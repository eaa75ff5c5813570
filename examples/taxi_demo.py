#!/usr/bin/env python
"""NYC-taxi demo: the hdk_jax analog of the reference's
examples/heterogen_demo_taxi.ipynb — same queries, on the default JAX device.

Run with a CSV of taxi trips (or no argument to use synthetic data):

    python examples/taxi_demo.py [trips.csv]
"""

import sys
import time

import numpy as np

import hdk_jax


def load(hdk):
    if len(sys.argv) > 1:
        return hdk.import_csv(sys.argv[1], name="trips")
    rng = np.random.default_rng(0)
    n = 1_000_000
    year = 365 * 86400
    print(f"(no CSV given — generating {n:,} synthetic rows)")
    return hdk.import_pydict({
        "cab_type": rng.integers(0, 2, n, dtype=np.int8),
        "passenger_count": rng.integers(0, 9, n, dtype=np.int8),
        "total_amount": rng.gamma(2.0, 8.0, n).astype(np.float32),
        "trip_distance": rng.gamma(1.5, 2.5, n).astype(np.float32),
        "pickup_datetime": np.int64(1356998400) + rng.integers(0, 4 * year, n),
    }, name="trips", schema={
        "pickup_datetime": hdk_jax.types.timestamp(
            hdk_jax.types.TimeUnit.SECOND, False)})


def show(title, res, seconds):
    print(f"\n== {title}  ({seconds * 1e3:.1f} ms)")
    print(res.to_pandas().head(10).to_string())


def main():
    hdk = hdk_jax.init()
    trips = load(hdk)

    queries = {
        "Q1: count by cab_type":
            "SELECT cab_type, COUNT(*) FROM trips GROUP BY cab_type",
        "Q2: avg fare by passengers":
            "SELECT passenger_count, AVG(total_amount) FROM trips "
            "GROUP BY passenger_count",
        "Q3: counts by passengers x year":
            "SELECT passenger_count, EXTRACT(year FROM pickup_datetime) AS y,"
            " COUNT(*) FROM trips GROUP BY passenger_count, y",
        "Q4: top groups by count":
            "SELECT passenger_count, EXTRACT(year FROM pickup_datetime) AS y,"
            " CAST(trip_distance AS int) AS dist, COUNT(*) AS c FROM trips "
            "GROUP BY passenger_count, y, dist ORDER BY c DESC LIMIT 10",
    }
    for title, sql in queries.items():
        res = hdk.sql(sql)  # warm (compile)
        res.block()
        t0 = time.perf_counter()
        res = hdk.sql(sql)
        res.block()
        show(title, res, time.perf_counter() - t0)

    # builder-API flavor of Q4 with a window function on top
    t = hdk.scan("trips")
    agg = t.agg(["passenger_count"], "count", "avg(total_amount)")
    out = agg.run()
    top = out.scan
    ranked = top.proj(
        "passenger_count", "count",
        rank=hdk.rank().over().order_by((top["count"], "desc")))
    print("\n== builder API: rank by count")
    print(ranked.run().to_pandas().head(10).to_string())

    print("\n== plan for Q1")
    print(hdk.sql("EXPLAIN " + queries["Q1: count by cab_type"]))


if __name__ == "__main__":
    main()
