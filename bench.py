#!/usr/bin/env python
"""Benchmark driver: NYC-taxi Q1-Q4 analog suite on synthetic data.

Queries mirror the reference harness
(reference: omniscidb/Benchmarks/taxi/taxi_reduced_bench.cpp:52-84):
  Q1: SELECT cab_type, count(*) GROUP BY cab_type
  Q2: SELECT passenger_count, avg(total_amount) GROUP BY passenger_count
  Q3: SELECT passenger_count, extract(year from pickup_datetime), count(*)
      GROUP BY 1, 2
  Q4: SELECT passenger_count, year, cast(trip_distance as int), count(*)
      GROUP BY 1, 2, 3 ORDER BY count(*) DESC

The reference publishes no numbers (BASELINE.md), so the baseline is
*measured*: pandas runs the identical queries on the same data on this
host, cached in BASELINE_MEASURED.json.  vs_baseline = our geomean
rows/s over the suite / baseline geomean rows/s.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

ROWS = int(os.environ.get("BENCH_ROWS", "10000000"))
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BASELINE_MEASURED.json")


def gen_data(rows: int):
    rng = np.random.default_rng(7)
    year_secs = 365 * 86400
    return {
        "cab_type": rng.integers(0, 2, rows, dtype=np.int8),
        "passenger_count": rng.integers(0, 9, rows, dtype=np.int8),
        "total_amount": (rng.gamma(2.0, 8.0, rows)).astype(np.float32),
        "trip_distance": (rng.gamma(1.5, 2.5, rows)).astype(np.float32),
        "pickup_datetime": (np.int64(1356998400)  # 2013-01-01
                            + rng.integers(0, 4 * year_secs, rows)),
    }


def pandas_suite(data):
    import pandas as pd

    df = pd.DataFrame(data)
    ts = pd.to_datetime(df["pickup_datetime"], unit="s")

    def q1():
        return df.groupby("cab_type").size()

    def q2():
        return df.groupby("passenger_count")["total_amount"].mean()

    def q3():
        return df.groupby(["passenger_count", ts.dt.year]).size()

    def q4():
        g = df.groupby(["passenger_count", ts.dt.year,
                        df["trip_distance"].astype(np.int32)]).size()
        return g.sort_values(ascending=False)

    return {"q1": q1, "q2": q2, "q3": q3, "q4": q4}


def engine_suite(data, hdk=None):
    """The four taxi queries over ``data`` imported as table "trips"
    (into ``hdk``, or a new session)."""
    import hdk_jax
    from hdk_jax import types as t

    hdk = hdk or hdk_jax.HDK()
    ht = hdk.import_pydict(
        dict(data), name="trips",
        schema={"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})

    def q1():
        return ht.agg("cab_type", "count").run()

    def q2():
        return ht.agg("passenger_count", "avg(total_amount)").run()

    def q3():
        return ht.agg(
            ["passenger_count", ht["pickup_datetime"].extract("year").name("y")],
            "count").run()

    def q4():
        return ht.agg(
            ["passenger_count", ht["pickup_datetime"].extract("year").name("y"),
             ht["trip_distance"].cast("int32").name("dist")],
            "count").sort(("count", "desc")).run()

    return {"q1": q1, "q2": q2, "q3": q3, "q4": q4}


def measure(suite, rows: int, iters: int = 5):
    """Median warm seconds per query after one cold run.  Engine
    results end with ``block()`` (``block_until_ready`` on every result
    buffer); pandas results are already on the host."""
    out = {}
    for name, fn in suite.items():
        def once():
            t0 = time.perf_counter()
            r = fn()
            if hasattr(r, "block"):
                r.block()
            return time.perf_counter() - t0

        once()
        samples = sorted(once() for _ in range(iters))
        secs = samples[len(samples) // 2]
        out[name] = {"seconds": secs, "seconds_samples": samples,
                     "rows_per_sec": rows / secs}
    return out


def geomean(vals):
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def load_or_measure_baseline(data, rows: int):
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            rec = json.load(f)
        if rec.get("rows") == rows:
            return rec
    res = measure(pandas_suite(data), rows)
    rec = {"oracle": "pandas", "rows": rows, "queries": res,
           "geomean_rows_per_sec": geomean(
               [q["rows_per_sec"] for q in res.values()])}
    with open(BASELINE_FILE, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main():
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    rows = ROWS
    if "--quick" in sys.argv:
        rows = min(rows, 1_000_000)
    data = gen_data(rows)
    baseline = load_or_measure_baseline(data, rows)
    ours = measure(engine_suite(data), rows)
    value = geomean([q["rows_per_sec"] for q in ours.values()])
    vs = value / baseline["geomean_rows_per_sec"]
    detail = {name: round(q["rows_per_sec"] / 1e6, 2) for name, q in ours.items()}
    print(json.dumps({
        "metric": "taxi_q1q4_geomean_rows_per_sec",
        "value": round(value, 1),
        "unit": "rows/s",
        "vs_baseline": round(vs, 3),
        "detail_Mrows_per_sec": detail,
        "baseline_oracle": baseline.get("oracle", "pandas"),
        "timing": "median warm seconds per query, block_until_ready",
        "rows": rows,
        "device": device,
    }))


if __name__ == "__main__":
    main()
