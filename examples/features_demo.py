#!/usr/bin/env python
"""Tour of engine features beyond the taxi demo: UDFs, window frames,
arrays + UNNEST, set ops, GROUPING SETS, spill, EXPLAIN.

Runs on the CPU (forced, so it works anywhere):
    python examples/features_demo.py
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, ".")
import hdk_jax  # noqa: E402
from hdk_jax import types as t  # noqa: E402


def main() -> None:
    hdk = hdk_jax.init()
    rng = np.random.default_rng(0)
    n = 100_000
    trips = hdk.import_pydict({
        "cab": rng.integers(0, 3, n, dtype=np.int8),
        "fare": np.round(rng.gamma(2.0, 8.0, n), 2),
        "tip": np.round(rng.gamma(1.0, 2.0, n), 2),
        "stops": [list(rng.integers(0, 50, rng.integers(0, 4)))
                  for _ in range(1000)] * 100,
    }, name="trips")

    # --- UDF: traces into the fused query program --------------------
    import jax.numpy as jnp

    hdk.register_udf("tip_rate", lambda tip, fare: tip / jnp.maximum(fare, 1.0),
                     arg_types=[t.fp64(), t.fp64()], ret_type=t.fp64())
    print(hdk.sql(
        "SELECT cab, AVG(tip_rate(tip, fare)) AS r FROM trips "
        "GROUP BY cab ORDER BY r DESC").to_pandas())

    # --- window frames ------------------------------------------------
    print(hdk.sql(
        "SELECT cab, fare, AVG(fare) OVER (PARTITION BY cab ORDER BY fare "
        "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ma3 "
        "FROM trips LIMIT 5").to_pandas())

    # --- arrays: cardinality + unnest ---------------------------------
    print(trips.proj(ns=trips["stops"].cardinality())
          .agg("ns", "count").run().to_pandas())
    print(trips.unnest("stops").agg("stops", "count")
          .sort(("count", "desc"), limit=5).run().to_pandas())

    # --- GROUPING SETS / set ops --------------------------------------
    print(hdk.sql(
        "SELECT cab, COUNT(*) AS c FROM trips GROUP BY ROLLUP(cab) "
        "ORDER BY c").to_pandas())

    # --- result chaining + explicit spill ------------------------------
    res = trips.agg("cab", "count", "sum(fare)").run()
    res.offload()  # host tier; reloads transparently
    sc = res.scan
    print(sc.filter(sc["count"] > 10).run().to_pandas())

    # --- plan inspection -----------------------------------------------
    print(hdk.explain(
        "SELECT cab, COUNT(*) FROM trips WHERE fare > 30 GROUP BY cab"))


if __name__ == "__main__":
    main()
