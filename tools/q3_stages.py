#!/usr/bin/env python
"""Q3 stage costing: warm timings of Q3 sub-plans + both plan variants
(rewrite vs original), all in one session.

    python tools/q3_stages.py [--scale 1.0]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args()

    import bench_suite
    import hdk_jax

    hdk = hdk_jax.HDK(**{"exec.enable_route_feedback": False})
    for name, (cols, schema) in bench_suite.tpch_q3_data(
            args.scale).items():
        hdk.import_pydict(cols, name=name, schema=schema)

    DATE = "TIMESTAMP '1995-03-15 00:00:00'"
    stages = {
        # the pre-aggregate alone (root materialization pays the trim)
        "preagg": ("SELECT l_orderkey, "
                   "SUM(l_extendedprice * (1 - l_discount)) AS r "
                   f"FROM lineitem3 WHERE l_shipdate > {DATE} "
                   "GROUP BY l_orderkey"),
        # dimension join alone
        "ord_cust": ("SELECT COUNT(*), MAX(o_orderdate) FROM customer3, "
                     "orders3 WHERE c_mktsegment = 'BUILDING' "
                     "AND c_custkey = o_custkey "
                     f"AND o_orderdate < {DATE}"),
        # full Q3
        "q3": ("SELECT l_orderkey, "
               "SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
               "o_orderdate, o_shippriority "
               "FROM customer3, orders3, lineitem3 "
               "WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey "
               "AND l_orderkey = o_orderkey "
               f"AND o_orderdate < {DATE} AND l_shipdate > {DATE} "
               "GROUP BY l_orderkey, o_orderdate, o_shippriority "
               "ORDER BY revenue DESC, o_orderdate LIMIT 10"),
    }

    def timed(sql, label):
        for _ in range(2):  # compile, then settle
            hdk.sql(sql).block()
        samples = []
        for _ in range(4):
            t0 = time.perf_counter()
            hdk.sql(sql).block()
            samples.append(time.perf_counter() - t0)
        secs = sorted(samples)[2]
        print(f"{label}: warm {secs:.3f}s", flush=True)
        return secs

    for label, sql in stages.items():
        timed(sql, label)

    # original (no-rewrite) variant
    hdk.config.exec.enable_eager_aggregation = False
    timed(stages["q3"], "q3_original_plan")


if __name__ == "__main__":
    main()
