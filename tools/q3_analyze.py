#!/usr/bin/env python
"""TPC-H Q3 diagnosis: per-run wall time + jit-build deltas + plan
variant + EXPLAIN ANALYZE step breakdown.

    python tools/q3_analyze.py [--scale 1.0] [--runs 8] [--no-analyze]
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
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--no-analyze", action="store_true")
    args = ap.parse_args()

    import bench_suite
    import hdk_jax

    hdk = hdk_jax.HDK()
    ex = hdk._executor
    for name, (cols, schema) in bench_suite.tpch_q3_data(
            args.scale).items():
        hdk.import_pydict(cols, name=name, schema=schema)
    Q3 = bench_suite.TPCH_Q3

    def run():
        return hdk.sql(Q3)

    for i in range(args.runs):
        b0 = ex.code_cache.misses
        t0 = time.perf_counter()
        run().block()
        secs = time.perf_counter() - t0
        fb = ex._plan_feedback
        sigs = {v for (s, v) in fb._fb._t}
        print(f"run {i}: {secs:.3f}s  builds+{ex.code_cache.misses - b0} "
              f"measured_variants={sorted(sigs)} "
              f"ndv_sample={ex._ndv_sample_seconds:.2f}s", flush=True)
    if not args.no_analyze:
        print("\n=== EXPLAIN ANALYZE ===", flush=True)
        print(hdk.explain(Q3, analyze=True), flush=True)


if __name__ == "__main__":
    main()
