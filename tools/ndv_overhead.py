#!/usr/bin/env python
"""Measure the sampling-estimator host-readback overhead: the NDV/skew
sample pulls are the one host round-trip class the engine otherwise
avoids — this records their cost as a fraction of the queries they
serve.  Prints one JSON object.  Reference analog: the estimator mini-query
cost the reference pays per work unit (CardinalityEstimator.h:59).
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np

    import hdk_jax

    rows = int(os.environ.get("NDV_ROWS", "100000000"))
    hdk = hdk_jax.HDK()
    rng = np.random.default_rng(5)
    # unbounded keys (hashed): the NDV sampler is on the hot path
    k = rng.integers(0, rows // 2, rows).astype(np.int64) * 2654435761 % (
        1 << 62)
    hdk.import_pydict({"k": k, "v": rng.integers(0, 1000, rows)},
                      name="ndv_ovh")
    t = hdk.scan("ndv_ovh")
    ex = hdk._executor

    def q():
        return t.agg("k", "count", "sum(v)").run()

    # cold (includes the estimator's jit build + pull)
    s0 = ex._ndv_sample_seconds
    t0 = time.perf_counter()
    q().block()
    cold = time.perf_counter() - t0
    cold_sample = ex._ndv_sample_seconds - s0

    # warm: per-execution estimator cost vs total query time
    s0 = ex._ndv_sample_seconds
    q().block()
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        q().block()
        samples.append(time.perf_counter() - t0)
    warm = sorted(samples)[1]
    warm_sample_per_iter = (ex._ndv_sample_seconds - s0) / 4  # 1+3 runs
    out = {
        "rows": rows,
        "cold_seconds": round(cold, 3),
        "cold_sample_seconds": round(cold_sample, 4),
        "warm_query_seconds": warm,
        "warm_sample_seconds_per_query": round(warm_sample_per_iter, 4),
        "sample_fraction_of_warm_query": round(
            warm_sample_per_iter / warm, 4),
        "attempts": ex._groupby_attempts,
        "ndv_estimate": ex._ndv_estimate,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
