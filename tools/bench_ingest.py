#!/usr/bin/env python
"""Ingest/compute-overlap benchmark (SURVEY §2.7 P3; VERDICT r3 #9).

Measures wall time of (import_csv + first query) with the ingest
pipeline ON (storage.prefetch_device: per-column device transfer issued
while the next column decodes, fragment stats warmed in the background)
vs OFF (sequential: decode everything, then the first query pays
transfer + stats).  Both modes run in this one process, in turns, each
in its own session; the card is opened by this process only.

Prints one JSON object.  Reference analog: ColumnFetcher overlaps
per-fragment fetch with kernel execution (ColumnFetcher.h:42-90,
TBB kernel pool Execute.cpp:2753).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROWS = int(os.environ.get("INGEST_ROWS", "10000000"))
REPS = int(os.environ.get("INGEST_REPS", "3"))


def make_csv(path: str, rows: int) -> None:
    import numpy as np
    import pyarrow as pa
    import pyarrow.csv as pacsv

    rng = np.random.default_rng(31)
    at = pa.table({
        "cab": rng.integers(0, 2, rows).astype(np.int8),
        "passengers": rng.integers(0, 9, rows).astype(np.int8),
        "amount": rng.gamma(2.0, 8.0, rows).astype(np.float32),
        "distance": rng.gamma(1.5, 2.5, rows).astype(np.float32),
        "pickup": np.int64(1356998400) + rng.integers(0, 4 * 365 * 86400,
                                                      rows),
        "vendor": np.asarray(["ACME", "BETA", "GAMMA", "DELTA"])[
            rng.integers(0, 4, rows)],
    })
    pacsv.write_csv(at, path)


def ingest_sessions():
    """{mode: import_and_query(name) -> seconds} for both modes."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import hdk_jax

    def timer(prefetch: bool):
        hdk = hdk_jax.HDK(**{"storage.prefetch_device": prefetch})

        def import_and_query(csv_path: str, name: str) -> float:
            t0 = time.perf_counter()
            t = hdk.import_csv(csv_path, name=name)
            t.agg(["cab", "vendor"], "count", "sum(amount)",
                  "min(distance)", "max(pickup)").run().to_numpy()
            return time.perf_counter() - t0

        return import_and_query

    return {"on": timer(True), "off": timer(False)}


def bench_dict_encode() -> dict:
    """Serial vs parallel native bulk dictionary encode (reference hot
    path: TBB getOrAddBulk, StringDictionary.h:126).  Subprocess per
    thread count so the env knob is read fresh; the children use no
    device."""
    code = r"""
import json, random, sys, time
sys.path.insert(0, %r)
from hdk_jax.storage.native import load_native
m = load_native()
rng = random.Random(3)
uniq = [f"str_{i:06d}" for i in range(50_000)]
vals = [uniq[rng.randrange(50_000)] for _ in range(4_000_000)]
d = m.dict_new()
t0 = time.perf_counter(); m.dict_bulk_get_or_add(d, vals)
cold = time.perf_counter() - t0
warm = 1e9
for _ in range(3):
    t0 = time.perf_counter(); m.dict_bulk_get_or_add(d, vals)
    warm = min(warm, time.perf_counter() - t0)
print(json.dumps({"cold_s": cold, "warm_s": warm}))
""" % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {"rows": 4_000_000, "unique": 50_000}
    for label, threads in (("serial", "1"), ("parallel", "0")):
        env = {**os.environ, "HDK_JAX_DICT_THREADS": threads}
        if threads == "0":
            env.pop("HDK_JAX_DICT_THREADS")
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=600,
                              env=env)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        if lines:
            out[label] = json.loads(lines[-1])
    if "serial" in out and "parallel" in out:
        out["warm_speedup"] = round(
            out["serial"]["warm_s"] / out["parallel"]["warm_s"], 2)
        out["cold_speedup"] = round(
            out["serial"]["cold_s"] / out["parallel"]["cold_s"], 2)
        out["warm_Mrows_per_s"] = round(
            4.0 / out["parallel"]["warm_s"], 1)
    return out


def main() -> None:
    d = tempfile.mkdtemp(prefix="hdk_ingest_")
    csv_path = os.path.join(d, "ingest.csv")
    make_csv(csv_path, ROWS)
    import jax

    dev = jax.devices()[0]
    out = {"rows": ROWS,
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "dict_encode": bench_dict_encode(), "on": [], "off": []}
    runs = ingest_sessions()
    for mode, run in runs.items():
        # warm-up pass builds the jit programs, so the timed passes pay
        # CSV decode + dict-encode + device transfer + execution only
        run(csv_path, f"ing_warm_{mode}")
    for rep in range(REPS):
        for mode, run in runs.items():
            out[mode].append(run(csv_path, f"ing_{mode}_{rep}"))
    os.remove(csv_path)
    if out["on"] and out["off"]:
        med = lambda xs: sorted(xs)[len(xs) // 2]
        out["median_on_s"] = med(out["on"])
        out["median_off_s"] = med(out["off"])
        out["speedup_import_plus_first_query"] = round(
            out["median_off_s"] / out["median_on_s"], 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
