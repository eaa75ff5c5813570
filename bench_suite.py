#!/usr/bin/env python
"""Extended benchmark suite: the BASELINE.json configs beyond taxi Q1-Q4.

  join:    trips ⋈ payments hash join on int64 key (100M ⋈ 10M default)
  zipf:    the same join with Zipf(1.3)-skewed probe keys
  groupby: high-cardinality group-by (50M distinct keys) + top-100 sort
  tpch:    TPC-H Q1/Q6 shapes over a 60M-row lineitem (SF10 shape)
  tpch3:   TPC-H Q3 shape (customer 1.5M, orders 15M, lineitem 60M)

Each config reports rows/s (probe side for the join).  ``--scale 0.1``
shrinks all row counts 10x.  Everything runs in one process; a failed
query fails the script.  The ``*_data`` generators are seeded and
shared with ``chip_smoke.py``, which checks the same queries against a
numpy reference.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# Peak device-memory bandwidth by jax ``device_kind`` (NVIDIA H100 SXM
# data sheet).  A device missing from the table is an error.
HBM_BYTES_PER_SEC = {"NVIDIA H100 80GB HBM3": 3.35e12}

TPCH_Q1 = (
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity), "
    "SUM(l_extendedprice), "
    "SUM(l_extendedprice * (1 - l_discount)), "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), "
    "COUNT(*) FROM lineitem "
    "WHERE l_shipdate <= TIMESTAMP '1998-09-02 00:00:00' "
    "GROUP BY l_returnflag, l_linestatus "
    "ORDER BY l_returnflag, l_linestatus")

TPCH_Q6 = (
    "SELECT SUM(l_extendedprice * l_discount) FROM lineitem "
    "WHERE l_shipdate >= TIMESTAMP '1994-01-01 00:00:00' "
    "AND l_shipdate < TIMESTAMP '1995-01-01 00:00:00' "
    "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24")

TPCH_Q3 = (
    "SELECT l_orderkey, "
    "SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
    "o_orderdate, o_shippriority "
    "FROM customer3, orders3, lineitem3 "
    "WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey "
    "AND l_orderkey = o_orderkey "
    "AND o_orderdate < TIMESTAMP '1995-03-15 00:00:00' "
    "AND l_shipdate > TIMESTAMP '1995-03-15 00:00:00' "
    "GROUP BY l_orderkey, o_orderdate, o_shippriority "
    "ORDER BY revenue DESC, o_orderdate LIMIT 10")

def _ts_seconds():
    from hdk_jax import types as t

    return t.timestamp(t.TimeUnit.SECOND, False)


def hbm_bytes_per_sec() -> float:
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in HBM_BYTES_PER_SEC:
        raise KeyError(f"no peak bandwidth known for device kind {kind!r}")
    return HBM_BYTES_PER_SEC[kind]


def bench_query(fn, hdk, iters: int = 3) -> dict:
    """Cold run (compiles included), then ``iters`` warm runs, each
    ended by ``block_until_ready`` on every result buffer.

    ``jit_builds`` counts CodeCache misses of the cold run (one jax.jit
    per miss); ``warm_builds`` those after it (0 = fully cached)."""
    misses0 = hdk._executor.code_cache.misses
    t0 = time.perf_counter()
    fn().block()
    cold = time.perf_counter() - t0
    misses_cold = hdk._executor.code_cache.misses
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn().block()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return {
        "seconds": samples[len(samples) // 2],
        "seconds_min": samples[0],
        "seconds_samples": samples,
        "cold_seconds": cold,
        "jit_builds": misses_cold - misses0,
        "warm_builds": hdk._executor.code_cache.misses - misses_cold,
    }


def _rec(config: str, rows: int, m: dict, bytes_ideal: float) -> dict:
    """``bytes_ideal``: minimum device-memory traffic of the operator
    (read every input byte once, write the result once)."""
    return {"config": config, "rows_per_sec": rows / m["seconds"], **m,
            "bytes_ideal": int(bytes_ideal),
            "roofline_frac_ideal":
                (bytes_ideal / hbm_bytes_per_sec()) / m["seconds"]}


def join_data(scale: float):
    """(probe, build) column dicts: 100M probe rows with uniform int64
    keys into a 10M-row build side whose keys are a permutation."""
    n_probe = int(100_000_000 * scale)
    n_build = int(10_000_000 * scale)
    rng = np.random.default_rng(11)
    probe = {
        "k": rng.integers(0, n_build, n_probe),
        "amt": rng.gamma(2.0, 10.0, n_probe).astype(np.float32),
    }
    build = {
        "k": rng.permutation(n_build),
        "fee": rng.gamma(1.0, 2.0, n_build).astype(np.float32),
    }
    return probe, build


def zipf_join_data(scale: float):
    """Zipf(1.3) probe keys over the join shape: a handful of
    heavy-hitter build rows receive ~30% of all probes (BASELINE.json
    config 5 'Zipf-skewed join keys')."""
    n_probe = int(100_000_000 * scale)
    n_build = int(10_000_000 * scale)
    rng = np.random.default_rng(17)
    k = np.minimum(rng.zipf(1.3, n_probe), n_build).astype(np.int64) - 1
    probe = {"k": k, "amt": rng.gamma(2.0, 10.0, n_probe).astype(np.float32)}
    build = {
        "k": rng.permutation(n_build),
        "fee": rng.gamma(1.0, 2.0, n_build).astype(np.float32),
    }
    return probe, build


def high_ndv_data(scale: float) -> dict:
    """100M rows over ~50M distinct int64 keys."""
    n = int(100_000_000 * scale)
    ndv = int(50_000_000 * scale)
    rng = np.random.default_rng(12)
    return {"k": rng.integers(0, ndv, n), "v": rng.integers(0, 1000, n)}


def lineitem_data(rows: int):
    """(columns, schema) of the Q1/Q6 lineitem; 60M rows ~ SF10."""
    rng = np.random.default_rng(13)
    year_secs = 365 * 86400
    ship = np.int64(694224000) + rng.integers(0, 7 * year_secs, rows)
    cols = {
        "l_quantity": rng.integers(1, 51, rows).astype(np.int8),
        "l_extendedprice": (rng.gamma(3.0, 12000.0, rows)).astype(np.float64),
        "l_discount": np.round(rng.uniform(0.0, 0.1, rows), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, rows), 2),
        "l_returnflag": rng.integers(0, 3, rows).astype(np.int8),
        "l_linestatus": rng.integers(0, 2, rows).astype(np.int8),
        "l_shipdate": ship,
    }
    return cols, {"l_shipdate": _ts_seconds()}


def tpch_q3_data(scale: float) -> dict:
    """{table: (columns, schema)} for the Q3 shape: customer 1.5M,
    orders 15M, lineitem 60M at scale 1.0 (~SF10)."""
    n_cust = int(1_500_000 * scale)
    n_ord = int(15_000_000 * scale)
    n_li = int(60_000_000 * scale)
    rng = np.random.default_rng(23)
    seg = np.asarray(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                      "MACHINERY"])
    base = np.int64(694224000)  # 1992-01-01
    year7 = 7 * 365 * 86400
    ts = _ts_seconds()
    customer = {
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_mktsegment": seg[rng.integers(0, 5, n_cust)],
    }
    orders = {
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_custkey": rng.integers(0, n_cust, n_ord),
        "o_orderdate": base + rng.integers(0, year7, n_ord),
        "o_shippriority": rng.integers(0, 3, n_ord).astype(np.int8),
    }
    lineitem = {
        "l_orderkey": rng.integers(0, n_ord, n_li),
        "l_extendedprice": rng.gamma(3.0, 12000.0, n_li).astype(np.float32),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2
                               ).astype(np.float32),
        "l_shipdate": base + rng.integers(0, year7, n_li),
    }
    return {"customer3": (customer, {}),
            "orders3": (orders, {"o_orderdate": ts}),
            "lineitem3": (lineitem, {"l_shipdate": ts})}


def _join_query(hdk, probe, build, tag: str):
    t = hdk.import_pydict(probe, name=f"trips_{tag}")
    p = hdk.import_pydict(build, name=f"payments_{tag}")
    return lambda: t.join(p, "k", "k").agg([], "count", "sum(fee)").run()


def bench_join(hdk, scale: float):
    probe, build = join_data(scale)
    n_probe, n_build = len(probe["k"]), len(build["k"])
    q = _join_query(hdk, probe, build, "j")
    # ideal: probe keys once + build fee value-table + dense output
    return _rec(f"join {n_probe}x{n_build} int64 key", n_probe,
                bench_query(q, hdk), bytes_ideal=8 * n_probe + 12 * n_build)


def bench_zipf_join(hdk, scale: float):
    probe, build = zipf_join_data(scale)
    n_probe, n_build = len(probe["k"]), len(build["k"])
    q = _join_query(hdk, probe, build, "z")
    return _rec(f"zipf_join {n_probe}x{n_build} a=1.3 skew", n_probe,
                bench_query(q, hdk), bytes_ideal=8 * n_probe + 12 * n_build)


def bench_high_ndv(hdk, scale: float):
    data = high_ndv_data(scale)
    n = len(data["k"])
    ndv = int(50_000_000 * scale)
    t = hdk.import_pydict(data, name="ndv_t")

    def q():
        return t.agg("k", "count", "sum(v)").run()

    def q_sorted():
        return t.agg("k", "count", "sum(v)").sort(("count", "desc"),
                                                  limit=100).run()

    # ideal: read (k,v) once, write 3 result cols at NDV / 100 entries
    return [
        _rec(f"groupby {n} rows ~{ndv} distinct keys", n,
             bench_query(q, hdk), bytes_ideal=16 * n + 24 * ndv),
        _rec(f"groupby+top100 {n} rows ~{ndv} keys", n,
             bench_query(q_sorted, hdk), bytes_ideal=16 * n + 24 * 100),
    ]


def bench_tpch_q3(hdk, scale: float):
    """TPC-H Q3 shape: 3-table join chain + group-by + top-10 sort.
    Exercises join-chain reordering, the FK join path and fused
    agg->sort together (SQL shape per the TPC-H spec Q3)."""
    tables = tpch_q3_data(scale)
    for name, (cols, schema) in tables.items():
        hdk.import_pydict(cols, name=name, schema=schema)
    n_cust = len(tables["customer3"][0]["c_custkey"])
    n_ord = len(tables["orders3"][0]["o_orderkey"])
    n_li = len(tables["lineitem3"][0]["l_orderkey"])
    return _rec(f"tpch_q3 {n_li} lineitem rows (3-table join)", n_li,
                bench_query(lambda: hdk.sql(TPCH_Q3), hdk),
                bytes_ideal=24 * n_li + 25 * n_ord + 9 * n_cust)


def bench_tpch(hdk, scale: float):
    rows = int(60_000_000 * scale)  # ~SF10-scale lineitem per unit scale
    cols, schema = lineitem_data(rows)
    hdk.import_pydict(cols, name="lineitem", schema=schema)
    return [
        _rec(f"tpch_q1 {rows} rows", rows,
             bench_query(lambda: hdk.sql(TPCH_Q1), hdk),
             bytes_ideal=35 * rows),
        _rec(f"tpch_q6 {rows} rows", rows,
             bench_query(lambda: hdk.sql(TPCH_Q6), hdk),
             bytes_ideal=25 * rows),
    ]


CONFIGS = {"join": bench_join, "zipf": bench_zipf_join,
           "groupby": bench_high_ndv, "tpch": bench_tpch,
           "tpch3": bench_tpch_q3}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1,
                    help="row-count multiplier vs the north-star configs")
    ap.add_argument("--only", choices=sorted(CONFIGS))
    args = ap.parse_args()

    import jax

    import hdk_jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for name in ([args.only] if args.only else list(CONFIGS)):
        hdk = hdk_jax.HDK()
        out = CONFIGS[name](hdk, args.scale)
        for r in (out if isinstance(out, list) else [out]):
            r["Mrows_per_sec"] = r.pop("rows_per_sec") / 1e6
            print(json.dumps({**r, "device": device}), flush=True)
        hdk.clear_device_mem()


if __name__ == "__main__":
    main()
