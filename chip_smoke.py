#!/usr/bin/env python
"""End-to-end run of the engine on one GPU at TPC-H SF10 shape.

Drives the user entry points (``hdk.sql`` and the builder's ``.run()``)
over the repo's seeded generators (``bench.py``, ``bench_suite.py``) and
checks every answer against a plain numpy reference computed on the
host from the same arrays:

  taxi Q1-Q4 (100M rows), TPC-H Q1/Q6 (60M lineitem), TPC-H Q3
  (1.5M customer, 15M orders, 60M lineitem), join 100M x 10M on int64
  keys, and a 100M-row group-by over ~50M distinct keys (plain and
  top-100).

It also proves the integer-limb one-hot contraction bit-exact on the
card and times ``onehot.seg_sums`` against ``jax.ops.segment_sum``.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # TPC-H, join and high-NDV phases in
                                   # a dist session over four cards

Each phase prints rows, cold and warm seconds and its largest relative
error; the last line is one JSON object naming the device.  The script
exits non-zero when JAX finds no GPU, and when any phase fails or
mismatches.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

# tolerance classes: (relative tolerance, reason)
EXACT = (0.0, "keys, counts and integer sums must match exactly")
F64 = (1e-9, "sums of float64 inputs: summation order differs from numpy's")
F32 = (1e-5, "sums/averages of float32 inputs: float32 block partials "
             "(ops/onehot.py) and float32 expression arithmetic")
TOLERANCES = {"exact": EXACT, "f64": F64, "f32": F32}

TAXI_ROWS = 100_000_000
LINEITEM_ROWS = 60_000_000
SEG_ROWS = 10_000_000
SEG_GROUPS = 4096


class Mismatch(AssertionError):
    pass


def _epoch(ts: str) -> int:
    return int(np.datetime64(ts, "s").astype(np.int64))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise Mismatch(f"shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise Mismatch("non-finite values in result")
    if got.size == 0:
        return 0.0
    scale = np.maximum(np.abs(want), np.finfo(np.float64).tiny)
    return float(np.max(np.abs(got - want) / scale))


def compare(cols, want, tols) -> float:
    """``cols``/``want``: equal-length lists of columns; ``tols``: one
    tolerance class name per column.  Returns the largest relative
    error over the float columns."""
    if len(cols) != len(want):
        raise Mismatch(f"{len(cols)} columns, expected {len(want)}")
    worst = 0.0
    for i, (g, w, tol) in enumerate(zip(cols, want, tols)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            raise Mismatch(f"column {i}: shape {g.shape} != {w.shape}")
        rtol = TOLERANCES[tol][0]
        if rtol == 0.0:
            if not np.array_equal(g.astype(w.dtype), w):
                bad = np.flatnonzero(g.astype(w.dtype) != w)[:5]
                raise Mismatch(f"column {i}: exact mismatch at rows "
                               f"{bad.tolist()}: {g[bad]} != {w[bad]}")
        else:
            err = rel_err(g, w)
            if err > rtol:
                raise Mismatch(f"column {i}: relative error {err:.3e} > "
                               f"{rtol:.0e}")
            worst = max(worst, err)
    return worst


def by_keys(cols, nkeys: int):
    """Columns reordered by their first ``nkeys`` columns (group-by
    output order is unspecified)."""
    cols = [np.asarray(c) for c in cols]
    order = np.lexsort(cols[:nkeys][::-1])
    return [c[order] for c in cols]


def result_columns(res) -> list:
    return list(res.to_numpy().values())


class Query:
    """One query: ``run()`` goes through the engine's entry points,
    ``check(columns)`` compares columns in output order against the
    numpy reference and returns the largest relative error.  ``sqlite``
    is the same query over the same tables for a third opinion in the
    tests: (sql, {table: columns})."""

    def __init__(self, name, rows, run, check, sqlite=None):
        self.name, self.rows, self.run = name, rows, run
        self.check, self.sqlite = check, sqlite


# --------------------------------------------------------------------- taxi
def taxi_queries(hdk, scale: float):
    import bench

    rows = int(TAXI_ROWS * scale)
    data = bench.gen_data(rows)
    suite = bench.engine_suite(data, hdk)
    cab = data["cab_type"].astype(np.int64)
    pc = data["passenger_count"].astype(np.int64)
    year = data["pickup_datetime"].astype("datetime64[s]").astype(
        "datetime64[Y]").astype(np.int64) + 1970
    dist = np.trunc(data["trip_distance"]).astype(np.int64)

    def counts_by(*keys):
        """Unique key tuples (lexicographic) with their counts."""
        span = [int(k.max()) - int(k.min()) + 1 for k in keys]
        code = np.zeros(rows, np.int64)
        for k, s in zip(keys, span):
            code = code * s + (k - k.min())
        cnt = np.bincount(code)
        live = np.flatnonzero(cnt)
        out, rest = [], live
        for k, s in zip(keys[::-1], span[::-1]):
            out.append(rest % s + k.min())
            rest = rest // s
        return out[::-1], cnt[live], live, code

    (q1k,), q1c, _, _ = counts_by(cab)
    (q2k,), q2c, live2, code2 = counts_by(pc)
    q2avg = (np.bincount(code2, weights=data["total_amount"].astype(
        np.float64)) / np.maximum(np.bincount(code2), 1))[live2]
    q3k, q3c, _, _ = counts_by(pc, year)
    q4k, q4c, _, _ = counts_by(pc, year, dist)

    def check_q4(cols):
        if np.any(np.diff(np.asarray(cols[3], np.int64)) > 0):
            raise Mismatch("q4 not ordered by count desc")
        return compare(by_keys(cols, 3), q4k + [q4c], ["exact"] * 4)

    tables = {"trips": data}
    ydays = "CAST(strftime('%Y', pickup_datetime, 'unixepoch') AS INTEGER)"
    return [
        Query("taxi_q1", rows, suite["q1"],
              lambda c: compare(by_keys(c, 1), [q1k, q1c], ["exact"] * 2),
              ("SELECT cab_type, COUNT(*) FROM trips GROUP BY cab_type",
               tables)),
        Query("taxi_q2", rows, suite["q2"],
              lambda c: compare(by_keys(c, 1), [q2k, q2avg],
                                ["exact", "f32"]),
              ("SELECT passenger_count, AVG(total_amount) FROM trips "
               "GROUP BY passenger_count", tables)),
        Query("taxi_q3", rows, suite["q3"],
              lambda c: compare(by_keys(c, 2), q3k + [q3c], ["exact"] * 3),
              (f"SELECT passenger_count, {ydays}, COUNT(*) FROM trips "
               f"GROUP BY 1, 2", tables)),
        Query("taxi_q4", rows, suite["q4"], check_q4,
              (f"SELECT passenger_count, {ydays}, "
               f"CAST(trip_distance AS INTEGER), COUNT(*) FROM trips "
               f"GROUP BY 1, 2, 3 ORDER BY 4 DESC", tables)),
    ]


# -------------------------------------------------------------------- TPC-H
def tpch_q1_q6_queries(hdk, scale: float):
    import bench_suite

    rows = int(LINEITEM_ROWS * scale)
    cols, schema = bench_suite.lineitem_data(rows)
    hdk.import_pydict(cols, name="lineitem", schema=schema)
    ship = cols["l_shipdate"]
    price = cols["l_extendedprice"]
    disc = cols["l_discount"]
    tax = cols["l_tax"]
    qty = cols["l_quantity"].astype(np.int64)

    m1 = ship <= _epoch("1998-09-02")
    g = (cols["l_returnflag"].astype(np.int64) * 2
         + cols["l_linestatus"])[m1]
    cnt = np.bincount(g, minlength=6)
    live = np.flatnonzero(cnt)

    def gsum(v):
        return np.bincount(g, weights=np.asarray(v, np.float64)[m1],
                           minlength=6)[live]

    n = cnt[live]
    sum_qty = np.bincount(g, weights=qty[m1], minlength=6)[live]
    disc_price = price * (1 - disc)
    q1_want = [live // 2, live % 2, sum_qty.astype(np.int64), gsum(price),
               gsum(disc_price), gsum(disc_price * (1 + tax)),
               sum_qty / n, gsum(price) / n, gsum(disc) / n, n]
    q1_tols = ["exact", "exact", "exact"] + ["f64"] * 6 + ["exact"]

    m6 = ((ship >= _epoch("1994-01-01")) & (ship < _epoch("1995-01-01"))
          & (disc >= 0.05) & (disc <= 0.07) & (qty < 24))
    q6_want = [np.asarray([np.sum(price[m6] * disc[m6])])]

    tables = {"lineitem": cols}
    return [
        Query("tpch_q1", rows, lambda: hdk.sql(bench_suite.TPCH_Q1),
              lambda c: compare(c, q1_want, q1_tols),
              (bench_suite.TPCH_Q1.replace(
                  "TIMESTAMP '1998-09-02 00:00:00'",
                  str(_epoch("1998-09-02"))), tables)),
        Query("tpch_q6", rows, lambda: hdk.sql(bench_suite.TPCH_Q6),
              lambda c: compare(c, q6_want, ["f64"]),
              (bench_suite.TPCH_Q6.replace(
                  "TIMESTAMP '1994-01-01 00:00:00'",
                  str(_epoch("1994-01-01"))).replace(
                  "TIMESTAMP '1995-01-01 00:00:00'",
                  str(_epoch("1995-01-01"))), tables)),
    ]


def tpch_q3_queries(hdk, scale: float):
    import bench_suite

    tables = bench_suite.tpch_q3_data(scale)
    for name, (cols, schema) in tables.items():
        hdk.import_pydict(cols, name=name, schema=schema)
    cust = tables["customer3"][0]
    orders = tables["orders3"][0]
    li = tables["lineitem3"][0]
    day = _epoch("1995-03-15")

    building = cust["c_mktsegment"] == "BUILDING"
    order_ok = (orders["o_orderdate"] < day) & building[orders["o_custkey"]]
    li_ok = (li["l_shipdate"] > day) & order_ok[li["l_orderkey"]]
    okey = li["l_orderkey"][li_ok]
    rev_all = li["l_extendedprice"].astype(np.float64) * (
        1 - li["l_discount"].astype(np.float64))
    revenue = np.bincount(okey, weights=rev_all[li_ok],
                          minlength=len(order_ok))
    present = np.bincount(okey, minlength=len(order_ok)) > 0
    keys = np.flatnonzero(present)
    top = keys[np.lexsort((orders["o_orderdate"][keys],
                           -revenue[keys]))][:10]
    want = [top, revenue[top], orders["o_orderdate"][top],
            orders["o_shippriority"][top]]

    sql = bench_suite.TPCH_Q3.replace(
        "TIMESTAMP '1995-03-15 00:00:00'", str(day))
    return [Query("tpch_q3", len(li["l_orderkey"]),
                  lambda: hdk.sql(bench_suite.TPCH_Q3),
                  lambda c: compare(c, want,
                                    ["exact", "f32", "exact", "exact"]),
                  (sql, {n: t[0] for n, t in tables.items()}))]


# --------------------------------------------------------------------- join
def join_queries(hdk, scale: float):
    import bench_suite

    probe, build = bench_suite.join_data(scale)
    t = hdk.import_pydict(probe, name="trips_j")
    p = hdk.import_pydict(build, name="payments_j")
    fee_by_key = np.zeros(int(build["k"].max()) + 1, np.float64)
    fee_by_key[build["k"]] = build["fee"]
    hit = probe["k"] <= build["k"].max()
    hit[hit] = np.isin(probe["k"][hit], build["k"])
    want = [np.asarray([int(hit.sum())]),
            np.asarray([fee_by_key[probe["k"][hit]].sum()])]
    return [Query(
        "join", len(probe["k"]),
        lambda: t.join(p, "k", "k").agg([], "count", "sum(fee)").run(),
        lambda c: compare(c, want, ["exact", "f32"]),
        ("SELECT COUNT(*), SUM(fee) FROM trips_j JOIN payments_j "
         "ON trips_j.k = payments_j.k",
         {"trips_j": probe, "payments_j": build}))]


# ----------------------------------------------------------------- high NDV
def high_ndv_queries(hdk, scale: float):
    import bench_suite

    data = bench_suite.high_ndv_data(scale)
    t = hdk.import_pydict(data, name="ndv_t")
    cnt = np.bincount(data["k"])
    sums = np.bincount(data["k"], weights=data["v"]).astype(np.int64)
    keys = np.flatnonzero(cnt)
    want = [keys, cnt[keys], sums[keys]]

    def check_top(cols):
        k, c, s = (np.asarray(x, np.int64) for x in cols)
        top = np.sort(cnt)[::-1][:100]
        if len(np.unique(k)) != len(k):
            raise Mismatch("duplicate keys in top-100")
        compare([c, c, s], [top, cnt[k], sums[k]], ["exact"] * 3)
        return 0.0

    tables = {"ndv_t": data}
    return [
        Query("high_ndv", len(data["k"]),
              lambda: t.agg("k", "count", "sum(v)").run(),
              lambda c: compare(by_keys(c, 1), want, ["exact"] * 3),
              ("SELECT k, COUNT(*), SUM(v) FROM ndv_t GROUP BY k", tables)),
        Query("high_ndv_top100", len(data["k"]),
              lambda: t.agg("k", "count", "sum(v)").sort(
                  ("count", "desc"), limit=100).run(),
              check_top,
              ("SELECT k, COUNT(*) AS c, SUM(v) FROM ndv_t GROUP BY k "
               "ORDER BY c DESC LIMIT 100", tables)),
    ]


DATASETS = {
    "taxi": taxi_queries,
    "tpch_q1_q6": tpch_q1_q6_queries,
    "tpch_q3": tpch_q3_queries,
    "join": join_queries,
    "high_ndv": high_ndv_queries,
}
FOUR_CARD_DATASETS = ("tpch_q1_q6", "tpch_q3", "join", "high_ndv")


# ----------------------------------------------------------- device phases
def _timed(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return sorted(samples)[reps // 2]


def seg_sums_exact_phase() -> None:
    """The integer-limb contraction of ``onehot.seg_sums`` (default
    matmul precision) must be bit-exact: int64 sums over 10M rows,
    gids 0..4095, against numpy's own int64 additions."""
    import jax
    import jax.numpy as jnp

    from hdk_jax.ops import onehot

    rng = np.random.default_rng(5)
    gid = rng.integers(0, SEG_GROUPS, SEG_ROWS)
    vals = rng.integers(-(1 << 62), 1 << 62, SEG_ROWS)
    fn = jax.jit(lambda v, g: onehot.seg_sums([v], g, SEG_GROUPS)[0])
    t0 = time.perf_counter()
    got = np.asarray(fn(jnp.asarray(vals), jnp.asarray(gid)))
    cold = time.perf_counter() - t0
    warm = _timed(fn, jnp.asarray(vals), jnp.asarray(gid))
    order = np.argsort(gid, kind="stable")
    starts = np.searchsorted(gid[order], np.arange(SEG_GROUPS))
    want = np.add.reduceat(vals[order], starts)  # int64, wraps like XLA
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)[:5]
        raise Mismatch(f"seg_sums int64 not bit-exact at gids {bad}")
    print(f"phase seg_sums_int64_exact: rows={SEG_ROWS} groups={SEG_GROUPS} "
          f"cold_s={cold:.4f} warm_s={warm:.6f} max_rel_err=0 "
          f"bit_exact=True", flush=True)


def seg_sums_timing_line(scale: float) -> None:
    """Warm device time of onehot.seg_sums vs jax.ops.segment_sum at
    the taxi Q1/Q2 and TPC-H Q1 group-by shapes (input to the route
    choice in exec/groupby.py; decides nothing here)."""
    import jax
    import jax.numpy as jnp

    from hdk_jax.ops import onehot

    def inputs(rows, n, dtypes, seed):
        key = jax.random.PRNGKey(seed)
        ks = jax.random.split(key, len(dtypes) + 1)
        gid = jax.random.randint(ks[0], (rows,), 0, n, jnp.int32)
        cols = []
        for k, dt in zip(ks[1:], dtypes):
            if dt == "ones":
                cols.append(jnp.ones((rows,), jnp.int64))
            elif dt == "int8":
                cols.append(jax.random.randint(k, (rows,), 1, 51, jnp.int8))
            else:
                cols.append(jax.random.uniform(k, (rows,), jnp.dtype(dt)))
        return cols, gid

    shapes = {
        "taxi_q1": (int(TAXI_ROWS * scale), 2, ["ones"]),
        "taxi_q2": (int(TAXI_ROWS * scale), 9, ["ones", "float32"]),
        "tpch_q1": (int(LINEITEM_ROWS * scale), 6,
                    ["ones", "int8", "float64", "float64", "float64",
                     "float64"]),
    }
    out = {}
    for seed, (name, (rows, n, dts)) in enumerate(shapes.items()):
        cols, gid = inputs(rows, n, dts, seed)
        ones = tuple(i for i, d in enumerate(dts) if d == "ones")

        @jax.jit
        def via_onehot(cols, gid, n=n, ones=ones):
            return onehot.seg_sums(cols, gid, n, ones_ids=ones)

        @jax.jit
        def via_segment_sum(cols, gid, n=n):
            return [jax.ops.segment_sum(
                c.astype(jnp.float64 if jnp.issubdtype(c.dtype, jnp.floating)
                         else jnp.int64), gid, num_segments=n) for c in cols]

        a = via_onehot(cols, gid)
        b = via_segment_sum(cols, gid)
        for x, y, dt in zip(a, b, dts):
            tol = 0.0 if dt in ("ones", "int8") else 1e-5
            if rel_err(x, y) > tol:
                raise Mismatch(f"{name}: seg_sums and segment_sum disagree")
        out[name] = {"rows": rows, "groups": n, "columns": dts,
                     "onehot_s": _timed(via_onehot, cols, gid),
                     "segment_sum_s": _timed(via_segment_sum, cols, gid)}
        del cols, gid
    print("seg_sums_vs_segment_sum " + json.dumps(out), flush=True)


def run_query(q: Query, hdk=None) -> None:
    t0 = time.perf_counter()
    res = q.run().block()
    cold = time.perf_counter() - t0
    del res
    if hdk is not None:
        hdk._executor._join_route = hdk._executor._dist_agg_route = None
    t0 = time.perf_counter()
    res = q.run().block()
    warm = time.perf_counter() - t0
    err = q.check(result_columns(res))
    routes = ""
    if hdk is not None:  # the executor's route choices in the warm run
        ex = hdk._executor
        routes = "".join(
            f" {a}={getattr(ex, '_' + a)}" for a in ("join_route",
                                                     "dist_agg_route")
            if getattr(ex, "_" + a, None) is not None)
    print(f"phase {q.name}: rows={q.rows} cold_s={cold:.4f} "
          f"warm_s={warm:.4f} max_rel_err={err:.3e}{routes}", flush=True)


def run_dataset(name: str, scale: float, session_kwargs: dict) -> None:
    import hdk_jax

    hdk = hdk_jax.HDK(**session_kwargs)
    t0 = time.perf_counter()
    queries = DATASETS[name](hdk, scale)
    print(f"data {name}: generated, imported and referenced in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for q in queries:
        run_query(q, hdk)
    del queries
    hdk.clear_device_mem()
    del hdk
    gc.collect()


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the TPC-H, join and high-NDV phases in a "
                         "dist session over four cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1
    if not args.four:
        # one card only: JAX reserves most of the memory of every card
        # it opens
        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2

    import hdk_jax  # noqa: F401  (turns on 64-bit mode)
    from hdk_jax.storage.native import load_native

    for line in card_lines():
        print(f"card: {line}", flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)
    print("native string dictionary: "
          + ("loaded" if load_native() is not None else
             "NOT loaded (pure-Python encoder)"), flush=True)
    try:
        import pyarrow  # noqa: F401
        print("pyarrow: present (the checked path does not use it)")
    except ImportError:
        print("pyarrow: absent")
    for tag, (rtol, why) in TOLERANCES.items():
        print(f"tolerance {tag}: relative {rtol:g} — {why}")
    print("tolerance tpch_q3: top-10 keys and order exact, revenue "
          "relative 1e-5 (float32 inputs)", flush=True)

    if args.four:
        session = {"dist.enable": True, "dist.num_devices": 4}
        names = FOUR_CARD_DATASETS
    else:
        session = {}
        names = list(DATASETS)
        seg_sums_exact_phase()
        seg_sums_timing_line(1.0)
    for name in names:
        run_dataset(name, 1.0, session)
    stats = devs[0].memory_stats() or {}
    print(f"peak_bytes_in_use (device 0): {stats.get('peak_bytes_in_use')}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
