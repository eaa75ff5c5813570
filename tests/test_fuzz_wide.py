"""Seeded differential fuzzing over the families the base fuzzer
(test_fuzz_differential.py) doesn't reach: joins (including the spread
FK route at a lowered admission threshold), window functions, datetime
extract/trunc, strings, masked unions, and distributed sessions on the
virtual 8-device mesh (VERDICT r3 missing #6).

Oracle: pandas (the reference's differential strategy —
ArrowBasedExecuteTest.cpp enumerates ~216 fixed shapes across these
same families; this samples the space randomly but deterministically,
so failures reproduce by seed).
"""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from hdk_jax import types as t
from harness import assert_frames_match

N = 1500


# ---------------------------------------------------------------- joins
@pytest.fixture(scope="module")
def jenv():
    rng = np.random.default_rng(555)
    lhs = pd.DataFrame({
        "k": rng.integers(0, 40, N),
        "j": rng.integers(-5, 60, N),
        "lv": np.round(rng.normal(0, 4, N), 4),
        "li": rng.integers(0, 9, N),
    })
    rhs = pd.DataFrame({
        "k": rng.permutation(40),          # unique complete FK target
        "rv": np.round(rng.normal(2, 3, 40), 4),
        "ri": rng.integers(0, 6, 40),
    })
    rhs_dup = pd.DataFrame({               # non-unique build keys
        "j": rng.integers(0, 50, 120),
        "w": np.round(rng.normal(0, 2, 120), 4),
    })
    hdk = hdk_jax.HDK()
    hdk.config.exec.join.spread_join_min_rows = 50  # exercise the route
    tl = hdk.import_pandas(lhs, name="fw_l")
    tr = hdk.import_pandas(rhs, name="fw_r")
    td = hdk.import_pandas(rhs_dup, name="fw_d")
    return hdk, (tl, tr, td), (lhs, rhs, rhs_dup)


@pytest.mark.parametrize("seed", range(15))
def test_fuzz_fk_join_agg(jenv, seed):
    """FK join (spread-eligible) under a random probe-side filter with a
    random agg mix — vs pandas merge."""
    hdk, (tl, tr, _), (lhs, rhs, _) = jenv
    rng = np.random.default_rng(100 + seed)
    thr = int(rng.integers(0, 50))
    keys = list(rng.choice(["li", "ri"], size=int(rng.integers(1, 3)),
                           replace=False))
    got = (tl.filter(tl["j"] > thr).join(tr, "k", "k")
           .agg(keys, "count", "sum(rv)", "min(lv)")
           .run().to_pandas())
    sub = lhs[lhs["j"] > thr].merge(rhs, on="k")
    if len(sub) == 0:
        assert len(got) == 0
        return
    g = sub.groupby(keys)
    exp = pd.DataFrame({"count": g.size(), "rv_sum": g["rv"].sum(),
                        "lv_min": g["lv"].min()}).reset_index()
    exp.columns = list(got.columns)
    assert_frames_match(got, exp)


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_dup_key_join(jenv, seed):
    """Non-unique build keys (pair-table route) with random filters on
    both sides — row multiplicity must match pandas exactly."""
    hdk, (tl, _, td), (lhs, _, rhs_dup) = jenv
    rng = np.random.default_rng(300 + seed)
    lthr = float(np.round(rng.uniform(-4, 4), 2))
    rthr = float(np.round(rng.uniform(-2, 2), 2))
    got = (tl.filter(tl["lv"] > lthr)
           .join(td.filter(td["w"] <= rthr), "j", "j")
           .agg([], "count", "sum(w)", "sum(lv)").run().to_pandas())
    sub = lhs[lhs["lv"] > lthr].merge(
        rhs_dup[rhs_dup["w"] <= rthr], on="j")
    assert got["count"].iloc[0] == len(sub)
    if len(sub):
        np.testing.assert_allclose(got.iloc[0, 1], sub["w"].sum(), rtol=1e-6)
        np.testing.assert_allclose(got.iloc[0, 2], sub["lv"].sum(), rtol=1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_left_join(jenv, seed):
    hdk, (tl, tr, _), (lhs, rhs, _) = jenv
    rng = np.random.default_rng(400 + seed)
    rthr = int(rng.integers(0, 6))
    got = (tl.join(tr.filter(tr["ri"] >= rthr), "k", "k", how="left")
           .agg(["li"], "count", "count(rv)", "sum(rv)")
           .run().to_pandas())
    sub = lhs.merge(rhs[rhs["ri"] >= rthr], on="k", how="left")
    g = sub.groupby("li")
    exp = pd.DataFrame({"count": g.size(), "c2": g["rv"].count(),
                        "s": g["rv"].sum()}).reset_index()
    exp.loc[exp["c2"] == 0, "s"] = None  # SQL SUM of empty = NULL
    exp.columns = list(got.columns)
    assert_frames_match(got, exp)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_right_full_join(jenv, seed):
    """RIGHT/FULL OUTER joins (round-5 binder canonicalization) under
    random build filters — padded-row counts must match pandas with SQL
    NULL-key semantics (no NaN keys here, so merge is a valid oracle)."""
    hdk, (tl, tr, _), (lhs, rhs, _) = jenv
    rng = np.random.default_rng(700 + seed)
    rthr = int(rng.integers(0, 6))
    how = "right" if seed % 2 == 0 else "full"
    got = (tl.join(tr.filter(tr["ri"] >= rthr), "k", "k", how=how)
           .agg([], "count", "count(lv)", "count(rv)", "sum(rv)")
           .run().to_pandas())
    sub = lhs.merge(rhs[rhs["ri"] >= rthr], on="k",
                    how=("right" if how == "right" else "outer"))
    assert got["count"].iloc[0] == len(sub)
    assert got.iloc[0, 1] == sub["lv"].count()
    assert got.iloc[0, 2] == sub["rv"].count()
    if sub["rv"].count():
        np.testing.assert_allclose(got.iloc[0, 3], sub["rv"].sum(),
                                   rtol=1e-6)


# -------------------------------------------------------------- windows
@pytest.fixture(scope="module")
def wenv():
    rng = np.random.default_rng(777)
    df = pd.DataFrame({
        "g": rng.integers(0, 12, N),
        "h": rng.integers(0, 4, N),
        "o": rng.integers(0, 200, N),
        "v": np.round(rng.normal(0, 5, N), 4),
    })
    hdk = hdk_jax.HDK()
    ht = hdk.import_pandas(df, name="fw_w")
    return hdk, ht, df


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_window_rank_rowno(wenv, seed):
    hdk, ht, df = wenv
    rng = np.random.default_rng(500 + seed)
    pk = ["g", "h"][int(rng.integers(0, 2))]
    got = ht.proj(
        pk, "o",
        rn=hdk.row_number().over(ht[pk]).order_by(ht["o"], ht["rowid"]),
        rk=hdk.rank().over(ht[pk]).order_by(ht["o"]),
        dr=hdk.dense_rank().over(ht[pk]).order_by(ht["o"]),
    ).run().to_pandas()
    exp_rk = df.groupby(pk)["o"].rank(method="min").astype(np.int64)
    exp_dr = df.groupby(pk)["o"].rank(method="dense").astype(np.int64)
    np.testing.assert_array_equal(got["rk"], exp_rk)
    np.testing.assert_array_equal(got["dr"], exp_dr)
    srt = df.reset_index().sort_values([pk, "o", "index"], kind="stable")
    exp_rn = srt.groupby(pk).cumcount() + 1
    np.testing.assert_array_equal(got["rn"].iloc[srt["index"]], exp_rn)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_window_agg_shift(wenv, seed):
    hdk, ht, df = wenv
    rng = np.random.default_rng(600 + seed)
    pk = ["g", "h"][int(rng.integers(0, 2))]
    n = int(rng.integers(1, 3))
    got = ht.proj(
        pk, "o", "v",
        s=ht["v"].sum().over(ht[pk]),
        cs=ht["v"].sum().over(ht[pk]).order_by(ht["o"], ht["rowid"]),
        lg=ht["v"].lag(n).over(ht[pk]).order_by(ht["o"], ht["rowid"]),
    ).run().to_pandas()
    np.testing.assert_allclose(got["s"], df.groupby(pk)["v"].transform("sum"),
                               rtol=1e-6)
    srt = df.reset_index().sort_values([pk, "o", "index"], kind="stable")
    exp_cs = srt.groupby(pk)["v"].cumsum()
    exp_lg = srt.groupby(pk)["v"].shift(n)
    np.testing.assert_allclose(got["cs"].iloc[srt["index"]], exp_cs,
                               rtol=1e-6)
    np.testing.assert_allclose(got["lg"].iloc[srt["index"]].to_numpy(),
                               exp_lg.to_numpy(), rtol=1e-6, equal_nan=True)


# ------------------------------------------------------------- datetime
@pytest.fixture(scope="module")
def denv():
    rng = np.random.default_rng(888)
    secs = (np.int64(946684800)  # 2000-01-01
            + rng.integers(0, 12 * 365 * 86400, N))
    df = pd.DataFrame({
        "ts": secs,
        "g": rng.integers(0, 6, N),
        "v": np.round(rng.normal(10, 3, N), 4),
    })
    hdk = hdk_jax.HDK()
    ht = hdk.import_pydict(
        {k: df[k].to_numpy() for k in df}, name="fw_dt",
        schema={"ts": t.timestamp(t.TimeUnit.SECOND, False)})
    return hdk, ht, df


_DT_FIELDS = [
    ("year", lambda s: s.dt.year),
    ("month", lambda s: s.dt.month),
    ("day", lambda s: s.dt.day),
    ("hour", lambda s: s.dt.hour),
    ("quarter", lambda s: s.dt.quarter),
    ("dow", lambda s: (s.dt.dayofweek + 1) % 7),  # engine: 0=Sunday
    ("week", lambda s: s.dt.isocalendar().week.astype(np.int64)),
]


@pytest.mark.parametrize("seed", range(14))
def test_fuzz_datetime_extract_group(denv, seed):
    hdk, ht, df = denv
    rng = np.random.default_rng(700 + seed)
    field, pfn = _DT_FIELDS[int(rng.integers(0, len(_DT_FIELDS)))]
    gthr = int(rng.integers(0, 6))
    ts = pd.to_datetime(df["ts"], unit="s")
    got = (ht.filter(ht["g"] >= gthr)
           .agg([ht["ts"].extract(field).name("f"), "g"],
                "count", "sum(v)").run().to_pandas())
    sub = df[df["g"] >= gthr]
    g = sub.groupby([pfn(ts[sub.index]).rename("f"), "g"])
    exp = pd.DataFrame({"count": g.size(), "v_sum": g["v"].sum()}
                       ).reset_index()
    exp.columns = list(got.columns)
    assert_frames_match(got, exp, approx_cols=("v_sum",))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_datetime_trunc_count(denv, seed):
    hdk, ht, df = denv
    rng = np.random.default_rng(800 + seed)
    unit, punit = [("year", "YS"), ("month", "MS"), ("day", "D")][
        int(rng.integers(0, 3))]
    got = (ht.agg([ht["ts"].trunc(unit).name("b")], "count")
           .run().to_pandas())
    ts = pd.to_datetime(df["ts"], unit="s")
    exp = (ts.dt.to_period({"YS": "Y", "MS": "M", "D": "D"}[punit])
           .dt.start_time.value_counts().sort_index())
    got_b = pd.to_datetime(got.sort_values("b")["b"].to_numpy())
    np.testing.assert_array_equal(got_b, exp.index.to_numpy())
    np.testing.assert_array_equal(
        got.sort_values("b")["count"].to_numpy(), exp.to_numpy())


# -------------------------------------------------------------- strings
@pytest.fixture(scope="module")
def senv():
    rng = np.random.default_rng(999)
    words = np.array(["apple", "banana", "cherry", "date", "elder",
                      "fig", "grape", "Apple", "BANANA", "apricot"])
    df = pd.DataFrame({
        "s": words[rng.integers(0, len(words), N)],
        "v": rng.integers(0, 50, N),
    })
    hdk = hdk_jax.HDK()
    ht = hdk.import_pandas(df, name="fw_s")
    return hdk, ht, df


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_string_filter_group(senv, seed):
    hdk, ht, df = senv
    rng = np.random.default_rng(900 + seed)
    mode = int(rng.integers(0, 4))
    if mode == 0:
        lit = str(df["s"].iloc[int(rng.integers(0, N))])
        pred, mask = ht["s"] == lit, df["s"] == lit
    elif mode == 1:
        pat = ["a%", "%e", "%an%", "_pple"][int(rng.integers(0, 4))]
        regex = "^" + pat.replace("%", ".*").replace("_", ".") + "$"
        pred, mask = ht["s"].like(pat), df["s"].str.match(regex)
    elif mode == 2:
        pat = ["A%", "%RY", "%aN%"][int(rng.integers(0, 3))]
        regex = "^" + pat.replace("%", ".*").replace("_", ".") + "$"
        pred = ht["s"].ilike(pat)
        mask = df["s"].str.upper().str.match(regex.upper())
    else:
        thr = int(rng.integers(5, 45))
        pred, mask = ht["v"] < thr, df["v"] < thr
    got = (ht.filter(pred).agg(["s"], "count", "sum(v)")
           .run().to_pandas())
    sub = df[mask]
    if len(sub) == 0:
        assert len(got) == 0
        return
    g = sub.groupby("s")
    exp = pd.DataFrame({"count": g.size(), "v_sum": g["v"].sum()}
                       ).reset_index()
    exp.columns = list(got.columns)
    assert_frames_match(got, exp)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_string_distinct(senv, seed):
    hdk, ht, df = senv
    rng = np.random.default_rng(1000 + seed)
    thr = int(rng.integers(0, 50))
    got = (ht.filter(ht["v"] >= thr)
           .agg(["v"], ht["s"].count(distinct=True).name("nd"))
           .run().to_pandas())
    sub = df[df["v"] >= thr]
    exp = sub.groupby("v")["s"].nunique().reset_index()
    exp.columns = list(got.columns)
    assert_frames_match(got, exp)


# -------------------------------------------------------- masked unions
@pytest.mark.parametrize("seed", range(8))
def test_fuzz_masked_union(jenv, seed):
    """UNION ALL of two filtered scans feeding an aggregate — the
    masked-union path must not drop or duplicate filtered rows."""
    hdk, (tl, _, _), (lhs, _, _) = jenv
    rng = np.random.default_rng(1100 + seed)
    t1 = int(rng.integers(0, 55))
    t2 = int(rng.integers(0, 55))
    got = (tl.filter(tl["j"] > t1).union_all(tl.filter(tl["j"] <= t2))
           .agg(["li"], "count", "sum(lv)").run().to_pandas())
    sub = pd.concat([lhs[lhs["j"] > t1], lhs[lhs["j"] <= t2]])
    g = sub.groupby("li")
    exp = pd.DataFrame({"count": g.size(), "s": g["lv"].sum()}).reset_index()
    exp.columns = list(got.columns)
    assert_frames_match(got, exp)


# ------------------------------------------------- distributed sessions
@pytest.fixture(scope="module")
def distenv():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    rng = np.random.default_rng(1212)
    df = pd.DataFrame({
        "k": rng.integers(0, 500, 4096),
        "z": np.minimum(rng.zipf(1.4, 4096), 1000).astype(np.int64),
        "v": np.round(rng.normal(0, 3, 4096), 4),
    })
    dim = pd.DataFrame({
        "k": np.arange(500),
        "w": rng.integers(0, 20, 500),
    })
    hdk = hdk_jax.HDK(**{"dist.enable": True, "dist.num_devices": 4})
    td = hdk.import_pandas(df, name="fw_dist")
    tdim = hdk.import_pandas(dim, name="fw_dim")
    return hdk, td, tdim, df, dim


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_dist_groupby(distenv, seed):
    hdk, td, _, df, _ = distenv
    rng = np.random.default_rng(1300 + seed)
    key = ["k", "z"][int(rng.integers(0, 2))]
    thr = float(np.round(rng.uniform(-2, 2), 2))
    got = (td.filter(td["v"] > thr).agg([key], "count", "sum(v)", "max(v)")
           .run().to_pandas())
    sub = df[df["v"] > thr]
    g = sub.groupby(key)
    exp = pd.DataFrame({"count": g.size(), "s": g["v"].sum(),
                        "m": g["v"].max()}).reset_index()
    exp.columns = list(got.columns)
    assert_frames_match(got, exp)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_dist_join(distenv, seed):
    hdk, td, tdim, df, dim = distenv
    rng = np.random.default_rng(1400 + seed)
    thr = int(rng.integers(0, 20))
    got = (td.join(tdim.filter(tdim["w"] >= thr), "k", "k")
           .agg([], "count", "sum(w)").run().to_pandas())
    sub = df.merge(dim[dim["w"] >= thr], on="k")
    assert got["count"].iloc[0] == len(sub)
    if len(sub):
        assert got.iloc[0, 1] == sub["w"].sum()


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_dist_distinct(distenv, seed):
    hdk, td, _, df, _ = distenv
    rng = np.random.default_rng(1500 + seed)
    thr = float(np.round(rng.uniform(-1, 1), 2))
    got = (td.filter(td["v"] > thr)
           .agg(["z"], td["k"].count(distinct=True).name("nd"))
           .run().to_pandas())
    sub = df[df["v"] > thr]
    exp = sub.groupby("z")["k"].nunique().reset_index()
    exp.columns = list(got.columns)
    assert_frames_match(got, exp)


# ---------------------------------------------------- eager aggregation
@pytest.fixture(scope="module")
def eenv():
    """Session where the eager-agg rewrite fires on fuzz-sized tables;
    an identical rewrite-disabled session is the second oracle (same
    engine, agg-above-join plan) alongside pandas."""
    rng = np.random.default_rng(777)
    lhs = pd.DataFrame({
        "fk": rng.integers(0, 30, N),
        "v": np.round(rng.normal(0, 5, N), 4),
        "q": rng.integers(-3, 12, N),
        "g": rng.integers(0, 4, N),
    })
    lhs.loc[rng.random(N) < 0.08, "v"] = np.nan
    rhs = pd.DataFrame({
        "pk": np.concatenate([np.arange(30),
                              rng.integers(0, 30, 14)]),  # dup tail
        "cat": rng.integers(0, 5, 44),
        "rw": np.round(rng.normal(1, 2, 44), 4),
    })
    on_ = hdk_jax.HDK()
    on_.config.exec.eager_agg_min_rows = 32
    on_.config.exec.eager_agg_min_ratio = 1.0
    off = hdk_jax.HDK()
    off.config.exec.enable_eager_aggregation = False
    for h, suf in ((on_, "on"), (off, "off")):
        h.import_pandas(lhs, name="fe_l")
        h.import_pandas(rhs, name="fe_r")
    return on_, off, lhs, rhs


_EAGG = ["count", "sum(v)", "min(q)", "max(q)", "avg(v)", "sum(q)"]


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_eager_agg(eenv, seed):
    """Random key/agg/filter shapes through the eager-agg rewrite,
    checked against BOTH the rewrite-disabled plan (exact same engine
    semantics) and pandas."""
    on_, off, lhs, rhs = eenv
    rng = np.random.default_rng(9000 + seed)
    aggs = list(rng.choice(_EAGG, size=int(rng.integers(1, 4)),
                           replace=False))
    keys = list(rng.choice(["fk", "g", "cat"],
                           size=int(rng.integers(1, 3)), replace=False))
    thr = int(rng.integers(-3, 10))

    def build(h):
        tl, tr = h.scan("fe_l"), h.scan("fe_r")
        q = (tl.filter(tl["q"] > thr).join(tr, "fk", "pk")
             .agg(keys, *aggs))
        return q

    plan = on_.explain(build(on_))
    ji = plan.index("Join[inner]")
    assert "Aggregate" in plan[ji:], f"seed {seed}: rewrite did not fire"
    got = build(on_).run().to_pandas().sort_values(keys).reset_index(
        drop=True)
    ref = build(off).run().to_pandas().sort_values(keys).reset_index(
        drop=True)
    approx = tuple(c for c in got.columns if got[c].dtype.kind == "f")
    assert_frames_match(got, ref, approx_cols=approx)
    # pandas oracle
    sub = lhs[lhs["q"] > thr].merge(rhs, left_on="fk", right_on="pk")
    if len(sub) == 0:
        assert len(got) == 0
        return
    g = sub.groupby(keys)
    cols = {}
    for a in aggs:
        if a == "count":
            cols["count"] = g.size()
        else:
            fn, col = a.split("(")[0], a.split("(")[1][:-1]
            nm = {"sum": "sum", "min": "min", "max": "max",
                  "avg": "mean"}[fn]
            cols[f"{col}_{fn}"] = getattr(g[col], nm)()
    exp = pd.DataFrame(cols).reset_index()
    exp = exp.sort_values(keys).reset_index(drop=True)
    exp.columns = list(got.columns)
    assert_frames_match(got, exp, approx_cols=approx)
