"""Multi-key streaming top-n (exec/sort.py lex_topn).

The exact lexicographic top-n replaces the full payload sort for
multi-key ORDER BY + small LIMIT (reference analog: StreamingTopN.cpp
per-fragment heaps; multi-key was a deliberate r2 non-implementation
until TPC-H Q3's tail made it the measured bottleneck).  Must be
bit-identical to the stable full sort: ties resolve by row id, NULLs by
the sort_keys_int64 sentinels, dead rows sink past the validity window.
"""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


def test_lex_topn_matches_full_sort_fuzz(rng):
    """Direct parity vs the numpy stable-lexsort oracle over tied,
    masked and dead rows (one fixed shape: one compile per K)."""
    import jax.numpy as jnp

    from hdk_jax.exec.masked import MaskedCol
    from hdk_jax.exec.sort import lex_topn, sort_keys_int64

    n, topn = 257, 13
    for K in (1, 2, 3):
        for trial in range(8):
            cols, descs, nfs = [], [], []
            for _ in range(K):
                vals = rng.integers(0, 4, n).astype(np.int64)  # heavy ties
                mask = (rng.random(n) > 0.2) if trial % 2 else None
                cols.append(MaskedCol(
                    jnp.asarray(vals),
                    None if mask is None else jnp.asarray(mask)))
                descs.append(bool(rng.random() < 0.5))
                nfs.append(bool(rng.random() < 0.5))
            rm = (jnp.asarray(rng.random(n) > 0.3)
                  if trial % 3 == 0 else None)
            keys = sort_keys_int64(cols, descs, nfs)
            got = np.asarray(lex_topn(keys, topn, rm))
            knp = [np.asarray(k) for k in keys]
            dead = (np.zeros(n, bool) if rm is None
                    else ~np.asarray(rm))
            order = np.lexsort(tuple(
                [np.arange(n)] + list(reversed(knp)) + [dead]))
            nlive = int((~dead).sum())
            ncmp = min(topn, nlive)  # beyond live, the window masks
            assert (got[:ncmp] == order[:ncmp]).all(), (K, trial)


def test_sql_multikey_limit(hdk, rng):
    n = 5000
    df = pd.DataFrame({
        "a": rng.integers(0, 20, n),
        "b": rng.integers(0, 30, n),
        "v": rng.normal(size=n),
    })
    hdk.import_pandas(df, name="lt_t")
    res = hdk.sql(
        "SELECT a, b, v FROM lt_t ORDER BY a DESC, b, v LIMIT 25"
    ).to_pandas()
    exp = df.sort_values(["a", "b", "v"], ascending=[False, True, True],
                         kind="stable").head(25).reset_index(drop=True)
    assert_frames_match(res, exp, ordered=True)


def test_sql_multikey_limit_offset_nulls(hdk, rng):
    n = 3000
    b = rng.normal(size=n)
    b[rng.random(n) < 0.1] = np.nan
    df = pd.DataFrame({"a": rng.integers(0, 8, n), "b": b})
    hdk.import_pandas(df, name="lt_null_t")
    res = hdk.sql(
        "SELECT a, b FROM lt_null_t ORDER BY a, b DESC LIMIT 40 OFFSET 7"
    ).to_pandas()
    exp = (df.sort_values(["a", "b"], ascending=[True, False],
                          kind="stable", na_position="first")
           .iloc[7:47].reset_index(drop=True))
    assert list(res["a"]) == list(exp["a"])
    np.testing.assert_allclose(res["b"], exp["b"])


def test_sql_multikey_limit_filtered(hdk, rng):
    """Masked (filtered) source rows must never displace live rows
    inside the LIMIT window."""
    n = 4000
    df = pd.DataFrame({
        "a": rng.integers(0, 6, n),
        "b": rng.integers(0, 5, n),
        "f": rng.integers(0, 2, n),
    })
    hdk.import_pandas(df, name="lt_filt_t")
    res = hdk.sql(
        "SELECT a, b FROM lt_filt_t WHERE f = 1 "
        "ORDER BY b DESC, a LIMIT 15").to_pandas()
    exp = (df[df.f == 1].sort_values(["b", "a"],
                                     ascending=[False, True],
                                     kind="stable")
           .head(15)[["a", "b"]].reset_index(drop=True))
    assert_frames_match(res, exp, ordered=True)


def test_groupby_multikey_limit(hdk, rng):
    """The fused agg->sort multi-key branch (the TPC-H Q3 tail shape:
    GROUP BY ... ORDER BY agg DESC, key LIMIT n)."""
    n = 20000
    df = pd.DataFrame({
        "k": rng.integers(0, 500, n),
        "d": rng.integers(0, 4, n),
        "v": rng.integers(0, 100, n),
    })
    hdk.import_pandas(df, name="lt_gb_t")
    res = hdk.sql(
        "SELECT k, d, SUM(v) AS s FROM lt_gb_t GROUP BY k, d "
        "ORDER BY s DESC, k, d LIMIT 12").to_pandas()
    exp = (df.groupby(["k", "d"], as_index=False)["v"].sum()
           .rename(columns={"v": "s"})
           .sort_values(["s", "k", "d"], ascending=[False, True, True],
                        kind="stable").head(12).reset_index(drop=True))
    assert_frames_match(res, exp, ordered=True)


def test_fused_identity_tail_warm_repeat(hdk, rng):
    """The Q3 warm shape end-to-end: eager-agg pre-aggregate -> partials
    join -> fused identity+top-n tail, run TWICE — the second run rides
    plan-recycled join artifacts into the fused program and must match
    the pandas oracle exactly both times."""
    hdk2 = hdk_jax.HDK(**{"exec.eager_agg_min_rows": 1000,
                          "exec.eager_agg_min_ratio": 0.1,
                          "exec.enable_route_feedback": False})
    n_ord, n_li = 9000, 60000
    o = pd.DataFrame({
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_flag": rng.integers(0, 3, n_ord).astype(np.int8),
        "o_keep": rng.integers(0, 2, n_ord).astype(np.int8),
    })
    li = pd.DataFrame({
        "l_orderkey": rng.integers(0, n_ord, n_li),
        "l_price": rng.gamma(3.0, 100.0, n_li).astype(np.float32),
    })
    hdk2.import_pandas(o, name="ft_orders")
    hdk2.import_pandas(li, name="ft_li")
    sql = ("SELECT l_orderkey, o_flag, SUM(l_price) AS rev "
           "FROM ft_li, ft_orders WHERE l_orderkey = o_orderkey "
           "AND o_keep = 1 GROUP BY l_orderkey, o_flag "
           "ORDER BY rev DESC, l_orderkey LIMIT 20")
    m = li.merge(o[o.o_keep == 1], left_on="l_orderkey",
                 right_on="o_orderkey")
    m["rev"] = m.l_price.astype(np.float64)
    exp = (m.groupby(["l_orderkey", "o_flag"], as_index=False)
           .agg(rev=("rev", "sum"))
           .sort_values(["rev", "l_orderkey"], ascending=[False, True],
                        kind="stable").head(20).reset_index(drop=True))
    for run in range(2):
        res = hdk2.sql(sql).to_pandas()
        assert list(res.l_orderkey) == list(exp.l_orderkey), run
        np.testing.assert_allclose(res.rev.values, exp.rev.values,
                                   rtol=1e-6)


def test_limit_larger_than_live(hdk, rng):
    df = pd.DataFrame({"a": [3, 1, 2], "b": [9, 9, 1],
                       "f": [1, 1, 0]})
    hdk.import_pandas(df, name="lt_small_t")
    res = hdk.sql(
        "SELECT a, b FROM lt_small_t WHERE f = 1 "
        "ORDER BY b, a DESC LIMIT 10").to_pandas()
    exp = (df[df.f == 1].sort_values(["b", "a"],
                                     ascending=[True, False])
           [["a", "b"]].reset_index(drop=True))
    assert_frames_match(res, exp, ordered=True)
