"""Join tests, differential vs pandas merge
(reference: Tests/JoinHashTableTest.cpp, ArrowBasedExecuteTest join suites)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def dfs(rng):
    n_l, n_r = 3000, 500
    lhs = pd.DataFrame({
        "k": rng.integers(0, 600, n_l),
        "v": rng.normal(size=n_l),
    })
    rhs = pd.DataFrame({
        "k": rng.permutation(600)[:n_r],   # unique keys
        "w": rng.integers(0, 100, n_r),
    })
    dup = pd.DataFrame({
        "k": rng.integers(0, 50, 200),     # duplicate build keys
        "u": rng.normal(size=200),
    })
    return lhs, rhs, dup


@pytest.fixture(scope="module")
def tables(hdk, dfs):
    lhs, rhs, dup = dfs
    return (hdk.import_pandas(lhs, name="join_l"),
            hdk.import_pandas(rhs, name="join_r"),
            hdk.import_pandas(dup, name="join_dup"))


def test_inner_join_unique_build(tables, dfs):
    tl, tr, _ = tables
    lhs, rhs, _ = dfs
    res = tl.join(tr, "k", "k").run().to_pandas()
    exp = lhs.merge(rhs, on="k", how="inner", suffixes=("", "_r"))
    exp = exp.rename(columns={"k": "k"})
    exp.insert(2, "k_r", exp["k"])
    assert_frames_match(res, exp[["k", "v", "k_r", "w"]])


def test_inner_join_one_to_many(tables, dfs):
    tl, _, td = tables
    lhs, _, dup = dfs
    res = tl.join(td, "k", "k").run().to_pandas()
    exp = lhs.merge(dup, on="k", how="inner")
    exp.insert(2, "k_r", exp["k"])
    assert_frames_match(res, exp[["k", "v", "k_r", "u"]])


def test_left_join(tables, dfs):
    tl, tr, _ = tables
    lhs, rhs, _ = dfs
    res = tl.join(tr, "k", "k", how="left").run().to_pandas()
    exp = lhs.merge(rhs, on="k", how="left")
    exp.insert(2, "k_r", exp["k"].where(exp["w"].notna()))
    assert_frames_match(res, exp[["k", "v", "k_r", "w"]])


def test_semi_join(tables, dfs):
    tl, tr, _ = tables
    lhs, rhs, _ = dfs
    res = tl.join(tr, "k", "k", how="semi").run().to_pandas()
    exp = lhs[lhs["k"].isin(rhs["k"])]
    assert_frames_match(res, exp)


def test_anti_join(tables, dfs):
    tl, tr, _ = tables
    lhs, rhs, _ = dfs
    res = tl.join(tr, "k", "k", how="anti").run().to_pandas()
    exp = lhs[~lhs["k"].isin(rhs["k"])]
    assert_frames_match(res, exp)


def test_multikey_join(hdk, rng):
    n = 1000
    lhs = pd.DataFrame({"a": rng.integers(0, 10, n),
                        "b": rng.integers(0, 10, n),
                        "v": np.arange(n)})
    rhs = pd.DataFrame({"a": np.repeat(np.arange(10), 10),
                        "b": np.tile(np.arange(10), 10),
                        "w": np.arange(100) * 2})
    tl = hdk.import_pandas(lhs, name="mk_l")
    tr = hdk.import_pandas(rhs, name="mk_r")
    res = tl.join(tr, ["a", "b"], ["a", "b"]).run().to_pandas()
    exp = lhs.merge(rhs, on=["a", "b"], how="inner")
    exp.insert(3, "a_r", exp["a"])
    exp.insert(4, "b_r", exp["b"])
    assert_frames_match(res, exp[["a", "b", "v", "a_r", "b_r", "w"]])


def test_null_keys_never_match(hdk):
    lhs = {"k": [1, None, 2, None], "v": [1, 2, 3, 4]}
    rhs = {"k": [1, None, 3], "w": [10, 20, 30]}
    tl = hdk.import_pydict(lhs, name="nk_l")
    tr = hdk.import_pydict(rhs, name="nk_r")
    res = tl.join(tr, "k", "k").run().to_pandas()
    assert res.shape[0] == 1
    assert res["v"][0] == 1 and res["w"][0] == 10
    # anti: null-key lhs rows are kept (NOT EXISTS semantics)
    anti = tl.join(tr, "k", "k", how="anti").run().to_pandas()
    assert sorted(anti["v"]) == [2, 3, 4]


def test_string_key_join(hdk):
    tl = hdk.import_pydict({"s": ["a", "b", "c", "a"], "v": [1, 2, 3, 4]},
                           name="sk_l")
    tr = hdk.import_pydict({"s": ["a", "c"], "w": [10, 30]}, name="sk_r")
    res = tl.join(tr, "s", "s").run().to_pandas()
    exp = pd.DataFrame({"s": ["a", "a", "c"], "v": [1, 4, 3],
                        "s_r": ["a", "a", "c"], "w": [10, 10, 30]})
    assert_frames_match(res, exp)


def test_join_residual_condition(tables, dfs):
    tl, tr, _ = tables
    lhs, rhs, _ = dfs
    cond = tl["v"] > tr["w"].cast("fp64") / 100.0
    res = tl.join(tr, "k", "k", cond=cond).run().to_pandas()
    exp = lhs.merge(rhs, on="k", how="inner")
    exp = exp[exp["v"] > exp["w"] / 100.0]
    exp.insert(2, "k_r", exp["k"])
    assert_frames_match(res, exp[["k", "v", "k_r", "w"]])


def test_join_then_groupby(tables, dfs):
    tl, tr, _ = tables
    lhs, rhs, _ = dfs
    joined = tl.join(tr, "k", "k")
    res = joined.agg("w", "count", "sum(v)").run().to_pandas()
    m = lhs.merge(rhs, on="k", how="inner")
    exp = m.groupby("w").agg(count=("w", "size"), v_sum=("v", "sum")).reset_index()
    assert_frames_match(res, exp)


def test_empty_probe_and_build(hdk):
    tl = hdk.import_pydict({"k": [1, 2], "v": [1, 2]}, name="ej_l")
    tr = hdk.import_pydict({"k": [5], "w": [9]}, name="ej_r")
    assert tl.join(tr, "k", "k").run().row_count == 0
    left = tl.join(tr, "k", "k", how="left").run().to_pandas()
    assert left.shape[0] == 2 and left["w"].isna().all()


def test_perfect_join_dense_range(hdk):
    """Unique small-range int build keys take the dense direct-index
    path (PerfectJoinHashTable analog); results identical to generic."""
    lhs = pd.DataFrame({"k": [5, 3, 9, 5, 100], "v": [1, 2, 3, 4, 5]})
    rhs = pd.DataFrame({"k": [3, 5, 9], "w": [30, 50, 90]})
    tl = hdk.import_pandas(lhs, name="pj_l")
    tr = hdk.import_pandas(rhs, name="pj_r")
    for how in ("inner", "left", "semi", "anti"):
        got = tl.join(tr, "k", "k", how=how).run().to_pandas()
        if how == "inner":
            exp = lhs.merge(rhs, on="k")
            assert sorted(got["w"]) == sorted(exp["w"])
        elif how == "left":
            exp = lhs.merge(rhs, on="k", how="left")
            assert got["w"].isna().sum() == 1
            assert sorted(got["w"].dropna()) == sorted(exp["w"].dropna())
        elif how == "semi":
            assert sorted(got["v"]) == [1, 2, 3, 4]
        else:
            assert list(got["v"]) == [5]


def test_perfect_join_falls_back_on_duplicates(hdk):
    lhs = pd.DataFrame({"k": [1, 2, 2], "v": [10, 20, 30]})
    rhs = pd.DataFrame({"k": [2, 2, 3], "w": [7, 8, 9]})  # dup build keys
    tl = hdk.import_pandas(lhs, name="pjd_l")
    tr = hdk.import_pandas(rhs, name="pjd_r")
    got = tl.join(tr, "k", "k").run().to_pandas()
    exp = lhs.merge(rhs, on="k")
    assert_frames_match(got[["k", "v", "w"]], exp[["k", "v", "w"]])


def test_left_join_residual_on(hdk, rng):
    """LEFT ... ON k-equality AND residual: unmatched-by-residual rows
    are kept with null right side (SQL ON semantics)."""
    lhs = pd.DataFrame({"k": rng.integers(0, 10, 200),
                        "v": rng.integers(0, 100, 200)})
    rhs = pd.DataFrame({"k": np.arange(10), "w": rng.integers(0, 100, 10)})
    tl = hdk.import_pandas(lhs, name="lr_l")
    tr = hdk.import_pandas(rhs, name="lr_r")
    got = tl.join(tr, "k", "k", how="left",
                  cond=tr["w"] > 50).run().to_pandas()
    exp = lhs.merge(rhs[rhs["w"] > 50], on="k", how="left")
    assert got.shape[0] == exp.shape[0]
    gs = got.sort_values(["k", "v"]).reset_index(drop=True)
    es = exp.sort_values(["k", "v"]).reset_index(drop=True)
    assert (gs["w"].isna().values == es["w"].isna().values).all()
    np.testing.assert_array_equal(gs["w"].dropna().values,
                                  es["w"].dropna().values)


def test_semi_anti_residual(hdk, rng):
    lhs = pd.DataFrame({"k": rng.integers(0, 8, 150),
                        "v": rng.integers(0, 100, 150)})
    rhs = pd.DataFrame({"k": np.arange(8), "w": rng.integers(0, 100, 8)})
    tl = hdk.import_pandas(lhs, name="sr_l")
    tr = hdk.import_pandas(rhs, name="sr_r")
    m = lhs.reset_index().merge(rhs, on="k")
    match_idx = set(m[m["v"] > m["w"]]["index"])
    semi = tl.join(tr, "k", "k", how="semi", cond=tl["v"] > tr["w"]).run()
    anti = tl.join(tr, "k", "k", how="anti", cond=tl["v"] > tr["w"]).run()
    assert semi.row_count == len(match_idx)
    assert anti.row_count == len(lhs) - len(match_idx)


def test_mixed_numeric_key_types(hdk, rng):
    """INT join key vs DOUBLE join key (e.g. from an IN subquery over a
    float column): both sides promote to the common type before hashing
    (reference: normalize_column_pairs), so 31 matches 31.0."""
    lhs = pd.DataFrame({"k": np.arange(20, dtype=np.int64)})
    rhs = pd.DataFrame({"kf": np.arange(0, 40, 2).astype(np.float64),
                        "w": np.arange(20)})
    tl = hdk.import_pandas(lhs, name="mix_l")
    tr = hdk.import_pandas(rhs, name="mix_r")
    res = tl.join(tr, "k", "kf").run().to_pandas()
    exp = lhs.merge(rhs, left_on="k", right_on="kf")
    assert sorted(res["k"].tolist()) == sorted(exp["k"].tolist())
    # non-integral floats match nothing
    rhs2 = pd.DataFrame({"kf": np.arange(20) + 0.5, "w": np.arange(20)})
    tr2 = hdk.import_pandas(rhs2, name="mix_r2")
    assert len(tl.join(tr2, "k", "kf").run().to_pandas()) == 0


def test_filtered_join_masked_inputs(hdk, rng):
    """Filtered join inputs stay masked (no eager compaction): dead rows
    must never match, for every join type."""
    lhs = pd.DataFrame({"k": rng.integers(0, 30, 500),
                        "f": rng.integers(0, 2, 500)})
    rhs = pd.DataFrame({"k": np.arange(30), "g": rng.integers(0, 2, 30),
                        "w": rng.normal(size=30)})
    tl = hdk.import_pandas(lhs, name="mj_l")
    tr = hdk.import_pandas(rhs, name="mj_r")
    fl = lhs[lhs.f == 1]
    fr = rhs[rhs.g == 1]
    inner = (tl.filter(tl["f"] == 1).join(tr.filter(tr["g"] == 1), "k", "k")
             .run().to_pandas())
    exp = fl.merge(fr, on="k")
    assert len(inner) == len(exp)
    anti = (tl.filter(tl["f"] == 1)
            .join(tr.filter(tr["g"] == 1), "k", "k", how="anti")
            .run().to_pandas())
    exp_anti = fl[~fl.k.isin(fr.k)]
    assert sorted(anti["k"].tolist()) == sorted(exp_anti["k"].tolist())
    left = (tl.filter(tl["f"] == 1)
            .join(tr.filter(tr["g"] == 1), "k", "k", how="left")
            .run().to_pandas())
    assert len(left) == len(fl)


def test_masked_build_cache_not_poisoned(hdk, rng):
    """Two different filters over the SAME build table share column
    buffers when inputs stay masked — the hashtable/value-table caches
    must key on the row_mask too, or the second query reuses the first
    filter's build table."""
    lhs = pd.DataFrame({"k": rng.integers(0, 40, 2000)})
    rhs = pd.DataFrame({"k": np.arange(40), "g": np.arange(40) % 4,
                        "w": np.arange(40, dtype=np.float32)})
    tl = hdk.import_pandas(lhs, name="cp_l")
    tr = hdk.import_pandas(rhs, name="cp_r")
    for gval in (0, 1, 2):
        got = (tl.join(tr.filter(tr["g"] == gval), "k", "k")
               .agg([], "count", "sum(w)").run().to_pandas())
        sub = rhs[rhs.g == gval]
        exp = lhs.merge(sub, on="k")
        assert got["count"].iloc[0] == len(exp), f"g={gval}"
        assert np.isclose(got["w_sum"].iloc[0], exp["w"].sum(),
                          rtol=1e-4), f"g={gval}"
