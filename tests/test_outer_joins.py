"""RIGHT / FULL OUTER JOIN tests (binder canonicalization onto the
4-type IR, nd.outer_join_rewrite) plus LEFT-join residual ON coverage.

Reference capability: Calcite accepts RIGHT/FULL and canonicalizes
RIGHT to swapped LEFT before the reference IR (IR/Node.h:463) sees it;
residual ON quals compile into the outer-join loop (IRCodegen.cpp:513).
Oracle: pandas merge with SQL NULL-key semantics (NULL never matches),
so NaN keys are excluded from the match set and padded explicitly.
"""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


def _sql_outer_oracle(lhs, rhs, keys, how, residual=None):
    """pandas oracle with SQL semantics: NULL keys never match; the
    residual is applied to matched pairs before unmatched-row padding."""
    l2 = lhs.reset_index(drop=True).reset_index(names="__li")
    r2 = rhs.reset_index(drop=True).reset_index(names="__ri")
    lk = l2.dropna(subset=keys)
    rk = r2.dropna(subset=keys)
    m = lk.merge(rk, on=keys, how="inner", suffixes=("", "_r"))
    if residual is not None:
        m = m[residual(m)]
    out_cols = [c for c in lhs.columns] + [
        (c + "_r" if c in lhs.columns and c not in keys else c)
        for c in rhs.columns if c not in keys]
    parts = []
    mm = m.copy()
    for c in rhs.columns:
        if c in keys:
            mm[c + "_r"] = mm[c]
    matched = mm
    parts.append(matched)
    if how in ("left", "full"):
        un_l = l2[~l2["__li"].isin(m["__li"])].copy()
        for c in rhs.columns:
            un_l[c + "_r" if c in lhs.columns else c] = np.nan
        parts.append(un_l)
    if how in ("right", "full"):
        un_r = r2[~r2["__ri"].isin(m["__ri"])].copy()
        ren = {c: (c + "_r" if c in lhs.columns else c)
               for c in rhs.columns}
        un_r = un_r.rename(columns=ren)
        for c in lhs.columns:
            un_r[c] = np.nan
        parts.append(un_r)
    exp = pd.concat(parts, ignore_index=True)
    full_cols = list(lhs.columns) + [
        (c + "_r" if c in lhs.columns else c) for c in rhs.columns]
    return exp.reindex(columns=full_cols)


@pytest.fixture(scope="module")
def data(rng):
    lhs = pd.DataFrame({
        "k": [1, 2, 3, 4, None, 2],
        "a": [10.0, 20.0, 30.0, 40.0, 50.0, 60.0],
    })
    rhs = pd.DataFrame({
        "k": [1, 2, 2, 5, None],
        "x": [3.0, 6.0, 7.0, 9.0, 11.0],
    })
    big_l = pd.DataFrame({
        "k": rng.integers(0, 50, 800).astype(float),
        "a": rng.normal(size=800),
    })
    big_l.loc[rng.permutation(800)[:40], "k"] = None
    big_r = pd.DataFrame({
        "k": rng.integers(25, 75, 300).astype(float),
        "x": rng.normal(size=300),
    })
    big_r.loc[rng.permutation(300)[:20], "k"] = None
    return lhs, rhs, big_l, big_r


@pytest.fixture(scope="module")
def tables(hdk, data):
    lhs, rhs, big_l, big_r = data
    return (hdk.import_pandas(lhs, name="oj_l"),
            hdk.import_pandas(rhs, name="oj_r"),
            hdk.import_pandas(big_l, name="oj_bl"),
            hdk.import_pandas(big_r, name="oj_br"))


def test_right_join_sql(hdk, tables, data):
    lhs, rhs = data[0], data[1]
    res = hdk.sql("SELECT l.k, l.a, r.x FROM oj_l l "
                  "RIGHT JOIN oj_r r ON l.k = r.k").to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "right")
    # output k comes from the LHS: NULL on padded rows
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res, exp[["k", "a", "x"]])


def test_right_outer_join_residual(hdk, tables, data):
    lhs, rhs = data[0], data[1]
    res = hdk.sql("SELECT l.k, l.a, r.x FROM oj_l l RIGHT OUTER JOIN "
                  "oj_r r ON l.k = r.k AND l.a < 40").to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "right",
                            residual=lambda m: m["a"] < 40)
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res, exp[["k", "a", "x"]])


def test_full_outer_join_sql(hdk, tables, data):
    lhs, rhs = data[0], data[1]
    res = hdk.sql("SELECT l.k, l.a, r.k AS rk, r.x FROM oj_l l "
                  "FULL OUTER JOIN oj_r r ON l.k = r.k").to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "full")
    exp = exp.rename(columns={"k_r": "rk"})
    # l.k NULL on right-padded rows; r.k NULL on left-padded rows
    exp["rk"] = exp["k"].where(~exp["x"].isna() | exp["a"].isna())
    exp.loc[exp["a"].isna(), "k"] = np.nan
    # the padded r.k values come from rhs directly
    exp.loc[exp["a"].isna(), "rk"] = [
        v for v in rhs.loc[~rhs["k"].isin(
            lhs["k"].dropna()), "k"]]
    assert res.shape[0] == exp.shape[0]
    assert_frames_match(res[["k", "a", "x"]], exp[["k", "a", "x"]])


def test_full_join_residual(hdk, tables, data):
    lhs, rhs = data[0], data[1]
    res = hdk.sql("SELECT l.k, l.a, r.x FROM oj_l l FULL JOIN oj_r r "
                  "ON l.k = r.k AND r.x > 5").to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "full",
                            residual=lambda m: m["x"] > 5)
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res, exp[["k", "a", "x"]])


def test_right_join_larger_dup_keys(hdk, tables, data):
    big_l, big_r = data[2], data[3]
    res = hdk.sql("SELECT l.k, l.a, r.x FROM oj_bl l "
                  "RIGHT JOIN oj_br r ON l.k = r.k").to_pandas()
    exp = _sql_outer_oracle(big_l, big_r, ["k"], "right")
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res, exp[["k", "a", "x"]])


def test_full_join_larger_dup_keys(hdk, tables, data):
    big_l, big_r = data[2], data[3]
    res = hdk.sql("SELECT l.k, l.a, r.x FROM oj_bl l "
                  "FULL OUTER JOIN oj_br r ON l.k = r.k").to_pandas()
    exp = _sql_outer_oracle(big_l, big_r, ["k"], "full")
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res, exp[["k", "a", "x"]])


def test_builder_right_and_full(hdk, data):
    lhs, rhs = data[0], data[1]
    tl = hdk.import_pandas(lhs, name="ojb_l")
    tr = hdk.import_pandas(rhs, name="ojb_r")
    res = tl.join(tr, "k", "k", how="right").run().to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "right")
    exp["k_r"] = exp["k"].where(~exp["x"].isna())
    exp.loc[exp["a"].isna(), "k_r"] = [
        v for v in rhs.loc[~rhs["k"].isin(lhs["k"].dropna()), "k"]]
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res[["k", "a", "x"]], exp[["k", "a", "x"]])

    res = tl.join(tr, "k", "k", how="full").run().to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "full")
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res[["k", "a", "x"]], exp[["k", "a", "x"]])


def test_right_join_aggregate_above(hdk, tables, data):
    lhs, rhs = data[0], data[1]
    res = hdk.sql("SELECT r.x, COUNT(l.a) AS c FROM oj_l l "
                  "RIGHT JOIN oj_r r ON l.k = r.k "
                  "GROUP BY r.x ORDER BY r.x").to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "right")
    g = (exp.groupby("x", dropna=False)["a"]
         .count().reset_index(name="c").sort_values("x"))
    assert_frames_match(res, g.rename(columns={"x": "x"})[["x", "c"]],
                        ordered=True)


def test_left_join_residual_on_sql(hdk, tables, data):
    lhs, rhs = data[0], data[1]
    res = hdk.sql("SELECT l.k, l.a, r.x FROM oj_l l LEFT JOIN oj_r r "
                  "ON l.k = r.k AND r.x > 5").to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "left",
                            residual=lambda m: m["x"] > 5)
    assert_frames_match(res, exp[["k", "a", "x"]])


def test_full_join_string_keys(hdk):
    tl = hdk.import_pydict({"s": ["a", "b", None, "d"],
                            "v": [1, 2, 3, 4]}, name="oj_sl")
    tr = hdk.import_pydict({"s": ["a", "c", None], "w": [10, 30, 50]},
                           name="oj_sr")
    res = hdk.sql("SELECT l.v, r.w FROM oj_sl l FULL JOIN oj_sr r "
                  "ON l.s = r.s").to_pandas()
    exp = pd.DataFrame({
        "v": [1.0, 2.0, 3.0, 4.0, np.nan, np.nan],
        "w": [10.0, np.nan, np.nan, np.nan, 30.0, 50.0],
    })
    assert_frames_match(res, exp)


def test_right_join_dist_session(data):
    import hdk_jax as ht
    lhs, rhs = data[0], data[1]
    s = ht.HDK(**{"dist.enable": True})
    s.import_pandas(lhs, name="ojd_l")
    s.import_pandas(rhs, name="ojd_r")
    res = s.sql("SELECT l.k, l.a, r.x FROM ojd_l l "
                "RIGHT JOIN ojd_r r ON l.k = r.k").to_pandas()
    exp = _sql_outer_oracle(lhs, rhs, ["k"], "right")
    exp.loc[exp["a"].isna(), "k"] = np.nan
    assert_frames_match(res, exp[["k", "a", "x"]])
