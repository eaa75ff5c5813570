"""Aggregation tests, differential vs pandas
(reference: Tests/GroupByTest.cpp, ArrowBasedExecuteTest.cpp)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def data(rng):
    n = 5000
    df = pd.DataFrame({
        "k_small": rng.integers(0, 5, n),          # perfect-hash path
        "k_big": rng.integers(0, 10**9, n),        # sort/baseline path
        "k2": rng.integers(-3, 4, n),
        "v_int": rng.integers(-100, 100, n),
        "v_f": rng.normal(size=n) * 10,
    })
    # sprinkle nulls
    vi = df["v_int"].astype("float64")
    vi[rng.random(n) < 0.1] = np.nan
    df["v_null"] = vi
    return df


@pytest.fixture(scope="module")
def ht(hdk, data):
    return hdk.import_pandas(data, name="gb_t")


def _pd_gb(data, keys, **aggs):
    out = data.groupby(keys, dropna=False).agg(**aggs).reset_index()
    return out


def test_perfect_hash_groupby(ht, data):
    res = ht.agg("k_small", "count", "sum(v_int)", "min(v_int)",
                 "max(v_int)").run().to_pandas()
    exp = _pd_gb(data, ["k_small"], count=("k_small", "size"),
                 v_int_sum=("v_int", "sum"), v_int_min=("v_int", "min"),
                 v_int_max=("v_int", "max"))
    exp.columns = ["k_small", "count", "v_int_sum", "v_int_min", "v_int_max"]
    assert_frames_match(res, exp)


def test_baseline_groupby(ht, data):
    res = ht.agg("k_big", "count", "avg(v_f)").run().to_pandas()
    exp = _pd_gb(data, ["k_big"], count=("k_big", "size"),
                 v_f_avg=("v_f", "mean"))
    exp.columns = ["k_big", "count", "v_f_avg"]
    assert_frames_match(res, exp)


def test_multikey_groupby(ht, data):
    res = ht.agg(["k_small", "k2"], "count", "sum(v_f)").run().to_pandas()
    exp = data.groupby(["k_small", "k2"], dropna=False).agg(
        count=("k2", "size"), v_f_sum=("v_f", "sum")).reset_index()
    exp.columns = ["k_small", "k2", "count", "v_f_sum"]
    assert_frames_match(res, exp)


def test_null_skipping_aggs(ht, data):
    res = ht.agg("k_small", "count(v_null)", "sum(v_null)",
                 "avg(v_null)").run().to_pandas()
    exp = data.groupby("k_small", dropna=False).agg(
        v_null_count=("v_null", "count"), v_null_sum=("v_null", "sum"),
        v_null_avg=("v_null", "mean")).reset_index()
    exp.columns = ["k_small", "v_null_count", "v_null_sum", "v_null_avg"]
    assert_frames_match(res, exp)


def test_null_key_is_a_group(hdk):
    ht = hdk.import_pydict(
        {"k": [1, None, 1, None, 2], "v": [1, 2, 3, 4, 5]}, name="nullkey_t")
    res = ht.agg("k", "sum(v)").run().to_pandas()
    exp = pd.DataFrame({"k": [1.0, 2.0, None], "v_sum": [4, 5, 6]})
    assert_frames_match(res, exp)


def test_global_agg(ht, data):
    res = ht.agg([], "count", "sum(v_int)", "avg(v_f)", "min(v_f)",
                 "max(v_f)").run().to_pandas()
    assert res.shape[0] == 1
    assert res["count"][0] == len(data)
    assert res["v_int_sum"][0] == data["v_int"].sum()
    np.testing.assert_allclose(res["v_f_avg"][0], data["v_f"].mean())


def test_global_agg_empty_input(ht):
    res = ht.filter(ht["k_small"] > 1000).agg([], "count", "sum(v_int)").run()
    pdf = res.to_pandas()
    assert pdf["count"][0] == 0
    assert pd.isna(pdf["v_int_sum"][0])


def test_count_distinct(ht, data):
    res = ht.agg("k_small", ht["k2"].count(distinct=True).name("nd"),
                 ht["k2"].approx_count_distinct().name("nda")).run().to_pandas()
    exp = data.groupby("k_small").agg(
        nd=("k2", "nunique")).reset_index()
    exp.columns = ["k_small", "nd"]
    assert_frames_match(res[["k_small", "nd"]], exp)
    # approx_count_distinct is now a real HLL sketch (reference:
    # HyperLogLog.h) — approximate, within the p=11 error envelope
    merged = res.merge(exp, on="k_small", suffixes=("", "_exp"))
    np.testing.assert_allclose(merged["nda"].to_numpy(float),
                               merged["nd_exp"].to_numpy(float),
                               rtol=0.1, atol=2)


def test_stddev_var(ht, data):
    res = ht.agg("k_small", "stddev(v_f)", "var(v_f)").run().to_pandas()
    exp = data.groupby("k_small").agg(
        v_f_stddev=("v_f", "std"), v_f_var=("v_f", "var")).reset_index()
    exp.columns = ["k_small", "v_f_stddev", "v_f_var"]
    assert_frames_match(res, exp, approx_cols=("v_f_stddev", "v_f_var"))


def test_quantile_median(ht, data):
    res = ht.agg("k_small", ht["v_f"].quantile(0.5).name("med")).run().to_pandas()
    exp = data.groupby("k_small").agg(med=("v_f", "median")).reset_index()
    assert_frames_match(res, exp, approx_cols=("med",))


def test_agg_on_expression_key(ht, data):
    res = ht.agg(ht["k_small"].cast("int64").name("k2x"),
                 "count").run().to_pandas()
    exp = data.groupby("k_small").size().reset_index(name="count")
    exp.columns = ["k2x", "count"]
    assert_frames_match(res, exp)


def test_agg_then_filter_chain(ht, data):
    res = ht.agg("k_small", "count").run()
    chained = res.scan
    out = chained.filter(chained["count"] > 900).run().to_pandas()
    exp = data.groupby("k_small").size().reset_index(name="count")
    exp = exp[exp["count"] > 900]
    exp.columns = ["k_small", "count"]
    assert_frames_match(out, exp)


def test_bool_key(hdk):
    ht = hdk.import_pydict(
        {"b": np.asarray([True, False, True, True]), "v": [1, 2, 3, 4]},
        name="boolkey_t")
    res = ht.agg("b", "sum(v)").run().to_pandas()
    exp = pd.DataFrame({"b": [False, True], "v_sum": [2, 8]})
    assert_frames_match(res, exp)


def test_sample_single_value(hdk):
    ht = hdk.import_pydict({"k": [1, 1, 2], "v": [7, 7, 9]}, name="sv_t")
    res = ht.agg("k", ht["v"].single_value().name("sv")).run().to_pandas()
    exp = pd.DataFrame({"k": [1, 2], "sv": [7, 9]})
    assert_frames_match(res, exp)


def test_corr(ht, data):
    res = ht.agg("k_small", ht["v_f"].corr(ht["v_int"]).name("r")).run().to_pandas()
    exp = (data.groupby("k_small")
           .apply(lambda g: g["v_f"].corr(g["v_int"].astype(float)),
                  include_groups=False).reset_index(name="r"))
    assert_frames_match(res, exp, approx_cols=("r",))


def test_top_k_bottom_k(hdk):
    ht = hdk.import_pydict(
        {"k": [1, 1, 1, 1, 2, 2], "v": [5, 9, 1, 7, 3, 8]}, name="topk_t")
    res = ht.agg("k", ht["v"].top_k(2).name("t"),
                 ht["v"].bottom_k(2).name("b")).run().to_pandas()
    res = res.sort_values("k").reset_index(drop=True)
    assert list(res["t"][0]) == [9, 7] and list(res["b"][0]) == [1, 5]
    assert list(res["t"][1]) == [8, 3] and list(res["b"][1]) == [3, 8]


def test_top_k_with_nulls(hdk):
    ht = hdk.import_pydict(
        {"k": [1, 1, 1], "v": [5.0, None, 7.0]}, name="topk_n")
    res = ht.agg("k", ht["v"].top_k(3).name("t")).run().to_pandas()
    assert list(res["t"][0]) == [7.0, 5.0]  # nulls excluded, ragged list
