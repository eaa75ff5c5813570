"""Sort/limit tests (reference: Tests/ParallelSortTest.cpp, TopKTest.cpp)."""

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
    n = 2000
    df = pd.DataFrame({
        "a": rng.integers(0, 50, n),
        "b": rng.normal(size=n),
        "s": rng.choice(["x", "y", "z"], n),
    })
    bn = df["b"].copy()
    bn[rng.random(n) < 0.05] = np.nan
    df["bn"] = bn
    return df


@pytest.fixture(scope="module")
def ht(hdk, data):
    return hdk.import_pandas(data, name="sort_t")


def test_single_key_asc(ht, data):
    res = ht.sort("a").run().to_pandas()
    exp = data.sort_values("a", kind="stable").reset_index(drop=True)
    assert list(res["a"]) == list(exp["a"])


def test_single_key_desc(ht, data):
    res = ht.sort(("b", "desc")).run().to_pandas()
    exp = data.sort_values("b", ascending=False, kind="stable")
    np.testing.assert_allclose(res["b"], exp["b"])


def test_multi_key(ht, data):
    res = ht.sort("a", ("b", "desc")).run().to_pandas()
    exp = data.sort_values(["a", "b"], ascending=[True, False],
                           kind="stable").reset_index(drop=True)
    assert list(res["a"]) == list(exp["a"])
    np.testing.assert_allclose(res["b"], exp["b"])


def test_nulls_last_default_asc(ht, data):
    # reference default: nulls sort last on ASC (IR/Node.h SortField)
    res = ht.sort("bn").run().to_pandas()
    n_null = data["bn"].isna().sum()
    assert res["bn"].tail(n_null).isna().all()
    head = res["bn"].head(len(data) - n_null)
    assert (head.values[:-1] <= head.values[1:]).all()


def test_nulls_first_default_desc(ht, data):
    res = ht.sort(("bn", "desc")).run().to_pandas()
    n_null = data["bn"].isna().sum()
    assert res["bn"].head(n_null).isna().all()


def test_explicit_null_placement(ht, data):
    res = ht.sort(("bn", "asc", "nulls_first")).run().to_pandas()
    n_null = data["bn"].isna().sum()
    assert res["bn"].head(n_null).isna().all()


def test_limit_offset(ht, data):
    res = ht.sort("a", limit=10, offset=5).run().to_pandas()
    exp = data.sort_values("a", kind="stable").iloc[5:15]
    assert list(res["a"]) == list(exp["a"])
    assert res.shape[0] == 10


def test_limit_without_sort(ht):
    res = ht.limit(7).run()
    assert res.row_count == 7


def test_sort_string_column(ht, data):
    res = ht.sort("s", "a").run().to_pandas()
    exp = data.sort_values(["s", "a"], kind="stable")
    assert list(res["s"]) == list(exp["s"])


def test_topk_pattern(ht, data):
    # classic ORDER BY count DESC LIMIT k over groupby (taxi Q4 shape)
    res = ht.agg("a", "count").sort(("count", "desc"), "a", limit=5).run().to_pandas()
    exp = (data.groupby("a").size().reset_index(name="count")
           .sort_values(["count", "a"], ascending=[False, True], kind="stable")
           .head(5).reset_index(drop=True))
    assert_frames_match(res, exp, ordered=True)


def test_sort_with_array_column_payload(hdk, rng):
    """ORDER BY with a fixed-width ARRAY column in the output: 2D
    payloads ride the payload-carrying sort (r2 ADVICE follow-up)."""
    import pandas as pd

    n = 500
    k = rng.integers(0, 100, n)
    arrs = [[int(x) for x in row] for row in rng.integers(0, 9, (n, 3))]
    t = hdk.import_pydict({"k": k, "a": arrs}, name="sortarr_t")
    got = t.sort(("k", "desc")).run().to_pandas()
    order = np.argsort(-k, kind="stable")
    assert got["k"].tolist() == k[order].tolist()
    exp_a = [arrs[i] for i in order]
    assert [list(v) for v in got["a"]] == exp_a
