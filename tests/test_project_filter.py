"""Scalar expressions, projection, filtering
(reference: ArrowBasedExecuteTest.cpp expression coverage)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def ht(hdk):
    return hdk.import_pydict({
        "i": [1, 2, 3, 4, 5],
        "j": [10, None, 30, None, 50],
        "f": [1.5, 2.5, -3.5, 4.5, 5.5],
        "s": ["apple", "banana", "apricot", None, "cherry"],
        "b": np.asarray([True, False, True, False, True]),
    }, name="pf_t")


def test_arith(ht):
    out = ht.proj(x=ht["i"] + 1, y=ht["i"] * ht["f"], z=ht["i"] - 10,
                  w=ht["f"] / 2).run().to_pandas()
    assert list(out["x"]) == [2, 3, 4, 5, 6]
    np.testing.assert_allclose(out["y"], [1.5, 5.0, -10.5, 18.0, 27.5])
    assert list(out["z"]) == [-9, -8, -7, -6, -5]
    np.testing.assert_allclose(out["w"], [0.75, 1.25, -1.75, 2.25, 2.75])


def test_int_division_truncates(ht):
    # C semantics: -7 / 2 == -3 (reference: ArithmeticIR.cpp sdiv)
    out = ht.proj(q=(ht["i"] - 8) / 2, m=(ht["i"] - 8) % 3).run().to_pandas()
    assert list(out["q"]) == [-3, -3, -2, -2, -1]
    assert list(out["m"]) == [-1, 0, -2, -1, 0]


def test_null_propagation(ht):
    out = ht.proj(x=ht["j"] + 1, n=ht["j"].is_null(),
                  nn=ht["j"].is_not_null()).run().to_pandas()
    assert out["x"].isna().tolist() == [False, True, False, True, False]
    assert list(out["n"]) == [False, True, False, True, False]
    assert list(out["nn"]) == [True, False, True, False, True]


def test_three_valued_logic(hdk):
    ht = hdk.import_pydict({
        "p": [True, True, True, False, False, False, None, None, None],
        "q": [True, False, None, True, False, None, True, False, None],
    }, name="tvl_t")
    out = ht.proj(a=ht["p"] & ht["q"], o=ht["p"] | ht["q"]).run().to_pandas()
    # Kleene AND: F dominates; OR: T dominates
    assert out["a"].tolist() == [True, False, None, False, False, False,
                                 None, False, None]
    assert out["o"].tolist() == [True, True, True, True, False, None,
                                 True, None, None]


def test_comparisons_and_filter(ht):
    out = ht.filter(ht["i"] >= 2, ht["f"] > 0).proj("i").run().to_pandas()
    assert list(out["i"]) == [2, 4, 5]
    out2 = ht.filter((ht["i"] == 1) | (ht["i"] == 5)).proj("i").run().to_pandas()
    assert list(out2["i"]) == [1, 5]


def test_filter_null_condition_drops_row(ht):
    # NULL condition excludes the row (SQL WHERE semantics)
    out = ht.filter(ht["j"] > 5).proj("i").run().to_pandas()
    assert list(out["i"]) == [1, 3, 5]


def test_case_expr(ht, hdk):
    e = hdk.if_then_else(ht["i"] > 3, ht["i"] * 100, 0 - ht["i"])
    out = ht.proj(c=e).run().to_pandas()
    assert list(out["c"]) == [-1, -2, -3, 400, 500]


def test_case_null_branches(ht, hdk):
    e = hdk.if_then_else(ht["j"].is_null(), hdk.cst(None, "int64"), ht["j"] * 2)
    out = ht.proj(c=e).run().to_pandas()
    assert out["c"].isna().tolist() == [False, True, False, True, False]
    assert out["c"].dropna().tolist() == [20, 60, 100]


def test_cast(ht):
    out = ht.proj(a=ht["f"].cast("int32"), b=ht["i"].cast("fp32"),
                  c=ht["b"].cast("int64")).run().to_pandas()
    # float->int truncates toward zero
    assert list(out["a"]) == [1, 2, -3, 4, 5]
    np.testing.assert_allclose(out["b"], [1, 2, 3, 4, 5])
    assert list(out["c"]) == [1, 0, 1, 0, 1]


def test_in_values(ht):
    out = ht.filter(ht["i"].in_values([2, 5, 99])).proj("i").run().to_pandas()
    assert list(out["i"]) == [2, 5]
    out2 = ht.filter(ht["s"].in_values(["apple", "cherry"])).proj("s").run().to_pandas()
    assert list(out2["s"]) == ["apple", "cherry"]


def test_like(ht):
    out = ht.filter(ht["s"].like("ap%")).proj("s").run().to_pandas()
    assert sorted(out["s"]) == ["apple", "apricot"]
    out2 = ht.filter(ht["s"].ilike("%AN%")).proj("s").run().to_pandas()
    assert list(out2["s"]) == ["banana"]
    out3 = ht.filter(ht["s"].regexp("^a.*t$")).proj("s").run().to_pandas()
    assert list(out3["s"]) == ["apricot"]


def test_string_eq_constant(ht):
    out = ht.filter(ht["s"] == "banana").proj("i").run().to_pandas()
    assert list(out["i"]) == [2]
    # non-existent string matches nothing
    out2 = ht.filter(ht["s"] == "zzz").run()
    assert out2.row_count == 0


def test_not(ht):
    out = ht.filter(~ht["b"]).proj("i").run().to_pandas()
    assert list(out["i"]) == [2, 4]


def test_neg(ht):
    out = ht.proj(n=-ht["i"]).run().to_pandas()
    assert list(out["n"]) == [-1, -2, -3, -4, -5]


def test_decimal_arith(hdk):
    ht = hdk.import_pydict(
        {"d": [100, 250, -325]},
        name="dec_t", schema={"d": hdk_jax.types.decimal64(10, 2)})
    # d is 1.00, 2.50, -3.25
    out = ht.proj(s=ht["d"] + ht["d"], m=ht["d"] * 2,
                  f=ht["d"].cast("fp64")).run()
    pdf = out.to_pandas()
    assert [float(x) for x in pdf["s"]] == [2.0, 5.0, -6.5]
    assert [float(x) for x in pdf["m"]] == [2.0, 5.0, -6.5]
    np.testing.assert_allclose(pdf["f"], [1.0, 2.5, -3.25])


def test_projection_of_constant(ht):
    out = ht.proj("i", k=ht["i"] * 0 + 7).run().to_pandas()
    assert list(out["k"]) == [7] * 5


def test_empty_filter_result(ht):
    out = ht.filter(ht["i"] > 100).run()
    assert out.row_count == 0
    assert out.to_pandas().shape[0] == 0


def test_lower_upper(hdk):
    ht = hdk.import_pydict({
        "s": ["Apple", "BANANA", None, "Cherry", "apple"],
    }, name="lu_t")
    out = ht.proj(lo=ht["s"].lower(), up=ht["s"].upper()).run().to_pandas()
    lo = [None if pd.isna(x) else x for x in out["lo"]]
    up = [None if pd.isna(x) else x for x in out["up"]]
    assert lo == ["apple", "banana", None, "cherry", "apple"]
    assert up == ["APPLE", "BANANA", None, "CHERRY", "APPLE"]
    # SQL path + grouping by the transformed column
    res = hdk.sql(
        "SELECT LOWER(s) AS l, COUNT(*) AS n FROM lu_t "
        "GROUP BY LOWER(s) ORDER BY l").to_pandas()
    l = [None if pd.isna(x) else x for x in res["l"]]
    assert l in ([None, "apple", "banana", "cherry"],
                 ["apple", "banana", "cherry", None])
    assert sorted(res["n"].tolist()) == [1, 1, 1, 2]


def test_char_length(hdk):
    ht = hdk.import_pydict({"s": ["a", "abc", None, ""]}, name="cl_t")
    out = hdk.sql("SELECT CHAR_LENGTH(s) AS n, LENGTH(s) AS m FROM cl_t")\
        .to_pandas()
    n = [None if pd.isna(x) else int(x) for x in out["n"]]
    assert n == [1, 3, None, 0]
