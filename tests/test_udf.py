"""User-defined scalar functions (reference: UdfCompiler.h:30,
Tests/UdfTest.cpp — here UDFs are jax-traceable functions fusing into
the query program; see hdk_jax/udf.py)."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

import hdk_jax
from hdk_jax import types as t
from harness import assert_frames_match


@pytest.fixture()
def hdk():
    return hdk_jax.HDK()


@pytest.fixture()
def ht(hdk):
    return hdk.import_pydict({
        "a": [3, 12, 25, 8, None],
        "b": [2, 8, 5, 3, 7],
        "x": [0.5, 1.5, -2.0, 3.25, 0.0],
    }, name="udf_t")


def test_builder_udf(hdk, ht):
    hdk.register_udf("gcd", lambda a, b: jnp.gcd(a, b),
                     arg_types=[t.int64(), t.int64()], ret_type=t.int64())
    out = ht.proj(g=hdk.call("gcd", ht["a"], ht["b"])).run().to_pandas()
    assert out["g"].tolist()[:4] == [1, 4, 5, 1]
    assert pd.isna(out["g"].iloc[4])


def test_sql_udf(hdk, ht):
    hdk.register_udf("relu6", lambda x: jnp.clip(x, 0.0, 6.0),
                     arg_types=[t.fp64()], ret_type=t.fp64(False))
    out = hdk.sql("SELECT relu6(x * 4) AS r FROM udf_t").to_pandas()
    np.testing.assert_allclose(out["r"], [2.0, 6.0, 0.0, 6.0, 0.0])


def test_udf_in_filter_and_groupby(hdk, ht):
    hdk.register_udf("parity", lambda a: a % 2,
                     arg_types=[t.int64()], ret_type=t.int64())
    out = hdk.sql(
        "SELECT parity(b) AS p, COUNT(*) AS n FROM udf_t "
        "WHERE parity(b) >= 0 GROUP BY parity(b) ORDER BY p").to_pandas()
    assert out["p"].tolist() == [0, 1]
    assert out["n"].tolist() == [2, 3]


def test_udf_null_propagation(hdk, ht):
    hdk.register_udf("twice", lambda a: a * 2,
                     arg_types=[t.int64()], ret_type=t.int64())
    out = hdk.sql("SELECT twice(a) AS d FROM udf_t").to_pandas()
    assert out["d"].tolist()[:4] == [6, 24, 50, 16]
    assert pd.isna(out["d"].iloc[4])


def test_udf_custom_null_handling(hdk, ht):
    def zero_for_null(a, valid):
        data = jnp.where(valid, a, 0) if valid is not None else a
        return data, None  # never NULL

    hdk.register_udf("znull", zero_for_null,
                     arg_types=[t.int64()], ret_type=t.int64(False),
                     null_propagation=False)
    out = hdk.sql("SELECT znull(a) AS d FROM udf_t").to_pandas()
    assert out["d"].tolist() == [3, 12, 25, 8, 0]


def test_udf_rereg_invalidates_cache(hdk, ht):
    hdk.register_udf("f1", lambda a: a + 1,
                     arg_types=[t.int64()], ret_type=t.int64())
    r1 = hdk.sql("SELECT f1(b) AS y FROM udf_t").to_pandas()
    assert r1["y"].tolist() == [3, 9, 6, 4, 8]
    hdk.register_udf("f1", lambda a: a + 100,
                     arg_types=[t.int64()], ret_type=t.int64())
    r2 = hdk.sql("SELECT f1(b) AS y FROM udf_t").to_pandas()
    assert r2["y"].tolist() == [102, 108, 105, 103, 107]


def test_udf_wrong_arity_rejected(hdk, ht):
    from hdk_jax.sql.binder import SqlError

    hdk.register_udf("one_arg", lambda a: a, arg_types=[t.int64()],
                     ret_type=t.int64())
    with pytest.raises(SqlError):
        hdk.sql("SELECT one_arg(a, b) FROM udf_t")


def test_udf_listing(hdk):
    hdk.register_udf("zz", lambda a: a, arg_types=[t.int64()],
                     ret_type=t.int64())
    assert "zz" in hdk._udfs.names()
    hdk._udfs.unregister("zz")
    assert "zz" not in hdk._udfs.names()
