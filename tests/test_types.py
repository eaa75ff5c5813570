"""Type-system tests (reference: type parsing in QueryBuilderTest.cpp)."""

import numpy as np
import pytest

from hdk_jax import types as t


def test_parse_simple():
    assert t.parse_type("int64") == t.int64()
    assert t.parse_type("int") == t.int32()
    assert t.parse_type("bigint") == t.int64()
    assert t.parse_type("fp32") == t.fp32()
    assert t.parse_type("double") == t.fp64()
    assert t.parse_type("bool") == t.boolean()
    assert t.parse_type("text") == t.text()


def test_parse_not_null():
    ty = t.parse_type("int32 not null")
    assert not ty.nullable
    assert ty == t.int32(nullable=False)


def test_parse_decimal():
    ty = t.parse_type("dec(10,2)")
    assert ty.is_decimal() and ty.precision == 10 and ty.scale == 2
    assert t.parse_type("decimal(5)").scale == 0


def test_parse_units():
    ty = t.parse_type("timestamp[ms]")
    assert ty.is_timestamp() and ty.unit == t.TimeUnit.MILLI
    assert t.parse_type("time[us]").unit == t.TimeUnit.MICRO


def test_parse_errors():
    with pytest.raises(ValueError):
        t.parse_type("wat")
    with pytest.raises(ValueError):
        t.parse_type("int32[ms]")


def test_physical_dtypes():
    assert t.int8().physical_dtype() == np.int8
    assert t.date32().physical_dtype() == np.int32
    assert t.timestamp().physical_dtype() == np.int64
    assert t.dict_text(1).physical_dtype() == np.int32
    assert t.decimal64(10, 2).physical_dtype() == np.int64


def test_null_sentinels():
    assert t.int32().null_sentinel() == np.iinfo(np.int32).min
    assert np.isnan(t.fp64().null_sentinel())


def test_common_type_promotion():
    assert t.common_type(t.int32(), t.int64()) == t.int64()
    assert t.common_type(t.int64(), t.fp32()) == t.fp64()
    assert t.common_type(t.int32(False), t.int32(False)) == t.int32(False)
    ct = t.common_type(t.decimal64(10, 2), t.int32())
    assert ct.is_decimal() and ct.scale == 2
    assert t.common_type(t.fp32(), t.fp32()) == t.fp32()


def test_common_type_errors():
    with pytest.raises(TypeError):
        t.common_type(t.int32(), t.text())


def test_with_nullable():
    assert t.int32().with_nullable(False) == t.int32(False)
    assert t.dict_text(3).with_nullable(False).dict_id == 3
