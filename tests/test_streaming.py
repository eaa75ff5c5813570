"""Streaming aggregation tests (reference: streaming execution API,
Execute.cpp:1800-1889, SURVEY.md A.7)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


def test_streaming_matches_batch(hdk, rng):
    n = 3000
    full = pd.DataFrame({
        "k": rng.integers(0, 20, n),
        "v": rng.normal(size=n) * 10,
    })
    st = hdk.create_stream({"k": "int64", "v": "fp64"}, ["k"],
                           ["count", "sum(v)", "avg(v)", "min(v)", "max(v)",
                            "stddev(v)"])
    for chunk in np.array_split(np.arange(n), 5):
        part = full.iloc[chunk]
        st.push({"k": part["k"].to_numpy(), "v": part["v"].to_numpy()})
    res = st.finish().to_pandas()
    exp = full.groupby("k").agg(
        count=("k", "size"), v_sum=("v", "sum"), v_avg=("v", "mean"),
        v_min=("v", "min"), v_max=("v", "max"),
        v_stddev=("v", "std")).reset_index()
    exp.columns = list(res.columns)
    assert_frames_match(res, exp, approx_cols=("v_stddev",))


def test_streaming_global_agg(hdk, rng):
    st = hdk.create_stream({"x": "fp64"}, [], ["count", "sum(x)"])
    st.push({"x": [1.0, 2.0]})
    st.push({"x": [3.0]})
    out = st.finish().to_pandas()
    assert out["count"][0] == 3
    assert out["x_sum"][0] == 6.0


def test_streaming_rejects_holistic(hdk):
    with pytest.raises(ValueError, match="not streamable"):
        hdk.create_stream({"x": "int64"}, [], ["count_distinct(x)"])


def test_streaming_needs_batches(hdk):
    st = hdk.create_stream({"x": "int64"}, [], ["count"])
    with pytest.raises(ValueError, match="no batches"):
        st.finish()
