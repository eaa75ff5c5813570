"""Order-preserving int64 key mapping (IEEE total-order trick over the
bitcast of f32/f64 values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hdk_jax.exec import groupby as gb


@pytest.fixture()
def doubles(rng):
    exps = rng.integers(-1000, 1023, 5000)
    vals = rng.random(5000) * np.exp2(exps.clip(-700, 700))
    vals = vals * np.where(rng.random(5000) < 0.5, -1.0, 1.0)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                        2.2250738585072014e-308,  # min normal
                        1.7976931348623157e308, 1.0, -1.0, 2.0, 0.5,
                        np.nextafter(1.0, 2.0), np.nextafter(2.0, 1.0)])
    return np.concatenate([vals, special])


def test_orderable_monotone(doubles):
    x = doubles[~np.isnan(doubles)]
    o = np.asarray(jax.jit(gb._orderable_int64)(jnp.asarray(x, jnp.float64)))
    idx = np.argsort(x, kind="stable")
    assert (np.diff(o[idx]) >= 0).all()
    # strictly increasing between distinct values (injective), except the
    # 0.0/-0.0 pair which deliberately compares equal
    xs = x[idx]
    distinct = xs[1:] != xs[:-1]
    assert (np.diff(o[idx])[distinct] > 0).all()


def test_f32_path_native_bitcast(rng):
    x = (rng.normal(size=2000) * np.exp2(
        rng.integers(-120, 120, 2000))).astype(np.float32)
    x[:4] = [np.float32(0.0), np.float32(-0.0), np.inf, -np.inf]
    o = np.asarray(jax.jit(gb._orderable_int64)(jnp.asarray(x)))
    idx = np.argsort(x, kind="stable")
    assert (np.diff(o[idx]) >= 0).all()
    assert o[0] == o[1]  # +/-0.0 equal


def test_f64_bitcast_key_nan_and_zero(doubles):
    """f64 keys: +/-0.0 share a key, every NaN maps to one key above
    +inf, and the order of all other values (infinities included) is
    kept."""
    x = np.concatenate([doubles, [np.nan, -np.nan, -0.0, 0.0]])
    o = np.asarray(jax.jit(gb._orderable_int64)(jnp.asarray(x, jnp.float64)))
    nan = np.isnan(x)
    assert len(set(o[nan].tolist())) == 1
    assert o[nan][0] > o[~nan].max()
    assert o[~nan][x[~nan] == np.inf][0] == o[~nan].max()
    zeros = o[x == 0]
    assert (zeros == zeros[0]).all() and zeros[0] == 0
    assert (o[x < 0] < 0).all() and (o[(x > 0) & ~nan] > 0).all()
    idx = np.argsort(x[~nan], kind="stable")
    xs, os_ = x[~nan][idx], o[~nan][idx]
    np.testing.assert_array_equal(os_[1:] > os_[:-1], xs[1:] > xs[:-1])
    np.testing.assert_array_equal(os_[1:] == os_[:-1], xs[1:] == xs[:-1])
