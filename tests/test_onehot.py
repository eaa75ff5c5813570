"""Direct property tests for ops/onehot.py (the one-hot segment-reduction
tier): bit-exact integer sums via bf16 limb decomposition, f64 accuracy,
min/max, discard-segment semantics, multi-row-pass chunking."""

import numpy as np
import pytest

import jax.numpy as jnp

from hdk_jax.ops import onehot


@pytest.mark.parametrize("n", [5, 10, 128, 640, 3000, 4096])
@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int32, np.int64])
def test_int_sums_bit_exact(n, dtype):
    rng = np.random.default_rng(n)
    rows = 20_000
    gid = rng.integers(0, n + 1, rows).astype(np.int32)  # incl. discard n
    if dtype == np.bool_:
        vals = rng.random(rows) < 0.5
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, rows, endpoint=True,
                            dtype=dtype)
    got = np.asarray(onehot.seg_sums([jnp.asarray(vals)],
                                     jnp.asarray(gid), n)[0])
    want = np.zeros(n, np.int64)
    live = gid < n
    np.add.at(want, gid[live], vals[live].astype(np.int64))
    assert np.array_equal(got, want)


def test_f64_accuracy():
    rng = np.random.default_rng(0)
    rows, n = 50_000, 100
    gid = rng.integers(0, n, rows).astype(np.int32)
    vals = rng.normal(size=rows) * 1e6
    got = np.asarray(onehot.seg_sums([jnp.asarray(vals)],
                                     jnp.asarray(gid), n)[0])
    want = np.zeros(n)
    np.add.at(want, gid, vals)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_min_max_with_identity():
    rng = np.random.default_rng(1)
    rows, n = 10_000, 300
    gid = rng.integers(0, n, rows).astype(np.int32)
    gid[gid % 7 == 0] = n  # discard segment
    vals = rng.integers(-10**9, 10**9, rows)
    ident_min = jnp.asarray(np.iinfo(np.int64).max)
    ident_max = jnp.asarray(np.iinfo(np.int64).min)
    gmin = np.asarray(onehot.seg_min(jnp.asarray(vals), jnp.asarray(gid),
                                     n, ident_min))
    gmax = np.asarray(onehot.seg_max(jnp.asarray(vals), jnp.asarray(gid),
                                     n, ident_max))
    for g in (0, 1, n // 2, n - 1):
        sel = vals[(gid == g)]
        if sel.size:
            assert gmin[g] == sel.min()
            assert gmax[g] == sel.max()
        else:
            assert gmin[g] == np.iinfo(np.int64).max
            assert gmax[g] == np.iinfo(np.int64).min


def test_row_pass_chunking_exact():
    # more rows than one contraction pass (~4M) — verify totals combine
    rng = np.random.default_rng(2)
    rows, n = 5_000_000, 16
    gid = rng.integers(0, n, rows).astype(np.int32)
    vals = np.ones(rows, np.bool_)
    got = np.asarray(onehot.seg_sums([jnp.asarray(vals)],
                                     jnp.asarray(gid), n)[0])
    want = np.bincount(gid, minlength=n)
    assert np.array_equal(got, want)
