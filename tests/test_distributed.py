"""Multi-chip tests on a virtual 8-device CPU mesh
(SURVEY.md §4.3: what HDK never had — a multi-device fixture)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax  # noqa: F401  (enables x64 before jax use)
import jax
import jax.numpy as jnp

from hdk_jax import types as t
from hdk_jax.exec import groupby as gb
from hdk_jax.exec.masked import MaskedCol
from hdk_jax.ir.expr import AggKind
from hdk_jax.parallel import dist_groupby as dg
from hdk_jax.parallel import shuffle as shf
from hdk_jax.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8


def test_dist_groupby_perfect_matches_local(mesh, rng):
    n = 8 * 1000
    keys_np = rng.integers(0, 7, n)
    vals_np = rng.normal(size=n)
    keys = [MaskedCol(jnp.asarray(keys_np))]
    vals = MaskedCol(jnp.asarray(vals_np))
    layout = gb.choose_perfect_layout(
        [t.int64(False)], [(0, 6, False)], 1 << 20)
    specs = [
        gb.AggSpec(AggKind.COUNT, None, t.int64(False)),
        gb.AggSpec(AggKind.SUM, vals, t.fp64()),
        gb.AggSpec(AggKind.MIN, vals, t.fp64()),
        gb.AggSpec(AggKind.MAX, vals, t.fp64()),
    ]
    key_cols, agg_cols, exists = dg.dist_groupby_perfect(
        mesh, keys, layout, specs)
    assert bool(jnp.all(exists[:7]))
    df = pd.DataFrame({"k": keys_np, "v": vals_np})
    exp = df.groupby("k").agg(count=("k", "size"), s=("v", "sum"),
                              mn=("v", "min"), mx=("v", "max"))
    np.testing.assert_array_equal(np.asarray(agg_cols[0].data[:7]),
                                  exp["count"].values)
    np.testing.assert_allclose(np.asarray(agg_cols[1].data[:7]),
                               exp["s"].values)
    np.testing.assert_allclose(np.asarray(agg_cols[2].data[:7]),
                               exp["mn"].values)
    np.testing.assert_allclose(np.asarray(agg_cols[3].data[:7]),
                               exp["mx"].values)


def test_dist_groupby_shuffled_matches_local(mesh, rng):
    n = 8 * 512
    keys_np = rng.integers(0, 1000, n)
    vals_np = rng.integers(0, 100, n)
    keys = [MaskedCol(jnp.asarray(keys_np))]
    vals = MaskedCol(jnp.asarray(vals_np))
    specs = [
        gb.AggSpec(AggKind.COUNT, None, t.int64(False)),
        gb.AggSpec(AggKind.SUM, vals, t.int64()),
    ]
    key_cols, agg_cols, gvalid, overflow = dg.dist_groupby_shuffled(
        mesh, keys, specs, rows_per_shard=n // 8,
        group_cap_per_shard=n // 8 + 8, slack=4.0)
    assert int(overflow) == 0
    gv = np.asarray(gvalid)
    got = pd.DataFrame({
        "k": np.asarray(key_cols[0].data)[gv],
        "count": np.asarray(agg_cols[0].data)[gv],
        "s": np.asarray(agg_cols[1].data)[gv],
    }).sort_values("k").reset_index(drop=True)
    exp = (pd.DataFrame({"k": keys_np, "v": vals_np})
           .groupby("k").agg(count=("k", "size"), s=("v", "sum"))
           .reset_index())
    assert got.shape[0] == exp.shape[0]  # each group on exactly one shard
    np.testing.assert_array_equal(got["k"].values, exp["k"].values)
    np.testing.assert_array_equal(got["count"].values, exp["count"].values)
    np.testing.assert_array_equal(got["s"].values, exp["s"].values)


def test_dist_count_distinct_via_shuffle(mesh, rng):
    n = 8 * 256
    keys_np = rng.integers(0, 40, n)
    vals_np = rng.integers(0, 17, n)
    keys = [MaskedCol(jnp.asarray(keys_np))]
    vals = MaskedCol(jnp.asarray(vals_np))
    specs = [gb.AggSpec(AggKind.COUNT_DISTINCT, vals, t.int64(False))]
    key_cols, agg_cols, gvalid, overflow = dg.dist_groupby_shuffled(
        mesh, keys, specs, rows_per_shard=n // 8,
        group_cap_per_shard=n // 8 + 8, slack=4.0)
    assert int(overflow) == 0
    gv = np.asarray(gvalid)
    got = pd.DataFrame({"k": np.asarray(key_cols[0].data)[gv],
                        "nd": np.asarray(agg_cols[0].data)[gv]})
    got = got.sort_values("k").reset_index(drop=True)
    exp = (pd.DataFrame({"k": keys_np, "v": vals_np})
           .groupby("k")["v"].nunique().reset_index(name="nd"))
    np.testing.assert_array_equal(got["k"].values, exp["k"].values)
    np.testing.assert_array_equal(got["nd"].values, exp["nd"].values)


def test_shuffle_overflow_detection(mesh, rng):
    # all rows share one key -> all land on one shard; tiny cap overflows
    n = 8 * 64
    keys = [MaskedCol(jnp.zeros(n, jnp.int64))]
    specs = [gb.AggSpec(AggKind.COUNT, None, t.int64(False))]
    _, _, _, overflow = dg.dist_groupby_shuffled(
        mesh, keys, specs, rows_per_shard=n // 8,
        group_cap_per_shard=16, slack=1.0)
    assert int(overflow) > 0


def test_null_keys_group_together_across_shards(mesh, rng):
    n = 8 * 128
    keys_np = rng.integers(0, 5, n).astype(np.int64)
    mask_np = rng.random(n) > 0.3
    keys = [MaskedCol(jnp.asarray(keys_np), jnp.asarray(mask_np))]
    specs = [gb.AggSpec(AggKind.COUNT, None, t.int64(False))]
    key_cols, agg_cols, gvalid, overflow = dg.dist_groupby_shuffled(
        mesh, keys, specs, rows_per_shard=n // 8,
        group_cap_per_shard=64, slack=4.0)
    assert int(overflow) == 0
    gv = np.asarray(gvalid)
    kd = np.asarray(key_cols[0].data)[gv]
    km = np.asarray(key_cols[0].mask)[gv]
    counts = np.asarray(agg_cols[0].data)[gv]
    # exactly one null group, holding all null rows
    assert (~km).sum() == 1
    assert counts[~km][0] == (~mask_np).sum()
    got = pd.Series(counts[km], index=kd[km]).sort_index()
    exp = pd.Series(keys_np[mask_np]).value_counts().sort_index()
    np.testing.assert_array_equal(got.values, exp.values)


def test_two_phase_skew_proof(mesh, rng):
    """Heavy-hitter keys collapse in phase 1 — tiny shuffle caps suffice."""
    from hdk_jax.parallel.dist_groupby import dist_groupby_two_phase

    n = 8 * 512
    # 90% of rows share ONE key: raw shuffle would overflow tiny caps
    keys_np = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 50, n))
    vals_np = rng.integers(0, 100, n)
    keys = [MaskedCol(jnp.asarray(keys_np))]
    vals = MaskedCol(jnp.asarray(vals_np))
    specs = [
        gb.AggSpec(AggKind.COUNT, None, t.int64(False)),
        gb.AggSpec(AggKind.SUM, vals, t.int64()),
        gb.AggSpec(AggKind.MIN, vals, t.int64()),
    ]
    key_cols, agg_cols, gvalid, overflow = dist_groupby_two_phase(
        mesh, keys, specs, rows_per_shard=n // 8,
        group_cap_per_shard=64, slack=4.0)
    assert int(overflow) == 0  # phase-1 combine absorbed the skew
    gv = np.asarray(gvalid)
    got = pd.DataFrame({
        "k": np.asarray(key_cols[0].data)[gv],
        "c": np.asarray(agg_cols[0].data)[gv],
        "s": np.asarray(agg_cols[1].data)[gv],
        "m": np.asarray(agg_cols[2].data)[gv],
    }).sort_values("k").reset_index(drop=True)
    exp = (pd.DataFrame({"k": keys_np, "v": vals_np}).groupby("k")
           .agg(c=("k", "size"), s=("v", "sum"), m=("v", "min"))
           .reset_index())
    np.testing.assert_array_equal(got["k"].values, exp["k"].values)
    np.testing.assert_array_equal(got["c"].values, exp["c"].values)
    np.testing.assert_array_equal(got["s"].values, exp["s"].values)
    np.testing.assert_array_equal(got["m"].values, exp["m"].values)


def test_raw_shuffle_overflows_on_same_skew(mesh, rng):
    """Contrast: the one-phase shuffle DOES overflow under the same skew
    and small caps — the retry contract reports it."""
    n = 8 * 512
    keys_np = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 50, n))
    keys = [MaskedCol(jnp.asarray(keys_np))]
    specs = [gb.AggSpec(AggKind.COUNT, None, t.int64(False))]
    _, _, _, overflow = dg.dist_groupby_shuffled(
        mesh, keys, specs, rows_per_shard=n // 8,
        group_cap_per_shard=64, slack=1.0)
    assert int(overflow) > 0


def test_dist_sort(mesh, rng):
    from hdk_jax.parallel.dist_sort import dist_sort

    n = 8 * 512
    vals_np = rng.normal(size=n)
    pay_np = rng.integers(0, 1000, n)
    sort_col = MaskedCol(jnp.asarray(vals_np))
    payload = [MaskedCol(jnp.asarray(pay_np))]
    pays, valid, overflow = dist_sort(
        mesh, [sort_col], [False], [False], [sort_col] + payload,
        rows_per_shard=n // 8, slack=3.0)
    assert int(overflow) == 0
    v = np.asarray(valid)
    got = np.asarray(pays[1].data)[v]
    assert got.shape[0] == n
    # global order: concatenation of shards in mesh order is sorted
    keys_sorted = np.asarray(pays[0].data)[v]
    assert (np.diff(keys_sorted) >= 0).all()
    exp = pay_np[np.argsort(vals_np, kind="stable")]
    np.testing.assert_array_equal(got, exp)


def test_dist_sort_desc(mesh, rng):
    from hdk_jax.parallel.dist_sort import dist_sort

    n = 8 * 256
    vals_np = rng.integers(0, 10_000, n)
    sort_col = MaskedCol(jnp.asarray(vals_np))
    pays, valid, overflow = dist_sort(
        mesh, [sort_col], [True], [True], [MaskedCol(jnp.asarray(vals_np))],
        rows_per_shard=n // 8, slack=3.0)
    assert int(overflow) == 0
    v = np.asarray(valid)
    got = np.asarray(pays[0].data)[v]
    assert (np.diff(got) <= 0).all()
