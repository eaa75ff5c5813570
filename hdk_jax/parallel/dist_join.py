"""Distributed equi-joins over a device mesh.

The reference's multi-GPU join model is per-device hash-table replicas
probed by each device's fragments, with results reduced after
(reference: PerfectJoinHashTable.cpp:370-400 builds per device,
Execute.cpp:1156 reduceMultiDeviceResults).  The generalization here
(SURVEY.md M5) has two strategies, chosen by build-side size:

  * **Replicated-build (broadcast)** — the dense build side is
    replicated to every shard; each shard builds the same sorted-hash
    table locally and probes only its own probe rows.  Probe-side rows
    never move; output stays row-sharded.
  * **Partitioned (shuffle-both-sides)** — both sides are exchanged by
    key hash (parallel/shuffle.py all_to_all) so matching keys
    co-locate, then each shard runs a local sorted-hash join over its
    partition.  This is the scale-out path when neither side fits
    per-device HBM replicated.

Static-shape discipline: candidate-pair counts are measured by a cheap
counting program first (the reference's count-then-fill two-pass shape,
HashJoinRuntime.h:181), so the join program's pair capacity is exact —
overflow is detected (psum'd) and feeds the widen-and-retry ladder.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..exec import join as jn
from ..exec.masked import MaskedCol, combine_masks
from ..ir.node import JoinType
from . import shuffle as shf
from .mesh import FRAG_AXIS
from ..utils import commlog


def _mask_first(keys: Sequence[MaskedCol], valid) -> List[MaskedCol]:
    """Fold row validity into the first key column's mask: the combined
    hash (and pair verification) then treats dead rows as NULL keys,
    which never match."""
    if valid is None:
        return list(keys)
    out = list(keys)
    out[0] = MaskedCol(out[0].data, combine_masks(out[0].mask, valid))
    return out


def _local_join(build_cols: Sequence[MaskedCol],
                build_keys: Sequence[MaskedCol],
                build_valid,
                probe_cols: Sequence[MaskedCol],
                probe_keys: Sequence[MaskedCol],
                probe_valid,
                join_type: JoinType,
                pair_cap: int):
    """One shard's join: sorted-hash build + binary-search probe + capped
    expansion (exec/join.py primitives), entirely sync-free.

    Returns (out_cols, out_mask, overflow) where out_cols follows the
    join type's output contract (INNER/LEFT: lhs ++ rhs columns; SEMI/
    ANTI: None — caller reuses the probe table's columns with out_mask).
    """
    bk = _mask_first(build_keys, build_valid)
    pk = _mask_first(probe_keys, probe_valid)
    table = jn.build(bk)
    lo, hi = jn.probe_ranges(table, pk)
    l_idx, r_idx, live, total = jn.expand_pairs_capped(table, lo, hi, pair_cap)
    ok = live & jn.verify_pairs(bk, pk, l_idx, r_idx)
    overflow = jnp.maximum(total - pair_cap, 0)

    if join_type == JoinType.INNER:
        out = ([MaskedCol(c.data[l_idx],
                          c.mask[l_idx] if c.mask is not None else None)
                for c in probe_cols]
               + [MaskedCol(c.data[r_idx],
                            c.mask[r_idx] if c.mask is not None else None)
                  for c in build_cols])
        return out, ok, overflow

    n_probe = pk[0].data.shape[0]
    matched = jax.ops.segment_sum(
        ok.astype(jnp.int32), l_idx,
        num_segments=max(n_probe, 1) + 1)[:n_probe] > 0
    probe_live = (jnp.ones((n_probe,), jnp.bool_) if probe_valid is None
                  else probe_valid)

    if join_type == JoinType.SEMI:
        return None, matched & probe_live, overflow
    if join_type == JoinType.ANTI:
        return None, ~matched & probe_live, overflow

    # LEFT: verified pairs ++ unmatched live probe rows with NULL rhs
    un_live = probe_live & ~matched
    lcols = [
        MaskedCol(jnp.concatenate([c.data[l_idx], c.data]),
                  jnp.concatenate([c.mask[l_idx], c.mask])
                  if c.mask is not None else None)
        for c in probe_cols
    ]
    rcols = []
    for c in build_cols:
        data = jnp.concatenate([
            c.data[r_idx], jnp.zeros((n_probe,), c.data.dtype)])
        mm = ok if c.mask is None else (ok & c.mask[r_idx])
        mask = jnp.concatenate([mm, jnp.zeros((n_probe,), jnp.bool_)])
        rcols.append(MaskedCol(data, mask))
    out_mask = jnp.concatenate([ok, un_live])
    return lcols + rcols, out_mask, overflow


def _col_spec(cols, spec):
    return jax.tree.map(lambda _: spec, list(cols))


# ---------------------------------------------------------------------------
# replicated-build (broadcast)
# ---------------------------------------------------------------------------

def count_candidates_broadcast(
    mesh: Mesh,
    probe_keys: Sequence[MaskedCol],
    probe_valid,
    build_keys: Sequence[MaskedCol],
    axis: str = FRAG_AXIS,
) -> jnp.ndarray:
    """Per-shard candidate totals (ndev,) — the count pass that sizes the
    join program's pair capacity exactly."""

    def fn(pkeys_l, pvalid_l, bkeys_g):
        table = jn.build(list(bkeys_g))
        lo, hi = jn.probe_ranges(table, _mask_first(pkeys_l, pvalid_l))
        return jnp.reshape(jnp.sum(hi - lo), (1,))

    in_specs = (_col_spec(probe_keys, P(axis)),
                None if probe_valid is None else P(axis),
                _col_spec(build_keys, P()))
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=P(axis),
                     check_vma=False)(list(probe_keys), probe_valid,
                                      list(build_keys))


def dist_join_broadcast(
    mesh: Mesh,
    probe_cols: Sequence[MaskedCol],
    probe_keys: Sequence[MaskedCol],
    probe_valid,
    build_cols: Sequence[MaskedCol],
    build_keys: Sequence[MaskedCol],
    join_type: JoinType,
    pair_cap: int,
    axis: str = FRAG_AXIS,
):
    """Replicated-build join: probe side sharded, build side replicated.

    Returns (out_cols, out_mask, overflow); for SEMI/ANTI out_cols is
    None and out_mask is the per-probe-row keep mask (sharded like the
    probe side).
    """
    semi_like = join_type in (JoinType.SEMI, JoinType.ANTI)

    def fn(pcols_l, pkeys_l, pvalid_l, bcols_g, bkeys_g):
        out, mask, ov = _local_join(
            list(bcols_g), list(bkeys_g), None,
            list(pcols_l), list(pkeys_l), pvalid_l,
            join_type, pair_cap)
        ov = commlog.psum(ov, axis)
        if out is None:
            return mask, ov
        return out, mask, ov

    in_specs = (_col_spec(probe_cols, P(axis)),
                _col_spec(probe_keys, P(axis)),
                None if probe_valid is None else P(axis),
                _col_spec(build_cols, P()),
                _col_spec(build_keys, P()))
    if semi_like:
        out_specs = (P(axis), P())
        mask, ov = shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)(
            list(probe_cols), list(probe_keys), probe_valid,
            list(build_cols), list(build_keys))
        return None, mask, ov
    n_out = len(probe_cols) + len(build_cols)
    out_specs = ([MaskedCol(P(axis),
                            P(axis) if _out_has_mask(c, join_type, i,
                                                     len(probe_cols))
                            else None)
                  for i, c in enumerate(list(probe_cols) + list(build_cols))],
                 P(axis), P())
    out, mask, ov = shard_map(fn, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=False)(
        list(probe_cols), list(probe_keys), probe_valid,
        list(build_cols), list(build_keys))
    return out, mask, ov


def _out_has_mask(col: MaskedCol, join_type: JoinType, i: int,
                  n_probe_cols: int) -> bool:
    """Output mask presence must match _local_join's construction: LEFT
    always adds masks to build-side columns."""
    if col.mask is not None:
        return True
    return join_type == JoinType.LEFT and i >= n_probe_cols


# ---------------------------------------------------------------------------
# partitioned (shuffle both sides)
# ---------------------------------------------------------------------------

def partition_histograms(
    mesh: Mesh,
    probe_keys: Sequence[MaskedCol],
    probe_valid,
    build_keys: Sequence[MaskedCol],
    build_valid,
    axis: str = FRAG_AXIS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact per-destination row totals for both sides ((ndev,) each) —
    sizes the shuffle send buffers with no overflow risk (the reference's
    Shuffle-COUNT step, RelAlgExecutor.cpp:748-764)."""
    ndev = mesh.devices.size

    def fn(pkeys_l, pvalid_l, bkeys_l, bvalid_l):
        def hist(keys_l, valid_l):
            h = shf.key_hash(_mask_first(keys_l, None))
            dest = shf.bucket_for_shards(h, ndev)
            if valid_l is not None:
                dest = jnp.where(valid_l, dest, ndev)
            cnt = jax.ops.segment_sum(
                jnp.ones(dest.shape, jnp.int64), dest,
                num_segments=ndev + 1)[:ndev]
            return commlog.psum(cnt, axis)

        return hist(pkeys_l, pvalid_l), hist(bkeys_l, bvalid_l)

    in_specs = (_col_spec(probe_keys, P(axis)),
                None if probe_valid is None else P(axis),
                _col_spec(build_keys, P(axis)),
                None if build_valid is None else P(axis))
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=(P(), P()),
                     check_vma=False)(list(probe_keys), probe_valid,
                                      list(build_keys), build_valid)


def count_candidates_partitioned(
    mesh: Mesh,
    probe_keys: Sequence[MaskedCol],
    probe_valid,
    build_keys: Sequence[MaskedCol],
    build_valid,
    probe_cap: int,
    build_cap: int,
    axis: str = FRAG_AXIS,
) -> jnp.ndarray:
    """Per-shard candidate totals after the key shuffle (keys only — the
    cheap dry run of the partitioned join's probe)."""
    ndev = mesh.devices.size

    def fn(pkeys_l, pvalid_l, bkeys_l, bvalid_l):
        pk2, pvalid2, _ = shf.shuffle_rows(
            list(pkeys_l), [], axis, ndev, probe_cap, row_valid=pvalid_l)
        bk2, bvalid2, _ = shf.shuffle_rows(
            list(bkeys_l), [], axis, ndev, build_cap, row_valid=bvalid_l)
        table = jn.build(_mask_first(bk2, bvalid2))
        lo, hi = jn.probe_ranges(table, _mask_first(pk2, pvalid2))
        return jnp.reshape(jnp.sum(hi - lo), (1,))

    in_specs = (_col_spec(probe_keys, P(axis)),
                None if probe_valid is None else P(axis),
                _col_spec(build_keys, P(axis)),
                None if build_valid is None else P(axis))
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=P(axis),
                     check_vma=False)(list(probe_keys), probe_valid,
                                      list(build_keys), build_valid)


def dist_join_partitioned(
    mesh: Mesh,
    probe_cols: Sequence[MaskedCol],
    probe_keys: Sequence[MaskedCol],
    probe_valid,
    build_cols: Sequence[MaskedCol],
    build_keys: Sequence[MaskedCol],
    build_valid,
    join_type: JoinType,
    probe_cap: int,
    build_cap: int,
    pair_cap: int,
    axis: str = FRAG_AXIS,
):
    """Shuffle-both-sides join.  All outputs are (ndev * rows)-sharded;
    SEMI/ANTI keep mask semantics are *post-shuffle* so out_cols carries
    the shuffled probe columns (unlike broadcast, probe rows moved).

    Returns (out_cols, out_mask, overflow).
    """
    ndev = mesh.devices.size

    def fn(pcols_l, pkeys_l, pvalid_l, bcols_l, bkeys_l, bvalid_l):
        pshuf, pvalid2, ov1 = shf.shuffle_rows(
            list(pkeys_l), list(pcols_l), axis, ndev, probe_cap,
            row_valid=pvalid_l)
        pk2 = pshuf[:len(pkeys_l)]
        pc2 = pshuf[len(pkeys_l):]
        bshuf, bvalid2, ov2 = shf.shuffle_rows(
            list(bkeys_l), list(bcols_l), axis, ndev, build_cap,
            row_valid=bvalid_l)
        bk2 = bshuf[:len(bkeys_l)]
        bc2 = bshuf[len(bkeys_l):]
        out, mask, ov3 = _local_join(bc2, bk2, bvalid2, pc2, pk2, pvalid2,
                                     join_type, pair_cap)
        ov = commlog.psum(ov1 + ov2 + ov3, axis)
        if out is None:
            # SEMI/ANTI: emit the shuffled probe columns + keep mask
            return pc2, mask, ov
        return out, mask, ov

    in_specs = (_col_spec(probe_cols, P(axis)),
                _col_spec(probe_keys, P(axis)),
                None if probe_valid is None else P(axis),
                _col_spec(build_cols, P(axis)),
                _col_spec(build_keys, P(axis)),
                None if build_valid is None else P(axis))
    if join_type in (JoinType.SEMI, JoinType.ANTI):
        out_cols_struct = [
            MaskedCol(P(axis), P(axis) if c.mask is not None else None)
            for c in probe_cols
        ]
    else:
        out_cols_struct = [
            MaskedCol(P(axis),
                      P(axis) if _out_has_mask(c, join_type, i,
                                               len(probe_cols))
                      else None)
            for i, c in enumerate(list(probe_cols) + list(build_cols))
        ]
    out_specs = (out_cols_struct, P(axis), P())
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)(
        list(probe_cols), list(probe_keys), probe_valid,
        list(build_cols), list(build_keys), build_valid)
