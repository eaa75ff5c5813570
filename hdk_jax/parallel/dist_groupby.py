"""Distributed group-by over a device mesh.

The reference's multi-device aggregation is: per-device output buffers,
then a host-side reduction (reference: Execute.cpp:1156
reduceMultiDeviceResults via ResultSetReductionJIT; SURVEY.md A.4).  The
translation here (A.4 note): keep identical per-shard layouts so the
combine is positional, and let XLA collectives do the reduce:

  * ``dist_groupby_perfect`` — each shard computes a dense positional
    partial buffer, combined with psum/pmin/pmax over the mesh axis (the
    perfect-hash case is a pure elementwise tree-reduce).  Works for
    distributive/algebraic aggregates (COUNT/SUM/AVG/MIN/MAX/STDDEV).
  * ``dist_groupby_shuffled`` — holistic aggregates (COUNT DISTINCT,
    QUANTILE) and high-cardinality keys: rows are exchanged so each key
    lives wholly on its owner shard (parallel/shuffle.py all_to_all),
    then each shard runs the local sort-based group-by.  The result is a
    sharded group table, the multi-device analog of the reference's
    partitioned aggregation (RelAlgExecutor.cpp:691-860).
"""

from __future__ import annotations

import dataclasses as _dataclasses
import math
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..exec import groupby as gb
from ..exec.masked import MaskedCol
from ..ir.expr import AggKind
from . import shuffle as shf
from .mesh import FRAG_AXIS
from ..utils import commlog

# slot-combine rule per aggregate kind: how per-shard raw slots merge
# (reference: ResultSetReductionOps.h op kinds).  Sketch kinds are
# algebraic too: HLL registers merge by elementwise max (reference:
# hll_unify, HyperLogLog.h:108); t-digest centroids merge by
# concatenate + re-cluster ("tdigest" consumes both slots together).
_COMBINE = {
    AggKind.COUNT: ("sum",),
    AggKind.SUM: ("sum", "sum"),
    AggKind.AVG: ("sum", "sum"),
    AggKind.STDDEV_SAMP: ("sum", "sum", "sum"),
    AggKind.VAR_SAMP: ("sum", "sum", "sum"),
    AggKind.MIN: ("min", "sum"),
    AggKind.MAX: ("max", "sum"),
    AggKind.SAMPLE: ("min", "sum"),
    AggKind.SINGLE_VALUE: ("min", "sum"),
    AggKind.APPROX_COUNT_DISTINCT: ("max",),
    AggKind.APPROX_QUANTILE: ("tdigest", "tdigest"),
}


def perfect_combinable(specs: Sequence[gb.AggSpec]) -> bool:
    return all(s.kind in _COMBINE for s in specs)


def _pin_sketch_sizing(specs, cap_hint: int):
    """Freeze effective sketch widths for a distributed run (budgets set
    to unlimited afterwards so nested paths can't re-shrink them)."""
    from ..ops import sketches as sk
    out = []
    for s in specs:
        if s.kind == AggKind.APPROX_COUNT_DISTINCT:
            s = _dataclasses.replace(
                s, hll_p=sk.effective_hll_p(s.hll_p, cap_hint, s.hll_budget),
                hll_budget=1 << 62)
        elif s.kind == AggKind.APPROX_QUANTILE:
            s = _dataclasses.replace(
                s, td_c=sk.effective_td_c(s.td_c, cap_hint, s.td_budget),
                td_budget=1 << 62)
        out.append(s)
    return out


def dist_groupby_perfect(
    mesh: Mesh,
    keys: Sequence[MaskedCol],
    layout: gb.PerfectHashLayout,
    specs: Sequence[gb.AggSpec],
    axis: str = FRAG_AXIS,
    row_valid=None,
):
    """Row-sharded keys/operands -> replicated finalized dense buffers.

    Returns (key_cols, agg_cols, exists) with ``layout.entry_count``
    entries, replicated on every shard.  This is the EXPLICIT form of
    the dense-buffer combine (local partial slots -> psum over the mesh
    axis): identical collective footprint to what GSPMD would insert
    for the same program, but routed through commlog so the scaling
    artifact accounts its AllReduce bytes (VERDICT r3 missing #1;
    reference analog: Execute.cpp:1156 reduceMultiDeviceResults).
    """
    n = layout.entry_count
    operands = [s.operand for s in specs]

    def shard_fn(keys_l, operands_l, row_valid_l):
        # same positional layout on every shard => psum is the reducer
        gid = jnp.zeros(keys_l[0].data.shape, jnp.int64)
        stride = 1
        for key, mn, size in zip(reversed(list(keys_l)),
                                 reversed(layout.mins),
                                 reversed(layout.sizes)):
            idx = key.data.astype(jnp.int64) - mn
            if key.mask is not None:
                idx = jnp.where(key.mask, idx, size - 1)
            gid = gid + idx * stride
            stride *= size
        in_range = (gid >= 0) & (gid < n)
        if row_valid_l is not None:
            in_range = in_range & row_valid_l
        gid = jnp.where(in_range, gid, n).astype(jnp.int32)

        exists_local = jax.ops.segment_sum(
            jnp.ones(gid.shape, jnp.int64), gid, num_segments=n + 1)[:n] > 0
        exists = commlog.psum(exists_local.astype(jnp.int32), axis) > 0

        out = []
        for spec, op in zip(specs, operands_l):
            sspec = _dataclasses.replace(spec, operand=op)
            slots = gb._agg_slots(sspec, gid, in_range, n, False).slots
            if spec.kind == AggKind.APPROX_QUANTILE:
                # gather every shard's digests along the centroid axis
                # and re-cluster per group (ops/sketches)
                from ..ops import sketches as sk
                c = slots[0].shape[1]
                gm = commlog.all_gather(slots[0], axis, axis=1, tiled=True)
                gw = commlog.all_gather(slots[1], axis, axis=1, tiled=True)
                combined = list(sk.tdigest_merge_gathered(gm, gw, c))
            else:
                combined = []
                for slot, rule in zip(slots, _COMBINE[spec.kind]):
                    if rule == "sum":
                        combined.append(commlog.psum(slot, axis))
                    elif rule == "min":
                        combined.append(commlog.pmin(slot, axis))
                    else:
                        combined.append(commlog.pmax(slot, axis))
            out.append(gb.AggResult(combined).finalize(sspec, None))
        return out, exists

    in_specs = (
        jax.tree.map(lambda _: P(axis), list(keys)),
        jax.tree.map(lambda _: P(axis), list(operands)),
        None if row_valid is None else P(axis),
    )
    out_specs = (
        jax.tree.map(lambda _: P(), [_out_struct(s) for s in specs]),
        P(),
    )
    agg_cols, exists = shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False)(list(keys), list(operands), row_valid)

    # reconstruct key columns from the dense entry index (host-side math)
    entry = jnp.arange(n, dtype=jnp.int64)
    strides = []
    acc = 1
    for size in reversed(layout.sizes):
        strides.append(acc)
        acc *= size
    strides = list(reversed(strides))
    key_cols = []
    for key, mn, size, st in zip(keys, layout.mins, layout.sizes, strides):
        idx = (entry // st) % size
        data = (idx + mn).astype(key.data.dtype)
        mask = (idx != size - 1) if key.mask is not None else None
        key_cols.append(MaskedCol(data, mask))
    return key_cols, agg_cols, exists


def _out_struct(spec: gb.AggSpec) -> MaskedCol:
    """Placeholder with the pytree structure finalize() returns."""
    nullable = spec.kind not in (AggKind.COUNT, AggKind.COUNT_DISTINCT,
                                 AggKind.APPROX_COUNT_DISTINCT)
    return MaskedCol(jnp.zeros(()), jnp.zeros((), jnp.bool_) if nullable else None)


def dist_groupby_two_phase(
    mesh: Mesh,
    keys: Sequence[MaskedCol],
    specs: Sequence[gb.AggSpec],
    rows_per_shard: int,
    group_cap_per_shard: int,
    axis: str = FRAG_AXIS,
    slack: float = 2.0,
    row_valid=None,
):
    """Skew-proof distributed group-by for algebraic aggregates.

    Phase 1: every shard pre-aggregates its local rows (sort group-by) —
    a heavy-hitter key collapses to ONE partial row per shard, so key
    skew cannot overload any shuffle partition (the north-star
    heavy-hitter requirement; generalizes the reference's partial
    buffers + reduce, Execute.cpp:1156).
    Phase 2: the per-shard partial rows (at most local-NDV of them)
    shuffle by key to owner shards and merge with the slot-combine
    rules of ``_COMBINE``.

    Same return contract as dist_groupby_shuffled.
    """
    if not perfect_combinable(specs):
        raise ValueError("two-phase aggregation requires algebraic "
                         "aggregates; use dist_groupby_shuffled")
    num_shards = mesh.devices.size
    local_cap = min(rows_per_shard, group_cap_per_shard * num_shards)
    cap = max(1, int(math.ceil(local_cap / num_shards * slack)))
    # pin sketch widths so phase-1 partials (built at local_cap groups)
    # and the phase-2 merge (group_cap groups) agree on register/centroid
    # counts — positional merge requires identical slot shapes
    specs = _pin_sketch_sizing(specs, max(local_cap, group_cap_per_shard))
    operands = [s.operand for s in specs]

    def shard_fn(keys_l, operands_l, row_valid_l):
        # ---- phase 1: local partial aggregation (raw slots) ----------
        nrows = keys_l[0].data.shape[0]
        perm, _rv, _full, gid, starts, ends, n_local = _sorted_key_spans(
            keys_l, row_valid_l, local_cap)

        partial_slots: List[List[jnp.ndarray]] = []
        for spec, op in zip(specs, operands_l):
            sspec = _dataclasses.replace(
                spec, operand=gb._permute_col(op, perm),
                operand2=gb._permute_col(spec.operand2, perm))
            partial_slots.append(
                gb._agg_sorted(sspec, gid, starts, ends, local_cap).slots)
        rep = perm[jnp.clip(starts, 0, max(nrows - 1, 0)).astype(jnp.int32)]
        pkeys = [
            MaskedCol(k.data[rep], k.mask[rep] if k.mask is not None else None)
            for k in keys_l
        ]
        local_valid = jnp.arange(local_cap) < n_local

        # ---- phase 2: shuffle partial rows, merge by key --------------
        slot_cols = [MaskedCol(slot) for slots in partial_slots
                     for slot in slots]
        cols, row_valid, overflow = shf.shuffle_rows(
            pkeys, slot_cols, axis, num_shards, cap,
            row_valid=local_valid)
        k2 = cols[: len(keys_l)]
        s2 = cols[len(keys_l):]

        # merge: group partial rows by key, combining slots
        merged_keys, merged_slots, exists, n_merged = _merge_partials(
            k2, s2, specs, row_valid, group_cap_per_shard)
        agg_cols = [
            gb.AggResult(slots).finalize(spec, None)
            for slots, spec in zip(merged_slots, specs)
        ]
        # receiver group-cap overflow is a detected failure, not a silent
        # clamp: a shard owning more distinct keys than its cap reports
        # the shortfall so the caller can widen and retry (reference:
        # OUT_OF_SLOTS -> retry ladder, GroupByRuntime.cpp:31-54)
        merge_overflow = jnp.maximum(
            n_merged.astype(jnp.int64) - group_cap_per_shard, 0)
        # phase-1 local cap overflow (local NDV > local_cap silently
        # merged the tail partial groups) is a failure too
        local_overflow = jnp.maximum(
            n_local.astype(jnp.int64) - local_cap, 0)
        total_overflow = commlog.psum(
            overflow.astype(jnp.int64) + merge_overflow + local_overflow,
            axis)
        return merged_keys, agg_cols, exists, total_overflow

    in_specs = (
        jax.tree.map(lambda _: P(axis), list(keys)),
        jax.tree.map(lambda _: P(axis), list(operands)),
        None if row_valid is None else P(axis),
    )
    out_specs = (
        jax.tree.map(lambda _: P(axis), [
            MaskedCol(jnp.zeros(()), None if k.mask is None
                      else jnp.zeros((), jnp.bool_)) for k in keys]),
        jax.tree.map(lambda _: P(axis), [_out_struct(s) for s in specs]),
        P(axis),
        P(),
    )
    return shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)(
        list(keys), list(operands), row_valid)


def _merge_partials(key_cols, slot_cols, specs, row_valid, cap):
    """Group shuffled partial rows by key; combine slots with the
    per-kind merge rules (sum/min/max/re-cluster)."""
    nrows = key_cols[0].data.shape[0]
    perm, rv, _full, gid, starts, ends, n_groups = _sorted_key_spans(
        key_cols, row_valid, cap)
    merged = []
    i = 0
    for spec in specs:
        c = _partial_slot_count(spec)
        merged.append(_rule_merge(spec, slot_cols[i:i + c], perm, rv, gid,
                                  starts, ends, cap))
        i += c
    rep = perm[jnp.clip(starts, 0, max(nrows - 1, 0)).astype(jnp.int32)]
    mkeys = [
        MaskedCol(k.data[rep], k.mask[rep] if k.mask is not None else None)
        for k in key_cols
    ]
    exists = jnp.arange(cap) < n_groups
    return mkeys, merged, exists, n_groups


def _merge_identity(rule: str, dtype):
    if rule == "sum":
        return jnp.asarray(0, dtype)
    return gb._minmax_identity(dtype, rule == "min")


def _sorted_key_spans(key_cols, row_valid, cap, minor_cols=()):
    """Stable-sort rows by ``key_cols`` (major) then ``minor_cols``
    (minor), dead rows last, and derive per-key group spans.

    Returns (perm, rv_sorted, full_boundary, gid, starts, ends,
    n_groups): ``gid`` is the key-grain group id clamped to ``cap - 1``
    with dead rows in a trash group at ``cap`` (so they can never
    pollute the last real group); ``full_boundary`` additionally marks
    minor-column transitions (the distinct-run starts).
    """
    nrows = key_cols[0].data.shape[0]
    perm = jnp.arange(nrows, dtype=jnp.int32)
    key_sort, minor_sort = [], []
    for cols, out in ((key_cols, key_sort), (minor_cols, minor_sort)):
        for key in cols:
            kv = gb._orderable_int64(key.data)
            if key.mask is not None:
                kv = jnp.where(key.mask, kv, jnp.iinfo(jnp.int64).max)
            out.append(kv)
    for kv in reversed(key_sort + minor_sort):
        perm = perm[jnp.argsort(kv[perm], stable=True)]
    rv = None
    if row_valid is not None:
        perm = perm[jnp.argsort((~row_valid[perm]).astype(jnp.int32),
                                stable=True)]
        rv = row_valid[perm]
    boundary = jnp.zeros((nrows,), jnp.bool_).at[0].set(True)
    for kv in key_sort:
        skv = kv[perm]
        boundary = boundary | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), skv[1:] != skv[:-1]])
    if rv is not None:
        sv = rv.astype(jnp.int32)
        boundary = boundary | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), sv[1:] != sv[:-1]])
    full = boundary
    for kv in minor_sort:
        skv = kv[perm]
        full = full | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), skv[1:] != skv[:-1]])
    gid = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    if rv is None:
        n_groups = gid[-1] + 1
    else:
        n_groups = jnp.max(jnp.where(rv, gid + 1, 0))
    gid = jnp.minimum(gid, cap - 1)
    if rv is not None:
        gid = jnp.where(rv, gid, cap)  # dead rows -> trash group
    bounds = jnp.searchsorted(gid, jnp.arange(cap + 1, dtype=jnp.int32),
                              side="left", method="sort").astype(jnp.int64)
    return perm, rv, full, gid, bounds[:-1], bounds[1:], n_groups


def _partial_slot_count(spec: gb.AggSpec) -> int:
    """Number of partial-slot columns a spec contributes to a merge."""
    if spec.kind == AggKind.COUNT_DISTINCT:
        return 1  # per-shard distinct count (disjoint value sets -> sum)
    return len(_COMBINE[spec.kind])


def _rule_merge(spec, cols, perm, rv, gid, starts, ends, cap):
    """Rule-merge one spec's shuffled partial-slot columns over the
    contiguous key spans of a `_sorted_key_spans` layout."""
    if spec.kind == AggKind.APPROX_QUANTILE:
        # both slots merge together: concatenate each key's partial
        # digests and re-cluster (ops/sketches)
        from ..ops import sketches as sk
        means = cols[0].data[perm]
        weights = cols[1].data[perm]
        weights = jnp.where(rv[:, None], weights, 0.0)
        return list(sk.tdigest_merge_rows(means, weights, gid, starts,
                                          ends, cap))
    rules = (("sum",) * len(cols) if spec.kind == AggKind.COUNT_DISTINCT
             else _COMBINE[spec.kind])
    slots = []
    for rule, col in zip(rules, cols):
        vals = col.data[perm]
        vals = jnp.where(rv[:, None] if vals.ndim == 2 else rv, vals,
                         _merge_identity(rule, vals.dtype))
        if rule == "sum":
            slots.append(gb._span_sums(vals, starts, ends))
        elif rule == "min":
            slots.append(gb._seg_min(vals, gid, cap + 1, True)[:cap])
        else:
            slots.append(gb._seg_max(vals, gid, cap + 1, True)[:cap])
    return slots


def dist_groupby_shuffled(
    mesh: Mesh,
    keys: Sequence[MaskedCol],
    specs: Sequence[gb.AggSpec],
    rows_per_shard: int,
    group_cap_per_shard: int,
    axis: str = FRAG_AXIS,
    slack: float = 2.0,
    row_valid=None,
):
    """Row-sharded inputs -> per-shard complete groups via all_to_all.

    The raw-row shuffle: every key's rows co-locate on its owner shard,
    so HOLISTIC aggregates (COUNT DISTINCT, QUANTILE, TOP_K, CORR)
    compute exactly — the multi-device analog of the reference's
    partitioned aggregation (RelAlgExecutor.cpp:691-860).

    Returns (key_cols, agg_cols, group_valid, overflow) where buffers are
    sharded (num_shards * group_cap_per_shard rows total); ``group_valid``
    marks real groups.  ``overflow`` > 0 means a shuffle-slot or
    receiver group-cap capacity was exceeded and the caller must retry
    with more slack (reference analog: OUT_OF_SLOTS -> retry ladder,
    Execute.cpp:2291).
    """
    num_shards = mesh.devices.size
    cap = max(1, int(math.ceil(rows_per_shard / num_shards * slack)))
    operands = [s.operand for s in specs]
    operands2 = [s.operand2 for s in specs]

    def shard_fn(keys_l, operands_l, operands2_l, row_valid_l):
        present = ([op for op in operands_l if op is not None]
                   + [op for op in operands2_l if op is not None])
        cols, rvalid, overflow = shf.shuffle_rows(
            list(keys_l), present, axis, num_shards, cap,
            row_valid=row_valid_l)
        k2 = cols[: len(keys_l)]
        rest = iter(cols[len(keys_l):])
        ops2: List[Optional[MaskedCol]] = [
            next(rest) if op is not None else None for op in operands_l]
        ops2b: List[Optional[MaskedCol]] = [
            next(rest) if op is not None else None for op in operands2_l]
        specs2 = [
            _dataclasses.replace(s, operand=o, operand2=o2)
            for s, o, o2 in zip(specs, ops2, ops2b)
        ]
        key_cols, agg_cols, exists, n_local = gb.groupby_sort(
            k2, specs2, group_cap_per_shard, row_valid=rvalid)
        # receiver group-cap overflow feeds the retry signal too (see
        # dist_groupby_two_phase)
        group_overflow = jnp.maximum(
            n_local.astype(jnp.int64) - group_cap_per_shard, 0)
        total_overflow = commlog.psum(
            overflow.astype(jnp.int64) + group_overflow, axis)
        return key_cols, agg_cols, exists, total_overflow

    in_specs = (
        jax.tree.map(lambda _: P(axis), list(keys)),
        jax.tree.map(lambda _: P(axis), list(operands)),
        jax.tree.map(lambda _: P(axis), list(operands2)),
        None if row_valid is None else P(axis),
    )
    out_specs = (
        jax.tree.map(lambda _: P(axis), [MaskedCol(jnp.zeros(()), None
                                                   if k.mask is None else jnp.zeros((), jnp.bool_))
                                         for k in keys]),
        jax.tree.map(lambda _: P(axis), [_out_struct(s) for s in specs]),
        P(axis),
        P(),
    )
    return shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)(
        list(keys), list(operands), list(operands2), row_valid)


def _is_distinct_class(spec: gb.AggSpec) -> bool:
    return (spec.kind == AggKind.COUNT_DISTINCT
            or (spec.distinct and spec.kind in (AggKind.SUM, AggKind.AVG)))


def distinct_splittable(specs: Sequence[gb.AggSpec]) -> bool:
    """True when the pair-split route applies: at least one DISTINCT-class
    aggregate, every spec either distinct-class or algebraic, and (checked
    structurally here via operand identity) all distinct-class specs share
    one operand column."""
    dists = [s for s in specs if _is_distinct_class(s)]
    if not dists:
        return False
    if not all(_is_distinct_class(s)
               or (s.kind in _COMBINE and not s.distinct) for s in specs):
        return False
    op0 = dists[0].operand
    return all(d.operand is op0 or d.operand is None for d in dists[1:])


def dist_groupby_distinct_split(
    mesh: Mesh,
    keys: Sequence[MaskedCol],
    specs: Sequence[gb.AggSpec],
    rows_per_shard: int,
    group_cap_per_shard: int,
    axis: str = FRAG_AXIS,
    slack: float = 2.0,
    row_valid=None,
):
    """Skew-proof distributed group-by with DISTINCT-class aggregates.

    The heavy-hitter answer for distinct aggregation (SURVEY.md §7.3;
    reference seed: RelAlgExecutor.cpp:691-860 partition sizing).
    Instead of sampling hot keys and salting them, rows are pre-aggregated
    at the (key.., distinct-operand) COMPOUND grain and shuffled by the
    compound hash: a hot key's rows spread over every shard — each
    distinct value to exactly one owner — so no partition can overload,
    with no sampling step and no wrong-threshold failure mode.

      0. local pre-agg by (keys.., v): algebraic partial slots at pair
         grain; the pair row itself carries the distinct information
      1. all_to_all by hash(keys.., v) -> pair-owner shards (a pair is
         ONE row per source shard; a dominant pair cannot overflow)
      2. per-key partials on received rows: distinct count/sum over value
         runs (pair-ownership makes per-shard value sets disjoint, so
         counts sum exactly); algebraic slots rule-merged
      3. all_to_all by hash(keys..) -> key-owner shards (at most
         num_shards partial rows per key: skew-proof by construction)
      4. merge partials (`_merge_partials`), finalize

    Same return contract as ``dist_groupby_shuffled``.
    """
    num_shards = mesh.devices.size
    # pair-grain local groups are bounded by local rows: no phase-0 cap
    local_cap = max(1, rows_per_shard)
    cap1 = max(1, int(math.ceil(local_cap / num_shards * slack)))
    cap3 = max(1, int(math.ceil(cap1 * slack)))
    specs = _pin_sketch_sizing(specs, max(local_cap, group_cap_per_shard))
    salt_col = next(s.operand for s in specs if _is_distinct_class(s))
    operands = [s.operand for s in specs]
    operands2 = [s.operand2 for s in specs]
    nkeys = len(keys)

    def shard_fn(keys_l, operands_l, operands2_l, salt_l, row_valid_l):
        # ---- phase 0: local pre-agg at (keys.., salt) pair grain ------
        compound = list(keys_l) + [salt_l]
        nrows = keys_l[0].data.shape[0]
        perm, _rv, _full, gid, starts, ends, n_pairs = _sorted_key_spans(
            compound, row_valid_l, local_cap)
        partial_slots: List[List[jnp.ndarray]] = []
        for spec, op, op2 in zip(specs, operands_l, operands2_l):
            if _is_distinct_class(spec):
                continue
            sspec = _dataclasses.replace(
                spec, operand=gb._permute_col(op, perm),
                operand2=gb._permute_col(op2, perm))
            partial_slots.append(
                gb._agg_sorted(sspec, gid, starts, ends, local_cap).slots)
        rep = perm[jnp.clip(starts, 0, max(nrows - 1, 0)).astype(jnp.int32)]
        pcols = [
            MaskedCol(c.data[rep], c.mask[rep] if c.mask is not None else None)
            for c in compound
        ]
        pair_valid = jnp.arange(local_cap) < n_pairs

        # ---- phase 1: shuffle pair rows by hash(keys.., salt) ---------
        slot_cols = [MaskedCol(slot) for slots in partial_slots
                     for slot in slots]
        cols1, rvalid1, ovf1 = shf.shuffle_rows(
            pcols, slot_cols, axis, num_shards, cap1, row_valid=pair_valid)
        k1 = cols1[:nkeys]
        salt1 = cols1[nkeys]
        s1 = cols1[nkeys + 1:]

        # ---- phase 2: per-key partials over received pair rows --------
        r2 = num_shards * cap1
        cap2 = r2  # groups <= rows: phase-2 cap can never overflow
        perm2, rv2, full2, kgid, kstarts, kends, n_keys2 = _sorted_key_spans(
            k1, rvalid1, cap2, minor_cols=[salt1])
        salt_valid = (salt1.mask[perm2] if salt1.mask is not None
                      else jnp.ones((r2,), jnp.bool_))
        first = full2 & rv2 & salt_valid  # distinct-run starts (non-null)
        p2_slots: List[jnp.ndarray] = []
        si = 0
        for spec in specs:
            if _is_distinct_class(spec):
                cnt = gb._span_sums(first.astype(jnp.int64), kstarts, kends)
                if spec.kind == AggKind.COUNT_DISTINCT:
                    p2_slots.append(cnt)
                else:  # SUM/AVG DISTINCT: sum the first-of-run values
                    acc = salt1.fill(0).astype(
                        gb._acc_dtype(salt1))[perm2]
                    s = gb._span_sums(jnp.where(first, acc, 0),
                                      kstarts, kends)
                    if spec.kind == AggKind.AVG:
                        s = s.astype(jnp.float64)
                    p2_slots.extend([s, cnt])
            else:
                c = _partial_slot_count(spec)
                p2_slots.extend(_rule_merge(
                    spec, s1[si:si + c], perm2, rv2, kgid,
                    kstarts, kends, cap2))
                si += c
        rep2 = perm2[jnp.clip(kstarts, 0, r2 - 1).astype(jnp.int32)]
        pkeys2 = [
            MaskedCol(k.data[rep2], k.mask[rep2] if k.mask is not None
                      else None)
            for k in k1
        ]
        valid2 = jnp.arange(cap2) < n_keys2

        # ---- phase 3: shuffle per-key partial rows by hash(keys..) ----
        cols3, rvalid3, ovf3 = shf.shuffle_rows(
            pkeys2, [MaskedCol(s) for s in p2_slots], axis, num_shards,
            cap3, row_valid=valid2)
        k3 = cols3[:nkeys]
        s3 = cols3[nkeys:]

        # ---- phase 4: merge per-key partials, finalize ----------------
        merged_keys, merged_slots, exists, n_merged = _merge_partials(
            k3, s3, specs, rvalid3, group_cap_per_shard)
        agg_cols = [
            gb.AggResult(slots).finalize(spec, None)
            for slots, spec in zip(merged_slots, specs)
        ]
        merge_overflow = jnp.maximum(
            n_merged.astype(jnp.int64) - group_cap_per_shard, 0)
        total_overflow = commlog.psum(
            ovf1.astype(jnp.int64) + ovf3.astype(jnp.int64)
            + merge_overflow, axis)
        return merged_keys, agg_cols, exists, total_overflow

    in_specs = (
        jax.tree.map(lambda _: P(axis), list(keys)),
        jax.tree.map(lambda _: P(axis), list(operands)),
        jax.tree.map(lambda _: P(axis), list(operands2)),
        P(axis),
        None if row_valid is None else P(axis),
    )
    out_specs = (
        jax.tree.map(lambda _: P(axis), [
            MaskedCol(jnp.zeros(()), None if k.mask is None
                      else jnp.zeros((), jnp.bool_)) for k in keys]),
        jax.tree.map(lambda _: P(axis), [_out_struct(s) for s in specs]),
        P(axis),
        P(),
    )
    return shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)(
        list(keys), list(operands), list(operands2), salt_col, row_valid)
