"""Equi-join engine.

Reference: QueryEngine/JoinHashTable/ — PerfectJoinHashTable (dense
min/max-keyed direct index, PerfectJoinHashTable.h:54) and
BaselineJoinHashTable (MurmurHash open-addressing, BaselineJoinHashTable
.h:52), probed from generated JoinLoops (IRCodegen.cpp:513).

Design (SURVEY.md §7.1/M4): no open-addressing CAS tables; the general
path is a **sorted-hash join** built from XLA sorts and searches:

  1. hash all build keys to 64-bit (splitmix-style mixer — role of
     MurmurHash in GroupByRuntime.cpp:25-29);
  2. argsort build side by hash — the sorted (hash, row) pair array *is*
     the hash table (keys|payload layout analog of HashTable.h:25);
  3. probe = vectorized binary search (searchsorted lower/upper) giving a
     candidate range per probe row — the OneToMany (offset, count) pair;
  4. expand candidate pairs, then verify true key equality to discard
     64-bit hash collisions (the reference compares keys in the probe
     loop for the same reason);
  5. SQL semantics: NULL keys never match — enforced by disjoint hash
     sentinels per side, so null rows generate zero candidates.

Expansion size is data-dependent: the executor syncs the candidate total
to the host between pass 1 and 2 — the same two-pass count-then-fill
structure the reference uses to build OneToMany tables
(fill_one_to_many_hash_table, HashJoinRuntime.h:181).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .groupby import _orderable_int64
from .masked import MaskedCol, combine_masks

def _i64(u: int) -> np.int64:
    """uint64 literal as its two's-complement int64 value (a host numpy
    scalar — a device array here would initialise the XLA backend at
    import time, breaking jax.distributed.initialize ordering)."""
    return np.uint64(u).astype(np.int64)


# disjoint null sentinels per side => null never matches null
_BUILD_NULL = _i64(0xF0F0F0F0F0F0F0F0)
_PROBE_NULL = _i64(0x0F0F0F0F0F0F0F0F)


def _lsr(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Logical shift right on int64 (mask off the sign extension)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: jnp.ndarray) -> jnp.ndarray:
    """splitmix64 finalizer in int64 arithmetic (wrapping semantics are
    identical to uint64, and the hashes sort as int64)."""
    x = x ^ _lsr(x, 30)
    x = x * _i64(0xBF58476D1CE4E5B9)
    x = x ^ _lsr(x, 27)
    x = x * _i64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def hash_keys(cols: Sequence[MaskedCol], null_sentinel: jnp.ndarray) -> jnp.ndarray:
    """Combined 64-bit hash of key columns; rows with any NULL key get
    ``null_sentinel``."""
    h = jnp.full(cols[0].data.shape, 0x243F6A8885A308D3, jnp.int64)
    valid = None
    for c in cols:
        k = _orderable_int64(c.data)
        h = _mix64(h ^ _mix64(k))
        valid = combine_masks(valid, c.mask)
    if valid is not None:
        h = jnp.where(valid, h, null_sentinel)
    return h


@jax.tree_util.register_pytree_node_class
@dataclass
class BuildTable:
    """Sorted-hash 'table': permutation + sorted hashes (cacheable per
    plan hash — reference: DataRecycler/HashtableRecycler.h:32)."""

    perm: jnp.ndarray  # build row index, ordered by hash
    sorted_hash: jnp.ndarray

    def tree_flatten(self):
        return (self.perm, self.sorted_hash), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def build(build_keys: Sequence[MaskedCol]) -> BuildTable:
    h = hash_keys(build_keys, _BUILD_NULL)
    perm = jnp.argsort(h, stable=True).astype(jnp.int32)
    return BuildTable(perm, h[perm])


def probe_ranges(table: BuildTable, probe_keys: Sequence[MaskedCol]
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(lo, hi) candidate positions in the sorted build table per probe row."""
    ph = hash_keys(probe_keys, _PROBE_NULL)
    # method="sort": one merge of sorted sequences instead of a
    # per-row binary search (route inherited, not yet re-measured)
    lo = jnp.searchsorted(table.sorted_hash, ph, side="left", method="sort")
    hi = jnp.searchsorted(table.sorted_hash, ph, side="right", method="sort")
    return lo.astype(jnp.int64), hi.astype(jnp.int64)


def _decode_runs(excl: jnp.ndarray, total: int) -> jnp.ndarray:
    """Run-length decode: slot j -> owning probe row, given each row's
    exclusive start offset.  Scatter-add of run-start markers + cumsum
    instead of a searchsorted (empty runs stack their markers on one
    slot, which add() handles)."""
    z = jnp.zeros((total,), jnp.int32).at[excl].add(1, mode="drop")
    return jnp.cumsum(z) - 1


def expand_pairs(table: BuildTable, lo: jnp.ndarray, hi: jnp.ndarray,
                 total: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Materialize candidate (probe_row, build_row) pairs; ``total`` is the
    host-synced candidate count (static for this trace)."""
    counts = hi - lo
    offsets = jnp.cumsum(counts)  # inclusive
    excl = offsets - counts
    j = jnp.arange(total, dtype=jnp.int64)
    l_idx = _decode_runs(excl, total)
    safe_l = jnp.minimum(l_idx, lo.shape[0] - 1)
    within = j - excl[safe_l]
    pos = lo[safe_l] + within
    r_idx = table.perm[jnp.clip(pos, 0, table.perm.shape[0] - 1)]
    return safe_l, r_idx


def expand_pairs_capped(table: BuildTable, lo: jnp.ndarray, hi: jnp.ndarray,
                        cap: int) -> Tuple[jnp.ndarray, jnp.ndarray,
                                           jnp.ndarray, jnp.ndarray]:
    """Sync-free variant of ``expand_pairs`` for fixed-capacity buffers
    (shard_map bodies can't host-sync the candidate total).  Returns
    (l_idx, r_idx, live, total): ``live`` marks real pairs, slots past
    the data are padding; ``total`` is the true candidate count so the
    caller can detect overflow (total > cap) and widen-retry."""
    counts = hi - lo
    offsets = jnp.cumsum(counts)  # inclusive
    excl = offsets - counts
    total = offsets[-1] if lo.shape[0] > 0 else jnp.asarray(0, jnp.int64)
    j = jnp.arange(cap, dtype=jnp.int64)
    l_idx = _decode_runs(excl, cap)
    safe_l = jnp.minimum(l_idx, max(lo.shape[0] - 1, 0))
    within = j - excl[safe_l]
    pos = lo[safe_l] + within
    r_idx = table.perm[jnp.clip(pos, 0, table.perm.shape[0] - 1)]
    live = j < total
    return safe_l, r_idx, live, total


@jax.tree_util.register_pytree_node_class
@dataclass
class PerfectTable:
    """Dense direct-index one-to-one table (reference:
    PerfectJoinHashTable.h:54 — min/max-keyed, ``slot = key - min_key``).
    ``rows[key - min_key]`` is the build row id, -1 for empty."""

    rows: jnp.ndarray  # (range,) int32
    min_key: int

    def tree_flatten(self):
        return (self.rows,), self.min_key

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux)


def build_perfect(build_key: MaskedCol, min_key: int, range_size: int):
    """Dense build; returns (table, is_unique).  A duplicate key makes
    the scatter lose a row, detected by count (the reference falls over
    to OneToMany on the same condition, PerfectHashTableBuilder)."""
    n = build_key.data.shape[0]
    idx = build_key.data.astype(jnp.int64) - min_key
    valid = (idx >= 0) & (idx < range_size)
    if build_key.mask is not None:
        valid = valid & build_key.mask
    pos = jnp.where(valid, idx, range_size)
    rows = jnp.full((range_size + 1,), -1, jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")[:range_size]
    n_set = jnp.sum(rows >= 0)
    n_valid = jnp.sum(valid)
    return PerfectTable(rows, min_key), n_set == n_valid, n_set


def probe_perfect(table: PerfectTable, probe_key: MaskedCol, range_size: int):
    """Per-probe-row build index (-1 = no match); NULL keys never match."""
    idx = probe_key.data.astype(jnp.int64) - table.min_key
    in_range = (idx >= 0) & (idx < range_size)
    if probe_key.mask is not None:
        in_range = in_range & probe_key.mask
    r = table.rows[jnp.clip(idx, 0, range_size - 1)]
    return jnp.where(in_range, r, -1)


def perfect_slots(probe_key: MaskedCol, min_key: int, range_size: int):
    """(slot, in_range) per probe row — elementwise only, NO table gather.

    The value-table join route: probe rows address per-column value
    tables directly by key slot, so matching a COMPLETE table (every
    slot occupied) costs zero gathers and each used build column costs
    exactly one (half the reference FK-join chain, which pays
    rows[slot] + col[row] = two dependent row-sized gathers)."""
    idx = probe_key.data.astype(jnp.int64) - min_key
    in_range = (idx >= 0) & (idx < range_size)
    if probe_key.mask is not None:
        in_range = in_range & probe_key.mask
    slots = jnp.clip(idx, 0, range_size - 1).astype(jnp.int32)
    return slots, in_range


def perfect_match(table: PerfectTable, probe_key: MaskedCol, *,
                  range_size: int, complete: bool):
    """(slot, matched) per probe row.  ``complete`` (every slot occupied,
    established at build) skips the occupancy gather entirely — the
    common FK case probes with elementwise ops only."""
    slots, in_range = perfect_slots(probe_key, table.min_key, range_size)
    if complete:
        return slots, in_range
    return slots, in_range & (table.rows[slots] >= 0)


def build_slots(build_key: MaskedCol, min_key: int, range_size: int):
    """Per-build-row key slot; invalid rows get ``range_size`` so a
    ``mode="drop"`` scatter into a (range_size,) table discards them."""
    idx = build_key.data.astype(jnp.int64) - min_key
    valid = (idx >= 0) & (idx < range_size)
    if build_key.mask is not None:
        valid = valid & build_key.mask
    return jnp.where(valid, idx, range_size).astype(jnp.int32)


def build_value_table(col: MaskedCol, slots: jnp.ndarray, range_size: int):
    """Scatter one build column into key-slot order (the per-column
    analog of PerfectJoinHashTable's payload layout, HashTable.h:25).
    Unique build keys guaranteed by the caller, so ``set`` is exact."""
    vt = jnp.zeros((range_size,) + col.data.shape[1:], col.data.dtype
                   ).at[slots].set(col.data, mode="drop")
    vm = None
    if col.mask is not None:
        vm = jnp.zeros((range_size,) + col.mask.shape[1:], jnp.bool_
                       ).at[slots].set(col.mask, mode="drop")
    return vt, vm


def spread_inner_fk(probe_slot: jnp.ndarray, vts, range_size: int):
    """Gather-free FK-join output: delta-spread sorted merge.

    For a COMPLETE perfect table (unique build keys occupying every
    slot) and an all-matching probe side, the per-column probe gather
    ``vt[slot]`` (a row-sized random gather, the dominant join cost)
    is replaced by ONE payload-carrying sort plus a cumsum per
    column:

      1. per column, take consecutive DELTAS of the slot-ordered value
         table (floats bitcast to ints so the telescoping sum is exact);
      2. sort the concat of [build slots, probe slots] with the side
         bit in the key LSB (build row leads its slot's run) carrying
         the delta columns as payloads;
      3. an integer cumsum then reconstructs, at every row, the value
         of the owning slot — each probe row reads its build row's
         value with zero random access.

    Each extra column costs one more sort payload and one cumsum
    instead of a further row-sized gather.

    ``vts``: [(vt_data_1d, vt_mask_or_None), ...] in key-slot order.
    Returns (is_probe, [(data, mask), ...]) over range_size+n_probe
    rows, in slot order with build rows interleaved (callers mask them
    dead via ``is_probe``).  Reference semantics: the OneToOne probe of
    PerfectJoinHashTable.h:54.
    """
    npr = probe_slot.shape[0]
    key2 = jnp.concatenate([
        jax.lax.iota(jnp.int32, range_size) << 1,
        (probe_slot.astype(jnp.int32) << 1) | 1,
    ])

    def delta_words(vt) -> Tuple[list, str]:
        """Exact wrap-around delta encoding of one value table as ≤4-byte
        integer words (per-word deltas telescope exactly under two's-
        complement wrapping, so the downstream cumsum reconstructs each
        word bit-exactly).  64-bit INTS split into (lo, hi) i32 words by
        shifts.  f64 value tables are not delta-encoded (not written
        yet) — callers must route f64 columns elsewhere."""
        dt = vt.dtype
        if jnp.issubdtype(dt, jnp.floating):
            if dt.itemsize != 4:
                raise ValueError("spread_inner_fk: f64 value tables "
                                 "are not delta-encoded; pre-filter at "
                                 "the route level")
            return [jax.lax.bitcast_convert_type(vt, jnp.int32)], "f32"
        if dt == jnp.bool_:
            return [vt.astype(jnp.int8)], "bool"
        if dt.itemsize == 8:  # int64 / date64 etc.
            lo = (vt & 0xFFFFFFFF).astype(jnp.int32)
            hi = ((vt >> 32) & 0xFFFFFFFF).astype(jnp.int32)
            return [lo, hi], "i64"
        return [vt], "int"

    pays = []
    specs = []
    for vt, vm in vts:
        words, kind = delta_words(vt)
        idxs = []
        for w in words:
            delta = jnp.concatenate([w[:1], w[1:] - w[:-1]])
            idxs.append(len(pays))
            pays.append(jnp.concatenate(
                [delta, jnp.zeros((npr,), delta.dtype)]))
        mi = None
        if vm is not None:
            mbits = vm.astype(jnp.int8)
            mdelta = jnp.concatenate([mbits[:1], mbits[1:] - mbits[:-1]])
            mi = len(pays)
            pays.append(jnp.concatenate(
                [mdelta, jnp.zeros((npr,), jnp.int8)]))
        specs.append((idxs, kind, vt.dtype, mi))
    out = jax.lax.sort(tuple([key2] + pays), num_keys=1, is_stable=False)
    is_probe = (out[0] & 1) == 1
    cols = []
    for idxs, kind, dt, mi in specs:
        accs = [jnp.cumsum(out[1 + i], dtype=out[1 + i].dtype)
                for i in idxs]
        if kind == "f32":
            data = jax.lax.bitcast_convert_type(accs[0], dt)
        elif kind == "bool":
            data = accs[0].astype(jnp.bool_)
        elif kind == "i64":
            lo, hi = accs
            data = ((hi.astype(jnp.int64) << 32)
                    | (lo.astype(jnp.int64) & 0xFFFFFFFF)).astype(dt)
        else:
            data = accs[0]
        mask = None
        if mi is not None:
            mask = jnp.cumsum(out[1 + mi], dtype=jnp.int8).astype(jnp.bool_)
        cols.append((data, mask))
    return is_probe, cols


def verify_pairs(build_keys: Sequence[MaskedCol], probe_keys: Sequence[MaskedCol],
                 l_idx: jnp.ndarray, r_idx: jnp.ndarray) -> jnp.ndarray:
    """True-equality check on candidate pairs (hash-collision guard)."""
    ok = jnp.ones(l_idx.shape, jnp.bool_)
    for pk, bk in zip(probe_keys, build_keys):
        pv = pk.data[l_idx]
        bv = bk.data[r_idx]
        eq = pv == bv
        if pk.mask is not None:
            eq = eq & pk.mask[l_idx]
        if bk.mask is not None:
            eq = eq & bk.mask[r_idx]
        ok = ok & eq
    return ok


