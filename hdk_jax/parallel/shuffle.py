"""Distributed hash-partition shuffle: all_to_all row exchange by key.

This is the multi-device generalization of the reference's single-node
two-pass Shuffle (reference: RelAlgExecutor.cpp:691-860
executeStepWithPartitionedAggregation — step A COUNT histogram, step B
scatter into partitions; IR/Node.h:871-933 ShuffleFunction{kHash}).

Mechanism (runs inside shard_map over the "frag" axis):
  1. per-shard, compute each row's destination shard from a 64-bit key
     hash (reference: key_hash partitioning, GroupByRuntime.cpp:25-29);
  2. locally bucket rows by destination into a fixed-capacity
     (P, cap) send buffer — rank-within-destination via a stable sort by
     destination (the scatter of step B);
  3. ONE lax.all_to_all exchanges the buffers between devices;
  4. receivers flatten to (P*cap) rows with a validity mask (static
     shapes: overflows are counted and reported so callers can retry
     with a larger cap — the reference's widen-and-retry ladder).

Capacity: rows are ~uniform under a good hash, so cap = ceil(n/P) * slack
covers realistic skew of *row placement*; key skew (one hot key) is
handled above this layer by heavy-hitter splitting (SURVEY.md §7.3).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..exec.join import _i64, _lsr, _mix64
from ..exec.groupby import _orderable_int64
from ..exec.masked import MaskedCol
from ..utils import commlog

# rows whose key is NULL hash to a fixed bucket (they still form a group)
_NULL_HASH = _i64(0x9E3779B97F4A7C15)


def key_hash(cols: Sequence[MaskedCol]) -> jnp.ndarray:
    """64-bit combined hash (int64 two's-complement); NULL keys get a
    fixed hash so all-null rows land on one shard
    and aggregate together."""
    h = jnp.full(cols[0].data.shape, 0x243F6A8885A308D3, jnp.int64)
    for c in cols:
        k = _orderable_int64(c.data)
        if c.mask is not None:
            k = jnp.where(c.mask, k, _NULL_HASH)
        h = _mix64(h ^ _mix64(k))
    return h


def bucket_for_shards(h: jnp.ndarray, num_shards: int) -> jnp.ndarray:
    """Destination shard per row (high bits — low bits feed local tables)."""
    return (_lsr(h, 33) % num_shards).astype(jnp.int32)


def build_send_buffers(
    dest: jnp.ndarray,
    payload: Sequence[jnp.ndarray],
    valid: jnp.ndarray,
    num_shards: int,
    cap: int,
) -> Tuple[List[jnp.ndarray], jnp.ndarray, jnp.ndarray]:
    """Bucket local rows into (num_shards, cap) send buffers.

    Returns (bufs, buf_valid, overflow_count).  Rows beyond ``cap`` for a
    destination are dropped and counted in overflow_count (caller retries
    with larger cap; reference analog: OUT_OF_SLOTS retry ladder).
    """
    n = dest.shape[0]
    dest = jnp.where(valid, dest, num_shards)  # invalid rows -> trash bucket
    order = jnp.argsort(dest, stable=True)
    sorted_dest = dest[order]
    # rank within destination: position - start offset of that destination
    counts = jax.ops.segment_sum(jnp.ones((n,), jnp.int32), sorted_dest,
                                 num_segments=num_shards + 1,
                                 indices_are_sorted=True)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    pos_in_sorted = jnp.arange(n, dtype=jnp.int32)
    rank = pos_in_sorted - starts[sorted_dest]
    keep = (sorted_dest < num_shards) & (rank < cap)
    slot = jnp.where(keep, sorted_dest * cap + rank, num_shards * cap)
    bufs = []
    for col in payload:
        # trailing dims (e.g. sketch-slot columns, (rows, C)) ride along:
        # the scatter/gather index the leading row axis only
        flat = jnp.zeros((num_shards * cap + 1,) + col.shape[1:],
                         col.dtype).at[slot].set(col[order], mode="drop")
        bufs.append(flat[:-1].reshape((num_shards, cap) + col.shape[1:]))
    buf_valid = jnp.zeros((num_shards * cap + 1,), jnp.bool_).at[slot].set(
        keep, mode="drop")[:-1].reshape(num_shards, cap)
    overflow = jnp.sum(
        jnp.where(sorted_dest < num_shards, (rank >= cap).astype(jnp.int32), 0))
    return bufs, buf_valid, overflow


def exchange(bufs: Sequence[jnp.ndarray], buf_valid: jnp.ndarray,
             axis_name: str) -> Tuple[List[jnp.ndarray], jnp.ndarray]:
    """all_to_all the (P, cap, ...) buffers over the mesh axis and flatten
    to (P*cap, ...) local rows + validity.

    Same-dtype buffers are packed into ONE collective (trailing-axis
    concat), so a shuffle costs #distinct-dtypes all_to_alls instead of
    #columns + 1 — collective launch latency amortizes, and the
    virtual-CPU dryrun dispatches far fewer ops."""
    allb = list(bufs) + [buf_valid]
    by_dtype: dict = {}
    for i, b in enumerate(allb):
        c = b.reshape(b.shape[0], b.shape[1], -1)
        by_dtype.setdefault(c.dtype, []).append((i, c))
    results: List[Optional[jnp.ndarray]] = [None] * len(allb)
    for items in by_dtype.values():
        packed = (jnp.concatenate([c for _, c in items], axis=2)
                  if len(items) > 1 else items[0][1])
        r = commlog.all_to_all(packed, axis_name, split_axis=0,
                               concat_axis=0, tiled=True)
        off = 0
        for i, c in items:
            w = c.shape[2]
            results[i] = r[:, :, off:off + w]
            off += w
    out = []
    for i, b in enumerate(bufs):
        r = results[i]
        out.append(r.reshape((-1,) + b.shape[2:]) if b.ndim > 2
                   else r.reshape(-1))
    return out, results[-1].reshape(-1)


def shuffle_rows(
    key_cols: Sequence[MaskedCol],
    payload_cols: Sequence[MaskedCol],
    axis_name: str,
    num_shards: int,
    cap: int,
    row_valid: Optional[jnp.ndarray] = None,
) -> Tuple[List[MaskedCol], jnp.ndarray, jnp.ndarray]:
    """Full shuffle of (keys ++ payload) rows to key-owner shards.

    Rows where ``row_valid`` is False are not sent.  Returns
    (cols, row_valid, overflow) where cols mirrors
    key_cols ++ payload_cols with P*cap local rows post-exchange.
    """
    all_cols = list(key_cols) + list(payload_cols)
    h = key_hash(key_cols)
    dest = bucket_for_shards(h, num_shards)
    valid = (jnp.ones(dest.shape, jnp.bool_) if row_valid is None
             else row_valid)
    payload: List[jnp.ndarray] = []
    positions: List[Tuple[int, Optional[int]]] = []
    for c in all_cols:
        di = len(payload)
        payload.append(c.data)
        mi = None
        if c.mask is not None:
            mi = len(payload)
            payload.append(c.mask)
        positions.append((di, mi))
    bufs, buf_valid, overflow = build_send_buffers(
        dest, payload, valid, num_shards, cap)
    recv, recv_valid = exchange(bufs, buf_valid, axis_name)
    out_cols = [
        MaskedCol(recv[di], recv[mi] if mi is not None else None)
        for di, mi in positions
    ]
    return out_cols, recv_valid, overflow
