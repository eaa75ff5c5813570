"""Distributed sort: sampled range partitioning + all_to_all + local sort.

The reference's sort is single-node (parallelTop / GPU radix,
ResultSetSort.cpp); this is the multi-device generalization promised in
SURVEY.md P7: distributed sort with per-shard merge.

Mechanism (inside shard_map over the row-sharded input):
  1. every shard takes a regular sample of its *leading* sort keys; an
     all_gather makes the global sample visible everywhere (tiny);
  2. splitters = sample quantiles (num_shards-1 of them) — the range
     partition function (radix-partition analog with data-adaptive
     boundaries, which also absorbs value skew);
  3. rows route to the shard owning their range via binary search —
     rows with EQUAL leading keys always share a destination, so
     secondary sort keys order correctly within one shard; ONE
     all_to_all exchanges them (fixed capacity + validity, like the
     hash shuffle);
  4. each shard sorts its received rows by the full key list
     (lexicographic iterated stable argsort); the concatenation of
     shard outputs in shard order is globally sorted.

Dead rows (filter-dead / shard padding) are dropped at the exchange and
never occupy output slots.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..exec.groupby import _orderable_int64
from ..exec.masked import MaskedCol
from . import shuffle as shf
from .mesh import FRAG_AXIS
from ..utils import commlog


def _sort_key(col: MaskedCol, desc: bool, nulls_first: bool) -> jnp.ndarray:
    kv = _orderable_int64(col.data)
    if desc:
        kv = ~kv
    if col.mask is not None:
        sentinel = (jnp.iinfo(jnp.int64).min if nulls_first
                    else jnp.iinfo(jnp.int64).max)
        kv = jnp.where(col.mask, kv, sentinel)
    return kv


def dist_sort(
    mesh: Mesh,
    sort_cols: Sequence[MaskedCol],
    descs: Sequence[bool],
    nulls_firsts: Sequence[bool],
    payload_cols: Sequence[MaskedCol],
    rows_per_shard: int,
    row_valid: Optional[jnp.ndarray] = None,
    axis: str = FRAG_AXIS,
    sample_per_shard: int = 256,
    slack: float = 2.0,
):
    """Row-sharded input -> range-partitioned, locally-sorted shards.

    Returns (sorted_payload_cols, row_valid_out, overflow): per-shard
    buffers of ``num_shards * cap`` rows; taking valid rows shard-by-
    shard in mesh order yields the global ORDER BY order.
    """
    num_shards = mesh.devices.size
    cap = max(1, int(math.ceil(rows_per_shard * slack)))

    def shard_fn(scols, payloads, rvalid):
        keys = [_sort_key(c, d, nf)
                for c, d, nf in zip(scols, descs, nulls_firsts)]
        lead = keys[0]
        n_loc = lead.shape[0]
        valid = (jnp.ones((n_loc,), jnp.bool_) if rvalid is None else rvalid)
        # 1) regular sample of local leading keys (dead rows sample last
        #    and are pushed out of the quantile window by validity count)
        lead_for_sample = jnp.where(valid, lead, jnp.iinfo(jnp.int64).max)
        local_sorted = jnp.sort(lead_for_sample)
        idx = jnp.linspace(0, n_loc - 1, sample_per_shard).astype(jnp.int32)
        sample = local_sorted[idx]
        # 2) global splitters from the gathered sample
        all_samples = commlog.all_gather(sample, axis).reshape(-1)
        all_sorted = jnp.sort(all_samples)
        total = all_sorted.shape[0]
        spl_idx = (jnp.arange(1, num_shards) * total // num_shards)
        splitters = all_sorted[spl_idx]
        # 3) destination shard per row + exchange (keys ride along so the
        #    local sort can re-derive full lexicographic order)
        dest = jnp.searchsorted(splitters, lead, side="right",
                                method="sort").astype(jnp.int32)
        cols = [MaskedCol(k) for k in keys] + list(payloads)
        flat: List[jnp.ndarray] = []
        positions: List[Tuple[int, Optional[int]]] = []
        for c in cols:
            di = len(flat)
            flat.append(c.data)
            mi = None
            if c.mask is not None:
                mi = len(flat)
                flat.append(c.mask)
            positions.append((di, mi))
        bufs, buf_valid, overflow = shf.build_send_buffers(
            dest, flat, valid, num_shards, cap)
        recv, recv_valid = shf.exchange(bufs, buf_valid, axis)
        out_cols = [MaskedCol(recv[di], recv[mi] if mi is not None else None)
                    for di, mi in positions]
        # 4) local lexicographic sort of received rows; invalid rows
        # last.  ONE variadic payload-carrying sort instead of iterated
        # argsorts + per-column permutation gathers (ops/sortops.py)
        nk = len(keys)
        skeys = [~recv_valid] + [c.data for c in out_cols[:nk]]
        flatp: List[jnp.ndarray] = []
        pos2: List[Tuple[int, Optional[int]]] = []
        for c in out_cols[nk:]:
            di = len(flatp)
            flatp.append(c.data)
            mi = None
            if c.mask is not None:
                mi = len(flatp)
                flatp.append(c.mask)
            pos2.append((di, mi))
        sout = jax.lax.sort(tuple(skeys) + tuple(flatp),
                            num_keys=len(skeys), is_stable=True)
        base = len(skeys)
        valid_out = ~sout[0]
        sorted_payloads = [
            MaskedCol(sout[base + di],
                      sout[base + mi] if mi is not None else None)
            for di, mi in pos2
        ]
        return sorted_payloads, valid_out, commlog.psum(overflow, axis)

    in_specs = (
        jax.tree.map(lambda _: P(axis), list(sort_cols)),
        jax.tree.map(lambda _: P(axis), list(payload_cols)),
        None if row_valid is None else P(axis),
    )
    out_specs = (
        jax.tree.map(lambda _: P(axis), [
            MaskedCol(jnp.zeros(()), None if c.mask is None
                      else jnp.zeros((), jnp.bool_))
            for c in payload_cols
        ]),
        P(axis),
        P(),
    )
    return shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)(
        list(sort_cols), list(payload_cols), row_valid)
