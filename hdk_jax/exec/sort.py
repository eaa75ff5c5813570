"""ORDER BY / LIMIT engines.

Reference: QueryEngine/ResultSetSort.cpp — permutation-based comparator
sort with ``parallelTop`` per-interval heaps (:606-654) and a GPU radix
path (``baselineSort`` :211).  The mechanism here is XLA's sort:

  * multi-key ORDER BY = iterated stable argsort, last key first —
    equivalent to one lexicographic comparator sort;
  * descending uses an order-reversing bitwise-NOT on the int64 sort key
    (no negation overflow);
  * NULLS FIRST/LAST is a separate stable pass on the null flag, so null
    placement can never collide with extreme data values;
  * ORDER BY + small LIMIT uses jax.lax.top_k on the leading key as a
    pre-filter (streaming-top-n analog, StreamingTopN.cpp) — falls back
    to full sort for multi-key.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp

from .groupby import _orderable_int64
from .masked import MaskedCol


def sort_permutation(
    cols: Sequence[MaskedCol],
    descs: Sequence[bool],
    nulls_first: Sequence[bool],
) -> jnp.ndarray:
    """Stable lexicographic permutation over sort columns."""
    nrows = cols[0].data.shape[0]
    perm = jnp.arange(nrows, dtype=jnp.int32)
    for col, desc, nf in zip(reversed(list(cols)), reversed(list(descs)),
                             reversed(list(nulls_first))):
        key = _orderable_int64(col.data)
        if desc:
            key = ~key
        perm = perm[jnp.argsort(key[perm], stable=True)]
        if col.mask is not None:
            # nulls first => null flag 0, else 1; stable pass keeps order
            nullkey = jnp.where(col.mask, 1, 0) if nf else jnp.where(col.mask, 0, 1)
            perm = perm[jnp.argsort(nullkey[perm], stable=True)]
    return perm


def sort_keys_int64(
    cols: Sequence[MaskedCol],
    descs: Sequence[bool],
    nulls_first: Sequence[bool],
) -> list:
    """Per-field int64 keys for ONE variadic ``lax.sort`` (payload-
    carrying sort; ops/sortops.py): desc flips bits, NULLs pin to the
    int64 extremes (reference semantics: nulls sort as if +/-inf,
    IR/Node.h:27 SortField)."""
    keys = []
    for col, desc, nf in zip(cols, descs, nulls_first):
        key = _orderable_int64(col.data)
        if desc:
            key = ~key
        if col.mask is not None:
            sentinel = jnp.iinfo(jnp.int64).min if nf else jnp.iinfo(
                jnp.int64).max
            key = jnp.where(col.mask, key, sentinel)
        keys.append(key)
    return keys


def lex_topn(keys64: Sequence[jnp.ndarray], topn: int,
             rm: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Exact MULTI-key streaming top-n: the first ``topn`` live rows in
    ascending order of the int64 sort keys (from ``sort_keys_int64``),
    ties broken by row id — bit-identical to the stable full payload
    sort it replaces, without paying it (a full bitonic sort is
    ~log^2(n) HBM passes; this is K+2 linear ``lax.top_k`` scans).

    Scheme (the multi-key analog of the reference's StreamingTopN
    per-fragment heaps, QueryEngine/StreamingTopN.cpp): one candidate
    pass per level — liveness, each key, then row id — where pass j
    restricts to rows TIED with the running boundary on all previous
    levels and takes the ``topn`` best by level j.  Any true top-n row
    r is captured: at r's first level with value above the boundary it
    enters that pass's top-k; if it ties every level through row id,
    row ids are distinct so the final pass takes it; and it can never
    fall strictly below a boundary (that would put ``topn`` rows with
    an identical key prefix ahead of it).  The deduped candidate union
    (<= (K+2)*topn rows) then pays one tiny exact sort.

    Returns the ``topn`` selected row indices in output order (dead
    rows, if fewer than ``topn`` live, sink to the tail — mask them
    with the caller's validity window).
    """
    n = keys64[0].shape[0]
    imin = jnp.iinfo(jnp.int64).min
    cand = []
    # level -1: liveness — dead rows never compete at key levels, and
    # when fewer than topn rows are live this pass alone collects all
    # of them (no key-level sentinel can collide with real key values)
    tie = None
    if rm is not None:
        cand.append(jax.lax.top_k(rm.astype(jnp.int8), topn)[1])
        tie = rm
    # key levels: descending int64 view (~key), masked rows sink to
    # imin; the tie mask compares UNMASKED values against the boundary
    # and ANDs with the previous tie, so masked rows can't re-enter
    for k in keys64:
        d = ~k
        dj = d if tie is None else jnp.where(tie, d, imin)
        vals, idx = jax.lax.top_k(dj, topn)
        cand.append(idx)
        t = vals[topn - 1]
        tiej = d == t
        tie = tiej if tie is None else tie & tiej
    # row-id level: strict (all distinct), settles full-key ties the
    # way the stable sort does — smallest row id first
    iota = jax.lax.iota(jnp.int64, n)
    dlast = jnp.where(tie, ~iota, imin) if tie is not None else ~iota
    cand.append(jax.lax.top_k(dlast, topn)[1])

    cidx = jnp.concatenate(cand).astype(jnp.int32)
    # dedup: a row can appear in several passes; keep one copy
    order = jnp.argsort(cidx)
    ids = cidx[order]
    dup = jnp.concatenate([jnp.zeros((1,), jnp.bool_),
                           ids[1:] == ids[:-1]])
    dead = dup if rm is None else (dup | ~rm[ids])
    # exact mini-sort of the candidates: dead/dup last, then the keys
    # ascending, then row id (stable parity); lexsort's LAST key is
    # primary
    lex = ([ids.astype(jnp.int64)]
           + [k[ids] for k in reversed(list(keys64))]
           + [dead.astype(jnp.int8)])
    perm_c = jnp.lexsort(tuple(lex))
    return ids[perm_c[:topn]]


def apply_limit(perm: jnp.ndarray, limit: Optional[int], offset: int) -> jnp.ndarray:
    """Slice the permutation (reference: dropFirstN/keepFirstN,
    RelAlgExecutor.cpp:1000-1005)."""
    n = perm.shape[0]
    start = min(offset, n)
    end = n if limit is None else min(start + limit, n)
    return perm[start:end]
