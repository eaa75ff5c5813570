"""Variadic payload-carrying sort + span primitives.

The rules behind these helpers (inherited from an earlier target and
not yet re-measured on the current one, ROADMAP D3):

  * ``lax.sort`` with payload operands moves the payload DURING the
    sort, so one fused sort replaces an argsort followed by a
    per-column permutation gather ``x[perm]``.
  * group-span bounds come from a boundary bitmap via a stable bool
    sort (True positions compact to the front in index order), not
    from ``searchsorted``.  The cap-sized POSITION ARRAY is then taken
    by slice, never by gather, which is also why groupby_sort's fast
    tail avoids spans entirely (one compaction sort of group-end
    cumsums).

Reference role: this is the replacement for the reference's
hash-table fill loops (GroupByRuntime.cpp) — sort once, then all
aggregation is sequential span arithmetic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


def sort_with_payload(key_arrays: Sequence[jnp.ndarray],
                      payloads: Sequence[jnp.ndarray],
                      stable: bool = True
                      ) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """ONE variadic sort pass: lexicographic by ``key_arrays`` (first is
    major); ``payloads`` are permuted alongside without gathers."""
    ops = tuple(key_arrays) + tuple(payloads)
    out = jax.lax.sort(ops, num_keys=len(key_arrays), is_stable=stable)
    return list(out[: len(key_arrays)]), list(out[len(key_arrays):])


def boundary_spans(boundary: jnp.ndarray, total_groups, cap: int
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-group [start, end) spans over sorted rows from the
    group-boundary bitmap.

    ``total_groups`` is the boundary count (groups beyond it get empty
    spans at n).  Group ``g``'s end is group ``g+1``'s start; the last
    group ends at n.  Scatter-free: a stable argsort of ~boundary
    compacts the True positions to the front in ascending order.
    """
    n = boundary.shape[0]
    _, bpos = jax.lax.sort((~boundary, jax.lax.iota(jnp.int32, n)),
                           num_keys=1, is_stable=True)
    if cap + 1 <= n:
        pos = bpos[:cap + 1].astype(jnp.int64)  # slice, not gather
    else:
        pos = jnp.concatenate(
            [bpos.astype(jnp.int64),
             jnp.full((cap + 1 - n,), n, jnp.int64)])
    idx = jnp.arange(cap + 1)
    ext = jnp.where(idx < total_groups, pos, n)
    return ext[:cap], ext[1:]


def changed(sorted_arr: jnp.ndarray) -> jnp.ndarray:
    """Boundary bitmap of a sorted array: True where a new run starts."""
    n = sorted_arr.shape[0]
    return jnp.concatenate([jnp.ones((1,), jnp.bool_),
                            sorted_arr[1:] != sorted_arr[:-1]])


class PayloadSet:
    """Deduplicating payload registry for ``sort_with_payload``: the
    same device array registered twice rides the sort once."""

    def __init__(self) -> None:
        self.arrays: List[jnp.ndarray] = []
        self._pos = {}

    def add(self, arr: Optional[jnp.ndarray]) -> Optional[int]:
        if arr is None:
            return None
        key = id(arr)
        got = self._pos.get(key)
        if got is None:
            got = len(self.arrays)
            self._pos[key] = got
            self.arrays.append(arr)
        return got
