"""Masked column values — the device-side value representation.

The reference encodes NULLs as in-band sentinels chosen per type
(reference: omniscidb/Shared/InlineNullValues.h) because LLVM scalar code
favors branchless sentinel checks.  Here the natural representation is
a validity mask (vectorizes, composes with jnp.where, and lets data stay
in its natural dtype).  ``MaskedCol`` pairs a data array with an
optional validity mask; ``mask=None`` means all-valid, which keeps
non-null columns mask-free end to end (no bandwidth cost).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclass
class MaskedCol:
    """data + validity (True = valid).  Scalars are 0-d arrays."""

    data: jnp.ndarray
    mask: Optional[jnp.ndarray] = None  # bool, same shape as data, or None

    # pytree protocol: composes with jit / shard_map / vmap
    def tree_flatten(self):
        return (self.data, self.mask), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def is_scalar(self) -> bool:
        return self.data.ndim == 0

    def valid_mask(self) -> jnp.ndarray:
        """Materialized mask (all-True if mask is None)."""
        if self.mask is None:
            return jnp.ones(self.data.shape, dtype=jnp.bool_)
        return self.mask

    def fill(self, value) -> jnp.ndarray:
        """Data with nulls replaced by ``value``."""
        if self.mask is None:
            return self.data
        return jnp.where(self.mask, self.data, jnp.asarray(value, self.data.dtype))


def combine_masks(*masks: Optional[jnp.ndarray]) -> Optional[jnp.ndarray]:
    """AND of optional masks (null-propagating ops)."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out & m)
    return out


def all_null(shape, dtype) -> MaskedCol:
    return MaskedCol(jnp.zeros(shape, dtype), jnp.zeros(shape, jnp.bool_))


def nonzero_indices(mask: jnp.ndarray, n: int) -> jnp.ndarray:
    """First ``n`` indices where mask is True, in order.

    Equivalent to jnp.flatnonzero(mask, size=n) but via a stable boolean
    argsort."""
    order = jnp.argsort(~mask, stable=True)
    return order[:n].astype(jnp.int32)
