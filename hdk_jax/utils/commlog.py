"""Trace-time collective accounting for the distributed paths.

Every dist-path collective (all_to_all / psum / all_gather / pmin /
pmax) goes through the wrappers below, which — while JAX is TRACING the
enclosing shard_map body — record the operand's static per-device byte
count into the active capture.  The first execution of a query traces
every program exactly once, so a capture around it is the complete
collective footprint of that query: bytes-on-wire per query is a static
property of the traced program.

Reference analog: HDK counts shuffle rows/partition sizes on the host
(RelAlgExecutor.cpp:691-860); here the equivalent numbers fall out of
the traced shapes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

_active: Optional[List[dict]] = None


@contextlib.contextmanager
def capture():
    """Collect collective records emitted while tracing under this scope.

    Yields the mutable record list; read it after the traced call
    returns.  Nested captures are not supported (inner wins)."""
    global _active
    prev = _active
    records: List[dict] = []
    _active = records
    try:
        yield records
    finally:
        _active = prev


def _record(op: str, operands, axis_name: str) -> None:
    if _active is None:
        return
    leaves = jax.tree_util.tree_leaves(operands)
    nbytes = int(sum(
        int(np.prod(l.shape)) * jnp.dtype(l.dtype).itemsize
        if hasattr(l, "shape") else 0
        for l in leaves))
    _active.append({"op": op, "axis": axis_name,
                    "bytes_per_device": nbytes})


def all_to_all(x, axis_name: str, *, split_axis: int, concat_axis: int,
               tiled: bool = False):
    _record("all_to_all", x, axis_name)
    return jax.lax.all_to_all(x, axis_name, split_axis=split_axis,
                              concat_axis=concat_axis, tiled=tiled)


def psum(x, axis_name: str):
    _record("psum", x, axis_name)
    return jax.lax.psum(x, axis_name)


def pmin(x, axis_name: str):
    _record("pmin", x, axis_name)
    return jax.lax.pmin(x, axis_name)


def pmax(x, axis_name: str):
    _record("pmax", x, axis_name)
    return jax.lax.pmax(x, axis_name)


def all_gather(x, axis_name: str, *, axis: int = 0, tiled: bool = False):
    _record("all_gather", x, axis_name)
    return jax.lax.all_gather(x, axis_name, axis=axis, tiled=tiled)


def summarize(records: List[dict], n_devices: int) -> Dict:
    """Aggregate a capture into per-op and wire-level byte totals.

    ``wire_bytes_per_device`` models what actually crosses the
    interconnect per device: all_to_all keeps (n-1)/n of the payload
    off-chip; psum (ring all-reduce) moves ~2x the operand; all_gather
    receives (n-1) shards of the per-device operand.
    """
    per_op: Dict[str, int] = {}
    wire = 0.0
    n = max(n_devices, 1)
    for r in records:
        b = r["bytes_per_device"]
        per_op[r["op"]] = per_op.get(r["op"], 0) + b
        if r["op"] == "all_to_all":
            wire += b * (n - 1) / n
        elif r["op"] in ("psum", "pmin", "pmax"):
            wire += 2.0 * b * (n - 1) / n
        elif r["op"] == "all_gather":
            wire += b * (n - 1)
    return {
        "n_collectives": len(records),
        "bytes_per_device_by_op": per_op,
        "wire_bytes_per_device": int(wire),
    }
