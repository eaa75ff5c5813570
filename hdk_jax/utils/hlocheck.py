"""Compiled-HLO collective extraction: the commlog cross-check.

utils/commlog.py records the collectives the ENGINE asks for (explicit
shard_map psum/all_to_all/...).  XLA's SPMD partitioner can also insert
collectives the engine never wrote — the round-3 blind spot was the
dense perfect-layout aggregation whose AllReduce came from GSPMD and
was invisible to commlog.

This module parses collective ops and operand shapes out of a COMPILED
HLO module, so a test (tests/test_commlog.py) can reconcile the two
accountings: every byte the scaling model charges must appear in the
executable, and an executable with collective bytes that commlog missed
fails the cross-check.

Reference analog: the per-device reduce buffers are first-class objects
in the reference (Execute.cpp:1156 reduceMultiDeviceResults); here the
equivalent ground truth is the partitioned executable itself.
"""

from __future__ import annotations

import re
from typing import Dict, List

# collective HLO opcodes -> commlog op names.  all-reduce-start /
# all-gather-start etc. are the async forms of the same ops.
_COLLECTIVE_OPS = {
    "all-reduce": "psum",
    "all-reduce-start": "psum",
    "all-to-all": "all_to_all",
    "ragged-all-to-all": "all_to_all",
    "all-gather": "all_gather",
    "all-gather-start": "all_gather",
    "reduce-scatter": "reduce_scatter",
    "collective-permute": "ppermute",
    "collective-permute-start": "ppermute",
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# `%name = (shape, ...) opcode(` or `%name = shape opcode(`
_INSTR_RE = re.compile(
    r"=\s*(?P<shapes>\([^)]*\)|\S+)\s+(?P<op>[a-z0-9-]+)\(")
_SHAPE_RE = re.compile(r"(?P<dt>[a-z]+\d*)\[(?P<dims>[\d,]*)\]")


def _shape_bytes(shapes: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shapes):
        nbytes = _DTYPE_BYTES.get(m.group("dt"))
        if nbytes is None:
            continue
        n = 1
        dims = m.group("dims")
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * nbytes
    return total


def collectives_in_hlo(hlo_text: str) -> List[dict]:
    """[{op, bytes_per_device}] for every collective instruction in a
    compiled HLO module text (``compiled.as_text()``).

    ``bytes_per_device`` is the RESULT shape of the instruction — for
    all-reduce that equals the per-device operand (commlog's convention)
    and for all-gather-start tuples the output shard set.  The async
    ``*-done`` halves are skipped (the ``*-start`` carries the shape).
    """
    out = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if m is None:
            continue
        op = _COLLECTIVE_OPS.get(m.group("op"))
        if op is None:
            continue
        nbytes = _shape_bytes(m.group("shapes"))
        if m.group("op").endswith("-start") and m.group("shapes").startswith("("):
            # async start result tuples carry (operand, result[, scratch]):
            # charge the result once, not the tuple (halve the pair)
            nbytes //= 2
        out.append({"op": op, "bytes_per_device": nbytes})
    return out


def summarize_hlo(hlo_text: str) -> Dict[str, int]:
    """Per-op byte totals, same keying as commlog.summarize's
    ``bytes_per_device_by_op``."""
    per_op: Dict[str, int] = {}
    for r in collectives_in_hlo(hlo_text):
        per_op[r["op"]] = per_op.get(r["op"], 0) + r["bytes_per_device"]
    return per_op


def compiled_text(fn, *args) -> str:
    """Compile a jittable callable and return its optimized HLO text
    (post SPMD partitioning — GSPMD-inserted collectives included)."""
    import jax

    lowered = jax.jit(fn).lower(*args)
    return lowered.compile().as_text()
