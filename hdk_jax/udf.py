"""User-defined scalar functions.

Reference: omniscidb/QueryEngine/UdfCompiler.h:30 — the reference
compiles C++ UDF sources to LLVM IR and links them into generated
kernels.  The analog here registers a *jax-traceable* Python
function: it is traced straight into the same fused XLA program as the
rest of the query step, so a UDF fuses with its surrounding expressions
exactly like a builtin (no FFI boundary, no separate compilation
pipeline).

Contract for registered functions:
  * called with one jnp array per argument (the column data, never the
    validity mask), all of equal length;
  * must be traceable by jax (no Python control flow on values) and
    shape-preserving;
  * NULL handling is SQL-style by default: an output row is NULL when
    any input row is NULL (``null_propagation=True``).  With
    ``null_propagation=False`` the function receives a trailing
    ``valid`` bool array (or None) and must return ``(data, mask)``.

Example::

    hdk.register_udf("gcd", lambda a, b: jnp.gcd(a, b),
                     arg_types=[t.int64(), t.int64()], ret_type=t.int64())
    hdk.sql("SELECT gcd(a, b) FROM t")
    ht.proj(g=hdk.call("gcd", ht["a"], ht["b"]))
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from . import types as t


@dataclass
class Udf:
    name: str
    fn: Callable
    arg_types: List[t.Type]
    ret_type: t.Type
    null_propagation: bool = True


class UdfRegistry:
    """Session-scoped registry (reference: table of ExtensionFunction
    signatures).  ``generation`` feeds compiled-plan cache keys so
    re-registering a name invalidates stale traces."""

    def __init__(self) -> None:
        self._udfs: Dict[str, Udf] = {}
        self.generation = 0

    def register(self, name: str, fn: Callable,
                 arg_types: Sequence[t.Type], ret_type: t.Type,
                 null_propagation: bool = True) -> Udf:
        name = name.lower()
        udf = Udf(name, fn, list(arg_types), ret_type, null_propagation)
        self._udfs[name] = udf
        self.generation += 1
        return udf

    def unregister(self, name: str) -> None:
        if self._udfs.pop(name.lower(), None) is not None:
            self.generation += 1

    def get(self, name: str) -> Optional[Udf]:
        return self._udfs.get(name.lower())

    def names(self) -> List[str]:
        return sorted(self._udfs)

    def __bool__(self) -> bool:
        return bool(self._udfs)
