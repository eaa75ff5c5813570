"""Measured-feedback route tuning (the P3 cost-policy seam).

The analytic cost model (exec/cost.py) picks routes from cardinality
estimates; this layer refines the choice with MEASURED wall time: the
first repetitions of a plan shape run each candidate route once with a
forced device sync (``block_until_ready``), the EWMA of warm timings is
recorded, and subsequent repetitions stick with
the measured winner.  Exploration costs one extra warm execution per
candidate route per plan shape; steady-state queries pay nothing.

Reference analog: HDK sizes partitioned aggregation from cost
heuristics only (RelAlgExecutor.cpp:691-860); the autotune loop is the
addition the SURVEY flags as P3.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax


class RouteFeedback:
    """Per-session (plan-sig, route) -> EWMA seconds store."""

    def __init__(self, enabled: bool = True, ewma: float = 0.3,
                 limit: int = 4096) -> None:
        self.enabled = enabled
        self._ewma = ewma
        self._limit = limit
        self._t: Dict[Tuple[str, str], float] = {}

    def choose(self, sig: str, routes: Sequence[str]
               ) -> Tuple[str, bool]:
        """(route, measure): pick an unmeasured route to explore (in
        order), else the measured winner.  ``measure`` asks the caller
        to time this execution with a forced sync and call record()."""
        if not self.enabled or len(routes) == 1:
            return routes[0], False
        for r in routes:
            if (sig, r) not in self._t:
                return r, True
        return min(routes, key=lambda r: self._t[(sig, r)]), False

    def record(self, sig: str, route: str, seconds: float) -> None:
        if not self.enabled:
            return
        if len(self._t) > self._limit:
            self._t.clear()
        k = (sig, route)
        old = self._t.get(k)
        self._t[k] = (seconds if old is None
                      else (1 - self._ewma) * old + self._ewma * seconds)

    def measured(self, sig: str) -> Dict[str, float]:
        return {r: s for (g, r), s in self._t.items() if g == sig}


class PlanChoiceFeedback:
    """Explore-once A/B between whole-plan variants (the route-feedback
    pattern lifted one level — VERDICT r4 next #7: eager aggregation
    fires on static thresholds; a mis-fire costs a full extra sort pass
    at scale, so the session measures both plans once).

    Per (plan-sig, variant) the first repetition runs COLD (pays every
    compile, untimed), the second runs warm and records; once every
    variant is measured, the winner runs.  choose() returns
    (variant, mode) with mode in {"cold", "timed", None}."""

    def __init__(self, fb: RouteFeedback) -> None:
        self._fb = fb
        self._cold: set = set()

    def choose(self, sig: str, variants: Sequence[str]
               ) -> Tuple[str, Optional[str]]:
        if not self._fb.enabled or len(variants) == 1:
            return variants[0], None
        for v in variants:
            if (sig, v) in self._fb._t:
                continue
            if (sig, v) in self._cold:
                return v, "timed"
            if len(self._cold) > 4096:
                self._cold.clear()
            self._cold.add((sig, v))
            return v, "cold"
        return min(variants, key=lambda v: self._fb._t[(sig, v)]), None

    def record(self, sig: str, variant: str, seconds: float) -> None:
        self._fb.record(sig, variant, seconds)

    def measured(self, sig: str) -> Dict[str, float]:
        return self._fb.measured(sig)


def timed_sync(fn, *args):
    """Run ``fn`` and wait for its outputs on the device; returns
    (outputs, warm_seconds).  The first call pays compilation, so the
    timing runs the already-compiled callable a second time — explore
    mode doubles ONE execution per route, steady state pays zero."""
    out = fn(*args)  # compile + run (untimed)
    _force(out)
    t0 = time.perf_counter()
    out = fn(*args)
    _force(out)
    return out, time.perf_counter() - t0


def _force(tree) -> None:
    jax.block_until_ready(tree)


def timed_wall(fn):
    """Explore-once wall timing for multi-stage routes (join paths mix
    cached jits with host syncs, so there is no single callable to hand
    timed_sync): run ``fn`` twice — the first run pays every compile,
    the second is the timed warm execution.  ``fn`` must force its own
    outputs (e.g. Executor._force_table).  Returns (out, seconds)."""
    fn()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0
