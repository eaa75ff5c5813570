"""Mergeable sketch accumulators: HyperLogLog and t-digest.

Reference semantics matched (not copied):
  * APPROX_COUNT_DISTINCT -> HLL registers.  Estimation follows
    ``hll_size`` (reference: ResultSet/HyperLogLog.h:90): alpha-adjusted
    harmonic mean, linear-counting correction when the estimate is small,
    LogLog-Beta adjustment only at precision 14, no large-range
    correction (64-bit hashes).  Rank follows
    QueryEngine/HyperLogLogRank.h:33 (``min(b, clz)+1``); register merge
    is elementwise max (``hll_unify``, HyperLogLog.h:108).
  * APPROX_QUANTILE -> t-digest centroids (reference:
    Shared/approx_quantile.h:184 / Shared/quantile.h TDigest).  Built as
    a "merging digest": values sorted per group, clustered by the asin
    scale function, centroid = weighted mean.  Merge = concatenate +
    re-cluster.

Both sketches are fixed-width per-group device slot arrays, which makes
APPROX_* aggregates ALGEBRAIC: per-shard partials combine positionally
(HLL: max; t-digest: re-cluster), so they are streamable and
two-phase-distributable — skew-proof by construction, since a heavy key
collapses to one fixed-width sketch row per shard.

Builds use sort + span arithmetic (no contended scatters,
SURVEY.md §7.3); 2^-k and the f64 bit tricks come from exec.groupby;
integer division avoided throughout (shifts/masks only).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

# splitmix64 finalization constants (public domain mixer), as int64
# two's-complement (hashes stay int64 end to end)
_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_C2 = 0x94D049BB133111EB - (1 << 64)

# crossover above which the arange+searchsorted span build would allocate
# more index memory than the registers themselves are worth; fall back to
# segment ops (scatter) beyond it
_SPAN_BUILD_LIMIT = 1 << 22


def _lsr(x, k: int):
    """Logical shift right on int64 (jnp >> is arithmetic)."""
    return jax.lax.shift_right_logical(x, jnp.int64(k))


def _mix64(h):
    h = h ^ _lsr(h, 30)
    h = h * jnp.int64(_C1)
    h = h ^ _lsr(h, 27)
    h = h * jnp.int64(_C2)
    return h ^ _lsr(h, 31)


def _bitlen(w):
    """Highest-set-bit position + 1 for non-negative int64 (0 -> 0),
    via 6 unrolled shift steps — exact, no float log2 rounding traps."""
    pos = jnp.zeros_like(w)
    cur = w
    for s in (32, 16, 8, 4, 2, 1):
        hi = cur >> s  # operands non-negative: arithmetic == logical
        take = hi > 0
        pos = pos + jnp.where(take, s, 0)
        cur = jnp.where(take, hi, cur)
    return jnp.where(w > 0, pos + 1, 0)


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------

def effective_hll_p(p: int, n_groups: int, budget: int) -> int:
    """Shrink precision so n_groups * 2^p registers fit the budget.
    Floor of 4 = smallest m with an alpha constant (HyperLogLog.h:33)."""
    p = int(p)
    while p > 4 and (1 << p) * max(int(n_groups), 1) > budget:
        p -= 1
    return p


def hll_registers(data, valid, gid, n: int, p: int) -> jnp.ndarray:
    """Per-group HLL registers.

    data: value column (any dtype); valid: bool mask or None; gid: int
    group ids with dead rows >= n.  Returns (n, 2^p) int8 registers.
    """
    from ..exec.groupby import _orderable_int64

    m = 1 << p
    b = 64 - p
    h = _mix64(_orderable_int64(data))
    reg = (h & (m - 1)).astype(jnp.int64)
    w = _lsr(h, p)
    # rank = leading zeros within the b-bit field + 1 (HyperLogLogRank.h)
    rank = (b - _bitlen(w)) + 1  # w==0 -> b+1
    live = gid < n
    if valid is not None:
        live = live & valid
    cid = jnp.where(live, gid.astype(jnp.int64) * m + reg, n * m)
    if n * m <= _SPAN_BUILD_LIMIT:
        ckey = cid * 128 + rank
        s = jnp.sort(ckey)
        scid = s >> 7
        ends = jnp.searchsorted(scid, jnp.arange(n * m, dtype=jnp.int64),
                                side="right", method="sort")
        starts = jnp.concatenate([jnp.zeros((1,), ends.dtype), ends[:-1]])
        total = s.shape[0]
        top = s[jnp.clip(ends - 1, 0, total - 1)] & 127
        regs = jnp.where(ends > starts, top, 0)
    else:
        regs = jax.ops.segment_max(
            jnp.where(live, rank, 0), cid.astype(jnp.int32),
            num_segments=n * m + 1)[: n * m]
        regs = jnp.maximum(regs, 0)
    return regs.reshape(n, m).astype(jnp.int8)


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def _beta(z):
    """LogLog-Beta polynomial (HyperLogLog.h:47, used only at p=14)."""
    zf = z.astype(jnp.float64)
    zl = jnp.log(zf + 1)
    return (-0.370393911 * zf + 0.070471823 * zl + 0.17393686 * zl**2
            + 0.16339839 * zl**3 - 0.09237745 * zl**4 + 0.03738027 * zl**5
            - 0.005384159 * zl**6 + 0.00042419 * zl**7)


def hll_estimate(registers: jnp.ndarray) -> jnp.ndarray:
    """(n, m) registers -> (n,) int64 estimates (hll_size semantics)."""
    from ..exec.groupby import _pow2_f64

    n, m = registers.shape
    p = int(math.log2(m))
    M = registers.astype(jnp.int64)
    denom = jnp.sum(_pow2_f64(-M), axis=1)
    zeros = jnp.sum((registers == 0).astype(jnp.int64), axis=1)
    est = (_alpha(m) * m * m) / denom
    linear = m * jnp.log(m / jnp.maximum(zeros, 1).astype(jnp.float64))
    small = (est <= 2.5 * m) & (zeros > 0)
    if p == 14:
        beta_est = (_alpha(m) * m * (m - zeros).astype(jnp.float64)
                    / (_beta(zeros) + denom))
        est = jnp.where(est <= 2.5 * m, est, beta_est)
    out = jnp.where(small, linear, est)
    return out.astype(jnp.int64)


# ---------------------------------------------------------------------------
# t-digest
# ---------------------------------------------------------------------------

def effective_td_c(c: int, n_groups: int, budget: int) -> int:
    """Shrink centroid count so n_groups * C fits the budget (floor 8)."""
    c = int(c)
    while c > 8 and c * max(int(n_groups), 1) > budget:
        c //= 2
    return c


def _td_cluster(q, c: int):
    """Merging-digest cluster index from quantile position via the asin
    scale function k1 (t-digest paper; reference TDigest uses the same
    family) — clusters are finest at the tails."""
    k = (jnp.arcsin(jnp.clip(2.0 * q - 1.0, -1.0, 1.0)) / jnp.pi + 0.5) * c
    return jnp.clip(jnp.floor(k), 0, c - 1).astype(jnp.int64)


def _span_sums_flat(x, starts, ends):
    cpad = jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)])
    return cpad[ends] - cpad[starts]


def _cluster_spans(cid_sorted, n: int, c: int):
    """Span bounds per (group, cluster) composite over sorted cids."""
    if n * c <= _SPAN_BUILD_LIMIT:
        ends = jnp.searchsorted(cid_sorted,
                                jnp.arange(n * c, dtype=jnp.int64),
                                side="right", method="sort")
        starts = jnp.concatenate([jnp.zeros((1,), ends.dtype), ends[:-1]])
        return starts, ends, None
    return None, None, cid_sorted  # caller uses segment ops


def _cluster_reduce(vals, weights, cid_sorted, n: int, c: int):
    """Weighted cluster reduction -> ((n, c) means, (n, c) weights)."""
    starts, ends, seg = _cluster_spans(cid_sorted, n, c)
    if seg is None:
        w = _span_sums_flat(weights, starts, ends)
        v = _span_sums_flat(vals * weights, starts, ends)
    else:
        sid = jnp.minimum(seg, n * c).astype(jnp.int32)
        w = jax.ops.segment_sum(weights, sid, num_segments=n * c + 1,
                                indices_are_sorted=True)[: n * c]
        v = jax.ops.segment_sum(vals * weights, sid, num_segments=n * c + 1,
                                indices_are_sorted=True)[: n * c]
    means = v / jnp.maximum(w, 1e-300)
    return means.reshape(n, c), w.reshape(n, c)


def tdigest_build(data, valid, gid, n: int, c: int
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build per-group digests from raw rows.

    data: numeric column; valid: bool mask or None; gid: int group ids
    with dead rows >= n.  Returns ((n, c) f64 means, (n, c) f64 weights).
    """
    fv = data.astype(jnp.float64)
    live = gid < n
    if valid is not None:
        live = live & valid
    g = jnp.where(live, gid.astype(jnp.int64), n)
    # sort by (group, value)
    perm = jnp.argsort(fv, stable=True)
    perm = perm[jnp.argsort(g[perm], stable=True)]
    sg = g[perm]
    sv = fv[perm]
    nrows = sv.shape[0]
    counts = jax.ops.segment_sum(jnp.ones((nrows,), jnp.int64), sg,
                                 num_segments=n + 1,
                                 indices_are_sorted=True)
    gstarts = jnp.concatenate([jnp.zeros((1,), jnp.int64),
                               jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(nrows, dtype=jnp.int64) - gstarts[sg]
    cnt = jnp.maximum(counts[sg], 1).astype(jnp.float64)
    q = (pos.astype(jnp.float64) + 0.5) / cnt
    cl = _td_cluster(q, c)
    cid = jnp.where(sg < n, sg * c + cl, n * c)  # sorted: cl monotone in q
    ones = jnp.where(sg < n, 1.0, 0.0)
    return _cluster_reduce(sv, ones, cid, n, c)


def tdigest_merge_flat(means_flat, weights_flat, gid_flat, starts_el,
                       ends_el, n: int, c: int
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Re-cluster flattened centroids into (n, c) digests.

    Inputs are element-granular: ``gid_flat`` gives each centroid's group
    (>= n for dead), with each group's elements CONTIGUOUS and spans
    [starts_el, ends_el) per group; centroids need not be mean-sorted yet.
    Zero-weight centroids are harmless (contribute nothing).
    """
    # sort within group by mean (stable two-pass)
    perm = jnp.argsort(means_flat, stable=True)
    perm = perm[jnp.argsort(gid_flat[perm], stable=True)]
    sg = gid_flat[perm]
    sm = means_flat[perm]
    sw = weights_flat[perm]
    cumw = jnp.cumsum(sw)
    cpad = jnp.concatenate([jnp.zeros((1,), cumw.dtype), cumw])
    live = sg < n
    sgc = jnp.minimum(sg, n)
    prefix = cpad[starts_el][jnp.minimum(sgc, starts_el.shape[0] - 1)]
    W = (cpad[ends_el] - cpad[starts_el])[
        jnp.minimum(sgc, starts_el.shape[0] - 1)]
    mid = cumw - prefix - sw * 0.5
    q = mid / jnp.maximum(W, 1e-300)
    cl = _td_cluster(q, c)
    cid = jnp.where(live, sgc * c + cl, n * c)
    return _cluster_reduce(sm, jnp.where(live, sw, 0.0), cid, n, c)


def tdigest_merge_rows(means2d, weights2d, gid_sorted, row_starts,
                       row_ends, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge per-row digests of key-sorted rows into per-group digests.

    means2d/weights2d: (R, c) with rows grouped contiguously per
    ``gid_sorted`` (dead rows must carry zero weights); row_starts/row_ends:
    (n,) row spans per group.  Returns (n, c) merged digests.
    """
    r, c = means2d.shape
    gid_flat = jnp.repeat(gid_sorted.astype(jnp.int64), c)
    return tdigest_merge_flat(
        means2d.reshape(-1), weights2d.reshape(-1), gid_flat,
        row_starts * c, row_ends * c, n, c)


def tdigest_merge_gathered(means2d, weights2d, c: int
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge K digests per group laid out along axis 1: (n, K*c) -> (n, c)
    (the all-gather combine for the dense/perfect distributed path)."""
    n, k = means2d.shape
    gid_flat = jnp.repeat(jnp.arange(n, dtype=jnp.int64), k)
    el = jnp.arange(n + 1, dtype=jnp.int64) * k
    return tdigest_merge_flat(
        means2d.reshape(-1), weights2d.reshape(-1), gid_flat,
        el[:-1], el[1:], n, c)


def tdigest_quantile(means2d, weights2d, q: float) -> jnp.ndarray:
    """Per-group quantile from digests via centroid-midpoint
    interpolation (reference: quantile.h:354 TDigest::quantile)."""
    n, c = means2d.shape
    # compact live centroids left, preserving mean order
    ordkey = jnp.where(weights2d > 0, jnp.arange(c)[None, :], c)
    order = jnp.argsort(ordkey, axis=1, stable=True)
    m = jnp.take_along_axis(means2d, order, axis=1)
    w = jnp.take_along_axis(weights2d, order, axis=1)
    nv = jnp.sum((weights2d > 0).astype(jnp.int64), axis=1)
    W = jnp.sum(w, axis=1)
    cum = jnp.cumsum(w, axis=1)
    mid = cum - w * 0.5
    t = q * W
    live = jnp.arange(c)[None, :] < nv[:, None]
    below = (mid <= t[:, None]) & live
    kk = jnp.sum(below.astype(jnp.int64), axis=1) - 1
    last = jnp.maximum(nv - 1, 0)
    k0 = jnp.clip(kk, 0, last)
    k1 = jnp.clip(kk + 1, 0, last)
    take = lambda a, i: jnp.take_along_axis(a, i[:, None], axis=1)[:, 0]
    m0, m1 = take(m, k0), take(m, k1)
    d0, d1 = take(mid, k0), take(mid, k1)
    frac = jnp.clip((t - d0) / jnp.maximum(d1 - d0, 1e-300), 0.0, 1.0)
    out = jnp.where(kk < 0, take(m, jnp.zeros_like(k0)),
                    jnp.where(k1 == k0, m0, m0 + (m1 - m0) * frac))
    return jnp.where(nv > 0, out, 0.0)
