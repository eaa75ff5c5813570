"""Window function execution.

Reference: QueryEngine/WindowContext.{h,cpp} — the reference
materializes partitions via a hash join table on the partition keys,
sorts each partition, and computes rank-family / navigation / windowed
aggregates into a buffer indexed by original row position (SURVEY.md
A.6).

Mechanism: ONE lexicographic sort of all rows by
(validity, partition keys, order keys), then every window kind is a
combination of segment boundaries, prefix scans (jax.lax.associative_scan
with segmented combine), and gathers — fully fused by XLA, no
per-partition loops.  Results scatter back to original row positions.

Frame semantics (matching the reference's defaults):
  * rank family / ntile: standard SQL (frames never apply).
  * navigation (lag/lead/first/last): whole partition by default.
  * windowed aggregates: whole partition without ORDER BY; cumulative
    (RANGE UNBOUNDED PRECEDING .. CURRENT ROW, ties share the value of
    their tie-group end) with ORDER BY.

Explicit frames (reference: WindowContext.h:67-140 frame bound types):
ROWS and RANGE BETWEEN with numeric offsets.  Per-row absolute frame
bounds [lo, hi] come from position arithmetic (ROWS) or a vectorized
in-partition binary search on the single ORDER BY key (RANGE); then
SUM/COUNT/AVG are padded-cumsum differences, MIN/MAX are O(n log n)
sparse-table range queries, and FIRST/LAST/NTH_VALUE gather at
lo/hi/lo+n-1 — all fused, no per-row loops.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp

from ..ir.expr import WindowKind
from .groupby import _minmax_identity, _orderable_int64
from .masked import MaskedCol, combine_masks


def _bitlen(w):
    """floor(log2(w)) + 1 for positive int64 (0 -> 0)."""
    pos = jnp.zeros_like(w)
    cur = w
    for s in (32, 16, 8, 4, 2, 1):
        hi = cur >> s
        take = hi > 0
        pos = pos + jnp.where(take, s, 0)
        cur = jnp.where(take, hi, cur)
    return jnp.where(w > 0, pos + 1, 0)


def _span_bisect(sorted_vals, targets, lo0, hi0, left: bool):
    """Vectorized per-row binary search restricted to [lo0, hi0):
    first index where sorted_vals >= target (left) / > target (right)."""
    n = sorted_vals.shape[0]
    steps = max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)
    lo, hi = lo0, hi0
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        mv = sorted_vals[jnp.clip(mid, 0, n - 1)]
        go_right = (mv < targets) if left else (mv <= targets)
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo


def _rmq(filled, lo, hi, is_min):
    """Range min/max over [lo, hi] (hi >= lo) via a sparse table:
    levels T[j][i] = agg over [i, i + 2^j)."""
    combine = jnp.minimum if is_min else jnp.maximum
    ident = _minmax_identity(filled.dtype, is_min)
    n = filled.shape[0]
    levels = [filled]
    span = 1
    while span * 2 <= n:
        prev = levels[-1]
        shifted = jnp.concatenate(
            [prev[span:], jnp.full((span,), ident, prev.dtype)])
        levels.append(combine(prev, shifted))
        span *= 2
    table = jnp.stack(levels)
    length = jnp.maximum(hi - lo + 1, 1)
    j = (_bitlen(length) - 1).astype(jnp.int32)
    pow2 = jnp.left_shift(jnp.int64(1), j.astype(jnp.int64))
    a = table[j, jnp.clip(lo, 0, n - 1)]
    b = table[j, jnp.clip(hi - pow2 + 1, 0, n - 1)]
    return combine(a, b)


def _seg_scan(vals, reset, combine):
    """Segmented inclusive scan: restart at rows where reset is True."""

    def op(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, combine(va, vb))

    _, out = jax.lax.associative_scan(op, (reset, vals))
    return out


def compute_window(
    kind: WindowKind,
    args: Sequence[MaskedCol],
    part_cols: Sequence[MaskedCol],
    order_cols: Sequence[MaskedCol],
    order_desc: Sequence[bool],
    arg1,
    nrows: int,
    row_mask: Optional[jnp.ndarray],
    out_dtype,
    frame=None,
) -> MaskedCol:
    # ---- global sort: (validity, partition keys, order keys) ----------
    # ONE variadic payload-carrying sort (ops/sortops.py): the row index
    # rides the radix passes and the sorted keys come back directly —
    # no per-key argsort+gather round trips
    from ..ops import sortops as so

    def keyof(col: MaskedCol, desc: bool = False, nulls_high: bool = True):
        kv = _orderable_int64(col.data)
        if desc:
            kv = ~kv
        if col.mask is not None:
            sentinel = jnp.iinfo(jnp.int64).max if nulls_high else jnp.iinfo(jnp.int64).min
            kv = jnp.where(col.mask, kv, sentinel)
        return kv

    order_keys = [keyof(c, d) for c, d in zip(order_cols, order_desc)]
    part_keys = [keyof(c) for c in part_cols]
    sort_keys = (([(~row_mask)] if row_mask is not None else [])
                 + part_keys + order_keys)
    skeys, (perm,) = so.sort_with_payload(
        sort_keys, [jnp.arange(nrows, dtype=jnp.int32)])
    n_valid_keys = 1 if row_mask is not None else 0
    sorted_part = skeys[n_valid_keys:n_valid_keys + len(part_keys)]
    sorted_order = skeys[n_valid_keys + len(part_keys):]

    pos = jnp.arange(nrows, dtype=jnp.int64)
    first_row = pos == 0

    def boundary(sorted_keys):
        b = first_row
        for sk in sorted_keys:
            b = b | jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]])
        return b

    pb = boundary(sorted_part)  # partition boundary
    if row_mask is not None:
        sv = skeys[0]  # sorted invalid flag
        pb = pb | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), sv[1:] != sv[:-1]])
    ob = pb | boundary(sorted_order)  # order-tie boundary

    # partition / tie spans from the boundary bitmaps (sortops: stable
    # bool argsort; no sorted-segment scatter ops)
    pgid = jnp.cumsum(pb.astype(jnp.int32)) - 1
    n_parts = (pgid[-1] + 1) if nrows > 0 else jnp.asarray(0, jnp.int32)
    pstarts, pends = so.boundary_spans(pb, n_parts, nrows)
    start = pstarts[pgid]  # absolute partition start per row
    pend = pends[pgid] - 1  # absolute partition end per row
    cnt = pend - start + 1
    pos0 = pos - start  # 0-based within partition
    tie_gid = jnp.cumsum(ob.astype(jnp.int32)) - 1
    n_ties = (tie_gid[-1] + 1) if nrows > 0 else jnp.asarray(0, jnp.int32)
    tstarts, tends = so.boundary_spans(ob, n_ties, nrows)
    tie_start = tstarts[tie_gid]
    tie_end = tends[tie_gid] - 1

    def part_sum(vals):
        """Per-row partition sum: prefix-difference over contiguous
        spans (O(N) cumsum; the sorted-segment replacement for
        segment_sum)."""
        acc = (jnp.float64 if jnp.issubdtype(vals.dtype, jnp.floating)
               else jnp.int64)
        pref = jnp.concatenate([jnp.zeros((1,), acc),
                                jnp.cumsum(vals.astype(acc))])
        return pref[pend + 1] - pref[start]

    def frame_bounds():
        """Per-row absolute frame span [lo, hi] (inclusive; hi < lo =
        empty frame)."""
        if frame.unit == "rows":
            def side(bound):
                bk, v = bound
                if bk == "unbounded_preceding":
                    return start
                if bk == "unbounded_following":
                    return pend
                if bk == "current_row":
                    return pos
                off = jnp.int64(int(v))
                return pos - off if bk == "preceding" else pos + off
            return (jnp.maximum(side(frame.start), start),
                    jnp.minimum(side(frame.end), pend))
        # RANGE: offsets on the single ORDER BY key; v' = +-v so the
        # sorted direction is ascending in v'-space and "preceding"
        # is always v' - offset
        if len(order_cols) != 1:
            raise NotImplementedError(
                "RANGE frame with offsets requires exactly one ORDER BY "
                "key (reference: WindowContext frame validation)")
        oc = order_cols[0]
        sgn = -1.0 if order_desc[0] else 1.0
        v = oc.data.astype(jnp.float64) * sgn
        if oc.mask is not None:  # nulls sort last: +inf in v'-space
            v = jnp.where(oc.mask, v, jnp.inf)
        sv = v[perm]

        def side(bound, is_start):
            bk, off = bound
            if bk == "unbounded_preceding":
                return start
            if bk == "unbounded_following":
                return pend
            if bk == "current_row":
                return tie_start if is_start else tie_end
            tgt = sv - float(off) if bk == "preceding" else sv + float(off)
            if is_start:  # first idx in partition with v' >= tgt
                return _span_bisect(sv, tgt, start, pend + 1, left=True)
            # last idx with v' <= tgt
            return _span_bisect(sv, tgt, start, pend + 1, left=False) - 1
        return side(frame.start, True), side(frame.end, False)

    def scatter_back(sorted_vals, sorted_mask=None) -> MaskedCol:
        out = jnp.zeros((nrows,), sorted_vals.dtype).at[perm].set(sorted_vals)
        mask = (jnp.zeros((nrows,), jnp.bool_).at[perm].set(sorted_mask)
                if sorted_mask is not None else None)
        return MaskedCol(out.astype(out_dtype), mask)

    if kind == WindowKind.ROW_NUMBER:
        return scatter_back(pos0 + 1)
    if kind == WindowKind.RANK:
        return scatter_back(tie_start - start + 1)
    if kind == WindowKind.DENSE_RANK:
        obc = jnp.cumsum(ob.astype(jnp.int64))
        return scatter_back(obc - obc[jnp.clip(start, 0, nrows - 1)] + 1)
    if kind == WindowKind.PERCENT_RANK:
        rank = (tie_start - start).astype(jnp.float64)
        denom = jnp.maximum(cnt - 1, 1).astype(jnp.float64)
        return scatter_back(jnp.where(cnt <= 1, 0.0, rank / denom))
    if kind == WindowKind.CUME_DIST:
        return scatter_back((tie_end - start + 1).astype(jnp.float64)
                            / cnt.astype(jnp.float64))
    if kind == WindowKind.NTILE:
        n = jnp.int64(int(arg1))
        return scatter_back(pos0 * n // jnp.maximum(cnt, 1) + 1)

    # navigation / aggregates need the argument column in sorted order
    arg = args[0] if args else None

    if kind in (WindowKind.LAG, WindowKind.LEAD):
        k = int(arg1) if arg1 is not None else 1
        if kind == WindowKind.LEAD:
            k = -k
        src = jnp.clip(pos - k, 0, nrows - 1)
        in_part = (pgid[src] == pgid) & (pos - k >= 0) & (pos - k < nrows)
        sa = arg.data[perm]
        sm = arg.mask[perm] if arg.mask is not None else None
        vals = sa[src]
        mask = in_part if sm is None else (in_part & sm[src])
        return scatter_back(vals, mask)

    if kind in (WindowKind.FIRST_VALUE, WindowKind.LAST_VALUE,
                WindowKind.NTH_VALUE):
        sa = arg.data[perm]
        sm = arg.mask[perm] if arg.mask is not None else None
        if frame is not None:
            lo, hi = frame_bounds()
        else:
            lo, hi = start, pend
        if kind == WindowKind.FIRST_VALUE:
            idx = lo
        elif kind == WindowKind.LAST_VALUE:
            idx = hi
        else:  # NTH_VALUE(x, n): n-th row of the frame, 1-based
            idx = lo + jnp.int64(int(arg1) - 1)
        in_frame = (idx >= lo) & (idx <= hi)
        idx = jnp.clip(idx, 0, nrows - 1)
        vals = sa[idx]
        mask = in_frame if sm is None else (in_frame & sm[idx])
        return scatter_back(vals, mask)

    # ---- windowed aggregates over an explicit frame -------------------
    if frame is not None:
        lo, hi = frame_bounds()
        nonempty = hi >= lo
        loc = jnp.clip(lo, 0, nrows - 1)
        hic = jnp.clip(hi, 0, nrows - 1)
        if kind == WindowKind.COUNT:
            if arg is None or arg.mask is None:
                ones = jnp.ones((nrows,), jnp.int64)
            else:
                ones = arg.mask[perm].astype(jnp.int64)
            cpad = jnp.concatenate([jnp.zeros((1,), jnp.int64),
                                    jnp.cumsum(ones)])
            c = cpad[hic + 1] - cpad[loc]
            return scatter_back(jnp.where(nonempty, c, 0))
        fa = arg.data[perm]
        fm = arg.mask[perm] if arg.mask is not None else None
        facc = (jnp.float64 if jnp.issubdtype(fa.dtype, jnp.floating)
                else jnp.int64)
        fvals = (fa.astype(facc) if fm is None
                 else jnp.where(fm, fa, 0).astype(facc))
        fnn1 = (jnp.ones((nrows,), jnp.int64) if fm is None
                else fm.astype(jnp.int64))
        npad = jnp.concatenate([jnp.zeros((1,), jnp.int64),
                                jnp.cumsum(fnn1)])
        fnn = jnp.where(nonempty, npad[hic + 1] - npad[loc], 0)
        if kind in (WindowKind.SUM, WindowKind.AVG):
            spad = jnp.concatenate([jnp.zeros((1,), facc),
                                    jnp.cumsum(fvals)])
            s = spad[hic + 1] - spad[loc]
            if kind == WindowKind.AVG:
                return scatter_back(
                    s.astype(jnp.float64) / jnp.maximum(fnn, 1), fnn > 0)
            return scatter_back(s, fnn > 0)
        if kind in (WindowKind.MIN, WindowKind.MAX):
            is_min = kind == WindowKind.MIN
            ident = _minmax_identity(fa.dtype, is_min)
            filled = fa if fm is None else jnp.where(fm, fa, ident)
            r = _rmq(filled, loc, hic, is_min)
            return scatter_back(r, fnn > 0)
        raise NotImplementedError(f"window frame for {kind.value}")

    # ---- windowed aggregates (default frames) -------------------------
    cumulative = len(order_cols) > 0
    if kind == WindowKind.COUNT and arg is None:
        ones = jnp.ones((nrows,), jnp.int64)
        if cumulative:
            run = _seg_scan(ones, pb, jnp.add)
            return scatter_back(run[tie_end])
        return scatter_back(cnt)

    sa = arg.data[perm]
    sm = arg.mask[perm] if arg.mask is not None else None

    if kind == WindowKind.COUNT:
        ones = (jnp.ones((nrows,), jnp.int64) if sm is None
                else sm.astype(jnp.int64))
        if cumulative:
            return scatter_back(_seg_scan(ones, pb, jnp.add)[tie_end])
        return scatter_back(part_sum(ones))

    acc_dt = (jnp.float64 if jnp.issubdtype(sa.dtype, jnp.floating)
              else jnp.int64)
    vals0 = (sa.astype(acc_dt) if sm is None
             else jnp.where(sm, sa, 0).astype(acc_dt))
    nonnull = (jnp.ones((nrows,), jnp.int64) if sm is None
               else sm.astype(jnp.int64))

    if kind in (WindowKind.SUM, WindowKind.AVG):
        if cumulative:
            s = _seg_scan(vals0, pb, jnp.add)[tie_end]
            nn = _seg_scan(nonnull, pb, jnp.add)[tie_end]
        else:
            s = part_sum(vals0)
            nn = part_sum(nonnull)
        if kind == WindowKind.AVG:
            avg = s.astype(jnp.float64) / jnp.maximum(nn, 1)
            return scatter_back(avg, nn > 0)
        return scatter_back(s, nn > 0)

    if kind in (WindowKind.MIN, WindowKind.MAX):
        is_min = kind == WindowKind.MIN
        ident = _minmax_identity(sa.dtype, is_min)
        filled = sa if sm is None else jnp.where(sm, sa, ident)
        combine = jnp.minimum if is_min else jnp.maximum
        if cumulative:
            r = _seg_scan(filled, pb, combine)[tie_end]
            nn = _seg_scan(nonnull, pb, jnp.add)[tie_end]
        else:
            r = _rmq(filled, start, pend, is_min)
            nn = part_sum(nonnull)
        return scatter_back(r, nn > 0)

    raise NotImplementedError(f"window function {kind}")
