"""Group-by / aggregation engines.

The reference picks one of several output layouts per query
(reference: ResultSet/ResultType.h:28-34 via MemoryLayoutBuilder.h:40-51):

  * NonGroupedAggregate  -> ``nogroup_agg``: pure XLA reductions.
  * GroupByPerfectHash   -> ``groupby_perfect``: the reference computes
    ``off = (key - min_key) / bucket * stride`` positionally with no
    probing (GroupByRuntime.cpp:199-213, multi-key cross-product formula
    in docs/results.rst).  Here this is a segment-reduction into a
    dense buffer — the equivalent of a positional group buffer, with a
    trailing slot per nullable key (the reference's has_nulls extra
    slot).
  * GroupByBaselineHash  -> ``groupby_sort``: the reference uses a
    MurmurHash open-addressing table with CAS claims
    (GroupByRuntime.cpp:31-54).  This engine has no hash table; the
    baseline layout is *sort-based* (SURVEY.md §7.3): lexicographic
    multi-key sort, group boundary detection, then sorted-segment
    reductions.  This yields the
    same groups, naturally compacted and key-ordered.

Aggregate cell semantics follow the reference (SURVEY.md A.2):
COUNT(*) counts rows; COUNT(col) counts non-null; SUM/MIN/MAX/AVG skip
nulls and return NULL for all-null groups; AVG is a (sum, count) pair
finalized at materialization; STDDEV/VAR use (sum, sumsq, count).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .. import types as t
from ..ir.expr import AggKind
from ..ops import onehot
from .masked import MaskedCol, combine_masks


@dataclass
class AggSpec:
    """One aggregate target, operand already evaluated."""

    kind: AggKind
    operand: Optional[MaskedCol]  # None for COUNT(*)
    out_type: t.Type
    distinct: bool = False
    arg1: object = None  # quantile fraction / k / etc.
    interpolation: str = "linear"
    operand2: Optional[MaskedCol] = None  # CORR's second argument
    # mergeable-sketch sizing (reference: HyperLogLog.h hll_size /
    # approx_quantile.h TDigest); effective values shrink with the group
    # count to fit the budget (ops/sketches.effective_*)
    hll_p: int = 11
    hll_budget: int = 1 << 24
    td_c: int = 300
    td_budget: int = 1 << 21


@dataclass
class PerfectHashLayout:
    """Dense positional layout over integer key ranges (reference:
    QueryMemoryDescriptor min_val/max_val/bucket, QMD.h:212-214)."""

    mins: List[int]
    sizes: List[int]  # per-key slot count (incl. +1 null slot if nullable)
    null_slots: List[bool]

    @property
    def entry_count(self) -> int:
        return int(math.prod(self.sizes))


def choose_perfect_layout(
    key_types: Sequence[t.Type],
    key_ranges: Sequence[Tuple[Optional[float], Optional[float], bool]],
    limit: int,
) -> Optional[PerfectHashLayout]:
    """Layout chooser (reference: MemoryLayoutBuilder picks PerfectHash when
    the key-range product is small; Shared/Config.h big_group_threshold)."""
    mins: List[int] = []
    sizes: List[int] = []
    null_slots: List[bool] = []
    total = 1
    for typ, (lo, hi, has_nulls) in zip(key_types, key_ranges):
        ok = (typ.is_integer() or typ.is_boolean() or typ.is_dict_encoded_string()
              or (typ.is_date() and typ.unit == t.TimeUnit.DAY))  # type: ignore[attr-defined]
        if not ok or lo is None or hi is None:
            if typ.is_boolean():
                lo, hi = 0, 1
            else:
                return None
        size = int(hi) - int(lo) + 1
        if has_nulls or typ.nullable:
            size += 1
        if size <= 0:
            return None
        mins.append(int(lo))
        sizes.append(size)
        null_slots.append(True)  # null slot always reserved at index size-1
        total *= size
        if total > limit:
            return None
    return PerfectHashLayout(mins, sizes, null_slots)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_SUM_DTYPE = {True: jnp.float64, False: jnp.int64}

# entry count above which segment sums leave the scatter-free tiers
# (route threshold inherited from an earlier target, not yet re-measured)
DENSE_SCATTER_LIMIT = 512


def _acc_dtype(v: MaskedCol):
    return jnp.float64 if jnp.issubdtype(v.data.dtype, jnp.floating) else jnp.int64


def _minmax_identity(dtype, is_min: bool):
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.asarray(jnp.inf if is_min else -jnp.inf, dtype)
    info = jnp.iinfo(dtype)
    return jnp.asarray(info.max if is_min else info.min, dtype)



# below this many segments a scatter-based segment reduction piles
# every row onto a few accumulator cells — use masked full-column
# reductions instead, one vector pass per segment
_FEW_SEGMENTS = 4


def _seg_sum(vals, gid, n, sorted_, is_ones: bool = False):
    """Segment sum, tiered: masked vector reductions for a handful of
    segments, the blocked one-hot matrix contraction up to
    ``onehot.SEGMENT_LIMIT`` (ops/onehot.py), XLA scatter beyond.

    Accumulates in 64-bit and RETURNS int64/float64 regardless of the
    input width — pass operands at their NATIVE width so the one-hot
    tier decomposes into as few bf16-exact limbs as possible (a bool
    count column is 1 limb; pre-widening it to int64 would cost 8)."""
    acc_t = (jnp.float64 if jnp.issubdtype(vals.dtype, jnp.floating)
             else jnp.int64)
    if n <= _FEW_SEGMENTS and vals.ndim == 1:
        # ONE pass over a (N, n) select instead of n masked passes;
        # bool counts accumulate in i32
        hit = gid[:, None] == jnp.arange(n, dtype=gid.dtype)[None, :]
        if vals.dtype == jnp.bool_:
            cnt = jnp.sum(jnp.where(hit & vals[:, None], jnp.int32(1),
                                    jnp.int32(0)), axis=0)
            return cnt.astype(jnp.int64)
        sel = jnp.where(hit, vals[:, None].astype(acc_t),
                        jnp.zeros((), acc_t))
        return jnp.sum(sel, axis=0)
    if n <= _FEW_SEGMENTS:
        v64 = vals.astype(acc_t)
        zero = jnp.zeros((), acc_t)
        return jnp.stack([
            jnp.sum(jnp.where(_bcast(gid == g, v64), v64, zero), axis=0)
            for g in range(n)])
    if vals.ndim == 1 and n <= onehot.SEGMENT_LIMIT:
        return onehot.seg_sums([vals], gid, n,
                               ones_ids=(0,) if is_ones else ())[0]
    # multi-dim slot matrices (HLL registers, t-digest centroids) keep
    # the single scatter op: the one-hot path would unroll one
    # contraction per trailing column (thousands for a 2^p register
    # matrix), exploding trace and compile time
    return jax.ops.segment_sum(vals.astype(acc_t), gid, num_segments=n,
                               indices_are_sorted=sorted_)


def _seg_min(vals, gid, n, sorted_):
    if n <= _FEW_SEGMENTS:
        ident = _minmax_identity(vals.dtype, True)
        return jnp.stack([
            jnp.min(jnp.where(_bcast(gid == g, vals), vals, ident), axis=0)
            for g in range(n)])
    if vals.ndim == 1 and n <= onehot.SEGMENT_LIMIT:
        return onehot.seg_min(vals, gid, n,
                              _minmax_identity(vals.dtype, True))
    return jax.ops.segment_min(vals, gid, num_segments=n,
                               indices_are_sorted=sorted_)


def _seg_max(vals, gid, n, sorted_):
    if n <= _FEW_SEGMENTS:
        ident = _minmax_identity(vals.dtype, False)
        return jnp.stack([
            jnp.max(jnp.where(_bcast(gid == g, vals), vals, ident), axis=0)
            for g in range(n)])
    if vals.ndim == 1 and n <= onehot.SEGMENT_LIMIT:
        return onehot.seg_max(vals, gid, n,
                              _minmax_identity(vals.dtype, False))
    return jax.ops.segment_max(vals, gid, num_segments=n,
                               indices_are_sorted=sorted_)


def _bcast(mask, vals):
    """Broadcast a row mask against possibly multi-dim values."""
    if vals.ndim > mask.ndim:
        return mask.reshape(mask.shape + (1,) * (vals.ndim - mask.ndim))
    return mask


@dataclass
class AggResult:
    """Raw aggregate buffers; AVG/STDDEV finalized in ``finalize``."""

    slots: List[jnp.ndarray]

    def finalize(self, spec: AggSpec, group_count: Optional[jnp.ndarray]) -> MaskedCol:
        k = spec.kind
        out_dt = jnp.dtype(spec.out_type.physical_dtype())
        if k == AggKind.COUNT:
            return MaskedCol(self.slots[0].astype(out_dt))
        if k in (AggKind.SUM, AggKind.MIN, AggKind.MAX, AggKind.SAMPLE,
                 AggKind.SINGLE_VALUE):
            data, nonnull = self.slots
            return MaskedCol(data.astype(out_dt), nonnull > 0)
        if k == AggKind.AVG:
            s, c = self.slots
            avg = s.astype(jnp.float64) / jnp.where(c == 0, 1, c)
            return MaskedCol(avg.astype(out_dt), c > 0)
        if k in (AggKind.STDDEV_SAMP, AggKind.VAR_SAMP):
            s, sq, c = self.slots
            cf = c.astype(jnp.float64)
            mean = s / jnp.where(cf == 0, 1.0, cf)
            var = (sq - cf * mean * mean) / jnp.where(cf <= 1, 1.0, cf - 1.0)
            var = jnp.maximum(var, 0.0)
            out = jnp.sqrt(var) if k == AggKind.STDDEV_SAMP else var
            return MaskedCol(out.astype(out_dt), c > 1)
        if k == AggKind.COUNT_DISTINCT:
            return MaskedCol(self.slots[0].astype(out_dt))
        if k == AggKind.APPROX_COUNT_DISTINCT:
            from ..ops import sketches as sk
            return MaskedCol(sk.hll_estimate(self.slots[0]).astype(out_dt))
        if k == AggKind.QUANTILE:
            data, nonnull = self.slots
            return MaskedCol(data.astype(out_dt), nonnull > 0)
        if k == AggKind.APPROX_QUANTILE:
            from ..ops import sketches as sk
            means, weights = self.slots
            est = sk.tdigest_quantile(means, weights, float(spec.arg1))
            return MaskedCol(est.astype(out_dt),
                             jnp.sum(weights, axis=1) > 0)
        if k in (AggKind.TOP_K, AggKind.BOTTOM_K):
            vals, valid = self.slots  # (n, k) element-typed; ArrayType is
            return MaskedCol(vals, valid)  # host-side, keep device dtype
        if k == AggKind.CORR:
            # Pearson r from the 5 moment slots (reference: kCorr cells)
            sx, sy, sxy, sxx, syy, c = self.slots
            cf = c.astype(jnp.float64)
            n_ = jnp.where(cf == 0, 1.0, cf)
            cov = sxy - sx * sy / n_
            vx = sxx - sx * sx / n_
            vy = syy - sy * sy / n_
            denom = jnp.sqrt(jnp.maximum(vx * vy, 0.0))
            r = cov / jnp.where(denom == 0, 1.0, denom)
            return MaskedCol(r.astype(out_dt), (c > 1) & (denom > 0))
        raise NotImplementedError(f"aggregate {k}")


def _sum_plan(spec: AggSpec, gid, num: int, ones):
    """(columns_to_segment_sum, resolve) for pure sum-shaped aggregate
    kinds, or None for kinds that need their own reduction (MIN/MAX,
    COUNT DISTINCT, sketches...).  All returned columns from every spec
    in a group-by are summed in ONE shared one-hot contraction
    (ops/onehot.seg_sums) — per-spec contractions re-materialize the
    one-hot operands each time."""
    k = spec.kind
    v = spec.operand
    if spec.distinct and k in (AggKind.SUM, AggKind.AVG):
        first = _distinct_first_mask(v, gid, num)
        zero = jnp.zeros((), v.data.dtype)
        acc = jnp.where(first, v.fill(0), zero)
        if k == AggKind.SUM:
            return [acc, first], lambda r: AggResult([r[0], r[1]])
        return [acc, first], lambda r: AggResult(
            [r[0].astype(jnp.float64), r[1]])
    if spec.distinct:
        return None
    if k == AggKind.COUNT:
        if v is None or v.mask is None:
            return [ones], lambda r: AggResult([r[0]])
        return [v.mask], lambda r: AggResult([r[0]])
    if k in (AggKind.SUM, AggKind.AVG, AggKind.STDDEV_SAMP,
             AggKind.VAR_SAMP):
        nonnull = ones if v.mask is None else v.mask
        acc = v.fill(0)
        if k == AggKind.SUM:
            return [acc, nonnull], lambda r: AggResult([r[0], r[1]])
        if k == AggKind.AVG:
            return [acc, nonnull], lambda r: AggResult(
                [r[0].astype(jnp.float64), r[1]])
        sq = (acc.astype(_acc_dtype(v)) ** 2).astype(jnp.float64)
        return [acc, sq, nonnull], lambda r: AggResult(
            [r[0].astype(jnp.float64), r[1], r[2]])
    return None


def _seg_sum_many(cols, gid, num: int, sorted_: bool, ones_obj=None):
    """Segment-sum many columns at once: every 1-D column in the one-hot
    window shares a single contraction; the rest fall back to
    per-column ``_seg_sum`` tiering.  Duplicate column objects (shared
    ones/masks) are summed once.  ``ones_obj`` identifies the shared
    all-ones COUNT column so it rides the 2-operand count contraction
    (ops/onehot.py ones_ids)."""
    uniq: Dict[int, int] = {}
    ucols = []
    slots = []
    for c in cols:
        key = id(c)
        if key not in uniq:
            uniq[key] = len(ucols)
            ucols.append(c)
        slots.append(uniq[key])
    results: List[Optional[jnp.ndarray]] = [None] * len(ucols)
    oh = [i for i, c in enumerate(ucols)
          if c.ndim == 1 and _FEW_SEGMENTS < num <= onehot.SEGMENT_LIMIT]
    ones_pos = [j for j, i in enumerate(oh) if ucols[i] is ones_obj]
    if len(oh) >= 2 or ones_pos:
        sums = onehot.seg_sums([ucols[i] for i in oh], gid, num,
                               ones_ids=ones_pos)
        for j, i in enumerate(oh):
            results[i] = sums[j]
    for i, c in enumerate(ucols):
        if results[i] is None:
            results[i] = _seg_sum(c, gid, num, sorted_,
                                  is_ones=(c is ones_obj))
    return [results[s] for s in slots]


def _agg_slots(spec: AggSpec, gid, row_valid, n: int, sorted_: bool) -> AggResult:
    """Compute raw slot buffers for one aggregate over assigned group ids.

    ``row_valid`` masks rows that participate at all (filter fusion +
    perfect-hash out-of-range guard); rows with row_valid False must
    already map to a discard segment >= n in ``gid``.
    """
    k = spec.kind
    num = n + 1  # one discard segment at the end

    def ones_like_rows():
        # native bool width: the one-hot tier spends 1 bf16 limb on a
        # 0/1 column where an int64 pre-cast would cost 8
        return jnp.ones(gid.shape, jnp.bool_)

    if k == AggKind.COUNT and spec.operand is None:
        cnt = _seg_sum(ones_like_rows(), gid, num, sorted_,
                       is_ones=True)[:n]
        return AggResult([cnt])

    v = spec.operand
    assert v is not None, f"{k} requires an operand"
    valid = v.mask if v.mask is not None else None

    if k == AggKind.COUNT:
        ones = ones_like_rows() if valid is None else valid
        return AggResult([_seg_sum(ones, gid, num, sorted_)[:n]])

    nonnull = (ones_like_rows() if valid is None else valid)
    nonnull_per_group = _seg_sum(nonnull, gid, num, sorted_)[:n]

    if spec.distinct and k in (AggKind.SUM, AggKind.AVG):
        # SUM/AVG(DISTINCT x): dedupe (group, value) pairs, then reduce
        # the first of each run (reference: distinct agg cells)
        first = _distinct_first_mask(v, gid, num)
        zero = jnp.zeros((), v.data.dtype)
        acc = jnp.where(first, v.fill(0), zero)
        s = _seg_sum(acc, gid, num, sorted_)[:n]
        cnt = _seg_sum(first, gid, num, sorted_)[:n]
        if k == AggKind.SUM:
            return AggResult([s, cnt])
        return AggResult([s.astype(jnp.float64), cnt])

    if k in (AggKind.SUM, AggKind.AVG, AggKind.STDDEV_SAMP, AggKind.VAR_SAMP):
        acc = v.fill(0)  # native width; _seg_sum widens the accumulator
        s = _seg_sum(acc, gid, num, sorted_)[:n]
        if k == AggKind.SUM:
            return AggResult([s, nonnull_per_group])
        if k == AggKind.AVG:
            return AggResult([s.astype(jnp.float64), nonnull_per_group])
        sq = _seg_sum((acc.astype(_acc_dtype(v)) ** 2).astype(jnp.float64),
                      gid, num, sorted_)[:n]
        return AggResult([s.astype(jnp.float64), sq, nonnull_per_group])

    if k in (AggKind.MIN, AggKind.SAMPLE, AggKind.SINGLE_VALUE):
        ident = _minmax_identity(v.data.dtype, True)
        vals = v.data if valid is None else jnp.where(valid, v.data, ident)
        m = _seg_min(vals, gid, num, sorted_)[:n]
        m = jnp.where(nonnull_per_group > 0, m, ident)
        return AggResult([m, nonnull_per_group])

    if k == AggKind.MAX:
        ident = _minmax_identity(v.data.dtype, False)
        vals = v.data if valid is None else jnp.where(valid, v.data, ident)
        m = _seg_max(vals, gid, num, sorted_)[:n]
        m = jnp.where(nonnull_per_group > 0, m, ident)
        return AggResult([m, nonnull_per_group])

    if k == AggKind.COUNT_DISTINCT:
        return AggResult([_count_distinct(v, gid, n, num)])

    if k == AggKind.APPROX_COUNT_DISTINCT:
        from ..ops import sketches as sk
        p = sk.effective_hll_p(spec.hll_p, n, spec.hll_budget)
        live = gid < n if row_valid is None else ((gid < n) & row_valid)
        return AggResult([sk.hll_registers(v.data, valid, jnp.where(
            live, gid, n), n, p)])

    if k == AggKind.QUANTILE:
        q = float(spec.arg1)
        data = _group_quantile(v, gid, n, num, q, spec.interpolation)
        return AggResult([data, nonnull_per_group])

    if k == AggKind.APPROX_QUANTILE:
        from ..ops import sketches as sk
        c = sk.effective_td_c(spec.td_c, n, spec.td_budget)
        live = gid < n if row_valid is None else ((gid < n) & row_valid)
        means, weights = sk.tdigest_build(
            v.data, valid, jnp.where(live, gid, n), n, c)
        return AggResult([means, weights])

    if k == AggKind.CORR:
        return AggResult(_corr_slots(
            spec, lambda x: _seg_sum(x, gid, num, sorted_)[:n]))

    if k in (AggKind.TOP_K, AggKind.BOTTOM_K):
        return AggResult(_group_topk_unsorted(
            v, gid, n, num, int(spec.arg1), k == AggKind.TOP_K))

    raise NotImplementedError(f"aggregate {k}")


def _group_topk_unsorted(v: MaskedCol, gid, n: int, num: int, kk: int,
                         largest: bool):
    """TOP_K/BOTTOM_K via (gid, value)-sort + positional gather
    (reference: TopKRuntime.cpp per-group heaps; sort-based here)."""
    valid = v.mask
    key_g = jnp.where(valid, gid, num - 1) if valid is not None else gid
    vals64 = _orderable_int64(v.data)
    if largest:
        vals64 = ~vals64
    if valid is not None:
        vals64 = jnp.where(valid, vals64, jnp.iinfo(jnp.int64).max)
    p2 = jnp.argsort(vals64, stable=True)
    p2 = p2[jnp.argsort(key_g[p2], stable=True)]
    sv = v.data[p2]
    counts = _seg_sum((valid if valid is not None
                       else jnp.ones(gid.shape, jnp.bool_))[p2],
                      key_g[p2], num, True)
    starts_all = jnp.concatenate([
        jnp.zeros((1,), jnp.int64),
        jnp.cumsum(_seg_sum(jnp.ones(gid.shape, jnp.bool_), key_g[p2],
                            num, True))[:-1]])
    starts = starts_all[:n]
    cnt = counts[:n]
    total = sv.shape[0]
    idx = starts[:, None] + jnp.arange(kk, dtype=jnp.int64)[None, :]
    vals = sv[jnp.clip(idx, 0, max(total - 1, 0))]
    good = jnp.arange(kk, dtype=jnp.int64)[None, :] < cnt[:, None]
    return [vals, good]


def _corr_slots(spec: AggSpec, reduce_fn):
    """CORR moment slots (sum x, sum y, sum xy, sum x2, sum y2, n) over
    rows where BOTH operands are non-null."""
    x = spec.operand
    y = spec.operand2
    assert y is not None, "CORR requires two operands"
    both = combine_masks(x.mask, y.mask)
    xf = x.data.astype(jnp.float64)
    yf = y.data.astype(jnp.float64)
    if both is not None:
        xf = jnp.where(both, xf, 0.0)
        yf = jnp.where(both, yf, 0.0)
        cnt = both.astype(jnp.int64)
    else:
        cnt = jnp.ones(xf.shape, jnp.int64)
    return [reduce_fn(xf), reduce_fn(yf), reduce_fn(xf * yf),
            reduce_fn(xf * xf), reduce_fn(yf * yf), reduce_fn(cnt)]


def _distinct_first_mask(v: MaskedCol, gid, num: int) -> jnp.ndarray:
    """Per-row flag (original row order): True for the first occurrence of
    each distinct non-null (group, value) pair."""
    valid = v.mask
    key_g = jnp.where(valid, gid, num - 1) if valid is not None else gid
    vals64 = _orderable_int64(v.data)
    perm = jnp.argsort(vals64, stable=True)
    perm = perm[jnp.argsort(key_g[perm], stable=True)]
    sg = key_g[perm]
    sv = vals64[perm]
    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (sg[1:] != sg[:-1]) | (sv[1:] != sv[:-1]),
    ])
    if valid is not None:
        first = first & valid[perm]
    return jnp.zeros(gid.shape, jnp.bool_).at[perm].set(first)


def _count_distinct(v: MaskedCol, gid, n: int, num: int):
    """Exact COUNT(DISTINCT x) per group: sort (gid, x) pairs and count
    pair boundaries (reference semantics: CountDistinct.h exact bitmap /
    set; the mechanism here is sort-unique)."""
    valid = v.mask
    key_g = jnp.where(valid, gid, num - 1) if valid is not None else gid
    vals64 = _orderable_int64(v.data)
    # lexicographic (gid, value) sort
    perm = jnp.argsort(vals64, stable=True)
    perm = perm[jnp.argsort(key_g[perm], stable=True)]
    sg = key_g[perm]
    sv = vals64[perm]
    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (sg[1:] != sg[:-1]) | (sv[1:] != sv[:-1]),
    ])
    return _seg_sum(first, sg, num, True)[:n]


def _group_quantile(v: MaskedCol, gid, n: int, num: int, q: float,
                    interpolation: str):
    """Exact per-group quantile via (gid, value) sort + positional gather
    (reference: Shared/quantile.h exact path; approx tdigest maps here to
    the exact computation, which satisfies its error bound trivially)."""
    valid = v.mask
    key_g = jnp.where(valid, gid, num - 1) if valid is not None else gid
    fvals = v.data.astype(jnp.float64)
    perm = jnp.argsort(fvals, stable=True)
    perm = perm[jnp.argsort(key_g[perm], stable=True)]
    sg = key_g[perm]
    sv = fvals[perm]
    counts = _seg_sum(jnp.ones(sg.shape, jnp.bool_), sg, num, True)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int64),
                              jnp.cumsum(counts)[:-1]])
    cnt = counts[:n]
    start = starts[:n]
    pos = q * jnp.maximum(cnt - 1, 0).astype(jnp.float64)
    lo = jnp.floor(pos).astype(jnp.int64)
    hi = jnp.ceil(pos).astype(jnp.int64)
    total = sg.shape[0]
    lo_v = sv[jnp.clip(start + lo, 0, total - 1)]
    hi_v = sv[jnp.clip(start + hi, 0, total - 1)]
    if interpolation == "lower":
        return lo_v
    if interpolation == "higher":
        return hi_v
    frac = pos - lo.astype(jnp.float64)
    return lo_v + (hi_v - lo_v) * frac


def _pow2_f64(k):
    """Exact 2**k for integer k in [-1022, 1023], via IEEE bit
    assembly."""
    bits = (k.astype(jnp.int64) + 1023) << 52
    return jax.lax.bitcast_convert_type(bits, jnp.float64)


def _orderable_int64(data):
    """Map values to int64 preserving order (floats via the IEEE
    total-order trick; +/-0.0 compare equal, NaN sorts above +inf)."""
    if jnp.issubdtype(data.dtype, jnp.floating):
        if data.dtype == jnp.float32:
            b = jax.lax.bitcast_convert_type(data, jnp.int32)
            o = jnp.where(b < 0, jnp.int32(-0x80000000) - b - 1, b)
            o = jnp.where(data == 0, 0, o)  # -0.0 == +0.0
            return o.astype(jnp.int64)
        x = data.astype(jnp.float64)
        bits = jax.lax.bitcast_convert_type(x, jnp.int64)
        o = jnp.where(
            bits < 0, jnp.int64(-0x8000000000000000) - bits - 1, bits)
        o = jnp.where(x == 0, 0, o)
        nan_key = jnp.int64(0x7FF8000000000000)
        return jnp.where(jnp.isnan(x), nan_key, o)
    if data.dtype == jnp.bool_:
        return data.astype(jnp.int64)
    return data.astype(jnp.int64)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def nogroup_agg(specs: Sequence[AggSpec], nrows: int,
                row_mask: Optional[jnp.ndarray]) -> List[MaskedCol]:
    """Scalar aggregation (reference: NonGroupedAggregate layout)."""
    gid = (jnp.zeros((nrows,), jnp.int32) if row_mask is None
           else jnp.where(row_mask, 0, 1).astype(jnp.int32))
    out = []
    for spec in specs:
        res = _agg_slots(spec, gid, None, 1, False)
        col = res.finalize(spec, None)
        out.append(MaskedCol(col.data[0], col.mask[0] if col.mask is not None else None))
    return out


def perfect_gid(keys: Sequence[MaskedCol], layout: PerfectHashLayout,
                row_mask: Optional[jnp.ndarray]
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense positional group id per row; out-of-range / dead rows map
    to the discard segment ``entry_count`` (reference cross-product
    index formula off = (key - min) * stride, GroupByRuntime.cpp:199)."""
    n = layout.entry_count
    gid = jnp.zeros(keys[0].data.shape, jnp.int64)
    stride = 1
    # row-major over keys, first key outermost (docs/results.rst)
    for key, mn, size in zip(reversed(list(keys)),
                             reversed(layout.mins), reversed(layout.sizes)):
        idx = key.data.astype(jnp.int64) - mn
        if key.mask is not None:
            idx = jnp.where(key.mask, idx, size - 1)
        gid = gid + idx * stride
        stride *= size
    in_range = (gid >= 0) & (gid < n)
    if row_mask is not None:
        in_range = in_range & row_mask
    return jnp.where(in_range, gid, n).astype(jnp.int32), in_range


def perfect_key_columns_from_types(key_types: Sequence[t.Type],
                                   layout: PerfectHashLayout
                                   ) -> List[MaskedCol]:
    """Reconstruct dense-entry key columns from the layout alone (no
    evaluated key arrays needed — fragment-streamed execution builds
    keys once after all chunks merge)."""
    n = layout.entry_count
    entry = jnp.arange(n, dtype=jnp.int64)
    strides = []
    acc = 1
    for size in reversed(layout.sizes):
        strides.append(acc)
        acc *= size
    strides = list(reversed(strides))
    out: List[MaskedCol] = []
    for typ, mn, size, st in zip(key_types, layout.mins, layout.sizes,
                                 strides):
        idx = (entry // st) % size
        is_null_slot = idx == (size - 1)
        data = (idx + mn).astype(jnp.dtype(typ.physical_dtype()))
        out.append(MaskedCol(data, ~is_null_slot if typ.nullable else None))
    return out


def groupby_perfect(
    keys: Sequence[MaskedCol],
    layout: PerfectHashLayout,
    specs: Sequence[AggSpec],
    row_mask: Optional[jnp.ndarray],
) -> Tuple[List[MaskedCol], List[MaskedCol], jnp.ndarray]:
    """Dense positional group-by.

    Returns (key_columns, agg_columns, exists) where all buffers have
    ``layout.entry_count`` entries and ``exists`` marks observed groups.
    The caller compacts (reference keeps dense buffers and skips empty
    entries at iteration time — ResultSetIteration.cpp).
    """
    n = layout.entry_count
    gid, in_range = perfect_gid(keys, layout, row_mask)

    # tiering: up to onehot.SEGMENT_LIMIT entries the blocked one-hot
    # contraction (ops/onehot.py, bit-exact); beyond it the
    # E-independent sort + span sums.  Both are exact.
    if n > onehot.SEGMENT_LIMIT:
        perm = jnp.argsort(gid, stable=True).astype(jnp.int32)
        gids = gid[perm]
        grp = jnp.arange(n + 1, dtype=jnp.int32)
        bounds = jnp.searchsorted(gids, grp, side="left",
                                  method="sort").astype(jnp.int64)
        starts = bounds[:-1]
        ends = bounds[1:]
        exists = ends > starts
        agg_cols = []
        for spec in specs:
            sspec = _permute_spec(spec, perm)
            res = _agg_sorted(sspec, gids, starts, ends, n)
            agg_cols.append(res.finalize(sspec, None))
    else:
        # ONE shared contraction for exists + every sum-shaped slot
        ones = jnp.ones(gid.shape, jnp.bool_)
        batch_cols: List[jnp.ndarray] = [ones]
        plans = []
        for spec in specs:
            plan = _sum_plan(spec, gid, n + 1, ones)
            if plan is not None:
                cols_i, resolve = plan
                idxs = list(range(len(batch_cols),
                                  len(batch_cols) + len(cols_i)))
                batch_cols.extend(cols_i)
                plans.append((idxs, resolve))
            else:
                plans.append(None)
        sums = _seg_sum_many(batch_cols, gid, n + 1, False, ones_obj=ones)
        exists = sums[0][:n] > 0
        agg_cols = []
        for spec, plan in zip(specs, plans):
            if plan is None:
                res = _agg_slots(spec, gid, in_range, n, False)
            else:
                idxs, resolve = plan
                res = resolve([sums[i][:n] for i in idxs])
            agg_cols.append(res.finalize(spec, None))

    return _perfect_key_columns(keys, layout), agg_cols, exists


def _perfect_key_columns(keys: Sequence[MaskedCol],
                         layout: PerfectHashLayout) -> List[MaskedCol]:
    """Reconstruct key values from the dense entry index."""
    n = layout.entry_count
    entry = jnp.arange(n, dtype=jnp.int64)
    key_cols: List[MaskedCol] = []
    strides = []
    acc = 1
    for size in reversed(layout.sizes):
        strides.append(acc)
        acc *= size
    strides = list(reversed(strides))
    for key, mn, size, st in zip(keys, layout.mins, layout.sizes, strides):
        idx = (entry // st) % size
        is_null_slot = idx == (size - 1)
        data = (idx + mn).astype(key.data.dtype)
        nullable = key.mask is not None
        key_cols.append(MaskedCol(data, ~is_null_slot if nullable else None))
    return key_cols


def _permute_col(c: Optional[MaskedCol], perm) -> Optional[MaskedCol]:
    if c is None:
        return None
    return MaskedCol(c.data[perm],
                     c.mask[perm] if c.mask is not None else None)


def _permute_spec(spec: AggSpec, perm) -> AggSpec:
    return dataclasses.replace(spec, operand=_permute_col(spec.operand, perm),
                               operand2=_permute_col(spec.operand2, perm))


def _span_sums(x, starts, ends):
    """Per-group sums over contiguous spans of a sorted array via
    padded-cumsum difference — O(N) streaming, no scatter (replaces
    scatter-add segment reduction on sorted segments)."""
    cpad = jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)])
    return cpad[ends] - cpad[starts]


def _agg_sorted(spec: AggSpec, gid_sorted, starts, ends, n: int):
    """Aggregate slots over key-sorted rows using span arithmetic.

    ``spec.operand`` must already be permuted into sorted-row order.
    ``starts``/``ends`` are each group's row span (int64, group-indexed).
    Only MIN/MAX fall back to scatter-based segment ops (values are not
    ordered within a group); everything else is cumsum/gather work.
    """
    k = spec.kind
    counts = ends - starts
    if k == AggKind.COUNT and spec.operand is None:
        return AggResult([counts])

    v = spec.operand
    assert v is not None, f"{k} requires an operand"
    valid = v.mask

    if k == AggKind.COUNT:
        if valid is None:
            return AggResult([counts])
        return AggResult([_span_sums(valid.astype(jnp.int64), starts, ends)])

    nonnull = (counts if valid is None
               else _span_sums(valid.astype(jnp.int64), starts, ends))

    if spec.distinct and k in (AggKind.SUM, AggKind.AVG):
        # dedupe within the already-sorted group spans: one payload-
        # carrying (gid, value) sort keeps spans identical and moves the
        # accumulator along (no gathers; ops/sortops.py)
        from ..ops import sortops as so

        vals64 = _orderable_int64(v.data)
        vkey = (vals64 if valid is None
                else jnp.where(valid, vals64, jnp.iinfo(jnp.int64).max))
        pay = [v.fill(0).astype(_acc_dtype(v))]
        if valid is not None:
            pay.append(valid)
        (gb2, sv), spay = so.sort_with_payload([gid_sorted, vkey], pay)
        first = jnp.concatenate([
            jnp.ones((1,), jnp.bool_),
            (sv[1:] != sv[:-1]) | (gb2[1:] != gb2[:-1]),
        ])
        if valid is not None:
            first = first & spay[1]
        s = _span_sums(jnp.where(first, spay[0], 0), starts, ends)
        cnt = _span_sums(first.astype(jnp.int64), starts, ends)
        if k == AggKind.SUM:
            return AggResult([s, cnt])
        return AggResult([s.astype(jnp.float64), cnt])

    if k in (AggKind.SUM, AggKind.AVG, AggKind.STDDEV_SAMP, AggKind.VAR_SAMP):
        acc = v.fill(0).astype(_acc_dtype(v))
        s = _span_sums(acc, starts, ends)
        if k == AggKind.SUM:
            return AggResult([s, nonnull])
        if k == AggKind.AVG:
            return AggResult([s.astype(jnp.float64), nonnull])
        sq = _span_sums((acc * acc).astype(jnp.float64), starts, ends)
        return AggResult([s.astype(jnp.float64), sq, nonnull])

    if k in (AggKind.MIN, AggKind.MAX, AggKind.SAMPLE, AggKind.SINGLE_VALUE):
        is_min = k != AggKind.MAX
        ident = _minmax_identity(v.data.dtype, is_min)
        vals = v.data if valid is None else jnp.where(valid, v.data, ident)
        seg = _seg_min if is_min else _seg_max
        m = seg(vals, gid_sorted, n + 1, True)[:n]
        m = jnp.where(nonnull > 0, m, ident)
        return AggResult([m, nonnull])

    if k == AggKind.APPROX_COUNT_DISTINCT:
        from ..ops import sketches as sk
        p = sk.effective_hll_p(spec.hll_p, n, spec.hll_budget)
        return AggResult([sk.hll_registers(v.data, valid, gid_sorted, n, p)])

    if k == AggKind.APPROX_QUANTILE:
        from ..ops import sketches as sk
        c = sk.effective_td_c(spec.td_c, n, spec.td_budget)
        means, weights = sk.tdigest_build(v.data, valid, gid_sorted, n, c)
        return AggResult([means, weights])

    if k == AggKind.COUNT_DISTINCT:
        # one (gid, value) payload sort keeps group spans identical and
        # marks distinct-run starts (ops/sortops.py, gather-free)
        from ..ops import sortops as so

        vals64 = _orderable_int64(v.data)
        vkey = (vals64 if valid is None
                else jnp.where(valid, vals64, jnp.iinfo(jnp.int64).max))
        pay = [valid] if valid is not None else []
        (gb2, sv), spay = so.sort_with_payload([gid_sorted, vkey], pay)
        first = jnp.concatenate([
            jnp.ones((1,), jnp.bool_),
            (sv[1:] != sv[:-1]) | (gb2[1:] != gb2[:-1]),
        ])
        if valid is not None:
            first = first & spay[0]  # nulls don't count as distinct
        return AggResult([_span_sums(first.astype(jnp.int64), starts, ends)])

    if k == AggKind.CORR:
        return AggResult(_corr_slots(
            spec, lambda x: _span_sums(x, starts, ends)))

    if k in (AggKind.TOP_K, AggKind.BOTTOM_K):
        kk = int(spec.arg1)
        largest = k == AggKind.TOP_K
        vals64 = _orderable_int64(v.data)
        if largest:
            vals64 = ~vals64
        if valid is not None:
            vals64 = jnp.where(valid, vals64, jnp.iinfo(jnp.int64).max)
        p2 = jnp.argsort(vals64, stable=True)
        p2 = p2[jnp.argsort(gid_sorted[p2], stable=True)]
        sv = v.data[p2]
        total = sv.shape[0]
        idx = starts[:, None] + jnp.arange(kk, dtype=jnp.int64)[None, :]
        vals = sv[jnp.clip(idx, 0, max(total - 1, 0))]
        good = jnp.arange(kk, dtype=jnp.int64)[None, :] < nonnull[:, None]
        return AggResult([vals, good])

    if k == AggKind.QUANTILE:
        q = float(spec.arg1)
        fvals = v.data.astype(jnp.float64)
        vkey = (fvals if valid is None
                else jnp.where(valid, fvals, jnp.inf))
        p2 = jnp.argsort(vkey, stable=True)
        p2 = p2[jnp.argsort(gid_sorted[p2], stable=True)]
        sv = fvals[p2]
        total = sv.shape[0]
        cnt = nonnull  # only non-null values participate
        pos = q * jnp.maximum(cnt - 1, 0).astype(jnp.float64)
        lo = jnp.floor(pos).astype(jnp.int64)
        hi = jnp.ceil(pos).astype(jnp.int64)
        lo_v = sv[jnp.clip(starts + lo, 0, max(total - 1, 0))]
        hi_v = sv[jnp.clip(starts + hi, 0, max(total - 1, 0))]
        if spec.interpolation == "lower":
            data = lo_v
        elif spec.interpolation == "higher":
            data = hi_v
        else:
            frac = pos - lo.astype(jnp.float64)
            data = lo_v + (hi_v - lo_v) * frac
        return AggResult([data, nonnull])

    raise NotImplementedError(f"aggregate {k}")


def try_pack_keys(
    keys: Sequence[MaskedCol],
    key_ranges: Optional[Sequence[Tuple[int, int, bool]]],
) -> Optional[Tuple[jnp.ndarray, List[Tuple[int, int, int]]]]:
    """Pack multi-column keys into ONE int64 composite when ranges fit in
    62 bits (perfect-hash index formula applied to sorting): a single
    argsort replaces k stable argsorts.

    Returns (composite, layout) where layout[i] = (lo, size, stride) per
    key in original order — the inverse mapping, so group keys can be
    UNPACKED from composite values instead of gathered from the source
    columns (no row-sized random gather)."""
    if key_ranges is None or len(key_ranges) != len(keys):
        return None
    total = 1
    sizes = []
    for (lo, hi, has_nulls), key in zip(key_ranges, keys):
        size = int(hi) - int(lo) + 1 + 1  # +1 null slot
        if size <= 0:
            return None
        sizes.append(size)
        total *= size
        if total >= (1 << 62):
            return None
    composite = jnp.zeros(keys[0].data.shape, jnp.int64)
    stride = 1
    strides = []
    for key, (lo, _hi, _n), size in zip(reversed(list(keys)),
                                        reversed(list(key_ranges)),
                                        reversed(sizes)):
        idx = key.data.astype(jnp.int64) - int(lo)
        if key.mask is not None:  # nulls take the top slot => sort last
            idx = jnp.where(key.mask, idx, size - 1)
        composite = composite + idx * stride
        strides.append(stride)
        stride *= size
    strides = list(reversed(strides))
    layout = [(int(lo), size, st)
              for (lo, _hi, _n), size, st in zip(key_ranges, sizes, strides)]
    return composite, layout


def unpack_keys(comp: jnp.ndarray, keys: Sequence[MaskedCol],
                layout: List[Tuple[int, int, int]]) -> List[MaskedCol]:
    """Inverse of ``try_pack_keys`` on packed composite values."""
    out: List[MaskedCol] = []
    total = max(st * size for _lo, size, st in layout)
    for key, (lo, size, st) in zip(keys, layout):
        idx = comp // st if st != 1 else comp
        if st * size != total:  # the top key needs no mod (comp < total)
            idx = idx % size
        data = (idx + lo).astype(key.data.dtype)
        mask = (idx != size - 1) if key.mask is not None else None
        out.append(MaskedCol(data, mask))
    return out


def groupby_sort(
    keys: Sequence[MaskedCol],
    specs: Sequence[AggSpec],
    entry_cap: int,
    row_valid: Optional[jnp.ndarray] = None,
    key_ranges: Optional[Sequence[Tuple[int, int, bool]]] = None,
) -> Tuple[List[MaskedCol], List[MaskedCol], jnp.ndarray, jnp.ndarray]:
    """Sort-based baseline group-by, scatter-free on the hot path.

    Pipeline: (1) one argsort on a packed composite key when ranges
    allow, else iterated stable argsorts; (2) group ids from sorted-key
    boundaries; (3) group row-spans via vectorized binary search into the
    sorted gid array (no scatter); (4) aggregates via cumsum-difference
    span sums (see _agg_sorted).

    ``row_valid`` marks participating rows; invalid rows (filter-dead or
    shuffle padding) sort last as garbage groups excluded from
    ``n_groups``.  Returns (key_cols, agg_cols, exists, n_groups) with
    buffers sized ``entry_cap``; the first ``n_groups`` entries are real
    groups in composite/lexicographic key order.
    """
    from ..ops import sortops as so

    nrows = keys[0].data.shape[0]
    packed = try_pack_keys(keys, key_ranges)
    composite, pack_layout = packed if packed is not None else (None, None)

    # fast-tail eligibility decided UP FRONT: the fast tail never uses
    # the permutation (keys unpack from the composite; aggregates come
    # from cumsum differences), so its sort skips the iota payload —
    # 4 of ~20 bytes/row of sort traffic
    fast = (composite is not None and nrows > 0
            and all(s.kind in (AggKind.COUNT, AggKind.SUM, AggKind.AVG,
                               AggKind.STDDEV_SAMP, AggKind.VAR_SAMP)
                    and not s.distinct for s in specs))

    # ---- ONE variadic payload-carrying sort (ops/sortops.py): the
    # operand columns ride the radix passes instead of being gathered
    # through HBM afterwards (6.5x at 1e8 rows) ----------------------
    if composite is not None:
        sort_key = composite
        # a composite whose packed range fits int32 sorts on half the
        # key bytes (the 50M-NDV bench key is 26 bits)
        total_range = max(st * size for _lo, size, st in pack_layout)
        if total_range < (1 << 31) - 1:
            sort_key = sort_key.astype(jnp.int32)
            sentinel = jnp.iinfo(jnp.int32).max
        else:
            sentinel = jnp.iinfo(jnp.int64).max
        if row_valid is not None:
            sort_key = jnp.where(row_valid, sort_key, sentinel)
        skeys = [sort_key]
    else:
        skeys = []
        if row_valid is not None:  # bool key: valid rows sort first
            skeys.append(~row_valid)
        for key in keys:
            kv = _orderable_int64(key.data)
            if key.mask is not None:  # nulls group at the high end
                kv = jnp.where(key.mask, kv, jnp.iinfo(jnp.int64).max)
            skeys.append(kv)
    pay = so.PayloadSet()
    perm_slot = (None if fast
                 else pay.add(jax.lax.iota(jnp.int32, nrows)))
    spec_slots = []
    for spec in specs:
        slots = []
        for col in (spec.operand, spec.operand2):
            if col is None:
                slots.append(None)
            else:
                slots.append((pay.add(col.data), pay.add(col.mask)))
        spec_slots.append(slots)
    sorted_keys, sorted_pay = so.sort_with_payload(skeys, pay.arrays)
    perm = sorted_pay[perm_slot] if perm_slot is not None else None

    if composite is not None:
        boundary = so.changed(sorted_keys[0])
        # dead rows carry the key sentinel (strictly above any packed
        # composite), so validity is derivable from the sorted key — no
        # row_valid payload lane rides the sort
        valid_sorted = ((sorted_keys[0] != sentinel)
                        if row_valid is not None else None)
    else:
        boundary = jnp.zeros((nrows,), jnp.bool_).at[0].set(True)
        for sk in sorted_keys:
            boundary = boundary | so.changed(sk)
        valid_sorted = (~sorted_keys[0]) if row_valid is not None else None

    gid_u = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    total_b = gid_u[-1] + 1 if nrows > 0 else jnp.asarray(0, jnp.int32)
    if valid_sorted is None:
        n_groups = total_b
    else:
        # valid groups form a prefix (validity dominates the sort order)
        n_groups = jnp.max(jnp.where(valid_sorted, gid_u + 1, 0))
    gid_sorted = jnp.minimum(gid_u, entry_cap - 1)  # overflow guard
    if valid_sorted is not None:
        # dead rows -> trash segment past the cap (never pollute a group)
        gid_sorted = jnp.where(valid_sorted, gid_sorted, entry_cap)

    def slot_col(slots) -> Optional[MaskedCol]:
        if slots is None:
            return None
        di, mi = slots
        return MaskedCol(sorted_pay[di],
                         sorted_pay[mi] if mi is not None else None)

    # ---- fast tail: for span-sum-shaped aggregates over a packed
    # composite, ONE compaction sort of group-END rows replaces every
    # cap-sized gather.  boundary_spans' bool argsort + the per-spec
    # cumsum-difference gathers + the representative-row key gather are
    # each a row-sized random gather; the compaction sort carries all
    # end-row cumsums + the composite key to the front in one pass and
    # group values become adjacent-element differences. --
    if fast:
        last = jnp.concatenate([boundary[1:], jnp.ones((1,), jnp.bool_)])
        csums: List[jnp.ndarray] = [
            jax.lax.iota(jnp.int32, nrows) + jnp.int32(1)]  # row count
        plans = []
        for spec, slots in zip(specs, spec_slots):
            k = spec.kind
            v = slot_col(slots[0])
            if k == AggKind.COUNT and (v is None or v.mask is None):
                plans.append(("count", []))
                continue
            if k == AggKind.COUNT:
                idx = [len(csums)]
                csums.append(jnp.cumsum(v.mask.astype(jnp.int64)))
                plans.append(("one", idx))
                continue
            acc_t = _acc_dtype(v)
            acc = v.fill(0).astype(acc_t)
            nonnull = (None if v.mask is None
                       else jnp.cumsum(v.mask.astype(jnp.int64)))
            idx = [len(csums)]
            csums.append(jnp.cumsum(acc))
            if k in (AggKind.STDDEV_SAMP, AggKind.VAR_SAMP):
                idx.append(len(csums))
                csums.append(jnp.cumsum(
                    (acc.astype(jnp.float64) ** 2)))
            if nonnull is None:
                idx.append(0)  # share the row-count cumsum
            else:
                idx.append(len(csums))
                csums.append(nonnull)
            plans.append((k.value, idx))
        comp_ops = tuple([~last] + csums + [sorted_keys[0]])
        comp_out = jax.lax.sort(comp_ops, num_keys=1, is_stable=True)

        def take(a):
            if entry_cap <= nrows:
                return a[:entry_cap]
            return jnp.concatenate(
                [a, jnp.zeros((entry_cap - nrows,), a.dtype)])

        ends_vals = [take(a) for a in comp_out[1:]]

        def delta(a):
            return a - jnp.concatenate(
                [jnp.zeros((1,), a.dtype), a[:-1]])

        counts = delta(ends_vals[0]).astype(jnp.int64)
        agg_cols = []
        for spec, (tag, idx) in zip(specs, plans):
            k = spec.kind
            if tag == "count":
                res = AggResult([counts])
            elif tag == "one":
                res = AggResult([delta(ends_vals[idx[0]])])
            else:
                s = delta(ends_vals[idx[0]])
                nn = (counts if idx[-1] == 0
                      else delta(ends_vals[idx[-1]]))
                if k == AggKind.SUM:
                    res = AggResult([s, nn])
                elif k == AggKind.AVG:
                    res = AggResult([s.astype(jnp.float64), nn])
                else:
                    sq = delta(ends_vals[idx[1]])
                    res = AggResult([s.astype(jnp.float64), sq, nn])
            agg_cols.append(res.finalize(spec, None))
        comp_keys = ends_vals[-1]
        key_cols = unpack_keys(comp_keys, keys, pack_layout)
        exists = jnp.arange(entry_cap) < n_groups
        return key_cols, agg_cols, exists, n_groups

    # group row-spans: boundary positions via stable bool argsort (11x
    # over searchsorted at 1e8); end of group g == start of group g+1
    starts, ends = so.boundary_spans(boundary, total_b, entry_cap)

    agg_cols = []
    for spec, slots in zip(specs, spec_slots):
        sspec = dataclasses.replace(spec, operand=slot_col(slots[0]),
                                    operand2=slot_col(slots[1]))
        res = _agg_sorted(sspec, gid_sorted, starts, ends, entry_cap)
        agg_cols.append(res.finalize(sspec, None))

    # representative row per group -> key values by gather (no scatter)
    rep = perm[jnp.clip(starts, 0, max(nrows - 1, 0)).astype(jnp.int32)]
    key_cols = []
    for key in keys:
        data = key.data[rep]
        mask = key.mask[rep] if key.mask is not None else None
        key_cols.append(MaskedCol(data, mask))

    exists = jnp.arange(entry_cap) < n_groups
    return key_cols, agg_cols, exists, n_groups
