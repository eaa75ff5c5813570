"""One-hot matrix-product segment reductions.

XLA lowers ``segment_sum``/``segment_min`` to scatter, which piles many
rows onto few accumulator cells when the segment count is small.  This
module computes the same reduction as a *factored* one-hot contraction,
a matrix product, with no scatter.

Factorization: ``gid = hi * LO + lo`` with LO = 128 (the lane width).
Per row-block, two thin one-hots A[b, HI] = (hi == ·) and
B[b, LO] = (lo == ·) contract as an outer-product histogram

    partial[hi, lo] = sum_b vals[b] * A[b, hi] * B[b, lo]

so the (B x E) one-hot never materializes — the contraction sees two
narrow operands instead.

Exactness:
  * integer values decompose into 8-bit limbs (<= 255: exact in bf16
    and in TF32, so default-precision multiplies are exact); block
    partials (<= 255 * block < 2^24) are exact in the f32 accumulator;
    limb totals recombine in int64 (chip_smoke.py checks this bit for
    bit on the device).
  * f32 values contract with ``Precision.HIGHEST`` and combine block
    partials in f64.
  * f64 values skip the matrix product (its f32 accumulator would cap
    accuracy at ~1e-6) and use a blocked select+reduce in true f64.

MIN/MAX use the blocked select+reduce over the same (blocks, B) tiling
(no factorization — extrema don't distribute over the outer product).

Rows with ``gid`` outside [0, n) (discard segment, padding) match no
one-hot column and drop out of sums; min/max select the identity.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

_BLOCK = 8192   # rows per block; int block partials <= 255 * 8192 < 2^24
_LANE = 128     # lo-side width of the factorization

# above this many segments the contraction's N*E work term hands over
# to the E-independent sort + span sums (threshold inherited from an
# earlier target, not yet re-measured: ROADMAP D2)
SEGMENT_LIMIT = 4096


def _pad_blocks(gid: jnp.ndarray, n: int,
                vals: Sequence[jnp.ndarray]) -> Tuple[jnp.ndarray, list, int]:
    """Pad rows to a multiple of _BLOCK; padding rows get gid == n
    (matches no one-hot column of the live range)."""
    nrows = gid.shape[0]
    nb = max(1, math.ceil(nrows / _BLOCK))
    padded = nb * _BLOCK
    pad = padded - nrows
    if pad:
        gid = jnp.concatenate([gid, jnp.full((pad,), n, gid.dtype)])
        vals = [jnp.concatenate([v, jnp.zeros((pad,), v.dtype)]) for v in vals]
    else:
        vals = list(vals)
    return gid.reshape(nb, _BLOCK), [v.reshape(nb, _BLOCK) for v in vals], nb


def _factor(n: int) -> Tuple[int, int]:
    """(HI, LO) with HI*LO >= n (+ a discard slot when factored).

    n <= _LANE stays flat (HI == 1, LO == n, no padding to 128).
    Larger n factors over LO = 128 with HI a power of two AND at least
    32 (thin HI contractions were slow on the target these shapes were
    tuned for; not yet re-tuned, ROADMAP D2); padding HI only wastes
    discard columns."""
    if n <= _LANE:
        return 1, n
    lo = _LANE
    hi = max(1, math.ceil((n + 1) / lo))
    hi = max(1 << (hi - 1).bit_length(), 32)
    return hi, lo


def _onehots(gid2: jnp.ndarray, n: int, dt) -> Tuple[Optional[jnp.ndarray],
                                                     jnp.ndarray]:
    """(A, B) one-hot factors; A is None in the flat (HI == 1) regime —
    out-of-range gids (discard/padding) then match no B column."""
    hi_n, lo_n = _factor(n)
    if hi_n == 1:
        B = (gid2[:, :, None]
             == jnp.arange(lo_n, dtype=gid2.dtype)[None, None, :]).astype(dt)
        return None, B
    hi = (gid2 // lo_n).astype(jnp.int32)
    lo = (gid2 % lo_n).astype(jnp.int32)
    A = (hi[:, :, None] == jnp.arange(hi_n, dtype=jnp.int32)).astype(dt)
    B = (lo[:, :, None] == jnp.arange(lo_n, dtype=jnp.int32)).astype(dt)
    return A, B


def _int_limbs(v2: jnp.ndarray) -> List[jnp.ndarray]:
    """8-bit limb decomposition; every limb is bf16-exact.  The top limb
    keeps the sign via arithmetic shift so the recombination is exact
    two's-complement."""
    if v2.dtype == jnp.bool_:
        return [v2.astype(jnp.float32)]
    bits = jnp.iinfo(v2.dtype).bits
    n_limbs = (bits + 7) // 8
    v64 = v2.astype(jnp.int64) if bits > 32 else v2.astype(jnp.int32)
    out = []
    for k in range(n_limbs):
        sh = v64 >> (8 * k)
        limb = (sh & 255) if k < n_limbs - 1 else sh
        out.append(limb.astype(jnp.float32))
    return out


def seg_sums(columns: Sequence[jnp.ndarray], gid: jnp.ndarray,
             n: int, ones_ids: Sequence[int] = ()) -> List[jnp.ndarray]:
    """Segment sums of several columns sharing one factored contraction.

    Returns one (n,) array per column: int64 for integer/bool inputs
    (bit-exact), float64 for floating inputs.

    ``ones_ids``: column indices the CALLER asserts are all-ones (COUNT
    slots).  Those never enter the slot operand — the per-gid count is
    the pure two-operand contraction A^T@B of the one-hot factors, which
    skips the 3-operand einsum entirely (XLA's contraction order for
    'nkb,nbh,nbl' can materialize a large intermediate)."""
    gid2, cols2, nb = _pad_blocks(gid, n, columns)
    hi_n, lo_n = _factor(n)
    ones_set = set(ones_ids)

    int_slots: List[jnp.ndarray] = []   # (nb, B) f32 limbs
    int_plan: List[Tuple[int, List[int]]] = []  # (col idx, limb slot ids)
    flt_slots: List[jnp.ndarray] = []
    flt_plan: List[Tuple[int, int]] = []
    f64_ids: List[int] = []
    for i, v2 in enumerate(cols2):
        if i in ones_set:
            continue  # counts come from the one-hot factors alone
        if jnp.issubdtype(v2.dtype, jnp.floating):
            if v2.dtype == jnp.float64:
                f64_ids.append(i)
            else:
                flt_plan.append((i, len(flt_slots)))
                flt_slots.append(v2.astype(jnp.float32))
        else:
            limbs = _int_limbs(v2)
            ids = list(range(len(int_slots), len(int_slots) + len(limbs)))
            int_plan.append((i, ids))
            int_slots.extend(limbs)

    out: List[Optional[jnp.ndarray]] = [None] * len(columns)
    int_stacked = jnp.stack(int_slots, axis=1) if int_slots else None
    flt_stacked = jnp.stack(flt_slots, axis=1) if flt_slots else None

    # row-chunked passes: the one-hot operands / f64 selects are bounded
    # per pass (~4M rows) so transients never scale with total rows
    nbp = max(1, (1 << 22) // _BLOCK)
    int_tot = flt_tot = cnt_tot = None
    f64_tot = {i: None for i in f64_ids}

    def add(a, b):
        return b if a is None else a + b

    for b0 in range(0, nb, nbp):
        g = gid2[b0:b0 + nbp]
        for i in f64_ids:
            hit = (g[:, :, None]
                   == jnp.arange(n, dtype=g.dtype)[None, None, :])
            sel = jnp.where(hit, cols2[i][b0:b0 + nbp][:, :, None],
                            jnp.float64(0))
            f64_tot[i] = add(f64_tot[i], jnp.sum(jnp.sum(sel, axis=1),
                                                 axis=0))
        if ones_set:
            # INT8 one-hot factors with an i32 accumulator: exact for
            # any block size
            A, B = _onehots(g, n, jnp.int8)
            if A is None:  # flat: counts = column sums of B
                part = jnp.sum(B.astype(jnp.int32), axis=1)
            else:
                part = jnp.einsum('nbh,nbl->nhl', A, B,
                                  preferred_element_type=jnp.int32)
            cnt_tot = add(cnt_tot, jnp.sum(part.astype(jnp.int64), axis=0))
        if int_stacked is not None:
            A, B = _onehots(g, n, jnp.bfloat16)
            chunk = int_stacked[b0:b0 + nbp]
            if A is None:
                part = jnp.einsum('nkb,nbl->nkl', chunk, B,
                                  preferred_element_type=jnp.float32)
            else:
                part = jnp.einsum('nkb,nbh,nbl->nkhl', chunk, A, B,
                                  preferred_element_type=jnp.float32)
            int_tot = add(int_tot, jnp.sum(part.astype(jnp.int64), axis=0))
        if flt_stacked is not None:
            A, B = _onehots(g, n, jnp.float32)
            chunk = flt_stacked[b0:b0 + nbp]
            if A is None:
                part = jnp.einsum('nkb,nbl->nkl', chunk, B,
                                  precision=jax.lax.Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)
            else:
                part = jnp.einsum('nkb,nbh,nbl->nkhl', chunk, A, B,
                                  precision=jax.lax.Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)
            flt_tot = add(flt_tot,
                          jnp.sum(part.astype(jnp.float64), axis=0))

    for i in f64_ids:
        out[i] = f64_tot[i]
    if cnt_tot is not None:
        cnt = cnt_tot.reshape(-1)[:n]
        for i in ones_set:
            out[i] = cnt
    if int_tot is not None:
        tot = int_tot.reshape(int_tot.shape[0], hi_n * lo_n)[:, :n]
        for i, ids in int_plan:
            acc = jnp.zeros((n,), jnp.int64)
            for k, sid in enumerate(ids):
                acc = acc + (tot[sid] << (8 * k))
            out[i] = acc
    if flt_tot is not None:
        tot = flt_tot.reshape(flt_tot.shape[0], hi_n * lo_n)[:, :n]
        for i, sid in flt_plan:
            out[i] = tot[sid]
    return out  # type: ignore[return-value]


def seg_sum(vals: jnp.ndarray, gid: jnp.ndarray, n: int) -> jnp.ndarray:
    """Single-column segment sum; trailing dims handled column-wise."""
    if vals.ndim == 1:
        return seg_sums([vals], gid, n)[0]
    flat = vals.reshape(vals.shape[0], -1)
    cols = seg_sums([flat[:, j] for j in range(flat.shape[1])], gid, n)
    return jnp.stack(cols, axis=1).reshape((n,) + vals.shape[1:])


def _seg_extreme(vals: jnp.ndarray, gid: jnp.ndarray, n: int,
                 ident: jnp.ndarray, is_min: bool) -> jnp.ndarray:
    if vals.ndim > 1:  # columns independently
        flat = vals.reshape(vals.shape[0], -1)
        cols = [_seg_extreme(flat[:, j], gid, n, ident, is_min)
                for j in range(flat.shape[1])]
        return jnp.stack(cols, axis=1).reshape((n,) + vals.shape[1:])
    gid2, (v2,), nb = _pad_blocks(gid, n, [vals])
    hit = gid2[:, :, None] == jnp.arange(n, dtype=gid2.dtype)[None, None, :]
    sel = jnp.where(hit, v2[:, :, None], ident)
    part = jnp.min(sel, axis=1) if is_min else jnp.max(sel, axis=1)
    return (jnp.min(part, axis=0) if is_min else jnp.max(part, axis=0))


def seg_min(vals: jnp.ndarray, gid: jnp.ndarray, n: int,
            ident: jnp.ndarray) -> jnp.ndarray:
    return _seg_extreme(vals, gid, n, ident, True)


def seg_max(vals: jnp.ndarray, gid: jnp.ndarray, n: int,
            ident: jnp.ndarray) -> jnp.ndarray:
    return _seg_extreme(vals, gid, n, ident, False)
