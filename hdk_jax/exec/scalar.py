"""Scalar expression evaluation: Expr -> traced jnp ops on MaskedCol.

This module replaces the reference's entire scalar codegen tier
(reference: QueryEngine/{ArithmeticIR,CompareIR,CaseIR,CastIR,ColumnIR,
ConstantIR,DateTimeIR,StringOpsIR}.cpp + CgenState): instead of emitting
LLVM IR per expression, expressions are *interpreted once at JAX trace
time*, producing a fused XLA computation.  The tracer is the code
generator.

Null semantics match the reference:
  * arithmetic/comparison propagate nulls (mask AND);
  * AND/OR use three-valued (Kleene) logic, as the reference's codegen
    does via null-aware short-circuit blocks (CompareIR.cpp logical ops);
  * IS NULL / IS NOT NULL return non-null booleans;
  * integer division truncates toward zero (C semantics, ArithmeticIR);
  * dictionary-encoded string compares run in code space; LIKE/REGEXP is
    evaluated on the host dictionary and becomes code-set membership
    (reference: StringDictionary::getLike + StringOpsIR.cpp).
"""

from __future__ import annotations

import fnmatch
import re
from typing import Callable, Dict, Optional

import jax.numpy as jnp
import numpy as np

from .. import types as t
from ..ir import expr as ir
from . import datetime_kernels as dtk
from .masked import MaskedCol, combine_masks

Resolver = Callable[[ir.ColumnRef], MaskedCol]


def _np_to_jnp_dtype(typ: t.Type):
    return jnp.dtype(typ.physical_dtype())


def _trunc_div(a, b):
    """C-style truncating integer division.  Positive-constant divisors
    take the divide-free reciprocal path (datetime_kernels._fd);
    traced divisors keep the general lowering."""
    if isinstance(b, (int, np.integer)) and int(b) > 0:
        q = dtk._fd(a, b)
        r = a - q * int(b)
        return q + ((r != 0) & (a < 0))
    q = jnp.floor_divide(a, b)
    r = a - q * b
    return q + ((r != 0) & ((a < 0) != (b < 0)))


def _unit_pow10(u_from: int, u_to: int):
    """Multiplier between two per-second unit counts."""
    return u_to // u_from if u_to >= u_from else None


def _datetime_upsec(typ: t.Type) -> int:
    """Units per second for a datetime-ish type (DAY dates are special)."""
    if typ.is_date() and typ.unit == t.TimeUnit.DAY:  # type: ignore[attr-defined]
        return -1  # marker: value is in days
    return t.unit_per_second(typ.unit)  # type: ignore[attr-defined]


def _to_seconds(data, typ: t.Type):
    """Datetime value -> (whole epoch seconds, sub-second remainder in unit,
    units-per-second)."""
    if not (typ.is_datetime() or typ.is_date() or typ.is_time()):
        # the reference types EXTRACT/DATE_TRUNC operands strictly
        # (ExtractExpr over kDATE/kTIMESTAMP); say so instead of dying
        # on a missing .unit attribute
        raise ExecError(
            f"datetime operation on non-datetime type {typ} — import the "
            "column as a timestamp (schema={...: types.timestamp(...)}) "
            "or CAST it first")
    up = _datetime_upsec(typ)
    if up == -1:
        return data.astype(jnp.int64) * dtk.SECS_PER_DAY, None, 1
    if up == 1:
        return data.astype(jnp.int64), None, 1
    secs = dtk._fd(data.astype(jnp.int64), up)
    sub = data.astype(jnp.int64) - secs * up
    return secs, sub, up


class ExecError(RuntimeError):
    pass


class ScalarCompiler:
    """Evaluates expression trees over resolved input columns."""

    def __init__(self, dicts, udfs=None) -> None:
        self.dicts = dicts  # DictionaryRegistry, for string ops
        self.udfs = udfs    # UdfRegistry (udf.py) or None

    def evaluate(self, expr: ir.Expr, resolver: Resolver,
                 row_mask=None, window_override=None) -> MaskedCol:
        """``window_override``: {id(WindowFunction expr): MaskedCol} —
        precomputed window values substituted during evaluation (the
        executor's distributed-window route computes them via an
        explicit shuffle plan, parallel/dist_window.py)."""
        cache: Dict[int, MaskedCol] = {}
        self._row_mask = row_mask  # consumed by window functions only
        self._window_override = window_override

        def ev(e: ir.Expr) -> MaskedCol:
            got = cache.get(id(e))
            if got is None:
                got = self._eval(e, ev, resolver)
                cache[id(e)] = got
            return got

        return ev(expr)

    # ------------------------------------------------------------------
    def _eval(self, e: ir.Expr, ev, resolver: Resolver) -> MaskedCol:
        if isinstance(e, ir.ColumnRef):
            return resolver(e)
        if isinstance(e, ir.Constant):
            return self._constant(e)
        if isinstance(e, ir.BinOp):
            return self._binop(e, ev)
        if isinstance(e, ir.UnOp):
            return self._unop(e, ev)
        if isinstance(e, ir.Cast):
            return self._cast(e, ev)
        if isinstance(e, ir.CaseExpr):
            return self._case(e, ev)
        if isinstance(e, ir.ExtractExpr):
            return self._extract(e, ev)
        if isinstance(e, ir.DateTruncExpr):
            return self._date_trunc(e, ev)
        if isinstance(e, ir.DateAddExpr):
            return self._date_add(e, ev)
        if isinstance(e, ir.DateDiffExpr):
            return self._date_diff(e, ev)
        if isinstance(e, ir.InValues):
            return self._in_values(e, ev)
        if isinstance(e, ir.LikeExpr):
            return self._like(e, ev)
        if isinstance(e, ir.KeyForString):
            v = ev(e.operand)
            return MaskedCol(v.data.astype(jnp.int32), v.mask)
        if isinstance(e, ir.FunctionCall):
            return self._function(e, ev)
        if isinstance(e, ir.WindowFunction):
            return self._window(e, ev)
        raise ExecError(f"cannot evaluate expression: {e.to_str()}")

    # ------------------------------------------------------------------
    def _window(self, e: ir.WindowFunction, ev) -> MaskedCol:
        from .window import compute_window

        ov = getattr(self, "_window_override", None)
        if ov is not None and id(e) in ov:
            return ov[id(e)]

        args = [ev(a) for a in e.args]
        parts = [ev(p) for p in e.partition_keys]
        orders = [ev(o) for o in e.order_keys]
        cols = args + parts + orders
        nrows = None
        for c in cols:
            if c.data.ndim > 0:
                nrows = c.data.shape[0]
                break
        if nrows is None:
            raise ExecError("window function needs at least one column input")
        return compute_window(
            e.kind, args, parts, orders, e.order_desc, e.arg1, nrows,
            getattr(self, "_row_mask", None),
            jnp.dtype(e.type.physical_dtype()), frame=e.frame)

    # ------------------------------------------------------------------
    def _function(self, e: ir.FunctionCall, ev) -> MaskedCol:
        """Scalar builtins (reference: ExtensionFunctions.hpp) and
        registered UDFs (udf.py; reference: UdfCompiler.h:30) — a UDF
        traces into the same fused XLA program as any builtin."""
        vals = [ev(a) for a in e.args]
        mask = combine_masks(*[v.mask for v in vals])
        xs = [v.data for v in vals]
        out_dt = _np_to_jnp_dtype(e.type)
        udf = self.udfs.get(e.name) if self.udfs is not None else None
        if udf is not None:
            if udf.null_propagation:
                return MaskedCol(udf.fn(*xs).astype(out_dt), mask)
            data, out_mask = udf.fn(*xs, mask)
            return MaskedCol(data.astype(out_dt), out_mask)
        if e.name == "cardinality" and e.args[0].type.is_array():
            a = vals[0]
            if a.data.ndim != 2:
                raise ExecError("CARDINALITY requires an array column")
            cnt = (jnp.sum(a.mask, axis=1).astype(jnp.int32)
                   if a.mask is not None
                   else jnp.full(a.data.shape[:1], a.data.shape[1],
                                 jnp.int32))
            return MaskedCol(cnt, None)
        if e.name == "array_at" and e.args[0].type.is_array():
            a = vals[0]
            idx = int(e.args[1].value)  # type: ignore[attr-defined]
            k = a.data.shape[1]
            if idx < 0 or idx >= k:
                z = jnp.zeros(a.data.shape[:1], a.data.dtype)
                return MaskedCol(z.astype(out_dt),
                                 jnp.zeros(a.data.shape[:1], jnp.bool_))
            m = a.mask[:, idx] if a.mask is not None else None
            return MaskedCol(a.data[:, idx].astype(out_dt), m)
        if e.name in ("lower", "upper") and e.args[0].type.is_dict_encoded_string():
            return self._string_transform(e.name, e.args[0], vals[0])
        if e.name == "char_length" and e.args[0].type.is_dict_encoded_string():
            d = self.dicts.get(e.args[0].type.dict_id)
            lens = np.asarray([len(s_) for s_ in d.all_strings()],
                              dtype=np.int32)
            if lens.size == 0:
                return MaskedCol(jnp.zeros(vals[0].data.shape, jnp.int32),
                                 mask)
            table = jnp.asarray(lens)
            codes = jnp.clip(vals[0].data.astype(jnp.int32), 0,
                             lens.size - 1)
            return MaskedCol(table[codes], mask)
        fn = _FUNCTIONS.get(e.name)
        if fn is None:
            raise ExecError(f"unknown function {e.name!r}")
        return MaskedCol(fn(*xs).astype(out_dt), mask)

    def _string_transform(self, name: str, arg: ir.Expr,
                          v: MaskedCol) -> MaskedCol:
        """LOWER/UPPER on dict codes via a host-built code->code
        translation into the SAME dictionary (reference: IR/Expr.h Lower
        + StringDictionary transient additions).  Transformed strings
        intern with get_or_add; the translation table is a trace-time
        constant keyed by the dictionary generation."""
        d = self.dicts.get(arg.type.dict_id)  # type: ignore[attr-defined]
        xf = str.lower if name == "lower" else str.upper
        mapping = np.asarray(
            [d.get_or_add(xf(s)) for s in d.all_strings()], dtype=np.int32)
        if mapping.size == 0:
            return v
        table = jnp.asarray(mapping)
        codes = jnp.clip(v.data.astype(jnp.int32), 0, mapping.size - 1)
        return MaskedCol(table[codes], v.mask)

    # ------------------------------------------------------------------
    def _constant(self, e: ir.Constant) -> MaskedCol:
        if e.value is None:
            return MaskedCol(jnp.zeros((), _np_to_jnp_dtype(e.type)),
                             jnp.zeros((), jnp.bool_))
        typ = e.type
        value = e.value
        if typ.is_dict_encoded_string() and isinstance(value, str):
            code = self.dicts.get(typ.dict_id).get_code(value)  # type: ignore[attr-defined]
            return MaskedCol(jnp.asarray(code, jnp.int32))
        if typ.is_decimal():
            value = int(round(float(value) * 10 ** typ.scale))  # type: ignore[attr-defined]
        return MaskedCol(jnp.asarray(value, _np_to_jnp_dtype(typ)))

    # ------------------------------------------------------------------
    def _binop(self, e: ir.BinOp, ev) -> MaskedCol:
        k = e.kind
        if k.is_logic():
            return self._logic(e, ev)
        a = ev(e.lhs)
        b = ev(e.rhs)
        tl, tr = e.lhs.type, e.rhs.type
        if (k.is_comparison() and tl.is_dict_encoded_string()
                and tr.is_dict_encoded_string()
                and tl.dict_id != tr.dict_id):  # type: ignore[attr-defined]
            bd, bm = self.translate_dict_codes(b.data, b.mask, tr, tl)
            # untranslatable codes (string absent from lhs dict) compare
            # unequal, not NULL
            data = self._compare(k, a.data, bd, tl, tl)
            if bm is not b.mask:
                absent = (~bm) if bm is not None else None
                if absent is not None and b.mask is not None:
                    absent = absent & b.mask
                if absent is not None:
                    neq = k == ir.BinOpKind.NE
                    data = jnp.where(absent, neq, data)
            return MaskedCol(data, combine_masks(a.mask, b.mask))
        mask = combine_masks(a.mask, b.mask)
        if k.is_comparison():
            data = self._compare(k, a.data, b.data, tl, tr)
            return MaskedCol(data, mask)
        return MaskedCol(self._arith(e, a.data, b.data), mask)

    def translate_dict_codes(self, data, mask, from_t: t.Type, to_t: t.Type):
        """Gather codes through a host-built cross-dictionary map
        (reference: StringDictionaryTranslationMgr, Execute.h:305-315)."""
        from ..storage.dictionary import NULL_CODE

        sd = self.dicts.get(from_t.dict_id)  # type: ignore[attr-defined]
        dd = self.dicts.get(to_t.dict_id)  # type: ignore[attr-defined]
        if len(sd) == 0:
            return data, mask
        tmap = jnp.asarray(sd.translate_to(dd, add_missing=False))
        out = tmap[jnp.clip(data, 0, len(sd) - 1)]
        new_mask = combine_masks(mask, out != NULL_CODE)
        return out, new_mask

    def _compare(self, k: ir.BinOpKind, x, y, tx: t.Type, ty_: t.Type):
        # datetime compare: align units first (date[day] vs timestamp[us]…)
        if tx.is_datetime() and ty_.is_datetime():
            xs, xsub, xup = _to_seconds(x, tx)
            ys, ysub, yup = _to_seconds(y, ty_)
            up = max(xup, yup)
            x = xs * up + (xsub * (up // xup) if xsub is not None else 0)
            y = ys * up + (ysub * (up // yup) if ysub is not None else 0)
        # decimal compare: rescale to common scale first
        elif tx.is_decimal() or ty_.is_decimal():
            sx = tx.scale if tx.is_decimal() else 0  # type: ignore[attr-defined]
            sy = ty_.scale if ty_.is_decimal() else 0  # type: ignore[attr-defined]
            s = max(sx, sy)
            x = x.astype(jnp.int64) * (10 ** (s - sx))
            y = y.astype(jnp.int64) * (10 ** (s - sy))
        ops = {
            ir.BinOpKind.EQ: jnp.equal, ir.BinOpKind.NE: jnp.not_equal,
            ir.BinOpKind.LT: jnp.less, ir.BinOpKind.LE: jnp.less_equal,
            ir.BinOpKind.GT: jnp.greater, ir.BinOpKind.GE: jnp.greater_equal,
        }
        return ops[k](x, y)

    def _arith(self, e: ir.BinOp, x, y):
        typ = e.type
        k = e.kind
        out_dt = _np_to_jnp_dtype(typ)
        if typ.is_decimal():
            return self._decimal_arith(e, x, y)
        if typ.is_fp():
            x = x.astype(out_dt)
            y = y.astype(out_dt)
            ops = {ir.BinOpKind.ADD: jnp.add, ir.BinOpKind.SUB: jnp.subtract,
                   ir.BinOpKind.MUL: jnp.multiply, ir.BinOpKind.DIV: jnp.divide,
                   ir.BinOpKind.MOD: jnp.fmod}
            return ops[k](x, y)
        # integer / datetime arithmetic
        x = x.astype(out_dt)
        y = y.astype(out_dt)
        if k == ir.BinOpKind.BW_AND:
            return x & y
        if k == ir.BinOpKind.BW_OR:
            return x | y
        if k == ir.BinOpKind.BW_XOR:
            return x ^ y
        if k == ir.BinOpKind.ADD:
            return x + y
        if k == ir.BinOpKind.SUB:
            return x - y
        if k == ir.BinOpKind.MUL:
            return x * y
        if k == ir.BinOpKind.DIV:
            return _trunc_div(x, jnp.where(y == 0, 1, y))
        if k == ir.BinOpKind.MOD:
            q = _trunc_div(x, jnp.where(y == 0, 1, y))
            return x - q * y
        raise ExecError(f"arith op {k}")

    def _decimal_arith(self, e: ir.BinOp, x, y):
        """Scaled-int64 decimal arithmetic (reference: ArithmeticIR.cpp
        decimal paths; scale bookkeeping as in Analyzer type analysis)."""
        so = e.type.scale  # type: ignore[attr-defined]
        sx = e.lhs.type.scale if e.lhs.type.is_decimal() else 0  # type: ignore[attr-defined]
        sy = e.rhs.type.scale if e.rhs.type.is_decimal() else 0  # type: ignore[attr-defined]
        x = x.astype(jnp.int64)
        y = y.astype(jnp.int64)
        k = e.kind
        if k in (ir.BinOpKind.ADD, ir.BinOpKind.SUB):
            xs = x * (10 ** (so - sx))
            ys = y * (10 ** (so - sy))
            return xs + ys if k == ir.BinOpKind.ADD else xs - ys
        if k == ir.BinOpKind.MUL:
            prod = x * y  # scale sx+sy
            return _trunc_div(prod, 10 ** (sx + sy - so)) if sx + sy > so else prod * (10 ** (so - sx - sy))
        if k == ir.BinOpKind.DIV:
            num = x * (10 ** (so - sx + sy))
            return _trunc_div(num, jnp.where(y == 0, 1, y))
        raise ExecError(f"decimal op {k}")

    def _logic(self, e: ir.BinOp, ev) -> MaskedCol:
        """Three-valued AND/OR: a valid FALSE dominates AND, a valid TRUE
        dominates OR, otherwise any null operand nulls the result."""
        a = ev(e.lhs)
        b = ev(e.rhs)
        x = a.data.astype(jnp.bool_)
        y = b.data.astype(jnp.bool_)
        if a.mask is None and b.mask is None:
            return MaskedCol(x & y if e.kind == ir.BinOpKind.AND else x | y)
        va = a.valid_mask()
        vb = b.valid_mask()
        if e.kind == ir.BinOpKind.AND:
            known_true = (va & x) & (vb & y)
            known_false = (va & ~x) | (vb & ~y)
        else:
            known_true = (va & x) | (vb & y)
            known_false = (va & ~x) & (vb & ~y)
        return MaskedCol(known_true, known_true | known_false)

    # ------------------------------------------------------------------
    def _unop(self, e: ir.UnOp, ev) -> MaskedCol:
        v = ev(e.operand)
        if e.kind == "bw_not":
            return MaskedCol(~v.data, v.mask)
        if e.kind == "not":
            return MaskedCol(~v.data.astype(jnp.bool_), v.mask)
        if e.kind == "neg":
            return MaskedCol(-v.data, v.mask)
        if e.kind == "isnull":
            if v.mask is None:
                return MaskedCol(jnp.zeros(v.data.shape, jnp.bool_))
            return MaskedCol(~v.mask)
        if e.kind == "isnotnull":
            if v.mask is None:
                return MaskedCol(jnp.ones(v.data.shape, jnp.bool_))
            return MaskedCol(v.mask)
        raise ExecError(f"unop {e.kind}")

    # ------------------------------------------------------------------
    def _cast(self, e: ir.Cast, ev) -> MaskedCol:
        v = ev(e.operand)
        src = e.operand.type
        dst = e.type
        data = v.data
        if src.is_decimal() and not dst.is_decimal():
            scale = 10.0 ** src.scale  # type: ignore[attr-defined]
            if dst.is_fp():
                data = data.astype(_np_to_jnp_dtype(dst)) / scale
            else:
                data = _trunc_div(data, int(scale)).astype(_np_to_jnp_dtype(dst))
            return MaskedCol(data, v.mask)
        if dst.is_decimal():
            s = dst.scale  # type: ignore[attr-defined]
            if src.is_decimal():
                ss = src.scale  # type: ignore[attr-defined]
                data = (data * 10 ** (s - ss) if s >= ss
                        else _trunc_div(data, 10 ** (ss - s)))
            elif src.is_fp():
                data = jnp.round(data * (10.0 ** s)).astype(jnp.int64)
            else:
                data = data.astype(jnp.int64) * (10 ** s)
            return MaskedCol(data, v.mask)
        if src.is_datetime() and dst.is_datetime():
            secs, sub, up = _to_seconds(data, src)
            dup = _datetime_upsec(dst)
            if dup == -1:
                out = dtk._fd(secs, dtk.SECS_PER_DAY).astype(jnp.int32)
            else:
                out = secs * dup
                if sub is not None and dup > 1:
                    out = out + _trunc_div(sub * dup, up)
            return MaskedCol(out.astype(_np_to_jnp_dtype(dst)), v.mask)
        if src.is_datetime() and dst.is_integer():
            secs, _, _ = _to_seconds(data, src)
            return MaskedCol(secs.astype(_np_to_jnp_dtype(dst)), v.mask)
        if src.is_integer() and dst.is_datetime():
            up = _datetime_upsec(dst)
            if up == -1:
                out = dtk._fd(data.astype(jnp.int64), dtk.SECS_PER_DAY)
            else:
                out = data.astype(jnp.int64) * up
            return MaskedCol(out.astype(_np_to_jnp_dtype(dst)), v.mask)
        if src.is_fp() and (dst.is_integer() or dst.is_boolean()):
            # C-style truncation toward zero (reference: CastIR.cpp fptosi)
            return MaskedCol(jnp.trunc(data).astype(_np_to_jnp_dtype(dst)), v.mask)
        if src.is_dict_encoded_string() and dst.is_dict_encoded_string():
            sd = self.dicts.get(src.dict_id)  # type: ignore[attr-defined]
            dd = self.dicts.get(dst.dict_id)  # type: ignore[attr-defined]
            if sd.dict_id == dd.dict_id:
                return v
            # host-built translation map, gathered on device (reference:
            # StringDictionaryTranslationMgr)
            tmap = jnp.asarray(sd.translate_to(dd, add_missing=False))
            data = tmap[jnp.clip(v.data, 0, len(sd) - 1)]
            from ..storage.dictionary import NULL_CODE

            mask = combine_masks(v.mask, data != NULL_CODE)
            return MaskedCol(data, mask)
        return MaskedCol(data.astype(_np_to_jnp_dtype(dst)), v.mask)

    # ------------------------------------------------------------------
    def _case(self, e: ir.CaseExpr, ev) -> MaskedCol:
        out = ev(e.else_expr)
        out_dt = _np_to_jnp_dtype(e.type)
        data = out.data.astype(out_dt)
        mask = out.mask
        # fold WHEN branches in reverse so the first match wins
        for cond_e, val_e in reversed(e.branches):
            c = ev(cond_e)
            v = ev(val_e)
            fires = c.data.astype(jnp.bool_)
            if c.mask is not None:
                fires = fires & c.mask
            data = jnp.where(fires, v.data.astype(out_dt), data)
            if v.mask is not None or mask is not None:
                vm = v.valid_mask()
                om = mask if mask is not None else jnp.ones(
                    jnp.broadcast_shapes(data.shape), jnp.bool_)
                mask = jnp.where(fires, vm, om)
        return MaskedCol(data, mask)

    # ------------------------------------------------------------------
    def _extract(self, e: ir.ExtractExpr, ev) -> MaskedCol:
        v = ev(e.operand)
        secs, sub, up = _to_seconds(v.data, e.operand.type)
        f = e.field
        if f in (ir.DateTimeField.MILLI, ir.DateTimeField.MICRO,
                 ir.DateTimeField.NANO):
            target = {ir.DateTimeField.MILLI: 1_000,
                      ir.DateTimeField.MICRO: 1_000_000,
                      ir.DateTimeField.NANO: 1_000_000_000}[f]
            within = dtk._mod(secs, 60) * target
            if sub is not None:
                within = within + (sub * target // up if target >= up
                                   else sub // (up // target))
            return MaskedCol(within, v.mask)
        if f == ir.DateTimeField.YEAR:
            fast = self._extract_year_bounded(e, secs)
            if fast is not None:
                return MaskedCol(fast, v.mask)
        return MaskedCol(dtk.extract_from_seconds(f, secs), v.mask)

    @staticmethod
    def _extract_year_bounded(e: ir.ExtractExpr, secs):
        """Stats-bounded EXTRACT(YEAR) fast path: when fragment stats
        bound the column to a <=64-year span, the year is lo_year plus
        a compare-add against each intervening Jan-1 epoch boundary —
        ~span fused element-wise compares instead of the full
        civil-calendar kernel (the reference's ExtractFromTime.cpp
        always runs full civil math).
        None = stats can't bound the span."""
        from . import ranges as _ranges

        r = _ranges._operand_epoch_seconds_range(e.operand)
        if r is None:
            return None
        import calendar
        import datetime as _dt

        lo_s, hi_s, _nulls = r
        try:
            lo_y = _dt.datetime.fromtimestamp(
                lo_s, tz=_dt.timezone.utc).year
            hi_y = _dt.datetime.fromtimestamp(
                hi_s, tz=_dt.timezone.utc).year
        except (OverflowError, OSError, ValueError):
            return None
        span = hi_y - lo_y
        if span < 0 or span > 64:
            return None
        acc = jnp.full(secs.shape, lo_y, jnp.int32)
        for y in range(lo_y + 1, hi_y + 1):
            b = calendar.timegm((y, 1, 1, 0, 0, 0))
            acc = acc + (secs >= b).astype(jnp.int32)
        return acc.astype(jnp.int64)

    def _date_trunc(self, e: ir.DateTruncExpr, ev) -> MaskedCol:
        v = ev(e.operand)
        src = e.operand.type
        secs, sub, up = _to_seconds(v.data, src)
        out_secs = dtk.trunc_seconds(e.field, secs)
        sub_fields = {ir.DateTimeField.SECOND, ir.DateTimeField.MILLI,
                      ir.DateTimeField.MICRO, ir.DateTimeField.NANO}
        dup = _datetime_upsec(e.type)
        if dup == -1:
            out = dtk._fd(out_secs, dtk.SECS_PER_DAY)
        else:
            out = out_secs * dup
            if sub is not None and e.field in sub_fields and e.field != ir.DateTimeField.SECOND:
                keep = {ir.DateTimeField.MILLI: 1_000,
                        ir.DateTimeField.MICRO: 1_000_000,
                        ir.DateTimeField.NANO: 1_000_000_000}[e.field]
                kept = (sub - dtk._mod(sub, up // keep)
                        if up > keep else sub)
                out = out + kept * (dup // up)
        return MaskedCol(out.astype(_np_to_jnp_dtype(e.type)), v.mask)

    def _date_add(self, e: ir.DateAddExpr, ev) -> MaskedCol:
        n = ev(e.number)
        v = ev(e.datetime)
        secs, sub, up = _to_seconds(v.data, e.datetime.type)
        out_secs = dtk.date_add_seconds(e.field, n.data.astype(jnp.int64), secs)
        dup = _datetime_upsec(e.type)
        if dup == -1:
            out = dtk._fd(out_secs, dtk.SECS_PER_DAY)
        else:
            out = out_secs * dup + (sub * (dup // up) if sub is not None else 0)
        mask = combine_masks(n.mask, v.mask)
        return MaskedCol(out.astype(_np_to_jnp_dtype(e.type)), mask)

    def _date_diff(self, e: ir.DateDiffExpr, ev) -> MaskedCol:
        a = ev(e.start)
        b = ev(e.end)
        sa, _, _ = _to_seconds(a.data, e.start.type)
        sb, _, _ = _to_seconds(b.data, e.end.type)
        out = dtk.date_diff_seconds(e.field, sa, sb)
        return MaskedCol(out, combine_masks(a.mask, b.mask))

    # ------------------------------------------------------------------
    def _in_values(self, e: ir.InValues, ev) -> MaskedCol:
        v = ev(e.operand)
        typ = e.operand.type
        vals = [x for x in e.values if x is not None]
        if typ.is_dict_encoded_string():
            d = self.dicts.get(typ.dict_id)  # type: ignore[attr-defined]
            codes = [d.get_code(s) for s in vals]
            arr = np.asarray([c for c in codes if c >= 0], dtype=np.int32)
        elif typ.is_decimal():
            arr = np.asarray(
                [int(round(float(x) * 10 ** typ.scale)) for x in vals],  # type: ignore[attr-defined]
                dtype=np.int64)
        else:
            arr = np.asarray(vals, dtype=typ.physical_dtype())
        if arr.size == 0:
            return MaskedCol(jnp.zeros(v.data.shape, jnp.bool_), v.mask)
        hits = jnp.isin(v.data, jnp.asarray(arr))
        return MaskedCol(hits, v.mask)

    def _like(self, e: ir.LikeExpr, ev) -> MaskedCol:
        """LIKE/REGEXP on dict codes via host dictionary scan (reference:
        StringDictionary::getLike / getRegexpLike)."""
        v = ev(e.operand)
        typ = e.operand.type
        if not typ.is_dict_encoded_string():
            raise ExecError("LIKE requires a dictionary-encoded string column")
        d = self.dicts.get(typ.dict_id)  # type: ignore[attr-defined]
        if e.is_regexp:
            rx = re.compile(e.pattern, re.IGNORECASE if e.case_insensitive else 0)
            pred = lambda s: rx.search(s) is not None
        else:
            rx = re.compile(_like_to_regex(e.pattern, e.escape),
                            re.IGNORECASE if e.case_insensitive else 0)
            pred = lambda s: rx.fullmatch(s) is not None
        matching = d.codes_matching(pred)
        if matching.size == 0:
            return MaskedCol(jnp.zeros(v.data.shape, jnp.bool_), v.mask)
        hits = jnp.isin(v.data, jnp.asarray(matching))
        return MaskedCol(hits, v.mask)


def _round_half_away(x):
    """SQL ROUND: half away from zero (numpy/jnp round is half-to-even)."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


_FUNCTIONS = {
    "abs": jnp.abs,
    "ceil": jnp.ceil,
    "ceiling": jnp.ceil,
    "floor": jnp.floor,
    "round": lambda x, *d: (_round_half_away(x * 10.0 ** d[0]) / 10.0 ** d[0]
                            if d else _round_half_away(x)),
    "truncate": lambda x, *d: (jnp.trunc(x * 10.0 ** d[0]) / 10.0 ** d[0]
                               if d else jnp.trunc(x)),
    "sign": jnp.sign,
    "sqrt": jnp.sqrt,
    "exp": jnp.exp,
    "ln": jnp.log,
    "log": jnp.log,
    "log10": jnp.log10,
    "power": jnp.power,
    "pow": jnp.power,
    "mod": lambda a, b: a - _trunc_div(a.astype(jnp.int64), b.astype(jnp.int64)) * b
    if jnp.issubdtype(a.dtype, jnp.integer) else jnp.fmod(a, b),
    "sin": jnp.sin,
    "cos": jnp.cos,
    "tan": jnp.tan,
    "asin": jnp.arcsin,
    "acos": jnp.arccos,
    "atan": jnp.arctan,
    "atan2": jnp.arctan2,
    "degrees": jnp.degrees,
    "radians": jnp.radians,
    "pi": lambda: jnp.asarray(np.pi),
    "greatest": lambda *xs: jnp.maximum(*xs) if len(xs) == 2 else jnp.max(jnp.stack(xs), 0),
    "least": lambda *xs: jnp.minimum(*xs) if len(xs) == 2 else jnp.min(jnp.stack(xs), 0),
    "width_bucket": lambda x, lo, hi, n: jnp.clip(
        jnp.floor((x - lo) / (hi - lo) * n).astype(jnp.int64) + 1, 0, n + 1),
    # reference: RuntimeFunctions.cpp:1472 sample_ratio — Knuth
    # multiplicative hash of the row offset against a 2^32 threshold
    "sample_ratio": lambda p, pos: (
        (pos.astype(jnp.int64) * 2654435761) % 4294967296
        < jnp.trunc(p * 4294967296.0).astype(jnp.int64)),
}


def _like_to_regex(pattern: str, escape: Optional[str]) -> str:
    """SQL LIKE pattern -> python regex (%, _ wildcards with escape)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)
