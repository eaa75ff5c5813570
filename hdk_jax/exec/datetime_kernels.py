"""Vectorized civil-calendar kernels (jnp).

The reference implements these as scalar C++ runtime functions compiled
into query modules (reference: omniscidb/QueryEngine/ExtractFromTime.cpp,
DateTruncate.cpp, DateAdd.cpp).  Here they are pure element-wise code
over integer arrays — XLA fuses them into the surrounding kernel.

Calendar math follows the standard era-based civil algorithms
(Howard Hinnant's date algorithms), matching the reference's proleptic
Gregorian semantics:
  * extract(dow):    0=Sunday..6=Saturday   (ExtractFromTime.cpp kDOW)
  * extract(isodow): 1=Monday..7=Sunday
  * week:            ISO-8601 week number
All division is floor division (jnp.floor_divide on ints is floored,
so pre-epoch dates are handled correctly).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ir.expr import DateTimeField

SECS_PER_DAY = 86400


def _fd(a, b):
    """Floored division by a positive constant, WITHOUT integer divide
    (a reciprocal multiply instead of XLA's i64 // i64 lowering).  An
    f64 reciprocal multiply is exact to +-1 for quotients
    below 2^50 (all calendar-scale magnitudes), and one fix-up step
    makes it exactly floored."""
    b = int(b)
    a = a.astype(jnp.int64)
    q = jnp.floor(a.astype(jnp.float64) * (1.0 / b)).astype(jnp.int64)
    r = a - q * b
    return q + (r >= b).astype(jnp.int64) - (r < 0).astype(jnp.int64)


def _mod(a, b):
    """a mod b (floored, b a positive constant) via _fd."""
    return a - _fd(a, b) * int(b)


def _fd32(a, b):
    """Floored division by a positive constant on DAY-scale int32
    operands: f32 reciprocal multiply + one fix-up step, so the 32-bit
    civil kernels stay in 32-bit arithmetic.  Exact while
    |a| < 2^24 — dates within ±~45,000 years, far beyond the
    reference's calendar envelope."""
    b = int(b)
    a = a.astype(jnp.int32)
    q = jnp.floor(a.astype(jnp.float32)
                  * jnp.float32(1.0 / b)).astype(jnp.int32)
    r = a - q * b
    return q + (r >= b).astype(jnp.int32) - (r < 0).astype(jnp.int32)


def _mod32(a, b):
    return a - _fd32(a, b) * int(b)


def civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day) int32, vectorized.
    All arithmetic is day-scale int32/f32 (see _fd32)."""
    z = days.astype(jnp.int32) + 719468
    era = _fd32(z, 146097)
    doe = z - era * 146097
    yoe = _fd32(doe - _fd32(doe, 1460) + _fd32(doe, 36524)
                - _fd32(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fd32(yoe, 4) - _fd32(yoe, 100))
    mp = _fd32(5 * doy + 2, 153)
    d = doy - _fd32(153 * mp + 2, 5) + 1
    m = mp + jnp.where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return y, m, d


def days_from_civil(y, m, d):
    """(year, month, day) -> days since epoch int64, vectorized."""
    y = y.astype(jnp.int32) - (m <= 2)
    m = m.astype(jnp.int32)
    d = d.astype(jnp.int32)
    era = _fd32(y, 400)
    yoe = y - era * 400
    doy = _fd32(153 * (m + jnp.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fd32(yoe, 4) - _fd32(yoe, 100) + doy
    return (era * 146097 + doe - 719468).astype(jnp.int64)


def _split(secs):
    """epoch seconds -> (days, seconds-of-day in [0, 86400))."""
    days = _fd(secs, SECS_PER_DAY)
    return days, secs - days * SECS_PER_DAY


def extract_from_seconds(field: DateTimeField, secs):
    """EXTRACT on epoch seconds (sub-second fields handled by caller)."""
    secs = secs.astype(jnp.int64)
    days, tod = _split(secs)
    if field == DateTimeField.EPOCH:
        return secs
    if field == DateTimeField.HOUR:
        return _fd(tod, 3600)
    if field == DateTimeField.MINUTE:
        return _mod(_fd(tod, 60), 60)
    if field == DateTimeField.SECOND:
        return _mod(tod, 60)
    days32 = days.astype(jnp.int32)
    if field == DateTimeField.DOW:
        return _mod32(days32 + 4, 7).astype(jnp.int64)
    if field == DateTimeField.ISODOW:
        return (_mod32(days32 + 3, 7) + 1).astype(jnp.int64)
    y, m, d = civil_from_days(days32)
    if field == DateTimeField.YEAR:
        return y.astype(jnp.int64)
    if field == DateTimeField.MONTH:
        return m.astype(jnp.int64)
    if field == DateTimeField.DAY:
        return d.astype(jnp.int64)
    if field == DateTimeField.QUARTER:
        return (_fd32(m - 1, 3) + 1).astype(jnp.int64)
    if field == DateTimeField.DOY:
        return (days - days_from_civil(y, jnp.ones_like(m),
                                       jnp.ones_like(d)) + 1)
    if field == DateTimeField.WEEK:
        # ISO week: week of the Thursday of this row's week.
        isodow = _mod32(days32 + 3, 7) + 1
        thursday = days32 + (4 - isodow)
        ty, tm, td = civil_from_days(thursday)
        jan1 = days_from_civil(ty, jnp.ones_like(tm), jnp.ones_like(td))
        return (_fd(thursday.astype(jnp.int64) - jan1, 7) + 1)
    raise NotImplementedError(f"extract field {field}")


def trunc_seconds(field: DateTimeField, secs):
    """DATE_TRUNC on epoch seconds -> epoch seconds."""
    secs = secs.astype(jnp.int64)
    days, _ = _split(secs)
    if field == DateTimeField.SECOND:
        return secs
    if field == DateTimeField.MINUTE:
        return _fd(secs, 60) * 60
    if field == DateTimeField.HOUR:
        return _fd(secs, 3600) * 3600
    if field == DateTimeField.DAY:
        return days * SECS_PER_DAY
    if field == DateTimeField.WEEK:
        return (days - _mod(days + 3, 7)) * SECS_PER_DAY
    y, m, _d = civil_from_days(days)
    one = jnp.ones_like(m)
    if field == DateTimeField.MONTH:
        return days_from_civil(y, m, one) * SECS_PER_DAY
    if field == DateTimeField.QUARTER:
        qm = (_fd(m - 1, 3) * 3) + 1
        return days_from_civil(y, qm, one) * SECS_PER_DAY
    if field == DateTimeField.YEAR:
        return days_from_civil(y, one, one) * SECS_PER_DAY
    raise NotImplementedError(f"date_trunc field {field}")


def _days_in_month(y, m):
    lengths = jnp.asarray([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                          dtype=jnp.int64)
    base = lengths[m - 1]
    leap = ((_mod(y, 4) == 0) & (_mod(y, 100) != 0)) | (_mod(y, 400) == 0)
    return jnp.where((m == 2) & leap, 29, base)


def add_months(secs, n):
    """Add n months, clamping the day to the target month's length
    (reference: DateAdd.cpp semantics: Jan 31 + 1 month = Feb 28)."""
    secs = secs.astype(jnp.int64)
    days, tod = _split(secs)
    y, m, d = civil_from_days(days)
    total = (y * 12 + (m - 1)) + n
    ny = _fd(total, 12)
    nm = total - ny * 12 + 1
    nd = jnp.minimum(d, _days_in_month(ny, nm))
    return days_from_civil(ny, nm, nd) * SECS_PER_DAY + tod


_FIELD_SECONDS = {
    DateTimeField.DAY: SECS_PER_DAY,
    DateTimeField.HOUR: 3600,
    DateTimeField.MINUTE: 60,
    DateTimeField.SECOND: 1,
    DateTimeField.WEEK: 7 * SECS_PER_DAY,
}


def date_add_seconds(field: DateTimeField, number, secs):
    if field == DateTimeField.YEAR:
        return add_months(secs, number * 12)
    if field == DateTimeField.QUARTER:
        return add_months(secs, number * 3)
    if field == DateTimeField.MONTH:
        return add_months(secs, number)
    mult = _FIELD_SECONDS.get(field)
    if mult is None:
        raise NotImplementedError(f"date_add field {field}")
    return secs.astype(jnp.int64) + number * mult


def date_diff_seconds(field: DateTimeField, start, end):
    """Whole units from start to end (reference: DateDiff semantics:
    truncating count of boundary-free units)."""
    start = start.astype(jnp.int64)
    end = end.astype(jnp.int64)
    if field in _FIELD_SECONDS:
        return _trunc_div(end - start, _FIELD_SECONDS[field])
    sy, sm, sd = civil_from_days(_fd(start, SECS_PER_DAY))
    ey, em, ed = civil_from_days(_fd(end, SECS_PER_DAY))
    months = (ey - sy) * 12 + (em - sm)
    # back off one month if the end day-of-month hasn't reached the start's
    adj = jnp.where((months > 0) & (ed < sd), -1,
                    jnp.where((months < 0) & (ed > sd), 1, 0))
    months = months + adj
    if field == DateTimeField.MONTH:
        return months
    if field == DateTimeField.QUARTER:
        return _trunc_div(months, 3)
    if field == DateTimeField.YEAR:
        return _trunc_div(months, 12)
    raise NotImplementedError(f"date_diff field {field}")


def _trunc_div(a, b):
    """C-style truncating division (toward zero) by a positive constant."""
    q = _fd(a, b)
    r = a - q * int(b)
    return q + ((r != 0) & (a < 0))
