"""The TIMESTAMP(p), TIME(p) and TIMESTAMP(p) WITH TIME ZONE functions.

Counterpart of the date and time functions of ``trino_tpu/exec/expr.py``
(operator/scalar/DateTimeFunctions.java): fields, truncation, date_add /
date_diff, interval arithmetic, unix time, the MySQL and Joda formats,
ISO 8601, and the zones.

Lanes: TIMESTAMP and TIME are int64 milliseconds, TIMESTAMP WITH TIME ZONE
is the UTC instant with its offset minutes in ``data2``. Field, calendar
and truncation work is integer arithmetic on the device (floor division
through ``torch.div(..., rounding_mode="floor")``). Formatting and
parsing run on the host once per distinct value (``per_distinct``) or
once per dictionary value, and the results are gathered back on the
device. A zone's offsets come from its transition table over the lane's
range and one ``torch.searchsorted`` (ops/timezone.py).

A value WITH TIME ZONE carries an offset, not a zone name: date_trunc,
date_add and interval arithmetic over it keep each row's offset.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict

import numpy as np
import torch

from ..columnar import Column
from ..ops import timezone as tz
from ..ops.datetime import (add_months, civil_from_days, date_trunc_days,
                            extract_field)
from ..rex import Const
from ..types import (BIGINT, DATE, DOUBLE, IntervalYearMonth, TimestampType,
                     TimestampTZType, TimeType)
from .expr import (_DISPATCH, MS_DAY, EvalError, _codes_through,
                   _dict_transform, _div_scalar, _f64, _full, _merge_valid,
                   cast_column, const_column, days_of, eval_expr,
                   local_millis, naive_datetime, per_distinct, zone_text)

_I64 = torch.int64
_SUBDAY = {"hour": 3_600_000, "minute": 60_000, "second": 1000,
           "millisecond": 1}


def _fdiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _const_str(e, i: int, what: str) -> str:
    a = e.args[i]
    if not isinstance(a, Const) or a.value is None:
        raise EvalError(f"{what} must be a constant")
    return str(a.value)


def _zoned(t, ms: torch.Tensor, src: Column, valid) -> Column:
    """A result of type ``t`` from millis, carrying ``src``'s zone lane
    when ``t`` has one."""
    if isinstance(t, TimestampTZType):
        off = src.data2 if src.data2 is not None else torch.zeros_like(ms)
        return Column(t, ms, valid, data2=off)
    return Column(t, ms, valid)


def _on_local(src: Column, fn) -> torch.Tensor:
    """``fn`` over the wall-clock millis, returned as millis of the
    source's kind (an instant again for a zoned value)."""
    off = (src.data2 * 60_000 if isinstance(src.type, TimestampTZType)
           and src.data2 is not None else 0)
    return fn(local_millis(src)) - off


def _add_months_ms(ms: torch.Tensor, months: torch.Tensor) -> torch.Tensor:
    days = _fdiv(ms, MS_DAY)
    return add_months(days, months) * MS_DAY + (ms - days * MS_DAY)


# ---- fields ----------------------------------------------------------------

def _time_field(field: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        if isinstance(a.type, (TimestampType, TimestampTZType, TimeType)):
            ms = torch.remainder(local_millis(a), MS_DAY)
        else:
            # a DATE has no time of day
            ms = torch.zeros(a.capacity, dtype=_I64, device=a.device)
        if field == "hour":
            v = _fdiv(ms, 3_600_000)
        elif field == "minute":
            v = _fdiv(ms, 60_000) % 60
        elif field == "second":
            v = _fdiv(ms, 1000) % 60
        else:
            v = ms % 1000
        return Column(BIGINT, v, a.valid)
    return h


def _year_of_week(e, batch):
    """ISO 8601 week-year: the calendar year of the week's Thursday."""
    a = eval_expr(e.args[0], batch)
    days = days_of(a)
    thursday = days - torch.remainder(days + 3, 7) + 3
    return Column(BIGINT, extract_field(thursday, "year"), a.valid)


def _last_day_of_month(e, batch):
    a = eval_expr(e.args[0], batch)
    first = date_trunc_days(days_of(a), "month")
    last = add_months(first, torch.ones_like(first)) - 1
    return Column(DATE, last.to(torch.int32), a.valid)


def _timezone_part(which: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        off = (a.data2 if a.data2 is not None
               else torch.zeros(a.capacity, dtype=_I64, device=a.device))
        part = (torch.abs(off) // 60 if which == "hour"
                else torch.abs(off) % 60)
        return Column(BIGINT, torch.sign(off) * part, a.valid)
    return h


# ---- arithmetic -------------------------------------------------------------

def _ts_interval(op: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        iv = b.data.to(_I64)
        if op == "-":
            iv = -iv
        if e.args[1].type is IntervalYearMonth:
            ms = _on_local(a, lambda m: _add_months_ms(m, iv))
        else:
            ms = a.data.to(_I64) + iv
        return _zoned(e.type, ms, a, _merge_valid(a, b))
    return h


def _date_diff_days(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    return Column(BIGINT, a.data.to(_I64) - b.data.to(_I64),
                  _merge_valid(a, b))


def _date_trunc(e, batch):
    u = _const_str(e, 0, "date_trunc unit").lower()
    a = eval_expr(e.args[1], batch)
    if a.type is DATE:
        try:
            days = date_trunc_days(a.data, u)
        except ValueError as ex:
            raise EvalError(str(ex)) from None
        return Column(DATE, days.to(torch.int32), a.valid)
    if not isinstance(a.type, (TimestampType, TimestampTZType)):
        raise EvalError("date_trunc requires a date or timestamp")
    if u in ("year", "quarter", "month", "week", "day"):
        def trunc(ms):
            return date_trunc_days(_fdiv(ms, MS_DAY), u) * MS_DAY
    elif u in _SUBDAY:
        q = _SUBDAY[u]

        def trunc(ms):
            return _fdiv(ms, q) * q
    else:
        raise EvalError(f"unsupported date_trunc unit: {u}")
    return _zoned(a.type, _on_local(a, trunc), a, a.valid)


def _date_diff(e, batch):
    u = _const_str(e, 0, "date_diff unit").lower()
    a = eval_expr(e.args[1], batch)
    b = eval_expr(e.args[2], batch)
    valid = _merge_valid(a, b)
    if u in _SUBDAY:
        return Column(BIGINT, _fdiv(b.data.to(_I64) - a.data.to(_I64),
                                    _SUBDAY[u]), valid)
    da, db = days_of(a), days_of(b)
    if u == "day":
        return Column(BIGINT, db - da, valid)
    if u == "week":
        return Column(BIGINT, _fdiv(db - da, 7), valid)
    if u not in ("month", "quarter", "year"):
        raise EvalError(f"unsupported date_diff unit: {u}")
    ya, ma, dda = civil_from_days(da)
    yb, mb, ddb = civil_from_days(db)
    months = (yb * 12 + mb) - (ya * 12 + ma) - (ddb < dda).to(_I64)
    return Column(BIGINT, _fdiv(months, {"month": 1, "quarter": 3,
                                         "year": 12}[u]), valid)


def _date_add(e, batch):
    u = _const_str(e, 0, "date_add unit").lower()
    n = eval_expr(e.args[1], batch)
    a = eval_expr(e.args[2], batch)
    valid = _merge_valid(n, a)
    nn = n.data.to(_I64)
    months = {"month": 1, "quarter": 3, "year": 12}.get(u)
    if a.type is DATE:
        days = a.data.to(_I64)
        if u == "day":
            out = days + nn
        elif u == "week":
            out = days + nn * 7
        elif months is not None:
            out = add_months(days, nn * months)
        else:
            raise EvalError(f"date_add('{u}') on a date is not supported")
        return Column(DATE, out.to(torch.int32), valid)
    step = dict(_SUBDAY, day=MS_DAY, week=7 * MS_DAY).get(u)
    if step is not None:
        ms = a.data.to(_I64) + nn * step
    elif months is not None:
        ms = _on_local(a, lambda m: _add_months_ms(m, nn * months))
    else:
        raise EvalError(f"unsupported date_add unit: {u}")
    return _zoned(a.type, ms, a, valid)


# ---- the clock --------------------------------------------------------------

def _now_ms() -> int:
    return time.time_ns() // 1_000_000


def _current_date(e, batch):
    return Column(DATE, _full(_now_ms() // MS_DAY, batch.capacity,
                              torch.int32, batch.device), None)


def _now(e, batch):
    return Column(e.type, _full(_now_ms(), batch.capacity, _I64,
                                batch.device), None)


def _current_time(e, batch):
    return Column(e.type, _full(_now_ms() % MS_DAY, batch.capacity, _I64,
                                batch.device), None)


def _date(e, batch):
    return cast_column(eval_expr(e.args[0], batch), e.type)


# ---- unix time --------------------------------------------------------------

def _from_unixtime(e, batch):
    a = eval_expr(e.args[0], batch)
    return Column(e.type, torch.round(_f64(a) * 1000.0).to(_I64), a.valid)


def _to_unixtime(e, batch):
    a = eval_expr(e.args[0], batch)
    return Column(DOUBLE, _div_scalar(a.data.to(torch.float64), 1000.0),
                  a.valid)


# ---- formats ----------------------------------------------------------------

_MYSQL_FMT = {"Y": "%Y", "y": "%y", "m": "%m", "c": "%m", "d": "%d",
              "e": "%d", "H": "%H", "k": "%H", "h": "%I", "I": "%I",
              "i": "%M", "s": "%S", "S": "%S", "f": "%f", "p": "%p",
              "W": "%A", "a": "%a", "b": "%b", "M": "%B", "j": "%j",
              "T": "%H:%M:%S", "%": "%%"}


def _mysql_to_py_format(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            code = fmt[i + 1]
            if code not in _MYSQL_FMT:
                raise EvalError(
                    f"unsupported datetime format code '%{code}'")
            out.append(_MYSQL_FMT[code])
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


_JODA_TOKENS = [
    ("yyyy", "%Y"), ("yyy", "%Y"), ("yy", "%y"), ("y", "%Y"),
    ("MMMM", "%B"), ("MMM", "%b"), ("MM", "%m"), ("M", "%m"),
    ("dd", "%d"), ("d", "%d"), ("EEEE", "%A"), ("EEE", "%a"),
    ("HH", "%H"), ("H", "%H"), ("hh", "%I"), ("h", "%I"),
    ("mm", "%M"), ("m", "%M"), ("ss", "%S"), ("s", "%S"),
    ("SSS", "%f"), ("a", "%p"), ("ZZ", "%z"), ("Z", "%z"),
]


def _joda_to_strptime(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "'":
            j = fmt.find("'", i + 1)
            if j < 0:
                out.append(fmt[i + 1:])
                break
            out.append(fmt[i + 1:j].replace("%", "%%"))
            i = j + 1
            continue
        for tok, rep in _JODA_TOKENS:
            if fmt.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            out.append(fmt[i].replace("%", "%%"))
            i += 1
    return "".join(out)


def _wall_lanes(a: Column):
    """The lanes that fix a value's wall-clock reading: a DATE's days, a
    timestamp's millis, and a zoned value's offset."""
    if isinstance(a.type, TimestampTZType) and a.data2 is not None:
        return [a.data, a.data2]
    return [a.data]


def _wall(a: Column):
    """datetime of the wall-clock reading of one value's lanes."""
    if a.type is DATE:
        return lambda d: naive_datetime(d * MS_DAY)
    return lambda ms, off=0: naive_datetime(ms + off * 60_000)


def _date_format(e, batch):
    a = eval_expr(e.args[0], batch)
    pyfmt = _mysql_to_py_format(_const_str(e, 1, "date_format format"))
    wall = _wall(a)
    return per_distinct(_wall_lanes(a), a.valid,
                        lambda *v: wall(*v).strftime(pyfmt), e.type)


def _format_datetime(e, batch):
    a = eval_expr(e.args[0], batch)
    fmt = _joda_to_strptime(_const_str(e, 1, "format_datetime format"))
    wall = _wall(a)

    def f(*v):
        t = wall(*v)
        # Joda's SSS is milliseconds, strftime's %f microseconds: put the
        # digits into the format, where they cannot meet another code
        return t.strftime(fmt.replace("%f", f"{t.microsecond // 1000:03d}"))
    return per_distinct(_wall_lanes(a), a.valid, f, e.type)


def _to_iso8601(e, batch):
    a = eval_expr(e.args[0], batch)
    if a.type is DATE:
        def f(d):
            return naive_datetime(d * MS_DAY).date().isoformat()
    elif isinstance(a.type, TimestampTZType):
        def f(ms, off=0):
            return (naive_datetime(ms + off * 60_000)
                    .isoformat(timespec="milliseconds") + zone_text(off))
    else:
        def f(ms):
            return naive_datetime(ms).isoformat(timespec="milliseconds")
    return per_distinct(_wall_lanes(a), a.valid, f, e.type)


_EPOCH = datetime.datetime(1970, 1, 1)


def _millis(t: datetime.datetime) -> int:
    return int((t - _EPOCH).total_seconds() * 1000)


def _date_parse(e, batch):
    a = eval_expr(e.args[0], batch)
    pyfmt = _mysql_to_py_format(_const_str(e, 1, "date_parse format"))

    def parse(v: str):
        try:
            return _millis(datetime.datetime.strptime(v, pyfmt))
        except ValueError:
            return None
    return _dict_transform(a, parse, e.type)


def _zoned_from_text(a: Column, t, parse) -> Column:
    """A TIMESTAMP WITH TIME ZONE column from ``parse(text)`` -> an aware
    or naive datetime, once per dictionary value."""
    if a.dictionary is None:
        return const_column(Const(None, t), a.capacity, a.device)
    ms, offs = [], []
    for v in a.dictionary.values:
        try:
            p = parse(str(v))
        except ValueError as ex:
            raise EvalError(f"cannot parse '{v}': {ex}") from None
        off = p.utcoffset()
        offm = 0 if off is None else int(off.total_seconds() // 60)
        ms.append(_millis(p.replace(tzinfo=None)) - offm * 60_000)
        offs.append(offm)
    return Column(t, _codes_through(a, np.asarray(ms, np.int64)), a.valid,
                  data2=_codes_through(a, np.asarray(offs, np.int64)))


def _parse_datetime(e, batch):
    a = eval_expr(e.args[0], batch)
    fmt = _joda_to_strptime(_const_str(e, 1, "parse_datetime format"))
    return _zoned_from_text(
        a, e.type, lambda v: datetime.datetime.strptime(v, fmt))


def _from_iso8601_timestamp(e, batch):
    a = eval_expr(e.args[0], batch)
    return _zoned_from_text(a, e.type, lambda v: datetime.datetime
                            .fromisoformat(v.replace("Z", "+00:00")))


def _from_iso8601_date(e, batch):
    a = eval_expr(e.args[0], batch)
    d0 = datetime.date(1970, 1, 1).toordinal()

    def f(v: str):
        try:
            return datetime.date.fromisoformat(v[:10]).toordinal() - d0
        except ValueError as ex:
            raise EvalError(f"from_iso8601_date: {ex}") from None
    return _dict_transform(a, f, e.type)


# ---- zones ------------------------------------------------------------------

def _zone_arg(e, what: str) -> str:
    return _const_str(e, 1, f"{what}: the zone")


def _offsets(fn, zone: str, lane: torch.Tensor, valid) -> torch.Tensor:
    try:
        return fn(zone, lane, valid)
    except tz.UnknownZone as ex:
        raise EvalError(str(ex)) from None


def _at_timezone(e, batch):
    """AT TIME ZONE: the same instant, read in another zone (a TIMESTAMP
    is an instant read as UTC)."""
    a = eval_expr(e.args[0], batch)
    zone = _zone_arg(e, "AT TIME ZONE")
    ms = a.data.to(_I64)
    return Column(e.type, ms, a.valid,
                  data2=_offsets(tz.offsets_at, zone, ms, a.valid))


def _with_timezone(e, batch):
    """with_timezone(timestamp, zone): the wall-clock time read in that
    zone; a time in a DST gap or overlap resolves as java.time does (a
    gap moves it later, an overlap takes the earlier offset), and the
    value shows the offset in force at its instant."""
    a = eval_expr(e.args[0], batch)
    zone = _zone_arg(e, "with_timezone")
    local = a.data.to(_I64)
    instant = local - 60_000 * _offsets(tz.offsets_for_local, zone, local,
                                        a.valid)
    return Column(TimestampTZType(getattr(a.type, "precision", 3)),
                  instant, a.valid,
                  data2=_offsets(tz.offsets_at, zone, instant, a.valid))


DISPATCH: Dict[str, object] = {
    "hour": _time_field("hour"), "minute": _time_field("minute"),
    "second": _time_field("second"),
    "millisecond": _time_field("millisecond"),
    "ts_add_interval": _ts_interval("+"),
    "ts_sub_interval": _ts_interval("-"),
    "date_diff_days": _date_diff_days,
    "date_trunc": _date_trunc, "date_diff": _date_diff,
    "date_add": _date_add,
    "year_of_week": _year_of_week, "yow": _year_of_week,
    "last_day_of_month": _last_day_of_month,
    "timezone_hour": _timezone_part("hour"),
    "timezone_minute": _timezone_part("minute"),
    "current_date": _current_date, "now": _now,
    "current_timestamp": _now, "localtimestamp": _now,
    "current_time": _current_time, "localtime": _current_time,
    "date": _date,
    "from_unixtime": _from_unixtime, "to_unixtime": _to_unixtime,
    "date_format": _date_format, "date_parse": _date_parse,
    "parse_datetime": _parse_datetime,
    "format_datetime": _format_datetime,
    "from_iso8601_date": _from_iso8601_date,
    "from_iso8601_timestamp": _from_iso8601_timestamp,
    "to_iso8601": _to_iso8601,
    "at_timezone": _at_timezone, "with_timezone": _with_timezone,
}
_DISPATCH.update(DISPATCH)
