"""Row-expression evaluation over Batches of torch tensors.

Counterpart of ``trino_tpu/exec/expr.py``, for the subset the ported
queries reach: column references, constants, CASE and the conditionals
(coalesce, nullif, if, try, greatest, least, IS DISTINCT FROM), casts
between numbers, short decimals, dates, booleans and varchar, Kleene
AND/OR/NOT, IS NULL, comparisons (numbers, short decimals, dates,
dictionary strings), + - * / % on numbers and short decimals, the
numeric functions (abs, round, floor, ceil, truncate, sign, power, mod,
sqrt, exp, ln, the trigonometric family, ...), LIKE and the regexp
family, the string functions (lower, upper, trim, length, substring,
concat, strpos, replace, split_part, lpad, ...), date arithmetic with
day-time and year-month intervals, and the date fields (year, month,
day, quarter, ... and EXTRACT of them from a DATE). Anything else raises
``NotYetPorted("not yet ported: ...")``, an EvalError that try() lets
through.

Decimals over 18 digits (DECIMAL(p>18), among them every SQL decimal
division, which the planner types DECIMAL(38, 6)) carry a high lane
(``Column.data2``) and go through ops/int128.py: + - * / %, negation,
abs, round, comparisons, CASE and coalesce, and casts to and from
double, bigint, varchar and short decimals. A side without a high lane
sign-extends its low lane.

Strings are dictionary-coded: a string function runs on the host once
per dictionary value (``_dict_transform``) and its result table is
gathered on the device by the code lane, so per-row device work is an
integer gather whatever the function. The dictionary is host metadata in
both engines. Functions of several string columns, or of a per-row
start, materialise the rows on the host (``_row_string_fn``) and upload
the new code lane.

Every evaluation returns a Column (value lane + validity lane); AND/OR
implement the Kleene truth tables. A constant is a stride-0 view over one
element, so it costs no memory at any capacity.
"""

from __future__ import annotations

import base64
import datetime
import re
from dataclasses import replace as dc_replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..columnar import Batch, Column, StringDictionary, take_clamped, \
    torch_dtype
from ..config import capacity_for
from ..ops import hll
from ..ops import int128 as i128
from ..ops.datetime import add_months, extract_field
from ..rex import Call, CaseExpr, Cast, Const, InputRef, RowExpr
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, UNKNOWN,
                     VARCHAR, CharType, DecimalType, HyperLogLogType,
                     IntervalYearMonth, Type, is_integral, is_string)

_F64 = torch.float64
_I64 = torch.int64


class EvalError(Exception):
    pass


class NotYetPorted(EvalError):
    """An expression outside the port's slice: raised through try()."""


def eval_expr(e: RowExpr, batch: Batch) -> Column:
    if isinstance(e, InputRef):
        return batch.column(e.name)
    if isinstance(e, Const):
        return const_column(e, batch.capacity, batch.device)
    if isinstance(e, Call):
        h = _DISPATCH.get(e.fn)
        if h is None:
            raise NotYetPorted(f"not yet ported: function '{e.fn}'")
        return h(e, batch)
    if isinstance(e, Cast):
        return cast_column(eval_expr(e.arg, batch), e.type, e.safe)
    if isinstance(e, CaseExpr):
        return _eval_case(e, batch)
    raise NotYetPorted(f"not yet ported: {type(e).__name__} expressions")


def eval_predicate(e: RowExpr, batch: Batch) -> torch.Tensor:
    """Boolean mask: TRUE rows only (NULL -> excluded), ANDed with
    liveness."""
    col = eval_expr(e, batch)
    m = col.data.to(torch.bool)
    if col.valid is not None:
        m = m & col.valid
    return m & batch.row_valid()


def _full(value, cap: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    return torch.full((1,), value, dtype=dtype, device=device).expand(cap)


def const_column(e: Const, cap: int, device: torch.device) -> Column:
    t = e.type
    if e.value is None:
        invalid = _full(False, cap, torch.bool, device)
        if isinstance(t, HyperLogLogType):
            return _sketches(t, _full(0, cap, _I64, device), invalid,
                             _full(0, cap, _I64, device),
                             hll.empty_sketch_lane(device))
        if is_string(t):
            d, _ = StringDictionary.from_strings([])
            return Column(t, _full(0, cap, torch.int32, device), invalid, d)
        return Column(t, _full(0, cap, _lane_dtype(t), device), invalid)
    if is_string(t):
        d = StringDictionary(np.asarray([e.value], dtype=object))
        return Column(t, _full(0, cap, torch.int32, device), None, d)
    if isinstance(t, DecimalType):
        q = _decimal_unscaled(e.value, t.scale)
        if t.is_short:
            return Column(t, _full(q, cap, _I64, device), None)
        lo, hi = i128.split_const(q)
        return Column(t, _full(lo, cap, _I64, device), None,
                      data2=_full(hi, cap, _I64, device))
    return Column(t, _full(e.value, cap, torch_dtype(t), device), None)


def _decimal_unscaled(v, scale: int) -> int:
    """The unscaled integer of a decimal literal, exact and HALF_UP."""
    if isinstance(v, int):
        return v * 10 ** scale
    from decimal import ROUND_HALF_UP, Context, Decimal
    return int(Decimal(str(v)).scaleb(scale, Context(prec=80))
               .to_integral_value(rounding=ROUND_HALF_UP))


def _no_hi_lane(what: str, *cols: Column) -> None:
    """The functions that take no DECIMAL(p>18) operand yet."""
    for c in cols:
        if c.data2 is not None:
            raise NotYetPorted(f"not yet ported: {what} of {c.type}")


def _lanes128(c: Column):
    """(lo, hi) of a decimal column: its high lane, or the low lane
    sign-extended."""
    lo = c.data.to(_I64)
    return lo, (c.data2 if c.data2 is not None else i128.sign_extend(lo))


def _long(t: Type) -> bool:
    return isinstance(t, DecimalType) and not t.is_short


def _merge_valid(*cols: Column) -> Optional[torch.Tensor]:
    v = None
    for c in cols:
        if c.valid is not None:
            v = c.valid if v is None else (v & c.valid)
    return v


def _lane_dtype(t: Type) -> torch.dtype:
    return torch_dtype(BOOLEAN if t == UNKNOWN else t)


# ---- dictionary machinery ------------------------------------------------

def _codes_through(col: Column, table: np.ndarray) -> torch.Tensor:
    """Gather a host table by the column's code lane, on its device. An
    out-of-range code (-1 marks a literal absent from a dictionary) clamps
    into the table, as ``jnp.take(mode="clip")`` does."""
    return take_clamped(torch.from_numpy(np.asarray(table))
                        .to(col.device), col.data)


def _dict_transform(col: Column, fn: Callable[[str], object],
                    out_type: Type) -> Column:
    """Evaluate ``fn`` on the host once per dictionary value, then gather
    its result table on the device by the code lane. A None result is
    NULL."""
    out = [fn(str(v)) for v in col.dictionary.values]
    nulls = np.asarray([v is None for v in out], dtype=bool)
    valid = col.valid
    if nulls.any():
        nv = ~_codes_through(col, nulls)
        valid = nv if valid is None else valid & nv
    if is_string(out_type):
        d, codes = StringDictionary.from_strings(out)
        return Column(out_type, _codes_through(col, codes.astype(np.int32)),
                      valid, d)
    tbl = np.asarray([0 if v is None else v for v in out],
                     dtype=out_type.np_dtype)
    return Column(out_type, _codes_through(col, tbl), valid)


def _materialize_strings(col: Column) -> List:
    """The column's rows as python strings (None for NULL), on the
    host."""
    codes = col.data.cpu().numpy()
    valid = None if col.valid is None else col.valid.cpu().numpy()
    vals = col.dictionary.values
    return [None if valid is not None and not valid[i]
            else str(vals[int(codes[i])]) for i in range(len(codes))]


def _strings_column(out: List, out_type: Type,
                    device: torch.device) -> Column:
    """A string column from host rows (None is NULL), uploaded."""
    d, codes = StringDictionary.from_strings(out)
    nv = np.asarray([o is not None for o in out], dtype=bool)
    return Column(out_type, torch.from_numpy(codes).to(device),
                  None if nv.all() else torch.from_numpy(nv).to(device), d)


def _row_string_fn(cols: List[Column], fn, out_type: Type) -> Column:
    """Host row-wise evaluation for functions of several string
    columns."""
    mats = [_materialize_strings(c) for c in cols]
    out = [None if any(v is None for v in row) else fn(*row)
           for row in zip(*mats)]
    return _strings_column(out, out_type, cols[0].device)


def _align_string_codes(a: Column, b: Column):
    """Both code lanes on one merged dictionary: code equality is string
    equality."""
    if a.dictionary is b.dictionary:
        return a.data, b.data, a.dictionary
    merged, ra, rb = a.dictionary.merge(b.dictionary)
    return _codes_through(a, ra), _codes_through(b, rb), merged


def _unify(cols: List[Column], clamp_first: bool):
    """(merged dictionary, each column's codes on it)."""
    merged = cols[0].dictionary
    lanes = [_codes_through(cols[0], np.arange(len(merged), dtype=np.int32))
             if clamp_first else cols[0].data]
    for c in cols[1:]:
        merged, _, ro = merged.merge(c.dictionary)
        lanes.append(_codes_through(c, ro))
    return merged, lanes


# ---- CASE and the conditionals -------------------------------------------

def _eval_case(e: CaseExpr, batch: Batch) -> Column:
    branches = [(eval_expr(c, batch), eval_expr(v, batch))
                for c, v in e.whens]
    default = (eval_expr(e.default, batch) if e.default is not None
               else const_column(Const(None, e.type), batch.capacity,
                                 batch.device))
    vals = [v for _, v in branches] + [default]
    dictionary = hi_lanes = None
    if is_string(e.type):
        dictionary, lanes = _unify(vals, clamp_first=True)
    else:
        # every branch in the result type's dtype first: torch.where
        # would otherwise promote by its own rules
        dt = _lane_dtype(e.type)
        lanes = [v.data.to(dt) for v in vals]
        if _long(e.type):
            hi_lanes = [_lanes128(v)[1] for v in vals]
    data = lanes[-1]
    hi = hi_lanes[-1] if hi_lanes else None
    valid = default.valid_mask()
    taken = torch.zeros(batch.capacity, dtype=torch.bool,
                        device=batch.device)
    for i, (cond, val) in enumerate(branches):
        c_true = cond.data.to(torch.bool)
        if cond.valid is not None:
            c_true = c_true & cond.valid
        sel = c_true & ~taken
        data = torch.where(sel, lanes[i], data)
        if hi is not None:
            hi = torch.where(sel, hi_lanes[i], hi)
        valid = torch.where(sel, val.valid_mask(), valid)
        taken = taken | c_true
    return Column(e.type, data, valid, dictionary, hi)


def _coalesce(e, batch):
    cols = [eval_expr(a, batch) for a in e.args]
    dictionary = hi_lanes = None
    if is_string(e.type):
        dictionary, lanes = _unify(cols, clamp_first=False)
    else:
        dt = _lane_dtype(e.type)
        lanes = [c.data.to(dt) for c in cols]
        if _long(e.type):
            hi_lanes = [_lanes128(c)[1] for c in cols]
    data = lanes[-1]
    hi = hi_lanes[-1] if hi_lanes else None
    valid = cols[-1].valid_mask()
    for i in range(len(cols) - 2, -1, -1):
        v = cols[i].valid_mask()
        data = torch.where(v, lanes[i], data)
        if hi is not None:
            hi = torch.where(v, hi_lanes[i], hi)
        valid = v | valid
    return Column(e.type, data, valid, dictionary, hi)


def _nullif(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    eq = _equal(a, b)
    both = _merge_valid(a, b)
    if both is not None:
        eq = eq & both
    return dc_replace(a, valid=a.valid_mask() & ~eq)


def _if(e, batch):
    return _eval_case(CaseExpr(((e.args[0], e.args[1]),), e.args[2],
                               e.type), batch)


def _try(e, batch):
    try:
        return eval_expr(e.args[0], batch)
    except NotYetPorted:
        raise
    except EvalError:
        return const_column(Const(None, e.type), batch.capacity,
                            batch.device)


def _greatest_least(which):
    def h(e, batch):
        cols = [eval_expr(a, batch) for a in e.args]
        _no_hi_lane(which, *cols)
        if is_string(e.type):
            raise NotYetPorted(f"not yet ported: {which} over varchar")
        pick = torch.maximum if which == "greatest" else torch.minimum
        dt = _lane_dtype(e.type)
        data = cols[0].data.to(dt)
        for c in cols[1:]:
            data = pick(data, c.data.to(dt))
        return Column(e.type, data, _merge_valid(*cols))
    return h


def _is_distinct_from(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    live = batch.row_valid()
    av = live if a.valid is None else a.valid & live
    bv = live if b.valid is None else b.valid & live
    data = (av != bv) | (av & bv & ~_equal(a, b))
    return Column(BOOLEAN, data, None)


def _equal(a: Column, b: Column) -> torch.Tensor:
    """Value equality of two columns of one type (NULLs not handled)."""
    if is_string(a.type):
        da, db, _ = _align_string_codes(a, b)
        return da == db
    if a.data2 is not None or b.data2 is not None:
        return _cmp_int128("=", a, b)
    return a.data == b.data


# ---- casts ---------------------------------------------------------------

def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    """HALF_UP to int64; out of range saturates and NaN gives 0."""
    return i128.f64_to_i64_saturating(
        torch.sign(x) * torch.floor(torch.abs(x) + 0.5))


def _div_round_half_up(x: torch.Tensor, q: int) -> torch.Tensor:
    """x / q rounded half away from zero, in integers (q > 0)."""
    ax = torch.abs(x)
    return torch.sign(x) * torch.div(ax + q // 2, q, rounding_mode="floor")


def _div_scalar(x: torch.Tensor, q: float) -> torch.Tensor:
    """A true division by a 0-d device tensor: CUDA turns a python-scalar
    divisor into a multiply by its reciprocal, which rounds 35/100 and
    others to the other neighbour."""
    return x / torch.full((), q, dtype=x.dtype, device=x.device)


def cast_column(src: Column, t: Type, safe: bool = False) -> Column:
    s = src.type
    if s == t:
        return src
    if s == UNKNOWN:
        return const_column(Const(None, t), src.capacity, src.device)
    if is_string(s) and is_string(t):
        return dc_replace(src, type=t)
    if isinstance(s, HyperLogLogType) and _stringy(t):
        return _sketch_to_wire(src, t)
    if isinstance(t, HyperLogLogType) and _stringy(s):
        return _sketch_from_wire(src, t, safe)
    if is_string(s):
        if _long(t):
            return _parse_long_decimal(src, t, safe)
        return _dict_transform(src, _parser_for(t, safe), t)
    if is_string(t):
        return _to_varchar(src, t)
    if t.np_dtype is None or s.np_dtype is None \
            or s.name.startswith("time") or t.name.startswith("time") \
            or s.name.startswith("interval") \
            or t.name.startswith("interval"):
        raise NotYetPorted(f"not yet ported: cast {s} -> {t}")
    d = src.data
    if isinstance(s, DecimalType):
        if isinstance(t, DecimalType):
            shift = t.scale - s.scale
            if shift == 0 and t.is_short == s.is_short:
                # a precision-only change keeps both lanes
                return dc_replace(src, type=t)
            if src.data2 is not None or not t.is_short:
                lo, hi = i128.rescale(*_lanes128(src), shift)
                # an in-range value fits the low lane of a short decimal
                # exactly; beyond it wraps (ops/int128.py)
                return Column(t, lo, src.valid,
                              data2=None if t.is_short else hi)
            if shift >= 0:
                return Column(t, d * 10 ** shift, src.valid)
            return Column(t, _div_round_half_up(d, 10 ** (-shift)),
                          src.valid)
        if t is BOOLEAN:
            nz = d != 0
            if src.data2 is not None:
                nz = nz | (src.data2 != 0)
            return Column(t, nz, src.valid)
        if src.data2 is not None:
            if is_integral(t):
                lo, _ = i128.rescale(*_lanes128(src), -s.scale)
                return Column(t, lo.to(torch_dtype(t)), src.valid)
            sv = _div_scalar(i128.to_double(*_lanes128(src)),
                             10.0 ** s.scale)
        else:
            sv = _div_scalar(d.to(_F64), 10.0 ** s.scale)
        if is_integral(t):
            sv = _round_half_up(sv)
        return Column(t, sv.to(torch_dtype(t)), src.valid)
    if isinstance(t, DecimalType):
        if is_integral(s) or s is BOOLEAN:
            if not t.is_short:
                lo = d.to(_I64)
                lo, hi = i128.rescale(lo, i128.sign_extend(lo), t.scale)
                return Column(t, lo, src.valid, data2=hi)
            return Column(t, d.to(_I64) * 10 ** t.scale, src.valid)
        if s is DATE:
            raise NotYetPorted(f"not yet ported: cast {s} -> {t}")
        scaled = d.to(_F64) * (10.0 ** t.scale)
        if not t.is_short:
            rounded = torch.sign(scaled) * torch.floor(
                torch.abs(scaled) + 0.5)
            lo, hi = i128.from_double(rounded)
            return Column(t, lo, src.valid, data2=hi)
        return Column(t, _round_half_up(scaled), src.valid)
    if t is DATE or s is DATE:
        raise NotYetPorted(f"not yet ported: cast {s} -> {t}")
    if t.name in ("double", "real"):
        return Column(t, d.to(torch_dtype(t)), src.valid)
    if is_integral(t):
        if s.name in ("double", "real"):
            d = _round_half_up(d.to(_F64))
        return Column(t, d.to(torch_dtype(t)), src.valid)
    if t is BOOLEAN:
        return Column(t, d.to(torch.bool), src.valid)
    raise NotYetPorted(f"not yet ported: cast {s} -> {t}")


def _stringy(t: Type) -> bool:
    return is_string(t) or t.name == "varbinary"


def _sketches(t: HyperLogLogType, starts, valid, lens,
              entries: torch.Tensor) -> Column:
    """A sketch column: offsets, validity, entry counts, flat entries."""
    return Column(t, starts, valid, None, lens, Column(INTEGER, entries))


def _sketch_to_wire(src: Column, t: Type) -> Column:
    """CAST(hll AS varbinary/varchar): the base64 of the engine's dense
    framing (ops/hll.py, shared with the result rows), as a dictionary
    column. The distinct (start, count) spans are found on the device and
    encoded once each on the host, in the order of their first row, so
    that the codes are those of a dictionary built row by row."""
    b = src.type.bucket_bits
    dev = src.device
    # a span as its readers clip it, as one key: start * (m + 1) + count
    m1 = (1 << b) + 1
    key = (src.data.to(_I64).clamp(0, src.elements.data.shape[0]) * m1
           + src.data2.to(_I64).clamp(0, m1 - 1))
    keys, inverse = torch.unique(key, return_inverse=True)
    rows = torch.arange(inverse.shape[0], device=dev)
    first = torch.full((keys.shape[0],), inverse.shape[0],
                       dtype=_I64, device=dev).scatter_reduce_(
        0, inverse, rows, "amin")
    by_first = torch.argsort(first)
    keys = keys[by_first]
    rank = torch.empty_like(by_first)
    rank[by_first] = torch.arange(by_first.shape[0], device=dev)
    starts, lens = keys // m1, keys % m1
    out = hll.sketches_to_base64(
        starts.cpu().numpy(), lens.cpu().numpy(),
        hll.entries_prefix(starts, lens, src.elements.data, b), b)
    dct, codes = StringDictionary.from_strings(out)
    return Column(t, take_clamped(torch.from_numpy(codes).to(dev),
                                  rank[inverse]), src.valid, dct)


def _sketch_from_wire(src: Column, t: HyperLogLogType,
                      safe: bool) -> Column:
    """CAST(varbinary/varchar AS hyperloglog), once per dictionary value
    on the host; under TRY_CAST a malformed value is NULL."""
    pool, bits, bad = [], [], np.zeros(len(src.dictionary.values), bool)
    for i, v in enumerate(src.dictionary.values):
        try:
            regs = hll.deserialize_registers(base64.b64decode(v))
        except (ValueError, IndexError) as ex:   # incl. binascii.Error
            if not safe:
                raise EvalError(f"cannot cast to hyperloglog: {ex}")
            pool.append(np.zeros((0,), np.int32))
            bad[i] = True
            continue
        pool.append(hll.entries_from_dense(regs))
        bits.append(int(regs.shape[0]).bit_length() - 1)
    real_b = sorted(set(bits))
    if len(real_b) > 1:
        raise EvalError("cannot cast a column mixing HyperLogLog "
                        f"precisions (bucket bits {real_b})")
    lens = np.asarray([p.shape[0] for p in pool], np.int64)
    offs = np.cumsum(lens) - lens
    flat = np.concatenate(pool) if pool else np.zeros((0,), np.int32)
    flat = np.pad(flat, (0, capacity_for(max(flat.shape[0], 1))
                         - flat.shape[0]))
    dev = src.device
    codes = src.data
    valid = src.valid
    if bad.any():
        ok = take_clamped(torch.from_numpy(~bad).to(dev), codes)
        valid = ok if valid is None else valid & ok
    if real_b:
        t = HyperLogLogType(real_b[0])
    return _sketches(t, take_clamped(torch.from_numpy(offs).to(dev), codes),
                     valid,
                     take_clamped(torch.from_numpy(lens).to(dev), codes),
                     torch.from_numpy(flat).to(dev))


def _parser_for(t: Type, safe: bool):
    """varchar -> t for one dictionary value."""
    if not (t is DATE or is_integral(t) or t.name in ("double", "real")
            or t is BOOLEAN or isinstance(t, DecimalType)):
        raise NotYetPorted(f"not yet ported: cast varchar -> {t}")

    def parse(v: str):
        try:
            if t is DATE:
                d = datetime.date.fromisoformat(v.strip())
                return d.toordinal() - datetime.date(1970, 1, 1).toordinal()
            if is_integral(t):
                return int(v.strip())
            if t.name in ("double", "real"):
                return float(v)
            if t is BOOLEAN:
                return v.strip().lower() in ("true", "t", "1")
            from decimal import Decimal
            return int(Decimal(v.strip()).scaleb(t.scale)
                       .to_integral_value())
        except (ValueError, ArithmeticError):
            if safe:
                return None
            raise EvalError(f"Cannot cast '{v}' to {t}") from None
    return parse


def _parse_long_decimal(col: Column, t: DecimalType, safe: bool) -> Column:
    """varchar -> DECIMAL(p>18): parse each dictionary value on the host
    into its 128-bit unscaled value, then gather the (lo, hi) tables by
    the code lane."""
    from decimal import (ROUND_HALF_UP, Context, Decimal,
                         InvalidOperation)
    ctx = Context(prec=80)
    los, his, nulls = [], [], []
    for v in col.dictionary.values:
        try:
            q = int(Decimal(str(v).strip()).scaleb(t.scale, ctx)
                    .to_integral_value(rounding=ROUND_HALF_UP))
            lo, hi = i128.split_const(q)
            nulls.append(False)
        except (InvalidOperation, ValueError, OverflowError):
            if not safe:
                raise EvalError(f"Cannot cast '{v}' to {t}") from None
            lo = hi = 0
            nulls.append(True)
        los.append(lo)
        his.append(hi)
    valid = col.valid
    nulls = np.asarray(nulls, dtype=bool)
    if nulls.any():
        nv = ~_codes_through(col, nulls)
        valid = nv if valid is None else valid & nv
    return Column(t, _codes_through(col, np.asarray(los, np.int64)), valid,
                  data2=_codes_through(col, np.asarray(his, np.int64)))


def _to_varchar(src: Column, t: Type) -> Column:
    """number, decimal, date or boolean -> varchar, row by row on the
    host."""
    s = src.type
    data = src.data.cpu().numpy()
    valid = None if src.valid is None else src.valid.cpu().numpy()
    hi = None if src.data2 is None else src.data2.cpu().numpy()
    epoch = datetime.date(1970, 1, 1).toordinal()
    if s is DATE:
        def fmt(v):
            return str(datetime.date.fromordinal(int(v) + epoch))
    elif isinstance(s, DecimalType):
        def fmt(v, h=None):
            q = int(v) if h is None else i128.combine_host(int(v), int(h))
            if not s.scale:
                return str(q)
            sign = "-" if q < 0 else ""
            q = abs(q)
            return (f"{sign}{q // 10 ** s.scale}."
                    f"{q % 10 ** s.scale:0{s.scale}d}")
    elif s is BOOLEAN:
        def fmt(v):
            return "true" if v else "false"
    elif s.name in ("double", "real"):
        def fmt(v):
            return repr(float(v))
    elif is_integral(s):
        def fmt(v):
            return str(int(v))
    else:
        raise NotYetPorted(f"not yet ported: cast {s} -> {t}")
    out = [None if valid is not None and not valid[i]
           else fmt(data[i]) if hi is None else fmt(data[i], hi[i])
           for i in range(len(data))]
    return _strings_column(out, t, src.device)


# ---- boolean logic (Kleene) ----------------------------------------------

def _bool_parts(c: Column):
    d = c.data.to(torch.bool)
    v = torch.ones_like(d) if c.valid is None else c.valid
    return d, v


def _and(e, batch):
    a, b = (eval_expr(x, batch) for x in e.args)
    ad, av = _bool_parts(a)
    bd, bv = _bool_parts(b)
    # NULL unless either side is definite FALSE
    valid = (av & bv) | (av & ~ad) | (bv & ~bd)
    return Column(BOOLEAN, ad & bd & valid, valid)


def _or(e, batch):
    a, b = (eval_expr(x, batch) for x in e.args)
    ad, av = _bool_parts(a)
    bd, bv = _bool_parts(b)
    true_a = av & ad
    true_b = bv & bd
    return Column(BOOLEAN, true_a | true_b, (av & bv) | true_a | true_b)


def _not(e, batch):
    a = eval_expr(e.args[0], batch)
    return Column(BOOLEAN, ~a.data.to(torch.bool), a.valid)


def _is_null(e, batch):
    a = eval_expr(e.args[0], batch)
    if a.valid is None:
        return Column(BOOLEAN, torch.zeros(batch.capacity, dtype=torch.bool,
                                           device=batch.device))
    return Column(BOOLEAN, ~a.valid & batch.row_valid())


# ---- comparisons ---------------------------------------------------------

def _cmp_lanes(op, da, db):
    if op == "=":
        return da == db
    if op == "<>":
        return da != db
    if op == "<":
        return da < db
    if op == "<=":
        return da <= db
    if op == ">":
        return da > db
    return da >= db


def _cmp(op: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        valid = _merge_valid(a, b)
        if is_string(a.type):
            # both sides move into one merged dictionary; order compares
            # collation ranks, equality compares codes
            merged, ma, mb = a.dictionary.merge(b.dictionary)
            if op not in ("=", "<>"):
                ranks = merged.rank_codes()
                ma, mb = ranks[ma], ranks[mb]
            data = _cmp_lanes(op, _codes_through(a, ma),
                              _codes_through(b, mb))
        elif a.data2 is not None or b.data2 is not None:
            data = _cmp_int128(op, a, b)
        else:
            # the planner casts decimals of different scales to one type
            # before comparing, so decimals compare unscaled lanes
            data = _cmp_lanes(op, a.data, b.data)
        return Column(BOOLEAN, data, valid)
    return h


def _cmp_int128(op: str, a: Column, b: Column) -> torch.Tensor:
    """Two's-complement 128-bit comparison: signed on the high lane,
    unsigned on the low (sign-bit flip); a side without a high lane
    sign-extends."""
    alo, ahi = _lanes128(a)
    blo, bhi = _lanes128(b)
    if op in ("=", "<>"):
        eq = i128.eq128(alo, ahi, blo, bhi)
        return eq if op == "=" else ~eq
    if op in ("<", ">="):
        lt = i128.lt128(alo, ahi, blo, bhi)
        return lt if op == "<" else ~lt
    gt = i128.lt128(blo, bhi, alo, ahi)
    return gt if op == ">" else ~gt


# ---- arithmetic ----------------------------------------------------------

def _arith(op: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        out_dtype = torch_dtype(e.type)
        da, db = a.data.to(out_dtype), b.data.to(out_dtype)
        if op == "+":
            data = da + db
        elif op == "-":
            data = da - db
        elif op == "*":
            data = da * db
        elif op == "/":
            if is_integral(e.type):
                # truncating division; a zero divisor yields 0 here (the
                # JAX engine's convention) instead of raising
                q = torch.abs(da) // torch.clamp(torch.abs(db), min=1)
                data = torch.sign(da) * torch.sign(db) * q
            else:
                data = da / db
        else:
            if is_integral(e.type):
                m = torch.abs(da) % torch.clamp(torch.abs(db), min=1)
                data = torch.sign(da) * m
            else:
                data = torch.where(db != 0, torch.fmod(da, db),
                                   torch.full_like(da, float("nan")))
        return Column(e.type, data.to(out_dtype), _merge_valid(a, b))
    return h


def _negate(e, batch):
    a = eval_expr(e.args[0], batch)
    if a.data2 is not None:
        lo, hi = i128.neg128(*_lanes128(a))
        return dc_replace(a, data=lo, data2=hi, type=e.type)
    return dc_replace(a, data=-a.data, type=e.type)


def _decimal_arith(op: str):
    """Short-decimal arithmetic on unscaled int64 lanes: + and - rescale
    both sides to the result scale; * rescales the product HALF_UP; /
    divides in doubles and rounds HALF_UP at the result scale; % is the
    remainder of the unscaled lanes (0 for a zero divisor). A long
    operand or result takes the exact Int128 path."""
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        t = e.type
        if a.data2 is not None or b.data2 is not None or not t.is_short:
            return _decimal_arith_128(op, a, b, t)
        sa = a.type.scale if isinstance(a.type, DecimalType) else 0
        sb = b.type.scale if isinstance(b.type, DecimalType) else 0
        da = a.data.to(_I64)
        db = b.data.to(_I64)
        if op in ("+", "-"):
            da = da * 10 ** (t.scale - sa)
            db = db * 10 ** (t.scale - sb)
            data = da + db if op == "+" else da - db
        elif op == "*":
            data = da * db
            shift = sa + sb - t.scale
            if shift > 0:
                data = _div_round_half_up(data, 10 ** shift)
        elif op == "/":
            # result scale ts: (a / b) * 10^ts = a * 10^(ts - sa + sb) / b
            shift = t.scale - sa + sb
            num = da * 10 ** max(shift, 0)
            den = torch.where(db == 0, torch.ones_like(db), db)
            q = num.to(_F64) / den.to(_F64)
            if shift < 0:
                q = _div_scalar(q, 10.0 ** (-shift))
            data = _round_half_up(q)
        else:
            den = torch.where(db == 0, torch.ones_like(db), db)
            data = torch.where(db != 0, torch.remainder(da, den),
                               torch.zeros_like(da))
        return Column(t, data, _merge_valid(a, b))
    return h


def _decimal_arith_128(op: str, a: Column, b: Column,
                       t: DecimalType) -> Column:
    """Exact Int128 decimal arithmetic over (lo, hi) lanes, HALF_UP
    rescaling; / and % by zero give NULL."""
    sa = a.type.scale if isinstance(a.type, DecimalType) else 0
    sb = b.type.scale if isinstance(b.type, DecimalType) else 0
    valid = _merge_valid(a, b)
    alo, ahi = _lanes128(a)
    blo, bhi = _lanes128(b)
    if op in ("+", "-"):
        alo, ahi = i128.rescale(alo, ahi, t.scale - sa)
        blo, bhi = i128.rescale(blo, bhi, t.scale - sb)
        lo, hi = (i128.add128(alo, ahi, blo, bhi) if op == "+"
                  else i128.sub128(alo, ahi, blo, bhi))
    elif op == "*":
        lo, hi = i128.mul128(alo, ahi, blo, bhi)
        lo, hi = i128.rescale(lo, hi, t.scale - sa - sb)
    else:
        if op == "/":
            # (a / b) at scale ts: round(a * 10^(ts - sa + sb) / b)
            shift = t.scale - sa + sb
            alo, ahi = i128.rescale(alo, ahi, max(shift, 0))
            blo, bhi = i128.rescale(blo, bhi, max(-shift, 0))
        else:
            # % : both operands at the result scale first
            alo, ahi = i128.rescale(alo, ahi, t.scale - sa)
            blo, bhi = i128.rescale(blo, bhi, t.scale - sb)
        zero = (blo == 0) & (bhi == 0)
        blo = torch.where(zero, torch.ones_like(blo), blo)
        if op == "/":
            lo, hi = i128.div128_round_half_up_pair(alo, ahi, blo, bhi)
        else:
            _, _, lo, hi = i128.divmod128_trunc(alo, ahi, blo, bhi)
        valid = ~zero if valid is None else valid & ~zero
    return Column(t, lo, valid, data2=None if t.is_short else hi)


# ---- numeric functions ---------------------------------------------------

def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): |x|^(1/3) with its sign, then one
    Newton step."""
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    ok = (y != 0) & torch.isfinite(y)
    step = (y * y * y - x) / torch.where(ok, 3.0 * y * y,
                                         torch.ones_like(y))
    return torch.where(ok, y - step, y)


def _unary_np(fn):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        return Column(e.type, fn(a.data.to(_F64)).to(torch_dtype(e.type)),
                      a.valid)
    return h


def _abs(e, batch):
    a = eval_expr(e.args[0], batch)
    if a.data2 is not None:
        lo, hi = i128.abs128(*_lanes128(a))
        return dc_replace(a, data=lo, data2=hi)
    return dc_replace(a, data=torch.abs(a.data))


def _literal_digits(e) -> int:
    if len(e.args) < 2:
        return 0
    arg1 = e.args[1]
    if not isinstance(arg1, Const) or arg1.value is None:
        raise EvalError("round(decimal, n) requires a literal n")
    return int(arg1.value)


def _round(e, batch):
    a = eval_expr(e.args[0], batch)
    t = a.type
    if isinstance(t, DecimalType):
        # digits must be a constant for a static result scale
        n = _literal_digits(e)
        d = a.data.to(_I64)
        if n >= t.scale:
            return a
        if a.data2 is not None:
            if t.scale - n > 38:
                # 10^(scale - n) exceeds 128 bits: every value rounds to 0
                z = torch.zeros_like(d)
                return Column(t, z, a.valid, data2=z)
            lo, hi = i128.rescale(*_lanes128(a), -(t.scale - n))
            lo, hi = i128.rescale(lo, hi, t.scale - n)
            return Column(t, lo, a.valid, data2=hi)
        if t.scale - n > 18:
            return Column(t, torch.zeros_like(d), a.valid)
        div = 10 ** (t.scale - n)
        return Column(t, _div_round_half_up(d, div) * div, a.valid)
    if is_integral(t):
        return a
    d = a.data.to(_F64)
    if len(e.args) == 2:
        arg1 = e.args[1]
        if isinstance(arg1, Const) and arg1.value is not None:
            scale = torch.full((), 10.0 ** int(arg1.value), dtype=_F64,
                               device=d.device)
        else:
            digits = eval_expr(arg1, batch).data.to(_I64).to(_F64)
            scale = torch.pow(torch.full((), 10.0, dtype=_F64,
                                         device=d.device), digits)
    else:
        scale = torch.ones((), dtype=_F64, device=d.device)
    data = torch.sign(d) * torch.floor(torch.abs(d) * scale + 0.5) / scale
    return Column(t, data.to(torch_dtype(t)), a.valid)


def _floorceil(which):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        t = a.type
        if is_integral(t):
            return a
        _no_hi_lane(which, a)
        d = a.data.to(_F64)
        data = torch.floor(d) if which == "floor" else torch.ceil(d)
        return Column(t, data.to(torch_dtype(t)), a.valid)
    return h


def _truncate(e, batch):
    a = eval_expr(e.args[0], batch)
    _no_hi_lane("truncate", a)
    data = torch.trunc(a.data.to(_F64))
    if is_integral(a.type):
        # a BIGINT near 2^63 rounds to 2^63 as a double
        data = i128.f64_to_i64_saturating(data)
    return Column(a.type, data.to(torch_dtype(a.type)), a.valid)


def _sign(e, batch):
    a = eval_expr(e.args[0], batch)
    _no_hi_lane("sign", a)
    return Column(a.type, torch.sign(a.data).to(torch_dtype(a.type)),
                  a.valid)


def _power(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    return Column(DOUBLE, torch.pow(a.data.to(_F64), b.data.to(_F64)),
                  _merge_valid(a, b))


def _float_pred(fn):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        return Column(BOOLEAN, fn(a.data.to(_F64)), a.valid)
    return h


# ---- LIKE and regular expressions ----------------------------------------

def like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
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


def _const_arg(e, i: int, what: str):
    if not isinstance(e.args[i], Const):
        raise EvalError(f"{what} must be constant")
    return e.args[i].value


def _like(e, batch):
    a = eval_expr(e.args[0], batch)
    pat = _const_arg(e, 1, "LIKE pattern")
    esc = _const_arg(e, 2, "LIKE escape") if len(e.args) > 2 else None
    rx = re.compile(like_to_regex(str(pat), esc), re.DOTALL)
    return _dict_transform(a, lambda v: rx.fullmatch(v) is not None,
                           BOOLEAN)


def _regexp_pattern(e):
    return re.compile(str(_const_arg(e, 1, "regexp pattern")))


def _regexp_like(e, batch):
    a = eval_expr(e.args[0], batch)
    rx = _regexp_pattern(e)
    return _dict_transform(a, lambda v: rx.search(v) is not None, BOOLEAN)


def _regexp_extract(e, batch):
    a = eval_expr(e.args[0], batch)
    pat = _regexp_pattern(e)
    group = (int(_const_arg(e, 2, "regexp_extract: group"))
             if len(e.args) > 2 else 0)

    def g(v: str):
        m = pat.search(v)
        return None if m is None else m.group(group)
    return _dict_transform(a, g, e.type)


def _regexp_replace(e, batch):
    a = eval_expr(e.args[0], batch)
    pat = _regexp_pattern(e)
    repl = ""
    if len(e.args) > 2:
        # Java replacement syntax: $1 / ${name} -> Python \1 / \g<name>
        repl = re.sub(r"\$\{(\w+)\}", r"\\g<\1>",
                      re.sub(r"\$(\d+)", r"\\\1",
                             _const_arg(e, 2, "regexp_replace: "
                                              "replacement")))
    return _dict_transform(a, lambda v: pat.sub(repl, v), e.type)


# ---- string functions ----------------------------------------------------

def _string_unary(fn):
    def h(e, batch):
        return _dict_transform(eval_expr(e.args[0], batch), fn, e.type)
    return h


def _length(e, batch):
    a = eval_expr(e.args[0], batch)
    if isinstance(a.type, CharType):
        return _dict_transform(a, lambda v: a.type.length, BIGINT)
    return _dict_transform(a, len, BIGINT)


def _substr(e, batch):
    a = eval_expr(e.args[0], batch)
    if all(isinstance(x, Const) for x in e.args[1:]):
        start = int(e.args[1].value)
        ln = int(e.args[2].value) if len(e.args) > 2 else None

        def f(v: str):
            i = start - 1 if start > 0 else len(v) + start
            return v[i:] if ln is None else v[i:i + ln]
        return _dict_transform(a, f, e.type)
    # a per-row start or length: host rows
    rest = [eval_expr(x, batch) for x in e.args[1:]]
    starts = rest[0].data.cpu().numpy()
    lens = rest[1].data.cpu().numpy() if len(rest) > 1 else None
    out = []
    for i, v in enumerate(_materialize_strings(a)):
        if v is None:
            out.append(None)
            continue
        st = int(starts[i])
        j = st - 1 if st > 0 else len(v) + st
        out.append(v[j:] if lens is None else v[j:j + int(lens[i])])
    return _strings_column(out, e.type, a.device)


def _concat(e, batch):
    dyn = [i for i, a in enumerate(e.args) if not isinstance(a, Const)]
    if not dyn:
        return const_column(Const("".join(str(a.value) for a in e.args),
                                  VARCHAR), batch.capacity, batch.device)
    if len(dyn) == 1:
        # one dynamic column: a dictionary transform with constant parts
        i = dyn[0]
        pre = "".join(str(a.value) for a in e.args[:i])
        post = "".join(str(a.value) for a in e.args[i + 1:])
        return _dict_transform(eval_expr(e.args[i], batch),
                               lambda v: pre + v + post, e.type)
    cols = [eval_expr(a, batch) for a in e.args]
    return _row_string_fn(cols, lambda *vs: "".join(vs), e.type)


def _strpos(e, batch):
    a = eval_expr(e.args[0], batch)
    needle = str(_const_arg(e, 1, "strpos needle"))
    return _dict_transform(a, lambda v: v.find(needle) + 1, BIGINT)


def _replace(e, batch):
    a = eval_expr(e.args[0], batch)
    if not all(isinstance(x, Const) for x in e.args[1:]):
        raise EvalError("replace search/replacement must be constant")
    search = str(e.args[1].value)
    repl = str(e.args[2].value) if len(e.args) > 2 else ""
    return _dict_transform(a, lambda v: v.replace(search, repl), e.type)


def _starts_with(e, batch):
    a = eval_expr(e.args[0], batch)
    p = str(_const_arg(e, 1, "starts_with prefix"))
    return _dict_transform(a, lambda v: v.startswith(p), BOOLEAN)


def _split_part(e, batch):
    a = eval_expr(e.args[0], batch)
    if not all(isinstance(x, Const) for x in e.args[1:]):
        raise EvalError("split_part arguments must be constant")
    delim = str(e.args[1].value)
    idx = int(e.args[2].value)

    def f(v: str):
        parts = v.split(delim)
        return parts[idx - 1] if 1 <= idx <= len(parts) else None
    return _dict_transform(a, f, e.type)


def _pad(which):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        size = int(e.args[1].value)
        fill = str(e.args[2].value) if len(e.args) > 2 else " "

        def f(v: str):
            if len(v) >= size:
                return v[:size]
            n = size - len(v)
            p = (fill * n)[:n]
            return p + v if which == "lpad" else v + p
        return _dict_transform(a, f, e.type)
    return h


# ---- dates ---------------------------------------------------------------

def _date_interval(op: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        days = a.data.to(_I64)
        iv = b.data.to(_I64)
        if op == "-":
            iv = -iv
        if e.args[1].type is IntervalYearMonth:
            data = add_months(days, iv)
        else:
            data = days + torch.div(iv, 86400000, rounding_mode="floor")
        return Column(DATE, data.to(torch.int32), _merge_valid(a, b))
    return h


def _extract(field: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        if a.type is not DATE:
            raise NotYetPorted(f"not yet ported: {field}() of {a.type}")
        return Column(BIGINT, extract_field(a.data, field), a.valid)
    return h


# ---- HyperLogLog -----------------------------------------------------------

def _cardinality(e, batch):
    """cardinality(hll): the HLL estimate of each row's sketch."""
    a = eval_expr(e.args[0], batch)
    if not isinstance(a.type, HyperLogLogType):
        raise NotYetPorted(f"not yet ported: cardinality of {a.type}")
    est = hll.estimate_from_sparse(a.data, a.data2, a.elements.data,
                                   a.type.bucket_bits)
    return Column(BIGINT, est, a.valid)


def _empty_approx_set(e, batch):
    """A sketch with no entries on every row, with approx_set's default
    bucket count, so that it merges with approx_set(x) sketches."""
    cap, dev = batch.capacity, batch.device
    return _sketches(HyperLogLogType(hll.APPROX_SET_BUCKET_BITS),
                     torch.zeros(cap, dtype=_I64, device=dev), None,
                     torch.zeros(cap, dtype=_I64, device=dev),
                     hll.empty_sketch_lane(dev))


_DISPATCH: Dict[str, Callable] = {
    "and": _and, "or": _or, "not": _not, "is_null": _is_null,
    "is_distinct_from": _is_distinct_from,
    "=": _cmp("="), "<>": _cmp("<>"), "<": _cmp("<"), "<=": _cmp("<="),
    ">": _cmp(">"), ">=": _cmp(">="),
    "+": _arith("+"), "-": _arith("-"), "*": _arith("*"),
    "/": _arith("/"), "%": _arith("%"),
    "decimal_+": _decimal_arith("+"), "decimal_-": _decimal_arith("-"),
    "decimal_*": _decimal_arith("*"), "decimal_/": _decimal_arith("/"),
    "decimal_%": _decimal_arith("%"),
    "negate": _negate, "abs": _abs, "round": _round,
    "floor": _floorceil("floor"), "ceil": _floorceil("ceil"),
    "ceiling": _floorceil("ceil"), "truncate": _truncate, "sign": _sign,
    "sqrt": _unary_np(torch.sqrt), "cbrt": _unary_np(_cbrt),
    "exp": _unary_np(torch.exp), "ln": _unary_np(torch.log),
    "log2": _unary_np(torch.log2), "log10": _unary_np(torch.log10),
    "sin": _unary_np(torch.sin), "cos": _unary_np(torch.cos),
    "tan": _unary_np(torch.tan), "asin": _unary_np(torch.asin),
    "acos": _unary_np(torch.acos), "atan": _unary_np(torch.atan),
    "sinh": _unary_np(torch.sinh), "cosh": _unary_np(torch.cosh),
    "tanh": _unary_np(torch.tanh),
    "degrees": _unary_np(torch.rad2deg), "radians": _unary_np(torch.deg2rad),
    "power": _power, "pow": _power, "mod": _arith("%"),
    "greatest": _greatest_least("greatest"),
    "least": _greatest_least("least"),
    "is_nan": _float_pred(torch.isnan),
    "is_finite": _float_pred(torch.isfinite),
    "is_infinite": _float_pred(torch.isinf),
    "coalesce": _coalesce, "nullif": _nullif, "if": _if, "try": _try,
    "like": _like, "regexp_like": _regexp_like,
    "regexp_extract": _regexp_extract, "regexp_replace": _regexp_replace,
    "lower": _string_unary(str.lower), "upper": _string_unary(str.upper),
    "trim": _string_unary(str.strip), "ltrim": _string_unary(str.lstrip),
    "rtrim": _string_unary(str.rstrip),
    "reverse": _string_unary(lambda v: v[::-1]),
    "length": _length, "substring": _substr, "substr": _substr,
    "concat": _concat, "strpos": _strpos, "position": _strpos,
    "replace": _replace, "starts_with": _starts_with,
    "split_part": _split_part, "lpad": _pad("lpad"), "rpad": _pad("rpad"),
    "date_add_interval": _date_interval("+"),
    "date_sub_interval": _date_interval("-"),
    "year": _extract("year"), "month": _extract("month"),
    "quarter": _extract("quarter"), "week": _extract("week"),
    "day": _extract("day"), "day_of_month": _extract("day"),
    "day_of_week": _extract("day_of_week"), "dow": _extract("day_of_week"),
    "day_of_year": _extract("day_of_year"), "doy": _extract("day_of_year"),
    "cardinality": _cardinality, "empty_approx_set": _empty_approx_set,
}
