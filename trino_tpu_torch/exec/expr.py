"""Row-expression evaluation over Batches of torch tensors.

Counterpart of ``trino_tpu/exec/expr.py``, for the subset the ported
queries reach: column references, constants, casts between numeric types,
Kleene AND/OR/NOT, IS NULL, comparisons (numbers, dates, dictionary
strings), + - * / % on non-decimal numbers, negation, and adding or
subtracting a day-time interval to a date. Anything else raises
``EvalError("not yet ported: ...")``.

Every evaluation returns a Column (value lane + validity lane); AND/OR
implement the Kleene truth tables. A constant is a stride-0 view over one
element, so it costs no memory at any capacity.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..columnar import Batch, Column, StringDictionary, take_clamped, \
    torch_dtype
from ..rex import Call, Cast, Const, InputRef, RowExpr
from ..types import (BOOLEAN, DATE, UNKNOWN, DecimalType,
                     IntervalYearMonth, Type, is_integral, is_string)


class EvalError(Exception):
    pass


def eval_expr(e: RowExpr, batch: Batch) -> Column:
    if isinstance(e, InputRef):
        return batch.column(e.name)
    if isinstance(e, Const):
        return const_column(e, batch.capacity, batch.device)
    if isinstance(e, Call):
        h = _DISPATCH.get(e.fn)
        if h is None:
            raise EvalError(f"not yet ported: function '{e.fn}'")
        return h(e, batch)
    if isinstance(e, Cast):
        return cast_column(eval_expr(e.arg, batch), e.type)
    raise EvalError(f"not yet ported: {type(e).__name__} expressions")


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
        if is_string(t):
            d, _ = StringDictionary.from_strings([])
            return Column(t, _full(0, cap, torch.int32, device), invalid, d)
        base = BOOLEAN if t == UNKNOWN else t
        return Column(t, _full(0, cap, torch_dtype(base), device), invalid)
    if is_string(t):
        d = StringDictionary(np.asarray([e.value], dtype=object))
        return Column(t, _full(0, cap, torch.int32, device), None, d)
    if isinstance(t, DecimalType):
        raise EvalError(f"not yet ported: {t} constants")
    return Column(t, _full(e.value, cap, torch_dtype(t), device), None)


def _merge_valid(*cols: Column) -> Optional[torch.Tensor]:
    v = None
    for c in cols:
        if c.valid is not None:
            v = c.valid if v is None else (v & c.valid)
    return v


# ---- casts ---------------------------------------------------------------

def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def cast_column(src: Column, t: Type) -> Column:
    s = src.type
    if s == t:
        return src
    if s == UNKNOWN:
        return const_column(Const(None, t), src.capacity, src.device)
    if is_string(s) and is_string(t):
        return dc_replace(src, type=t)
    if isinstance(s, DecimalType) or isinstance(t, DecimalType) \
            or is_string(s) or is_string(t) or t.np_dtype is None \
            or s.np_dtype is None:
        raise EvalError(f"not yet ported: cast {s} -> {t}")
    d = src.data
    if t.name in ("double", "real"):
        return Column(t, d.to(torch_dtype(t)), src.valid)
    if is_integral(t):
        if s.name in ("double", "real"):
            d = _round_half_up(d.to(torch.float64))
        return Column(t, d.to(torch_dtype(t)), src.valid)
    if t is BOOLEAN:
        return Column(t, d != 0, src.valid)
    raise EvalError(f"not yet ported: cast {s} -> {t}")


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

def _codes_through(col: Column, table: np.ndarray) -> torch.Tensor:
    return take_clamped(torch.from_numpy(np.asarray(table))
                        .to(col.device), col.data)


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
        elif isinstance(a.type, DecimalType) \
                or isinstance(b.type, DecimalType):
            raise EvalError(f"not yet ported: {op} on {a.type}")
        else:
            data = _cmp_lanes(op, a.data, b.data)
        return Column(BOOLEAN, data, valid)
    return h


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
    if isinstance(a.type, DecimalType):
        raise EvalError(f"not yet ported: negate {a.type}")
    return dc_replace(a, data=-a.data, type=e.type)


def _date_interval(op: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        if e.args[1].type is IntervalYearMonth:
            raise EvalError("not yet ported: year-month intervals")
        days = a.data.to(torch.int64)
        iv = b.data.to(torch.int64)
        if op == "-":
            iv = -iv
        data = days + torch.div(iv, 86400000, rounding_mode="floor")
        return Column(DATE, data.to(torch.int32), _merge_valid(a, b))
    return h


_DISPATCH: Dict[str, Callable] = {
    "and": _and, "or": _or, "not": _not, "is_null": _is_null,
    "=": _cmp("="), "<>": _cmp("<>"), "<": _cmp("<"), "<=": _cmp("<="),
    ">": _cmp(">"), ">=": _cmp(">="),
    "+": _arith("+"), "-": _arith("-"), "*": _arith("*"),
    "/": _arith("/"), "%": _arith("%"),
    "negate": _negate,
    "date_add_interval": _date_interval("+"),
    "date_sub_interval": _date_interval("-"),
}
