"""Device-side TPC-H generation: lineitem lanes born in device memory.

Counterpart of ``trino_tpu/connectors/tpch_device.py`` (lineitem only so
far). Every value is ``mix(seed, row_index)`` through the counter-based
splitmix64 of the host generator (connectors/tpch.py), so the lanes are
bit-identical to the numpy leg.

Torch has no unsigned 64-bit arithmetic (``>>``, ``%`` and ``+`` are not
implemented for ``torch.uint64``), so a u64 value is carried as the same
64-bit pattern in an int64 tensor: multiply, xor and add wrap alike in
two's complement; a logical right shift is the arithmetic shift with the
copied sign bits masked off; an unsigned remainder is built from the
non-negative ``x >>> 1``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..columnar import Batch, Column, take_clamped
from ..config import capacity_for
from ..types import BIGINT, DATE, DOUBLE, INTEGER, VarcharType
from .tpch import (CURRENTDATE, INSTRUCTIONS, MODES, ORDER_DATE_SPAN,
                   STARTDATE, _SEED, table_rows, _strings as _dict_col)

_I64 = torch.int64
_M64 = (1 << 64) - 1


def _s64(u: int) -> int:
    """The int64 with the bit pattern of the unsigned ``u mod 2^64``."""
    u &= _M64
    return u - (1 << 64) if u >= (1 << 63) else u


_C1 = _s64(0xBF58476D1CE4E5B9)
_C2 = _s64(0x94D049BB133111EB)
_GOLD = 0x9E3779B97F4A7C15


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a u64 pattern held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned remainder of a u64 pattern by 0 < m < 2^62: with
    x = 2h + b (h = x >>> 1 >= 0), x mod m = (2 (h mod m) + b) mod m."""
    return (2 * (_shr(x, 1) % m) + (x & 1)) % m


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ _shr(x, 30)
    x = x * _C1
    x = x ^ _shr(x, 27)
    x = x * _C2
    x = x ^ _shr(x, 31)
    return x


def _u64(seed: int, idx: torch.Tensor) -> torch.Tensor:
    return _mix(idx.to(_I64) + _s64(seed * _GOLD))


def _randint(seed: int, idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return lo + _umod(_u64(seed, idx), hi - lo + 1)


def _order_key(i: torch.Tensor) -> torch.Tensor:
    return ((i >> 3) << 5) | (i & 7)


def _order_date(order_idx: torch.Tensor) -> torch.Tensor:
    return STARTDATE + _randint(_SEED["orders"] + 4, order_idx, 0,
                                ORDER_DATE_SPAN)


def _line_counts(order_idx: torch.Tensor) -> torch.Tensor:
    return _randint(_SEED["lineitem"] + 1, order_idx, 1, 7)


def _per_100(x: torch.Tensor) -> torch.Tensor:
    """x / 100 in f64, correctly rounded as numpy divides. The divisor is
    a tensor on x's device: given a python scalar, CUDA multiplies by the
    reciprocal instead, which rounds some values to the other neighbour."""
    return x.to(torch.float64) / torch.full((), 100.0, dtype=torch.float64,
                                            device=x.device)


def _retailprice(partkey: torch.Tensor) -> torch.Tensor:
    pk = partkey.to(_I64)
    return _per_100(90000 + (pk // 10) % 20001 + 100 * (pk % 1000))


def _ps_suppkey(partkey: torch.Tensor, i: torch.Tensor,
                s_count: int) -> torch.Tensor:
    pk = partkey.to(_I64)
    return (pk + i * (s_count // 4 + (pk - 1) // s_count)) % s_count + 1


LINEITEM_DEVICE_COLS = {
    "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
    "l_quantity", "l_extendedprice", "l_discount", "l_tax",
    "l_shipdate", "l_commitdate", "l_receiptdate", "l_returnflag",
    "l_linestatus", "l_shipinstruct", "l_shipmode"}


def device_columns(table: str) -> Optional[set]:
    return LINEITEM_DEVICE_COLS if table == "lineitem" else None


def _line_grid(lo: int, hi: int, device: torch.device):
    """(order_rep, line_no, total, cap) for order indices (lo, hi]: one
    row per (order, line number) in the numpy leg's ``np.repeat`` order,
    padded to the capacity bucket with copies of the first row (padding
    rows are dead, but their derived codes stay in range)."""
    oi = torch.arange(lo + 1, hi + 1, dtype=_I64, device=device)
    counts = _line_counts(oi)
    total = int(counts.sum())
    cap = capacity_for(max(total, 1), minimum=8)
    order_rep = torch.repeat_interleave(oi, counts, output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    line_no = (torch.arange(total, dtype=_I64, device=device)
               - torch.repeat_interleave(starts, counts,
                                         output_size=total) + 1)
    pad = cap - total
    if pad:
        order_rep = torch.cat([order_rep, torch.full(
            (pad,), lo + 1, dtype=_I64, device=device)])
        line_no = torch.cat([line_no, torch.ones(pad, dtype=_I64,
                                                 device=device)])
    return order_rep, line_no, total, cap


def lineitem_batch(lo: int, hi: int, sf: float, columns: List[str],
                   device: torch.device) -> Batch:
    """Lineitem rows for order indices (lo, hi], generated on ``device``."""
    S = _SEED["lineitem"]
    order_rep, line_no, total, cap = _line_grid(lo, hi, device)
    rid = order_rep * 8 + line_no
    p_count = table_rows("part", sf)
    s_count = table_rows("supplier", sf)
    need = set(columns)
    out: Dict[str, Column] = {}

    partkey = None
    if need & {"l_partkey", "l_suppkey", "l_extendedprice"}:
        partkey = _randint(S + 2, rid, 1, p_count)
    odate = None
    if need & {"l_shipdate", "l_commitdate", "l_receiptdate",
               "l_returnflag", "l_linestatus"}:
        odate = _order_date(order_rep)
    shipdate = None
    if need & {"l_shipdate", "l_receiptdate", "l_returnflag",
               "l_linestatus"}:
        shipdate = odate + _randint(S + 7, rid, 1, 121)

    if "l_orderkey" in need:
        out["l_orderkey"] = Column(BIGINT, _order_key(order_rep))
    if "l_partkey" in need:
        out["l_partkey"] = Column(BIGINT, partkey)
    if "l_suppkey" in need:
        out["l_suppkey"] = Column(
            BIGINT, _ps_suppkey(partkey, _randint(S + 3, rid, 0, 3),
                                s_count))
    if "l_linenumber" in need:
        out["l_linenumber"] = Column(INTEGER, line_no.to(torch.int32))
    if need & {"l_quantity", "l_extendedprice"}:
        qty = _randint(S + 4, rid, 1, 50).to(torch.float64)
        if "l_quantity" in need:
            out["l_quantity"] = Column(DOUBLE, qty)
        if "l_extendedprice" in need:
            out["l_extendedprice"] = Column(
                DOUBLE, qty * _retailprice(partkey))
    if "l_discount" in need:
        out["l_discount"] = Column(
            DOUBLE, _per_100(_randint(S + 5, rid, 0, 10)))
    if "l_tax" in need:
        out["l_tax"] = Column(DOUBLE, _per_100(_randint(S + 6, rid, 0, 8)))
    if "l_shipdate" in need:
        out["l_shipdate"] = Column(DATE, shipdate.to(torch.int32))
    if "l_commitdate" in need:
        out["l_commitdate"] = Column(
            DATE, (odate + _randint(S + 8, rid, 30, 90)).to(torch.int32))
    if "l_receiptdate" in need or "l_returnflag" in need:
        receipt = shipdate + _randint(S + 9, rid, 1, 30)
        if "l_receiptdate" in need:
            out["l_receiptdate"] = Column(DATE, receipt.to(torch.int32))
        if "l_returnflag" in need:
            returned = receipt <= CURRENTDATE
            ra = _umod(_u64(S + 20, rid), 2)
            flag = torch.where(returned, ra, 2).to(torch.int32)
            out["l_returnflag"] = _dict_col(["R", "A", "N"], flag,
                                            VarcharType(1))
    if "l_linestatus" in need:
        st = (shipdate > CURRENTDATE).to(torch.int32)
        out["l_linestatus"] = _dict_col(["F", "O"], st, VarcharType(1))
    if "l_shipinstruct" in need:
        si = _randint(S + 21, rid, 0, 3).to(torch.int32)
        out["l_shipinstruct"] = _dict_col(INSTRUCTIONS, si,
                                          VarcharType(25))
    if "l_shipmode" in need:
        sm = _randint(S + 22, rid, 0, 6).to(torch.int32)
        out["l_shipmode"] = _dict_col(MODES, sm, VarcharType(10))
    return Batch({c: out[c] for c in columns}, total)


def device_filter(batch: Batch, constraint, limit: Optional[int]) -> Batch:
    """Apply an accepted TupleDomain + limit to a device-resident batch
    without a host round trip. Dictionary columns evaluate the domain
    once per dictionary value on the host, then gather the per-code
    verdicts; numeric columns turn ranges into comparisons. Generator
    columns carry no NULLs."""
    from ..ops import compact
    if constraint is not None and constraint.is_none:
        return Batch(batch.columns, 0)
    if constraint is not None and not constraint.is_all():
        mask = batch.row_valid()
        for col, dom in constraint.domains:
            if col not in batch.columns or dom.is_all:
                continue
            c = batch.columns[col]
            if c.dictionary is not None:
                vals = c.dictionary.values.astype(str)
                tbl = dom.mask_for(
                    np.arange(len(vals)), None,
                    lambda cds, v=vals: v[np.clip(
                        cds.astype(np.int64), 0, len(v) - 1)])
                m = take_clamped(torch.from_numpy(np.asarray(tbl, bool))
                                 .to(c.device), c.data)
            else:
                m = torch.zeros(c.capacity, dtype=torch.bool,
                                device=c.device)
                for r in dom.ranges:
                    rm = torch.ones_like(m)
                    if r.low is not None:
                        rm &= ((c.data >= r.low) if r.low_inclusive
                               else (c.data > r.low))
                    if r.high is not None:
                        rm &= ((c.data <= r.high) if r.high_inclusive
                               else (c.data < r.high))
                    m |= rm
            mask = mask & m
        batch = compact.filter_batch(batch, mask)
    if limit is not None:
        batch = compact.limit_batch(batch, limit)
    return batch
