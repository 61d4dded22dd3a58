"""Device-side TPC-H generation: lineitem and orders lanes born in
device memory.

Counterpart of ``trino_tpu/connectors/tpch_device.py``. Every value is
``mix(seed, row_index)`` through the counter-based splitmix64 of the host
generator (connectors/tpch.py), so the lanes are bit-identical to the
numpy leg. u64 arithmetic runs on int64 carriers (ops/hashing.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..columnar import Batch, Column, take_clamped
from ..config import capacity_for
from ..ops.hashing import GOLDEN, mix64, s64, umod
from ..types import BIGINT, DATE, DOUBLE, INTEGER, VarcharType
from .tpch import (CURRENTDATE, INSTRUCTIONS, MODES, ORDER_DATE_SPAN,
                   PRIORITIES, STARTDATE, _SEED, table_rows,
                   _strings as _dict_col)

_I64 = torch.int64


def _u64(seed: int, idx: torch.Tensor) -> torch.Tensor:
    return mix64(idx.to(_I64) + s64(seed * GOLDEN))


def _randint(seed: int, idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return lo + umod(_u64(seed, idx), hi - lo + 1)


def _order_key(i: torch.Tensor) -> torch.Tensor:
    return ((i >> 3) << 5) | (i & 7)


def _order_date(order_idx: torch.Tensor) -> torch.Tensor:
    return STARTDATE + _randint(_SEED["orders"] + 4, order_idx, 0,
                                ORDER_DATE_SPAN)


def _cust_key(order_idx: torch.Tensor, c_count: int) -> torch.Tensor:
    """Random custkey never divisible by 3 (only 2/3 of customers have
    orders, spec 4.2.3)."""
    j = _randint(_SEED["orders"] + 3, order_idx, 1,
                 max(2 * c_count // 3, 1))
    return 3 * ((j - 1) // 2) + 1 + ((j - 1) % 2)


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


ORDERS_DEVICE_COLS = {
    "o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
    "o_orderdate", "o_orderpriority", "o_shippriority"}


def device_columns(table: str) -> Optional[set]:
    return {"lineitem": LINEITEM_DEVICE_COLS,
            "orders": ORDERS_DEVICE_COLS}.get(table)


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
            ra = umod(_u64(S + 20, rid), 2)
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


def orders_batch(lo: int, hi: int, sf: float, columns: List[str],
                 device: torch.device) -> Batch:
    """Orders rows for order indices (lo, hi], generated on ``device``.
    o_totalprice and o_orderstatus aggregate the order's generated
    lineitems on a static 7-wide grid (dead cells masked)."""
    S = _SEED["orders"]
    idx = torch.arange(lo + 1, hi + 1, dtype=_I64, device=device)
    n = hi - lo
    cap = capacity_for(max(n, 1), minimum=8)

    def padded(a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, torch.zeros(cap - n, dtype=a.dtype,
                                         device=device)])

    need = set(columns)
    out: Dict[str, Column] = {}
    if "o_orderkey" in need:
        out["o_orderkey"] = Column(BIGINT, padded(_order_key(idx)))
    if "o_custkey" in need:
        out["o_custkey"] = Column(BIGINT, padded(
            _cust_key(idx, table_rows("customer", sf))))
    if need & {"o_orderstatus", "o_totalprice"}:
        SL = _SEED["lineitem"]
        counts = _line_counts(idx)
        o_grid = torch.repeat_interleave(idx, 7)
        ln_grid = torch.arange(1, 8, dtype=_I64, device=device).repeat(n)
        live = ln_grid <= torch.repeat_interleave(counts, 7)
        rid = o_grid * 8 + ln_grid
        pk = _randint(SL + 2, rid, 1, table_rows("part", sf))
        qty = _randint(SL + 4, rid, 1, 50).to(torch.float64)
        disc = _per_100(_randint(SL + 5, rid, 0, 10))
        tax = _per_100(_randint(SL + 6, rid, 0, 8))
        price = qty * _retailprice(pk) * (1.0 + tax) * (1.0 - disc)
        price = torch.where(live, price, 0.0).reshape(n, 7)
        # sequential left-to-right adds: bit-identical to the host
        # leg's np.add.at accumulation (a tree reduction rounds
        # differently in the last bit)
        total = price[:, 0]
        for k in range(1, 7):
            total = total + price[:, k]
        # numpy's round(x, 2): rint(x * 100) / 100 with a true division
        total = _per_100(torch.round(total * 100.0))
        if "o_totalprice" in need:
            out["o_totalprice"] = Column(DOUBLE, padded(total))
        if "o_orderstatus" in need:
            ship = _order_date(o_grid) + _randint(SL + 7, rid, 1, 121)
            shipped = (live & (ship <= CURRENTDATE)).reshape(n, 7)
            n_shipped = shipped.sum(dim=1)
            status = torch.where(
                n_shipped == 0, 0,
                torch.where(n_shipped == counts, 1, 2)).to(torch.int32)
            out["o_orderstatus"] = _dict_col(["O", "F", "P"],
                                             padded(status), VarcharType(1))
    if "o_orderdate" in need:
        out["o_orderdate"] = Column(DATE, padded(
            _order_date(idx).to(torch.int32)))
    if "o_orderpriority" in need:
        p = _randint(S + 5, idx, 0, 4).to(torch.int32)
        out["o_orderpriority"] = _dict_col(PRIORITIES, padded(p),
                                           VarcharType(15))
    if "o_shippriority" in need:
        out["o_shippriority"] = Column(
            INTEGER, torch.zeros(cap, dtype=torch.int32, device=device))
    return Batch({c: out[c] for c in columns}, n)


def device_filter(batch: Batch, constraint, limit: Optional[int]) -> Batch:
    """Apply an accepted TupleDomain + limit to a device-resident batch
    without a host round trip. Dictionary columns evaluate the domain
    once per dictionary value on the host, then gather the per-code
    verdicts; numeric columns turn ranges into comparisons. A NULL row
    (a memory table's; generator columns carry none) is kept when the
    domain allows NULL, as ``Domain.mask_for`` keeps it."""
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
                # an empty dictionary: every row is NULL
                m = (take_clamped(torch.from_numpy(np.asarray(tbl, bool))
                                  .to(c.device), c.data) if len(vals)
                     else torch.zeros(c.capacity, dtype=torch.bool,
                                      device=c.device))
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
            if c.valid is not None:
                m = torch.where(c.valid, m, dom.null_allowed)
            mask = mask & m
        batch = compact.filter_batch(batch, mask)
    if limit is not None:
        batch = compact.limit_batch(batch, limit)
    return batch
