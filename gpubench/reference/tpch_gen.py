"""TPC-H row generators in plain numpy: the data both sides read.

Frozen copy of the value functions of ``trino_tpu_torch/connectors/tpch.py``
at commit 02b59fe5773712a2e689bf918db914d607cd01fb (the counter hash, the
seeds, the key and date rules, the lineitem lanes and the vocabularies),
with the connector's classes, string dictionaries and device leg left out.
Every value is a pure function of (column seed, row index), so any range
of orders can be generated on its own; lineitem rows are addressed by
their order index (1 to 7 lines an order).

It imports nothing of the program: a later change to the program's
generator cannot move what the reference computes.
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

_EPOCH = datetime.date(1970, 1, 1).toordinal()


def days(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 (a DATE lane's value)."""
    return datetime.date(y, m, d).toordinal() - _EPOCH


def date_str(day: int) -> str:
    return datetime.date.fromordinal(int(day) + _EPOCH).isoformat()


STARTDATE = days(1992, 1, 1)
CURRENTDATE = days(1995, 6, 17)
ENDDATE = days(1998, 12, 31)
ORDER_DATE_SPAN = (ENDDATE - 151) - STARTDATE

SCHEMAS: Dict[str, float] = {
    "tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0,
}

_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(30))
        x = x * _C1
        x = x ^ (x >> np.uint64(27))
        x = x * _C2
        x = x ^ (x >> np.uint64(31))
    return x


def u64(seed: int, idx: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _mix(np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
                    + idx.astype(np.uint64))


def randint(seed: int, idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform integer in [lo, hi], inclusive, per row."""
    span = np.uint64(hi - lo + 1)
    return (lo + (u64(seed, idx) % span).astype(np.int64)).astype(np.int64)


SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["F", "O"]

_BASE_ROWS = {"supplier": 10_000, "part": 200_000, "partsupp": 800_000,
              "customer": 150_000, "orders": 1_500_000}

SEED = {name: i * 1000 for i, name in enumerate(
    ["supplier", "part", "partsupp", "customer", "orders", "lineitem"])}


def table_rows(table: str, sf: float) -> int:
    return int(round(_BASE_ROWS[table] * sf))


def retailprice(partkey: np.ndarray) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)) / 100.0


def line_counts(order_idx: np.ndarray) -> np.ndarray:
    return randint(SEED["lineitem"] + 1, order_idx, 1, 7)


def line_numbers(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(int(counts.sum()), dtype=np.int64) \
        - np.repeat(starts, counts) + 1


def order_key(order_idx: np.ndarray) -> np.ndarray:
    i = order_idx.astype(np.int64)
    return ((i >> 3) << 5) | (i & 7)


def order_date(order_idx: np.ndarray) -> np.ndarray:
    return STARTDATE + randint(SEED["orders"] + 4, order_idx, 0,
                               ORDER_DATE_SPAN)


def cust_key(order_idx: np.ndarray, c_count: int) -> np.ndarray:
    j = randint(SEED["orders"] + 3, order_idx, 1, max(2 * c_count // 3, 1))
    return 3 * ((j - 1) // 2) + 1 + ((j - 1) % 2)


def order_priority(order_idx: np.ndarray) -> np.ndarray:
    """Index into PRIORITIES."""
    return randint(SEED["orders"] + 5, order_idx, 0, 4)


def customer_segment(custkey: np.ndarray) -> np.ndarray:
    """Index into SEGMENTS."""
    return randint(SEED["customer"] + 6, custkey, 0, 4)


def part_type_s1(partkey: np.ndarray) -> np.ndarray:
    """Index into TYPE_S1 of p_type (its first word)."""
    return randint(SEED["part"] + 4, partkey, 0, 149) // 25


def lineitem(lo: int, hi: int, sf: float, columns):
    """The lineitem lanes of orders (lo, hi] (0-based bounds, 1-based
    order indices), as ``(rows, orders)``: ``rows`` holds a lane per
    requested ``l_`` column, one value a line; ``orders`` holds
    ``o_idx`` (the order indices), ``counts`` (lines an order) and each
    requested ``o_`` column, one value an order. Only what the requested
    columns derive from is generated; string lanes are indices into
    their vocabularies."""
    need = set(columns)
    S = SEED["lineitem"]
    o_idx = np.arange(lo + 1, hi + 1, dtype=np.int64)
    counts = line_counts(o_idx)
    orders: Dict[str, np.ndarray] = {"o_idx": o_idx, "counts": counts}
    rep = np.repeat(o_idx, counts)
    rid = rep * 8 + line_numbers(counts)
    rows: Dict[str, np.ndarray] = {}
    if "l_orderkey" in need:
        rows["l_orderkey"] = order_key(rep)
    if "o_custkey" in need:
        orders["o_custkey"] = cust_key(o_idx, table_rows("customer", sf))
    if "o_orderpriority" in need:
        orders["o_orderpriority"] = order_priority(o_idx)
    partkey = None
    if need & {"l_partkey", "l_extendedprice"}:
        partkey = randint(S + 2, rid, 1, table_rows("part", sf))
        rows["l_partkey"] = partkey
    quantity = None
    if need & {"l_quantity", "l_extendedprice"}:
        quantity = randint(S + 4, rid, 1, 50).astype(np.float64)
        rows["l_quantity"] = quantity
    if "l_discount" in need:
        rows["l_discount"] = randint(S + 5, rid, 0, 10) / 100.0
    if "l_tax" in need:
        rows["l_tax"] = randint(S + 6, rid, 0, 8) / 100.0
    if "l_extendedprice" in need:
        rows["l_extendedprice"] = quantity * retailprice(partkey)
    if need & {"l_shipdate", "l_commitdate", "l_receiptdate",
               "l_returnflag", "l_linestatus", "o_orderdate"}:
        odate_o = order_date(o_idx)
        orders["o_orderdate"] = odate_o
        odate = np.repeat(odate_o, counts)
        ship = odate + randint(S + 7, rid, 1, 121)
        rows["l_shipdate"] = ship
        if "l_commitdate" in need:
            rows["l_commitdate"] = odate + randint(S + 8, rid, 30, 90)
        if need & {"l_receiptdate", "l_returnflag"}:
            receipt = ship + randint(S + 9, rid, 1, 30)
            rows["l_receiptdate"] = receipt
            if "l_returnflag" in need:
                ra = (u64(S + 20, rid) % np.uint64(2)).astype(np.int64)
                rows["l_returnflag"] = np.where(receipt <= CURRENTDATE,
                                                ra, 2)
        if "l_linestatus" in need:
            rows["l_linestatus"] = (ship > CURRENTDATE).astype(np.int64)
    if "l_shipmode" in need:
        rows["l_shipmode"] = randint(S + 22, rid, 0, 6)
    return rows, orders
