"""TPC-H data-generator connector.

Reference parity: plugin/trino-tpch (TpchConnectorFactory.java,
TpchMetadata.java, TpchRecordSetProvider.java, TpchSplitManager.java:32-46)
— generates TPC-H data on the fly, deterministically, per split.

TPU-first redesign (SURVEY.md Appendix B.6): instead of a stateful
row-cursor (airlift dbgen port), every value is a pure function of
``(column_seed, absolute_row_index)`` through a splitmix64 counter hash.
Any split can therefore generate its exact row range independently, fully
vectorized in numpy, with no sequential RNG state — the generator itself is
data-parallel. Distributions follow the TPC-H specification rev 2.18
(value ranges, key sparsity, date windows, comment token injection);
the bit-exact dbgen text grammar is intentionally not reproduced.

Schemas: tiny (SF 0.01), sf1, sf10, sf100, sf1000 — matching the
reference connector's schema set (TpchMetadata.java SCHEMA_NAMES).
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..catalog import (ColumnMetadata as CM, Connector, Split, TableHandle,
                       TableMetadata)
from ..columnar import Batch, Column, StringDictionary, pad_batch
from ..config import DeviceLike, capacity_for, resolve_device
from ..types import (BIGINT, DATE, DOUBLE, INTEGER, Type, VarcharType)

_EPOCH = datetime.date(1970, 1, 1).toordinal()


def _days(y: int, m: int, d: int) -> int:
    return datetime.date(y, m, d).toordinal() - _EPOCH


STARTDATE = _days(1992, 1, 1)
CURRENTDATE = _days(1995, 6, 17)
ENDDATE = _days(1998, 12, 31)
ORDER_DATE_SPAN = (ENDDATE - 151) - STARTDATE  # o_orderdate upper bound

SCHEMAS: Dict[str, float] = {
    "tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0, "sf1000": 1000.0,
}

# --------------------------------------------------------------------------
# counter-based RNG: value = f(seed, row_index), vectorized
# --------------------------------------------------------------------------

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


def _u64(seed: int, idx: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _mix(np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
                    + idx.astype(np.uint64))


def _randint(seed: int, idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform integer in [lo, hi], inclusive, per row."""
    span = np.uint64(hi - lo + 1)
    return (lo + (_u64(seed, idx) % span).astype(np.int64)).astype(np.int64)


def _uniform(seed: int, idx: np.ndarray) -> np.ndarray:
    return (_u64(seed, idx) >> np.uint64(11)).astype(np.float64) / float(1 << 53)


# --------------------------------------------------------------------------
# fixed vocabularies (TPC-H spec 4.2.2.13)
# --------------------------------------------------------------------------

NATIONS = [  # (name, regionkey)
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

P_NAME_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue "
    "blush brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder "
    "puff purple red rose rosy royal saddle salmon sandy seashell sienna "
    "sky slate smoke snow spring steel tan thistle tomato turquoise "
    "violet wheat white yellow").split()

TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

_COMMENT_WORDS = (
    "carefully quickly blithely furiously slyly fluffily final express "
    "regular special bold pending ironic even silent unusual daring "
    "deposits requests accounts packages instructions theodolites "
    "platelets foxes ideas dependencies excuses pinto beans asymptotes "
    "courts dolphins multipliers sauternes warhorses sheaves dugouts "
    "sleep wake cajole nag haggle detect integrate boost engage breach "
    "among across above against along until again after about the")


_DICT_CACHE: Dict[tuple, StringDictionary] = {}


def _strings(values: Sequence[str], codes: np.ndarray, typ: Type) -> Column:
    # fixed-vocabulary dictionaries are shared by identity across splits
    # so jitted pipelines (dictionary is static trace metadata) compile
    # once per query, not once per split
    key = tuple(values)
    d = _DICT_CACHE.get(key)
    if d is None:
        d = StringDictionary(np.asarray(list(values), dtype=object))
        _DICT_CACHE[key] = d
    lane = (codes.to(torch.int32) if isinstance(codes, torch.Tensor)
            else codes.astype(np.int32))
    return Column(typ, lane, None, d)


def _text_column(seed: int, idx: np.ndarray, typ: Type,
                 inject: Optional[Dict[str, np.ndarray]] = None) -> Column:
    """Pseudo-text comments: 5-8 pool words per row. ``inject`` maps a
    phrase to a boolean row mask that must contain it (spec 4.2.2.10's
    'special requests' / 'Customer Complaints' text injections)."""
    words = _COMMENT_WORDS.split()
    nw = len(words)
    n = len(idx)
    lens = _randint(seed + 11, idx, 5, 8)
    picks = [_randint(seed + 13 + k, idx, 0, nw - 1) for k in range(8)]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = " ".join(words[int(picks[k][i])]
                          for k in range(int(lens[i])))
    if inject:
        for phrase, mask in inject.items():
            rows = np.nonzero(mask)[0]
            for i in rows:
                out[i] = f"{out[i].split(' ', 1)[0]} {phrase}"
    dic, codes = StringDictionary.from_strings(list(out))
    return Column(typ, codes, None, dic)


def _alnum_column(seed: int, idx: np.ndarray, typ: Type) -> Column:
    """Random address-like strings (v-strings, spec 4.2.2.7)."""
    h1 = _u64(seed, idx)
    h2 = _u64(seed + 1, idx)
    out = np.empty(len(idx), dtype=object)
    for i in range(len(idx)):
        s = f"{int(h1[i]):016x}{int(h2[i]):08x}"
        out[i] = s[: 10 + int(h2[i]) % 15]
    dic, codes = StringDictionary.from_strings(list(out))
    return Column(typ, codes, None, dic)


def _phone_column(seed: int, idx: np.ndarray,
                  nationkey: np.ndarray) -> Column:
    a = _randint(seed + 1, idx, 100, 999)
    b = _randint(seed + 2, idx, 100, 999)
    c = _randint(seed + 3, idx, 1000, 9999)
    out = np.empty(len(idx), dtype=object)
    for i in range(len(idx)):
        out[i] = (f"{int(nationkey[i]) + 10:02d}-{int(a[i])}-"
                  f"{int(b[i])}-{int(c[i])}")
    dic, codes = StringDictionary.from_strings(list(out))
    return Column(VarcharType(15), codes, None, dic)


def _fmt_key_column(prefix: str, keys: np.ndarray, typ: Type) -> Column:
    out = np.empty(len(keys), dtype=object)
    for i in range(len(keys)):
        out[i] = f"{prefix}{int(keys[i]):09d}"
    dic, codes = StringDictionary.from_strings(list(out))
    return Column(typ, codes, None, dic)


# --------------------------------------------------------------------------
# table schemas (column order and types mirror plugin/trino-tpch's
# TpchTable column lists; prices are DOUBLE as in the reference connector)
# --------------------------------------------------------------------------

TABLES: Dict[str, List[CM]] = {
    "region": [CM("r_regionkey", BIGINT), CM("r_name", VarcharType(25)),
               CM("r_comment", VarcharType(152))],
    "nation": [CM("n_nationkey", BIGINT), CM("n_name", VarcharType(25)),
               CM("n_regionkey", BIGINT), CM("n_comment", VarcharType(152))],
    "supplier": [CM("s_suppkey", BIGINT), CM("s_name", VarcharType(25)),
                 CM("s_address", VarcharType(40)),
                 CM("s_nationkey", BIGINT), CM("s_phone", VarcharType(15)),
                 CM("s_acctbal", DOUBLE), CM("s_comment", VarcharType(101))],
    "part": [CM("p_partkey", BIGINT), CM("p_name", VarcharType(55)),
             CM("p_mfgr", VarcharType(25)), CM("p_brand", VarcharType(10)),
             CM("p_type", VarcharType(25)), CM("p_size", INTEGER),
             CM("p_container", VarcharType(10)),
             CM("p_retailprice", DOUBLE), CM("p_comment", VarcharType(23))],
    "partsupp": [CM("ps_partkey", BIGINT), CM("ps_suppkey", BIGINT),
                 CM("ps_availqty", INTEGER), CM("ps_supplycost", DOUBLE),
                 CM("ps_comment", VarcharType(199))],
    "customer": [CM("c_custkey", BIGINT), CM("c_name", VarcharType(25)),
                 CM("c_address", VarcharType(40)),
                 CM("c_nationkey", BIGINT), CM("c_phone", VarcharType(15)),
                 CM("c_acctbal", DOUBLE),
                 CM("c_mktsegment", VarcharType(10)),
                 CM("c_comment", VarcharType(117))],
    "orders": [CM("o_orderkey", BIGINT), CM("o_custkey", BIGINT),
               CM("o_orderstatus", VarcharType(1)),
               CM("o_totalprice", DOUBLE), CM("o_orderdate", DATE),
               CM("o_orderpriority", VarcharType(15)),
               CM("o_clerk", VarcharType(15)),
               CM("o_shippriority", INTEGER),
               CM("o_comment", VarcharType(79))],
    "lineitem": [CM("l_orderkey", BIGINT), CM("l_partkey", BIGINT),
                 CM("l_suppkey", BIGINT), CM("l_linenumber", INTEGER),
                 CM("l_quantity", DOUBLE), CM("l_extendedprice", DOUBLE),
                 CM("l_discount", DOUBLE), CM("l_tax", DOUBLE),
                 CM("l_returnflag", VarcharType(1)),
                 CM("l_linestatus", VarcharType(1)),
                 CM("l_shipdate", DATE), CM("l_commitdate", DATE),
                 CM("l_receiptdate", DATE),
                 CM("l_shipinstruct", VarcharType(25)),
                 CM("l_shipmode", VarcharType(10)),
                 CM("l_comment", VarcharType(44))],
}

_BASE_ROWS = {"supplier": 10_000, "part": 200_000, "partsupp": 800_000,
              "customer": 150_000, "orders": 1_500_000}


def table_rows(table: str, sf: float) -> int:
    if table == "region":
        return 5
    if table == "nation":
        return 25
    if table == "lineitem":
        # addressed by order index; row count is derived (avg 4/order)
        raise ValueError("lineitem row count is data-dependent")
    return int(round(_BASE_ROWS[table] * sf))


# per-(table,column-group) seeds, disjoint
_SEED = {name: i * 1000 for i, name in enumerate(
    ["supplier", "part", "partsupp", "customer", "orders", "lineitem"])}


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)) / 100.0


def _ps_suppkey(partkey: np.ndarray, i: np.ndarray,
                s_count: int) -> np.ndarray:
    """spec 4.2.3: ps_suppkey = (ps_partkey + (i * (S/4 +
    (ps_partkey-1)/S))) % S + 1"""
    pk = partkey.astype(np.int64)
    s = np.int64(s_count)
    return (pk + i * (s // 4 + (pk - 1) // s)) % s + 1


def _line_counts(order_idx: np.ndarray) -> np.ndarray:
    """lineitems per order, 1..7, pure function of order index."""
    return _randint(_SEED["lineitem"] + 1, order_idx, 1, 7)


def _line_numbers(counts: np.ndarray) -> np.ndarray:
    """1..count for each order, one order after another (int64)."""
    counts = counts.astype(np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(int(counts.sum()), dtype=np.int64) \
        - np.repeat(starts, counts) + 1


def _order_key(order_idx: np.ndarray) -> np.ndarray:
    """Sparse order keys: 8 used out of every 32 (spec 4.2.3 O_ORDERKEY)."""
    i = order_idx.astype(np.int64)
    return ((i >> 3) << 5) | (i & 7)


def _order_date(order_idx: np.ndarray) -> np.ndarray:
    return STARTDATE + _randint(_SEED["orders"] + 4, order_idx, 0,
                                ORDER_DATE_SPAN)


def _cust_key(order_idx: np.ndarray, c_count: int) -> np.ndarray:
    """Random custkey never divisible by 3 (only 2/3 of customers have
    orders, spec 4.2.3)."""
    j = _randint(_SEED["orders"] + 3, order_idx, 1, max(2 * c_count // 3, 1))
    return 3 * ((j - 1) // 2) + 1 + ((j - 1) % 2)


class _LineFields:
    """All lineitem lanes for a range of global lineitem row indices,
    each a pure function of (order_idx, line_number)."""

    def __init__(self, order_idx: np.ndarray, linenumber: np.ndarray,
                 sf: float):
        S = _SEED["lineitem"]
        # unique per-row counter: order_idx * 8 + linenumber
        rid = order_idx.astype(np.int64) * 8 + linenumber
        self.orderkey = _order_key(order_idx)
        self.linenumber = linenumber
        p_count = table_rows("part", sf)
        s_count = table_rows("supplier", sf)
        self.partkey = _randint(S + 2, rid, 1, p_count)
        self.suppkey = _ps_suppkey(self.partkey,
                                   _randint(S + 3, rid, 0, 3), s_count)
        self.quantity = _randint(S + 4, rid, 1, 50).astype(np.float64)
        self.discount = _randint(S + 5, rid, 0, 10) / 100.0
        self.tax = _randint(S + 6, rid, 0, 8) / 100.0
        self.extendedprice = self.quantity * _retailprice(self.partkey)
        odate = _order_date(order_idx)
        self.shipdate = odate + _randint(S + 7, rid, 1, 121)
        self.commitdate = odate + _randint(S + 8, rid, 30, 90)
        self.receiptdate = self.shipdate + _randint(S + 9, rid, 1, 30)
        self.rid = rid


class TpchConnector(Connector):
    name = "tpch"
    scan_cache_ok = True      # pure generator: splits are immutable

    def __init__(self, rows_per_split: int = 1 << 17,
                 device: DeviceLike = None):
        self.rows_per_split = rows_per_split
        # splits are returned on this device; on a card, lineitem and
        # orders are generated there (tpch_device.py)
        self.device = resolve_device(device)

    # --- metadata --------------------------------------------------------
    def list_schemas(self) -> List[str]:
        return list(SCHEMAS)

    def list_tables(self, schema: str) -> List[str]:
        return list(TABLES) if schema in SCHEMAS else []

    def get_table_metadata(self, schema, table) -> Optional[TableMetadata]:
        if schema in SCHEMAS and table in TABLES:
            return TableMetadata(schema, table, tuple(TABLES[table]))
        return None

    def table_row_count(self, handle: TableHandle) -> Optional[float]:
        sf = SCHEMAS[handle.schema]
        if handle.table == "lineitem":
            return table_rows("orders", sf) * 4.0
        return float(table_rows(handle.table, sf))

    def column_statistics(self, handle: TableHandle, column: str):
        """Analytic per-column stats from the TPC-H spec's value
        domains, scaled by SF (reference:
        plugin/trino-tpch/.../statistics/ ships precomputed stats
        files; ours derive from the same spec formulas)."""
        from ..catalog import ColumnStatistics as CS
        sf = SCHEMAS[handle.schema]

        def rows(t):
            return float(table_rows(t, sf))

        stats = {
            "r_regionkey": CS(5, 0, 4), "r_name": CS(5),
            "n_nationkey": CS(25, 0, 24), "n_name": CS(25),
            "n_regionkey": CS(5, 0, 4),
            "s_suppkey": CS(rows("supplier"), 1, rows("supplier")),
            "s_nationkey": CS(25, 0, 24),
            "s_acctbal": CS(rows("supplier") * 0.9, -999.99, 9999.99),
            "s_name": CS(rows("supplier")),
            "p_partkey": CS(rows("part"), 1, rows("part")),
            "p_brand": CS(25), "p_type": CS(150), "p_size": CS(50, 1,
                                                              50),
            "p_container": CS(40), "p_mfgr": CS(5),
            "p_retailprice": CS(rows("part") * 0.1, 900.0, 2099.0),
            "p_name": CS(rows("part")),
            "ps_partkey": CS(rows("part"), 1, rows("part")),
            "ps_suppkey": CS(rows("supplier"), 1, rows("supplier")),
            "ps_availqty": CS(9999, 1, 9999),
            "ps_supplycost": CS(100_000, 1.0, 1000.0),
            "c_custkey": CS(rows("customer"), 1, rows("customer")),
            "c_nationkey": CS(25, 0, 24), "c_mktsegment": CS(5),
            "c_acctbal": CS(rows("customer") * 0.9, -999.99, 9999.99),
            "c_name": CS(rows("customer")),
            "o_orderkey": CS(rows("orders"), 1, rows("orders") * 4),
            # 1/3 of customers have no orders (TPC-H 4.2.3)
            "o_custkey": CS(rows("customer") * 2 / 3, 1,
                            rows("customer")),
            "o_orderstatus": CS(3), "o_orderpriority": CS(5),
            "o_shippriority": CS(1, 0, 0), "o_clerk": CS(
                max(rows("orders") / 1500, 1)),
            "o_orderdate": CS(ORDER_DATE_SPAN, STARTDATE,
                              STARTDATE + ORDER_DATE_SPAN),
            "o_totalprice": CS(rows("orders") * 0.9, 857.71,
                               555285.16),
            "l_orderkey": CS(rows("orders"), 1, rows("orders") * 4),
            "l_partkey": CS(rows("part"), 1, rows("part")),
            "l_suppkey": CS(rows("supplier"), 1, rows("supplier")),
            "l_linenumber": CS(7, 1, 7),
            "l_quantity": CS(50, 1, 50),
            "l_extendedprice": CS(rows("part") * 0.5, 901.0,
                                  104949.5),
            "l_discount": CS(11, 0.0, 0.10),
            "l_tax": CS(9, 0.0, 0.08),
            "l_returnflag": CS(3), "l_linestatus": CS(2),
            "l_shipmode": CS(7), "l_shipinstruct": CS(4),
            "l_shipdate": CS(ENDDATE - 151 + 121 - STARTDATE - 1,
                             STARTDATE + 1, ENDDATE - 151 + 121),
            "l_commitdate": CS(ENDDATE - STARTDATE, STARTDATE + 30,
                               ENDDATE - 31),
            "l_receiptdate": CS(ENDDATE - STARTDATE, STARTDATE + 2,
                                ENDDATE),
        }
        return stats.get(column)

    # --- splits ----------------------------------------------------------
    def get_splits(self, handle: TableHandle,
                   desired_parallelism: int = 1) -> List[Split]:
        sf = SCHEMAS[handle.schema]
        if handle.table == "lineitem":
            # addressed by order index; ~4 lineitems per order
            units = table_rows("orders", sf)
            per = max(self.rows_per_split // 4, 1)
        else:
            units = table_rows(handle.table, sf)
            per = self.rows_per_split
        n_splits = max(1, min((units + per - 1) // per,
                              max(desired_parallelism * 4, 1)
                              if units > per else 1))
        n_splits = max(n_splits, min(desired_parallelism,
                                     (units + per - 1) // per) or 1)
        n_splits = (units + per - 1) // per
        return [Split(handle, p, n_splits) for p in range(max(n_splits, 1))]

    # --- data ------------------------------------------------------------
    def read_split(self, split: Split, columns: Sequence[str]) -> Batch:
        sf = SCHEMAS[split.handle.schema]
        table = split.handle.table
        handle = split.handle
        gen_cols = list(columns)
        if handle.constraint is not None:
            # generate constraint columns too, mask, then project
            for c, _ in handle.constraint.domains:
                if c not in gen_cols:
                    gen_cols.append(c)
        dev = self._read_split_device(split, sf, table, handle, gen_cols,
                                      columns)
        if dev is not None:
            return dev
        if table == "region":
            out = self._region(gen_cols)
        elif table == "nation":
            out = self._nation(gen_cols)
        else:
            if table == "lineitem":
                units = table_rows("orders", sf)
            else:
                units = table_rows(table, sf)
            lo = split.part * units // split.part_count
            hi = (split.part + 1) * units // split.part_count
            idx = np.arange(lo + 1, hi + 1, dtype=np.int64)  # 1-based
            gen = getattr(self, f"_{table}")
            out = gen(idx, sf, gen_cols)
        if handle.constraint is not None or handle.limit is not None:
            from ..predicate import filter_batch_host
            out = filter_batch_host(out, handle.constraint,
                                    handle.limit)
            out = out.select_columns(list(columns))
        return out.to(self.device)

    def _read_split_device(self, split: Split, sf: float, table: str,
                           handle, gen_cols, columns) -> Optional[Batch]:
        """Generate the split's lanes ON THE CARD when the connector's
        device is CUDA and every requested column is device-generatable
        (tpch_device.py): at sf>=10 host generation is the bottleneck —
        60M sf10 lineitem rows take minutes on the host before the first
        byte reaches device memory."""
        if self.device.type != "cuda":
            return None
        from .tpch_device import (device_columns, device_filter,
                                  lineitem_batch, orders_batch)
        allowed = device_columns(table)
        if allowed is None or not set(gen_cols) <= allowed:
            return None
        # both tables are addressed by order index
        units = table_rows("orders", sf)
        lo = split.part * units // split.part_count
        hi = (split.part + 1) * units // split.part_count
        gen = lineitem_batch if table == "lineitem" else orders_batch
        out = gen(lo, hi, sf, list(gen_cols), self.device)
        if handle.constraint is not None or handle.limit is not None:
            out = device_filter(out, handle.constraint, handle.limit)
            out = out.select_columns(list(columns))
        return out

    # --- pushdown (plugin/trino-tpch has no applyFilter in the
    # reference; ours accepts domains because masking at generation
    # time keeps host->HBM bytes down, the applyFilter contract) -------
    def apply_filter(self, handle: TableHandle, constraint):
        from ..catalog import accept_filter_pushdown
        return accept_filter_pushdown(handle, constraint)

    def apply_limit(self, handle: TableHandle, limit: int):
        from ..catalog import accept_limit_pushdown
        return accept_limit_pushdown(handle, limit)

    # --- per-table generators -------------------------------------------
    def _finish(self, cols: Dict[str, Column], n: int,
                columns: Sequence[str]) -> Batch:
        out = {name: cols[name] for name in columns}
        return pad_batch(Batch(out, n), capacity_for(n, minimum=8))

    def _region(self, columns) -> Batch:
        idx = np.arange(5, dtype=np.int64)
        cols = {
            "r_regionkey": Column(BIGINT, idx.copy(), None),
            "r_name": _strings(REGIONS, idx, VarcharType(25)),
            "r_comment": _text_column(901, idx, VarcharType(152)),
        }
        return self._finish(cols, 5, columns)

    def _nation(self, columns) -> Batch:
        idx = np.arange(25, dtype=np.int64)
        cols = {
            "n_nationkey": Column(BIGINT, idx.copy(), None),
            "n_name": _strings([n for n, _ in NATIONS], idx, VarcharType(25)),
            "n_regionkey": Column(
                BIGINT, np.asarray([r for _, r in NATIONS],
                                   dtype=np.int64), None),
            "n_comment": _text_column(902, idx, VarcharType(152)),
        }
        return self._finish(cols, 25, columns)

    def _supplier(self, idx, sf, columns) -> Batch:
        S = _SEED["supplier"]
        need = set(columns)
        n = len(idx)
        nationkey = _randint(S + 2, idx, 0, 24)
        cols: Dict[str, Column] = {}
        cols["s_suppkey"] = Column(BIGINT, idx.copy(), None)
        if "s_name" in need:
            cols["s_name"] = _fmt_key_column("Supplier#", idx,
                                             VarcharType(25))
        if "s_address" in need:
            cols["s_address"] = _alnum_column(S + 3, idx, VarcharType(40))
        cols["s_nationkey"] = Column(BIGINT, nationkey, None)
        if "s_phone" in need:
            cols["s_phone"] = _phone_column(S + 4, idx, nationkey)
        cols["s_acctbal"] = Column(
            DOUBLE, np.round(-999.99 + _uniform(S + 5, idx) * 10999.98, 2),
            None)
        if "s_comment" in need:
            # 5 per 10000 'Customer Complaints', 5 'Customer Recommends'
            # (spec 4.2.3; q16 keys off this)
            slot = _u64(S + 6, idx) % np.uint64(2000)
            cols["s_comment"] = _text_column(
                S + 7, idx, VarcharType(101),
                inject={"Customer Complaints": slot == 0,
                        "Customer Recommends": slot == 1})
        return self._finish(cols, n, columns)

    def _part(self, idx, sf, columns) -> Batch:
        S = _SEED["part"]
        need = set(columns)
        n = len(idx)
        mfgr = _randint(S + 2, idx, 1, 5)
        cols: Dict[str, Column] = {}
        cols["p_partkey"] = Column(BIGINT, idx.copy(), None)
        if "p_name" in need:
            w = [_randint(S + 10 + k, idx, 0, len(P_NAME_WORDS) - 1)
                 for k in range(5)]
            out = np.empty(n, dtype=object)
            for i in range(n):
                out[i] = " ".join(P_NAME_WORDS[int(w[k][i])]
                                  for k in range(5))
            dic, codes = StringDictionary.from_strings(list(out))
            cols["p_name"] = Column(VarcharType(55), codes, None, dic)
        if "p_mfgr" in need:
            vals = [f"Manufacturer#{m}" for m in range(1, 6)]
            cols["p_mfgr"] = _strings(vals, mfgr - 1, VarcharType(25))
        if "p_brand" in need:
            bn = _randint(S + 3, idx, 1, 5)
            vals = [f"Brand#{m}{b}" for m in range(1, 6)
                    for b in range(1, 6)]
            cols["p_brand"] = _strings(vals, (mfgr - 1) * 5 + bn - 1,
                                       VarcharType(10))
        if "p_type" in need:
            t = _randint(S + 4, idx, 0, 149)
            vals = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                    for c in TYPE_S3]
            cols["p_type"] = _strings(vals, t, VarcharType(25))
        cols["p_size"] = Column(INTEGER,
                                _randint(S + 5, idx, 1, 50)
                                .astype(np.int32), None)
        if "p_container" in need:
            c = _randint(S + 6, idx, 0, 39)
            vals = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
            cols["p_container"] = _strings(vals, c, VarcharType(10))
        cols["p_retailprice"] = Column(DOUBLE, _retailprice(idx), None)
        if "p_comment" in need:
            cols["p_comment"] = _text_column(S + 7, idx, VarcharType(23))
        return self._finish(cols, n, columns)

    def _partsupp(self, idx, sf, columns) -> Batch:
        S = _SEED["partsupp"]
        n = len(idx)
        # row i (1-based over 4*P rows) -> (partkey, supplier slot)
        partkey = (idx - 1) // 4 + 1
        slot = (idx - 1) % 4
        s_count = table_rows("supplier", sf)
        cols: Dict[str, Column] = {}
        cols["ps_partkey"] = Column(BIGINT, partkey, None)
        cols["ps_suppkey"] = Column(BIGINT,
                                    _ps_suppkey(partkey, slot, s_count),
                                    None)
        cols["ps_availqty"] = Column(
            INTEGER, _randint(S + 2, idx, 1, 9999).astype(np.int32), None)
        cols["ps_supplycost"] = Column(
            DOUBLE, np.round(1.0 + _uniform(S + 3, idx) * 999.0, 2), None)
        if "ps_comment" in set(columns):
            cols["ps_comment"] = _text_column(S + 4, idx, VarcharType(199))
        return self._finish(cols, n, columns)

    def _customer(self, idx, sf, columns) -> Batch:
        S = _SEED["customer"]
        need = set(columns)
        n = len(idx)
        nationkey = _randint(S + 2, idx, 0, 24)
        cols: Dict[str, Column] = {}
        cols["c_custkey"] = Column(BIGINT, idx.copy(), None)
        if "c_name" in need:
            cols["c_name"] = _fmt_key_column("Customer#", idx,
                                             VarcharType(25))
        if "c_address" in need:
            cols["c_address"] = _alnum_column(S + 3, idx, VarcharType(40))
        cols["c_nationkey"] = Column(BIGINT, nationkey, None)
        if "c_phone" in need:
            cols["c_phone"] = _phone_column(S + 4, idx, nationkey)
        cols["c_acctbal"] = Column(
            DOUBLE, np.round(-999.99 + _uniform(S + 5, idx) * 10999.98, 2),
            None)
        if "c_mktsegment" in need:
            seg = _randint(S + 6, idx, 0, 4)
            cols["c_mktsegment"] = _strings(SEGMENTS, seg, VarcharType(10))
        if "c_comment" in need:
            cols["c_comment"] = _text_column(S + 7, idx, VarcharType(117))
        return self._finish(cols, n, columns)

    def _orders(self, idx, sf, columns) -> Batch:
        S = _SEED["orders"]
        need = set(columns)
        n = len(idx)
        c_count = table_rows("customer", sf)
        cols: Dict[str, Column] = {}
        cols["o_orderkey"] = Column(BIGINT, _order_key(idx), None)
        cols["o_custkey"] = Column(BIGINT, _cust_key(idx, c_count), None)
        odate = _order_date(idx)
        needs_lines = need & {"o_orderstatus", "o_totalprice"}
        if needs_lines:
            # derive from this order's lineitems (spec: status/totalprice
            # are aggregates of the generated lineitems)
            counts = _line_counts(idx)
            status = np.empty(n, dtype=np.int8)
            total = np.zeros(n, dtype=np.float64)
            order_rep = np.repeat(idx, counts)
            lf = _LineFields(order_rep, _line_numbers(counts), sf)
            seg = np.repeat(np.arange(n), counts)
            price = lf.extendedprice * (1.0 + lf.tax) * (1.0 - lf.discount)
            np.add.at(total, seg, price)
            shipped = lf.shipdate <= CURRENTDATE
            n_shipped = np.zeros(n, dtype=np.int64)
            np.add.at(n_shipped, seg, shipped.astype(np.int64))
            status = np.where(n_shipped == 0, 0,
                              np.where(n_shipped == counts, 1, 2))
            if "o_orderstatus" in need:
                cols["o_orderstatus"] = _strings(
                    ["O", "F", "P"], status, VarcharType(1))
            cols["o_totalprice"] = Column(DOUBLE, np.round(total, 2), None)
        cols["o_orderdate"] = Column(DATE, odate.astype(np.int32), None)
        if "o_orderpriority" in need:
            p = _randint(S + 5, idx, 0, 4)
            cols["o_orderpriority"] = _strings(PRIORITIES, p,
                                               VarcharType(15))
        if "o_clerk" in need:
            clerk = _randint(S + 6, idx, 1,
                             max(int(1000 * max(sf, 1.0)), 1))
            cols["o_clerk"] = _fmt_key_column("Clerk#", clerk,
                                              VarcharType(15))
        cols["o_shippriority"] = Column(
            INTEGER, np.zeros(n, dtype=np.int32), None)
        if "o_comment" in need:
            # ~1.6% of order comments contain 'special ... requests' (q13)
            slot = _u64(S + 7, idx) % np.uint64(64)
            cols["o_comment"] = _text_column(
                S + 8, idx, VarcharType(79),
                inject={"special packages requests": slot == 0})
        return self._finish(cols, n, columns)

    def _lineitem(self, order_idx, sf, columns) -> Batch:
        need = set(columns)
        counts = _line_counts(order_idx)
        order_rep = np.repeat(order_idx, counts)
        lf = _LineFields(order_rep, _line_numbers(counts), sf)
        n = len(order_rep)
        S = _SEED["lineitem"]
        cols: Dict[str, Column] = {
            "l_orderkey": Column(BIGINT, lf.orderkey, None),
            "l_partkey": Column(BIGINT, lf.partkey, None),
            "l_suppkey": Column(BIGINT, lf.suppkey, None),
            "l_linenumber": Column(INTEGER,
                                   lf.linenumber.astype(np.int32), None),
            "l_quantity": Column(DOUBLE, lf.quantity, None),
            "l_extendedprice": Column(DOUBLE, lf.extendedprice, None),
            "l_discount": Column(DOUBLE, lf.discount, None),
            "l_tax": Column(DOUBLE, lf.tax, None),
            "l_shipdate": Column(DATE, lf.shipdate.astype(np.int32), None),
            "l_commitdate": Column(DATE, lf.commitdate.astype(np.int32),
                                   None),
            "l_receiptdate": Column(DATE, lf.receiptdate.astype(np.int32),
                                    None),
        }
        if "l_returnflag" in need:
            returned = lf.receiptdate <= CURRENTDATE
            ra = (_u64(S + 20, lf.rid) % np.uint64(2)).astype(np.int64)
            flag = np.where(returned, ra, 2)  # R/A else N
            cols["l_returnflag"] = _strings(["R", "A", "N"], flag,
                                            VarcharType(1))
        if "l_linestatus" in need:
            st = (lf.shipdate > CURRENTDATE).astype(np.int64)
            cols["l_linestatus"] = _strings(["F", "O"], st, VarcharType(1))
        if "l_shipinstruct" in need:
            si = _randint(S + 21, lf.rid, 0, 3)
            cols["l_shipinstruct"] = _strings(INSTRUCTIONS, si,
                                              VarcharType(25))
        if "l_shipmode" in need:
            sm = _randint(S + 22, lf.rid, 0, 6)
            cols["l_shipmode"] = _strings(MODES, sm, VarcharType(10))
        if "l_comment" in need:
            cols["l_comment"] = _text_column(S + 23, lf.rid,
                                             VarcharType(44))
        return self._finish(cols, n, columns)
