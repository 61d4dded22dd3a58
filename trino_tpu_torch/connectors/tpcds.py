"""TPC-DS data-generator connector.

Reference parity: plugin/trino-tpcds (TpcdsMetadata.java,
TpcdsRecordSetProvider.java, TpcdsSplitManager.java) — on-the-fly
deterministic TPC-DS data, the star-schema benchmark workhorse
(BASELINE.json configs[4] = q64).

Same TPU-first design as connectors/tpch.py: every value is a pure
function of ``(column_seed, absolute_row_index)`` through a splitmix64
counter hash, so any split generates its row range independently and
fully vectorized — no sequential dsdgen state. Value families
(distributions, vocabularies, key ranges) follow the TPC-DS spec v2.x;
the bit-exact dsdgen output is intentionally not reproduced.

Schema: all 24 TPC-DS tables (the three sales/returns channel pairs,
inventory, and the full dimension set through web_site/ship_mode/
reason/time_dim) with their commonly queried columns. Referential
integrity: every foreign key is drawn from the referenced table's live
key range; returns reference actual sales rows by strided index so
(item_sk, ticket/order) pairs join.

Counterpart of ``trino_tpu/connectors/tpcds.py``: the same numpy
generators, row for row; each split is generated on the host and
returned on the connector's device (``cuda`` unless the caller asks for
the CPU). There is no device generator for TPC-DS.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..catalog import (ColumnMetadata as CM, Connector, Split, TableHandle,
                       TableMetadata)
from ..columnar import Batch, Column, StringDictionary, pad_batch
from ..config import DeviceLike, capacity_for, resolve_device
from ..types import BIGINT, DATE, DOUBLE, INTEGER, Type, VarcharType
from .tpch import _mix, _u64, _randint, _uniform, _strings

_EPOCH = datetime.date(1970, 1, 1).toordinal()

# d_date_sk numbering: Julian-day style; sk 2415022 == 1900-01-02
_SK0 = 2415022
_D0 = datetime.date(1900, 1, 2).toordinal()
_N_DATES = 73049  # 1900-01-02 .. 2100-01-01, fixed at every SF


def _date_sk(y: int, m: int, d: int) -> int:
    return _SK0 + (datetime.date(y, m, d).toordinal() - _D0)


_SALES_SK_LO = _date_sk(1998, 1, 1)
_SALES_SK_HI = _date_sk(2002, 12, 31)

SCHEMAS: Dict[str, float] = {
    "tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0,
}

# spec row counts at known scale points (TpcdsScaling); geometric
# interpolation elsewhere. None -> fixed count at every scale.
_SCALE_POINTS = {
    "store_sales":           {0.01: 120527, 1: 2880404, 10: 28800991,
                              100: 287997024},
    "store_returns":         {0.01: 11925, 1: 287514, 10: 2875432,
                              100: 28795080},
    "catalog_sales":         {0.01: 89807, 1: 1441548, 10: 14401261,
                              100: 143997065},
    "catalog_returns":       {0.01: 8923, 1: 144067, 10: 1439749,
                              100: 14404374},
    "item":                  {0.01: 2000, 1: 18000, 10: 102000,
                              100: 204000},
    "customer":              {0.01: 1000, 1: 100000, 10: 500000,
                              100: 2000000},
    "customer_address":      {0.01: 1000, 1: 50000, 10: 250000,
                              100: 1000000},
    "customer_demographics": {0.01: 19208, 1: 1920800, 10: 1920800,
                              100: 1920800},
    "store":                 {0.01: 2, 1: 12, 10: 102, 100: 402},
    "promotion":             {0.01: 30, 1: 300, 10: 500, 100: 1000},
    "warehouse":             {0.01: 1, 1: 5, 10: 10, 100: 15},
    "web_sales":             {0.01: 7198, 1: 719384, 10: 7197566,
                              100: 71997522},
    "web_returns":           {0.01: 718, 1: 71763, 10: 719217,
                              100: 7197670},
    "web_site":              {0.01: 2, 1: 30, 10: 42, 100: 54},
    "web_page":              {0.01: 2, 1: 60, 10: 200, 100: 2040},
    "inventory":             {0.01: 117450, 1: 11745000, 10: 133110000,
                              100: 399330000},
    "call_center":           {0.01: 2, 1: 6, 10: 24, 100: 30},
    "catalog_page":          {0.01: 11718, 1: 11718, 10: 12000,
                              100: 20400},
    "reason":                {0.01: 35, 1: 35, 10: 60, 100: 70},
    "household_demographics": None,   # 7200 fixed
    "income_band":           None,    # 20 fixed
    "date_dim":              None,    # 73049 fixed
    "time_dim":              None,    # 86400 fixed
    "ship_mode":             None,    # 20 fixed
}
_FIXED_ROWS = {"household_demographics": 7200, "income_band": 20,
               "date_dim": _N_DATES, "time_dim": 86400,
               "ship_mode": 20}


def table_rows(table: str, sf: float) -> int:
    pts = _SCALE_POINTS[table]
    if pts is None:
        return _FIXED_ROWS[table]
    if sf in pts:
        return pts[sf]
    keys = sorted(pts)
    if sf <= keys[0]:
        return max(1, int(pts[keys[0]] * sf / keys[0]))
    for lo, hi in zip(keys, keys[1:]):
        if sf <= hi:
            # geometric interpolation in log-sf space
            import math
            t = (math.log(sf) - math.log(lo)) / (
                math.log(hi) - math.log(lo))
            return int(pts[lo] * (pts[hi] / pts[lo]) ** t)
    return int(pts[keys[-1]] * sf / keys[-1])


# --------------------------------------------------------------------------
# vocabularies (spec-style value families)
# --------------------------------------------------------------------------

COLORS = ("purple burlywood indian spring floral medium almond antique "
          "aquamarine azure beige bisque black blanched blue blush brown "
          "chartreuse chiffon chocolate coral cornflower cornsilk cream "
          "cyan dark deep dim dodger drab firebrick forest frosted "
          "gainsboro ghost goldenrod green grey honeydew hot ivory khaki "
          "lace lavender lawn lemon light lime linen magenta maroon "
          "metallic midnight mint misty moccasin navajo navy olive orange "
          "orchid pale papaya peach peru pink plum powder puff red rose "
          "rosy royal saddle salmon sandy seashell sienna sky slate smoke "
          "snow steel tan thistle tomato turquoise violet wheat white "
          "yellow").split()

_UNITS = ("Unknown ought able pri ese anti cally ation eing n st").split()
_STREET_NAMES = ("Main Oak Park First Second Elm Lake Hill Maple Pine "
                 "Cedar Ridge Spring View Walnut Washington Wilson "
                 "Church College Davis Dogwood Fifth Forest Fourth "
                 "Franklin Green Highland Jackson Johnson Lee Lincoln "
                 "Locust Meadow Mill North Poplar railroad River Smith "
                 "South Sunset Sycamore Third Valley West Williams "
                 "Woodland 1st 2nd 3rd 4th 5th 6th 7th 8th 9th 10th "
                 "11th 12th 13th 14th 15th").split()
_STREET_TYPES = ("Street Ave Blvd Boulevard Circle Court Ct Dr Drive "
                 "Lane Ln Parkway Pkwy RD Road ST Way Wy").split()
_CITIES = ("Midway Fairview Oakland Five_Points Oak_Grove Pleasant_Hill "
           "Centerville Liberty Salem Greenville Bethel Clinton "
           "Springfield Marion Union Wilson Glendale Antioch Concord "
           "Enterprise Farmington Five_Forks Friendship Georgetown "
           "Glenwood Greenfield Greenwood Hamilton Harmony Highland_Park "
           "Hillcrest Hopewell Jackson Jamestown Kingston Lakeside "
           "Lakeview Lebanon Lincoln Macedonia Maple_Grove Mount_Olive "
           "Mount_Pleasant Mount_Vernon Mount_Zion New_Hope Newport "
           "Newtown Oakdale Oakwood Philadelphia Pine_Grove Pleasant_"
           "Grove Pleasant_Valley Plainview Providence Riverdale "
           "Riverside Riverview Shady_Grove Shiloh Spring_Hill "
           "Spring_Valley Stringtown Summit Sunnyside Unionville "
           "Valley_View Walnut_Grove Waterloo Westgate White_Oak "
           "Wildwood Woodland Woodlawn Woodville").split()
_MARITAL = ["M", "S", "D", "W", "U"]
_GENDER = ["M", "F"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                  "0-500", "Unknown"]
_PROMO_CHANNELS = ["N", "Y"]
_CATEGORIES = ["Women", "Men", "Children", "Shoes", "Music", "Jewelry",
               "Home", "Sports", "Books", "Electronics"]
_P_NAMES = ("ese anti pri ought able eing cally ation n st bar ation "
            "eingoughtable callyought ableought").split()


def _zip_strings(seed: int, idx: np.ndarray, typ: Type) -> Column:
    z = (_u64(seed, idx) % np.uint64(100000)).astype(np.int64)
    vals = [f"{v:05d}" for v in range(0, 100000, 97)]
    # snap to a bounded dictionary (zips repeat heavily in reality)
    codes = (z % np.uint64(len(vals))).astype(np.int32)
    return _strings(vals, codes, typ)


def _word_column(seed: int, idx: np.ndarray, words: List[str],
                 n_words: int, typ: Type) -> Column:
    picks = [_randint(seed + k, idx, 0, len(words) - 1)
             for k in range(n_words)]
    out = np.empty(len(idx), dtype=object)
    for i in range(len(idx)):
        out[i] = " ".join(words[int(picks[k][i])] for k in range(n_words))
    dic, codes = StringDictionary.from_strings(list(out))
    return Column(typ, codes, None, dic)


def _key_name_column(prefix: str, idx: np.ndarray, typ: Type) -> Column:
    out = np.empty(len(idx), dtype=object)
    for i in range(len(idx)):
        out[i] = f"{prefix}{int(idx[i]):016d}"
    dic, codes = StringDictionary.from_strings(list(out))
    return Column(typ, codes, None, dic)


# seed order is FROZEN for the original 14 tables (reordering would
# silently regenerate every dataset); new tables append after them
_SEED_ORDER = [
    "catalog_returns", "catalog_sales", "customer", "customer_address",
    "customer_demographics", "date_dim", "household_demographics",
    "income_band", "item", "promotion", "store", "store_returns",
    "store_sales", "warehouse",
    # round-4 additions
    "web_sales", "web_returns", "web_site", "web_page", "inventory",
    "time_dim", "reason", "ship_mode", "call_center", "catalog_page",
]
_SEED = {t: 1000 + 31 * i for i, t in enumerate(_SEED_ORDER)}


def _fk(seed: int, idx: np.ndarray, n_ref: int,
        null_frac: float = 0.0):
    """Foreign key into [1, n_ref]; optional NULL fraction."""
    k = 1 + (_u64(seed, idx) % np.uint64(max(n_ref, 1))).astype(np.int64)
    if null_frac <= 0.0:
        return k, None
    valid = _uniform(seed + 7777, idx) >= null_frac
    return k, valid


def _price(seed: int, idx: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return np.round(lo + _uniform(seed, idx) * (hi - lo), 2)


class TpcdsConnector(Connector):
    name = "tpcds"
    scan_cache_ok = True      # pure generator: splits are immutable

    def __init__(self, rows_per_split: int = 1 << 17,
                 device: DeviceLike = None):
        self.rows_per_split = rows_per_split
        # splits are generated on the host and returned on this device
        self.device = resolve_device(device)

    # --- metadata --------------------------------------------------------
    def list_schemas(self) -> List[str]:
        return list(SCHEMAS)

    def list_tables(self, schema: str) -> List[str]:
        return sorted(_SCALE_POINTS) if schema in SCHEMAS else []

    def get_table_metadata(self, schema, table) -> Optional[TableMetadata]:
        if schema in SCHEMAS and table in _TABLES:
            return TableMetadata(schema, table, tuple(_TABLES[table]))
        return None

    def table_row_count(self, handle: TableHandle) -> Optional[float]:
        return float(table_rows(handle.table, SCHEMAS[handle.schema]))

    # --- splits ----------------------------------------------------------
    def get_splits(self, handle: TableHandle,
                   desired_parallelism: int = 1) -> List[Split]:
        sf = SCHEMAS[handle.schema]
        units = table_rows(handle.table, sf)
        per = self.rows_per_split
        n_splits = max(1, (units + per - 1) // per)
        return [Split(handle, p, n_splits) for p in range(n_splits)]

    # --- data ------------------------------------------------------------
    def read_split(self, split: Split, columns: Sequence[str]) -> Batch:
        sf = SCHEMAS[split.handle.schema]
        table = split.handle.table
        units = table_rows(table, sf)
        lo = split.part * units // split.part_count
        hi = (split.part + 1) * units // split.part_count
        idx = np.arange(lo + 1, hi + 1, dtype=np.int64)  # 1-based keys
        gen = getattr(self, "_" + table)
        return gen(idx, sf, columns).to(self.device)

    def _finish(self, cols: Dict[str, Column], n: int,
                columns: Sequence[str]) -> Batch:
        out = {name: cols[name] for name in columns}
        return pad_batch(Batch(out, n), capacity_for(n, minimum=8))

    # --- dimension tables ------------------------------------------------
    def _date_dim(self, idx, sf, columns) -> Batch:
        need = set(columns)
        ords = _D0 + (idx - 1)
        days = ords - _EPOCH
        # vectorized calendar via numpy datetime64
        d64 = days.astype("datetime64[D]")
        y = d64.astype("datetime64[Y]").astype(np.int64) + 1970
        m64 = d64.astype("datetime64[M]")
        moy = (m64.astype(np.int64) % 12) + 1
        dom = (d64 - m64.astype("datetime64[D]")).astype(np.int64) + 1
        cols: Dict[str, Column] = {
            "d_date_sk": Column(BIGINT, _SK0 + (idx - 1), None),
            "d_date": Column(DATE, days.astype(np.int64), None),
            "d_year": Column(INTEGER, y.astype(np.int64), None),
            "d_moy": Column(INTEGER, moy.astype(np.int64), None),
            "d_dom": Column(INTEGER, dom.astype(np.int64), None),
            "d_qoy": Column(INTEGER, ((moy - 1) // 3 + 1), None),
            "d_dow": Column(INTEGER, (days + 4) % 7, None),
        }
        if "d_month_seq" in need:
            cols["d_month_seq"] = Column(
                BIGINT, (y - 1900) * 12 + (moy - 1), None)
        if "d_week_seq" in need:
            cols["d_week_seq"] = Column(BIGINT, (days + 4) // 7, None)
        if "d_day_name" in need:
            names = ["Sunday", "Monday", "Tuesday", "Wednesday",
                     "Thursday", "Friday", "Saturday"]
            cols["d_day_name"] = _strings(
                names, ((days + 4) % 7).astype(np.int32), VarcharType(9))
        if "d_quarter_name" in need:
            y0, y1 = int(y.min()), int(y.max())
            vals = [f"{yy}Q{q}" for yy in range(y0, y1 + 1)
                    for q in range(1, 5)]
            codes = ((y - y0) * 4 + (moy - 1) // 3).astype(np.int32)
            cols["d_quarter_name"] = _strings(vals, codes,
                                              VarcharType(6))
        return self._finish(cols, len(idx), columns)

    def _item(self, idx, sf, columns) -> Batch:
        S = _SEED["item"]
        need = set(columns)
        n = len(idx)
        cols: Dict[str, Column] = {
            "i_item_sk": Column(BIGINT, idx.copy(), None)}
        if "i_item_id" in need:
            cols["i_item_id"] = _key_name_column("AAAAAAAA", idx,
                                                 VarcharType(16))
        if "i_product_name" in need:
            cols["i_product_name"] = _word_column(
                S + 2, idx, _P_NAMES, 4, VarcharType(50))
        if "i_item_desc" in need:
            cols["i_item_desc"] = _word_column(
                S + 13, idx, _P_NAMES, 8, VarcharType(200))
        if "i_color" in need:
            cols["i_color"] = _strings(
                COLORS,
                (_u64(S + 3, idx) % np.uint64(len(COLORS))).astype(
                    np.int32), VarcharType(20))
        cols["i_current_price"] = Column(
            DOUBLE, _price(S + 4, idx, 0.09, 99.99), None)
        cols["i_wholesale_cost"] = Column(
            DOUBLE, _price(S + 5, idx, 0.05, 70.0), None)
        if "i_brand_id" in need or "i_brand" in need:
            brand_id = _randint(S + 6, idx, 1, 1000)
            cols["i_brand_id"] = Column(BIGINT, brand_id, None)
            if "i_brand" in need:
                vals = [f"{_UNITS[b % 10]}{_UNITS[(b // 10) % 10]} #{b}"
                        for b in range(1, 1001)]
                cols["i_brand"] = _strings(
                    vals, (brand_id - 1).astype(np.int32), VarcharType(50))
        if "i_manufact_id" in need or "i_manufact" in need:
            mid = _randint(S + 7, idx, 1, 1000)
            cols["i_manufact_id"] = Column(BIGINT, mid, None)
            if "i_manufact" in need:
                vals = [f"{_UNITS[m % 10]}{_UNITS[(m // 10) % 10]}"
                        for m in range(1, 1001)]
                cols["i_manufact"] = _strings(
                    vals, (mid - 1).astype(np.int32), VarcharType(50))
        if "i_category" in need or "i_category_id" in need:
            cid = _randint(S + 8, idx, 1, len(_CATEGORIES))
            cols["i_category_id"] = Column(BIGINT, cid, None)
            cols["i_category"] = _strings(
                _CATEGORIES, (cid - 1).astype(np.int32), VarcharType(50))
        if "i_class_id" in need or "i_class" in need:
            clid = _randint(S + 9, idx, 1, 16)
            cols["i_class_id"] = Column(BIGINT, clid, None)
            if "i_class" in need:
                vals = [f"class#{c}" for c in range(1, 17)]
                cols["i_class"] = _strings(
                    vals, (clid - 1).astype(np.int32), VarcharType(50))
        if "i_manager_id" in need:
            cols["i_manager_id"] = Column(
                BIGINT, _randint(S + 10, idx, 1, 100), None)
        if "i_size" in need:
            sizes = ["petite", "small", "medium", "large", "extra large",
                     "N/A"]
            cols["i_size"] = _strings(
                sizes, (_u64(S + 11, idx) % np.uint64(6)).astype(np.int32),
                VarcharType(20))
        if "i_units" in need:
            units = ["Each", "Dozen", "Case", "Pallet", "Gross", "Box",
                     "Pound", "Ounce", "Ton", "Unknown"]
            cols["i_units"] = _strings(
                units, (_u64(S + 12, idx) % np.uint64(10)).astype(
                    np.int32), VarcharType(10))
        return self._finish(cols, n, columns)

    def _customer(self, idx, sf, columns) -> Batch:
        S = _SEED["customer"]
        need = set(columns)
        n = len(idx)
        n_cd = table_rows("customer_demographics", sf)
        n_hd = table_rows("household_demographics", sf)
        n_ca = table_rows("customer_address", sf)
        cols: Dict[str, Column] = {
            "c_customer_sk": Column(BIGINT, idx.copy(), None)}
        if "c_customer_id" in need:
            cols["c_customer_id"] = _key_name_column(
                "AAAAAAAA", idx, VarcharType(16))
        for name, nref, s in (("c_current_cdemo_sk", n_cd, 2),
                              ("c_current_hdemo_sk", n_hd, 3),
                              ("c_current_addr_sk", n_ca, 4)):
            k, v = _fk(S + s, idx, nref, null_frac=0.02)
            cols[name] = Column(BIGINT, k, v)
        for name, s in (("c_first_sales_date_sk", 5),
                        ("c_first_shipto_date_sk", 6)):
            sk = _randint(S + s, idx, _date_sk(1990, 1, 1),
                          _date_sk(2002, 12, 31))
            cols[name] = Column(BIGINT, sk, None)
        if "c_first_name" in need:
            names = [f"First{i}" for i in range(512)]
            cols["c_first_name"] = _strings(
                names, (_u64(S + 8, idx) % np.uint64(512)).astype(
                    np.int32), VarcharType(20))
        if "c_last_name" in need:
            names = [f"Last{i}" for i in range(1024)]
            cols["c_last_name"] = _strings(
                names, (_u64(S + 9, idx) % np.uint64(1024)).astype(
                    np.int32), VarcharType(30))
        if "c_birth_year" in need:
            cols["c_birth_year"] = Column(
                INTEGER, _randint(S + 10, idx, 1924, 1992), None)
        if "c_birth_month" in need:
            cols["c_birth_month"] = Column(
                INTEGER, _randint(S + 12, idx, 1, 12), None)
        if "c_birth_day" in need:
            cols["c_birth_day"] = Column(
                INTEGER, _randint(S + 13, idx, 1, 28), None)
        if "c_preferred_cust_flag" in need:
            cols["c_preferred_cust_flag"] = _strings(
                ["N", "Y"],
                (_u64(S + 14, idx) % np.uint64(2)).astype(np.int32),
                VarcharType(1))
        if "c_salutation" in need:
            sal = ["Mr.", "Mrs.", "Ms.", "Miss", "Dr.", "Sir"]
            cols["c_salutation"] = _strings(
                sal, (_u64(S + 15, idx) % np.uint64(6)).astype(np.int32),
                VarcharType(10))
        if "c_email_address" in need:
            cols["c_email_address"] = _key_name_column(
                "Customer@example.", idx, VarcharType(50))
        if "c_last_review_date_sk" in need:
            cols["c_last_review_date_sk"] = Column(
                BIGINT, _randint(S + 16, idx, _date_sk(1999, 1, 1),
                                 _date_sk(2002, 12, 31)), None)
        if "c_birth_country" in need:
            from .tpch import NATIONS
            vals = [n0.upper() for n0, _ in NATIONS]
            cols["c_birth_country"] = _strings(
                vals, (_u64(S + 11, idx) % np.uint64(len(vals))).astype(
                    np.int32), VarcharType(20))
        return self._finish(cols, n, columns)

    def _customer_address(self, idx, sf, columns) -> Batch:
        S = _SEED["customer_address"]
        n = len(idx)
        cols: Dict[str, Column] = {
            "ca_address_sk": Column(BIGINT, idx.copy(), None)}
        num_vals = [str(v) for v in range(1, 1001)]
        cols["ca_street_number"] = _strings(
            num_vals, (_u64(S + 2, idx) % np.uint64(1000)).astype(
                np.int32), VarcharType(10))
        sn = (_u64(S + 3, idx)
              % np.uint64(len(_STREET_NAMES))).astype(np.int64)
        st = (_u64(S + 4, idx)
              % np.uint64(len(_STREET_TYPES))).astype(np.int64)
        vals = [f"{a} {b}" for a in _STREET_NAMES for b in _STREET_TYPES]
        codes = (sn * len(_STREET_TYPES) + st).astype(np.int32)
        cols["ca_street_name"] = _strings(vals, codes, VarcharType(60))
        cols["ca_city"] = _strings(
            [c.replace("_", " ") for c in _CITIES],
            (_u64(S + 5, idx) % np.uint64(len(_CITIES))).astype(np.int32),
            VarcharType(60))
        cols["ca_zip"] = _zip_strings(S + 6, idx, VarcharType(10))
        cols["ca_state"] = _strings(
            ["AL", "CA", "GA", "IL", "IN", "KS", "KY", "LA", "MI", "MN",
             "MO", "MS", "NC", "NE", "NY", "OH", "OK", "OR", "PA", "SC",
             "TN", "TX", "VA", "WA", "WV"],
            (_u64(S + 7, idx) % np.uint64(25)).astype(np.int32),
            VarcharType(2))
        cols["ca_country"] = _strings(
            ["United States"], np.zeros(n, np.int32), VarcharType(20))
        cols["ca_county"] = _strings(
            ["Williamson County", "Ziebach County", "Walker County",
             "Daviess County", "Barrow County", "Franklin Parish",
             "Luce County", "Richland County", "Furnas County",
             "Maverick County"],
            (_u64(S + 8, idx) % np.uint64(10)).astype(np.int32),
            VarcharType(30))
        cols["ca_gmt_offset"] = Column(
            DOUBLE, -5.0 - (_u64(S + 9, idx)
                            % np.uint64(4)).astype(np.int64), None)
        cols["ca_street_type"] = _strings(
            _STREET_TYPES,
            (_u64(S + 10, idx)
             % np.uint64(len(_STREET_TYPES))).astype(np.int32),
            VarcharType(15))
        cols["ca_suite_number"] = _strings(
            [f"Suite {v}" for v in range(0, 100, 10)],
            (_u64(S + 11, idx) % np.uint64(10)).astype(np.int32),
            VarcharType(10))
        cols["ca_location_type"] = _strings(
            ["apartment", "condo", "single family"],
            (_u64(S + 12, idx) % np.uint64(3)).astype(np.int32),
            VarcharType(20))
        return self._finish(cols, n, columns)

    def _customer_demographics(self, idx, sf, columns) -> Batch:
        # fully cross-joined demographic space, decoded from the key
        # (spec: cd is the cross product of its attribute domains)
        n = len(idx)
        k = idx - 1
        cols: Dict[str, Column] = {
            "cd_demo_sk": Column(BIGINT, idx.copy(), None)}
        g = (k % 2).astype(np.int32)
        k2 = k // 2
        ms = (k2 % 5).astype(np.int32)
        k3 = k2 // 5
        ed = (k3 % 7).astype(np.int32)
        k4 = k3 // 7
        cols["cd_gender"] = _strings(_GENDER, g, VarcharType(1))
        cols["cd_marital_status"] = _strings(_MARITAL, ms, VarcharType(1))
        cols["cd_education_status"] = _strings(_EDUCATION, ed,
                                               VarcharType(20))
        cols["cd_purchase_estimate"] = Column(
            BIGINT, ((k4 % 20) + 1) * 500, None)
        cols["cd_credit_rating"] = _strings(
            _CREDIT, ((k4 // 20) % 4).astype(np.int32), VarcharType(10))
        cols["cd_dep_count"] = Column(BIGINT, (k4 // 80) % 7, None)
        cols["cd_dep_employed_count"] = Column(
            BIGINT, (k4 // 560) % 7, None)
        cols["cd_dep_college_count"] = Column(
            BIGINT, (k4 // 3920) % 7, None)
        return self._finish(cols, n, columns)

    def _household_demographics(self, idx, sf, columns) -> Batch:
        n = len(idx)
        k = idx - 1
        cols: Dict[str, Column] = {
            "hd_demo_sk": Column(BIGINT, idx.copy(), None)}
        cols["hd_income_band_sk"] = Column(BIGINT, (k % 20) + 1, None)
        cols["hd_buy_potential"] = _strings(
            _BUY_POTENTIAL, ((k // 20) % 6).astype(np.int32),
            VarcharType(15))
        cols["hd_dep_count"] = Column(BIGINT, (k // 120) % 10, None)
        cols["hd_vehicle_count"] = Column(BIGINT, (k // 1200) % 6 - 1,
                                          None)
        return self._finish(cols, n, columns)

    def _income_band(self, idx, sf, columns) -> Batch:
        n = len(idx)
        cols = {
            "ib_income_band_sk": Column(BIGINT, idx.copy(), None),
            "ib_lower_bound": Column(BIGINT, (idx - 1) * 10000, None),
            "ib_upper_bound": Column(BIGINT, idx * 10000 - 1, None),
        }
        return self._finish(cols, n, columns)

    def _store(self, idx, sf, columns) -> Batch:
        S = _SEED["store"]
        n = len(idx)
        cols: Dict[str, Column] = {
            "s_store_sk": Column(BIGINT, idx.copy(), None)}
        cols["s_store_id"] = _key_name_column("AAAAAAAA", idx,
                                              VarcharType(16))
        names = [f"{u}" for u in _UNITS]
        cols["s_store_name"] = _strings(
            names, ((idx - 1) % len(names)).astype(np.int32),
            VarcharType(50))
        cols["s_zip"] = _zip_strings(S + 3, idx, VarcharType(10))
        cols["s_state"] = _strings(
            ["TN", "OH", "TX", "GA", "IL"],
            (_u64(S + 4, idx) % np.uint64(5)).astype(np.int32),
            VarcharType(2))
        cols["s_city"] = _strings(
            [c.replace("_", " ") for c in _CITIES[:20]],
            (_u64(S + 5, idx) % np.uint64(20)).astype(np.int32),
            VarcharType(60))
        cols["s_number_employees"] = Column(
            BIGINT, _randint(S + 6, idx, 200, 300), None)
        cols["s_county"] = _strings(
            ["Williamson County", "Ziebach County", "Walker County",
             "Daviess County", "Barrow County"],
            (_u64(S + 7, idx) % np.uint64(5)).astype(np.int32),
            VarcharType(30))
        cols["s_company_name"] = _strings(
            ["Unknown"], np.zeros(n, np.int32), VarcharType(50))
        cols["s_company_id"] = Column(BIGINT, np.ones(n, np.int64),
                                      None)
        cols["s_market_id"] = Column(
            BIGINT, _randint(S + 12, idx, 1, 10), None)
        cols["s_street_number"] = _strings(
            [str(v) for v in range(1, 1001)],
            (_u64(S + 8, idx) % np.uint64(1000)).astype(np.int32),
            VarcharType(10))
        sn = (_u64(S + 9, idx)
              % np.uint64(len(_STREET_NAMES))).astype(np.int32)
        cols["s_street_name"] = _strings(_STREET_NAMES, sn,
                                         VarcharType(60))
        cols["s_street_type"] = _strings(
            _STREET_TYPES,
            (_u64(S + 10, idx)
             % np.uint64(len(_STREET_TYPES))).astype(np.int32),
            VarcharType(15))
        cols["s_suite_number"] = _strings(
            [f"Suite {v}" for v in range(0, 100, 10)],
            (_u64(S + 11, idx) % np.uint64(10)).astype(np.int32),
            VarcharType(10))
        return self._finish(cols, n, columns)

    def _promotion(self, idx, sf, columns) -> Batch:
        S = _SEED["promotion"]
        n = len(idx)
        cols: Dict[str, Column] = {
            "p_promo_sk": Column(BIGINT, idx.copy(), None)}
        cols["p_promo_id"] = _key_name_column("AAAAAAAA", idx,
                                              VarcharType(16))
        for cname, s in (("p_channel_dmail", 2), ("p_channel_email", 3),
                         ("p_channel_tv", 4), ("p_channel_event", 5),
                         ("p_channel_catalog", 6)):
            cols[cname] = _strings(
                _PROMO_CHANNELS,
                (_u64(S + s, idx) % np.uint64(2)).astype(np.int32),
                VarcharType(1))
        cols["p_cost"] = Column(DOUBLE, _price(S + 7, idx, 500.0, 2000.0),
                                None)
        return self._finish(cols, n, columns)

    def _warehouse(self, idx, sf, columns) -> Batch:
        S = _SEED["warehouse"]
        n = len(idx)
        cols = {
            "w_warehouse_sk": Column(BIGINT, idx.copy(), None),
            "w_warehouse_name": _key_name_column("Warehouse#", idx,
                                                 VarcharType(20)),
            "w_warehouse_sq_ft": Column(
                BIGINT, _randint(S + 2, idx, 50000, 1000000), None),
            "w_city": _strings(
                [c.replace("_", " ") for c in _CITIES[:20]],
                (_u64(S + 3, idx) % np.uint64(20)).astype(np.int32),
                VarcharType(60)),
            "w_county": _strings(
                ["Williamson County", "Ziebach County", "Walker County",
                 "Daviess County", "Barrow County"],
                (_u64(S + 4, idx) % np.uint64(5)).astype(np.int32),
                VarcharType(30)),
            "w_state": _strings(
                ["TN", "OH", "TX", "GA", "IL"],
                (_u64(S + 5, idx) % np.uint64(5)).astype(np.int32),
                VarcharType(2)),
            "w_country": _strings(
                ["United States"], np.zeros(n, np.int32),
                VarcharType(20)),
        }
        return self._finish(cols, n, columns)

    def _time_dim(self, idx, sf, columns) -> Batch:
        """One row per second of day: sk 0..86399 (spec time_dim)."""
        n = len(idx)
        t = idx - 1                       # 0-based seconds
        hour = t // 3600
        minute = (t // 60) % 60
        second = t % 60
        cols: Dict[str, Column] = {
            "t_time_sk": Column(BIGINT, t.copy(), None),
            "t_time": Column(BIGINT, t.copy(), None),
            "t_hour": Column(BIGINT, hour, None),
            "t_minute": Column(BIGINT, minute, None),
            "t_second": Column(BIGINT, second, None),
        }
        cols["t_am_pm"] = _strings(
            ["AM", "PM"], (hour >= 12).astype(np.int32), VarcharType(2))
        meal = np.select(
            [(hour >= 6) & (hour <= 8), (hour >= 11) & (hour <= 13),
             (hour >= 17) & (hour <= 19)],
            [1, 2, 3], default=0).astype(np.int32)
        cols["t_meal_time"] = Column(
            VarcharType(20),
            meal,
            meal > 0,
            StringDictionary(np.asarray(
                ["", "breakfast", "lunch", "dinner"], dtype=object)))
        return self._finish(cols, n, columns)

    def _reason(self, idx, sf, columns) -> Batch:
        n = len(idx)
        descs = ["Package was damaged", "Stopped working",
                 "Did not get it on time", "Not the product that was "
                 "ordred", "Parts missing", "Does not work with a "
                 "product that I have", "Gift exchange", "Did not like "
                 "the color", "Did not like the model", "Did not like "
                 "the make", "Did not fit", "Wrong size", "Lost my job",
                 "unauthoized purchase", "Found a better price in a "
                 "store", "Found a better extension in a store",
                 "No service location in my area", "Duplicate purchase",
                 "Its the best", "Did not like the warranty",
                 "reason 21", "reason 22", "reason 23", "reason 24",
                 "reason 25", "reason 26", "reason 27", "reason 28",
                 "reason 29", "reason 30", "reason 31", "reason 32",
                 "reason 33", "reason 34", "reason 35"]
        cols = {
            "r_reason_sk": Column(BIGINT, idx.copy(), None),
            "r_reason_id": _key_name_column("AAAAAAAA", idx,
                                            VarcharType(16)),
            "r_reason_desc": _strings(
                descs, ((idx - 1) % len(descs)).astype(np.int32),
                VarcharType(100)),
        }
        return self._finish(cols, n, columns)

    def _ship_mode(self, idx, sf, columns) -> Batch:
        n = len(idx)
        types = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR",
                 "TWO DAY"]
        carriers = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS",
                    "ZHOU", "ZOUROS", "MSC", "LATVIAN", "DIAMOND",
                    "BARIAN", "ALLIANCE", "ORIENTAL", "BOXBUNDLES",
                    "GREAT EASTERN", "HARMSTORF", "PRIVATECARRIER",
                    "GERMA", "RUPEKSA"]
        cols = {
            "sm_ship_mode_sk": Column(BIGINT, idx.copy(), None),
            "sm_ship_mode_id": _key_name_column("AAAAAAAA", idx,
                                                VarcharType(16)),
            "sm_type": _strings(
                types, ((idx - 1) % 5).astype(np.int32), VarcharType(30)),
            "sm_carrier": _strings(
                carriers, ((idx - 1) % 20).astype(np.int32),
                VarcharType(20)),
            "sm_code": _strings(
                ["AIR", "SURFACE", "SEA", "LIBRARY"],
                ((idx - 1) % 4).astype(np.int32), VarcharType(10)),
        }
        return self._finish(cols, n, columns)

    def _call_center(self, idx, sf, columns) -> Batch:
        S = _SEED["call_center"]
        n = len(idx)
        names = ["NY Metro", "Mid Atlantic", "Mideast", "North Midwest",
                 "Pacific Northwest", "Southwest", "California",
                 "Hawaii/Alaska", "Northeast", "Southeast"]
        cols = {
            "cc_call_center_sk": Column(BIGINT, idx.copy(), None),
            "cc_call_center_id": _key_name_column("AAAAAAAA", idx,
                                                  VarcharType(16)),
            "cc_name": _strings(
                names, ((idx - 1) % len(names)).astype(np.int32),
                VarcharType(50)),
            "cc_manager": _word_column(S + 2, idx, _P_NAMES, 2,
                                       VarcharType(40)),
            "cc_county": _strings(
                ["Williamson County", "Ziebach County", "Walker County",
                 "Daviess County", "Barrow County"],
                (_u64(S + 3, idx) % np.uint64(5)).astype(np.int32),
                VarcharType(30)),
        }
        return self._finish(cols, n, columns)

    def _catalog_page(self, idx, sf, columns) -> Batch:
        n = len(idx)
        cols = {
            "cp_catalog_page_sk": Column(BIGINT, idx.copy(), None),
            "cp_catalog_page_id": _key_name_column("AAAAAAAA", idx,
                                                   VarcharType(16)),
            "cp_catalog_number": Column(
                BIGINT, (idx - 1) // 108 + 1, None),
            "cp_catalog_page_number": Column(
                BIGINT, (idx - 1) % 108 + 1, None),
        }
        return self._finish(cols, n, columns)

    def _web_site(self, idx, sf, columns) -> Batch:
        n = len(idx)
        names = [f"site_{i}" for i in range(40)]
        cols = {
            "web_site_sk": Column(BIGINT, idx.copy(), None),
            "web_site_id": _key_name_column("AAAAAAAA", idx,
                                            VarcharType(16)),
            "web_name": _strings(
                names, ((idx - 1) % len(names)).astype(np.int32),
                VarcharType(50)),
            "web_company_name": _strings(
                ["pri", "ought", "able", "ese", "anti", "cally"],
                ((idx - 1) % 6).astype(np.int32), VarcharType(50)),
        }
        return self._finish(cols, n, columns)

    def _web_page(self, idx, sf, columns) -> Batch:
        S = _SEED["web_page"]
        n = len(idx)
        cols = {
            "wp_web_page_sk": Column(BIGINT, idx.copy(), None),
            "wp_web_page_id": _key_name_column("AAAAAAAA", idx,
                                               VarcharType(16)),
            "wp_char_count": Column(
                BIGINT, _randint(S + 2, idx, 100, 8000), None),
        }
        return self._finish(cols, n, columns)

    def _inventory(self, idx, sf, columns) -> Batch:
        """Weekly stock levels: key decodes to (week, item, warehouse);
        inv_date_sk steps 7 days from 1998-01-01 (spec: one snapshot
        per week over the sales window)."""
        S = _SEED["inventory"]
        n = len(idx)
        n_item = table_rows("item", sf)
        n_wh = table_rows("warehouse", sf)
        k = idx - 1
        # week varies FASTEST so every scale factor covers the whole
        # 5-year window (261 weekly snapshots) — with item-fastest
        # decode, small scales stop in early 1999 and date-filtered
        # queries (q37/q82/q21/q22) go empty at tiny
        week = k % 261
        rest = k // 261
        item = (rest % n_item) + 1
        wh = (rest // n_item) % n_wh + 1
        cols = {
            "inv_date_sk": Column(
                BIGINT, _date_sk(1998, 1, 1) + 7 * week, None),
            "inv_item_sk": Column(BIGINT, item, None),
            "inv_warehouse_sk": Column(BIGINT, wh, None),
            "inv_quantity_on_hand": Column(
                BIGINT, _randint(S + 2, idx, 0, 1000),
                _uniform(S + 3, idx) >= 0.05),
        }
        return self._finish(cols, n, columns)

    # --- fact tables -----------------------------------------------------
    def _store_sales(self, idx, sf, columns) -> Batch:
        S = _SEED["store_sales"]
        need = set(columns)
        n = len(idx)
        n_item = table_rows("item", sf)
        cols: Dict[str, Column] = {}
        # ~12 line items per ticket
        ticket = (idx - 1) // 12 + 1
        cols["ss_ticket_number"] = Column(BIGINT, ticket, None)
        cols["ss_item_sk"] = Column(
            BIGINT, 1 + (_u64(S + 2, idx) % np.uint64(n_item)).astype(
                np.int64), None)
        # per-TICKET foreign keys (all items of a basket share customer,
        # store, date — the spec's ticket semantics)
        cols["ss_sold_date_sk"] = Column(
            BIGINT, _randint(S + 3, ticket, _SALES_SK_LO, _SALES_SK_HI),
            _uniform(S + 103, ticket) >= 0.02)
        if "ss_sold_time_sk" in need:
            cols["ss_sold_time_sk"] = Column(
                BIGINT, _randint(S + 33, ticket, 28800, 75600), None)
        for cname, ref, s, nf in (
                ("ss_customer_sk", table_rows("customer", sf), 4, 0.02),
                ("ss_cdemo_sk",
                 table_rows("customer_demographics", sf), 5, 0.02),
                ("ss_hdemo_sk",
                 table_rows("household_demographics", sf), 6, 0.02),
                ("ss_addr_sk",
                 table_rows("customer_address", sf), 7, 0.02),
                ("ss_store_sk", table_rows("store", sf), 8, 0.02),
                ("ss_promo_sk", table_rows("promotion", sf), 9, 0.02)):
            k, v = _fk(S + s, ticket, ref, null_frac=nf)
            cols[cname] = Column(BIGINT, k, v)
        qty = _randint(S + 10, idx, 1, 100)
        whole = _price(S + 11, idx, 1.0, 100.0)
        lp = np.round(whole * (1.0 + _uniform(S + 12, idx)), 2)
        sp = np.round(lp * (0.2 + 0.8 * _uniform(S + 13, idx)), 2)
        cols["ss_quantity"] = Column(BIGINT, qty, None)
        cols["ss_wholesale_cost"] = Column(DOUBLE, whole, None)
        cols["ss_list_price"] = Column(DOUBLE, lp, None)
        cols["ss_sales_price"] = Column(DOUBLE, sp, None)
        if "ss_ext_sales_price" in need:
            cols["ss_ext_sales_price"] = Column(
                DOUBLE, np.round(sp * qty, 2), None)
        if "ss_ext_list_price" in need:
            cols["ss_ext_list_price"] = Column(
                DOUBLE, np.round(lp * qty, 2), None)
        if "ss_ext_discount_amt" in need:
            cols["ss_ext_discount_amt"] = Column(
                DOUBLE, np.round((lp - sp) * qty, 2), None)
        if "ss_ext_wholesale_cost" in need:
            cols["ss_ext_wholesale_cost"] = Column(
                DOUBLE, np.round(whole * qty, 2), None)
        if "ss_ext_tax" in need:
            cols["ss_ext_tax"] = Column(
                DOUBLE, np.round(sp * qty * 0.01
                                 * _randint(S + 16, idx, 0, 9), 2),
                None)
        cols["ss_coupon_amt"] = Column(
            DOUBLE,
            np.where(_uniform(S + 14, idx) < 0.2,
                     _price(S + 15, idx, 0.0, 500.0), 0.0), None)
        if "ss_net_paid" in need:
            cols["ss_net_paid"] = Column(
                DOUBLE, np.round(sp * qty, 2), None)
        if "ss_net_profit" in need:
            cols["ss_net_profit"] = Column(
                DOUBLE, np.round((sp - whole) * qty, 2), None)
        return self._finish(cols, n, columns)

    def _store_returns(self, idx, sf, columns) -> Batch:
        """Each return references a real store_sales row (strided, so
        (item_sk, ticket_number) pairs are unique and join back)."""
        S = _SEED["store_returns"]
        need = set(columns)
        n = len(idx)
        sf_rows = table_rows("store_sales", sf)
        sr_rows = table_rows("store_returns", sf)
        ss_idx = 1 + (idx - 1) * sf_rows // sr_rows
        Sss = _SEED["store_sales"]
        n_item = table_rows("item", sf)
        ticket = (ss_idx - 1) // 12 + 1
        cols: Dict[str, Column] = {}
        cols["sr_item_sk"] = Column(
            BIGINT, 1 + (_u64(Sss + 2, ss_idx)
                         % np.uint64(n_item)).astype(np.int64), None)
        cols["sr_ticket_number"] = Column(BIGINT, ticket, None)
        cols["sr_returned_date_sk"] = Column(
            BIGINT, _randint(S + 2, idx, _SALES_SK_LO, _SALES_SK_HI),
            None)
        # the return references the originating sale's customer and
        # store (spec: returns come from the matched ticket), so joins
        # back via (ticket, customer) — q17/q25 — find real matches
        k, v = _fk(Sss + 4, ticket, table_rows("customer", sf), 0.02)
        cols["sr_customer_sk"] = Column(BIGINT, k, v)
        if "sr_store_sk" in need:
            k, v = _fk(Sss + 8, ticket, table_rows("store", sf), 0.02)
            cols["sr_store_sk"] = Column(BIGINT, k, v)
        qty = _randint(S + 4, idx, 1, 20)
        cols["sr_return_quantity"] = Column(BIGINT, qty, None)
        amt = _price(S + 5, idx, 1.0, 300.0)
        cols["sr_return_amt"] = Column(DOUBLE, amt, None)
        if "sr_net_loss" in need:
            cols["sr_net_loss"] = Column(
                DOUBLE, _price(S + 6, idx, 0.5, 150.0), None)
        if "sr_reason_sk" in need:
            k, v = _fk(S + 7, idx, table_rows("reason", sf), 0.02)
            cols["sr_reason_sk"] = Column(BIGINT, k, v)
        if "sr_return_time_sk" in need:
            cols["sr_return_time_sk"] = Column(
                BIGINT, _randint(S + 8, idx, 28800, 61200), None)
        for cname, s in (("sr_fee", 9), ("sr_refunded_cash", 10),
                         ("sr_reversed_charge", 11),
                         ("sr_store_credit", 12)):
            if cname in need:
                cols[cname] = Column(
                    DOUBLE, _price(S + s, idx, 0.0, 100.0), None)
        if "sr_cdemo_sk" in need:
            k, v = _fk(S + 13, idx,
                       table_rows("customer_demographics", sf), 0.02)
            cols["sr_cdemo_sk"] = Column(BIGINT, k, v)
        return self._finish(cols, n, columns)

    def _catalog_sales(self, idx, sf, columns) -> Batch:
        S = _SEED["catalog_sales"]
        need = set(columns)
        n = len(idx)
        n_item = table_rows("item", sf)
        cols: Dict[str, Column] = {}
        cols["cs_order_number"] = Column(BIGINT, idx.copy(), None)
        cols["cs_item_sk"] = Column(
            BIGINT, 1 + (_u64(S + 2, idx) % np.uint64(n_item)).astype(
                np.int64), None)
        sold = _randint(S + 3, idx, _SALES_SK_LO, _SALES_SK_HI)
        cols["cs_sold_date_sk"] = Column(BIGINT, sold, None)
        if "cs_ship_date_sk" in need:
            cols["cs_ship_date_sk"] = Column(
                BIGINT, sold + _randint(S + 30, idx, 1, 120), None)
        if "cs_sold_time_sk" in need:
            cols["cs_sold_time_sk"] = Column(
                BIGINT, _randint(S + 31, idx, 0, 86399), None)
        for cname, ref, s in (
                ("cs_bill_customer_sk", table_rows("customer", sf), 4),
                ("cs_ship_customer_sk", table_rows("customer", sf), 5),
                ("cs_bill_cdemo_sk",
                 table_rows("customer_demographics", sf), 12),
                ("cs_bill_hdemo_sk",
                 table_rows("household_demographics", sf), 13),
                ("cs_bill_addr_sk",
                 table_rows("customer_address", sf), 14),
                ("cs_ship_addr_sk",
                 table_rows("customer_address", sf), 15),
                ("cs_call_center_sk", table_rows("call_center", sf), 16),
                ("cs_catalog_page_sk",
                 table_rows("catalog_page", sf), 17),
                ("cs_ship_mode_sk", table_rows("ship_mode", sf), 18),
                ("cs_promo_sk", table_rows("promotion", sf), 19),
                ("cs_warehouse_sk", table_rows("warehouse", sf), 6)):
            k, v = _fk(S + s, idx, ref, 0.02)
            cols[cname] = Column(BIGINT, k, v)
        qty = _randint(S + 7, idx, 1, 100)
        lp = _price(S + 8, idx, 1.0, 200.0)
        cols["cs_quantity"] = Column(BIGINT, qty, None)
        cols["cs_list_price"] = Column(DOUBLE, lp, None)
        cols["cs_ext_list_price"] = Column(
            DOUBLE, np.round(lp * qty, 2), None)
        if need & {"cs_sales_price", "cs_ext_sales_price",
                   "cs_ext_discount_amt", "cs_net_paid"}:
            sp = np.round(lp * (0.2 + 0.8 * _uniform(S + 9, idx)), 2)
            cols["cs_sales_price"] = Column(DOUBLE, sp, None)
            cols["cs_ext_sales_price"] = Column(
                DOUBLE, np.round(sp * qty, 2), None)
            if "cs_ext_discount_amt" in need:
                cols["cs_ext_discount_amt"] = Column(
                    DOUBLE, np.round((lp - sp) * qty, 2), None)
            if "cs_net_paid" in need:
                cols["cs_net_paid"] = Column(
                    DOUBLE, np.round(sp * qty, 2), None)
        if need & {"cs_wholesale_cost", "cs_ext_wholesale_cost"}:
            whole = _price(S + 10, idx, 1.0, 100.0)
            if "cs_wholesale_cost" in need:
                cols["cs_wholesale_cost"] = Column(DOUBLE, whole, None)
            if "cs_ext_wholesale_cost" in need:
                cols["cs_ext_wholesale_cost"] = Column(
                    DOUBLE, np.round(whole * qty, 2), None)
        if "cs_ext_ship_cost" in need:
            cols["cs_ext_ship_cost"] = Column(
                DOUBLE, _price(S + 20, idx, 0.0, 50.0), None)
        if "cs_coupon_amt" in need:
            cols["cs_coupon_amt"] = Column(
                DOUBLE,
                np.where(_uniform(S + 21, idx) < 0.2,
                         _price(S + 22, idx, 0.0, 500.0), 0.0), None)
        if "cs_net_profit" in need:
            cols["cs_net_profit"] = Column(
                DOUBLE, _price(S + 11, idx, -500.0, 500.0), None)
        return self._finish(cols, n, columns)

    def _web_sales(self, idx, sf, columns) -> Batch:
        S = _SEED["web_sales"]
        need = set(columns)
        n = len(idx)
        n_item = table_rows("item", sf)
        cols: Dict[str, Column] = {}
        cols["ws_order_number"] = Column(BIGINT, idx.copy(), None)
        cols["ws_item_sk"] = Column(
            BIGINT, 1 + (_u64(S + 2, idx) % np.uint64(n_item)).astype(
                np.int64), None)
        sold = _randint(S + 3, idx, _SALES_SK_LO, _SALES_SK_HI)
        cols["ws_sold_date_sk"] = Column(BIGINT, sold, None)
        if "ws_ship_date_sk" in need:
            cols["ws_ship_date_sk"] = Column(
                BIGINT, sold + _randint(S + 30, idx, 1, 120), None)
        if "ws_sold_time_sk" in need:
            cols["ws_sold_time_sk"] = Column(
                BIGINT, _randint(S + 31, idx, 0, 86399), None)
        for cname, ref, s in (
                ("ws_bill_customer_sk", table_rows("customer", sf), 4),
                ("ws_ship_customer_sk", table_rows("customer", sf), 5),
                ("ws_bill_cdemo_sk",
                 table_rows("customer_demographics", sf), 12),
                ("ws_bill_hdemo_sk",
                 table_rows("household_demographics", sf), 13),
                ("ws_ship_hdemo_sk",
                 table_rows("household_demographics", sf), 21),
                ("ws_bill_addr_sk",
                 table_rows("customer_address", sf), 14),
                ("ws_ship_addr_sk",
                 table_rows("customer_address", sf), 15),
                ("ws_warehouse_sk", table_rows("warehouse", sf), 6),
                ("ws_web_page_sk", table_rows("web_page", sf), 16),
                ("ws_web_site_sk", table_rows("web_site", sf), 17),
                ("ws_ship_mode_sk", table_rows("ship_mode", sf), 18),
                ("ws_promo_sk", table_rows("promotion", sf), 19)):
            k, v = _fk(S + s, idx, ref, 0.02)
            cols[cname] = Column(BIGINT, k, v)
        qty = _randint(S + 7, idx, 1, 100)
        lp = _price(S + 8, idx, 1.0, 200.0)
        whole = _price(S + 10, idx, 1.0, 100.0)
        sp = np.round(lp * (0.2 + 0.8 * _uniform(S + 9, idx)), 2)
        cols["ws_quantity"] = Column(BIGINT, qty, None)
        cols["ws_list_price"] = Column(DOUBLE, lp, None)
        cols["ws_sales_price"] = Column(DOUBLE, sp, None)
        cols["ws_wholesale_cost"] = Column(DOUBLE, whole, None)
        cols["ws_ext_list_price"] = Column(
            DOUBLE, np.round(lp * qty, 2), None)
        cols["ws_ext_sales_price"] = Column(
            DOUBLE, np.round(sp * qty, 2), None)
        if "ws_ext_wholesale_cost" in need:
            cols["ws_ext_wholesale_cost"] = Column(
                DOUBLE, np.round(whole * qty, 2), None)
        if "ws_ext_discount_amt" in need:
            cols["ws_ext_discount_amt"] = Column(
                DOUBLE, np.round((lp - sp) * qty, 2), None)
        if "ws_ext_ship_cost" in need:
            cols["ws_ext_ship_cost"] = Column(
                DOUBLE, _price(S + 20, idx, 0.0, 50.0), None)
        if "ws_net_paid" in need:
            cols["ws_net_paid"] = Column(
                DOUBLE, np.round(sp * qty, 2), None)
        if "ws_net_profit" in need:
            cols["ws_net_profit"] = Column(
                DOUBLE, np.round((sp - whole) * qty, 2), None)
        return self._finish(cols, n, columns)

    def _web_returns(self, idx, sf, columns) -> Batch:
        """Each return references a real web_sales row (strided)."""
        S = _SEED["web_returns"]
        need = set(columns)
        n = len(idx)
        ws_rows = table_rows("web_sales", sf)
        wr_rows = table_rows("web_returns", sf)
        ws_idx = 1 + (idx - 1) * ws_rows // wr_rows
        Sws = _SEED["web_sales"]
        n_item = table_rows("item", sf)
        cols: Dict[str, Column] = {}
        cols["wr_item_sk"] = Column(
            BIGINT, 1 + (_u64(Sws + 2, ws_idx)
                         % np.uint64(n_item)).astype(np.int64), None)
        cols["wr_order_number"] = Column(BIGINT, ws_idx, None)
        cols["wr_returned_date_sk"] = Column(
            BIGINT, _randint(S + 2, idx, _SALES_SK_LO, _SALES_SK_HI),
            None)
        for cname, sref in (("wr_refunded_customer_sk", 4),
                            ("wr_returning_customer_sk", 4)):
            k, v = _fk(Sws + sref, ws_idx, table_rows("customer", sf),
                       0.02)
            cols[cname] = Column(BIGINT, k, v)
        if "wr_web_page_sk" in need:
            k, v = _fk(Sws + 16, ws_idx, table_rows("web_page", sf),
                       0.02)
            cols["wr_web_page_sk"] = Column(BIGINT, k, v)
        if "wr_reason_sk" in need:
            k, v = _fk(S + 5, idx, table_rows("reason", sf), 0.02)
            cols["wr_reason_sk"] = Column(BIGINT, k, v)
        qty = _randint(S + 6, idx, 1, 20)
        cols["wr_return_quantity"] = Column(BIGINT, qty, None)
        cols["wr_return_amt"] = Column(
            DOUBLE, _price(S + 7, idx, 1.0, 300.0), None)
        if "wr_net_loss" in need:
            cols["wr_net_loss"] = Column(
                DOUBLE, _price(S + 8, idx, 0.5, 150.0), None)
        if "wr_refunded_cash" in need:
            cols["wr_refunded_cash"] = Column(
                DOUBLE, _price(S + 9, idx, 0.0, 200.0), None)
        if "wr_fee" in need:
            cols["wr_fee"] = Column(
                DOUBLE, _price(S + 10, idx, 0.5, 100.0), None)
        for cname, sref, tbl in (
                ("wr_returning_addr_sk", 11, "customer_address"),
                ("wr_refunded_addr_sk", 12, "customer_address"),
                ("wr_refunded_cdemo_sk", 13, "customer_demographics"),
                ("wr_returning_cdemo_sk", 14,
                 "customer_demographics")):
            if cname in need:
                k, v = _fk(S + sref, idx, table_rows(tbl, sf), 0.02)
                cols[cname] = Column(BIGINT, k, v)
        return self._finish(cols, n, columns)

    def _catalog_returns(self, idx, sf, columns) -> Batch:
        S = _SEED["catalog_returns"]
        n = len(idx)
        cs_rows = table_rows("catalog_sales", sf)
        cr_rows = table_rows("catalog_returns", sf)
        cs_idx = 1 + (idx - 1) * cs_rows // cr_rows
        Scs = _SEED["catalog_sales"]
        n_item = table_rows("item", sf)
        cols: Dict[str, Column] = {}
        cols["cr_item_sk"] = Column(
            BIGINT, 1 + (_u64(Scs + 2, cs_idx)
                         % np.uint64(n_item)).astype(np.int64), None)
        cols["cr_order_number"] = Column(BIGINT, cs_idx, None)
        cols["cr_returned_date_sk"] = Column(
            BIGINT, _randint(S + 2, idx, _SALES_SK_LO, _SALES_SK_HI),
            None)
        cols["cr_refunded_cash"] = Column(
            DOUBLE, _price(S + 3, idx, 0.0, 200.0), None)
        cols["cr_reversed_charge"] = Column(
            DOUBLE, _price(S + 4, idx, 0.0, 100.0), None)
        cols["cr_store_credit"] = Column(
            DOUBLE, _price(S + 5, idx, 0.0, 100.0), None)
        cols["cr_return_quantity"] = Column(
            BIGINT, _randint(S + 6, idx, 1, 20), None)
        need = set(columns)
        if "cr_return_amount" in need:
            cols["cr_return_amount"] = Column(
                DOUBLE, _price(S + 7, idx, 1.0, 300.0), None)
        if "cr_net_loss" in need:
            cols["cr_net_loss"] = Column(
                DOUBLE, _price(S + 8, idx, 0.5, 150.0), None)
        if "cr_returning_customer_sk" in need:
            k, v = _fk(S + 9, idx, table_rows("customer", sf), 0.02)
            cols["cr_returning_customer_sk"] = Column(BIGINT, k, v)
        if "cr_call_center_sk" in need:
            k, v = _fk(S + 10, idx, table_rows("call_center", sf), 0.02)
            cols["cr_call_center_sk"] = Column(BIGINT, k, v)
        if "cr_catalog_page_sk" in need:
            k, v = _fk(S + 11, idx, table_rows("catalog_page", sf),
                       0.02)
            cols["cr_catalog_page_sk"] = Column(BIGINT, k, v)
        if "cr_reason_sk" in need:
            k, v = _fk(S + 12, idx, table_rows("reason", sf), 0.02)
            cols["cr_reason_sk"] = Column(BIGINT, k, v)
        if "cr_return_amt_inc_tax" in need:
            cols["cr_return_amt_inc_tax"] = Column(
                DOUBLE, _price(S + 13, idx, 1.0, 320.0), None)
        if "cr_returning_addr_sk" in need:
            k, v = _fk(S + 14, idx,
                       table_rows("customer_address", sf), 0.02)
            cols["cr_returning_addr_sk"] = Column(BIGINT, k, v)
        return self._finish(cols, n, columns)


# column catalogs (metadata surface; generation is lazy per need)
def _cm(name: str, typ: Type) -> CM:
    return CM(name, typ)


_V = VarcharType
_TABLES: Dict[str, List[CM]] = {
    "date_dim": [
        _cm("d_date_sk", BIGINT), _cm("d_date", DATE),
        _cm("d_year", INTEGER), _cm("d_moy", INTEGER),
        _cm("d_dom", INTEGER), _cm("d_qoy", INTEGER),
        _cm("d_dow", INTEGER), _cm("d_month_seq", BIGINT),
        _cm("d_week_seq", BIGINT), _cm("d_day_name", _V(9)),
        _cm("d_quarter_name", _V(6))],
    "item": [
        _cm("i_item_sk", BIGINT), _cm("i_item_id", _V(16)),
        _cm("i_product_name", _V(50)), _cm("i_item_desc", _V(200)),
        _cm("i_color", _V(20)),
        _cm("i_current_price", DOUBLE), _cm("i_wholesale_cost", DOUBLE),
        _cm("i_brand_id", BIGINT), _cm("i_brand", _V(50)),
        _cm("i_manufact_id", BIGINT), _cm("i_manufact", _V(50)),
        _cm("i_category_id", BIGINT),
        _cm("i_category", _V(50)), _cm("i_class_id", BIGINT),
        _cm("i_class", _V(50)), _cm("i_manager_id", BIGINT),
        _cm("i_size", _V(20)), _cm("i_units", _V(10))],
    "customer": [
        _cm("c_customer_sk", BIGINT), _cm("c_customer_id", _V(16)),
        _cm("c_current_cdemo_sk", BIGINT),
        _cm("c_current_hdemo_sk", BIGINT),
        _cm("c_current_addr_sk", BIGINT),
        _cm("c_first_sales_date_sk", BIGINT),
        _cm("c_first_shipto_date_sk", BIGINT),
        _cm("c_first_name", _V(20)), _cm("c_last_name", _V(30)),
        _cm("c_birth_year", INTEGER), _cm("c_birth_month", INTEGER),
        _cm("c_birth_day", INTEGER), _cm("c_birth_country", _V(20)),
        _cm("c_preferred_cust_flag", _V(1)), _cm("c_salutation", _V(10)),
        _cm("c_email_address", _V(50)),
        _cm("c_last_review_date_sk", BIGINT)],
    "customer_address": [
        _cm("ca_address_sk", BIGINT), _cm("ca_street_number", _V(10)),
        _cm("ca_street_name", _V(60)), _cm("ca_city", _V(60)),
        _cm("ca_zip", _V(10)), _cm("ca_state", _V(2)),
        _cm("ca_country", _V(20)), _cm("ca_county", _V(30)),
        _cm("ca_gmt_offset", DOUBLE), _cm("ca_street_type", _V(15)),
        _cm("ca_suite_number", _V(10)),
        _cm("ca_location_type", _V(20))],
    "customer_demographics": [
        _cm("cd_demo_sk", BIGINT), _cm("cd_gender", _V(1)),
        _cm("cd_marital_status", _V(1)),
        _cm("cd_education_status", _V(20)),
        _cm("cd_purchase_estimate", BIGINT),
        _cm("cd_credit_rating", _V(10)), _cm("cd_dep_count", BIGINT),
        _cm("cd_dep_employed_count", BIGINT),
        _cm("cd_dep_college_count", BIGINT)],
    "household_demographics": [
        _cm("hd_demo_sk", BIGINT), _cm("hd_income_band_sk", BIGINT),
        _cm("hd_buy_potential", _V(15)), _cm("hd_dep_count", BIGINT),
        _cm("hd_vehicle_count", BIGINT)],
    "income_band": [
        _cm("ib_income_band_sk", BIGINT), _cm("ib_lower_bound", BIGINT),
        _cm("ib_upper_bound", BIGINT)],
    "store": [
        _cm("s_store_sk", BIGINT), _cm("s_store_id", _V(16)),
        _cm("s_store_name", _V(50)), _cm("s_zip", _V(10)),
        _cm("s_state", _V(2)), _cm("s_city", _V(60)),
        _cm("s_number_employees", BIGINT),
        _cm("s_county", _V(30)), _cm("s_company_name", _V(50)),
        _cm("s_company_id", BIGINT), _cm("s_market_id", BIGINT),
        _cm("s_street_number", _V(10)),
        _cm("s_street_name", _V(60)), _cm("s_street_type", _V(15)),
        _cm("s_suite_number", _V(10))],
    "promotion": [
        _cm("p_promo_sk", BIGINT), _cm("p_promo_id", _V(16)),
        _cm("p_channel_dmail", _V(1)), _cm("p_channel_email", _V(1)),
        _cm("p_channel_tv", _V(1)), _cm("p_channel_event", _V(1)),
        _cm("p_channel_catalog", _V(1)), _cm("p_cost", DOUBLE)],
    "warehouse": [
        _cm("w_warehouse_sk", BIGINT), _cm("w_warehouse_name", _V(20)),
        _cm("w_warehouse_sq_ft", BIGINT), _cm("w_city", _V(60)),
        _cm("w_county", _V(30)), _cm("w_state", _V(2)),
        _cm("w_country", _V(20))],
    "store_sales": [
        _cm("ss_sold_date_sk", BIGINT), _cm("ss_sold_time_sk", BIGINT),
        _cm("ss_item_sk", BIGINT),
        _cm("ss_customer_sk", BIGINT), _cm("ss_cdemo_sk", BIGINT),
        _cm("ss_hdemo_sk", BIGINT), _cm("ss_addr_sk", BIGINT),
        _cm("ss_store_sk", BIGINT), _cm("ss_promo_sk", BIGINT),
        _cm("ss_ticket_number", BIGINT), _cm("ss_quantity", BIGINT),
        _cm("ss_wholesale_cost", DOUBLE), _cm("ss_list_price", DOUBLE),
        _cm("ss_sales_price", DOUBLE),
        _cm("ss_ext_sales_price", DOUBLE),
        _cm("ss_ext_list_price", DOUBLE),
        _cm("ss_ext_discount_amt", DOUBLE),
        _cm("ss_ext_wholesale_cost", DOUBLE),
        _cm("ss_ext_tax", DOUBLE),
        _cm("ss_coupon_amt", DOUBLE), _cm("ss_net_paid", DOUBLE),
        _cm("ss_net_profit", DOUBLE)],
    "store_returns": [
        _cm("sr_item_sk", BIGINT), _cm("sr_ticket_number", BIGINT),
        _cm("sr_returned_date_sk", BIGINT),
        _cm("sr_return_time_sk", BIGINT),
        _cm("sr_customer_sk", BIGINT), _cm("sr_cdemo_sk", BIGINT),
        _cm("sr_store_sk", BIGINT), _cm("sr_reason_sk", BIGINT),
        _cm("sr_return_quantity", BIGINT),
        _cm("sr_return_amt", DOUBLE), _cm("sr_net_loss", DOUBLE),
        _cm("sr_fee", DOUBLE), _cm("sr_refunded_cash", DOUBLE),
        _cm("sr_reversed_charge", DOUBLE),
        _cm("sr_store_credit", DOUBLE)],
    "catalog_sales": [
        _cm("cs_sold_date_sk", BIGINT), _cm("cs_sold_time_sk", BIGINT),
        _cm("cs_ship_date_sk", BIGINT), _cm("cs_item_sk", BIGINT),
        _cm("cs_order_number", BIGINT),
        _cm("cs_bill_customer_sk", BIGINT),
        _cm("cs_ship_customer_sk", BIGINT),
        _cm("cs_bill_cdemo_sk", BIGINT),
        _cm("cs_bill_hdemo_sk", BIGINT),
        _cm("cs_bill_addr_sk", BIGINT), _cm("cs_ship_addr_sk", BIGINT),
        _cm("cs_call_center_sk", BIGINT),
        _cm("cs_catalog_page_sk", BIGINT),
        _cm("cs_ship_mode_sk", BIGINT), _cm("cs_promo_sk", BIGINT),
        _cm("cs_warehouse_sk", BIGINT), _cm("cs_quantity", BIGINT),
        _cm("cs_list_price", DOUBLE), _cm("cs_ext_list_price", DOUBLE),
        _cm("cs_sales_price", DOUBLE),
        _cm("cs_ext_sales_price", DOUBLE),
        _cm("cs_ext_discount_amt", DOUBLE),
        _cm("cs_wholesale_cost", DOUBLE),
        _cm("cs_ext_wholesale_cost", DOUBLE),
        _cm("cs_ext_ship_cost", DOUBLE), _cm("cs_coupon_amt", DOUBLE),
        _cm("cs_net_paid", DOUBLE), _cm("cs_net_profit", DOUBLE)],
    "catalog_returns": [
        _cm("cr_item_sk", BIGINT), _cm("cr_order_number", BIGINT),
        _cm("cr_returned_date_sk", BIGINT),
        _cm("cr_refunded_cash", DOUBLE),
        _cm("cr_reversed_charge", DOUBLE),
        _cm("cr_store_credit", DOUBLE),
        _cm("cr_return_quantity", BIGINT),
        _cm("cr_return_amount", DOUBLE), _cm("cr_net_loss", DOUBLE),
        _cm("cr_returning_customer_sk", BIGINT),
        _cm("cr_call_center_sk", BIGINT),
        _cm("cr_catalog_page_sk", BIGINT),
        _cm("cr_reason_sk", BIGINT),
        _cm("cr_return_amt_inc_tax", DOUBLE),
        _cm("cr_returning_addr_sk", BIGINT)],
    "web_sales": [
        _cm("ws_sold_date_sk", BIGINT), _cm("ws_sold_time_sk", BIGINT),
        _cm("ws_ship_date_sk", BIGINT), _cm("ws_item_sk", BIGINT),
        _cm("ws_order_number", BIGINT),
        _cm("ws_bill_customer_sk", BIGINT),
        _cm("ws_ship_customer_sk", BIGINT),
        _cm("ws_bill_cdemo_sk", BIGINT),
        _cm("ws_bill_hdemo_sk", BIGINT),
        _cm("ws_ship_hdemo_sk", BIGINT),
        _cm("ws_bill_addr_sk", BIGINT), _cm("ws_ship_addr_sk", BIGINT),
        _cm("ws_web_page_sk", BIGINT), _cm("ws_web_site_sk", BIGINT),
        _cm("ws_ship_mode_sk", BIGINT), _cm("ws_warehouse_sk", BIGINT),
        _cm("ws_promo_sk", BIGINT), _cm("ws_quantity", BIGINT),
        _cm("ws_wholesale_cost", DOUBLE), _cm("ws_list_price", DOUBLE),
        _cm("ws_sales_price", DOUBLE),
        _cm("ws_ext_discount_amt", DOUBLE),
        _cm("ws_ext_sales_price", DOUBLE),
        _cm("ws_ext_wholesale_cost", DOUBLE),
        _cm("ws_ext_list_price", DOUBLE),
        _cm("ws_ext_ship_cost", DOUBLE), _cm("ws_net_paid", DOUBLE),
        _cm("ws_net_profit", DOUBLE)],
    "web_returns": [
        _cm("wr_returned_date_sk", BIGINT), _cm("wr_item_sk", BIGINT),
        _cm("wr_order_number", BIGINT),
        _cm("wr_refunded_customer_sk", BIGINT),
        _cm("wr_returning_customer_sk", BIGINT),
        _cm("wr_web_page_sk", BIGINT), _cm("wr_reason_sk", BIGINT),
        _cm("wr_return_quantity", BIGINT),
        _cm("wr_return_amt", DOUBLE), _cm("wr_net_loss", DOUBLE),
        _cm("wr_refunded_cash", DOUBLE), _cm("wr_fee", DOUBLE),
        _cm("wr_returning_addr_sk", BIGINT),
        _cm("wr_refunded_addr_sk", BIGINT),
        _cm("wr_refunded_cdemo_sk", BIGINT),
        _cm("wr_returning_cdemo_sk", BIGINT)],
    "web_site": [
        _cm("web_site_sk", BIGINT), _cm("web_site_id", _V(16)),
        _cm("web_name", _V(50)), _cm("web_company_name", _V(50))],
    "web_page": [
        _cm("wp_web_page_sk", BIGINT), _cm("wp_web_page_id", _V(16)),
        _cm("wp_char_count", BIGINT)],
    "inventory": [
        _cm("inv_date_sk", BIGINT), _cm("inv_item_sk", BIGINT),
        _cm("inv_warehouse_sk", BIGINT),
        _cm("inv_quantity_on_hand", BIGINT)],
    "time_dim": [
        _cm("t_time_sk", BIGINT), _cm("t_time", BIGINT),
        _cm("t_hour", BIGINT), _cm("t_minute", BIGINT),
        _cm("t_second", BIGINT), _cm("t_am_pm", _V(2)),
        _cm("t_meal_time", _V(20))],
    "reason": [
        _cm("r_reason_sk", BIGINT), _cm("r_reason_id", _V(16)),
        _cm("r_reason_desc", _V(100))],
    "ship_mode": [
        _cm("sm_ship_mode_sk", BIGINT), _cm("sm_ship_mode_id", _V(16)),
        _cm("sm_type", _V(30)), _cm("sm_carrier", _V(20)),
        _cm("sm_code", _V(10))],
    "call_center": [
        _cm("cc_call_center_sk", BIGINT),
        _cm("cc_call_center_id", _V(16)), _cm("cc_name", _V(50)),
        _cm("cc_manager", _V(40)), _cm("cc_county", _V(30))],
    "catalog_page": [
        _cm("cp_catalog_page_sk", BIGINT),
        _cm("cp_catalog_page_id", _V(16)),
        _cm("cp_catalog_number", BIGINT),
        _cm("cp_catalog_page_number", BIGINT)],
}
