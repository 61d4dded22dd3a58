"""SQL type system, TPU-first.

Mirrors the reference's type SPI (reference: core/trino-spi/src/main/java/io/
trino/spi/type/ — 60+ classes) but each type here declares its *physical*
device representation: the jnp dtype of the value lanes plus how NULLs and
variable-width data are encoded. Design decisions (SURVEY.md §7.1):

- Fixed-width SQL types map 1:1 onto a single dense ``jax.Array`` lane.
- DECIMAL(p,s) with p<=18 is a scaled int64 ("short decimal",
  reference: spi/type/DecimalType.java, Int128 only for p>18).
- DECIMAL(p>18) is a pair of int64 lanes (hi, lo) emulating Int128.
- VARCHAR/CHAR are dictionary-encoded: an int32 code lane per row plus a
  host-side deduplicated dictionary (reference analog: spi/block/
  DictionaryBlock.java made the *primary* representation, because equality/
  group-by/join on codes is MXU/VPU-friendly while raw bytes are not).
- DATE is days-since-epoch int32; TIMESTAMP(p) is an int64 of 10^-p units
  since epoch (reference: spi/type/DateType.java, TimestampType.java).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

__all__ = [
    "Type", "BOOLEAN", "TINYINT", "SMALLINT", "INTEGER", "BIGINT", "REAL",
    "DOUBLE", "VARCHAR", "VARBINARY", "DATE", "UNKNOWN", "DecimalType",
    "VarcharType", "CharType", "TimestampType", "TimeType", "ArrayType",
    "MapType", "RowType", "HyperLogLogType", "HYPER_LOG_LOG",
    "TDigestType", "T_DIGEST", "QDigestType", "GeometryType",
    "GEOMETRY",
    "IntervalDayTime", "IntervalYearMonth", "parse_type", "common_super_type",
    "is_numeric", "is_integral", "is_exact_numeric", "is_string",
]


@dataclass(frozen=True)
class Type:
    """Base SQL type. ``name`` is the SQL display name."""

    name: str

    # --- physical layout -------------------------------------------------
    @property
    def np_dtype(self) -> Optional[np.dtype]:
        """dtype of the primary value lane, or None for multi-lane types."""
        return _PHYSICAL.get(self.name)

    @property
    def lanes(self) -> int:
        return 1

    @property
    def is_dictionary(self) -> bool:
        return False

    def __str__(self) -> str:  # SQL display form
        return self.name

    def display(self) -> str:
        return self.name


_PHYSICAL = {
    "boolean": np.dtype(np.bool_),
    "tinyint": np.dtype(np.int8),
    "smallint": np.dtype(np.int16),
    "integer": np.dtype(np.int32),
    "bigint": np.dtype(np.int64),
    "real": np.dtype(np.float32),
    "double": np.dtype(np.float64),
    "date": np.dtype(np.int32),
    "interval day to second": np.dtype(np.int64),  # millis
    "interval year to month": np.dtype(np.int32),  # months
    "unknown": np.dtype(np.bool_),
}


@dataclass(frozen=True)
class HyperLogLogType(Type):
    """HLL sketch (reference: spi/type/HyperLogLogType + airlift-stats).

    Physically an ARRAY-like column: offsets into a flat register lane
    (``ops/hll.py``). ``bucket_bits`` is static per column so kernels see
    a fixed register width."""

    bucket_bits: int = 11

    def __init__(self, bucket_bits: int = 11):
        object.__setattr__(self, "name", "hyperloglog")
        object.__setattr__(self, "bucket_bits", bucket_bits)

    @property
    def num_buckets(self) -> int:
        return 1 << self.bucket_bits

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)  # offset lane


HYPER_LOG_LOG = HyperLogLogType()


@dataclass(frozen=True)
class GeometryType(Type):
    """GEOMETRY (reference: trino-geospatial's GeometryType over ESRI
    shapes). TPU-first representation: POINT geometries are two float64
    lanes (x in ``data``, y in ``data2``) — ST_Distance/ST_Contains are
    pure VPU math; non-point shapes ride dictionary-coded WKT text."""

    def __init__(self):
        object.__setattr__(self, "name", "geometry")


GEOMETRY = GeometryType()


@dataclass(frozen=True)
class TDigestType(Type):
    """t-digest sketch (reference: spi/type/TDigestType + airlift-stats
    TDigest). Physically like an ARRAY column: ``data`` = per-row start
    into flat centroid lanes, ``data2`` = centroid count, ``elements`` =
    centroid means (f64), ``elements2`` = centroid weights (f64)."""

    compression: int = 100

    def __init__(self, compression: int = 100):
        object.__setattr__(self, "name", "tdigest")
        object.__setattr__(self, "compression", compression)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)  # offset lane


T_DIGEST = TDigestType()


@dataclass(frozen=True)
class QDigestType(Type):
    """Quantile digest over a numeric type (spi/type/QDigestType).
    Same physical layout as TDigestType; ``value_type`` drives the
    result type of value_at_quantile."""

    value_type: "Type" = None  # type: ignore

    def __init__(self, value_type: "Type"):
        object.__setattr__(self, "name", f"qdigest({value_type.name})")
        object.__setattr__(self, "value_type", value_type)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)  # offset lane


@dataclass(frozen=True)
class DecimalType(Type):
    precision: int = 38
    scale: int = 0

    def __init__(self, precision: int, scale: int):
        object.__setattr__(self, "name", f"decimal({precision},{scale})")
        object.__setattr__(self, "precision", precision)
        object.__setattr__(self, "scale", scale)
        if not (1 <= precision <= 38):
            raise ValueError(f"DECIMAL precision out of range: {precision}")
        if not (0 <= scale <= precision):
            raise ValueError(f"DECIMAL scale out of range: {scale}")

    @property
    def is_short(self) -> bool:
        return self.precision <= 18

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    @property
    def lanes(self) -> int:
        return 1 if self.is_short else 2


@dataclass(frozen=True)
class VarcharType(Type):
    length: Optional[int] = None  # None == unbounded

    def __init__(self, length: Optional[int] = None):
        object.__setattr__(
            self, "name",
            "varchar" if length is None else f"varchar({length})")
        object.__setattr__(self, "length", length)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int32)  # dictionary code lane

    @property
    def is_dictionary(self) -> bool:
        return True


@dataclass(frozen=True)
class CharType(Type):
    length: int = 1

    def __init__(self, length: int = 1):
        object.__setattr__(self, "name", f"char({length})")
        object.__setattr__(self, "length", length)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int32)

    @property
    def is_dictionary(self) -> bool:
        return True


@dataclass(frozen=True)
class TimestampType(Type):
    precision: int = 3

    def __init__(self, precision: int = 3):
        object.__setattr__(self, "name", f"timestamp({precision})")
        object.__setattr__(self, "precision", precision)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


def iso_timestamp_millis(s: str) -> int:
    """ISO timestamp text -> epoch milliseconds (shared by literal
    planning and varchar casts so the conversions cannot diverge)."""
    import datetime
    dt = datetime.datetime.fromisoformat(s.strip())
    epoch = datetime.datetime(1970, 1, 1)
    return int((dt - epoch).total_seconds() * 1000)


def iso_time_millis(s: str) -> int:
    """ISO time text -> milliseconds of day."""
    import datetime
    t = datetime.time.fromisoformat(s.strip())
    return (((t.hour * 60 + t.minute) * 60 + t.second) * 1000
            + t.microsecond // 1000)


@dataclass(frozen=True)
class TimestampTZType(Type):
    """TIMESTAMP(p) WITH TIME ZONE (spi/type/
    TimestampWithTimeZoneType.java packs millis+zoneKey in one long).
    TPU-first layout: the ``data`` lane is the UTC instant in epoch
    milliseconds — so comparison/ordering/grouping/joins are plain
    int64 lane ops with the correct instant semantics — and the
    ``data2`` lane carries the per-value zone offset in MINUTES, used
    only for display and field extraction (it does NOT participate in
    equality, matching the reference's instant-based equality)."""
    precision: int = 3

    def __init__(self, precision: int = 3):
        object.__setattr__(self, "name",
                           f"timestamp({precision}) with time zone")
        object.__setattr__(self, "precision", precision)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


def zone_offset_minutes(zone: str, instant_ms=None) -> int:
    """Fixed-offset zone string ('+05:30', '-08:00', 'UTC', or an IANA
    name resolved at ``instant_ms``) -> offset minutes."""
    z = zone.strip()
    if z.upper() in ("UTC", "Z"):
        return 0
    if z and z[0] in "+-":
        sign = -1 if z[0] == "-" else 1
        hh, _, mm = z[1:].partition(":")
        return sign * (int(hh) * 60 + int(mm or 0))
    import datetime
    from zoneinfo import ZoneInfo
    dt = (datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
          + datetime.timedelta(milliseconds=int(instant_ms or 0)))
    off = dt.astimezone(ZoneInfo(z)).utcoffset()
    return int(off.total_seconds() // 60)


def iso_timestamp_tz(s: str):
    """Timestamp text with zone -> (utc_millis, offset_minutes).
    Accepts '2020-01-01 00:00:00 +05:30', '...Z', '... UTC', and
    '... Region/City' forms; None offset part -> (naive, None)."""
    import datetime
    import re as _re
    text = s.strip()
    m = _re.match(
        r"^(\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}(?::\d{2}(?:\.\d+)?)?)"
        r"\s*(Z|UTC|[+-]\d{2}(?::?\d{2})?|[A-Za-z_]+/[A-Za-z_]+)?$",
        text)
    if not m:
        raise ValueError(f"cannot parse timestamp: {s!r}")
    base, zone = m.group(1), m.group(2)
    naive = datetime.datetime.fromisoformat(base.replace("T", " "))
    local_ms = int((naive - datetime.datetime(1970, 1, 1))
                   .total_seconds() * 1000)
    if zone is None:
        return local_ms, None
    if "/" in zone:
        from zoneinfo import ZoneInfo
        aware = naive.replace(tzinfo=ZoneInfo(zone))
        off = aware.utcoffset()
        offset_min = int(off.total_seconds() // 60)
    else:
        offset_min = zone_offset_minutes(zone)
    return local_ms - offset_min * 60000, offset_min


@dataclass(frozen=True)
class TimeType(Type):
    """TIME(p): milliseconds of day in an int64 lane
    (spi/type/TimeType.java)."""
    precision: int = 3

    def __init__(self, precision: int = 3):
        object.__setattr__(self, "name", f"time({precision})")
        object.__setattr__(self, "precision", precision)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


@dataclass(frozen=True)
class ArrayType(Type):
    element: Type = None  # type: ignore

    def __init__(self, element: Type):
        object.__setattr__(self, "name", f"array({element.name})")
        object.__setattr__(self, "element", element)


@dataclass(frozen=True)
class MapType(Type):
    """MAP(k, v): physically offsets+lengths lanes over two flat element
    columns (keys, values) — spi/type/MapType.java redesigned as
    struct-of-arrays like ArrayType (see columnar.Column docstring)."""
    key: Type = None    # type: ignore
    value: Type = None  # type: ignore

    def __init__(self, key: Type, value: Type):
        object.__setattr__(self, "name", f"map({key.name}, {value.name})")
        object.__setattr__(self, "key", key)
        object.__setattr__(self, "value", value)


@dataclass(frozen=True)
class RowType(Type):
    fields: Tuple[Tuple[Optional[str], Type], ...] = ()

    def __init__(self, fields):
        fields = tuple((n, t) for n, t in fields)
        object.__setattr__(
            self, "name",
            "row(" + ", ".join(
                (f"{n} {t.name}" if n else t.name) for n, t in fields) + ")")
        object.__setattr__(self, "fields", fields)


BOOLEAN = Type("boolean")
TINYINT = Type("tinyint")
SMALLINT = Type("smallint")
INTEGER = Type("integer")
BIGINT = Type("bigint")
REAL = Type("real")
DOUBLE = Type("double")
DATE = Type("date")
UNKNOWN = Type("unknown")  # type of NULL literal
VARBINARY = Type("varbinary")
VARCHAR = VarcharType(None)
IntervalDayTime = Type("interval day to second")
IntervalYearMonth = Type("interval year to month")


def is_integral(t: Type) -> bool:
    return t.name in ("tinyint", "smallint", "integer", "bigint")


def is_exact_numeric(t: Type) -> bool:
    return is_integral(t) or isinstance(t, DecimalType)


def is_numeric(t: Type) -> bool:
    return is_exact_numeric(t) or t.name in ("real", "double")


def is_string(t: Type) -> bool:
    return isinstance(t, (VarcharType, CharType))


_NUMERIC_LADDER = ["tinyint", "smallint", "integer", "bigint", "real",
                   "double"]


def default_decimal_for(t: Type) -> DecimalType:
    return {
        "tinyint": DecimalType(3, 0), "smallint": DecimalType(5, 0),
        "integer": DecimalType(10, 0), "bigint": DecimalType(19, 0),
    }[t.name]


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """The implicit-coercion join of two types (reference:
    core/trino-main/.../type/TypeCoercion.java)."""
    if a == b:
        return a
    if a == UNKNOWN:
        return b
    if b == UNKNOWN:
        return a
    if is_string(a) and is_string(b):
        return VARCHAR
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        if a.name in ("double",) or b.name in ("double",):
            return DOUBLE
        if a.name in ("real",) or b.name in ("real",):
            return REAL
        da = a if isinstance(a, DecimalType) else (
            default_decimal_for(a) if is_integral(a) else None)
        db = b if isinstance(b, DecimalType) else (
            default_decimal_for(b) if is_integral(b) else None)
        if da is None or db is None:
            return None
        scale = max(da.scale, db.scale)
        ip = max(da.precision - da.scale, db.precision - db.scale)
        return DecimalType(min(38, ip + scale), scale)
    if is_numeric(a) and is_numeric(b):
        ia, ib = _NUMERIC_LADDER.index(a.name), _NUMERIC_LADDER.index(b.name)
        return a if ia >= ib else b
    if a == DATE and isinstance(b, TimestampType):
        return b
    if b == DATE and isinstance(a, TimestampType):
        return a
    if isinstance(a, ArrayType) and isinstance(b, ArrayType):
        e = common_super_type(a.element, b.element)
        return None if e is None else ArrayType(e)
    if isinstance(a, MapType) and isinstance(b, MapType):
        k = common_super_type(a.key, b.key)
        v = common_super_type(a.value, b.value)
        return None if k is None or v is None else MapType(k, v)
    if isinstance(a, RowType) and isinstance(b, RowType):
        if len(a.fields) != len(b.fields):
            return None
        fields = []
        for (na, ta), (nb, tb) in zip(a.fields, b.fields):
            t = common_super_type(ta, tb)
            if t is None:
                return None
            fields.append((na if na == nb else None, t))
        return RowType(fields)
    return None


def _split_top_level(s: str):
    """Split on commas not nested inside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _looks_like_type(tok: str) -> bool:
    tok = tok.split("(")[0]
    return (tok in _SIMPLE
            or tok in ("decimal", "char", "timestamp", "time", "array",
                       "map", "row"))


_TYPE_RE = re.compile(r"^\s*([a-z_ ]+?)\s*(?:\(\s*([0-9]+)\s*(?:,\s*([0-9]+)\s*)?\))?\s*$")

_SIMPLE = {t.name: t for t in [
    BOOLEAN, TINYINT, SMALLINT, INTEGER, BIGINT, REAL, DOUBLE, DATE,
    VARBINARY, UNKNOWN, IntervalDayTime, IntervalYearMonth]}
_SIMPLE["int"] = INTEGER
_SIMPLE["string"] = VARCHAR
_SIMPLE["varchar"] = VARCHAR
_SIMPLE["timestamp"] = TimestampType(3)
_SIMPLE["hyperloglog"] = HYPER_LOG_LOG
_SIMPLE["geometry"] = GEOMETRY
_SIMPLE["tdigest"] = T_DIGEST
_SIMPLE["p4hyperloglog"] = HYPER_LOG_LOG


def parse_type(s: str) -> Type:
    """Parse a SQL type name, e.g. 'decimal(12,2)' or
    'array(varchar(25))' (reference:
    core/trino-main/.../type/TypeRegistry.java)."""
    low = s.strip().lower()
    if low.startswith("array(") and low.endswith(")"):
        return ArrayType(parse_type(low[len("array("):-1]))
    if low.startswith("map(") and low.endswith(")"):
        parts = _split_top_level(low[len("map("):-1])
        if len(parts) != 2:
            raise ValueError(f"cannot parse map type: {s!r}")
        return MapType(parse_type(parts[0]), parse_type(parts[1]))
    if low.startswith("row(") and low.endswith(")"):
        fields = []
        for part in _split_top_level(low[len("row("):-1]):
            part = part.strip()
            # "name type" or bare "type"
            toks = part.split(None, 1)
            if len(toks) == 2 and not _looks_like_type(toks[0]):
                fields.append((toks[0], parse_type(toks[1])))
            else:
                fields.append((None, parse_type(part)))
        return RowType(fields)
    low2 = " ".join(low.split())
    if low2.endswith(" with time zone"):
        mtz = _TYPE_RE.match(low2[:-len(" with time zone")])
        if mtz and mtz.group(1) == "timestamp":
            return TimestampTZType(int(mtz.group(2))
                                   if mtz.group(2) else 3)
        raise ValueError(f"unknown type: {s!r}")
    if low2.endswith(" without time zone"):
        return parse_type(low2[:-len(" without time zone")])
    m = _TYPE_RE.match(s.lower())
    if not m:
        raise ValueError(f"cannot parse type: {s!r}")
    base, p1, p2 = m.group(1), m.group(2), m.group(3)
    if base in _SIMPLE and p1 is None:
        return _SIMPLE[base]
    if base == "decimal":
        return DecimalType(int(p1 or 38), int(p2 or 0))
    if base == "varchar":
        return VarcharType(int(p1)) if p1 else VARCHAR
    if base == "char":
        return CharType(int(p1 or 1))
    if base == "timestamp":
        return TimestampType(int(p1) if p1 else 3)
    if base == "time":
        return TimeType(int(p1) if p1 else 3)
    raise ValueError(f"unknown type: {s!r}")
