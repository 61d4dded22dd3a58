"""Columnar data model over torch tensors: Column / Batch.

Counterpart of ``trino_tpu/columnar.py``, with the same contract:

- A ``Column`` is a value lane (``data``), an optional validity lane
  (``valid``; None means every live row is non-null), for string types a
  host-side ``StringDictionary`` whose int32 codes are the lane, and for
  DECIMAL(p>18) a high int64 lane (``data2``).
- A GEOMETRY column is a POINT column, float64 x in ``data`` and y in
  ``data2``, or dictionary-coded WKT text like a string column
  (ops/geo.py).
- DATE is int32 days since 1970-01-01; TIMESTAMP(p) and TIME(p) are int64
  milliseconds (since 1970-01-01 and of the day). TIMESTAMP(p) WITH TIME
  ZONE is the UTC instant in int64 milliseconds with the zone's offset
  minutes in ``data2``, which only display and field extraction read
  (``key_hi_lane``).
- A HyperLogLog sketch column is ragged: ``data`` holds each row's start
  offset into the flat lane of packed int32 entries ``elements`` (a
  Column of its own, of any length), ``data2`` each row's entry count
  (ops/hll.py). A row gather moves the offsets and counts; ``elements``
  is shared untouched.
- ARRAY columns have the same layout: ``data`` is each row's int64
  start into the flat element pool ``elements``, ``data2`` its length.
  MAP columns add ``elements2``, the flat values beside the keys in
  ``elements``; a quantile digest (TDIGEST, QDIGEST) is laid out like a
  MAP of centroid means to weights. A ROW column holds one row-aligned
  Column per field in ``children``; its ``data`` is an int8 lane that
  only carries the capacity.
- A ``Batch`` is named Columns plus a row count. Lane length
  ("capacity") is a power-of-two bucket >= ``num_rows``; rows past
  ``num_rows`` are masked, never trusted. Capacity stays >= 8.
- ``num_rows`` is a python int (host-known) or a 0-d int64 tensor on the
  batch's device (data-dependent, e.g. after a filter), so a filter does
  not have to wait for the device.

Lanes are tensors on one device. A numpy lane handed to ``Column`` is
wrapped without a copy as a CPU tensor; ``Batch.to`` moves a batch.
"""

from __future__ import annotations

import datetime as _dt
from contextlib import nullcontext
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import DeviceLike, capacity_for, resolve_device
from .obs.trace import device_wait
from .types import (BOOLEAN, ArrayType, CharType, DecimalType,
                    GeometryType, MapType, QDigestType, RowType,
                    TDigestType, TimestampTZType, Type, is_string)

NumRows = Union[int, torch.Tensor]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def is_nested(typ: Type) -> bool:
    """ARRAY, MAP and ROW, and the digests laid out as a MAP."""
    return isinstance(typ, (ArrayType, MapType, RowType, TDigestType,
                            QDigestType))


def torch_dtype(typ: Type) -> torch.dtype:
    """The torch dtype of a type's value lane."""
    if isinstance(typ, RowType):
        return torch.int8
    if isinstance(typ, (ArrayType, MapType)):
        return torch.int64
    if isinstance(typ, GeometryType):
        return torch.float64        # a POINT column's x lane
    dt = typ.np_dtype
    if dt is None or np.dtype(dt) not in _TORCH_DTYPES:
        raise NotImplementedError(f"not yet ported: lanes of type {typ}")
    return _TORCH_DTYPES[np.dtype(dt)]


def _as_lane(x) -> Optional[torch.Tensor]:
    if x is None or isinstance(x, torch.Tensor):
        return x
    arr = np.ascontiguousarray(x)
    if arr.dtype not in _TORCH_DTYPES:
        raise TypeError(f"unsupported lane dtype {arr.dtype}")
    return torch.from_numpy(arr)


class StringDictionary:
    """Host-side deduplicated string pool backing a dictionary column.

    Codes are int32 indices into ``values``. Immutable; merges produce a
    new dictionary plus remap arrays that a lane gathers through.
    Equality and hash are content-based (order-sensitive fingerprint).
    """

    __slots__ = ("values", "_index", "_fp", "_derived")

    def __init__(self, values: np.ndarray, _index: Optional[dict] = None):
        self.values = np.asarray(values, dtype=object)
        self._index = _index
        self._fp: Optional[tuple] = None
        self._derived: Optional[dict] = None

    def derived(self, key, build):
        """``build()`` once per ``key`` over this dictionary: the value of
        a named pure function of the values, kept as long as the
        dictionary is (its values never change)."""
        if self._derived is None:
            self._derived = {}
        if key not in self._derived:
            self._derived[key] = build()
        return self._derived[key]

    @staticmethod
    def from_strings(strings: Sequence[Optional[str]]):
        """Build (dictionary, codes) from raw strings, codes in order of
        first appearance; None -> code 0."""
        uniq: Dict[str, int] = {}
        add = uniq.setdefault
        codes = np.fromiter((0 if s is None else add(s, len(uniq))
                             for s in strings), dtype=np.int32,
                            count=len(strings))
        if not uniq:
            uniq[""] = 0
        vals = np.empty(len(uniq), dtype=object)
        for s, c in uniq.items():
            vals[c] = s
        return StringDictionary(vals, uniq), codes

    def __len__(self) -> int:
        return len(self.values)

    @property
    def index(self) -> dict:
        if self._index is None:
            self._index = {s: i for i, s in enumerate(self.values)}
        return self._index

    def rank_codes(self) -> np.ndarray:
        """rank[code] = collation rank of values[code]; for ORDER BY."""
        order = np.argsort(self.values.astype(str), kind="stable")
        ranks = np.empty(len(self.values), dtype=np.int32)
        ranks[order] = np.arange(len(self.values), dtype=np.int32)
        return ranks

    @property
    def fingerprint(self) -> tuple:
        if self._fp is None:
            import hashlib
            h = hashlib.blake2b(digest_size=16)
            for v in self.values:
                if v is None:
                    h.update(b"\xff\x00\x00\x00\x00")
                else:
                    b = str(v).encode("utf-8", "surrogatepass")
                    h.update(len(b).to_bytes(4, "little"))
                    h.update(b)
            self._fp = (len(self.values), h.digest())
        return self._fp

    def __eq__(self, other):
        if other is self:
            return True
        if not isinstance(other, StringDictionary):
            return NotImplemented
        return self.fingerprint == other.fingerprint

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(self.fingerprint)

    def merge(self, other: "StringDictionary"):
        """Unify with other; returns (merged, remap_self, remap_other)."""
        if other is self:
            ident = np.arange(len(self.values), dtype=np.int32)
            return self, ident, ident
        idx = dict(self.index)
        vals: List[str] = list(self.values)
        remap_other = np.empty(len(other.values), dtype=np.int32)
        for i, s in enumerate(other.values):
            c = idx.get(s)
            if c is None:
                c = len(vals)
                idx[s] = c
                vals.append(s)
            remap_other[i] = c
        merged = StringDictionary(np.asarray(vals, dtype=object), idx)
        remap_self = np.arange(len(self.values), dtype=np.int32)
        return merged, remap_self, remap_other


def key_hi_lane(col: "Column") -> Optional[torch.Tensor]:
    """The high lane that takes part in value equality and order: a long
    decimal's. A TIMESTAMP WITH TIME ZONE's ``data2`` holds its zone
    offset, which is display payload: equal instants in two zones are
    equal, so its instant lane compares alone."""
    if col.data2 is None or isinstance(col.type, TimestampTZType):
        return None
    return col.data2


def hi_lane_or_fill(col: "Column") -> torch.Tensor:
    """The column's high lane; where it has none, a decimal sign-extends
    its low lane (a negative low lane zero-filled would be off by 2^64)
    and any other type fills zeros. For concatenations of parts that
    differ in having one."""
    if col.data2 is not None:
        return col.data2
    if isinstance(col.type, DecimalType):
        return torch.where(col.data.to(torch.int64) < 0, -1, 0)
    return torch.zeros(col.capacity, dtype=torch.int64, device=col.device)


def take_clamped(lane: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``lane[indices]`` with indices clamped into range: the counterpart
    of ``jnp.take(mode="clip")`` (an out-of-range index on CUDA is a
    device assert, so every engine gather clamps first)."""
    n = lane.shape[0]
    idx = indices.to(device=lane.device, dtype=torch.int64)
    if n == 0:
        # an empty pool (no element anywhere) reads as zeros
        return torch.zeros(idx.shape, dtype=lane.dtype, device=lane.device)
    return torch.index_select(lane, 0, idx.clamp(0, n - 1))


@dataclass(frozen=True)
class Column:
    """One SQL column: value lane + validity lane (+ dictionary, + hi
    lane, + the flat pools of a sketch, ARRAY or MAP column, + the field
    columns of a ROW). Rows beyond the owning Batch's num_rows are
    garbage."""

    type: Type
    data: torch.Tensor
    valid: Optional[torch.Tensor] = None
    dictionary: Optional[StringDictionary] = None
    data2: Optional[torch.Tensor] = None
    elements: Optional["Column"] = None
    elements2: Optional["Column"] = None
    children: Optional[Tuple["Column", ...]] = None

    def __post_init__(self):
        if is_string(self.type) and self.dictionary is None:
            raise ValueError(f"string column of type {self.type} needs a "
                             "dictionary")
        object.__setattr__(self, "data", _as_lane(self.data))
        object.__setattr__(self, "valid", _as_lane(self.valid))
        object.__setattr__(self, "data2", _as_lane(self.data2))

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device: torch.device,
           non_blocking: bool = False) -> "Column":
        if self.data.device == device:
            return self

        def mv(t):
            return None if t is None else t.to(device,
                                               non_blocking=non_blocking)

        def mvc(c):
            return None if c is None else c.to(device, non_blocking)
        return replace(self, data=mv(self.data), valid=mv(self.valid),
                       data2=mv(self.data2), elements=mvc(self.elements),
                       elements2=mvc(self.elements2),
                       children=None if self.children is None
                       else tuple(mvc(c) for c in self.children))

    def gather(self, indices: torch.Tensor,
               fill_invalid: Optional[torch.Tensor] = None) -> "Column":
        """Row gather with clamped indices; gathered rows where
        ``fill_invalid`` is True become NULL (outer-join padding). The
        flat pools of a sketch, ARRAY or MAP column are shared (its
        offsets moved); a ROW's fields are gathered with it."""
        def g(t):
            return None if t is None else take_clamped(t, indices)
        valid = g(self.valid)
        if fill_invalid is not None:
            valid = ~fill_invalid if valid is None else valid & ~fill_invalid
        return replace(self, data=g(self.data), valid=valid,
                       data2=g(self.data2),
                       children=None if self.children is None
                       else tuple(c.gather(indices, fill_invalid)
                                  for c in self.children))

    def with_dictionary(self, dictionary: "StringDictionary",
                        remap: np.ndarray) -> "Column":
        """Rewrite codes through ``remap`` into a merged dictionary."""
        table = torch.from_numpy(np.asarray(remap, np.int32))
        return replace(self, data=take_clamped(table.to(self.device),
                                               self.data),
                       dictionary=dictionary)

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.device)
        return self.valid


# the python type of a numeric or boolean lane's own values
LANE_PY_TYPE = {"bigint": int, "integer": int, "smallint": int,
                "tinyint": int, "double": float, "real": float,
                "boolean": bool}


def _to_lane(values, typ: Type):
    """numpy-ify a python sequence for a non-string column; returns
    (data, valid|None, data2|None). ``data2`` is the Int128 high lane,
    present only for DECIMAL(p>18) and TIMESTAMP WITH TIME ZONE. A
    numeric or boolean lane whose values are all None or of its own
    python type is built by numpy in one call (the loop's values)."""
    dt = typ.np_dtype
    if dt is None:
        raise NotImplementedError(f"not yet ported: columns of type {typ}")
    py = LANE_PY_TYPE.get(typ.name)
    if py is not None:
        kinds = set(map(type, values))
        if kinds <= {py, type(None)}:
            if type(None) not in kinds:
                return np.array(values, dtype=dt), None, None
            valid = np.array([v is not None for v in values], dtype=bool)
            return (np.array([0 if v is None else v for v in values],
                             dtype=dt), valid, None)
    n = len(values)
    data = np.zeros(n, dtype=dt)
    valid = np.ones(n, dtype=bool)
    any_null = False
    long_decimal = isinstance(typ, DecimalType) and not typ.is_short
    is_tz = str(typ.name).endswith("with time zone")
    data2 = (np.zeros(n, dtype=np.int64)
             if long_decimal or is_tz else None)
    for i, v in enumerate(values):
        if v is None:
            valid[i] = False
            any_null = True
        elif is_tz:
            if isinstance(v, tuple):          # (utc_millis, offset_min)
                data[i], data2[i] = v
            elif isinstance(v, _dt.datetime):
                off = v.utcoffset()
                data2[i] = (0 if off is None
                            else int(off.total_seconds() // 60))
                naive = v.replace(tzinfo=None)
                data[i] = int((naive - _dt.datetime(1970, 1, 1))
                              .total_seconds() * 1000) \
                    - data2[i] * 60000
            else:
                data[i] = int(v)
        elif isinstance(v, _dt.datetime):
            data[i] = int((v - _dt.datetime(1970, 1, 1))
                          .total_seconds() * 1000)
        elif isinstance(v, _dt.date):
            data[i] = v.toordinal() - 719163  # 1970-01-01
        elif isinstance(typ, DecimalType):
            if isinstance(v, int):
                q = v * (10 ** typ.scale)
            else:
                # exact decimal scaling with HALF_UP; prec=80 keeps
                # DECIMAL(38) magnitudes exact
                import decimal
                ctx = decimal.Context(prec=80)
                q = int(decimal.Decimal(str(v)).scaleb(typ.scale, ctx)
                        .to_integral_value(rounding=decimal.ROUND_HALF_UP))
            if long_decimal:
                # two's-complement split: lo = unsigned low 64 bits
                # (stored in an int64 lane), hi carries the sign
                lo = q & ((1 << 64) - 1)
                data[i] = lo - (1 << 64) if lo >= (1 << 63) else lo
                data2[i] = q >> 64
            else:
                data[i] = q
        elif typ is BOOLEAN or typ.name == "boolean":
            data[i] = bool(v)
        else:
            data[i] = v
    return data, (valid if any_null else None), data2


def _offsets(lens: np.ndarray) -> np.ndarray:
    return (np.cumsum(lens) - lens).astype(np.int64)


def column_from_pylist(values: Sequence, typ: Type) -> Column:
    """Build a CPU Column from python values (tests / VALUES literals):
    an ARRAY from lists, a MAP from dicts, a ROW from sequences of its
    fields' values."""
    if isinstance(typ, (ArrayType, MapType)):
        valid = np.asarray([v is not None for v in values], dtype=bool)
        lens = np.asarray([0 if v is None else len(v) for v in values],
                          dtype=np.int64)
        flat = [x for v in values if v is not None
                for x in (v.items() if isinstance(typ, MapType) else v)]
        if isinstance(typ, ArrayType):
            pools = (column_from_pylist(flat or [None], typ.element), None)
        else:
            pools = (column_from_pylist([k for k, _ in flat] or [None],
                                        typ.key),
                     column_from_pylist([x for _, x in flat] or [None],
                                        typ.value))
        return Column(typ, _offsets(lens), None if valid.all() else valid,
                      None, lens, *pools)
    if isinstance(typ, RowType):
        valid = np.asarray([v is not None for v in values], dtype=bool)
        kids = tuple(column_from_pylist(
            [None if v is None else v[i] for v in values], ft)
            for i, (_, ft) in enumerate(typ.fields))
        return Column(typ, np.zeros(len(values), dtype=np.int8),
                      None if valid.all() else valid, children=kids)
    if is_string(typ):
        dictionary, codes = StringDictionary.from_strings(list(values))
        valid = np.asarray([v is not None for v in values], dtype=bool)
        return Column(typ, codes, None if valid.all() else valid,
                      dictionary)
    data, valid, data2 = _to_lane(values, typ)
    return Column(typ, data, valid, data2=data2)


@dataclass(frozen=True)
class Batch:
    """A batch of rows: ordered named Columns + row count. ``spilled``
    marks a batch that a join wrote to host memory on purpose (host
    spill): its lanes are CPU tensors, pinned when they came from a card,
    and the executor moves it back to its device before any operator
    reads it."""

    columns: Dict[str, Column]
    num_rows: NumRows
    spilled: bool = False

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    @property
    def capacity(self) -> int:
        for c in self.columns.values():
            return c.capacity
        return 0

    @property
    def device(self) -> torch.device:
        for c in self.columns.values():
            return c.device
        if isinstance(self.num_rows, torch.Tensor):
            return self.num_rows.device
        return torch.device("cpu")

    def column(self, name: str) -> Column:
        return self.columns[name]

    def num_rows_device(self) -> torch.Tensor:
        n = self.num_rows
        # a host count copied to the card waits for the card's stream
        with device_wait() if isinstance(n, int) else nullcontext():
            return torch.as_tensor(n, dtype=torch.int64, device=self.device)

    def num_rows_host(self) -> int:
        n = self.num_rows
        if isinstance(n, int):
            return n
        with device_wait():
            return int(n)

    def row_valid(self) -> torch.Tensor:
        """iota < num_rows over the capacity."""
        return (torch.arange(self.capacity, dtype=torch.int64,
                             device=self.device)
                < self.num_rows_device())

    def to(self, device: torch.device,
           non_blocking: bool = False) -> "Batch":
        n = self.num_rows
        if isinstance(n, torch.Tensor):
            n = n.to(device)
        return Batch({k: c.to(device, non_blocking)
                      for k, c in self.columns.items()}, n)

    def select_columns(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.num_rows)

    def rename(self, mapping: Dict[str, str]) -> "Batch":
        return Batch({mapping.get(k, k): c
                      for k, c in self.columns.items()}, self.num_rows)

    def gather(self, indices: torch.Tensor,
               num_rows: NumRows) -> "Batch":
        return Batch({k: c.gather(indices)
                      for k, c in self.columns.items()}, num_rows)

    def schema(self) -> Dict[str, Type]:
        return {k: c.type for k, c in self.columns.items()}

    def to_pylist(self) -> List[list]:
        """Rows as python lists (client result encoding). Lanes come to
        the host once, then rows are decoded there."""
        n = self.num_rows_host()
        out_cols = []
        for c in self.columns.values():
            data = c.data[:n].cpu().numpy()
            valid = (np.ones(n, dtype=bool) if c.valid is None
                     else c.valid[:n].cpu().numpy())
            hi = None if c.data2 is None else c.data2[:n].cpu().numpy()
            out_cols.append(_decode(c, data, valid, hi, n))
        return [list(row) for row in zip(*out_cols)] if out_cols else []


def _values(col: Column, n: int) -> list:
    """The first ``n`` rows of one column as python values."""
    return [r[0] for r in Batch({"c": col}, n).to_pylist()]


def _decode_nested(c: Column, data: np.ndarray, valid: np.ndarray,
                   lens: np.ndarray, n: int) -> list:
    """ARRAY rows as lists, MAP rows as dicts: only the pool entries the
    rows reach are gathered (on the pool's device) and decoded."""
    lens = np.where(valid, lens.astype(np.int64), 0)
    offs = _offsets(lens)
    total = int(lens.sum())
    owner = np.repeat(np.arange(n, dtype=np.int64), lens)
    idx = data.astype(np.int64)[owner] + np.arange(total) - offs[owner]
    idx = torch.from_numpy(idx).to(c.elements.device)
    keys = _values(c.elements.gather(idx), total)
    vals = (None if c.elements2 is None
            else _values(c.elements2.gather(idx), total))
    out = []
    for i in range(n):
        if not valid[i]:
            out.append(None)
            continue
        s, e = int(offs[i]), int(offs[i] + lens[i])
        out.append(keys[s:e] if vals is None
                   else dict(zip(keys[s:e], vals[s:e])))
    return out


def _decode(c: Column, data: np.ndarray, valid: np.ndarray,
            hi: Optional[np.ndarray], n: int) -> list:
    t = c.type
    if isinstance(t, (TDigestType, QDigestType)):
        from .ops.digest import sketches_to_base64 as digest_base64
        enc = digest_base64(data, hi, c.elements.data.cpu().numpy(),
                            c.elements2.data.cpu().numpy())
        return [enc[i] if valid[i] else None for i in range(n)]
    if isinstance(t, (ArrayType, MapType)):
        return _decode_nested(c, data, valid, hi, n)
    if isinstance(t, RowType):
        kids = [_values(ch, n) for ch in c.children]
        return [list(vals) if valid[i] else None
                for i, vals in enumerate(zip(*kids))] \
            if kids else [[] for _ in range(n)]
    if is_string(t):
        vals = c.dictionary.values
        col = [str(vals[int(data[i])]) if valid[i] else None
               for i in range(n)]
        if isinstance(t, CharType):
            col = [v if v is None else v.ljust(t.length) for v in col]
        return col
    if isinstance(t, DecimalType):
        import decimal as _dec
        s = t.scale
        col = []
        for i in range(n):
            if not valid[i]:
                col.append(None)
                continue
            if hi is not None:
                lo = int(data[i]) & ((1 << 64) - 1)
                q = (int(hi[i]) << 64) + lo
            else:
                q = int(data[i])
            col.append(q if not s else _dec.Decimal(q).scaleb(
                -s, _dec.Context(prec=80)))
        return col
    if isinstance(t, GeometryType):
        # a POINT column renders as WKT; a WKT-backed shape passes its
        # dictionary text through (ops/geo.py)
        if c.dictionary is not None:
            vals = c.dictionary.values
            return [str(vals[int(data[i])]) if valid[i] else None
                    for i in range(n)]
        from .ops.geo import point_text
        return [point_text(data[i], hi[i]) if valid[i] else None
                for i in range(n)]
    if t.name == "boolean":
        return [bool(data[i]) if valid[i] else None for i in range(n)]
    if t.name in ("real", "double"):
        return [float(data[i]) if valid[i] else None for i in range(n)]
    if t.name == "varbinary" and c.dictionary is not None:
        # a cast sketch: its wire string from the dictionary
        vals = c.dictionary.values
        return [str(vals[int(data[i])]) if valid[i] else None
                for i in range(n)]
    if t.name == "hyperloglog":
        # base64 of the engine's dense sketch framing, as a cast to
        # varbinary renders it (ops/hll.py)
        from .ops.hll import sketches_to_base64
        enc = sketches_to_base64(data, hi, c.elements.data.cpu().numpy(),
                                 t.bucket_bits)
        return [enc[i] if valid[i] else None for i in range(n)]
    if t.name == "date":
        epoch = _dt.date(1970, 1, 1).toordinal()
        return [_dt.date.fromordinal(int(data[i]) + epoch)
                if valid[i] else None for i in range(n)]
    if t.name.endswith("with time zone"):
        offs = hi if hi is not None else np.zeros(n, np.int64)
        col = []
        for i in range(n):
            if not valid[i]:
                col.append(None)
                continue
            tz = _dt.timezone(_dt.timedelta(minutes=int(offs[i])))
            v = (_dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
                 + _dt.timedelta(milliseconds=int(data[i])))
            col.append(v.astimezone(tz))
        return col
    if t.name.startswith("timestamp"):
        return [(_dt.datetime(1970, 1, 1)
                 + _dt.timedelta(milliseconds=int(data[i])))
                if valid[i] else None for i in range(n)]
    if t.name.startswith("time("):
        col = []
        for i in range(n):
            if not valid[i]:
                col.append(None)
                continue
            ms = int(data[i]) % 86400000
            col.append(_dt.time(ms // 3600000, (ms // 60000) % 60,
                                (ms // 1000) % 60, (ms % 1000) * 1000))
        return col
    if t.np_dtype is None:
        raise NotImplementedError(f"not yet ported: rows of type {t}")
    return [int(data[i]) if valid[i] else None for i in range(n)]


def _pad(col: Column, cap: int) -> Column:
    n = col.capacity
    if n >= cap:
        return col

    def p(t):
        if t is None:
            return None
        return torch.cat([t, torch.zeros(cap - n, dtype=t.dtype,
                                         device=t.device)])
    return replace(col, data=p(col.data), valid=p(col.valid),
                   data2=p(col.data2),
                   children=None if col.children is None
                   else tuple(_pad(c, cap) for c in col.children))


def pad_batch(batch: Batch, cap: int) -> Batch:
    return Batch({k: _pad(c, cap) for k, c in batch.columns.items()},
                 batch.num_rows)


def empty_batch(schema: Dict[str, Type], device: DeviceLike = None,
                capacity: int = 8) -> Batch:
    """A batch of no rows of ``schema`` on ``device``."""
    dev = resolve_device(device)
    cols = {}
    for name, typ in schema.items():
        if is_nested(typ):
            cols[name] = null_column(typ, capacity, dev)
        elif is_string(typ):
            d, _ = StringDictionary.from_strings([])
            cols[name] = Column(typ, torch.zeros(capacity, dtype=torch.int32,
                                                 device=dev), None, d)
        else:
            hi_lane = (isinstance(typ, DecimalType) and not typ.is_short
                       or isinstance(typ, TimestampTZType))
            cols[name] = Column(typ, torch.zeros(
                capacity, dtype=torch_dtype(typ), device=dev), None,
                data2=torch.zeros(capacity, dtype=torch.int64, device=dev)
                if hi_lane else None)
    return Batch(cols, 0)


def null_column(typ: Type, cap: int, device: torch.device) -> Column:
    """An all-NULL ARRAY, MAP, ROW or digest column of ``cap`` rows."""
    if isinstance(typ, (TDigestType, QDigestType)):
        from .types import DOUBLE
        pool = column_from_pylist([0.0], DOUBLE)
        col = Column(typ, np.zeros(1, np.int64), np.zeros(1, bool), None,
                     np.zeros(1, np.int64), pool, pool)
    else:
        col = column_from_pylist([None], typ)
    return _pad(col, cap).to(device)


def map_row_lanes(col: Column, fn) -> Column:
    """``fn`` over each row-aligned lane (values, validity, high lane, a
    ROW's fields); the flat pools are shared."""
    def f(t):
        return None if t is None else fn(t)
    # the constructor, not dataclasses.replace: this runs for every
    # column of every streamed chunk
    return Column(col.type, f(col.data), f(col.valid), col.dictionary,
                  f(col.data2), col.elements, col.elements2,
                  None if col.children is None
                  else tuple(map_row_lanes(k, fn) for k in col.children))


def slice_rows(batch: Batch, lo: int, hi: int) -> Batch:
    """Rows [lo, hi) of ``batch`` copied into lanes of their own, of
    ``capacity_for(hi - lo)`` rows, zero-padded, on the batch's device.
    A stored table is made of such slices: they hold none of the source's
    padding and keep none of its row lanes alive. The flat pools of a
    sketch, ARRAY or MAP column are shared, as a gather shares them."""
    n = max(hi - lo, 0)
    cap = capacity_for(max(n, 1), minimum=8)

    def lane(t):
        out = torch.zeros(cap, dtype=t.dtype, device=t.device)
        out[:n].copy_(t[lo:hi])
        return out
    return Batch({k: map_row_lanes(c, lane)
                  for k, c in batch.columns.items()}, n)


def batch_from_pylist(data: Dict[str, Sequence], schema: Dict[str, Type],
                      device: DeviceLike = None) -> Batch:
    """Build a Batch from python values on ``device`` (cuda unless the
    caller asks for the CPU), padded to its capacity bucket."""
    dev = resolve_device(device)
    cols = {}
    n = 0
    for name, typ in schema.items():
        cols[name] = column_from_pylist(data[name], typ)
        n = len(data[name])
    return pad_batch(Batch(cols, n), capacity_for(n, minimum=8)).to(dev)


def batch_from_numpy(lanes: Mapping[str, Tuple[np.ndarray,
                                               Optional[np.ndarray],
                                               Optional[np.ndarray]]],
                     types: Mapping[str, Type],
                     dictionaries: Mapping[str, np.ndarray],
                     num_rows: int, device: DeviceLike = None) -> Batch:
    """Build a Batch from numpy lanes: ``lanes[name] = (data, valid,
    data2)`` (valid/data2 may be None), ``dictionaries[name]`` the value
    array of each string column. Lanes shorter than the capacity bucket
    of ``num_rows`` are padded to it. This is how a table made elsewhere
    (for example by the JAX engine) enters this engine."""
    dev = resolve_device(device)
    cols: Dict[str, Column] = {}
    for name, (data, valid, data2) in lanes.items():
        typ = types[name]
        dic = None
        if name in dictionaries:
            dic = StringDictionary(np.asarray(dictionaries[name],
                                              dtype=object))
        want = np.int32 if dic is not None else typ.np_dtype
        cols[name] = Column(
            typ, np.asarray(data, dtype=want),
            None if valid is None else np.asarray(valid, dtype=bool),
            dic, None if data2 is None else np.asarray(data2, np.int64))
    out = pad_batch(Batch(cols, int(num_rows)),
                    capacity_for(int(num_rows), minimum=8))
    return out.to(dev)

