"""Columnar data model over torch tensors: Column / Batch.

Counterpart of ``trino_tpu/columnar.py``, with the same contract:

- A ``Column`` is a value lane (``data``), an optional validity lane
  (``valid``; None means every live row is non-null), for string types a
  host-side ``StringDictionary`` whose int32 codes are the lane, and for
  DECIMAL(p>18) a high int64 lane (``data2``).
- A ``Batch`` is named Columns plus a row count. Lane length
  ("capacity") is a power-of-two bucket >= ``num_rows``; rows past
  ``num_rows`` are masked, never trusted. Capacity stays >= 8.
- ``num_rows`` is a python int (host-known) or a 0-d int64 tensor on the
  batch's device (data-dependent, e.g. after a filter), so a filter does
  not have to wait for the device.

Lanes are tensors on one device. A numpy lane handed to ``Column`` is
wrapped without a copy as a CPU tensor; ``Batch.to`` moves a batch.
ARRAY/MAP/ROW columns are not ported yet.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import DeviceLike, capacity_for, resolve_device
from .types import (BOOLEAN, CharType, DecimalType, Type, is_string)

NumRows = Union[int, torch.Tensor]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(typ: Type) -> torch.dtype:
    """The torch dtype of a type's value lane."""
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

    __slots__ = ("values", "_index", "_fp")

    def __init__(self, values: np.ndarray, _index: Optional[dict] = None):
        self.values = np.asarray(values, dtype=object)
        self._index = _index
        self._fp: Optional[tuple] = None

    @staticmethod
    def from_strings(strings: Sequence[Optional[str]]):
        """Build (dictionary, codes) from raw strings; None -> code 0."""
        uniq: Dict[str, int] = {}
        codes = np.empty(len(strings), dtype=np.int32)
        for i, s in enumerate(strings):
            if s is None:
                codes[i] = 0
                continue
            c = uniq.get(s)
            if c is None:
                c = uniq.setdefault(s, len(uniq))
            codes[i] = c
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


def take_clamped(lane: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``lane[indices]`` with indices clamped into range: the counterpart
    of ``jnp.take(mode="clip")`` (an out-of-range index on CUDA is a
    device assert, so every engine gather clamps first)."""
    n = lane.shape[0]
    idx = indices.to(device=lane.device, dtype=torch.int64)
    return torch.index_select(lane, 0, idx.clamp(0, max(n - 1, 0)))


@dataclass(frozen=True)
class Column:
    """One SQL column: value lane + validity lane (+ dictionary, + hi
    lane). Rows beyond the owning Batch's num_rows are garbage."""

    type: Type
    data: torch.Tensor
    valid: Optional[torch.Tensor] = None
    dictionary: Optional[StringDictionary] = None
    data2: Optional[torch.Tensor] = None

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
        return replace(self, data=mv(self.data), valid=mv(self.valid),
                       data2=mv(self.data2))

    def gather(self, indices: torch.Tensor,
               fill_invalid: Optional[torch.Tensor] = None) -> "Column":
        """Row gather with clamped indices; gathered rows where
        ``fill_invalid`` is True become NULL (outer-join padding)."""
        def g(t):
            return None if t is None else take_clamped(t, indices)
        valid = g(self.valid)
        if fill_invalid is not None:
            valid = ~fill_invalid if valid is None else valid & ~fill_invalid
        return replace(self, data=g(self.data), valid=valid,
                       data2=g(self.data2))

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


def _to_lane(values, typ: Type):
    """numpy-ify a python sequence for a non-string column; returns
    (data, valid|None, data2|None). ``data2`` is the Int128 high lane,
    present only for DECIMAL(p>18) and TIMESTAMP WITH TIME ZONE."""
    dt = typ.np_dtype
    if dt is None:
        raise NotImplementedError(f"not yet ported: columns of type {typ}")
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


def column_from_pylist(values: Sequence, typ: Type) -> Column:
    """Build a CPU Column from python values (tests / VALUES literals)."""
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
        return torch.as_tensor(self.num_rows, dtype=torch.int64,
                               device=self.device)

    def num_rows_host(self) -> int:
        n = self.num_rows
        return n if isinstance(n, int) else int(n)

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


def _decode(c: Column, data: np.ndarray, valid: np.ndarray,
            hi: Optional[np.ndarray], n: int) -> list:
    t = c.type
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
    if t.name == "boolean":
        return [bool(data[i]) if valid[i] else None for i in range(n)]
    if t.name in ("real", "double"):
        return [float(data[i]) if valid[i] else None for i in range(n)]
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
                   data2=p(col.data2))


def pad_batch(batch: Batch, cap: int) -> Batch:
    return Batch({k: _pad(c, cap) for k, c in batch.columns.items()},
                 batch.num_rows)


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

