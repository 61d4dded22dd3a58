"""Parquet reader producing Batches on the caller's device.

Counterpart of ``trino_tpu/formats/parquet.py``, reading the same files
to the same rows: the thrift-compact footer, the RLE/bit-packed hybrid,
the PLAIN and dictionary encodings, data pages v1 and v2 and the codecs
(UNCOMPRESSED, SNAPPY in pure python, GZIP, ZSTD through ``zstandard``)
are the reference's. What differs is that no loop runs over values:

- only the byte ranges of the wanted column chunks are read;
- fixed-width PLAIN pages are the page's bytes viewed as values;
  definition levels and dictionary ids decode run by run (a slice fill
  for an RLE run, ``np.unpackbits`` for a bit-packed one);
- BYTE_ARRAY values of one length are found by a fixed-width view;
  otherwise the length walk, sequential by nature, is a C loop
  (``csrc/byte_array_walk.c``); strings land as a dictionary column
  coded by first appearance, found on the device (``formats/lanes.py``),
  each distinct value decoded once;
- present values are placed by a mask on the device;
- columns decode side by side, a thread each.

Flat schemas: BOOLEAN, INT32 (DATE), INT64 (TIMESTAMP_MILLIS/MICROS to
TIMESTAMP(3)), FLOAT, DOUBLE, BYTE_ARRAY (VARCHAR); optional columns by
definition levels.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Batch, Column
from ..config import DeviceLike, capacity_for, resolve_device
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL,
                     TimestampType, Type, VarcharType)
from . import lanes as L

MAGIC = b"PAR1"


# --------------------------------------------------------------------------
# thrift compact protocol (the footer/page-header wire format)
# --------------------------------------------------------------------------

class _TReader:
    """Minimal thrift compact-protocol struct reader over any buffer
    (bytes, or a memoryview of a column chunk): structs become
    {field_id: value} dicts; only what parquet.thrift needs."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def _zigzag(self) -> int:
        v = self._varint()
        return (v >> 1) ^ -(v & 1)

    def _bytes(self) -> bytes:
        n = self._varint()
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def _value(self, ttype: int):
        if ttype == 1:
            return True
        if ttype == 2:
            return False
        if ttype in (3, 4, 5, 6):
            return self._zigzag()
        if ttype == 7:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ttype == 8:
            return self._bytes()
        if ttype in (9, 10):
            return self._list()
        if ttype == 12:
            return self.struct()
        raise ValueError(f"thrift type {ttype} unsupported")

    def _list(self):
        head = self._byte()
        size = head >> 4
        etype = head & 0x0F
        if size == 15:
            size = self._varint()
        if etype == 1:          # bool list elements carry their value
            return [self._byte() == 1 for _ in range(size)]
        return [self._value(etype) for _ in range(size)]

    def struct(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        fid = 0
        while True:
            head = self._byte()
            if head == 0:
                return out
            delta = head >> 4
            ttype = head & 0x0F
            if delta == 0:
                fid = self._zigzag()
            else:
                fid += delta
            if ttype in (1, 2):
                out[fid] = ttype == 1
            else:
                out[fid] = self._value(ttype)


# --------------------------------------------------------------------------
# snappy (pure python; raw block format)
# --------------------------------------------------------------------------

def snappy_decompress(data) -> bytes:
    """Raw Snappy block decode: preamble varint = uncompressed length,
    then literal / copy tags."""
    pos = 0
    n = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:                       # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(data[pos:pos + extra],
                                        "little") + 1
                pos += extra
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:                       # copy, 1-byte offset
            length = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0:
            raise ValueError("snappy: zero copy offset")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:
            for i in range(length):         # self-overlapping copy
                out.append(out[start + i])
    if len(out) != n:
        raise ValueError("snappy: length mismatch")
    return bytes(out)


def _decompress(data, codec: int, uncompressed: int):
    if codec == 0:
        return data
    if codec == 1:
        return snappy_decompress(bytes(data))
    if codec == 2:
        return zlib.decompress(data, 31)    # gzip wrapper
    if codec == 6:
        try:
            import zstandard
        except ImportError:
            raise ValueError("zstd codec requires the zstandard module")
        return zstandard.ZstdDecompressor().decompress(
            bytes(data), max_output_size=max(uncompressed, 1))
    raise ValueError(f"compression codec {codec} unsupported")


def _u8(buf) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.uint8)


# --------------------------------------------------------------------------
# RLE / bit-packed hybrid
# --------------------------------------------------------------------------

def _read_rle_bitpacked(buf, bit_width: int, count: int) -> np.ndarray:
    """The RLE/bit-packing hybrid used for levels and dictionary ids: a
    loop over runs, numpy inside each (a slice fill for an RLE run,
    ``np.unpackbits`` for a bit-packed one)."""
    out = np.empty(count, dtype=np.int64)
    got = 0
    pos = 0
    raw = _u8(buf)
    byte_width = (bit_width + 7) // 8
    weights = (1 << np.arange(bit_width)).astype(np.int64)
    while got < count and pos < len(raw):
        header = 0
        shift = 0
        while True:
            b = int(raw[pos])
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:                       # bit-packed run
            groups = header >> 1
            nvals = groups * 8
            take = min(nvals, count - got)
            nbytes = groups * bit_width
            if bit_width:
                need = (take * bit_width + 7) // 8
                bits = np.unpackbits(raw[pos:pos + need], bitorder="little")
                vals = bits[:take * bit_width].reshape(take, bit_width)
                out[got:got + take] = vals @ weights
            else:
                out[got:got + take] = 0
            pos += nbytes
            got += take
        else:                                # rle run
            run = header >> 1
            v = int.from_bytes(raw[pos:pos + byte_width].tobytes(),
                               "little") if byte_width else 0
            pos += byte_width
            take = min(run, count - got)
            out[got:got + take] = v
            got += take
    return out[:got] if got < count else out


def _present(buf, count: int) -> Optional[np.ndarray]:
    """Definition levels (bit width 1) as a mask of the present values;
    None when one RLE run says every value is present."""
    raw = _u8(buf)
    header, pos, shift = 0, 0, 0
    while pos < len(raw):
        b = int(raw[pos])
        pos += 1
        header |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if not header & 1 and header >> 1 >= count and pos < len(raw) \
            and raw[pos] == 1:
        return None
    return _read_rle_bitpacked(buf, 1, count) == 1


# --------------------------------------------------------------------------
# metadata model
# --------------------------------------------------------------------------

@dataclass
class _ColumnInfo:
    name: str
    physical: int                # parquet Type enum
    converted: Optional[int]
    optional: bool
    logical: Optional[dict] = None


@dataclass
class _ChunkInfo:
    column: _ColumnInfo
    codec: int
    num_values: int
    data_offset: int
    dict_offset: Optional[int]
    total_compressed: int = 0


@dataclass
class ParquetMetadata:
    num_rows: int
    columns: List[_ColumnInfo]
    row_groups: List[List[_ChunkInfo]]   # per group, per column
    group_rows: List[int]


_PHYS_BOOLEAN, _PHYS_INT32, _PHYS_INT64, _PHYS_INT96 = 0, 1, 2, 3
_PHYS_FLOAT, _PHYS_DOUBLE, _PHYS_BYTE_ARRAY, _PHYS_FIXED = 4, 5, 6, 7


def _sql_type(c: _ColumnInfo) -> Type:
    if c.physical == _PHYS_BOOLEAN:
        return BOOLEAN
    if c.physical == _PHYS_INT32:
        if c.converted == 6:                 # DATE
            return DATE
        return INTEGER
    if c.physical == _PHYS_INT64:
        if c.converted in (9, 10):           # TIMESTAMP_MILLIS/MICROS
            return TimestampType(3)
        if c.logical is not None and 8 in c.logical:
            return TimestampType(3)          # logicalType TIMESTAMP
        return BIGINT
    if c.physical == _PHYS_FLOAT:
        return REAL
    if c.physical == _PHYS_DOUBLE:
        return DOUBLE
    if c.physical == _PHYS_BYTE_ARRAY:
        return VarcharType(None)
    raise ValueError(f"parquet physical type {c.physical} unsupported "
                     f"for column {c.name}")


def read_metadata(path: str) -> ParquetMetadata:
    """Footer parse (reference: trino-parquet MetadataReader.java): the
    file's last 8 bytes, then its footer, nothing else."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(4)
        if size < 12:
            raise ValueError(f"{path}: not a parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if head != MAGIC or tail[4:] != MAGIC:
            raise ValueError(f"{path}: not a parquet file")
        flen = int.from_bytes(tail[:4], "little")
        f.seek(size - 8 - flen)
        footer = _TReader(f.read(flen)).struct()
    schema = footer[2]
    cols: List[_ColumnInfo] = []
    # schema[0] is the root group; flat children follow
    for el in schema[1:]:
        if el.get(5):                        # num_children -> nested
            raise ValueError("nested parquet schemas are not supported")
        cols.append(_ColumnInfo(
            name=el[4].decode(),
            physical=el.get(1, 0),
            converted=el.get(6),
            optional=el.get(3, 0) == 1,
            logical=el.get(10)))
    groups: List[List[_ChunkInfo]] = []
    group_rows: List[int] = []
    for rg in footer.get(4, []):
        chunks: List[_ChunkInfo] = []
        for i, cc in enumerate(rg[1]):
            md = cc[3]
            chunks.append(_ChunkInfo(
                column=cols[i],
                codec=md.get(4, 0),
                num_values=md[5],
                data_offset=md[9],
                dict_offset=md.get(11),
                total_compressed=md.get(7, 0)))
        groups.append(chunks)
        group_rows.append(rg.get(3, 0))
    return ParquetMetadata(footer[3], cols, groups, group_rows)


# --------------------------------------------------------------------------
# column chunk reader
# --------------------------------------------------------------------------

_NP_FOR_PHYS = {
    _PHYS_INT32: np.dtype("<i4"), _PHYS_INT64: np.dtype("<i8"),
    _PHYS_FLOAT: np.dtype("<f4"), _PHYS_DOUBLE: np.dtype("<f8"),
}

_walk = None


def _byte_array_walk(raw: np.ndarray, n: int) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """(starts, lengths) of the n PLAIN BYTE_ARRAY values in ``raw``."""
    global _walk
    if _walk is None:
        from ..ops.native import load_c
        fn = load_c("byte_array_walk").byte_array_walk
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int64
        _walk = fn
    raw = np.ascontiguousarray(raw)
    starts = np.empty(n, np.int64)
    lengths = np.empty(n, np.int64)
    if n and _walk(raw.ctypes.data, len(raw), n, starts.ctypes.data,
                   lengths.ctypes.data) < 0:
        raise ValueError("parquet: a BYTE_ARRAY value runs past its page")
    return starts, lengths


def _fixed_width(raw: np.ndarray, n: int) -> Optional[int]:
    """L when the page's n BYTE_ARRAY values all have the length L (each
    length word then sits 4 + L bytes after the last: no walk needed)."""
    if n == 0 or len(raw) < 4:
        return None
    width = int.from_bytes(raw[:4].tobytes(), "little")
    if len(raw) < n * (4 + width):
        return None
    words = raw[:n * (4 + width)].reshape(n, 4 + width)[:, :4]
    return width if bool((words == raw[:4]).all()) else None


class _Values:
    """One column's decoded present values, page after page: a numpy
    array, or byte ranges (buffer, starts, lengths) for BYTE_ARRAY, the
    ranges on the device."""

    def __init__(self, device):
        self.device = device
        self.arrays: List[np.ndarray] = []
        self.ranges: List[Tuple[np.ndarray, L.Lane, L.Lane]] = []
        self.present: List[np.ndarray] = []
        self.any_null = False


def _plain(phys: int, raw: np.ndarray, n: int, out: _Values) -> None:
    if phys in _NP_FOR_PHYS:
        # a view of the page's bytes (torch takes unaligned values)
        dt = _NP_FOR_PHYS[phys]
        out.arrays.append(raw[:n * dt.itemsize].view(dt))
    elif phys == _PHYS_BOOLEAN:
        bits = np.unpackbits(raw[:(n + 7) // 8], bitorder="little")
        out.arrays.append(bits[:n].astype(bool))
    elif phys == _PHYS_BYTE_ARRAY:
        width = _fixed_width(raw, n)
        if width is not None:
            starts = torch.arange(n, dtype=torch.int64,
                                  device=out.device) * (4 + width) + 4
            lengths = torch.full((n,), width, dtype=torch.int64,
                                 device=out.device)
        else:
            starts, lengths = _byte_array_walk(raw, n)
        out.ranges.append((raw, starts, lengths))
    else:
        raise ValueError(f"PLAIN decode for physical {phys} unsupported")


def _dictionary(phys: int, raw: np.ndarray, n: int, device):
    d = _Values(device)
    _plain(phys, raw, n, d)
    if d.ranges:
        blob, starts, lengths = d.ranges[0]
        return blob, L.to_device(starts, device), L.to_device(lengths,
                                                               device)
    return d.arrays[0]


def _read_chunk(f, chunk: _ChunkInfo, out: _Values) -> None:
    """Every page of one column chunk, read as one byte range of the
    file, into ``out``."""
    col = chunk.column
    start = chunk.dict_offset if chunk.dict_offset is not None \
        else chunk.data_offset
    if chunk.dict_offset is not None and chunk.dict_offset <= 0:
        start = chunk.data_offset            # writers that leave it 0
    f.seek(start)
    size = chunk.total_compressed or (os.fstat(f.fileno()).st_size - start)
    data = np.fromfile(f, dtype=np.uint8, count=size)
    view = memoryview(data)
    dictionary = None
    pos = 0
    remaining = chunk.num_values
    while remaining > 0:
        rd = _TReader(view, pos)
        header = rd.struct()
        page_type = header[1]
        comp_size = header[3]
        uncomp_size = header[2]
        body = data[rd.pos:rd.pos + comp_size]
        pos = rd.pos + comp_size
        if page_type == 2:                   # dictionary page
            raw = _u8(_decompress(body, chunk.codec, uncomp_size))
            dictionary = _dictionary(col.physical, raw, header[7][1],
                                     out.device)
            continue
        if page_type == 0:                   # data page v1
            dp = header[5]
            nvals = dp[1]
            encoding = dp[2]
            raw = _u8(_decompress(body, chunk.codec, uncomp_size))
            off = 0
            if col.optional:
                dl_len = int.from_bytes(raw[:4].tobytes(), "little")
                off = 4
                present = _present(raw[off:off + dl_len], nvals)
                off += dl_len
            else:
                present = None
        elif page_type == 3:                 # data page v2
            dp = header[8]
            nvals = dp[1]
            encoding = dp[4]
            dl_len = dp.get(5, 0)
            rl_len = dp.get(6, 0)
            payload = body[rl_len + dl_len:]
            if dp.get(7, True):
                payload = _decompress(payload, chunk.codec,
                                      uncomp_size - rl_len - dl_len)
            raw = _u8(payload)
            off = 0
            if col.optional and dl_len:
                present = _present(body[rl_len:rl_len + dl_len], nvals)
            else:
                present = None
        else:
            raise ValueError(f"page type {page_type} unsupported")
        if present is not None and len(present) < nvals:
            present = np.concatenate(
                [present, np.zeros(nvals - len(present), bool)])
        ndef = nvals if present is None else int(present.sum())
        if encoding == 0:                    # PLAIN
            _plain(col.physical, raw[off:], ndef, out)
        elif encoding in (2, 8):             # PLAIN_/RLE_DICTIONARY
            if dictionary is None:
                raise ValueError("dictionary page missing")
            bw = int(raw[off])
            ids = _read_rle_bitpacked(raw[off + 1:], bw, ndef)
            if isinstance(dictionary, tuple):
                dblob, dstarts, dlens = dictionary
                ids = L.to_device(ids, out.device).clamp(
                    0, max(len(dstarts) - 1, 0))
                out.ranges.append((dblob, dstarts[ids], dlens[ids]))
            else:
                out.arrays.append(dictionary[np.clip(
                    ids, 0, max(len(dictionary) - 1, 0))])
        else:
            raise ValueError(f"encoding {encoding} unsupported")
        out.present.append(np.ones(nvals, bool) if present is None
                           else present)
        out.any_null |= present is not None and not present.all()
        remaining -= nvals


def read_parquet(path: str, columns: Optional[Sequence[str]] = None,
                 row_group: Optional[int] = None,
                 device: DeviceLike = None) -> Batch:
    """Read a parquet file (or one row group) into a Batch on ``device``
    (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    meta = read_metadata(path)
    want = list(columns) if columns is not None \
        else [c.name for c in meta.columns]
    groups = meta.row_groups if row_group is None \
        else [meta.row_groups[row_group]]
    n = sum(meta.group_rows) if row_group is None \
        else meta.group_rows[row_group]
    cap = capacity_for(max(n, 1), minimum=8)
    wanted = set(want)
    infos = [c for c in meta.columns if c.name in wanted]

    def column(info: _ColumnInfo) -> Column:
        vals = _Values(dev)
        with open(path, "rb") as f:
            for chunks in groups:
                for chunk in chunks:
                    if chunk.column.name == info.name:
                        _read_chunk(f, chunk, vals)
        rows = sum(len(p) for p in vals.present)
        return _to_column(info, _sql_type(info), vals, rows, cap, dev)

    # a column a thread: numpy, the C walk and torch release the GIL
    cols = dict(zip([c.name for c in infos], L.each_column(column, infos)))
    return Batch(cols, n)


def _to_column(info: _ColumnInfo, t: Type, vals: _Values, n: int, cap: int,
               device) -> Column:
    present = (np.concatenate(vals.present) if vals.any_null else None)
    if isinstance(t, VarcharType):
        blob, starts, lengths = L.concat_ranges(vals.ranges, device)
        return L.string_column(t, blob, starts, lengths, present, n, cap,
                               device)
    data = (vals.arrays[0] if len(vals.arrays) == 1
            else np.concatenate(vals.arrays) if vals.arrays
            else np.zeros(0, t.np_dtype))
    if t.name == "timestamp(3)" and info.converted == 10:
        data = data // 1000                  # micros -> millis
    return L.numeric_column(t, data.astype(t.np_dtype, copy=False),
                            present, n, cap, device)


def schema_of(path: str) -> Dict[str, Type]:
    meta = read_metadata(path)
    return {c.name: _sql_type(c) for c in meta.columns}


def num_row_groups(path: str) -> int:
    return len(read_metadata(path).row_groups)
