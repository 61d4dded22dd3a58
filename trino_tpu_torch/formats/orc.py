"""ORC reader producing Batches on the caller's device.

Counterpart of ``trino_tpu/formats/orc.py``, reading the same files to
the same rows: the postscript, footer and stripe protobufs, the
compression framing (ZLIB, SNAPPY, ZSTD), RLE v1 and v2 (patched base
included), the byte and boolean RLE and the typed column readers are the
reference's. What differs:

- only the file's tail and the wanted columns' streams are read;
- RLE v1 and byte RLE streams made only of literal groups (the shape the
  writers here make) decode with no loop over values, the integers on
  the caller's device: varint ends are found by their high bit
  (``formats/lanes.py``); other layouts (runs, as third-party writers
  make them) walk run by run, numpy inside each; RLE v2 keeps its loop
  over runs;
- DECIMAL mantissas decode as one vector of varints;
- strings land as a dictionary column coded by first appearance, each
  distinct value decoded once; present values are placed by a mask on
  the device;
- columns decode side by side, a thread each.

Flat schemas: a root STRUCT of BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT,
DOUBLE, STRING, VARCHAR, CHAR, DATE, TIMESTAMP, DECIMAL(p<=18), BINARY
(as varchar); DIRECT, DIRECT_V2, DICTIONARY and DICTIONARY_V2.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Batch, Column
from ..config import DeviceLike, capacity_for, resolve_device
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL,
                     SMALLINT, TINYINT, DecimalType, TimestampType, Type,
                     VarcharType, CharType, VARCHAR, is_string)
from . import lanes as L

MAGIC = b"ORC"

# orc_proto.proto CompressionKind
_NONE, _ZLIB, _SNAPPY, _LZO, _LZ4, _ZSTD = range(6)

# orc_proto.proto Type.Kind
(K_BOOLEAN, K_BYTE, K_SHORT, K_INT, K_LONG, K_FLOAT, K_DOUBLE, K_STRING,
 K_BINARY, K_TIMESTAMP, K_LIST, K_MAP, K_STRUCT, K_UNION, K_DECIMAL,
 K_DATE, K_VARCHAR, K_CHAR) = range(18)

# Stream.Kind
(S_PRESENT, S_DATA, S_LENGTH, S_DICTIONARY_DATA, S_DICTIONARY_COUNT,
 S_SECONDARY, S_ROW_INDEX, S_BLOOM_FILTER) = range(8)

# ColumnEncoding.Kind
E_DIRECT, E_DICTIONARY, E_DIRECT_V2, E_DICTIONARY_V2 = range(4)

# ORC timestamp epoch: 2015-01-01 00:00:00 UTC, seconds
_TS_EPOCH = 1420070400

# the writers' literal group size (RLE v1 and byte RLE)
GROUP = 128


# --------------------------------------------------------------------------
# minimal protobuf wire-format reader
# --------------------------------------------------------------------------

def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def pb_decode(buf: bytes) -> Dict[int, list]:
    """Wire-level decode: {field_number: [raw values]} — varints stay
    ints, length-delimited stay bytes (decoded further by the caller)."""
    out: Dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _varint(buf, pos)
        elif wt == 1:
            v = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"orc: unsupported protobuf wire type {wt}")
        out.setdefault(fno, []).append(v)
    return out


def _packed_uints(vals: list) -> List[int]:
    """A repeated uint field arrives either as N varints or as packed
    length-delimited bytes."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, int):
            out.append(v)
        else:
            pos = 0
            while pos < len(v):
                u, pos = _varint(v, pos)
                out.append(u)
    return out


# --------------------------------------------------------------------------
# compression framing
# --------------------------------------------------------------------------

def _decompress_block(kind: int, data: bytes) -> bytes:
    if kind == _ZLIB:
        return zlib.decompress(data, -15)
    if kind == _SNAPPY:
        from .parquet import snappy_decompress
        return snappy_decompress(data)
    if kind == _ZSTD:
        try:
            import zstandard
        except ImportError:
            raise ValueError(
                "orc: zstd codec requires the zstandard module")
        return zstandard.ZstdDecompressor().decompressobj().decompress(data)
    raise ValueError(f"orc: unsupported compression kind {kind}")


def _read_stream(raw: bytes, kind: int) -> bytes:
    """Un-frame an ORC compressed stream: 3-byte chunk headers of
    (length << 1 | isOriginal), little-endian."""
    if kind == _NONE:
        return raw
    out = bytearray()
    pos = 0
    n = len(raw)
    while pos + 3 <= n:
        h = raw[pos] | (raw[pos + 1] << 8) | (raw[pos + 2] << 16)
        pos += 3
        ln = h >> 1
        chunk = raw[pos:pos + ln]
        pos += ln
        out += chunk if h & 1 else _decompress_block(kind, chunk)
    return out


# --------------------------------------------------------------------------
# RLE decoders
# --------------------------------------------------------------------------

def _zigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)) ^ (-(u & np.uint64(1))).astype(
        np.uint64)).astype(np.int64)


def _u8(buf) -> np.ndarray:
    return np.frombuffer(buf, np.uint8)


def _byte_rle(buf: bytes, count: int) -> np.ndarray:
    """Byte-level RLE (used for PRESENT/boolean bit streams and BYTE)."""
    fast = L.byte_groups(_u8(buf), count, GROUP)
    if fast is not None:
        return fast
    out = np.empty(count, np.uint8)
    got = 0
    pos = 0
    while got < count and pos < len(buf):
        ctrl = buf[pos]
        pos += 1
        if ctrl < 128:                  # run
            run = min(ctrl + 3, count - got)
            out[got:got + run] = buf[pos]
            pos += 1
            got += run
        else:                           # literals
            lit = min(256 - ctrl, count - got)
            out[got:got + lit] = np.frombuffer(buf, np.uint8, lit, pos)
            pos += 256 - ctrl
            got += lit
    return out[:got]


def _bool_bits(buf: bytes, count: int) -> np.ndarray:
    by = _byte_rle(buf, (count + 7) // 8)
    bits = np.unpackbits(by)  # MSB first
    return bits[:count].astype(bool)


def _sleb128(buf: bytes, pos: int) -> Tuple[int, int]:
    """Signed varint (used by RLEv1 base and DECIMAL mantissas):
    unbounded zigzag."""
    u, pos = _varint(buf, pos)
    return (u >> 1) ^ -(u & 1), pos


_WIDTH_TABLE = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                17, 18, 19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48,
                56, 64]


def _unpack_bits(buf: bytes, pos: int, count: int, width: int
                 ) -> Tuple[np.ndarray, int]:
    """MSB-first bit unpacking of `count` values of `width` bits."""
    nbytes = (count * width + 7) // 8
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, pos))
    bits = bits[:count * width].reshape(count, width).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(width - 1, -1, -1,
                                         dtype=np.uint64))
    return bits @ weights, pos + nbytes


def _rle_v2(buf: bytes, count: int, signed: bool) -> np.ndarray:
    """Integer RLEv2: SHORT_REPEAT / DIRECT / PATCHED_BASE / DELTA."""
    chunks: List[np.ndarray] = []
    got = 0
    pos = 0
    while got < count and pos < len(buf):
        first = buf[pos]
        enc = first >> 6
        if enc == 0:                    # SHORT_REPEAT
            nbytes = ((first >> 3) & 0x7) + 1
            run = (first & 0x7) + 3
            val = int.from_bytes(buf[pos + 1:pos + 1 + nbytes], "big")
            pos += 1 + nbytes
            if signed:
                val = (val >> 1) ^ -(val & 1)
            chunks.append(np.full(run, val, np.int64))
            got += run
        elif enc == 1:                  # DIRECT
            width = _WIDTH_TABLE[(first >> 1) & 0x1F]
            ln = ((first & 1) << 8 | buf[pos + 1]) + 1
            pos += 2
            vals, pos = _unpack_bits(buf, pos, ln, width)
            v = _zigzag(vals) if signed else vals.astype(np.int64)
            chunks.append(v)
            got += ln
        elif enc == 2:                  # PATCHED_BASE
            width = _WIDTH_TABLE[(first >> 1) & 0x1F]
            ln = ((first & 1) << 8 | buf[pos + 1]) + 1
            third, fourth = buf[pos + 2], buf[pos + 3]
            bw = (third >> 5) + 1       # base width, bytes
            pw = _WIDTH_TABLE[third & 0x1F]
            pgw = (fourth >> 5) + 1     # patch gap width, bits
            pll = fourth & 0x1F         # patch list length
            pos += 4
            base = int.from_bytes(buf[pos:pos + bw], "big")
            sign_mask = 1 << (bw * 8 - 1)
            if base & sign_mask:        # sign-magnitude
                base = -(base & (sign_mask - 1))
            pos += bw
            vals, pos = _unpack_bits(buf, pos, ln, width)
            if pll:
                patch, pos = _unpack_bits(buf, pos, pll, pgw + pw)
                idx = np.cumsum((patch >> np.uint64(pw)).astype(np.int64))
                pv = patch & np.uint64((1 << pw) - 1)
                np.bitwise_or.at(vals, idx, pv << np.uint64(width))
            chunks.append(vals.astype(np.int64) + base)
            got += ln
        else:                           # DELTA
            wcode = (first >> 1) & 0x1F
            ln = ((first & 1) << 8 | buf[pos + 1]) + 1
            pos += 2
            if signed:
                base, pos = _sleb128(buf, pos)
            else:
                base, pos = _varint(buf, pos)
            delta0, pos = _sleb128(buf, pos)
            out = np.empty(ln, np.int64)
            out[0] = base
            if ln > 1:
                out[1] = base + delta0
            if ln > 2:
                if wcode == 0:          # fixed delta
                    deltas = np.full(ln - 2, delta0, np.int64)
                else:
                    width = _WIDTH_TABLE[wcode]
                    dv, pos = _unpack_bits(buf, pos, ln - 2, width)
                    deltas = dv.astype(np.int64)
                    if delta0 < 0:
                        deltas = -deltas
                out[2:] = out[1] + np.cumsum(deltas)
            chunks.append(out)
            got += ln
    vals = (np.concatenate(chunks) if chunks
            else np.zeros(0, np.int64))
    return vals[:count]


def _rle_v1(buf: bytes, count: int, signed: bool, device) -> torch.Tensor:
    fast = L.varint_groups(_u8(buf), count, GROUP, device)
    if fast is not None:
        return L.zigzag_decode(fast) if signed else fast
    chunks: List[np.ndarray] = []
    got = 0
    pos = 0
    while got < count and pos < len(buf):
        ctrl = buf[pos]
        pos += 1
        if ctrl < 128:                  # run
            run = ctrl + 3
            delta = struct.unpack_from("b", buf, pos)[0]
            pos += 1
            if signed:
                base, pos = _sleb128(buf, pos)
            else:
                base, pos = _varint(buf, pos)
            chunks.append(base + delta * np.arange(run, dtype=np.int64))
            got += run
        else:
            lit = 256 - ctrl
            vals = np.empty(lit, np.int64)
            for i in range(lit):
                if signed:
                    vals[i], pos = _sleb128(buf, pos)
                else:
                    v, pos = _varint(buf, pos)
                    vals[i] = v
            chunks.append(vals)
            got += lit
    vals = (np.concatenate(chunks) if chunks
            else np.zeros(0, np.int64))
    return L.to_device(vals[:count], device)


def _read_ints(buf: bytes, count: int, signed: bool, encoding: int,
               device) -> torch.Tensor:
    """An integer stream's first ``count`` values, on ``device``."""
    if encoding in (E_DIRECT_V2, E_DICTIONARY_V2):
        return L.to_device(_rle_v2(buf, count, signed), device)
    return _rle_v1(buf, count, signed, device)


# --------------------------------------------------------------------------
# file metadata
# --------------------------------------------------------------------------

@dataclass
class OrcType:
    kind: int
    subtypes: List[int] = field(default_factory=list)
    field_names: List[str] = field(default_factory=list)
    max_length: int = 0
    precision: int = 0
    scale: int = 0


@dataclass
class StripeInfo:
    offset: int
    index_length: int
    data_length: int
    footer_length: int
    num_rows: int


@dataclass
class OrcMeta:
    compression: int
    types: List[OrcType]
    stripes: List[StripeInfo]
    num_rows: int


def read_meta(path: str) -> OrcMeta:
    """The postscript and footer, read from the file's tail alone."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 4 or f.read(3) != MAGIC:
            raise ValueError(f"{path}: not an ORC file")
        tail_len = min(size, 1 << 16)
        f.seek(size - tail_len)
        tail = f.read(tail_len)
        ps_len = tail[-1]
        ps = pb_decode(tail[-1 - ps_len:-1])
        footer_len = ps[1][0]
        if footer_len + ps_len + 1 > len(tail):
            f.seek(size - 1 - ps_len - footer_len)
            footer_raw = f.read(footer_len)
        else:
            footer_raw = tail[-1 - ps_len - footer_len:-1 - ps_len]
    compression = ps.get(2, [_NONE])[0]
    footer = pb_decode(_read_stream(footer_raw, compression))
    types: List[OrcType] = []
    for raw in footer.get(4, []):
        t = pb_decode(raw)
        types.append(OrcType(
            kind=t.get(1, [K_STRUCT])[0],
            subtypes=_packed_uints(t.get(2, [])),
            field_names=[b.decode() for b in t.get(3, [])],
            max_length=t.get(4, [0])[0],
            precision=t.get(5, [0])[0],
            scale=t.get(6, [0])[0]))
    stripes = []
    for raw in footer.get(3, []):
        s = pb_decode(raw)
        stripes.append(StripeInfo(
            s.get(1, [0])[0], s.get(2, [0])[0], s.get(3, [0])[0],
            s.get(4, [0])[0], s.get(5, [0])[0]))
    return OrcMeta(compression, types, stripes,
                   footer.get(6, [0])[0])


def _sql_type(t: OrcType) -> Type:
    if t.kind == K_BOOLEAN:
        return BOOLEAN
    if t.kind == K_BYTE:
        return TINYINT
    if t.kind == K_SHORT:
        return SMALLINT
    if t.kind == K_INT:
        return INTEGER
    if t.kind == K_LONG:
        return BIGINT
    if t.kind == K_FLOAT:
        return REAL
    if t.kind == K_DOUBLE:
        return DOUBLE
    if t.kind in (K_STRING, K_BINARY):
        return VARCHAR
    if t.kind == K_VARCHAR:
        return VarcharType(t.max_length or None)
    if t.kind == K_CHAR:
        return CharType(t.max_length or 1)
    if t.kind == K_DATE:
        return DATE
    if t.kind == K_TIMESTAMP:
        return TimestampType(3)
    if t.kind == K_DECIMAL:
        p = t.precision or 38
        if p > 18:
            raise ValueError("orc: DECIMAL precision > 18 unsupported")
        return DecimalType(p, t.scale)
    raise ValueError(f"orc: unsupported type kind {t.kind}")


def schema_of(path: str) -> Dict[str, Type]:
    meta = read_meta(path)
    root = meta.types[0]
    if root.kind != K_STRUCT:
        raise ValueError("orc: root type must be a struct")
    return {name: _sql_type(meta.types[sub])
            for name, sub in zip(root.field_names, root.subtypes)}


# --------------------------------------------------------------------------
# stripe reading
# --------------------------------------------------------------------------

@dataclass
class _Part:
    """One stripe's decoded column: the present values (an array, or
    byte ranges for strings) and the stripe's PRESENT mask (None: no
    nulls)."""
    rows: int
    present: Optional[np.ndarray]
    values: Optional[L.Lane] = None
    ranges: Optional[Tuple[np.ndarray, torch.Tensor, torch.Tensor]] = None


_POW10 = [10 ** i for i in range(19)]


def _column_from_streams(t: OrcType, n: int, enc: int, dict_size: int,
                         streams: Dict[int, bytes], device) -> _Part:
    """One stripe's column: booleans and floats on the host, integers
    and string byte ranges decoded on ``device``."""
    present = streams.get(S_PRESENT)
    valid = _bool_bits(present, n) if present is not None else None
    nnz = int(valid.sum()) if valid is not None else n
    data = streams.get(S_DATA, b"")
    part = _Part(n, valid)
    if t.kind == K_BOOLEAN:
        part.values = _bool_bits(data, nnz)
    elif t.kind == K_BYTE:
        part.values = _byte_rle(data, nnz).view(np.int8)
    elif t.kind in (K_SHORT, K_INT, K_LONG, K_DATE):
        part.values = _read_ints(data, nnz, True, enc, device)
    elif t.kind == K_FLOAT:
        part.values = np.frombuffer(data, "<f4", nnz).copy()
    elif t.kind == K_DOUBLE:
        part.values = np.frombuffer(data, "<f8", nnz).copy()
    elif t.kind == K_TIMESTAMP:
        secs = _read_ints(data, nnz, True, enc, device) + _TS_EPOCH
        nraw = _read_ints(streams.get(S_SECONDARY, b""), nnz, False, enc,
                          device)
        z = nraw & 7
        scale = torch.tensor(_POW10, device=device)[
            torch.where(z == 0, 0, z + 1)]
        nanos = (nraw >> 3) * scale
        # negative seconds with nonzero nanos count backwards
        secs = torch.where((secs < 0) & (nanos != 0), secs - 1, secs)
        part.values = secs * 1000 + torch.div(nanos, 1_000_000,
                                              rounding_mode="floor")
    elif t.kind == K_DECIMAL:
        mant = L.decode_varints(_u8(data), nnz, device)
        if mant is None:
            raise ValueError("orc: DECIMAL stream is short")
        mant = L.zigzag_decode(mant)
        scales = _read_ints(streams.get(S_SECONDARY, b""), nnz, True, enc,
                            device)
        adj = t.scale - scales
        pow10 = torch.tensor(_POW10, device=device)
        part.values = torch.div(mant * pow10[adj.clamp(0, 18)],
                                pow10[(-adj).clamp(0, 18)],
                                rounding_mode="floor")
    elif t.kind in (K_STRING, K_VARCHAR, K_CHAR, K_BINARY):
        if enc in (E_DICTIONARY, E_DICTIONARY_V2):
            codes = _read_ints(data, nnz, False, enc, device)
            lens = _read_ints(streams.get(S_LENGTH, b""), dict_size,
                              False, enc, device)
            blob = _u8(streams.get(S_DICTIONARY_DATA, b""))
            if dict_size == 0:
                codes = torch.zeros(nnz, dtype=torch.int64, device=device)
                lens = torch.zeros(1, dtype=torch.int64, device=device)
            starts = torch.cumsum(lens, 0) - lens
            codes = codes.clamp(0, len(lens) - 1)
            part.ranges = (blob, starts[codes], lens[codes])
        else:
            lens = _read_ints(streams.get(S_LENGTH, b""), nnz, False, enc,
                              device)
            part.ranges = (_u8(data), torch.cumsum(lens, 0) - lens, lens)
    else:
        raise ValueError(f"orc: unsupported column kind {t.kind}")
    return part


def _stripe_layout(f, meta: OrcMeta, st: StripeInfo):
    """(encodings, {column id: [(stream kind, offset, length)]}) of one
    stripe, from its footer."""
    f.seek(st.offset + st.index_length + st.data_length)
    sfoot = pb_decode(_read_stream(f.read(st.footer_length),
                                   meta.compression))
    encodings = []
    for raw in sfoot.get(2, []):
        e = pb_decode(raw)
        encodings.append((e.get(1, [0])[0], e.get(2, [0])[0]))
    # stream byte ranges: cumulative from stripe start, index streams
    # included
    pos = st.offset
    ranges: Dict[int, List[Tuple[int, int, int]]] = {}
    for raw in sfoot.get(1, []):
        s = pb_decode(raw)
        kind, col, length = (s.get(1, [0])[0], s.get(2, [0])[0],
                             s.get(3, [0])[0])
        if kind not in (S_ROW_INDEX, S_BLOOM_FILTER):
            ranges.setdefault(col, []).append((kind, pos, length))
        pos += length
    return encodings, ranges


def _read_range(f, offset: int, length: int) -> bytearray:
    f.seek(offset)
    buf = bytearray(length)
    f.readinto(buf)
    return buf


def read_orc(path: str, columns: Optional[Sequence[str]] = None,
             stripe_index: Optional[int] = None,
             device: DeviceLike = None) -> Batch:
    """Read an ORC file (or one stripe of it) into a Batch on ``device``
    (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    meta = read_meta(path)
    root = meta.types[0]
    names = root.field_names
    by_name = dict(zip(names, root.subtypes))
    ordered = list(columns) if columns is not None else names
    stripes = (meta.stripes if stripe_index is None
               else [meta.stripes[stripe_index]])
    with open(path, "rb") as f:
        layouts = [_stripe_layout(f, meta, st) for st in stripes]
    total = sum(st.num_rows for st in stripes)
    cap = capacity_for(max(total, 1))

    def column(name: str) -> Column:
        ci = by_name[name]
        sql = _sql_type(meta.types[ci])
        ps: List[_Part] = []
        with open(path, "rb") as f:
            for st, (encodings, ranges) in zip(stripes, layouts):
                enc, dsz = (encodings[ci] if ci < len(encodings)
                            else (E_DIRECT_V2, 0))
                streams = {kind: _read_stream(_read_range(f, off, ln),
                                              meta.compression)
                           for kind, off, ln in ranges.get(ci, [])}
                ps.append(_column_from_streams(meta.types[ci], st.num_rows,
                                               enc, dsz, streams, dev))
        present = (np.concatenate([np.ones(p.rows, bool) if p.present is None
                                   else p.present for p in ps])
                   if any(p.present is not None for p in ps) else None)
        if is_string(sql):
            blob, starts, lengths = L.concat_ranges([p.ranges for p in ps],
                                                    dev)
            return L.string_column(sql, blob, starts, lengths, present,
                                   total, cap, dev)
        vals = (ps[0].values if len(ps) == 1
                else torch.cat([L.to_device(p.values, dev) for p in ps])
                if ps else np.zeros(0, sql.np_dtype))
        return L.numeric_column(sql, vals, present, total, cap, dev)

    # a column a thread: numpy and torch release the GIL
    return Batch(dict(zip(ordered, L.each_column(column, ordered))), total)


def num_stripes(path: str) -> int:
    return len(read_meta(path).stripes)
