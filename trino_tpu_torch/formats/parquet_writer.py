"""Parquet writer (PLAIN encoding, uncompressed), byte-identical to the
reference's.

Counterpart of ``trino_tpu/formats/parquet_writer.py``: one row group,
one data page v1 a column, every column OPTIONAL with RLE/bit-packed
definition levels, the metadata in thrift compact protocol with the same
field order and varint widths, so the two packages write the same bytes
for the same rows. Each column's page values are made on the column's
device and come to the host with one copy: a string column encodes each
dictionary value once and is assembled by code on the device
(``formats/lanes.py``). Columns encode side by side, a thread each.

Supported lanes: BIGINT/INTEGER/SMALLINT/TINYINT (INT64/INT32), DOUBLE
and REAL (DOUBLE), BOOLEAN, VARCHAR/CHAR (BYTE_ARRAY/UTF8), DATE
(INT32/DATE).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Batch, Column
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, Type,
                     is_string)
from . import lanes as L

_MAGIC = b"PAR1"

# parquet physical types
_T_BOOLEAN, _T_INT32, _T_INT64, _T_DOUBLE, _T_BYTE_ARRAY = 0, 1, 2, 5, 6
# converted types
_C_UTF8, _C_DATE = 0, 6


class _TWriter:
    """Thrift compact-protocol struct writer (the _TReader mirror)."""

    def __init__(self):
        self.out = bytearray()

    def _varint(self, v: int):
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def _zigzag(self, v: int):
        self._varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def field(self, last_id: int, fid: int, ttype: int) -> int:
        delta = fid - last_id
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ttype)
        else:
            self.out.append(ttype)
            self._zigzag(fid)
        return fid

    def i_field(self, last_id: int, fid: int, v: int,
                ttype: int = 6) -> int:
        last_id = self.field(last_id, fid, ttype)
        self._zigzag(v)
        return last_id

    def bytes_field(self, last_id: int, fid: int, v: bytes) -> int:
        last_id = self.field(last_id, fid, 8)
        self._varint(len(v))
        self.out += v
        return last_id

    def list_header(self, size: int, etype: int):
        if size < 15:
            self.out.append((size << 4) | etype)
        else:
            self.out.append(0xF0 | etype)
            self._varint(size)

    def stop(self):
        self.out.append(0)


def _phys_type(t: Type) -> Tuple[int, Optional[int]]:
    if t is BIGINT or t.name in ("bigint",):
        return _T_INT64, None
    if t is INTEGER or t.name in ("integer", "smallint", "tinyint"):
        return _T_INT32, None
    if t is DOUBLE or t.name in ("double", "real"):
        return _T_DOUBLE, None
    if t is BOOLEAN or t.name == "boolean":
        return _T_BOOLEAN, None
    if t is DATE or t.name == "date":
        return _T_INT32, _C_DATE
    if is_string(t):
        return _T_BYTE_ARRAY, _C_UTF8
    raise ValueError(f"parquet writer: unsupported type {t}")


def _uleb(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _def_levels(valid: np.ndarray) -> bytes:
    """RLE/bit-packed hybrid encoding of 1-bit definition levels,
    4-byte length prefixed (DataPageHeader definition_level_encoding
    RLE)."""
    n = len(valid)
    body = bytearray()
    if valid.all():
        _uleb(body, n << 1)        # one RLE run of value 1
        body.append(1)
        return struct.pack("<I", len(body)) + bytes(body)
    groups = (n + 7) // 8          # bit-packed groups of 8 values
    _uleb(body, (groups << 1) | 1)
    bits = np.zeros(groups * 8, dtype=bool)
    bits[:n] = valid
    body += np.packbits(bits, bitorder="little").tobytes()
    return struct.pack("<I", len(body)) + bytes(body)


def _page_header(num_values: int, uncompressed: int) -> bytes:
    """PageHeader{type=DATA_PAGE, sizes, DataPageHeader{num_values,
    encoding=PLAIN(0), def/rep level encoding=RLE(3)}}."""
    w = _TWriter()
    last = w.i_field(0, 1, 0, 5)                 # type = DATA_PAGE
    last = w.i_field(last, 2, uncompressed, 5)   # uncompressed_size
    last = w.i_field(last, 3, uncompressed, 5)   # compressed_size
    last = w.field(last, 5, 12)                  # data_page_header
    l2 = w.i_field(0, 1, num_values, 5)
    l2 = w.i_field(l2, 2, 0, 5)                  # encoding PLAIN
    l2 = w.i_field(l2, 3, 3, 5)                  # def levels RLE
    l2 = w.i_field(l2, 4, 3, 5)                  # rep levels RLE
    w.stop()                                     # end DataPageHeader
    w.stop()                                     # end PageHeader
    return bytes(w.out)


def valid_mask(col: Column, n: int) -> np.ndarray:
    """The validity of a column's first ``n`` rows on the host."""
    if col.valid is None:
        return np.ones(n, dtype=bool)
    return L.to_host(col.valid[:n]).astype(bool)


_TORCH_OUT = {_T_INT64: torch.int64, _T_INT32: torch.int32,
              _T_DOUBLE: torch.float64}


def _values(phys: int, col: Column, n: int,
            valid: np.ndarray) -> np.ndarray:
    """The PLAIN bytes of the present values, made on the column's device
    and copied to the host once."""
    data = L.live(col.data[:n], None if valid.all()
                  else col.valid[:n].to(torch.bool))
    if phys in _TORCH_OUT:
        return L.to_host(data.to(_TORCH_OUT[phys])).view(np.uint8)
    if phys == _T_BOOLEAN:
        return np.packbits(L.to_host(data).astype(bool), bitorder="little")
    # BYTE_ARRAY: each dictionary value encoded once, with its length
    records = [struct.pack("<I", len(b)) + b
               for b in L.encoded_values(col.dictionary)]
    return L.assemble(records, data)


def write_parquet(path: str, batch: Batch,
                  columns: Optional[List[str]] = None) -> None:
    """Write a Batch's live rows as a one-row-group parquet file."""
    names = columns or list(batch.columns)
    n = batch.num_rows_host()

    def page(name: str):
        col = batch.column(name)
        phys, conv = _phys_type(col.type)
        valid = valid_mask(col, n)
        # schema declares every column OPTIONAL, so definition levels
        # are always present (an all-ones RLE run when nothing is null)
        return phys, conv, _def_levels(valid), _values(phys, col, n, valid)

    # the columns encode side by side, a thread each; pages are written
    # in column order
    pages = L.each_column(page, names)
    chunks = []          # (name, phys, conv, page_len, offset)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        off = len(_MAGIC)
        for name, (phys, conv, levels, values) in zip(names, pages):
            body = len(levels) + len(values)
            header = _page_header(n, body)
            f.write(header)
            f.write(levels)
            f.write(values)
            chunks.append((name, phys, conv, len(header) + body, off))
            off += len(header) + body
        meta = _file_metadata(chunks, n)
        f.write(meta)
        f.write(struct.pack("<I", len(meta)))
        f.write(_MAGIC)


def _file_metadata(chunks, n: int) -> bytes:
    """FileMetaData, field for field as the reference writes it."""
    w = _TWriter()
    last = w.i_field(0, 1, 1, 5)                 # version
    last = w.field(last, 2, 9)                   # schema list
    w.list_header(1 + len(chunks), 12)
    # root element
    se = _TWriter()
    l2 = se.bytes_field(0, 4, b"schema")
    l2 = se.i_field(l2, 5, len(chunks), 5)       # num_children
    se.stop()
    w.out += se.out
    for name, phys, conv, _, _ in chunks:
        se = _TWriter()
        l2 = se.i_field(0, 1, phys, 5)           # physical type
        l2 = se.i_field(l2, 3, 1, 5)             # repetition OPTIONAL
        l2 = se.bytes_field(l2, 4, name.encode())
        if conv is not None:
            l2 = se.i_field(l2, 6, conv, 5)      # converted_type
        se.stop()
        w.out += se.out
    last = w.i_field(last, 3, n, 6)              # num_rows
    last = w.field(last, 4, 9)                   # row_groups list
    w.list_header(1, 12)
    rg = _TWriter()
    l2 = rg.field(0, 1, 9)                       # columns list
    rg.list_header(len(chunks), 12)
    total = 0
    for name, phys, conv, page_len, off in chunks:
        cc = _TWriter()
        l3 = cc.i_field(0, 2, off, 6)            # file_offset
        l3 = cc.field(l3, 3, 12)                 # meta_data
        md = _TWriter()
        l4 = md.i_field(0, 1, phys, 5)           # type
        l4 = md.field(l4, 2, 9)                  # encodings
        md.list_header(2, 5)
        md._zigzag(0)                            # PLAIN
        md._zigzag(3)                            # RLE
        l4 = md.field(l4, 3, 9)                  # path_in_schema
        md.list_header(1, 8)
        md._varint(len(name.encode()))
        md.out += name.encode()
        l4 = md.i_field(l4, 4, 0, 5)             # codec UNCOMPRESSED
        l4 = md.i_field(l4, 5, n, 6)             # num_values
        l4 = md.i_field(l4, 6, page_len, 6)      # total_uncompressed
        l4 = md.i_field(l4, 7, page_len, 6)      # total_compressed
        l4 = md.i_field(l4, 9, off, 6)           # data_page_offset
        md.stop()
        cc.out += md.out
        cc.stop()
        rg.out += cc.out
        total += page_len
    l2 = rg.i_field(1, 2, total, 6)              # total_byte_size
    l2 = rg.i_field(l2, 3, n, 6)                 # num_rows
    rg.stop()
    w.out += rg.out
    w.stop()
    return bytes(w.out)
