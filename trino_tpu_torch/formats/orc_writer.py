"""ORC writer (RLE v1 DIRECT, uncompressed, one stripe), byte-identical
to the reference's.

Counterpart of ``trino_tpu/formats/orc_writer.py``: PRESENT (bits MSB
first under byte RLE, only when nulls exist), DATA and LENGTH streams,
integers as RLE v1 literal groups of 128, the protobuf footers in the
same field order, so the two packages write the same bytes for the same
rows. The zigzag varints and the string bytes are built on the column's
device with no loop over values (``formats/lanes.py``) and each stream
comes to the host with one copy; the columns encode side by side, a
thread each.

Supported lanes: BIGINT/INTEGER/SMALLINT/TINYINT (LONG/INT), DOUBLE and
REAL (DOUBLE), BOOLEAN, VARCHAR/CHAR (STRING direct), DATE.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Batch
from ..types import Type, is_string
from . import lanes as L
from .orc import (GROUP, K_BOOLEAN, K_DATE, K_DOUBLE, K_INT, K_LONG,
                  K_STRING, K_STRUCT, MAGIC, S_DATA, S_LENGTH, S_PRESENT)
from .parquet_writer import valid_mask

_NONE_COMPRESSION = 0


# --------------------------------------------------------------------------
# protobuf writing (the pb_decode mirror)
# --------------------------------------------------------------------------

def _varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _uint(out: bytearray, tag: int, v: int):
    _varint(out, (tag << 3) | 0)
    _varint(out, v)


def _blob(out: bytearray, tag: int, b: bytes):
    _varint(out, (tag << 3) | 2)
    _varint(out, len(b))
    out += b


# --------------------------------------------------------------------------
# stream encoders (mirrors of orc.py's decoders)
# --------------------------------------------------------------------------

def rle_v1_encode(vals, signed: bool) -> np.ndarray:
    """Integer RLEv1 as literal groups of <=128 (always decodable;
    run detection is an optimization the reader doesn't require), built
    on the values' device."""
    v = vals.to(torch.int64) if isinstance(vals, torch.Tensor) \
        else torch.as_tensor(np.asarray(vals, np.int64))
    return L.encode_varints(L.zigzag_encode(v) if signed else v,
                            group=GROUP)


def byte_rle_encode(raw: np.ndarray) -> np.ndarray:
    """Byte-level RLE as literal groups of <=128."""
    return L.encode_byte_groups(np.asarray(raw, np.uint8), GROUP)


def _bool_stream(bits: np.ndarray) -> np.ndarray:
    return byte_rle_encode(np.packbits(bits.astype(bool)))


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _orc_kind(t: Type) -> int:
    name = t.name
    if name in ("bigint", "integer", "smallint", "tinyint"):
        return K_LONG if name == "bigint" else K_INT
    if name in ("double", "real"):
        return K_DOUBLE
    if name == "boolean":
        return K_BOOLEAN
    if name == "date":
        return K_DATE
    if is_string(t):
        return K_STRING
    raise ValueError(f"orc writer: unsupported type {t}")


def _column_streams(ci: int, kind: int, col, n: int
                    ) -> List[Tuple[int, int, np.ndarray]]:
    """(stream kind, column id, bytes) of one column, in file order; the
    streams are made on the column's device and copied to the host once."""
    valid = valid_mask(col, n)
    out = []
    if not valid.all():
        out.append((S_PRESENT, ci, _bool_stream(valid)))
    data = L.live(col.data[:n], None if valid.all()
                  else col.valid[:n].to(torch.bool))
    if kind == K_BOOLEAN:
        out.append((S_DATA, ci, _bool_stream(L.to_host(data))))
    elif kind in (K_LONG, K_INT, K_DATE):
        out.append((S_DATA, ci, rle_v1_encode(data, signed=True)))
    elif kind == K_DOUBLE:
        out.append((S_DATA, ci, L.to_host(data.to(torch.float64))
                    .view(np.uint8)))
    else:   # K_STRING, direct encoding
        words = L.encoded_values(col.dictionary)
        codes = data.to(torch.int64).clamp(0, len(words) - 1)
        lens = torch.tensor([len(w) for w in words], dtype=torch.int64,
                            device=codes.device)[codes]
        out.append((S_DATA, ci, L.assemble(words, codes)))
        out.append((S_LENGTH, ci, rle_v1_encode(lens, signed=False)))
    return out


def write_orc(path: str, batch: Batch,
              columns: Optional[List[str]] = None) -> None:
    """Write a Batch's live rows as a one-stripe ORC file."""
    names = columns or list(batch.columns)
    n = batch.num_rows_host()
    sfoot = bytearray()
    data_len = 0
    kinds = [_orc_kind(batch.column(name).type) for name in names]
    # column id 0 is the root struct; children are 1..len(names); the
    # columns encode side by side, a thread each
    streams = L.each_column(
        lambda ci: _column_streams(ci, kinds[ci - 1],
                                   batch.column(names[ci - 1]), n),
        list(range(1, len(names) + 1)))
    with open(path, "wb") as f:
        f.write(MAGIC)
        for col_streams in streams:
            for skind, sci, body in col_streams:
                f.write(body)
                data_len += len(body)
                s = bytearray()
                _uint(s, 1, skind)
                _uint(s, 2, sci)
                _uint(s, 3, len(body))
                _blob(sfoot, 1, bytes(s))
        for _ in range(len(names) + 1):      # root + children: DIRECT
            e = bytearray()
            _uint(e, 1, 0)
            _blob(sfoot, 2, bytes(e))
        sfoot_b = bytes(sfoot)
        footer_b = _footer(names, kinds, n, data_len, len(sfoot_b))
        ps_b = _postscript(len(footer_b))
        f.write(sfoot_b)
        f.write(footer_b)
        f.write(ps_b)
        f.write(bytes([len(ps_b)]))


def _footer(names, kinds, n: int, data_len: int, sfoot_len: int) -> bytes:
    footer = bytearray()
    _uint(footer, 1, len(MAGIC))                      # headerLength
    _uint(footer, 2, len(MAGIC) + data_len + sfoot_len)  # contentLength
    si = bytearray()
    _uint(si, 1, len(MAGIC))                          # stripe offset
    _uint(si, 2, 0)                                   # indexLength
    _uint(si, 3, data_len)
    _uint(si, 4, sfoot_len)
    _uint(si, 5, n)
    _blob(footer, 3, bytes(si))
    root = bytearray()
    _uint(root, 1, K_STRUCT)
    for ci in range(1, len(names) + 1):
        _uint(root, 2, ci)
    for name in names:
        _blob(root, 3, name.encode())
    _blob(footer, 4, bytes(root))
    for kind in kinds:
        t = bytearray()
        _uint(t, 1, kind)
        _blob(footer, 4, bytes(t))
    _uint(footer, 6, n)                               # numberOfRows
    _uint(footer, 8, 0)                               # rowIndexStride
    return bytes(footer)


def _postscript(footer_len: int) -> bytes:
    ps = bytearray()
    _uint(ps, 1, footer_len)                          # footerLength
    _uint(ps, 2, _NONE_COMPRESSION)
    _uint(ps, 3, 0)                                   # block size
    _uint(ps, 4, 0)                                   # version 0.12
    _uint(ps, 4, 12)
    _uint(ps, 5, 0)                                   # metadataLength
    _blob(ps, 8000, b"ORC")                           # PostScript.magic
    ps_b = bytes(ps)
    assert len(ps_b) < 256
    return ps_b
