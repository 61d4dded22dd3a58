"""Vectorised pieces the file readers and writers share, as torch ops on
the caller's device: lanes placed on the device, string columns from byte
ranges, and the varint, byte-run and string codecs, with no loop over
values.

A string column lands as a ``StringDictionary`` whose codes follow first
appearance, as ``StringDictionary.from_strings`` gives them, without a
python string per row: the distinct values are found on the device from
one int64 key per row (the bytes themselves when a value is at most 7
bytes long, else a 64-bit hash whose groups are then checked byte for
byte), and each distinct value is decoded once on the host.

The varint codecs work the same way: a value's last byte is the one with
its high bit clear, so ``torch.nonzero`` finds every value's end at once,
and each byte position of the values is one gather (decode) or one
scatter (encode) over all of them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..columnar import Column, StringDictionary, torch_dtype
from ..types import Type

Lane = Union[np.ndarray, torch.Tensor]
_I64 = torch.int64
_U8 = torch.uint8

# rows handled a chunk at a time where a temporary grows with the row
# width, so that none holds more than a few bytes per value of a column
CHUNK = 1 << 22


def each_column(fn: Callable, items: Sequence) -> list:
    """``[fn(x) for x in items]``, the calls side by side in threads (the
    file reads, numpy and torch release the interpreter lock)."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def to_device(x: Lane, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if not x.flags.writeable:       # over bytes, e.g. a decompressed page
        x = np.array(x)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# --------------------------------------------------------------------------
# lanes on the device
# --------------------------------------------------------------------------

def place(values: Lane, present: Optional[np.ndarray], n: int, cap: int,
          dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A lane of ``cap`` rows on ``device``: ``values`` (the present rows'
    values, in order) at the rows ``present`` marks, zeros elsewhere."""
    out = torch.zeros(cap, dtype=dtype, device=device)
    if len(values) == 0:
        return out
    src = to_device(values, device)
    if src.dtype != dtype:
        src = src.to(dtype)
    if present is None:
        out[:n].copy_(src)
    else:
        out[:n][to_device(present, device)] = src
    return out


def valid_lane(present: Optional[np.ndarray], n: int, cap: int,
               device: torch.device) -> Optional[torch.Tensor]:
    if present is None or present.all():
        return None
    return place(present, None, n, cap, torch.bool, device)


def numeric_column(typ: Type, values: Lane, present: Optional[np.ndarray],
                   n: int, cap: int, device: torch.device) -> Column:
    if present is not None and present.all():
        present = None
    return Column(typ, place(values, present, n, cap, torch_dtype(typ),
                             device),
                  valid_lane(present, n, cap, device))


# --------------------------------------------------------------------------
# string columns from byte ranges
# --------------------------------------------------------------------------

_M1 = -0x61C8864680B583EB          # 0x9E3779B97F4A7C15 as int64
_M2 = -0x3D4D51C2D82B14B1          # 0xC2B2AE3D27D4EB4F as int64


def byte_at(blob: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
            k: int) -> torch.Tensor:
    """Byte ``k`` of each value (0 past a value's end), as int64."""
    if blob.numel() == 0:
        return torch.zeros_like(starts)
    b = blob[(starts + k).clamp_(max=blob.numel() - 1)].to(_I64)
    return b if bool((lengths > k).all()) else b * (lengths > k)


def _keys(blob, starts, lengths, width: int) -> torch.Tensor:
    """One int64 key per value: its bytes and length when ``width`` <= 7
    (exact), else a 64-bit hash of them."""
    if width <= 7:
        key = lengths << 56
        for k in range(width):
            key |= byte_at(blob, starts, lengths, k) << (8 * k)
        return key
    h = lengths * _M1
    for k in range(width):
        h = (h ^ byte_at(blob, starts, lengths, k)) * _M2
        h ^= h >> 29
    return h


def _same_bytes(blob, starts, lengths, rep: torch.Tensor,
                width: int) -> bool:
    """Every value equals the value at its row ``rep`` byte for byte."""
    rs, rl = starts[rep], lengths[rep]
    if not bool((lengths == rl).all()):
        return False
    return all(bool((byte_at(blob, starts, lengths, k)
                     == byte_at(blob, rs, rl, k)).all())
               for k in range(width))


def first_appearance(keys: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(codes, first rows): ``codes[i]`` numbers the distinct key of row
    ``i`` in order of first appearance, ``first rows[j]`` is the row where
    distinct key ``j`` first appears."""
    m = keys.shape[0]
    uniq, inv = torch.unique(keys, return_inverse=True)
    k = uniq.shape[0]
    rows = torch.arange(m, dtype=_I64, device=keys.device)
    first = torch.full((k,), m, dtype=_I64, device=keys.device)
    first.scatter_reduce_(0, inv, rows, reduce="amin")
    order = torch.argsort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(k, dtype=_I64, device=keys.device)
    return rank[inv], first[order]


def string_column(typ: Type, blob: np.ndarray, starts: Lane, lengths: Lane,
                  present: Optional[np.ndarray], n: int, cap: int,
                  device: torch.device) -> Column:
    """A dictionary column from the present rows' byte ranges
    ``blob[starts[i]:starts[i] + lengths[i]]`` (UTF-8, bad bytes
    replaced), NULL rows coded 0, as ``from_strings`` codes them."""
    if present is not None and present.all():
        present = None
    if len(starts) == 0:
        d, _ = StringDictionary.from_strings([])
        return _with_codes(typ, d, torch.zeros(0, dtype=_I64, device=device),
                           present, n, cap, device)
    blob_d = to_device(blob, device)
    starts = to_device(starts, device).to(_I64)
    lengths = to_device(lengths, device).to(_I64)
    width = int(lengths.max())
    codes, first = first_appearance(_keys(blob_d, starts, lengths, width))
    if width > 7 and not _same_bytes(blob_d, starts, lengths,
                                     first[codes], width):
        # two distinct values share a hash: decode every row
        strs = [_decode(blob, s, ln) for s, ln in
                zip(starts.tolist(), lengths.tolist())]
        d, c = StringDictionary.from_strings(strs)
        return _with_codes(typ, d, torch.from_numpy(c).to(device), present,
                           n, cap, device)
    values = [_decode(blob, s, ln) for s, ln in
              zip(starts[first].tolist(), lengths[first].tolist())]
    d, remap = StringDictionary.from_strings(values)
    if len(d) < len(values):
        # distinct bytes that decode to one string (replaced bad bytes)
        codes = torch.from_numpy(remap).to(device).to(_I64)[codes]
    return _with_codes(typ, d, codes, present, n, cap, device)


def _decode(blob: np.ndarray, start: int, length: int) -> str:
    return blob[start:start + length].tobytes().decode("utf-8", "replace")


def _with_codes(typ, d: StringDictionary, codes: torch.Tensor,
                present: Optional[np.ndarray], n: int, cap: int,
                device: torch.device) -> Column:
    return Column(typ, place(codes, present, n, cap, torch.int32, device),
                  valid_lane(present, n, cap, device), d)


def concat_ranges(parts: Sequence[Tuple[np.ndarray, Lane, Lane]],
                  device: torch.device
                  ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """(blob, starts, lengths) of several byte-range lists as one: the
    blobs one after another (no copy when they are one array), the starts
    moved past the blobs before them."""
    if not parts:
        return (np.zeros(0, np.uint8), torch.zeros(0, dtype=_I64),
                torch.zeros(0, dtype=_I64))
    starts = [to_device(p[1], device) for p in parts]
    lengths = [to_device(p[2], device) for p in parts]
    if len(parts) == 1:
        return parts[0][0], starts[0], lengths[0]
    if all(p[0] is parts[0][0] for p in parts):
        return parts[0][0], torch.cat(starts), torch.cat(lengths)
    base = np.cumsum([0] + [len(p[0]) for p in parts[:-1]]).tolist()
    return (np.concatenate([p[0] for p in parts]),
            torch.cat([s + b for s, b in zip(starts, base)]),
            torch.cat(lengths))


# --------------------------------------------------------------------------
# encoding for the writers
# --------------------------------------------------------------------------

def live(data: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The values of the rows ``valid`` marks (all of them, without a
    copy, when it is None)."""
    return data if valid is None else data[valid]


def to_host(t: torch.Tensor) -> np.ndarray:
    """One copy of a tensor to the host, as numpy."""
    return t.contiguous().cpu().numpy()


def encoded_values(dictionary: StringDictionary) -> List[bytes]:
    """Each dictionary value's UTF-8 bytes, encoded once."""
    return [str(v).encode() for v in dictionary.values]


def assemble(records: Sequence[bytes], codes: torch.Tensor) -> np.ndarray:
    """``b"".join(records[c] for c in codes)``, on the codes' device: the
    records as rows of a zero-padded matrix, gathered by code a chunk at
    a time (cut to each record's length when the lengths differ), then
    one copy to the host."""
    if codes.numel() == 0 or not records:
        return np.zeros(0, np.uint8)
    dev = codes.device
    lens = torch.tensor([len(r) for r in records], dtype=_I64, device=dev)
    width = max(int(lens.max()), 1)
    table = np.zeros((len(records), width), np.uint8)
    for i, r in enumerate(records):
        table[i, :len(r)] = np.frombuffer(r, np.uint8)
    table = torch.from_numpy(table).to(dev)
    codes = codes.to(_I64).clamp(0, len(records) - 1)
    if int(lens.min()) == width:
        return to_host(table[codes].reshape(-1))
    cols = torch.arange(width, device=dev)
    out = [table[c][cols[None, :] < lens[c][:, None]]
           for c in codes.split(CHUNK)]
    return to_host(torch.cat(out))


# --------------------------------------------------------------------------
# varints and byte runs
# --------------------------------------------------------------------------

_POS = 0x7FFFFFFFFFFFFFFF


def _shr(u: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes that carry uint64 values."""
    return u if s == 0 else (u >> s) & (_POS >> (s - 1))


def zigzag_encode(v: torch.Tensor) -> torch.Tensor:
    """int64 -> zigzag, as uint64 carried in int64."""
    return (v << 1) ^ (v >> 63)


def zigzag_decode(u: torch.Tensor) -> torch.Tensor:
    return _shr(u, 1) ^ -(u & 1)


def varint_bytes(u: torch.Tensor) -> torch.Tensor:
    """Each value's LEB128 byte count (1 to 10); ``u`` carries uint64."""
    big = u < 0                          # the top bit set: ten bytes
    nb = torch.ones_like(u)
    if bool(big.any()):
        top = 1 << 64
    else:
        top = int(u.max()) if u.numel() else 0
    for k in range(1, 10):
        if top < 1 << (7 * k):
            break
        nb += big if k == 9 else big | (u >= (1 << (7 * k)))
    return nb


def encode_varints(u: torch.Tensor, group: int = 0) -> np.ndarray:
    """LEB128 bytes of ``u`` (uint64 values carried in int64), one after
    another; with ``group`` > 0, a literal-group header byte (256 - the
    group's size) before every ``group`` values, as ORC's RLE v1 writes
    them. Built on ``u``'s device, one scatter per byte position; one copy
    to the host."""
    n = u.numel()
    if n == 0:
        return np.zeros(0, np.uint8)
    dev = u.device
    nb = varint_bytes(u)
    head = torch.zeros(n, dtype=_I64, device=dev)
    if group:
        head[::group] = 1
    size = nb + head
    pos = torch.cumsum(size, 0) - size + head     # each value's first byte
    buf = torch.empty(int(size.sum()), dtype=_U8, device=dev)
    if group:
        firsts = torch.arange(0, n, group, device=dev)
        buf[pos[firsts] - 1] = (256 - torch.clamp(n - firsts, max=group)
                                ).to(_U8)
    for k in range(int(nb.max())):
        byte = (_shr(u, 7 * k) & 0x7F) | ((nb - 1 > k) * 0x80)
        sel = nb > k
        if bool(sel.all()):
            buf[pos + k] = byte.to(_U8)
        else:
            buf[pos[sel] + k] = byte[sel].to(_U8)
    return to_host(buf)


def _gather_varints(buf: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor) -> torch.Tensor:
    """The LEB128 values at ``buf[starts[i]:ends[i] + 1]`` (uint64 in
    int64): one gather per byte position, over values, not bytes."""
    lens = ends - starts + 1
    out = torch.zeros(starts.shape, dtype=_I64, device=buf.device)
    for k in range(int(lens.max()) if starts.numel() else 0):
        out |= (byte_at(buf, starts, lens, k) & 0x7F) << (7 * k)
    return out


def _ends(buf: torch.Tensor, count: int) -> Optional[torch.Tensor]:
    ends = torch.nonzero(buf < 0x80).flatten()[:count]
    return ends if ends.numel() == count else None


def decode_varints(buf: Lane, count: int,
                   device: torch.device) -> Optional[torch.Tensor]:
    """The first ``count`` LEB128 values of ``buf`` (uint64 in int64) on
    ``device``; None when the buffer holds fewer."""
    b = to_device(buf, device)
    ends = _ends(b, count)
    if ends is None:
        return None
    starts = torch.zeros_like(ends)
    starts[1:] = ends[:-1] + 1
    return _gather_varints(b, starts, ends)


def _group_heads(count: int, group: int) -> np.ndarray:
    """The header bytes of ``count`` values in literal groups of
    ``group``: 256 - each group's size."""
    ngroups = (count + group - 1) // group
    sizes = np.full(ngroups, group, np.int64)
    sizes[-1] = count - group * (ngroups - 1)
    return (256 - sizes).astype(np.uint8)


def encode_byte_groups(raw: np.ndarray, group: int = 128) -> np.ndarray:
    """ORC byte RLE as literal groups of ``group`` bytes, each behind its
    header byte (256 - its size)."""
    n = len(raw)
    if n == 0:
        return np.zeros(0, np.uint8)
    want = _group_heads(n, group)
    out = np.empty(n + len(want), np.uint8)
    heads = np.arange(len(want)) * (group + 1)
    out[heads] = want
    keep = np.ones(n + len(want), bool)
    keep[heads] = False
    out[keep] = raw
    return out


def byte_groups(buf: np.ndarray, count: int,
                group: int) -> Optional[np.ndarray]:
    """The ``count`` bytes of a byte-RLE stream made only of literal
    groups of ``group`` bytes (the last one shorter), each behind its
    header byte, as the writers here make it; None when the stream is not
    laid out so (the caller then walks it run by run)."""
    if count == 0:
        return np.zeros(0, np.uint8)
    want = _group_heads(count, group)
    heads = np.arange(len(want)) * (group + 1)
    if len(buf) < count + len(want) or not np.array_equal(buf[heads], want):
        return None
    keep = np.ones(count + len(want), bool)
    keep[heads] = False
    return buf[:count + len(want)][keep]


def varint_groups(buf: Lane, count: int, group: int,
                  device: torch.device) -> Optional[torch.Tensor]:
    """The ``count`` values (uint64 in int64, on ``device``) of an RLE v1
    stream made only of literal groups of ``group`` varints, each group
    behind its header byte, as the writers here make it; None when the
    stream is not laid out so (a run, another group size)."""
    if count == 0:
        return torch.zeros(0, dtype=_I64, device=device)
    want = torch.from_numpy(_group_heads(count, group)).to(device)
    b = to_device(buf, device)
    # a header byte is >= 0x80, so it reads as the first byte of its
    # group's first varint: the values end at the bytes < 0x80
    ends = _ends(b, count)
    if ends is None:
        return None
    starts = torch.zeros_like(ends)
    starts[1:] = ends[:-1] + 1
    if not torch.equal(b[starts[::group]], want):
        return None
    starts[::group] += 1
    if bool((starts > ends).any()):
        return None
    return _gather_varints(b, starts, ends)
