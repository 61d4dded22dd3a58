"""Columnar page wire and spill format.

Counterpart of ``trino_tpu/serde.py``, with the same frame layout, so the
two packages write the same bytes for the same rows and dictionaries:
struct-of-arrays (one contiguous lane per column), little-endian, LZ4
lanes where that is smaller, an xxHash64 trailer. The LZ4 and xxHash64
loops are the C++ codec ``csrc/pageserde.cpp``, built at first use by
ops/native.py. There is no fallback: without the codec (no C++ compiler)
every call raises, so two processes never disagree on the checksum.

Frame layout:
  magic 'TPG1' | u8 codec | u32 ncols | u64 nrows
  per column:
    u16 name_len | name utf8 | u16 type_len | type utf8 | u8 flags | u64 n
    lane DATA  [flags&1: VALID lane] [flags&2: DATA2 lane]
    [flags&4: dictionary — u32 count | per value u32 len + utf8]
    [flags&8: the flat ``elements`` column, framed like a column]
    [flags&16: the flat ``elements2`` column (a MAP's values)]
    [flags&32: a ROW's fields — u32 count | each framed like a column]
  u64 xxh64 of everything before the trailer
Each lane: u8 dtype_code | u8 lane_codec | u64 raw_len | u64 stored_len |
bytes.

Flags 16 and 32 are the port's own: the JAX package's frames carry
neither lane, so a MAP's values and a ROW's fields do not cross its
exchange (ROADMAP C).

``serialize_batch`` takes a Batch on any device and copies each lane to
the host once; ``deserialize_batch(data, device=...)`` puts the lanes on
the caller's device.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .columnar import Batch, Column, StringDictionary
from .config import DeviceLike, capacity_for, resolve_device
from .types import parse_type

_MAGIC = b"TPG1"
CODEC_STORE = 0
CODEC_LZ4 = 1

_DTYPES = [np.dtype(x) for x in
           ("bool", "int8", "int16", "int32", "int64", "float32",
            "float64", "uint64")]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}
_LANE_HEAD = struct.Struct("<BBQQ")

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def codec_library() -> ctypes.CDLL:
    """The page codec (csrc/pageserde.cpp), built on first use; raises
    when it cannot be built."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .ops.native import load_c
            lib = load_c("pageserde")
            for name, restype, argtypes in [
                ("tt_lz4_compress", ctypes.c_int64,
                 [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                  ctypes.c_int64]),
                ("tt_lz4_decompress", ctypes.c_int64,
                 [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                  ctypes.c_int64]),
                ("tt_lz4_max_compressed", ctypes.c_int64,
                 [ctypes.c_int64]),
                ("tt_xxh64", ctypes.c_uint64,
                 [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]),
                ("tt_fnv1a64_many", None,
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_void_p]),
            ]:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
    return _LIB


def _addr(buf) -> int:
    """Address of a bytes-like object's first byte (a zero-length buffer
    gets a valid dummy address)."""
    if len(buf) == 0:
        return ctypes.addressof(ctypes.c_char())
    if isinstance(buf, bytes):
        return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
    return np.frombuffer(buf, dtype=np.uint8).ctypes.data


def checksum(data, seed: int = 0) -> int:
    return int(codec_library().tt_xxh64(_addr(data), len(data), seed))


def _compress(raw, codec: int) -> bytes:
    if codec != CODEC_LZ4:
        return bytes(raw)
    lib = codec_library()
    cap = int(lib.tt_lz4_max_compressed(len(raw)))
    out = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.tt_lz4_compress(_addr(raw), len(raw), out.ctypes.data, cap)
    if n < 0:
        raise ValueError("lz4 compression failed")
    return out[:n].tobytes()


def fnv1a64_many(values) -> np.ndarray:
    """FNV-1a 64 of each value's UTF-8 bytes, as uint64 (the C++ codec's
    loop; the dictionary hashes of stage/repartition.py)."""
    enc = [str(v).encode("utf-8") for v in values]
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    if enc:
        np.cumsum([len(b) for b in enc], out=offs[1:])
    buf = np.frombuffer(b"".join(enc) or b"\0", dtype=np.uint8)
    out = np.empty(len(enc), dtype=np.uint64)
    if enc:
        codec_library().tt_fnv1a64_many(buf.ctypes.data, offs.ctypes.data,
                                        len(enc), out.ctypes.data)
    return out


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------

def _host(t: torch.Tensor, n: int) -> np.ndarray:
    """The first ``n`` rows of a lane as a host array: one copy."""
    return t[:n].cpu().numpy()


# lanes of at least this many bytes in all are compressed, and
# decompressed, by a pool of threads (the codec's calls release the
# interpreter lock); the frame's bytes do not depend on it
_PARALLEL_BYTES = 1 << 20
_POOL = None


def _run_all(work: list, fn) -> None:
    """``fn`` over every item, in the page codec's thread pool when the
    items are many and large enough to pay for it."""
    global _POOL
    if len(work) > 1 and sum(w.size for w in work) >= _PARALLEL_BYTES:
        if _POOL is None:
            with _LIB_LOCK:
                if _POOL is None:
                    from concurrent.futures import ThreadPoolExecutor
                    _POOL = ThreadPoolExecutor(
                        max_workers=min(8, os.cpu_count() or 1),
                        thread_name_prefix="pageserde")
        list(_POOL.map(fn, work))
    else:
        for w in work:
            fn(w)


class _OutLane:
    """A lane to frame: its raw bytes, compressed when that is smaller."""

    __slots__ = ("arr", "code", "codec", "parts")

    def __init__(self, arr: np.ndarray, codec: int):
        self.arr = np.ascontiguousarray(arr)
        self.code = _DTYPE_CODE[self.arr.dtype]
        self.codec = codec
        self.parts = None

    @property
    def size(self) -> int:
        return self.arr.nbytes

    def encode(self) -> None:
        raw = memoryview(self.arr).cast("B")
        stored = _compress(raw, self.codec)
        lane_codec = self.codec
        if len(stored) >= len(raw):
            stored, lane_codec = raw.tobytes(), CODEC_STORE
        self.parts = (_LANE_HEAD.pack(self.code, lane_codec, len(raw),
                                      len(stored)), stored)


def _emit_column(out: list, name: str, col: Column, n: int,
                 codec: int) -> None:
    nb = name.encode()
    tb = col.type.name.encode()
    flags = ((1 if col.valid is not None else 0)
             | (2 if col.data2 is not None else 0)
             | (4 if col.dictionary is not None else 0)
             | (8 if col.elements is not None else 0)
             | (16 if col.elements2 is not None else 0)
             | (32 if col.children is not None else 0))
    out.append(struct.pack("<H", len(nb)))
    out.append(nb)
    out.append(struct.pack("<H", len(tb)))
    out.append(tb)
    out.append(struct.pack("<BQ", flags, n))
    for lane in (col.data, col.valid, col.data2):
        if lane is not None:
            out.append(_OutLane(_host(lane, n), codec))
    if col.dictionary is not None:
        vals = col.dictionary.values
        out.append(struct.pack("<I", len(vals)))
        for v in vals:
            vb = str(v).encode()
            out.append(struct.pack("<I", len(vb)))
            out.append(vb)
    # the flat pools ship whole: the offsets index into them
    for flag, pool, tag in ((8, col.elements, "$elements"),
                            (16, col.elements2, "$elements2")):
        if flags & flag:
            _emit_column(out, tag, pool, int(pool.data.shape[0]), codec)
    if col.children is not None:
        out.append(struct.pack("<I", len(col.children)))
        for i, ch in enumerate(col.children):
            _emit_column(out, f"$f{i}", ch, n, codec)


def serialize_batch(batch: Batch, codec: Optional[int] = None) -> bytes:
    """Batch (on any device) -> framed bytes of its live rows."""
    if codec is None:
        codec = CODEC_LZ4
    n = batch.num_rows_host()
    out: list = [_MAGIC, struct.pack("<BIQ", codec,
                                     len(batch.columns), n)]
    for name, col in batch.columns.items():
        _emit_column(out, name, col, n, codec)
    lanes = [x for x in out if isinstance(x, _OutLane)]
    _run_all(lanes, _OutLane.encode)
    body = b"".join(p for x in out
                    for p in (x.parts if isinstance(x, _OutLane) else (x,)))
    return body + struct.pack("<Q", checksum(body))


class _InLane:
    """A framed lane to decode into a zeroed host buffer of the column's
    capacity."""

    __slots__ = ("stored", "raw_len", "codec", "host")

    def __init__(self, stored, raw_len: int, codec: int, dtype,
                 cap: int):
        self.stored = stored
        self.raw_len = raw_len
        self.codec = codec
        if raw_len % dtype.itemsize:
            raise ValueError("page lane length is not a whole row count")
        self.host = np.zeros(max(cap, raw_len // dtype.itemsize),
                             dtype=dtype)

    @property
    def size(self) -> int:
        return self.raw_len

    def decode(self) -> None:
        dst = self.host.view(np.uint8)
        if self.codec != CODEC_LZ4:
            if len(self.stored) != self.raw_len:
                raise ValueError("stored page lane has the wrong length")
            dst[:self.raw_len] = np.frombuffer(self.stored, np.uint8)
            return
        if self.raw_len == 0:
            return
        got = codec_library().tt_lz4_decompress(
            _addr(self.stored), len(self.stored), dst.ctypes.data,
            self.raw_len)
        if got != self.raw_len:
            raise ValueError(
                f"lz4 decompression failed ({got} != {self.raw_len})")


def _read_lane(buf: memoryview, off: int, cap: int, lanes: list):
    code, lane_codec, raw_len, stored_len = _LANE_HEAD.unpack_from(buf,
                                                                   off)
    off += _LANE_HEAD.size
    if code >= len(_DTYPES) or off + stored_len > len(buf):
        raise ValueError("bad page lane header")
    lane = _InLane(buf[off:off + stored_len], raw_len, lane_codec,
                   _DTYPES[code], cap)
    lanes.append(lane)
    return lane, off + stored_len


def _read_column(buf: memoryview, off: int, lanes: list):
    """One column's structure; its lanes join ``lanes`` to decode.
    Returns (name, a builder of the Column from decoded lanes, offset)."""
    (nlen,) = struct.unpack_from("<H", buf, off)
    off += 2
    name = bytes(buf[off:off + nlen]).decode()
    off += nlen
    (tlen,) = struct.unpack_from("<H", buf, off)
    off += 2
    typ = parse_type(bytes(buf[off:off + tlen]).decode())
    off += tlen
    flags, n = struct.unpack_from("<BQ", buf, off)
    off += 9
    cap = capacity_for(max(int(n), 1), minimum=8)
    data, off = _read_lane(buf, off, cap, lanes)
    valid = d2 = dictionary = elements = elements2 = None
    kids = None
    if flags & 1:
        valid, off = _read_lane(buf, off, cap, lanes)
    if flags & 2:
        d2, off = _read_lane(buf, off, cap, lanes)
    if flags & 4:
        (cnt,) = struct.unpack_from("<I", buf, off)
        off += 4
        vals = []
        for _ in range(cnt):
            (vlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            vals.append(bytes(buf[off:off + vlen]).decode())
            off += vlen
        dictionary = StringDictionary(np.asarray(vals, dtype=object))
    if flags & 8:
        _, elements, off = _read_column(buf, off, lanes)
    if flags & 16:
        _, elements2, off = _read_column(buf, off, lanes)
    if flags & 32:
        (cnt,) = struct.unpack_from("<I", buf, off)
        off += 4
        kids = []
        for _ in range(cnt):
            _, ch, off = _read_column(buf, off, lanes)
            kids.append(ch)

    def build(device: torch.device) -> Column:
        def lane(x):
            return None if x is None else \
                torch.from_numpy(x.host).to(device)

        def sub(b):
            return None if b is None else b(device)
        return Column(typ, lane(data), lane(valid), dictionary, lane(d2),
                      sub(elements), sub(elements2),
                      None if kids is None else tuple(k(device)
                                                      for k in kids))
    return name, build, off


def frame_valid(data: bytes) -> bool:
    """Cheap integrity check of a serialized frame (magic and xxh64
    trailer) without decoding it: the exchange puller's guard against
    taking a non-frame HTTP 200 body as a partition."""
    if len(data) < 12 or data[:4] != _MAGIC:
        return False
    buf = memoryview(data)
    (csum,) = struct.unpack_from("<Q", buf, len(buf) - 8)
    return checksum(buf[:-8]) == csum


def deserialize_batch(data: bytes, device: DeviceLike = None) -> Batch:
    """Framed bytes -> Batch with its lanes on ``device`` (cuda unless the
    caller asks for the CPU). A corrupted frame raises."""
    dev = resolve_device(device)
    buf = memoryview(data)
    if len(buf) < 12:
        raise ValueError("page frame too short")
    body, (csum,) = buf[:-8], struct.unpack_from("<Q", buf, len(buf) - 8)
    if checksum(body) != csum:
        raise ValueError("page checksum mismatch")
    if bytes(buf[:4]) != _MAGIC:
        raise ValueError("bad page magic")
    _codec, ncols, nrows = struct.unpack_from("<BIQ", buf, 4)
    off = 4 + struct.calcsize("<BIQ")
    builders, lanes = [], []
    for _ in range(ncols):
        name, build, off = _read_column(buf, off, lanes)
        builders.append((name, build))
    _run_all(lanes, _InLane.decode)
    cols: Dict[str, Column] = {name: build(dev) for name, build in builders}
    return Batch(cols, int(nrows))


# --------------------------------------------------------------------------
# spill
# --------------------------------------------------------------------------

class Spiller:
    """Writes batches to local disk pages and reads them back. Every live
    spill file is listed for the leak report (server/diagnostics.py): a
    spill file that outlives its query is a leak."""

    _LIVE: "set[str]" = set()
    _LIVE_LOCK = threading.Lock()

    def __init__(self, directory: Optional[str] = None,
                 device: DeviceLike = None):
        import tempfile
        self._dir = directory or tempfile.mkdtemp(prefix="trino_tpu_spill_")
        self._files: List[str] = []
        self.device = resolve_device(device)

    @classmethod
    def live_files(cls) -> list:
        with cls._LIVE_LOCK:
            return sorted(cls._LIVE)

    def spill(self, batch: Batch) -> str:
        path = os.path.join(self._dir, f"page_{len(self._files)}.bin")
        with open(path, "wb") as f:
            f.write(serialize_batch(batch))
        self._files.append(path)
        with Spiller._LIVE_LOCK:
            Spiller._LIVE.add(path)
        return path

    def unspill(self, path: str) -> Batch:
        with open(path, "rb") as f:
            return deserialize_batch(f.read(), self.device)

    def unspill_all(self) -> List[Batch]:
        return [self.unspill(p) for p in self._files]

    def close(self) -> None:
        gone = []
        for p in self._files:
            try:
                os.unlink(p)
                gone.append(p)
            except OSError:
                pass        # stays listed: still on disk is a leak
        with Spiller._LIVE_LOCK:
            Spiller._LIVE.difference_update(gone)
        self._files.clear()
