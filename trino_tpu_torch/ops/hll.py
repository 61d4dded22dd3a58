"""HyperLogLog sketches over torch tensors.

Counterpart of ``trino_tpu/ops/hll.py``, with its design and its layout:

- A sketch is a sparse set of (bucket, rank) entries packed into one
  int32 (``bucket * 64 + rank``). A column of sketches is laid out like
  an ARRAY column: ``data`` holds each row's start offset into the flat
  ``elements`` lane, ``data2`` its entry count. Absent buckets have rank
  0.
- Per-group sketches: bucket and rank are bit operations on the row
  hashes; one stable sort by (group, bucket) and segment maxima dedup
  them into per-(group, bucket) entries.
- ``cardinality``: the HLL estimator with the linear-counting correction
  per row. Each row's sum of 2^-rank is reduced over its own span in a
  fixed order (``torch.segment_reduce``), not as a difference of a float
  cumulative sum over the flat lane: a float64 ``torch.cumsum`` on a
  card is not bit-stable from run to run.

Torch has no unsigned 64-bit arithmetic and no count of leading zeros,
so the u64 hash is carried in int64 (ops/hashing.py) and the leading
zeros are found by a six-step binary search on integer masks: a float
``log2`` would lose the bits past 2^53.

``merge`` and the wire format are host numpy, as in the JAX engine: a
merge consumes small pre-aggregated sketch batches.
"""

from __future__ import annotations

import base64
import math
from typing import Tuple

import numpy as np
import torch

from .hashing import lane_to_u64, mix64, s64, shr

# Trino's default approx_distinct standard error is 2.3% -> 2048 buckets
# (error ~= 1.0414 / sqrt(m)); approx_set's own default is 1.625% -> 4096
# buckets (ApproximateSetAggregation.DEFAULT_STANDARD_ERROR).
DEFAULT_BUCKET_BITS = 11
APPROX_SET_BUCKET_BITS = 12
MIN_BUCKET_BITS = 4
MAX_BUCKET_BITS = 16

_RANK_BITS = 6          # packed entry = bucket * 64 + rank
_I64 = torch.int64
_F64 = torch.float64


def bucket_bits_for_error(e: float) -> int:
    """Bucket-count exponent for a requested max standard error
    (ApproximateCountDistinctAggregation.standardErrorToBuckets)."""
    if not (0.0040625 <= e <= 0.26):
        raise ValueError(
            f"standard error must be in [0.0040625, 0.26]: {e}")
    m = (1.0414 / e) ** 2
    return max(MIN_BUCKET_BITS, min(MAX_BUCKET_BITS,
                                    int(math.ceil(math.log2(m)))))


def clz64(w: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u64 patterns held in int64 (64 for 0), by a
    binary search over the top 32, 16, 8, 4, 2 and 1 bits: integer
    operations only."""
    n = torch.zeros_like(w)
    x = w
    for k in (32, 16, 8, 4, 2, 1):
        top_clear = (x & s64(((1 << k) - 1) << (64 - k))) == 0
        n = n + top_clear.to(_I64) * k
        x = torch.where(top_clear, x * (1 << k), x)
    return torch.where(w == 0, 64, n)


def bucket_rank_lanes(data: torch.Tensor,
                      b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (bucket, rank) int32 lanes of a value lane: bucket = the
    top b bits of the row's 64-bit hash; rank = the leading zeros of the
    other 64 - b bits plus one (64 - b + 1 when they are all zero)."""
    h = mix64(lane_to_u64(data))
    bucket = shr(h, 64 - b).to(torch.int32)
    w = h * (1 << b)            # h << b, wrapping
    rank = torch.where(w == 0, 64 - b + 1,
                       torch.clamp(clz64(w), max=64 - b) + 1)
    return bucket, rank.to(torch.int32)


def grouped_sparse_hll(vals: torch.Tensor, valid: torch.Tensor,
                       gid: torch.Tensor, gcap: int, b: int):
    """Per-group sparse sketches from a value lane and each row's group.

    Returns (start, length, entries): ``start`` and ``length`` are
    (gcap,) int64, ``entries`` a (cap,) int32 lane whose first
    sum(length) positions are the group-major, bucket-ascending entry
    lists; the rest is 0."""
    cap = vals.shape[0]
    dev = vals.device
    m = 1 << b
    bucket, rank = bucket_rank_lanes(vals, b)
    key = gid.to(_I64) * m + bucket.to(_I64)
    skey = torch.where(valid, key, gcap * m)      # invalid rows sink
    order = torch.sort(skey, stable=True).indices
    k2 = skey[order]
    r2 = torch.where(valid, rank, 0)[order].to(_I64)
    v2 = valid[order]
    first = torch.arange(cap, device=dev) == 0
    boundary = v2 & ((k2 != torch.roll(k2, 1)) | first)
    runid = (torch.cumsum(boundary, 0) - 1).clamp(0, cap - 1)
    zeros = torch.zeros(cap, dtype=_I64, device=dev)
    run_rank = zeros.scatter_reduce(0, runid, torch.where(v2, r2, 0),
                                    "amax")
    run_key = zeros.scatter_reduce(0, runid, torch.where(v2, k2, 0),
                                   "amax")
    entries = ((run_key % m) * (1 << _RANK_BITS) + run_rank).to(
        torch.int32)
    length = torch.zeros(gcap, dtype=_I64, device=dev).index_add_(
        0, (k2 // m).clamp(0, gcap - 1), boundary.to(_I64))
    start = torch.cumsum(length, 0) - length
    # entries past the real run count are 0, so a span that clips into
    # them serialises deterministically
    nruns = boundary.sum(dtype=_I64)
    entries = torch.where(torch.arange(cap, device=dev) < nruns, entries,
                          0)
    return start, length, entries


def estimate_from_sparse(start: torch.Tensor, length: torch.Tensor,
                         entries: torch.Tensor, b: int) -> torch.Tensor:
    """Per-row HLL estimates (int64) from sparse entry spans (Flajolet et
    al. 2007, without bias tables). Linear counting below 2.5m, with the
    exact zero-register count m - length. Each row's sum of 2^-rank is
    reduced over its own span, in span order."""
    m = 1 << b
    dev = entries.device
    e_cap = entries.shape[0]
    s = start.to(_I64)
    ln = length.to(_I64).clamp(0, m)
    lo = s.clamp(0, e_cap)
    cnt = (s + ln).clamp(0, e_cap) - lo
    total = int(cnt.sum())
    row_base = torch.cumsum(cnt, 0) - cnt
    within = (torch.arange(total, dtype=_I64, device=dev)
              - torch.repeat_interleave(row_base, cnt, output_size=total))
    idx = torch.repeat_interleave(lo, cnt, output_size=total) + within
    ranks = (entries[idx].to(_I64) % (1 << _RANK_BITS)).to(_F64)
    pow2 = torch.exp2(-ranks)
    z_entries = torch.segment_reduce(pow2, "sum", lengths=cnt,
                                     unsafe=True) if total else \
        torch.zeros(s.shape[0], dtype=_F64, device=dev)
    zeros = (m - ln).to(_F64)
    z = z_entries + zeros            # absent buckets contribute 2^-0
    alpha = (0.673 if m == 16 else 0.697 if m == 32
             else 0.709 if m == 64 else 0.7213 / (1.0 + 1.079 / m))
    # tensor by tensor: a python-scalar operand of a division is a
    # multiply by a reciprocal in torch, which may round otherwise
    mm = torch.full_like(z, float(m))
    raw = torch.full_like(z, alpha * m * m) / torch.clamp(z, min=1e-300)
    lin = mm * torch.log(mm / torch.clamp(zeros, min=1.0))
    use_lin = (raw <= 2.5 * m) & (zeros > 0)
    est = torch.where(use_lin, lin, raw)
    return torch.round(est).to(_I64)


def entries_prefix(starts: torch.Tensor, lens: torch.Tensor,
                   entries: torch.Tensor, b: int) -> np.ndarray:
    """A host copy of the entries that the spans (starts, lens) reach:
    the flat lane up to the end of the furthest span, clipped as its
    readers clip, not its whole length (a sketch column's entries lane
    is as long as the rows it was built from). Reading the prefix gives
    what reading the whole lane gives."""
    e_cap = entries.shape[0]
    if starts.numel() == 0:
        return entries[:0].cpu().numpy()
    ends = starts.clamp(0, e_cap) + lens.clamp(0, 1 << b)
    return entries[:min(int(ends.max()), e_cap)].cpu().numpy()


def empty_sketch_lane(device: torch.device) -> torch.Tensor:
    """The elements lane of sketches with no entries."""
    return torch.zeros(8, dtype=torch.int32, device=device)


# ---- host numpy: merge and the wire format --------------------------------

def merge_sparse_host(starts: np.ndarray, lens: np.ndarray,
                      entries: np.ndarray, valid: np.ndarray,
                      gid: np.ndarray, gcap: int, b: int):
    """Per-group max-union of sketch rows. Returns (start, length,
    entries) with the layout of grouped_sparse_hll."""
    m = 1 << b
    starts = np.asarray(starts, np.int64)
    lens = np.clip(np.where(valid, np.asarray(lens, np.int64), 0), 0, m)
    e_cap = entries.shape[0]
    starts = np.clip(starts, 0, max(e_cap - 1, 0))
    lens = np.minimum(lens, e_cap - starts)
    total = int(lens.sum())
    owner = np.repeat(np.arange(starts.shape[0], dtype=np.int64), lens)
    base = np.repeat(starts, lens)
    csum = np.concatenate([[0], np.cumsum(lens)])
    within = np.arange(total, dtype=np.int64) - np.repeat(csum[:-1], lens)
    ent = entries[base + within].astype(np.int64)
    ebkt = ent >> _RANK_BITS
    ernk = ent & ((1 << _RANK_BITS) - 1)
    egid = np.asarray(gid, np.int64)[owner]
    key = egid * m + ebkt
    order = np.lexsort((-ernk, key))
    k2, r2 = key[order], ernk[order]
    boundary = np.ones(total, bool)
    boundary[1:] = k2[1:] != k2[:-1]
    out_key = k2[boundary]
    out_rank = r2[boundary]          # max rank: sorted desc within key
    out_gid = out_key // m
    out_bucket = out_key % m
    out_entries = (out_bucket << _RANK_BITS | out_rank).astype(np.int32)
    length = np.bincount(out_gid, minlength=gcap).astype(np.int64)
    start = np.cumsum(length) - length
    return start, length, out_entries


_MAGIC = b"TPUHLL1\x00"


def dense_registers(entries: np.ndarray, b: int) -> np.ndarray:
    """Dense m-register vector from one sketch's packed entries."""
    m = 1 << b
    regs = np.zeros(m, np.uint8)
    ent = np.asarray(entries, np.int64)
    regs[(ent >> _RANK_BITS) & (m - 1)] = ent & ((1 << _RANK_BITS) - 1)
    return regs


def entries_from_dense(regs: np.ndarray) -> np.ndarray:
    """Packed sparse entries (bucket-ascending) from dense registers."""
    regs = np.asarray(regs)
    nz = np.flatnonzero(regs)
    return (nz.astype(np.int64) << _RANK_BITS
            | regs[nz].astype(np.int64)).astype(np.int32)


def serialize_registers(regs: np.ndarray) -> bytes:
    """8-byte magic + 1-byte bucket bits + m dense uint8 registers."""
    regs = np.asarray(regs, dtype=np.uint8)
    m = regs.shape[-1]
    b = int(m).bit_length() - 1
    return _MAGIC + bytes([b]) + regs.tobytes()


def deserialize_registers(raw: bytes) -> np.ndarray:
    if raw[:8] != _MAGIC:
        raise ValueError("not a serialized HyperLogLog sketch")
    b = raw[8]
    m = 1 << b
    regs = np.frombuffer(raw[9:9 + m], dtype=np.uint8)
    if regs.shape[0] != m:
        raise ValueError("truncated HyperLogLog sketch")
    return regs


def sketches_to_base64(starts: np.ndarray, lens: np.ndarray,
                       entries: np.ndarray, b: int):
    """Per-row base64 wire strings of a sketch column: the one rendering
    of CAST(hll AS varbinary) and of result rows. Each distinct (start,
    length) span is encoded once."""
    m = 1 << b
    e_cap = int(np.asarray(entries).shape[0])
    starts = np.clip(np.asarray(starts, np.int64), 0, max(e_cap, 1))
    lens = np.clip(np.asarray(lens, np.int64), 0, m)
    lens = np.minimum(lens, e_cap - starts)
    spans = np.stack([starts, lens], axis=1)
    uniq, inverse = np.unique(spans, axis=0, return_inverse=True)
    encoded = []
    for p, ln in uniq:
        regs = dense_registers(entries[int(p):int(p) + int(ln)], b)
        encoded.append(base64.b64encode(
            serialize_registers(regs)).decode())
    return [encoded[i] for i in np.asarray(inverse).reshape(-1)]
