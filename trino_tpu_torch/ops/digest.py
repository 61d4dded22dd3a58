"""TDigest / QDigest quantile sketches.

Counterpart of ``trino_tpu/ops/digest.py``, with the same centroids: a
digest column is laid out like a MAP (``data`` = each row's start into
the flat centroid lanes, ``data2`` = its centroid count, ``elements`` =
the means, ``elements2`` = the weights), centroids sorted by mean.
Building compresses by greedy closest-pair merging under a uniform size
bound (``_compress``: the JAX package's python loop, run by a C copy of
it, csrc/digest_compress.c, built with the host's C compiler; the two
give the same centroids bit for bit). As in the JAX engine, construction runs
on the host: digests aggregate small pre-reduced data and their entry
counts are data-dependent twice over. The lanes come from the batch's
device and the result goes back to it.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column
from ..config import capacity_for
from ..types import DOUBLE

DEFAULT_COMPRESSION = 100          # airlift TDigest default
DEFAULT_QDIGEST_BUDGET = 200       # ~ accuracy 0.01 -> 2/0.01 nodes


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


_lib = None


def _native():
    """The C merge loop (csrc/digest_compress.c), built once per source
    content by ops/native.py."""
    global _lib
    if _lib is None:
        from .native import load_c
        fn = load_c("digest_compress").digest_compress
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64]
        fn.restype = ctypes.c_int64
        _lib = fn
    return _lib


def _compress(means: np.ndarray, weights: np.ndarray,
              budget: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by mean, then merge the closest adjacent centroids (weighted)
    until <= budget remain: the JAX package's python loop, run by its C
    copy (the same centroids, bit for bit)."""
    order = np.argsort(means, kind="stable")
    x = np.ascontiguousarray(means[order], dtype=np.float64)
    w = np.ascontiguousarray(weights[order], dtype=np.float64)
    if x.shape[0] <= budget:
        return x, w
    k = _native()(x.ctypes.data, w.ctypes.data, x.shape[0], budget)
    if k < 0:
        raise MemoryError("digest_compress: out of host memory")
    return x[:k].copy(), w[:k].copy()


def _digest_column(out_type, length, means, wts, group_valid,
                   device) -> Column:
    """The digest column of each group's centroid runs, one after
    another."""
    from .collections import offsets_of    # collections imports this
    total = int(length.sum())
    cap = capacity_for(max(total, 1))
    md = np.zeros(cap, np.float64)
    wd = np.zeros(cap, np.float64)
    if means:
        md[:total] = np.concatenate(means)
        wd[:total] = np.concatenate(wts)
    start = offsets_of(length)

    def dev(a):
        return torch.from_numpy(a).to(device)
    return Column(out_type, dev(start), group_valid, None, dev(length),
                  Column(DOUBLE, dev(md)), Column(DOUBLE, dev(wd)))


def _in_threads(fn, items: list) -> list:
    """[fn(item) for item in items], the items split into one contiguous
    slice per thread (the C merge loop and numpy's sort release the
    interpreter, so groups build side by side)."""
    k = min(len(items), os.cpu_count() or 1)
    if k < 2:
        return [fn(it) for it in items]
    _native()      # built once, before the threads need it
    step = -(-len(items) // k)
    with ThreadPoolExecutor(k) as pool:
        parts = pool.map(lambda lo: [fn(it) for it in items[lo:lo + step]],
                         range(0, len(items), step))
        return [r for part in parts for r in part]


def _build(groups, n_groups: int, compress_group, out_type, group_valid,
           device) -> Column:
    """The digest column of ``compress_group(rows)`` -> (means, weights)
    or None, over the groups that hold rows."""
    from .collections import nonempty
    todo = list(nonempty(groups))
    built = _in_threads(lambda g_rows: compress_group(g_rows[1]), todo)
    means, wts = [], []
    length = np.zeros(n_groups, np.int64)
    for (g, _), mw in zip(todo, built):
        if mw is not None:
            means.append(mw[0])
            wts.append(mw[1])
            length[g] = mw[0].shape[0]
    return _digest_column(out_type, length, means, wts, group_valid, device)


def grouped_digest(col: Column, groups: List[np.ndarray], group_valid,
                   out_type, budget: int,
                   weight_col: Optional[Column] = None,
                   scale: Optional[float] = None) -> Column:
    """Build one digest per group from a numeric lane (and optional
    per-row weights)."""
    data = host(col.data).astype(np.float64)
    if scale:
        data = data / scale
    wl = (None if weight_col is None
          else host(weight_col.data).astype(np.float64))

    def compress_group(rows):
        w = np.ones(rows.size) if wl is None else wl[rows]
        return _compress(data[rows], w, budget)
    return _build(groups, len(groups), compress_group, out_type,
                  group_valid, col.device)


def grouped_digest_merge(col: Column, groups: List[np.ndarray],
                         group_valid, budget: int) -> Column:
    """merge(digest) per group: concatenate centroid runs, recompress."""
    starts = host(col.data).astype(np.int64)
    lens = host(col.data2).astype(np.int64)
    em = host(col.elements.data).astype(np.float64)
    ew = host(col.elements2.data).astype(np.float64)

    def compress_group(rows):
        ln = lens[rows]
        total = int(ln.sum())
        if total == 0:
            return None
        # each row's run of centroids, one row after another
        at = np.arange(total) + np.repeat(starts[rows] - (np.cumsum(ln)
                                                          - ln), ln)
        return _compress(em[at], ew[at], budget)
    return _build(groups, len(groups), compress_group, col.type,
                  group_valid, col.device)


def digest_quantile(means: np.ndarray, weights: np.ndarray,
                    q: float) -> float:
    """Value at quantile from sorted centroids (airlift TDigest valueAt:
    piecewise over cumulative weights, midpoint convention)."""
    if means.size == 0:
        return float("nan")
    total = weights.sum()
    target = q * total
    cum = np.cumsum(weights) - weights / 2.0
    if target <= cum[0]:
        return float(means[0])
    if target >= cum[-1]:
        return float(means[-1])
    i = int(np.searchsorted(cum, target) - 1)
    span = cum[i + 1] - cum[i]
    frac = 0.0 if span <= 0 else (target - cum[i]) / span
    return float(means[i] + frac * (means[i + 1] - means[i]))


def digest_quantile_at_value(means: np.ndarray, weights: np.ndarray,
                             v: float) -> float:
    if means.size == 0:
        return float("nan")
    total = weights.sum()
    cum = np.cumsum(weights) - weights / 2.0
    if v <= means[0]:
        return 0.0
    if v >= means[-1]:
        return 1.0
    i = int(np.searchsorted(means, v) - 1)
    span = means[i + 1] - means[i]
    frac = 0.0 if span <= 0 else (v - means[i]) / span
    return float((cum[i] + frac * (cum[i + 1] - cum[i])) / total)


def sketches_to_base64(starts, lens, means, weights) -> List[str]:
    """A digest's text: base64 of a simple framing (count, then f64
    (mean, weight) pairs), the role of the reference's TDigest
    serialization."""
    import base64
    import struct
    out = []
    for i in range(len(starts)):
        s, ln = int(starts[i]), int(lens[i])
        buf = struct.pack("<q", ln)
        for j in range(s, s + ln):
            buf += struct.pack("<dd", float(means[j]), float(weights[j]))
        out.append(base64.b64encode(buf).decode())
    return out
