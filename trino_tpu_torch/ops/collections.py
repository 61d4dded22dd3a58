"""Collection aggregates on the host: map_union, multimap_agg,
numeric_histogram.

Counterpart of ``trino_tpu/ops/collections.py``. These aggregates build
per-group nested structures whose entry counts are data-dependent twice
over (rows per group x entries per row); like merge(hll) they usually
consume small pre-aggregated batches, so they run in numpy over lanes
fetched from the batch's device. Entries are chosen by index into the
flat pools and the output pools are gathered on the device with
``Column.gather``, so nested element types (dictionary strings,
decimals, arrays) ride along without per-type host code.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column
from ..config import capacity_for
from ..types import DOUBLE, ArrayType, MapType
from .digest import _compress, host

__all__ = ["Groups", "rows_by_group", "grouped_map_union", "grouped_multimap_agg",
           "grouped_numeric_histogram"]


class Groups:
    """Each group's original-row indices, in group-sorted row order: a
    sequence of ``gcap`` arrays (views of one row lane cut at the group
    bounds), with ``nonempty()`` to visit only the groups that hold rows
    (a batch's group capacity can be millions of empty slots)."""

    def __init__(self, rows: np.ndarray, bounds: np.ndarray):
        self.rows = rows
        self.bounds = bounds

    def __len__(self) -> int:
        return len(self.bounds) - 1

    def __getitem__(self, g: int) -> np.ndarray:
        return self.rows[self.bounds[g]:self.bounds[g + 1]]

    def __iter__(self):
        return (self[g] for g in range(len(self)))

    def nonempty(self):
        for g in np.nonzero(np.diff(self.bounds))[0]:
            yield int(g), self[int(g)]


def nonempty(groups):
    """(group, rows) of the groups that hold rows."""
    if isinstance(groups, Groups):
        return groups.nonempty()
    return ((g, r) for g, r in enumerate(groups) if r.size)


def offsets_of(length: np.ndarray) -> np.ndarray:
    """Each group's start in the pools: the lengths before it."""
    return np.cumsum(length) - length


def rows_by_group(order: torch.Tensor, gid: torch.Tensor,
                  valid_s: torch.Tensor, gcap: int) -> Groups:
    """Original-row indices per group, in group-sorted row order.
    ``order``/``gid``/``valid_s`` are the group-sorted lanes of
    ops/groupby.py (valid_s = live & input-valid & FILTER mask)."""
    order, gid, valid_s = host(order), host(gid), host(valid_s)
    keep = valid_s & (gid >= 0) & (gid < gcap)
    g = gid[keep]
    rows = order[keep].astype(np.int64)
    # a stable sort by group keeps rows in group-sorted order, then one
    # split at the group boundaries (no loop over rows)
    perm = np.argsort(g, kind="stable")
    return Groups(rows[perm], np.searchsorted(g[perm], np.arange(gcap + 1)))


def _entry_key_fn(col: Column):
    """Host equality key for one flat pool position."""
    data = host(col.data)
    data2 = None if col.data2 is None else host(col.data2)
    valid = None if col.valid is None else host(col.valid)

    def key(j: int):
        if valid is not None and not valid[j]:
            return (False, 0, 0)
        d2 = 0 if data2 is None else data2[j].item()
        return (True, data[j].item(), d2)
    return key


def _pool_gather(elem: Column, idx) -> Column:
    idx = np.asarray(idx, dtype=np.int64)
    padded = np.zeros(capacity_for(max(int(idx.shape[0]), 1)), np.int64)
    padded[:idx.shape[0]] = idx
    return elem.gather(torch.from_numpy(padded).to(elem.device))


def _lane(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def grouped_map_union(col: Column, groups: List[np.ndarray],
                      group_valid) -> Column:
    """Per-group union of map entries; the first occurrence of a key
    wins (the reference's MapUnionAggregation keeps the first seen
    value)."""
    starts, lens = host(col.data), host(col.data2)
    keyf = _entry_key_fn(col.elements)
    sel: List[int] = []
    out_len = np.zeros(len(groups), dtype=np.int64)
    for g, rows in nonempty(groups):
        before = len(sel)
        seen = set()
        for r in rows:
            s, ln = int(starts[r]), int(lens[r])
            for j in range(s, s + ln):
                k = keyf(j)
                if k not in seen:
                    seen.add(k)
                    sel.append(j)
        out_len[g] = len(sel) - before
    out_start = offsets_of(out_len)
    dev = col.device
    return Column(col.type, _lane(out_start, dev), group_valid, None,
                  _lane(out_len, dev), _pool_gather(col.elements, sel),
                  _pool_gather(col.elements2, sel))


def grouped_multimap_agg(kcol: Column, vcol: Column,
                         groups: List[np.ndarray], group_valid) -> Column:
    """multimap_agg(k, v) -> map(K, array(V)): per group, distinct keys
    in first-seen order, each mapped to the array of its values in row
    order (NULL values are collected; a NULL key is a key)."""
    keyf = _entry_key_fn(kcol)
    key_rows: List[int] = []      # one representative row per (g, key)
    val_rows: List[int] = []      # value pool rows, grouped by (g, key)
    arr_start: List[int] = []
    arr_len: List[int] = []
    out_len = np.zeros(len(groups), dtype=np.int64)
    for g, rows in nonempty(groups):
        before = len(key_rows)
        order_keys: List[Tuple] = []
        per_key = {}
        for r in rows:
            k = keyf(int(r))
            if k not in per_key:
                per_key[k] = (int(r), [])
                order_keys.append(k)
            per_key[k][1].append(int(r))
        for k in order_keys:
            rep, vals = per_key[k]
            key_rows.append(rep)
            arr_start.append(len(val_rows))
            arr_len.append(len(vals))
            val_rows.extend(vals)
        out_len[g] = len(key_rows) - before
    out_start = offsets_of(out_len)
    ecap = capacity_for(max(len(key_rows), 1))
    astart = np.zeros(ecap, dtype=np.int64)
    alen = np.zeros(ecap, dtype=np.int64)
    astart[:len(arr_start)] = arr_start
    alen[:len(arr_len)] = arr_len
    dev = kcol.device
    varr = Column(ArrayType(vcol.type), _lane(astart, dev), None, None,
                  _lane(alen, dev), _pool_gather(vcol, val_rows))
    return Column(MapType(kcol.type, ArrayType(vcol.type)),
                  _lane(out_start, dev), group_valid, None,
                  _lane(out_len, dev), _pool_gather(kcol, key_rows), varr)


def _merge_histogram(values: np.ndarray, buckets: int,
                     weights: Optional[np.ndarray] = None):
    """Greedy adjacent merge of sorted (x, w) pairs until <= buckets,
    the centroid merge of the digests (``_compress``), after dedupe and
    weight accumulation."""
    if values.size == 0:
        return [], []
    if weights is None:
        xs, ws = np.unique(values, return_counts=True)
        ws = ws.astype(np.float64)
    else:
        xs, inv = np.unique(values, return_inverse=True)
        ws = np.zeros(xs.size, np.float64)
        np.add.at(ws, inv, weights.astype(np.float64))
    xs = xs.astype(np.float64)
    if xs.size <= buckets:
        return list(xs), list(ws)
    x, w = _compress(xs, ws, buckets)
    return list(x), list(w)


def grouped_numeric_histogram(col: Column, groups: List[np.ndarray],
                              group_valid, buckets: int,
                              scale: Optional[float] = None,
                              weight_col: Optional[Column] = None
                              ) -> Column:
    """numeric_histogram(buckets, v[, w]) -> map(double, double)."""
    data = host(col.data).astype(np.float64)
    if scale:
        data = data / scale
    wl = (None if weight_col is None
          else host(weight_col.data).astype(np.float64))
    keys: List[float] = []
    wts: List[float] = []
    out_len = np.zeros(len(groups), dtype=np.int64)
    for g, rows in nonempty(groups):
        xs, ws = _merge_histogram(data[rows], buckets,
                                  None if wl is None else wl[rows])
        keys.extend(xs)
        wts.extend(ws)
        out_len[g] = len(xs)
    out_start = offsets_of(out_len)
    ecap = capacity_for(max(len(keys), 1))
    kd = np.zeros(ecap, dtype=np.float64)
    vd = np.zeros(ecap, dtype=np.float64)
    kd[:len(keys)] = keys
    vd[:len(wts)] = wts
    dev = col.device
    return Column(MapType(DOUBLE, DOUBLE), _lane(out_start, dev),
                  group_valid, None, _lane(out_len, dev),
                  Column(DOUBLE, torch.from_numpy(kd).to(dev)),
                  Column(DOUBLE, torch.from_numpy(vd).to(dev)))
