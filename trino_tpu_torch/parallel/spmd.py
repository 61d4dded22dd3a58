"""Per-shard programs and the collectives between them.

Counterpart of ``trino_tpu/parallel/spmd.py``. The JAX package runs a
per-shard function inside ``shard_map`` and moves rows with
``jax.lax.all_to_all`` / ``all_gather`` / ``psum`` over the mesh. Here
a per-shard program is a loop over the shards that calls the port's
batch functions on each shard's Batch, on its own device, and the
collectives are copies between the shards' devices:

- ``all_to_all`` (REMOTE REPARTITION): each source shard orders its live
  rows by destination with a stable sort, reads its per-destination
  counts (the one host read of the exchange), and each destination
  receives every source's slice, copied to its device with
  ``non_blocking`` and concatenated in source order. Received rows keep
  (source shard, source position) order, as in the JAX package's
  ``_shard_exchange``.
- ``all_gather`` (REPLICATE): every shard receives every shard's live
  rows the same way.
- ``psum``: a sum of the per-shard counts.

No lane passes through host memory: source and destination lanes stay
on their devices, and the host sees only the counts. The destination of
a row under hash repartition is ``hash_columns(keys) mod n`` (the
unsigned remainder of the u64 hash, ``umod``), so every row lands on the
shard the JAX package's 8-device mesh would put it on. u64 values are
carried in int64 (ops/hashing.py); gathers clamp their indices
(``take_clamped``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..columnar import Batch, Column, is_nested
from ..config import capacity_for
from ..ops.groupby import COMBINABLE_KINDS, AggInput, group_aggregate
from ..ops.hashing import hash_columns, umod
from ..ops.sort import sort_lanes
from .mesh import ShardedBatch, normalize


# --------------------------------------------------------------------------
# the exchange
# --------------------------------------------------------------------------

def exchangeable(sb: ShardedBatch, keys: Sequence[str] = ()) -> bool:
    """The exchange moves value, validity and high lanes: nested columns
    (shared element pools) and two-lane keys stay off it."""
    cols = sb.columns
    if any(k not in cols for k in keys):
        return False
    if any(is_nested(c.type) or c.elements is not None
           or c.children is not None for c in cols.values()):
        return False
    return all(cols[k].data2 is None for k in keys)


def _lanes(c: Column):
    return (c.data, c.valid, c.data2)


def _route(b: Batch, pid: torch.Tensor, n: int):
    """(stable order of the live rows by destination, host counts per
    destination) of one source shard."""
    live = b.row_valid()
    key = torch.where(live, pid.to(torch.int64),
                      torch.full_like(live, n, dtype=torch.int64))
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n + 1)[:n]
    return order, counts.cpu().numpy().astype(np.int64)


def _assemble(pieces: List[List[Optional[torch.Tensor]]], template: Batch,
              dev: torch.device, cap: int, total: int) -> Batch:
    """One destination shard from its received pieces: per column, per
    lane, the sources' slices one after another in a zeroed lane of
    ``cap`` rows on ``dev``."""
    cols = {}
    for ci, (name, c) in enumerate(template.columns.items()):
        lanes = []
        for li, lane in enumerate(_lanes(c)):
            if lane is None:
                lanes.append(None)
                continue
            out = torch.zeros(cap, dtype=lane.dtype, device=dev)
            off = 0
            for src in pieces:
                p = src[ci][li]
                k = p.shape[0]
                if k:
                    out[off:off + k].copy_(p, non_blocking=True)
                    off += k
            lanes.append(out)
        cols[name] = Column(c.type, lanes[0], lanes[1], c.dictionary,
                            lanes[2])
    return Batch(cols, total)


def _exchange(sb: ShardedBatch, pids: Sequence[torch.Tensor],
              out_cap: int) -> ShardedBatch:
    """all_to_all: every live row of every shard to shard ``pid``."""
    n = sb.n_shards
    devs = sb.mesh.devices
    routes = [_route(b, pid, n) for b, pid in zip(sb.shards, pids)]
    recv = np.stack([cnt for _, cnt in routes]).sum(axis=0)
    if recv.size and int(recv.max()) > out_cap:
        raise ValueError(f"exchange overflow: a shard receives "
                         f"{int(recv.max())} rows, capacity {out_cap}")
    # per source: its live rows in destination order, gathered once on
    # the source's device
    ordered = []
    for b, (order, cnt) in zip(sb.shards, routes):
        m = int(cnt.sum())
        idx = order[:m]
        ordered.append(([[None if t is None else t.index_select(0, idx)
                          for t in _lanes(c)]
                         for c in b.columns.values()],
                        np.concatenate([[0], np.cumsum(cnt)])))
    out = []
    for d in range(n):
        pieces = []
        for lanes, starts in ordered:
            lo, hi = int(starts[d]), int(starts[d + 1])
            pieces.append([[None if t is None
                            else t[lo:hi].to(devs[d], non_blocking=True)
                            for t in col] for col in lanes])
        out.append(_assemble(pieces, sb.shards[0], devs[d], out_cap,
                             int(recv[d])))
    return ShardedBatch(tuple(out), sb.mesh, out_cap)


def _hash_pid(b: Batch, keys: Sequence[str], n: int) -> torch.Tensor:
    return umod(hash_columns([b.column(k) for k in keys]), n)


def repartition_by_hash(sb: ShardedBatch, key_names: Sequence[str],
                        out_cap: Optional[int] = None) -> ShardedBatch:
    """REMOTE REPARTITION: redistribute rows so equal keys land on the
    same shard. ``out_cap`` bounds the per-shard capacity afterwards;
    the default is the safe worst case n_dev * per_shard_cap."""
    n = sb.n_shards
    cap = out_cap or n * sb.per_shard_cap
    return _exchange(sb, [_hash_pid(b, key_names, n) for b in sb.shards],
                     cap)


def _dest_counts(sb: ShardedBatch, pids) -> torch.Tensor:
    n = sb.n_shards
    total = np.zeros(n, np.int64)
    for b, pid in zip(sb.shards, pids):
        live = b.row_valid()
        total += torch.bincount(pid.to(torch.int64)[live].clamp(0, n - 1),
                                minlength=n).cpu().numpy()
    return torch.from_numpy(total)


def repartition_dest_counts(sb: ShardedBatch,
                            key_names: Sequence[str]) -> torch.Tensor:
    """Phase 1 of a two-phase repartition: the [n_dev] row totals each
    destination would receive (psum of the per-shard counts), to size
    the exchange from real counts."""
    n = sb.n_shards
    return _dest_counts(sb, [_hash_pid(b, key_names, n)
                             for b in sb.shards])


# --------------------------------------------------------------------------
# range repartition (distributed sort)
# --------------------------------------------------------------------------

def _range_pid(batch: Batch, sort_keys, splitter_lanes) -> torch.Tensor:
    """Destination shard per row: the number of splitters whose
    composite sort-lane tuple is strictly below the row's. Splitters
    ascend, so shard-major order of per-shard sorted rows is the global
    order."""
    lanes = sort_lanes(batch, sort_keys)[1:]   # drop the liveness lane
    some = lanes[0]
    dest = torch.zeros(some.shape, dtype=torch.int64, device=some.device)
    n_split = len(splitter_lanes[0])
    for si in range(n_split):
        gt = torch.zeros(some.shape, dtype=torch.bool, device=some.device)
        eq = torch.ones(some.shape, dtype=torch.bool, device=some.device)
        for lane, sl in zip(lanes, splitter_lanes):
            sval = torch.as_tensor(sl[si].item(), dtype=lane.dtype,
                                   device=lane.device)
            gt = gt | (eq & (lane > sval))
            eq = eq & (lane == sval)
        dest = dest + gt.to(torch.int64)
    return dest


def sample_range_splitters(sb: ShardedBatch, sort_keys,
                           samples_per_shard: int = 256):
    """Phase 0 of a distributed sort: sample each shard's sort lanes
    evenly, gather the samples, and pick n_dev - 1 splitters at sample
    quantiles. A list of per-lane splitter arrays, or None when the
    relation is empty."""
    n = sb.n_shards
    S = samples_per_shard
    samples: List[List[np.ndarray]] = []
    lives = []
    for b in sb.shards:
        my_n = b.num_rows_host()
        lanes = sort_lanes(b, sort_keys)[1:]
        pos = (torch.arange(S, dtype=torch.int64) * max(my_n, 1)) // S
        samples.append([l[pos.clamp(0, l.shape[0] - 1).to(l.device)]
                        .cpu().numpy() for l in lanes])
        lives.append(np.arange(S) < my_n)
    live = np.concatenate(lives)
    if not live.any():
        return None
    lanes_h = [np.concatenate([s[i] for s in samples])[live]
               for i in range(len(samples[0]))]
    order = np.lexsort(lanes_h[::-1])
    m = len(order)
    picks = [order[min(((i + 1) * m) // n, m - 1)] for i in range(n - 1)]
    return [l[picks] for l in lanes_h]


def range_dest_counts(sb: ShardedBatch, sort_keys,
                      splitter_lanes) -> torch.Tensor:
    """Per-destination row totals of a range exchange."""
    return _dest_counts(sb, [_range_pid(b, sort_keys, splitter_lanes)
                             for b in sb.shards])


def repartition_by_range(sb: ShardedBatch, sort_keys, splitter_lanes,
                         out_cap: Optional[int] = None) -> ShardedBatch:
    """Range exchange: shard i receives the i-th ORDER BY slice."""
    cap = out_cap or sb.n_shards * sb.per_shard_cap
    return _exchange(sb, [_range_pid(b, sort_keys, splitter_lanes)
                          for b in sb.shards], cap)


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

def distributed_group_aggregate(sb: ShardedBatch,
                                key_names: Sequence[str],
                                aggs: Sequence[AggInput],
                                out_cap: Optional[int] = None
                                ) -> ShardedBatch:
    """PARTIAL aggregation per shard -> exchange by key hash -> FINAL
    aggregation (the PushPartialAggregationThroughExchange shape). A
    non-decomposable aggregate repartitions the rows first and
    aggregates exactly: every group is then wholly on one shard.

    Unless ``out_cap`` is given, the exchange is sized from the real
    per-destination counts (two-phase), where the JAX package takes the
    worst case n_dev * per_shard_cap: its static shapes need a bound
    before the data, an eager exchange does not, and the worst case
    would hold four 2^26-row finals for q1's four groups on a 4-shard
    card."""
    keys = list(key_names)

    def exchange(src: ShardedBatch) -> ShardedBatch:
        cap = out_cap or capacity_for(max(int(
            repartition_dest_counts(src, keys).max()), 1))
        return repartition_by_hash(src, keys, cap)

    if all(a.kind in COMBINABLE_KINDS for a in aggs):
        finals = [AggInput(COMBINABLE_KINDS[a.kind], a.output, None,
                           a.output) for a in aggs]
        part = shard_apply(sb, lambda b: group_aggregate(
            b, keys, list(aggs)))
        moved = exchange(ShardedBatch(part.shards, part.mesh, max(
            s.capacity for s in part.shards)))
        return shard_apply(moved, lambda b: group_aggregate(
            b, keys, finals, groups_capacity=moved.per_shard_cap))
    moved = exchange(sb)
    return shard_apply(moved, lambda b: group_aggregate(
        b, keys, list(aggs), groups_capacity=moved.per_shard_cap))


# --------------------------------------------------------------------------
# per-shard programs
# --------------------------------------------------------------------------

def shard_apply(sb: ShardedBatch, fn, out_cap: Optional[int] = None
                ) -> ShardedBatch:
    """A Batch -> Batch transformation on every shard independently
    (the pipeline segment between exchanges). ``fn`` keeps the capacity
    at ``out_cap`` (default: unchanged)."""
    cap = out_cap or sb.per_shard_cap
    return ShardedBatch(normalize([fn(b) for b in sb.shards]), sb.mesh,
                        cap)


def shard_totals(sb: ShardedBatch, fn) -> List[int]:
    """Per-shard scalar (e.g. a join's output size): fn(Batch) -> int
    scalar, as the [n_dev] list (all_gather)."""
    return [int(fn(b)) for b in sb.shards]


def _replicas(b_host: Batch, sb: ShardedBatch) -> List[Batch]:
    """The replicated operand on each shard's device (one copy per
    distinct device)."""
    by_dev = {}
    out = []
    for dev in sb.mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = b_host.to(dev, non_blocking=True)
        out.append(by_dev[dev])
    return out


def shard_apply2(sa: ShardedBatch, b_host: Batch, fn,
                 out_cap: int) -> ShardedBatch:
    """Per-shard transformation with a REPLICATED second operand (a
    broadcast join's build side, a semi join's filtering source)."""
    reps = _replicas(b_host, sa)
    return ShardedBatch(normalize([fn(a, r) for a, r in
                                   zip(sa.shards, reps)]), sa.mesh, out_cap)


def shard_totals2(sa: ShardedBatch, b_host: Batch, fn) -> List[int]:
    reps = _replicas(b_host, sa)
    return [int(fn(a, r)) for a, r in zip(sa.shards, reps)]


def shard_apply2s(sa: ShardedBatch, sb: ShardedBatch, fn,
                  out_cap: int) -> ShardedBatch:
    """Per-shard transformation over two co-sharded operands (a
    PARTITIONED join: both sides repartitioned on the join keys)."""
    return ShardedBatch(normalize([fn(a, b) for a, b in
                                   zip(sa.shards, sb.shards)]), sa.mesh,
                        out_cap)


def shard_totals2s(sa: ShardedBatch, sb: ShardedBatch, fn) -> List[int]:
    return [int(fn(a, b)) for a, b in zip(sa.shards, sb.shards)]


def broadcast_sharded(sb: ShardedBatch,
                      out_cap: Optional[int] = None) -> ShardedBatch:
    """REPLICATE exchange: every shard ends up with every live row, in
    shard order."""
    n = sb.n_shards
    cap = out_cap or n * sb.per_shard_cap
    counts = sb.num_rows
    total = int(sum(counts))
    out = []
    for d, dev in enumerate(sb.mesh.devices):
        pieces = [[[None if t is None
                    else t[:k].to(dev, non_blocking=True)
                    for t in _lanes(c)] for c in b.columns.values()]
                  for b, k in zip(sb.shards, counts)]
        out.append(_assemble(pieces, sb.shards[0], dev, cap, total))
    return ShardedBatch(tuple(out), sb.mesh, cap)
