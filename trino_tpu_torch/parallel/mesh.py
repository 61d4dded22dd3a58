"""The device mesh and row-sharded batches.

Counterpart of ``trino_tpu/parallel/mesh.py``. The JAX package's mesh is
single-controller: one process drives every mesh device, and a sharded
batch is one global array per lane. The port keeps that design: a
``Mesh`` is one process's ordered list of shard devices, and a
``ShardedBatch`` holds one ``Batch`` per shard, each on its shard's
device. Shards may share a card (the counterpart of the JAX package's
virtual CPU devices); with several cards, shard ``d`` lives on card
``d % count``.

Liveness is per shard, as in the JAX package: shard ``d``'s live rows
are the first ``num_rows[d]`` of its batch, and every shard of one
ShardedBatch has the same capacity, ``per_shard_cap``. Every shard's
string columns carry one dictionary (``normalize`` merges the
dictionaries that per-shard work produced apart), so codes mean the
same on every shard and a hash of codes co-locates equal strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Batch, Column, hi_lane_or_fill, is_nested, \
    map_row_lanes, take_clamped
from ..config import DeviceLike, capacity_for, resolve_device


@dataclass(frozen=True)
class Mesh:
    """The shard devices of one process, in shard order, and ``home``:
    the device the runner works on, where gathered values land."""
    devices: Tuple[torch.device, ...]
    home: torch.device

    @property
    def size(self) -> int:
        return len(self.devices)


def get_mesh(n_devices: Optional[int] = None,
             device: DeviceLike = None) -> Mesh:
    """A mesh of ``n_devices`` shards. On ``cuda`` (the default) the
    default is one shard per visible card, and shard ``d`` lives on card
    ``d % count``; on ``cpu`` the default is one shard. A mesh asked for
    on ``cuda`` raises without a card."""
    home = resolve_device(device)
    if home.type == "cuda":
        count = torch.cuda.device_count()
        n = int(n_devices or count)
        devs = tuple(torch.device("cuda", d % count) for d in range(n))
    else:
        n = int(n_devices or 1)
        devs = tuple(torch.device("cpu") for _ in range(n))
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(devs, home)


@dataclass(frozen=True)
class ShardedBatch:
    """Row-sharded Batch: ``shards[d]`` is shard d's Batch, on
    ``mesh.devices[d]``, of capacity ``per_shard_cap``."""
    shards: Tuple[Batch, ...]
    mesh: Mesh
    per_shard_cap: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def columns(self) -> Dict[str, Column]:
        """Shard 0's columns: the types and dictionaries every shard
        shares."""
        return self.shards[0].columns

    @property
    def num_rows(self) -> List[int]:
        """Per-shard live counts (one host read per shard)."""
        return [s.num_rows_host() for s in self.shards]

    def total_rows_host(self) -> int:
        return int(sum(self.num_rows))

    def schema(self):
        return self.shards[0].schema()

    def map(self, fn) -> "ShardedBatch":
        """``fn`` over every shard's Batch, capacity kept."""
        return ShardedBatch(tuple(fn(s) for s in self.shards), self.mesh,
                            self.per_shard_cap)

    def nbytes(self) -> int:
        total = 0
        for s in self.shards:
            for c in s.columns.values():
                for lane in (c.data, c.valid, c.data2):
                    if lane is not None:
                        total += lane.numel() * lane.element_size()
        return total


def fit_capacity(b: Batch, cap: int) -> Batch:
    """``b`` with every row lane cut or zero-padded to ``cap`` rows (its
    live rows fit); the flat pools of nested columns are shared."""
    def lane(t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] == cap:
            return t
        out = torch.zeros(cap, dtype=t.dtype, device=t.device)
        k = min(cap, t.shape[0])
        out[:k].copy_(t[:k])
        return out
    return Batch({k: map_row_lanes(c, lane) for k, c in b.columns.items()},
                 b.num_rows)


def normalize(shards: Sequence[Batch]) -> Tuple[Batch, ...]:
    """Shards whose string columns carry one dictionary (merged in shard
    order, so shard 0's codes stay) and whose validity and high lanes
    are present on every shard or on none."""
    shards = list(shards)
    if len(shards) < 2:
        return tuple(shards)
    cols = [dict(s.columns) for s in shards]
    changed = False
    for name in shards[0].names:
        cs = [s.column(name) for s in shards]
        if is_nested(cs[0].type):
            continue
        new = list(cs)
        d0 = cs[0].dictionary
        if d0 is not None and any(c.dictionary is not d0
                                  and c.dictionary != d0 for c in cs):
            merged = d0
            remaps = [None]
            for c in cs[1:]:
                merged, _, ro = merged.merge(c.dictionary)
                remaps.append(ro)
            for i, (c, ro) in enumerate(zip(cs, remaps)):
                if ro is None:
                    new[i] = dc_replace(c, dictionary=merged)
                else:
                    table = torch.from_numpy(np.asarray(ro, np.int32))
                    new[i] = dc_replace(c, data=take_clamped(
                        table.to(c.device), c.data), dictionary=merged)
        elif d0 is not None:
            new = [c if c.dictionary is d0 else
                   dc_replace(c, dictionary=d0) for c in cs]
        if len({c.valid is None for c in new}) > 1:
            new = [dc_replace(c, valid=c.valid_mask()) for c in new]
        if len({c.data2 is None for c in new}) > 1:
            new = [dc_replace(c, data2=hi_lane_or_fill(c)) for c in new]
        if any(a is not b for a, b in zip(new, cs)):
            changed = True
            for cd, c in zip(cols, new):
                cd[name] = c
    if not changed:
        return tuple(shards)
    return tuple(Batch(cd, s.num_rows) for cd, s in zip(cols, shards))


def shard_batch(batch: Batch, mesh: Mesh,
                per_shard_cap: Optional[int] = None) -> ShardedBatch:
    """Range by range scatter of a Batch across the mesh (the first
    ``total % n`` shards one row longer), the analog of assigning splits
    to worker tasks."""
    n = mesh.size
    total = batch.num_rows_host()
    per = per_shard_cap or capacity_for(
        max((total + n - 1) // n, 1), minimum=8)
    counts = np.full(n, total // n, dtype=np.int64)
    counts[:total % n] += 1
    assert counts.max() <= per
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    shards = []
    for d in range(n):
        idx = torch.arange(int(offs[d]), int(offs[d]) + per,
                           dtype=torch.int64, device=batch.device)
        part = batch.gather(idx, int(counts[d]))
        shards.append(part.to(mesh.devices[d], non_blocking=True))
    return ShardedBatch(normalize(shards), mesh, per)


def shard_parts(parts: Sequence[Batch], mesh: Mesh) -> ShardedBatch:
    """Place per-worker Batches directly: part i -> shard i (splits
    already assigned per node), dictionaries merged across parts."""
    n = mesh.size
    assert len(parts) == n
    per = max(capacity_for(max(p.num_rows_host() for p in parts),
                           minimum=8), 8)
    shards = [fit_capacity(p, per).to(mesh.devices[d], non_blocking=True)
              for d, p in enumerate(parts)]
    return ShardedBatch(normalize(shards), mesh, per)


def unshard_batch(sb: ShardedBatch) -> Batch:
    """GATHER: the live prefixes of every shard, in shard order, as one
    Batch on the mesh's home device (the final exchange to the
    coordinator)."""
    from ..exec.executor import device_concat
    home = sb.mesh.home
    parts = []
    for s in sb.shards:
        n = s.num_rows_host()
        if any(is_nested(c.type) or c.elements is not None
               for c in s.columns.values()):
            parts.append(s.to(home, non_blocking=True))
            continue
        k = max(n, 1)
        cut = Batch({name: map_row_lanes(c, lambda t: t[:k])
                     for name, c in s.columns.items()}, n)
        parts.append(cut.to(home, non_blocking=True))
    return device_concat(parts)
