"""Hash repartition: the PartitionedOutput operator.

Counterpart of ``trino_tpu/stage/repartition.py``. The bucket of every
row equals the JAX package's, because it is a pure function of the key
VALUES: each key lane becomes a u64 pattern (an int64 carrier,
ops/hashing.py) — the bijective cast for integers, the equality lanes
for floats, the FNV-1a 64 hash of the string's UTF-8 bytes for a
dictionary column (computed once per dictionary entry by the page
codec's C++ loop, then gathered by code) — then ``mix64`` per lane, NULL
to 0, ``31 * h + x`` across keys from the golden seed and ``mix64``
again when there is more than one key, and ``partition_of``. A zoned
timestamp hashes its instant lane only, a long decimal its low lane
only, as the JAX package does.

The rows are cut into partitions on the batch's device: a stable sort
by bucket, one count per bucket, and one gather per partition, each
padded to its own capacity bucket. Only the serialiser then copies each
partition's lanes to the host.

Layout contract: a stage task's spooled attempt holds EXACTLY ``nparts``
frames, frame index == partition index. The consumer task for partition
p reads frame p of every upstream task.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..columnar import Batch, Column, take_clamped
from ..config import capacity_for
from ..obs.metrics import EXCHANGE_PARTITION_BYTES, EXCHANGE_PARTITIONS
from ..ops.hashing import GOLDEN, lane_to_u64, mix64, partition_of


def dictionary_value_hashes(dictionary) -> np.ndarray:
    """Per-entry uint64 FNV-1a 64 of a StringDictionary's values: a pure
    function of the string bytes, not of the process-local codes. Kept
    on the dictionary, so a dictionary is hashed once."""
    from ..serde import fnv1a64_many
    return dictionary.derived("fnv1a64",
                              lambda: fnv1a64_many(dictionary.values))


def _key_lane(col: Column) -> torch.Tensor:
    """The u64 partition lane (int64 carrier) of one key column."""
    if col.dictionary is not None:
        entry = torch.from_numpy(
            dictionary_value_hashes(col.dictionary).view(np.int64))
        return take_clamped(entry.to(col.device), col.data.to(torch.int64))
    return lane_to_u64(col.data)


def partition_buckets(batch: Batch, keys: Sequence[str],
                      nparts: int, session=None) -> torch.Tensor:
    """Bucket in [0, nparts) of each live row, as an int64 tensor on the
    batch's device."""
    n = batch.num_rows_host()
    from ..exec.hotshapes import record_program
    cap = int(batch.capacity)
    record_program(
        "repartition", ("repartition", len(keys), cap, int(nparts)), None,
        None, session,
        payload_fn=lambda: {"kind": "repartition", "nkeys": len(keys),
                            "capacity": cap, "nparts": int(nparts)})
    hashed = []
    for k in keys:
        c = batch.column(k)
        h = mix64(_key_lane(c))
        if c.valid is not None:
            h = torch.where(c.valid, h, torch.zeros_like(h))
        hashed.append(h)
    if len(hashed) == 1:
        h = hashed[0]
    else:
        acc = torch.full_like(hashed[0], GOLDEN)
        for h1 in hashed:
            acc = acc * 31 + h1
        h = mix64(acc)
    return partition_of(h[:n], nparts)


def _take(batch: Batch, idx: torch.Tensor, k: int) -> Batch:
    """Rows ``idx`` of ``batch`` in lanes of ``capacity_for(k)`` rows;
    the flat pools of ARRAY/MAP/sketch columns ride whole, as a gather
    shares them."""
    cap = capacity_for(max(k, 1), minimum=8)
    pad = torch.zeros(cap, dtype=torch.int64, device=idx.device)
    pad[:k] = idx
    return batch.gather(pad, k)


def partition_batch(batch: Batch, keys: Sequence[str],
                    nparts: int, session=None) -> List[Batch]:
    """Split ``batch`` into exactly ``nparts`` batches by key hash, on its
    device. Every live row lands in exactly one partition, at its bucket,
    in its original order; empty partitions are real zero-row batches."""
    n = batch.num_rows_host()
    dev = batch.device
    if not keys:
        # keyless: round-robin by row index
        bk = torch.arange(n, dtype=torch.int64, device=dev) % max(nparts, 1)
    else:
        bk = partition_buckets(batch, keys, nparts, session=session)
    order = torch.sort(bk, stable=True).indices
    counts = torch.bincount(bk, minlength=nparts).cpu().tolist()
    out, lo = [], 0
    for p in range(nparts):
        k = int(counts[p])
        out.append(_take(batch, order[lo:lo + k], k))
        lo += k
    return out


def partition_frames(batch: Batch, keys: Sequence[str], kind: str,
                     nparts: int, codec: Optional[int] = None,
                     session=None) -> List[bytes]:
    """A stage's output as partition frames: frame i IS partition i.
    kind="gather" (or nparts == 1) and kind="replicate" emit the whole
    batch as one frame; for replicate, every consumer task reads frame 0
    (stage/exchange.py), so the bytes are spooled once."""
    from ..serde import serialize_batch
    if kind in ("gather", "replicate") or nparts <= 1:
        parts = [batch]
    else:
        parts = partition_batch(batch, keys, nparts, session=session)
    frames = [serialize_batch(p, codec=codec) for p in parts]
    EXCHANGE_PARTITIONS.inc(len(frames), direction="written")
    EXCHANGE_PARTITION_BYTES.inc(sum(len(f) for f in frames),
                                 direction="written")
    return frames
