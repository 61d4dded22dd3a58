"""Engine configuration and device selection for the PyTorch engine.

Counterpart of ``trino_tpu/config.py``. Torch needs no 64-bit switch:
every tensor the engine creates names its dtype (SQL BIGINT is int64,
DOUBLE is float64), because torch's default float type is float32.

Device rule: every entry point runs on ``"cuda"`` unless its caller
passes ``device="cpu"``. Without a card and without that request,
``resolve_device`` raises; the engine never carries on on the CPU by
itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` by default,
    ``cpu`` only when asked for. Raises when CUDA is wanted and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class EngineConfig:
    """Process-wide defaults that session properties read (the
    reference's etc/config.properties). Only the fields the ported
    session and executor consult; values are the JAX engine's
    defaults."""

    # minimum physical capacity bucket (see capacity_for)
    min_capacity: int = 1 << 10
    # per-query device memory limit in bytes
    max_query_memory_per_node: int = 16 << 30
    # largest join output materialised as one batch; beyond it the JAX
    # engine spills to host memory (not ported: such a join raises)
    max_batch_rows: int = 1 << 22
    spill_enabled: bool = True
    prewarm_enabled: bool = True
    prewarm_top_k: int = 8
    stream_chunk_rows: int = 0
    ragged_batch_rows: int = 1 << 16
    stream_poll_interval_ms: int = 500
    stream_lateness_ms: int = 1000


CONFIG = EngineConfig()


class MemoryLimitExceeded(Exception):
    """EXCEEDED_LOCAL_MEMORY_LIMIT: a capacity decision would allocate
    more device memory than query_max_memory_per_node allows."""


def reserve_bytes(rows: int, n_lanes: int, limit_bytes: int,
                  what: str) -> int:
    """Check an allocation of rows x n_lanes 8-byte device lanes
    against the per-node query memory limit."""
    est = rows * max(n_lanes, 1) * 8
    if est > limit_bytes:
        raise MemoryLimitExceeded(
            f"Query exceeded per-node memory limit of {limit_bytes} "
            f"bytes ({what} needs ~{est} bytes for {rows} rows x "
            f"{n_lanes} lanes); raise query_max_memory_per_node")
    return est


def capacity_for(n: int, minimum: Optional[int] = None) -> int:
    """Round ``n`` up to a power-of-two capacity bucket (the same
    buckets as the JAX engine, so both packages pad alike)."""
    floor = CONFIG.min_capacity if minimum is None else minimum
    cap = max(int(n), 1)
    bucket = max(floor, 1)
    while bucket < cap:
        bucket <<= 1
    return bucket
