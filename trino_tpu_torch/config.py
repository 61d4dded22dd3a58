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
import os
import tempfile
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


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


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
    # largest join output materialised as one batch; beyond it the join
    # spills to host memory in chunks of at most this many rows
    max_batch_rows: int = 1 << 22
    spill_enabled: bool = True
    # device bytes the scan cache (exec/scancache.py) may hold across
    # queries; 0 turns the cache off
    scan_cache_bytes: int = 4 << 30
    # the hot-shape pre-warm (exec/hotshapes.py, exec/aot.py): registry
    # capacity, how many top shapes a joining worker warms before it
    # announces itself warm, and the process-wide pre-warm default (each
    # query's recording is gated by the prewarm_enabled session property)
    hot_shape_entries: int = _env_int("TRINO_TPU_HOT_SHAPE_ENTRIES", 128)
    prewarm_top_k: int = _env_int("TRINO_TPU_PREWARM_TOP_K", 8)
    prewarm_enabled: bool = os.environ.get("TRINO_TPU_PREWARM",
                                           "1") == "1"
    stream_chunk_rows: int = 0
    ragged_batch_rows: int = 1 << 16
    # process-wide default for the stream_poll_interval_ms session
    # property: the cadence at which continuous queries re-dispatch
    # their incremental plan (streaming/continuous.py)
    stream_poll_interval_ms: int = _env_int(
        "TRINO_TPU_STREAM_POLL_MS", 500)
    # default allowed event-time lateness (ms) for watermarked
    # windowed continuous queries: watermark = max(ts) - lateness
    stream_lateness_ms: int = _env_int(
        "TRINO_TPU_STREAM_LATENESS_MS", 1000)
    # streaming ingestion (streaming/): durable segment files of the
    # append-only message log. A sibling of the spool dir, never inside
    # it, so the spool's TTL sweep cannot reap live topics; uid-scoped
    # like spool_dir (ingested messages transit here).
    stream_dir: str = os.environ.get(
        "TRINO_TPU_STREAM_DIR",
        os.path.join(tempfile.gettempdir(),
                     f"trino_tpu_stream_{getattr(os, 'getuid', int)()}"))
    # default partition count of implicitly-created topics (CREATE
    # TABLE stream.default.t / first ingest into an unknown topic)
    stream_partitions: int = _env_int("TRINO_TPU_STREAM_PARTITIONS", 2)
    # fsync segment appends: the log survives process kills either way
    # (one O_APPEND write a batch); fsync also survives power loss at a
    # per-append cost
    stream_fsync: bool = os.environ.get("TRINO_TPU_STREAM_FSYNC",
                                        "0") == "1"
    # OTLP trace export sinks (obs/otlp.py): a JSONL file path and/or
    # an OTLP/HTTP collector endpoint. Empty = export off; the
    # coordinator's GET /v1/trace/{query_id} works either way.
    # Per-query opt-out: SET SESSION otlp_export = false.
    otlp_file: str = os.environ.get("TRINO_TPU_OTLP_FILE", "")
    otlp_endpoint: str = os.environ.get("TRINO_TPU_OTLP_ENDPOINT", "")

    # The coordinator's services (server/, fte/, obs/history.py,
    # exec/learnedstats.py, exec/resultcache.py), under the JAX
    # engine's names and environment variables.
    # Cluster memory pool in bytes (server/memory.py); 0 disables pool
    # governance (the per-node limit still applies).
    cluster_memory_pool_bytes: int = _env_int(
        "TRINO_TPU_CLUSTER_MEMORY_POOL", 0)
    # The spool (fte/spool.py): its root directory (uid-scoped: query
    # results transit it), the TTL after which an abandoned query's
    # entries are reaped, and the backend ("local" or "memory", the
    # object-store code path).
    spool_dir: str = os.environ.get(
        "TRINO_TPU_SPOOL_DIR",
        os.path.join(tempfile.gettempdir(),
                     f"trino_tpu_spool_{getattr(os, 'getuid', int)()}"))
    spool_ttl_s: int = _env_int("TRINO_TPU_SPOOL_TTL", 3600)
    spool_backend: str = os.environ.get("TRINO_TPU_SPOOL_BACKEND",
                                        "local")
    # the object-store spool's retry budget (fte/objectstore.py): tries
    # a spool operation gets, with exponential backoff from this delay
    objectstore_max_attempts: int = _env_int(
        "TRINO_TPU_OBJECTSTORE_ATTEMPTS", 4)
    objectstore_backoff_s: float = float(os.environ.get(
        "TRINO_TPU_OBJECTSTORE_BACKOFF_S", "0.02"))
    # The worker (server/task_worker.py, exec/taskexec.py): runner slots
    # of the shared split scheduler (0 = max(4, 2 x cores)); the
    # worker-local memory budget over live task reservations and the
    # scan cache (0 = off); the BUSY shed factor over the runner slots
    # (0 = never shed) and the time constant of its open-task EMA.
    task_runner_threads: int = _env_int("TRINO_TPU_TASK_RUNNERS", 0)
    # per-worker fetch-once cache of replicate exchange frames
    # (stage/exchange.py); 0 disables it
    replicate_cache_bytes: int = _env_int(
        "TRINO_TPU_REPLICATE_CACHE", 64 << 20)
    worker_memory_bytes: int = _env_int(
        "TRINO_TPU_WORKER_MEMORY_BYTES", 0)
    busy_shed_factor: int = _env_int("TRINO_TPU_BUSY_SHED_FACTOR", 8)
    busy_shed_ema_s: float = _env_float("TRINO_TPU_BUSY_SHED_EMA_S",
                                        2.0)
    # Restart-recovery persistence cap (fte/recovery.py): past it a
    # finished query is not re-pullable from a restarted coordinator.
    # 0 = no cap.
    result_spool_max_bytes: int = _env_int(
        "TRINO_TPU_RESULT_SPOOL_MAX_BYTES", 64 << 20)
    # Coordinator result cache (exec/resultcache.py) byte budget; 0
    # disables it (the result_cache_enabled session property gates each
    # query).
    result_cache_bytes: int = _env_int(
        "TRINO_TPU_RESULT_CACHE_BYTES", 64 << 20)
    # Query history (obs/history.py) and learned statistics
    # (exec/learnedstats.py): record capacity and TTL, the registry's
    # entry cap and EMA alpha.
    history_capacity: int = _env_int("TRINO_TPU_HISTORY_CAPACITY",
                                     1024)
    history_ttl_s: int = _env_int("TRINO_TPU_HISTORY_TTL", 7 * 86400)
    learned_stats_entries: int = _env_int(
        "TRINO_TPU_LEARNED_STATS_ENTRIES", 512)
    learned_stats_alpha: float = _env_float(
        "TRINO_TPU_LEARNED_STATS_ALPHA", 0.2)
    # system.runtime.metrics ring (obs/history.py MetricsRing): slots
    # and the least seconds between two samples.
    metrics_ring_slots: int = _env_int("TRINO_TPU_METRICS_RING", 64)
    metrics_ring_interval_s: float = _env_float(
        "TRINO_TPU_METRICS_RING_INTERVAL_S", 15.0)


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
