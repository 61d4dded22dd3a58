"""Fault-tolerant execution (FTE).

Counterpart of ``trino_tpu/fte/`` (host only).

Reference parity: Trino's fault-tolerant execution mode —
RetryPolicy.TASK (core/trino-main/.../execution/RetryPolicy.java), the
spooling exchange manager (plugin/trino-exchange-filesystem writing
completed task output to durable storage so a retried consumer re-reads
it instead of re-running the producer), EventDrivenFaultTolerantQuery-
Scheduler's task-attempt bookkeeping, and speculative execution of
slow tasks (adaptive straggler re-dispatch).

TPU-first shape: the unit of retry is a *leaf fragment task* — one
(fragment, split-share) attempt on one worker host (exec/remote.py).
Completed attempt output is committed to a spool as serialized page
frames (serde.py), first-commit-wins, so a late duplicate attempt from
a retry or a speculative re-dispatch is discarded, never double-counted
— and the coordinator combine reads the spool, not per-thread memory.
"""

from .objectstore import (InMemoryObjectStore, ObjectStore,
                          ObjectStoreSpool, TransientObjectStoreError)
from .retry import (RETRY_NONE, RETRY_TASK, RetryController, RetryPolicy,
                    backoff_delay, pick_worker)
from .speculate import StragglerDetector
from .spool import LocalDirSpool, SpoolManager, default_spool, make_spool

__all__ = [
    "RETRY_NONE", "RETRY_TASK", "RetryController", "RetryPolicy",
    "backoff_delay", "pick_worker", "StragglerDetector",
    "LocalDirSpool", "SpoolManager", "make_spool", "default_spool",
    "ObjectStore", "ObjectStoreSpool", "InMemoryObjectStore",
    "TransientObjectStoreError",
]
