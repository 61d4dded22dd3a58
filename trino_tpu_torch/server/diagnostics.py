"""Leak and orphan detection — the reference's leak-analysis tier.

Counterpart of ``trino_tpu/server/diagnostics.py`` (host code).

Reference parity: execution/QueryTracker's enforceTimeLimits +
ClusterMemoryLeakDetector (queries gone from the tracker but still
holding reserved memory) and the testing harness's thread-leak checks
(TestingTrinoServer asserts no stray query threads after close).

``leak_report`` snapshots the suspicious state; ``ThreadLeakGuard``
wraps a scope (a test, a drain) and reports threads that outlive it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class LeakReport:
    """One snapshot of would-be leaks; empty lists == clean."""
    stuck_queries: List[str] = field(default_factory=list)
    retained_results_bytes: int = 0
    scan_cache_bytes: int = 0
    spill_files: List[str] = field(default_factory=list)
    orphaned_threads: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not (self.stuck_queries or self.spill_files
                    or self.orphaned_threads)


def leak_report(coordinator, stuck_after_s: float = 3600.0,
                now: Optional[float] = None,
                orphan_grace_s: float = 5.0) -> LeakReport:
    """Inspect a Coordinator for leak analogs:
    - queries RUNNING longer than ``stuck_after_s`` (the
      enforceTimeLimits sweep's candidates),
    - result sets retained by terminal queries (memory the tracker
      still pins),
    - device scan-cache residency,
    - spill files left on disk,
    - query-runner threads outliving their query's terminal state."""
    now = time.time() if now is None else now
    rep = LeakReport()
    for q in coordinator.tracker.all():
        if q.state == "RUNNING" and now - q.created > stuck_after_s:
            rep.stuck_queries.append(q.query_id)
        if q.result is not None:
            # rough: rows x columns x 8 (the tracker pins results for
            # the paging protocol; a terminal query kept forever is
            # the ClusterMemoryLeakDetector shape)
            rep.retained_results_bytes += (
                len(q.result.rows) * max(len(q.result.columns), 1) * 8)
    from ..exec import scancache
    with scancache._SCAN_CACHE_LOCK:
        rep.scan_cache_bytes = sum(
            s["bytes"] for s in scancache._SCAN_CACHES.values())
    from ..serde import Spiller
    rep.spill_files = Spiller.live_files()
    # a thread is orphaned only when its query has been terminal for
    # longer than the grace window — the run thread legitimately winds
    # down (event listeners, group release) for a moment after _done
    ended_at = {q.query_id: q.ended
                for q in coordinator.tracker.all()
                if q.state in ("FINISHED", "FAILED", "CANCELED")}
    for t in threading.enumerate():
        qid = getattr(t, "trino_query_id", None)
        if qid is None or qid not in ended_at or not t.is_alive():
            continue
        ended = ended_at[qid]
        if ended is None or now - ended > orphan_grace_s:
            rep.orphaned_threads.append(f"{t.name} (query {qid})")
    return rep


class ThreadLeakGuard:
    """Context manager flagging threads created inside the scope that
    are still alive at exit (the TestingTrinoServer close() check)."""

    def __init__(self, grace_s: float = 2.0,
                 ignore_prefixes: tuple = ("pydevd", "IPython")):
        self.grace_s = grace_s
        self.ignore_prefixes = ignore_prefixes
        self.leaked: List[str] = []

    def __enter__(self):
        self._before = set(threading.enumerate())
        return self

    def _new_alive(self):
        # daemon threads count: the coordinator's query threads are
        # daemons and are exactly the leak class this guard exists for
        return [t for t in threading.enumerate()
                if t not in self._before and t.is_alive()
                and not t.name.startswith(self.ignore_prefixes)]

    def __exit__(self, *exc):
        deadline = time.time() + self.grace_s
        while time.time() < deadline:
            if not self._new_alive():
                break
            time.sleep(0.05)
        else:
            self.leaked = [t.name for t in self._new_alive()]
        return False
