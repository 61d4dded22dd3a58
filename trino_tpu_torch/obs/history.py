"""Coordinator query history: every terminal query leaves a compact,
durable record.

Counterpart of ``trino_tpu/obs/history.py`` (host only): the store is
bounded and TTL'd in memory, and append-only JSONL on disk under the
coordinator's history directory, so records survive a restart (``GET
/v1/history``, ``system.runtime.queries``). With it live the two rings
the observability endpoints serve: ``TraceRing`` (recent trace ids and
root-span summaries for ``GET /v1/trace``) and ``MetricsRing``
(periodic registry snapshots behind ``system.runtime.metrics``).

Records are appended by per-query threads while HTTP handler threads
and system-table scans read, so every method takes the store lock."""


from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..config import CONFIG
from .metrics import HISTORY_RECORDS, SLOW_QUERY_LOGS

# compact-record caps: history is a bounded diagnostic surface, not an
# archive — full SQL text and stack traces belong to /v1/query/{id}
_SQL_CAP = 512
_MSG_CAP = 300
_OPS_CAP = 64


def sql_digest(sql: str) -> str:
    """Stable identity of the query TEXT (the plan key is the
    identity of its canonical program — both ride the record)."""
    return hashlib.sha256((sql or "").encode()).hexdigest()[:16]


def record_from_query(q, plan_key: str = "") -> dict:
    """Build one history record from a terminal coordinator query
    (server/coordinator.py _Query, duck-typed). Everything numeric is
    defensive — a FAILED query may carry no result at all."""
    r = getattr(q, "result", None)
    err = getattr(q, "error", None) or {}
    stats = (getattr(r, "stats", None) or []) if r is not None else []
    created = float(getattr(q, "created", 0.0) or 0.0)
    started = getattr(q, "started", None)
    ended = float(getattr(q, "ended", None) or time.time())
    queued_s = max(((started if started is not None else ended)
                    - created), 0.0)
    cpu_s = float(getattr(r, "cpu_seconds", 0.0) or 0.0) if r else 0.0
    device_s = float(getattr(r, "device_seconds", 0.0) or 0.0) \
        if r else 0.0
    if cpu_s == 0.0 and stats:
        # local (non-dispatched) execution: the scheduler rollup never
        # ran, so attribute from the per-node stats directly
        cpu_s = sum(max(getattr(s, "cpu_s", 0.0), 0.0) for s in stats)
    if device_s == 0.0 and stats:
        device_s = sum(max(getattr(s, "device_s", 0.0), 0.0)
                       for s in stats)
    ops = []
    for s in stats[:_OPS_CAP]:
        ops.append({"name": getattr(s, "name", "?"),
                    "rows_in": int(getattr(s, "input_rows", -1)),
                    "rows_out": int(getattr(s, "output_rows", -1)),
                    "wall_s": round(getattr(s, "wall_s", 0.0), 6)})
    trace = getattr(r, "trace", None) if r is not None else None
    sess = getattr(q, "session", None)
    sql = str(getattr(q, "sql", "") or "")
    return {
        "query_id": getattr(q, "query_id", ""),
        "state": getattr(q, "state", ""),
        "user": getattr(sess, "user", "") if sess is not None else "",
        "source": getattr(q, "source", ""),
        "sql": sql[:_SQL_CAP],
        "sql_digest": sql_digest(sql),
        "plan_key": plan_key or str(getattr(r, "plan_key", "") or ""),
        "error_name": err.get("errorName"),
        "error_type": err.get("errorType"),
        "error_message": (str(err.get("message"))[:_MSG_CAP]
                          if err.get("message") else None),
        "created": created,
        "queued_s": round(queued_s, 6),
        "wall_s": round(max(ended - created, 0.0), 6),
        "cpu_s": round(cpu_s, 6),
        "device_s": round(device_s, 6),
        "rows": len(getattr(r, "rows", ()) or ()) if r else 0,
        "peak_memory_bytes": int(getattr(r, "peak_memory_bytes", 0)
                                 or 0) if r else 0,
        "spill_bytes": int(getattr(r, "spill_bytes", 0) or 0)
        if r else 0,
        "stream_chunks": int(getattr(r, "stream_chunks", 0) or 0)
        if r else 0,
        "stream_h2d_bytes": int(getattr(r, "stream_h2d_bytes", 0)
                                or 0) if r else 0,
        "ragged_batched": int(getattr(r, "ragged_batched", 0) or 0)
        if r else 0,
        "retries": int(getattr(r, "speculative_wins", 0) or 0)
        if r else 0,
        "trace_id": getattr(trace, "trace_id", None),
        "operators": ops,
    }


class QueryHistoryStore:
    """Bounded, TTL'd, JSONL-persisted record store. One instance per
    coordinator; the file outlives the process."""

    def __init__(self, path: str, capacity: Optional[int] = None,
                 ttl_s: Optional[float] = None) -> None:
        self.path = path
        self.capacity = max(int(capacity if capacity is not None
                                else CONFIG.history_capacity), 1)
        self.ttl_s = float(ttl_s if ttl_s is not None
                           else CONFIG.history_ttl_s)
        self._lock = threading.Lock()
        self._records: "deque[dict]" = deque(maxlen=self.capacity)
        self._appends_since_compact = 0
        self._load()

    # -- persistence ---------------------------------------------------
    def _load(self) -> None:
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return
        now = time.time()
        recs = []
        for line in lines[-self.capacity * 2:]:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and self._fresh(rec, now):
                recs.append(rec)
        with self._lock:
            for rec in recs[-self.capacity:]:
                self._records.append(rec)

    def _fresh(self, rec: dict, now: float) -> bool:
        if self.ttl_s <= 0:
            return True
        ts = float(rec.get("recorded_at") or rec.get("created") or 0.0)
        return (now - ts) <= self.ttl_s

    def _append_line(self, rec: dict) -> None:
        try:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        except (OSError, TypeError, ValueError):
            pass            # durable history is best-effort

    def _maybe_compact(self) -> None:
        """Rewrite the JSONL once appends exceed 4x capacity since the
        last compaction, so an immortal coordinator's history file
        stays O(capacity), not O(queries ever run)."""
        if self._appends_since_compact < self.capacity * 4:
            return
        self._appends_since_compact = 0
        snap = list(self._records)
        try:
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                for rec in snap:
                    f.write(json.dumps(rec, default=str) + "\n")
            os.replace(tmp, self.path)
        except (OSError, TypeError, ValueError):
            pass

    # -- write side ----------------------------------------------------
    def record(self, rec: dict) -> dict:
        """Append one terminal-query record (stamped, TTL-pruned,
        persisted). Returns the stamped record."""
        rec = dict(rec)
        rec.setdefault("recorded_at", time.time())
        now = rec["recorded_at"]
        with self._lock:
            while self._records and not self._fresh(self._records[0],
                                                    now):
                self._records.popleft()
            self._records.append(rec)
            self._appends_since_compact += 1
            self._append_line(rec)
            self._maybe_compact()
        HISTORY_RECORDS.inc(state=str(rec.get("state") or "UNKNOWN"))
        return rec

    def slow_log(self, rec: dict, threshold_ms: float) -> None:
        """Emit one full trace-linked slow-query record to the
        side-channel JSONL (``slow_queries.jsonl`` next to the history
        file) — the outlier log the slow_query_log_ms session property
        arms."""
        entry = dict(rec)
        entry["slow_query_threshold_ms"] = threshold_ms
        path = os.path.join(os.path.dirname(self.path) or ".",
                            "slow_queries.jsonl")
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(entry, default=str) + "\n")
        except (OSError, TypeError, ValueError):
            pass
        SLOW_QUERY_LOGS.inc()

    # -- read side -----------------------------------------------------
    def records(self, limit: Optional[int] = None,
                state: Optional[str] = None) -> List[dict]:
        """Newest-first TTL-pruned snapshot."""
        now = time.time()
        with self._lock:
            while self._records and not self._fresh(self._records[0],
                                                    now):
                self._records.popleft()
            out = [dict(r) for r in self._records]
        out.reverse()
        if state:
            out = [r for r in out if r.get("state") == state]
        if limit is not None and limit >= 0:
            out = out[:limit]
        return out

    def get(self, query_id: str) -> Optional[dict]:
        with self._lock:
            for r in reversed(self._records):
                if r.get("query_id") == query_id:
                    return dict(r)
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


class TraceRing:
    """Bounded ring of recent trace summaries — what a bare
    ``GET /v1/trace`` lists (trace id, query id, root spans), each
    expandable at ``/v1/trace/{query_id}``."""

    def __init__(self, capacity: int = 64) -> None:
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=max(capacity, 1))

    def append(self, query_id: str, state: str, trace) -> None:
        """Summarize a finished query's trace into the ring (no-op
        for traceless queries)."""
        if trace is None or not getattr(trace, "roots", None):
            return
        roots = [{"name": sp.name,
                  "wall_ms": round(sp.wall_s * 1000, 3),
                  "children": len(sp.children)}
                 for sp in trace.roots[:8]]
        with self._lock:
            self._ring.append({
                "traceId": getattr(trace, "trace_id", ""),
                "queryId": query_id,
                "state": state,
                "recordedAt": time.time(),
                "rootSpans": roots})

    def list(self) -> List[dict]:
        with self._lock:
            out = [dict(e) for e in self._ring]
        out.reverse()
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class MetricsRing:
    """Periodic whole-registry snapshots, ring-bounded. ``sample`` is
    lazy — the first reader past the interval takes the snapshot, so
    an idle cluster pays nothing."""

    def __init__(self, capacity: Optional[int] = None,
                 interval_s: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(
            maxlen=max(int(capacity if capacity is not None
                           else CONFIG.metrics_ring_slots), 1))
        self.interval_s = float(
            interval_s if interval_s is not None
            else CONFIG.metrics_ring_interval_s)
        self._last = 0.0

    def maybe_sample(self, collect_fn) -> None:
        """Take a snapshot if the interval elapsed. ``collect_fn``
        returns {node: {metric: {labels_tuple: value}}} (the parsed
        exposition shape of obs/metrics.py parse_exposition)."""
        now = time.time()
        with self._lock:
            if now - self._last < self.interval_s:
                return
            self._last = now
        try:
            snap = collect_fn()
        except Exception:       # noqa: BLE001 — sampling best-effort
            return
        with self._lock:
            self._ring.append({"ts": now, "nodes": snap})

    def snapshots(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
