"""Continuous queries: long-lived jobs re-dispatching incremental plans.

Counterpart of ``trino_tpu/streaming/continuous.py`` (host code); a
view's result is rebuilt on the manager's device (the coordinator's).

Three job kinds, all driven by one per-job scheduler thread on a
``stream_poll_interval_ms`` cadence, every cycle a REAL query through
the submit function the coordinator wires in (so cycles ride the
stage DAG, FTE retries, resource groups and show up in
``system.runtime.queries`` with source ``continuous``):

- ``insert`` — exactly-once incremental ``INSERT INTO ... SELECT``:
  each cycle snapshots the log's end offsets, pins the half-open
  window into the stream table reference (connectors/stream.py
  ``window_ref`` — the window rides the plan through serde, so every
  task retry reads identical rows), runs the INSERT, and only then
  commits the advanced offsets (streaming/offsets.py, epoch = cycle).
  A worker killed mid-ingest is retried WITHIN the cycle's query by
  the FTE machinery — same window, zero duplicated, zero lost rows. A
  coordinator crash in the gap between INSERT success and offset
  commit re-covers that one window (at-least-once across failover —
  the classic non-transactional-sink boundary, documented, not
  hidden).
- ``view`` — periodic-refresh materialized view: each cycle fully
  recomputes the SELECT and atomically swaps the target table
  (MemoryConnector.replace).
- ``window`` — watermarked windowed aggregation: an exactly-once
  incremental copy of the stream lands in a staging table (same
  offset machinery as ``insert``), the watermark advances to
  ``max(event time) - lateness``, and the view SQL — with
  ``{watermark}`` substituted and the stream reference redirected to
  staging — recomputes the target. Late arrivals within lateness
  re-aggregate on the next cycle because finalization is driven by
  the watermark predicate in the job's own SQL.

Durability: every state transition appends the full job record to a
JSONL ledger next to the coordinator's history dir; a replacement
coordinator on the same spool replays the ledger (last record per job
wins) and restarts RUNNING jobs, whose consumers resume from their
committed offset epochs — coordinator failover extended to jobs.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from ..catalog import ColumnMetadata, TableMetadata
from ..columnar import batch_from_pylist
from ..config import CONFIG, DeviceLike, resolve_device
from ..obs.metrics import CONTINUOUS_CYCLES, CONTINUOUS_JOBS
from .log import MessageLog, get_log
from .offsets import OffsetStore
from ..connectors.stream import window_ref

_KINDS = ("insert", "view", "window")
# consecutive failed cycles before a job is declared FAILED (a single
# transient cycle failure — a killed worker, a full queue — must not
# kill a long-lived job)
_MAX_CONSECUTIVE_FAILURES = 5


class ContinuousJob:
    def __init__(self, job_id: str, spec: dict):
        self.job_id = job_id
        self.kind = spec["kind"]
        self.sql = spec["sql"]
        self.topic = spec.get("topic", "")
        self.target = spec.get("target", "")
        self.stream_table = spec.get(
            "stream_table",
            f"stream.default.{self.topic}" if self.topic else "")
        self.poll_ms = int(spec.get("poll_interval_ms")
                           or CONFIG.stream_poll_interval_ms)
        self.ts_column = spec.get("ts_column", "")
        # an explicit 0 is a lateness of 0 (the JAX package reads it as
        # unset and applies the default)
        lateness = spec.get("lateness_ms")
        self.lateness_ms = int(CONFIG.stream_lateness_ms
                               if lateness is None else lateness)
        self.state = spec.get("state", "RUNNING")
        self.created = float(spec.get("created") or time.time())
        self.cycles = int(spec.get("cycles") or 0)
        self.rows_total = int(spec.get("rows_total") or 0)
        self.last_epoch = int(spec.get("last_epoch") or 0)
        self.watermark: Optional[float] = spec.get("watermark")
        self.last_error = spec.get("last_error", "")
        self._failures = 0
        self._stop = threading.Event()

    def to_dict(self) -> dict:
        return {"job_id": self.job_id, "kind": self.kind,
                "sql": self.sql, "topic": self.topic,
                "target": self.target,
                "stream_table": self.stream_table,
                "poll_interval_ms": self.poll_ms,
                "ts_column": self.ts_column,
                "lateness_ms": self.lateness_ms,
                "state": self.state, "created": self.created,
                "cycles": self.cycles,
                "rows_total": self.rows_total,
                "last_epoch": self.last_epoch,
                "watermark": self.watermark,
                "last_error": self.last_error}


def _split_fqn(fqn: str):
    parts = fqn.split(".")
    if len(parts) != 3:
        raise ValueError(
            f"expected catalog.schema.table, got {fqn!r}")
    return parts[0], parts[1], parts[2]


class ContinuousQueryManager:
    """Owns every job's scheduler thread + the durable job ledger.

    ``run_sql(sql) -> QueryResult`` raises on failure; the coordinator
    wires it to tracker.submit + wait (cycles are tracked queries), a
    bare runner works for unit tests. ``catalogs`` is only consulted
    for the view/window REPLACE primitive; ``device`` is where a view's
    rows are rebuilt (cuda unless ``device="cpu"``)."""

    def __init__(self, run_sql: Callable, catalogs,
                 offsets: OffsetStore,
                 jobs_path: Optional[str] = None,
                 log: Optional[MessageLog] = None,
                 device: DeviceLike = None):
        self.run_sql = run_sql
        self.device = resolve_device(device)
        self.catalogs = catalogs
        self.offsets = offsets
        self.log = log or get_log()
        self.jobs_path = jobs_path
        self._jobs: Dict[str, ContinuousJob] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()

    # --- ledger ----------------------------------------------------------
    def _persist(self, job: ContinuousJob) -> None:
        if not self.jobs_path:
            return
        os.makedirs(os.path.dirname(self.jobs_path), exist_ok=True)
        with open(self.jobs_path, "a") as f:
            f.write(json.dumps(job.to_dict()) + "\n")

    def restart_jobs(self) -> int:
        """Boot-time replay (coordinator failover): last record per
        job wins; RUNNING jobs restart, their consumers resuming from
        committed offsets. Returns how many restarted."""
        if not self.jobs_path or not os.path.exists(self.jobs_path):
            return 0
        latest: Dict[str, dict] = {}
        with open(self.jobs_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    latest[rec["job_id"]] = rec
                except (ValueError, KeyError):
                    continue
        n = 0
        for rec in latest.values():
            if rec.get("state") != "RUNNING":
                continue
            job = ContinuousJob(rec["job_id"], rec)
            with self._lock:
                if job.job_id in self._jobs:
                    continue
                self._jobs[job.job_id] = job
            self._start_thread(job)
            n += 1
        return n

    # --- lifecycle -------------------------------------------------------
    def create(self, spec: dict) -> dict:
        kind = spec.get("kind")
        if kind not in _KINDS:
            raise ValueError(
                f"kind must be one of {_KINDS}, got {kind!r}")
        if not spec.get("sql"):
            raise ValueError("sql is required")
        if kind in ("insert", "window") and not spec.get("topic"):
            raise ValueError(f"{kind} jobs require a topic")
        if kind in ("view", "window"):
            _split_fqn(spec.get("target", ""))   # validates
        if kind == "window" and not spec.get("ts_column"):
            raise ValueError("window jobs require ts_column")
        job = ContinuousJob(
            f"cq_{time.strftime('%Y%m%d_%H%M%S')}_"
            f"{uuid.uuid4().hex[:6]}", spec)
        with self._lock:
            self._jobs[job.job_id] = job
        self._persist(job)
        self._start_thread(job)
        return job.to_dict()

    def _start_thread(self, job: ContinuousJob) -> None:
        t = threading.Thread(target=self._drive, args=(job,),
                             name=f"continuous-{job.job_id}",
                             daemon=True)
        self._threads[job.job_id] = t
        CONTINUOUS_JOBS.inc()
        t.start()

    def cancel(self, job_id: str) -> bool:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            return False
        if job.state == "RUNNING":
            job.state = "CANCELED"
            self._persist(job)
        job._stop.set()
        return True

    def stop(self) -> None:
        """Coordinator shutdown: halt scheduler threads WITHOUT a
        state transition — jobs stay RUNNING in the ledger so the
        next coordinator restarts them."""
        self._shutdown.set()
        with self._lock:
            jobs = list(self._jobs.values())
        for j in jobs:
            j._stop.set()
        for t in self._threads.values():
            t.join(timeout=5.0)

    def get(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(job_id)
        return job.to_dict() if job else None

    def infos(self) -> List[dict]:
        with self._lock:
            return [j.to_dict() for j in self._jobs.values()]

    # --- the scheduler ---------------------------------------------------
    def _drive(self, job: ContinuousJob) -> None:
        try:
            while not job._stop.is_set() and job.state == "RUNNING":
                try:
                    advanced = self._cycle(job)
                    job._failures = 0
                    CONTINUOUS_CYCLES.inc(
                        outcome="advanced" if advanced else "idle")
                except Exception as e:   # noqa: BLE001 — job survives
                    job._failures += 1
                    job.last_error = f"{type(e).__name__}: {e}"[:500]
                    CONTINUOUS_CYCLES.inc(outcome="failed")
                    if job._failures >= _MAX_CONSECUTIVE_FAILURES:
                        job.state = "FAILED"
                        self._persist(job)
                        break
                job._stop.wait(job.poll_ms / 1000.0)
        finally:
            CONTINUOUS_JOBS.dec()

    def _pending_window(self, job: ContinuousJob):
        """(epoch to commit next, {partition: (start, end)}) — the
        exact rows this cycle owns, or None when fully caught up."""
        epoch, committed = self.offsets.load(job.job_id)
        start = committed.get(job.topic, {})
        ends = self.log.end_offsets(job.topic)
        window = {p: (start.get(p, 0), e) for p, e in ends.items()}
        if all(s >= e for s, e in window.values()):
            return None
        return epoch + 1, window

    def _windowed_ref(self, job: ContinuousJob, window) -> str:
        cat, schema, _ = _split_fqn(job.stream_table)
        topic_ref = window_ref(job.topic, window, job.job_id)
        return f'{cat}.{schema}."{topic_ref}"'

    def _rewrite(self, sql: str, job: ContinuousJob,
                 replacement: str) -> str:
        if job.stream_table not in sql:
            raise ValueError(
                f"job sql must reference {job.stream_table}")
        return sql.replace(job.stream_table, replacement)

    def _materialize(self, target: str, result) -> None:
        cat, schema, table = _split_fqn(target)
        conn = self.catalogs.connector(cat)
        batch = batch_from_pylist(
            {c: [row[i] for row in result.rows]
             for i, c in enumerate(result.columns)},
            dict(zip(result.columns, result.types)), self.device)
        if conn.get_table_metadata(schema, table) is None:
            conn.create_table(TableMetadata(schema, table, tuple(
                ColumnMetadata(c, t)
                for c, t in zip(result.columns, result.types))))
        conn.replace(schema, table, batch)

    def _commit(self, job: ContinuousJob, epoch: int,
                window) -> None:
        self.offsets.commit(
            job.job_id, epoch,
            {job.topic: {p: e for p, (_, e) in window.items()}})
        job.last_epoch = epoch

    def _cycle(self, job: ContinuousJob) -> bool:
        if job.kind == "view":
            res = self.run_sql(job.sql)
            self._materialize(job.target, res)
            job.cycles += 1
            job.rows_total += len(res.rows)
            return True
        pending = self._pending_window(job)
        if pending is None:
            return False
        epoch, window = pending
        ref = self._windowed_ref(job, window)
        if job.kind == "insert":
            res = self.run_sql(self._rewrite(job.sql, job, ref))
            job.rows_total += int(res.update_count or 0)
        else:                                    # window
            staging = self._staging_fqn(job)
            cat, schema, table = _split_fqn(staging)
            exists = self.catalogs.connector(cat).get_table_metadata(
                schema, table) is not None
            copy_sql = (
                f"INSERT INTO {staging} SELECT * FROM {ref}"
                if exists else
                f"CREATE TABLE {staging} AS SELECT * FROM {ref}")
            res = self.run_sql(copy_sql)
            job.rows_total += int(res.update_count or 0)
        # the window's INSERT succeeded: seal the epoch. A crash in
        # THIS gap is the documented at-least-once boundary.
        self._commit(job, epoch, window)
        if job.kind == "window":
            self._refresh_window_view(job)
        job.cycles += 1
        return True

    def _staging_fqn(self, job: ContinuousJob) -> str:
        cat, schema, table = _split_fqn(job.target)
        # staging lives next to the target so REPLACE and the
        # recompute read through one connector
        return f"{cat}.{schema}.{table}__cq_staging"

    def _refresh_window_view(self, job: ContinuousJob) -> None:
        staging = self._staging_fqn(job)
        wm_res = self.run_sql(
            f"SELECT max({job.ts_column}) FROM {staging}")
        max_ts = wm_res.rows[0][0] if wm_res.rows else None
        if max_ts is None:
            return
        job.watermark = float(max_ts) - job.lateness_ms
        sql = self._rewrite(job.sql, job, staging)
        sql = sql.replace("{watermark}", repr(job.watermark))
        self._materialize(job.target, self.run_sql(sql))
