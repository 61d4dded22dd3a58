"""Object-store-shaped spool backend.

Counterpart of ``trino_tpu/fte/objectstore.py`` (host code).

Reference parity: trino-exchange-filesystem's S3FileSystemExchangeStorage
— the spooling exchange written through an object-store client
(put/get/list/delete over opaque keys) instead of a local directory, so
completed task output is durable across HOSTS, not just processes. The
client surface here is the S3/GCS common denominator:

    put(key, data)             unconditional write
    put_if_absent(key, data)   conditional create (S3 If-None-Match:*)
    get(key) -> bytes|None
    list(prefix) -> [keys]
    delete_prefix(prefix)
    mtime(key) -> float

``InMemoryObjectStore`` emulates that surface for tests (and for
single-process clusters that want the object-store code path without a
real bucket), including *injectable transient failures*: real object
stores throw 503 SlowDown / connection resets under load, so every
spool operation runs through a bounded-retry/backoff wrapper and the
emulation can be told to fail the next N calls.

Layout mirrors the local-dir backend (fte/spool.py) key-for-path:

    <query_id>/f<fid>.p<part>/a<attempt>/page_00000
    <query_id>/f<fid>.p<part>/COMMITTED      <- winning attempt

Commit protocol is the same first-commit-wins: frames are put under the
attempt prefix, then the COMMITTED marker is claimed with a conditional
put. Exactly one attempt wins; a loser deletes its own frames and
reports the winner. TTL cleanup reaps whole query prefixes whose newest
object is older than ``ttl_s``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..obs.metrics import METRICS
from .faultpoints import fault_point
from .spool import (_M_SPOOL_DUPES, _M_SPOOL_READ, _M_SPOOL_WRITTEN,
                    SpoolManager)

_M_OBJSTORE_OPS = METRICS.counter(
    "trino_tpu_objectstore_requests_total",
    "Object-store spool requests by operation", ("op",))
_M_OBJSTORE_RETRIES = METRICS.counter(
    "trino_tpu_objectstore_retries_total",
    "Object-store spool operations retried after a transient failure")


class TransientObjectStoreError(Exception):
    """A retriable store failure (503 SlowDown, connection reset): the
    spool retries these within its budget; anything else propagates."""


class ObjectStore:
    """Minimal S3/GCS-shaped client surface the spool needs."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Create ``key`` only if it does not exist; returns True when
        this call created it (S3 conditional write If-None-Match:*)."""
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def list_entries(self, prefix: str) -> List[Tuple[str, float]]:
        """``(key, mtime)`` pairs in one call — S3/GCS LIST responses
        already carry LastModified, so a client overriding this makes
        the TTL sweep a single listing instead of one metadata round
        trip per object. Default: list + per-key mtime (correct for
        any backend, O(objects) requests)."""
        out: List[Tuple[str, float]] = []
        for k in self.list(prefix):
            out.append((k, self.mtime(k) or 0.0))
        return out

    def delete_prefix(self, prefix: str) -> int:
        raise NotImplementedError

    def mtime(self, key: str) -> Optional[float]:
        raise NotImplementedError


class InMemoryObjectStore(ObjectStore):
    """Dict-backed emulation with injectable transient faults.

    ``inject_failures(n, ops=...)`` makes the next ``n`` matching
    operations raise ``TransientObjectStoreError`` before touching
    state — the shape of a flaky network/bucket, exercised by the
    chaos tests against the spool's retry budget."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[str, Tuple[bytes, float]] = {}
        self._fail_remaining = 0
        self._fail_ops: Optional[frozenset] = None
        # observability for tests: how many operations actually ran
        self.op_counts: Dict[str, int] = {}

    def inject_failures(self, n: int,
                        ops: Optional[List[str]] = None) -> None:
        with self._lock:
            self._fail_remaining = int(n)
            self._fail_ops = frozenset(ops) if ops else None

    def _maybe_fail(self, op: str) -> None:
        # caller holds the lock
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        if self._fail_remaining > 0 and (self._fail_ops is None
                                         or op in self._fail_ops):
            self._fail_remaining -= 1
            raise TransientObjectStoreError(
                f"injected transient failure on {op}")

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._maybe_fail("put")
            self._objects[key] = (bytes(data), time.time())

    def put_if_absent(self, key: str, data: bytes) -> bool:
        with self._lock:
            self._maybe_fail("put")
            if key in self._objects:
                return False
            self._objects[key] = (bytes(data), time.time())
            return True

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            self._maybe_fail("get")
            entry = self._objects.get(key)
            return entry[0] if entry is not None else None

    def list(self, prefix: str) -> List[str]:
        with self._lock:
            self._maybe_fail("list")
            return sorted(k for k in self._objects
                          if k.startswith(prefix))

    def list_entries(self, prefix: str) -> List[Tuple[str, float]]:
        with self._lock:
            self._maybe_fail("list")
            return sorted((k, v[1]) for k, v in self._objects.items()
                          if k.startswith(prefix))

    def delete_prefix(self, prefix: str) -> int:
        with self._lock:
            self._maybe_fail("delete")
            doomed = [k for k in self._objects if k.startswith(prefix)]
            for k in doomed:
                del self._objects[k]
            return len(doomed)

    def mtime(self, key: str) -> Optional[float]:
        with self._lock:
            entry = self._objects.get(key)
            return entry[1] if entry is not None else None


class ObjectStoreSpool(SpoolManager):
    """Spool over an ``ObjectStore`` client with bounded retries.

    Every store call is wrapped in ``_retry``: up to ``max_attempts``
    tries with exponential backoff on ``TransientObjectStoreError``.
    The budget is deliberately small — a dead bucket should fail the
    attempt (which the task-retry engine then handles), not hang the
    query."""

    def __init__(self, store: ObjectStore,
                 ttl_s: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 backoff_initial_s: Optional[float] = None):
        from ..config import CONFIG
        self.store = store
        self.ttl_s = max(float(CONFIG.spool_ttl_s if ttl_s is None
                               else ttl_s), 60.0)
        self.max_attempts = int(CONFIG.objectstore_max_attempts
                                if max_attempts is None else max_attempts)
        self.backoff_initial_s = float(
            CONFIG.objectstore_backoff_s if backoff_initial_s is None
            else backoff_initial_s)
        self._last_sweep = 0.0
        self._released: set = set()

    # -- retry wrapper -------------------------------------------------
    def _retry(self, op: str, fn: Callable):
        _M_OBJSTORE_OPS.inc(op=op)
        delay = self.backoff_initial_s
        for attempt in range(max(self.max_attempts, 1)):
            try:
                return fn()
            except TransientObjectStoreError:
                if attempt + 1 >= max(self.max_attempts, 1):
                    raise
                _M_OBJSTORE_RETRIES.inc()
                time.sleep(delay)
                delay = min(delay * 2.0, 1.0)

    # -- layout --------------------------------------------------------
    @staticmethod
    def _task_prefix(query_id: str, fragment_id: int, part: int) -> str:
        return f"{query_id}/f{fragment_id}.p{part}"

    # -- SpoolManager --------------------------------------------------
    def commit(self, query_id: str, fragment_id: int, part: int,
               attempt: int, frames: List[bytes]) -> int:
        if self._is_released(query_id):
            return attempt        # finished query: drop, don't resurrect
        tpre = self._task_prefix(query_id, fragment_id, part)
        apre = f"{tpre}/a{attempt}"
        for i, frame in enumerate(frames):
            self._retry("put", lambda k=f"{apre}/page_{i:05d}",
                        d=frame: self.store.put(k, d))
        marker = f"{tpre}/COMMITTED"
        fault_point("spool.pre_marker")
        won = self._retry("put", lambda: self.store.put_if_absent(
            marker, str(attempt).encode()))
        if won:
            _M_SPOOL_WRITTEN.inc(sum(len(f) for f in frames))
            return attempt
        winner = self.committed_attempt(query_id, fragment_id, part)
        if winner is None:
            # unreadable marker (corrupt/legacy): usurp it — same
            # degenerate-case semantics as the local backend
            self._retry("put", lambda: self.store.put(
                marker, str(attempt).encode()))
            _M_SPOOL_WRITTEN.inc(sum(len(f) for f in frames))
            return attempt
        if winner != attempt:
            _M_SPOOL_DUPES.inc()
            self._retry("delete",
                        lambda: self.store.delete_prefix(apre + "/"))
        return winner

    def committed_attempt(self, query_id: str, fragment_id: int,
                          part: int) -> Optional[int]:
        marker = f"{self._task_prefix(query_id, fragment_id, part)}" \
                 "/COMMITTED"
        raw = self._retry("get", lambda: self.store.get(marker))
        try:
            return int(raw)
        except (TypeError, ValueError):
            return None

    def read(self, query_id: str, fragment_id: int,
             part: int) -> Optional[List[bytes]]:
        attempt = self.committed_attempt(query_id, fragment_id, part)
        if attempt is None:
            return None
        apre = f"{self._task_prefix(query_id, fragment_id, part)}" \
               f"/a{attempt}/"
        keys = self._retry("list", lambda: self.store.list(apre))
        if not keys and self.committed_attempt(
                query_id, fragment_id, part) != attempt:
            # reaped between the marker get and the list: the reap
            # deletes the marker too, so its absence distinguishes
            # missing output (None — callers treat it as a failure)
            # from a legitimately empty commit ([])
            return None
        frames: List[bytes] = []
        for k in keys:
            data = self._retry("get", lambda key=k: self.store.get(key))
            if data is None:
                return None       # reaped between list and get
            frames.append(data)
        _M_SPOOL_READ.inc(sum(len(f) for f in frames))
        return frames

    def frame_count(self, query_id: str, fragment_id: int,
                    part: int) -> Optional[int]:
        attempt = self.committed_attempt(query_id, fragment_id, part)
        if attempt is None:
            return None
        apre = f"{self._task_prefix(query_id, fragment_id, part)}" \
               f"/a{attempt}/"
        return len(self._retry("list", lambda: self.store.list(apre)))

    def read_frame(self, query_id: str, fragment_id: int, part: int,
                   index: int) -> Optional[bytes]:
        attempt = self.committed_attempt(query_id, fragment_id, part)
        if attempt is None:
            return None
        key = f"{self._task_prefix(query_id, fragment_id, part)}" \
              f"/a{attempt}/page_{index:05d}"
        data = self._retry("get", lambda: self.store.get(key))
        if data is not None:
            _M_SPOOL_READ.inc(len(data))
        return data

    def release(self, query_id: str) -> None:
        self._mark_released(query_id)
        try:
            self._retry("delete", lambda: self.store.delete_prefix(
                f"{query_id}/"))
        except TransientObjectStoreError:
            pass                  # the TTL sweep backstops a failed drop

    def release_fragment(self, query_id: str, fragment_id: int) -> None:
        try:
            self._retry("delete", lambda: self.store.delete_prefix(
                f"{query_id}/f{fragment_id}.p"))
        except TransientObjectStoreError:
            pass                  # the TTL sweep backstops a failed drop

    def cleanup(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        try:
            # one listing carries the mtimes (list_entries): a
            # per-object mtime round trip would make the sweep
            # O(total objects) network requests on a real bucket
            entries = self._retry(
                "list", lambda: self.store.list_entries(""))
        except TransientObjectStoreError:
            return 0
        newest: Dict[str, float] = {}
        for k, mt in entries:
            qid = k.split("/", 1)[0]
            newest[qid] = max(newest.get(qid, 0.0), mt or 0.0)
        removed = 0
        for qid, mt in newest.items():
            if mt < now - self.ttl_s:
                try:
                    self._retry("delete",
                                lambda q=qid: self.store.delete_prefix(
                                    f"{q}/"))
                    removed += 1
                except TransientObjectStoreError:
                    continue
        return removed
