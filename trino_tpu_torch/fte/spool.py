"""The spool: durable, first-commit-wins storage of query output.

Counterpart of ``trino_tpu/fte/spool.py`` (host only). A
``SpoolManager`` addresses entries by ``query/fragment.part/attempt``:

    <base>/<query_id>/f<fid>.p<part>/a<attempt>/page_00000.bin
    <base>/<query_id>/f<fid>.p<part>/COMMITTED      <- winning attempt

Commit protocol (idempotent, first-commit-wins): frames land in a temp
dir, the dir is atomically renamed to ``a<attempt>``, then the
``COMMITTED`` marker is created with O_EXCL. Exactly one attempt wins
the marker; a loser deletes its own frames and reports the winner. TTL
cleanup reaps whole query dirs whose mtime is older than ``ttl_s``.

On a single-node coordinator the spool holds finished queries' results
for restart recovery (fte/recovery.py); the workers' fragment output
and the object-store backend come with the worker slice.
"""


from __future__ import annotations

import os
import shutil
import threading
import time
from typing import List, Optional

from ..obs.metrics import METRICS
from .faultpoints import fault_point

_M_SPOOL_WRITTEN = METRICS.counter(
    "trino_tpu_spool_bytes_written_total",
    "Serialized page-frame bytes committed to the exchange spool")
_M_SPOOL_READ = METRICS.counter(
    "trino_tpu_spool_bytes_read_total",
    "Serialized page-frame bytes read back from the exchange spool")
_M_SPOOL_DUPES = METRICS.counter(
    "trino_tpu_spool_duplicate_attempts_total",
    "Late duplicate task attempts discarded by first-commit-wins")

class SpoolManager:
    """Pluggable spool interface (the ExchangeManager SPI analog).
    Backends: ``LocalDirSpool`` (single-host durable directory tree,
    below) and ``ObjectStoreSpool`` (fte/objectstore.py — S3/GCS-shaped
    put/get/list/delete with bounded retries, for real multi-host
    durability). ``make_spool`` selects one by name."""

    # backends set these in __init__; the time-gated sweep below is
    # shared so every backend's full scan runs at most once per TTL/4
    ttl_s: float = 3600.0
    _last_sweep: float = 0.0

    def commit(self, query_id: str, fragment_id: int, part: int,
               attempt: int, frames: List[bytes]) -> int:
        """Persist one attempt's output; returns the WINNING attempt
        for this (query, fragment, part) — not necessarily ours."""
        raise NotImplementedError

    def committed_attempt(self, query_id: str, fragment_id: int,
                          part: int) -> Optional[int]:
        raise NotImplementedError

    def read(self, query_id: str, fragment_id: int,
             part: int) -> Optional[List[bytes]]:
        """Frames of the committed attempt, or None if none committed."""
        raise NotImplementedError

    def release(self, query_id: str) -> None:
        """Drop a finished query's spool."""
        raise NotImplementedError

    def release_fragment(self, query_id: str, fragment_id: int) -> None:
        """Drop ONE fragment's spool entries without tombstoning the
        query — reserved-fragment bookkeeping (the execution manifest)
        is released on completion while the persisted result under the
        same query id must stay servable."""
        raise NotImplementedError

    def cleanup(self, now: Optional[float] = None) -> int:
        """Reap expired query spools; returns how many were removed."""
        raise NotImplementedError

    def maybe_cleanup(self, now: Optional[float] = None) -> int:
        """Time-gated ``cleanup``: the full sweep scans every query
        under the base, so callers on a dispatch hot path run it at
        most once per TTL/4 (floor 60s). The gate's check-then-set is
        under a lock: query threads call this concurrently, and an
        unlocked gate lets two threads win one window and sweep
        twice."""
        now = time.time() if now is None else now
        gate = max(min(self.ttl_s / 4, 900.0), 60.0)
        with _SWEEP_GATE_LOCK:
            if now - self._last_sweep < gate:
                return 0
            self._last_sweep = now
        return self.cleanup(now)

    # released-query tombstones, shared by every backend: a commit
    # arriving AFTER release (a straggler attempt of a finished query)
    # must be dropped, not resurrect the spool. The set is created
    # lazily per instance so a backend implementing only the abstract
    # surface never has to know about it (a class-level set would be
    # shared across every spool in the process).
    def _is_released(self, query_id: str) -> bool:
        return str(query_id) in getattr(self, "_released", ())

    def _mark_released(self, query_id: str) -> None:
        # under a lock: release() is called from request threads and
        # query threads concurrently, and the lazy check-then-set could
        # otherwise lose a tombstone to a racing first release
        with _TOMBSTONE_LOCK:
            released = getattr(self, "_released", None)
            if released is None:
                released = self._released = set()
            released.add(str(query_id))
            if len(released) > 4096:
                # bounded memory; the TTL sweep backstops anything a
                # forgotten tombstone lets through
                released.clear()
                released.add(str(query_id))


_DEFAULTS: dict = {}
_DEFAULT_LOCK = threading.Lock()
# guards every spool instance's sweep gate (the gate state is
# per-instance, but a shared lock costs nothing at once-per-TTL/4
# frequency and spares each backend from carrying its own)
_SWEEP_GATE_LOCK = threading.Lock()
# guards the released-query tombstone set's lazy init + mutation
# (release() arrives from request threads and dispatch threads)
_TOMBSTONE_LOCK = threading.Lock()


def make_spool(backend: Optional[str] = None,
               local_base_dir: Optional[str] = None,
               **kwargs) -> SpoolManager:
    """Backend factory (config- or session-selected): ``local``
    (default) is the directory-tree spool; ``memory``, the object-store
    code path, comes with the worker slice. ``local_base_dir``
    overrides the local backend's directory."""
    from ..config import CONFIG
    name = (backend or CONFIG.spool_backend or "local").lower()
    if name in ("local", "filesystem", ""):
        if local_base_dir is not None:
            kwargs.setdefault("base_dir", local_base_dir)
        return LocalDirSpool(**kwargs)
    if name in ("memory", "objectstore"):
        raise ValueError("not yet ported: the object-store spool "
                         f"backend '{backend}'")
    raise ValueError(f"unknown spool backend '{backend}' "
                     "(expected 'local' or 'memory')")


def default_spool(backend: Optional[str] = None) -> SpoolManager:
    """Process-wide spool singleton per backend name, for schedulers
    not handed one explicitly. Sharing one instance keeps the
    time-gated TTL sweep (``maybe_cleanup``) at its intended
    once-per-TTL/4 cadence — a fresh spool per query would reset
    ``_last_sweep`` and pay a full scan on every dispatch — and, for
    the in-memory object store, keeps every query in the SAME store.
    Config is read once, at first use."""
    from ..config import CONFIG
    name = (backend or CONFIG.spool_backend or "local").lower()
    with _DEFAULT_LOCK:
        spool = _DEFAULTS.get(name)
        if spool is None:
            spool = _DEFAULTS[name] = make_spool(name)
        return spool


class LocalDirSpool(SpoolManager):
    """Local-directory spool backend (single-host durable storage)."""

    def __init__(self, base_dir: Optional[str] = None,
                 ttl_s: Optional[float] = None):
        from ..config import CONFIG
        self.base = base_dir or CONFIG.spool_dir
        # TTL floor: commits touch the query dir's mtime, so 60s is
        # enough to keep any live query ahead of the sweep; a smaller
        # knob value could reap in-flight output
        self.ttl_s = max(float(CONFIG.spool_ttl_s if ttl_s is None
                               else ttl_s), 60.0)
        self._last_sweep = 0.0
        # released queries must stay dead: a late speculative/retry
        # loser completing after release() would otherwise re-create
        # the query dir and leak its frames until the TTL sweep
        self._released: set = set()
        os.makedirs(self.base, exist_ok=True)
        try:
            os.chmod(self.base, 0o700)   # results transit this dir
        except OSError:
            pass

    # -- layout --------------------------------------------------------
    def _task_dir(self, query_id: str, fragment_id: int,
                  part: int) -> str:
        return os.path.join(self.base, str(query_id),
                            f"f{fragment_id}.p{part}")

    # -- SpoolManager --------------------------------------------------
    def commit(self, query_id: str, fragment_id: int, part: int,
               attempt: int, frames: List[bytes]) -> int:
        if self._is_released(query_id):
            return attempt   # query already finished: drop, do not
            #                  resurrect the released dir
        tdir = self._task_dir(query_id, fragment_id, part)
        adir = os.path.join(tdir, f"a{attempt}")
        tmp = f"{adir}.tmp{os.getpid()}.{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        for i, frame in enumerate(frames):
            with open(os.path.join(tmp, f"page_{i:05d}.bin"),
                      "wb") as f:
                f.write(frame)
        return self._seal_attempt(query_id, fragment_id, part, attempt,
                                  tmp, sum(len(f) for f in frames))

    def _seal_attempt(self, query_id: str, fragment_id: int, part: int,
                      attempt: int, tmp: str, written_bytes: int) -> int:
        """Atomically publish a fully written attempt temp dir and race
        for the COMMITTED marker (first-commit-wins)."""
        tdir = self._task_dir(query_id, fragment_id, part)
        adir = os.path.join(tdir, f"a{attempt}")
        try:
            os.rename(tmp, adir)
        except OSError:
            # the same attempt id committed twice (a client retry of an
            # already-committed attempt): keep the first copy
            shutil.rmtree(tmp, ignore_errors=True)
        # keep the TTL sweep away from live queries: every commit
        # refreshes the query dir's mtime
        try:
            os.utime(os.path.join(self.base, str(query_id)))
        except OSError:
            pass
        # the marker is hard-linked from a fully written temp file, so
        # claiming (O_EXCL semantics of link) and content are one
        # atomic step — a crash can never leave an empty marker
        fault_point("spool.pre_marker")
        marker = os.path.join(tdir, "COMMITTED")
        tmpm = f"{marker}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmpm, "w") as f:
            f.write(str(attempt))
        try:
            for _ in range(2):
                try:
                    os.link(tmpm, marker)
                    _M_SPOOL_WRITTEN.inc(written_bytes)
                    return attempt
                except FileExistsError:
                    winner = self.committed_attempt(
                        query_id, fragment_id, part)
                    if winner is not None:
                        if winner != attempt:
                            _M_SPOOL_DUPES.inc()
                            shutil.rmtree(adir, ignore_errors=True)
                        return winner
                    # unreadable marker (legacy/corrupt): usurp it and
                    # retry the claim once — and never delete our own
                    # frames while the winner is unknown
                    try:
                        os.unlink(marker)
                    except OSError:
                        pass
            return attempt   # still contested: keep frames, claim self
        finally:
            try:
                os.unlink(tmpm)
            except OSError:
                pass

    def committed_attempt(self, query_id: str, fragment_id: int,
                          part: int) -> Optional[int]:
        marker = os.path.join(
            self._task_dir(query_id, fragment_id, part), "COMMITTED")
        try:
            with open(marker) as f:
                return int(f.read())
        except (OSError, ValueError):
            return None

    def read(self, query_id: str, fragment_id: int,
             part: int) -> Optional[List[bytes]]:
        attempt = self.committed_attempt(query_id, fragment_id, part)
        if attempt is None:
            return None
        adir = os.path.join(
            self._task_dir(query_id, fragment_id, part), f"a{attempt}")
        frames: List[bytes] = []
        try:
            for name in sorted(os.listdir(adir)):
                with open(os.path.join(adir, name), "rb") as f:
                    frames.append(f.read())
        except OSError:
            return None
        _M_SPOOL_READ.inc(sum(len(f) for f in frames))
        return frames

    def frame_count(self, query_id: str, fragment_id: int,
                    part: int) -> Optional[int]:
        """Number of committed frames, or None if nothing committed —
        lets a token-at-a-time server answer ``complete`` without
        reading frame payloads."""
        attempt = self.committed_attempt(query_id, fragment_id, part)
        if attempt is None:
            return None
        adir = os.path.join(
            self._task_dir(query_id, fragment_id, part), f"a{attempt}")
        try:
            return len(os.listdir(adir))
        except OSError:
            return None

    def read_frame(self, query_id: str, fragment_id: int, part: int,
                   index: int) -> Optional[bytes]:
        """One committed frame by index (the page-token protocol's
        unit): serving an N-frame pull frame-by-frame must cost O(N)
        disk reads total, not O(N^2) via ``read``, and must count each
        byte once in the spool-read metric."""
        attempt = self.committed_attempt(query_id, fragment_id, part)
        if attempt is None:
            return None
        path = os.path.join(
            self._task_dir(query_id, fragment_id, part),
            f"a{attempt}", f"page_{index:05d}.bin")
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        _M_SPOOL_READ.inc(len(data))
        return data

    def release(self, query_id: str) -> None:
        self._mark_released(query_id)
        shutil.rmtree(os.path.join(self.base, str(query_id)),
                      ignore_errors=True)

    def release_fragment(self, query_id: str, fragment_id: int) -> None:
        qdir = os.path.join(self.base, str(query_id))
        try:
            entries = os.listdir(qdir)
        except OSError:
            return
        prefix = f"f{fragment_id}.p"
        for name in entries:
            if name.startswith(prefix):
                shutil.rmtree(os.path.join(qdir, name),
                              ignore_errors=True)

    def cleanup(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        removed = 0
        try:
            entries = os.listdir(self.base)
        except OSError:
            return 0
        for name in entries:
            path = os.path.join(self.base, name)
            try:
                if os.path.isdir(path) \
                        and os.path.getmtime(path) < now - self.ttl_s:
                    shutil.rmtree(path, ignore_errors=True)
                    removed += 1
            except OSError:
                continue
        return removed
