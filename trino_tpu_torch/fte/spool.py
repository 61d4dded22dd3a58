"""Spooling exchange manager: durable fragment output.

Counterpart of ``trino_tpu/fte/spool.py`` (host only).

Reference parity: trino-exchange-filesystem's FileSystemExchange — a
completed task attempt writes its output pages to durable storage under
an (exchange, partition, attempt) key; consumers read committed output
only, and a duplicate attempt (task retry or speculative re-dispatch)
is deduplicated at commit time, not at read time.

Here the spool is a local directory tree (pluggable via the
``SpoolManager`` interface; an object-store backend slots in by
implementing the same five methods), addressed by
``query/fragment.part/attempt``:

    <base>/<query_id>/f<fid>.p<part>/a<attempt>/page_00000.bin
    <base>/<query_id>/f<fid>.p<part>/COMMITTED      <- winning attempt

Commit protocol (idempotent, first-commit-wins): frames land in a
temp dir, the dir is atomically renamed to ``a<attempt>``, then the
``COMMITTED`` marker is created with O_EXCL. Exactly one attempt wins
the marker; a loser deletes its own frames and reports the winner, so
a late duplicate is discarded rather than double-counted. TTL cleanup
reaps whole query dirs whose mtime is older than ``ttl_s`` (crashed
coordinators leave spools behind; the next query sweeps them).

The same addressing doubles as the SHUFFLE layer for multi-stage MPP
(stage/ — Trino's spooled exchange is the same object): a
stage task commits its hash-partitioned output under the
attempt-independent exchange key ``<qid>.s<sid>.p<part>`` with frame
index == partition index, consumers read single partitions through
``read_frame``, and first-commit-wins gives per-stage task retries and
speculation their dedup for free.
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
_M_SPOOL_COALESCED = METRICS.counter(
    "trino_tpu_spool_coalesced_commits_total",
    "Spool commits satisfied by hard-linking the worker's already-"
    "spooled frames (single-host double-write coalescing)")


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
        under a lock — dispatch threads of concurrent queries all call
        this, and an unsynchronized gate let two threads win the same
        window and run two full-directory sweeps (the same
        shared-state-race class analysis/lint.py flags; this one sits
        across a module boundary, outside the lint's module-local
        reachability, hence fixed by hand)."""
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
        # under a lock: release() is called from coordinator request
        # threads and dispatch threads concurrently, and the lazy
        # check-then-set could otherwise lose a tombstone to a racing
        # first release (the cross-module race class
        # analysis/lint.py's scheduler-thread -> spool edges exist to
        # catch; this one was fixed alongside teaching it those edges)
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
    """Backend factory (config/session-selected; the ExchangeManager
    plugin-loading analog): ``local`` (default) is the directory-tree
    spool; ``memory`` is the object-store code path over the in-memory
    emulation — the single-process stand-in for an S3/GCS bucket (a
    real bucket client slots in by implementing the ObjectStore
    surface). ``local_base_dir`` overrides the local backend's
    directory and is ignored by directory-less backends, so callers
    with a role-scoped dir (the worker's ``-worker`` suffix) need not
    duplicate the backend-alias resolution."""
    from ..config import CONFIG
    name = (backend or CONFIG.spool_backend or "local").lower()
    if name in ("local", "filesystem", ""):
        if local_base_dir is not None:
            kwargs.setdefault("base_dir", local_base_dir)
        return LocalDirSpool(**kwargs)
    if name in ("memory", "objectstore"):
        from .objectstore import InMemoryObjectStore, ObjectStoreSpool
        return ObjectStoreSpool(InMemoryObjectStore(), **kwargs)
    raise ValueError(f"unknown spool backend '{backend}' "
                     "(expected 'local' or 'memory')")


def worker_spool_base() -> str:
    """Default base directory of a WORKER's task spool — kept separate
    from the coordinator's query-keyed spool so neither side's TTL
    sweep can reap the other's live entries. One definition: the
    worker binds it (server/task_worker.py) and the coordinator's
    spool-first root gather reads through it (exec/remote.py) — a
    drifted copy would silently degrade every gather to the HTTP
    fallback."""
    from ..config import CONFIG
    return CONFIG.spool_dir + "-worker"


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

    def commit_linked(self, query_id: str, fragment_id: int, part: int,
                      attempt: int, src_dir: str,
                      expect_frames: Optional[List[bytes]] = None) -> int:
        """Commit by HARD-LINKING an already-spooled attempt directory
        (the worker's task spool on the same host) instead of rewriting
        the frame bytes — the single-host double-write coalescing of
        the worker/coordinator spool pair. Hard links (not symlinks):
        the worker's TTL sweep reaping its own dir only unlinks names,
        the shared inodes survive under our layout. Falls back to a
        byte copy on cross-device links.

        ``expect_frames`` verifies the linked bytes: ``src_dir`` comes
        from a worker-supplied header (X-TT-Spool-Dir), and with a
        spool active the gather reads frames OFF the spool — so the
        linked files, not the pulled pages, become the authoritative
        combine input. Verification happens AFTER linking (so a
        rename-swap between check and link is impossible); a mismatch
        raises ``ValueError`` and nothing is published, letting the
        caller fall back to the byte commit of the pages it actually
        pulled. What this guards against is linking FOREIGN files —
        a stale or hostile path whose contents differ from the pulled
        pages. It deliberately does not defend against the worker
        later rewriting its own frames through the shared inode: the
        worker authored those bytes and could as easily have served
        the altered version as pages, so that is no new capability —
        a worker you cannot trust with its own output needs the
        object-store backend, not link coalescing. Reading back bytes
        the worker just wrote (page-cache hot) still beats re-writing
        them."""
        if self._is_released(query_id):
            return attempt
        tdir = self._task_dir(query_id, fragment_id, part)
        adir = os.path.join(tdir, f"a{attempt}")
        tmp = f"{adir}.tmp{os.getpid()}.{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        try:
            names = sorted(os.listdir(src_dir))
            if expect_frames is not None \
                    and len(names) != len(expect_frames):
                raise ValueError(
                    f"coalescing source {src_dir} has {len(names)} "
                    f"frames, pulled {len(expect_frames)}")
            copied_bytes = 0
            for name in names:
                src = os.path.join(src_dir, name)
                dst = os.path.join(tmp, name)
                try:
                    os.link(src, dst)
                except OSError:
                    # cross-device (EXDEV etc): physically re-written
                    # bytes must show in the written counter — and the
                    # commit must NOT be reported as coalesced
                    shutil.copyfile(src, dst)
                    copied_bytes += os.path.getsize(dst)
            if expect_frames is not None:
                for name, frame in zip(names, expect_frames):
                    with open(os.path.join(tmp, name), "rb") as f:
                        if f.read() != frame:
                            raise ValueError(
                                f"coalescing source {src_dir}/{name} "
                                "does not match the pulled frame")
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        won = self._seal_attempt(query_id, fragment_id, part, attempt,
                                 tmp, written_bytes=copied_bytes)
        if won == attempt and copied_bytes == 0:
            # counted only when this attempt actually owns the marker
            # AND every frame was truly linked: a coalesced loser is a
            # discarded duplicate, and a cross-device copy fallback is
            # a real double write, not a coalesced commit
            _M_SPOOL_COALESCED.inc()
        return won

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

    def attempt_dir(self, query_id: str, fragment_id: int,
                    part: int) -> Optional[str]:
        """Absolute directory of the COMMITTED attempt's frames, or
        None — the handle a same-host consumer needs to coalesce its
        own commit into hard links (``commit_linked``)."""
        attempt = self.committed_attempt(query_id, fragment_id, part)
        if attempt is None:
            return None
        return os.path.join(self._task_dir(query_id, fragment_id, part),
                            f"a{attempt}")

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
