"""Worker-to-worker partitioned exchange: the consuming half.

Counterpart of ``trino_tpu/stage/exchange.py`` (host code); the frames
are read onto the reader's device.

Reference parity: operator/ExchangeOperator + ExchangeClient pulling a
RemoteSourceNode's pages from upstream tasks' output buffers. Here the
shuffle medium is the content-addressed FTE spool (fte/spool.py): a
stage task's attempt commits exactly one frame per output partition
under the attempt-independent exchange key ``<qid>.s<sid>.p<part>``,
so a consumer addresses partition ``p`` of upstream task ``t`` as
frame ``p`` of that key's COMMITTED attempt — no manifest, and task
retries/speculation dedupe through the spool's first-commit-wins
marker exactly like any other attempt.

Exchange kinds (the producing stage's PartitionedOutputNode.kind,
recorded per source by the stage scheduler):

- ``hash``: a consumer task reads frame index == its OWN partition of
  every upstream task (co-partitioned exchange);
- ``gather``: a single consumer task reads the single frame 0;
- ``replicate``: EVERY consumer task reads frame 0 of every upstream
  task — the REPLICATE exchange (broadcast build sides, semi-join
  filtering sources: each task sees the WHOLE relation, which is what
  makes NULL-IN semantics and cross joins partition-safe).

Pull order per upstream task:
  1. the local spool (``read_frame``) — on a shared spool base
     (same-host worker fleet, or the object-store backend) this is the
     whole exchange: a consumer never touches the network, and a DEAD
     producer's committed output is still readable (what makes
     mid-DAG task retry recovery work);
  2. HTTP ``GET /v1/partition/{key}/{index}`` on the worker the
     scheduler observed winning the task (server/task_worker.py) —
     the cross-host leg when spools are not shared. Under eager
     pipelining the winner is not known at consumer-dispatch time, so
     the scheduler also ships a ``candidates`` list (every live
     worker) and the puller sweeps it.

Eager pipelining (``eager`` in the source record): a partition that
resolves nowhere is NOT an instant failure — the producer stage may
simply still be running, so the puller BLOCKS, re-polling spool+HTTP
until the frame commits, bounded by ``timeout_s``/``cancel``. The
spool's first-commit-wins markers make these partial reads safe: only
committed attempts are ever visible. In barrier mode (no ``eager``
flag) an unresolvable partition raises immediately — the consuming
ATTEMPT fails and the stage scheduler's retry machinery takes over.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..obs.metrics import (EXCHANGE_PARTITION_BYTES,
                           EXCHANGE_PARTITIONS, REPLICATE_CACHE)


def exchange_task_key(query_id: str, sid: int, part: int) -> str:
    """Attempt-independent spool address of one stage task's output
    (every attempt of the task commits under this key; the COMMITTED
    marker arbitrates)."""
    return f"{query_id}.s{sid}.p{part}"


# --------------------------------------------------------------------------
# per-worker fetch-once cache for replicate exchange edges: EVERY
# consumer task of a replicated (broadcast) stage output reads the
# SAME frame 0 of every upstream task, so without a cache a worker
# running N consumer tasks pulls (and a remote producer serves) the
# identical frame N times — on the HTTP path that is N network round
# trips per edge. Keyed by the attempt-
# independent exchange key + frame index: first-commit-wins makes the
# bytes under a key immutable once committed, so a cached frame can
# never go stale. LRU by bytes (CONFIG.replicate_cache_bytes); also
# shed under memory pressure (exec/executor.py evict_cache_pressure).
# --------------------------------------------------------------------------

_REPL_LOCK = threading.Lock()
_REPL_CACHE: "OrderedDict[Tuple[str, int], bytes]" = OrderedDict()
_REPL_BYTES = [0]           # box: mutated under _REPL_LOCK only
# (key, index) -> the pull in progress; what makes the cache fetch-once
# when sibling consumer tasks start together
_REPL_INFLIGHT: "Dict[Tuple[str, int], _InFlight]" = {}


class _InFlight:
    """One replicate pull in progress: the leader sets ``frame`` (or
    leaves it None when its pull failed) and then ``done``."""
    __slots__ = ("done", "frame")

    def __init__(self):
        self.done = threading.Event()
        self.frame: Optional[bytes] = None


def _replicate_fetch(key: str, index: int, pull, cancel=None) -> bytes:
    """Single-flight fetch-once read of a replicate frame: a cached
    frame is a hit; the first reader that misses registers an in-flight
    entry and pulls, and concurrent readers of the same ``(key,
    index)`` wait for it and take its bytes (also a hit). A failed pull
    caches nothing: its waiters wake and pull for themselves."""
    k = (key, index)
    with _REPL_LOCK:
        frame = _REPL_CACHE.get(k)
        if frame is not None:
            _REPL_CACHE.move_to_end(k)
            flight, leader = None, False
        else:
            flight = _REPL_INFLIGHT.get(k)
            leader = flight is None
            if leader:
                flight = _REPL_INFLIGHT[k] = _InFlight()
    if frame is not None:
        REPLICATE_CACHE.inc(result="hit")
        return frame
    if not leader:
        while not flight.done.wait(0.05):
            if cancel is not None and cancel.is_set():
                raise RuntimeError(f"exchange pull of {key} canceled")
        if flight.frame is not None:
            REPLICATE_CACHE.inc(result="hit")
            return flight.frame
        REPLICATE_CACHE.inc(result="miss")
        frame = pull()
        _replicate_cache_put(key, index, frame)
        return frame
    REPLICATE_CACHE.inc(result="miss")
    try:
        frame = pull()
        _replicate_cache_put(key, index, frame)
        flight.frame = frame
    finally:
        with _REPL_LOCK:
            _REPL_INFLIGHT.pop(k, None)
        flight.done.set()
    return frame


def _replicate_cache_put(key: str, index: int, frame: bytes) -> None:
    from ..config import CONFIG
    limit = int(CONFIG.replicate_cache_bytes or 0)
    if limit <= 0 or len(frame) > limit:
        return                  # disabled, or the frame alone busts it
    with _REPL_LOCK:
        if (key, index) in _REPL_CACHE:
            return              # a concurrent consumer won the fill
        while _REPL_BYTES[0] + len(frame) > limit and _REPL_CACHE:
            _, old = _REPL_CACHE.popitem(last=False)
            _REPL_BYTES[0] -= len(old)
        _REPL_CACHE[(key, index)] = frame
        _REPL_BYTES[0] += len(frame)


def evict_replicate_cache(need_bytes: Optional[int] = None) -> int:
    """Shed fetch-once cache bytes oldest-first (memory-pressure
    governance hook; ``None`` clears everything). Returns bytes
    freed."""
    freed = 0
    with _REPL_LOCK:
        while _REPL_CACHE and (need_bytes is None
                               or freed < int(need_bytes)):
            _, old = _REPL_CACHE.popitem(last=False)
            _REPL_BYTES[0] -= len(old)
            freed += len(old)
    if freed:
        from ..obs.metrics import CACHE_PRESSURE_EVICTS
        CACHE_PRESSURE_EVICTS.inc(cache="replicate")
    return freed


def replicate_cache_bytes() -> int:
    with _REPL_LOCK:
        return _REPL_BYTES[0]


class ExchangePuller:
    """Reads this task's partition of every upstream stage task.

    ``sources`` maps stage id (as str or int — JSON stringifies dict
    keys on the wire) to ``{"tasks": [exchange keys...],
    "uris": [winning worker base uris...], "kind": "hash|gather|
    replicate", "candidates": [worker base uris...], "eager": bool}``
    as recorded by the stage scheduler. ``spool`` is the caller's
    local spool (the worker's own, or a worker-shaped spool on the
    coordinator) and may be None.
    """

    def __init__(self, sources: Dict, part: int, spool=None,
                 timeout_s: float = 600.0, cancel=None, device=None):
        from ..config import resolve_device
        self.sources = {str(k): v for k, v in (sources or {}).items()}
        self.device = resolve_device(device)
        self.part = int(part)
        self.spool = spool
        self.timeout_s = float(timeout_s)
        self.cancel = cancel

    # -- one partition frame ------------------------------------------
    def _try_once(self, key: str, index: int, uris: List[str],
                  errors: List[str], req_timeout: float
                  ) -> Optional[bytes]:
        if self.spool is not None:
            try:
                frame = self.spool.read_frame(key, 0, 0, index)
            except Exception as e:      # noqa: BLE001 — fall to HTTP
                frame = None
                errors.append(f"spool: {type(e).__name__}: {e}")
            if frame is not None:
                return frame
        from ..serde import frame_valid
        for uri in uris:
            if not uri:
                continue
            try:
                with urllib.request.urlopen(
                        f"{uri.rstrip('/')}/v1/partition/{key}/{index}",
                        timeout=req_timeout) as r:
                    frame = r.read()
                # the candidate sweep may hit a wedged/foreign endpoint
                # that 200s arbitrary bytes: only a structurally valid
                # frame (magic + checksum) is an answer
                if frame_valid(frame):
                    return frame
                errors.append(f"{uri}: invalid frame body")
            except Exception as e:      # noqa: BLE001
                errors.append(f"{uri}: {type(e).__name__}: {e}")
        return None

    def pull_frame(self, key: str, uri: Optional[str],
                   index: Optional[int] = None,
                   candidates: Optional[List[str]] = None,
                   eager: bool = False) -> bytes:
        """One partition frame of one upstream task. ``index`` defaults
        to this consumer's own partition (the hash-exchange contract);
        gather/replicate pulls pass 0. ``eager`` blocks until the frame
        commits (pipelined mode) instead of failing the attempt."""
        idx = self.part if index is None else int(index)
        uris = [uri] + [c for c in (candidates or ()) if c != uri]
        deadline = time.monotonic() + self.timeout_s
        # start near-spin: sub-second stages commit in milliseconds,
        # and a 20ms first sleep would hand the whole pipelining win
        # back as added per-edge latency; back off geometrically for
        # genuinely long producers
        delay = 0.002
        # eager sweeps probe with a SHORT per-request timeout: the loop
        # re-polls anyway, and a half-dead candidate (zombie listening
        # socket of a killed worker) must cost seconds per pass, not
        # the whole attempt budget
        req_timeout = (2.0 if eager
                       else max(1.0, min(self.timeout_s, 60.0)))
        while True:
            if self.cancel is not None and self.cancel.is_set():
                raise RuntimeError(f"exchange pull of {key} canceled")
            errors: List[str] = []
            frame = self._try_once(key, idx, uris, errors, req_timeout)
            if frame is not None:
                return frame
            if not eager or time.monotonic() > deadline:
                raise RuntimeError(
                    f"exchange partition {idx} of {key} unavailable"
                    + (f" ({'; '.join(errors[-3:])})" if errors else ""))
            # the producer task may still be running: wait for its
            # commit (the whole point of eager pipelining — consumers
            # start before producers finish)
            time.sleep(delay)
            delay = min(delay * 1.6, 0.1)

    # -- the Executor hook (exec/executor.py _exec_RemoteSourceNode) --
    def read_fragment(self, fid: int) -> List:
        """Deserialized batches on the reader's device, in task order:
        this task's slice of upstream stage ``fid`` — its own partition
        of every task (hash), or the whole output (gather/replicate)."""
        from ..serde import deserialize_batch
        src = self.sources.get(str(fid))
        if src is None:
            raise RuntimeError(
                f"no exchange source recorded for stage {fid}")
        tasks = list(src.get("tasks") or ())
        uris = list(src.get("uris") or ())
        uris += [None] * (len(tasks) - len(uris))
        kind = str(src.get("kind") or "hash")
        candidates = list(src.get("candidates") or ())
        eager = bool(src.get("eager"))
        index = 0 if kind in ("gather", "replicate") else None
        out, nbytes = [], 0
        for key, uri in zip(tasks, uris):
            def pull(key=key, uri=uri):
                return self.pull_frame(key, uri, index=index,
                                       candidates=candidates,
                                       eager=eager)
            if kind == "replicate":
                # fetch-once: sibling consumer tasks on this worker
                # share one pull of the identical broadcast frame
                frame = _replicate_fetch(key, 0, pull, self.cancel)
            else:
                frame = pull()
            nbytes += len(frame)
            out.append(deserialize_batch(frame, self.device))
        EXCHANGE_PARTITIONS.inc(len(out), direction="read")
        EXCHANGE_PARTITION_BYTES.inc(nbytes, direction="read")
        return out
