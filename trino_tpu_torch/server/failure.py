"""Heartbeat failure detector.

Counterpart of ``trino_tpu/server/failure.py`` (host only).

Reference parity: failuredetector/HeartbeatFailureDetector.java:78,93,
221,318-351 — the coordinator pings every known service on a fixed
cadence and tracks an EXPONENTIALLY DECAYED failure ratio per node;
nodes above ``failure_ratio_threshold`` are reported failed and the
scheduler excludes them (NodeScheduler consulting the detector). Ours
pings the worker's /v1/info (server/task_worker.py exposes it) or any
HTTP URI; a pluggable ``probe`` hook lets tests inject failures."""

from __future__ import annotations

import json
import math
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class _Stats:
    """Per-service decayed failure ratio
    (HeartbeatFailureDetector.Stats)."""
    decay_seconds: float = 30.0
    weight: float = 0.0           # decayed total probes
    failed: float = 0.0           # decayed failures
    last_update: float = field(default_factory=time.time)
    last_failure: Optional[str] = None

    def _decay(self, now: float) -> None:
        dt = max(0.0, now - self.last_update)
        k = math.exp(-dt / self.decay_seconds)
        self.weight *= k
        self.failed *= k
        self.last_update = now

    def record(self, success: bool, error: Optional[str] = None):
        now = time.time()
        self._decay(now)
        self.weight += 1.0
        if not success:
            self.failed += 1.0
            self.last_failure = error

    @property
    def failure_ratio(self) -> float:
        if self.weight <= 0:
            return 0.0
        return self.failed / self.weight


class HeartbeatFailureDetector:
    """Background pinger + failed-node query surface."""

    def __init__(self, interval_s: float = 0.5,
                 failure_ratio_threshold: float = 0.1,
                 warmup_probes: int = 2,
                 probe: Optional[Callable[[str], bool]] = None,
                 timeout_s: float = 2.0):
        self.interval_s = interval_s
        self.threshold = failure_ratio_threshold
        self.warmup = warmup_probes
        self.timeout_s = timeout_s
        self._probe = probe or self._http_probe
        self._stats: Dict[str, _Stats] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _http_probe(self, uri: str) -> bool:
        try:
            with urllib.request.urlopen(uri.rstrip("/") + "/v1/info",
                                        timeout=self.timeout_s) as r:
                json.loads(r.read())
            return True
        except Exception:
            return False

    # --- membership ------------------------------------------------------
    def add_service(self, uri: str) -> None:
        with self._lock:
            self._stats.setdefault(uri, _Stats())

    def remove_service(self, uri: str) -> None:
        with self._lock:
            self._stats.pop(uri, None)

    def services(self) -> List[str]:
        with self._lock:
            return list(self._stats)

    # --- probing ---------------------------------------------------------
    def probe_once(self) -> None:
        for uri in self.services():
            ok = False
            err = None
            try:
                ok = self._probe(uri)
            except Exception as e:
                err = str(e)
            with self._lock:
                st = self._stats.get(uri)
                if st is not None:
                    st.record(ok, err)

    # --- scheduler feedback ----------------------------------------------
    def record_task_failure(self, uri: str,
                            error: Optional[str] = None) -> None:
        """An observed task failure on a node is a failed probe: the
        scheduler (exec/remote.py) reports dispatch/exchange errors here
        so the decayed ratio reflects real work, not just pings — the
        reference's RemoteTask failure feedback into the failure
        detector. Auto-registers unknown services (a worker can fail a
        task before its first heartbeat)."""
        with self._lock:
            self._stats.setdefault(uri, _Stats()).record(False, error)

    def record_task_success(self, uri: str) -> None:
        with self._lock:
            self._stats.setdefault(uri, _Stats()).record(True)

    def start(self) -> "HeartbeatFailureDetector":
        """Start the active probe loop. Idempotent AND thread-safe:
        live-membership joins call this from HTTP handler threads on
        every announcement (the detector may have been created before
        any worker existed) while main.py may call it from the main
        thread — without the lock the check-then-act could spawn two
        probe loops, doubling every node's probe weight with no way
        to stop the orphan."""
        with self._lock:
            return self._start_locked()

    def _start_locked(self) -> "HeartbeatFailureDetector":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.probe_once()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    # --- queries ---------------------------------------------------------
    def is_alive(self, uri: str) -> bool:
        with self._lock:
            st = self._stats.get(uri)
            if st is None or st.weight < self.warmup:
                return True       # unknown/warming-up nodes pass
            # stale evidence ages out: ``_decay`` only runs inside
            # record(), so a node that stops receiving probes
            # (feedback-only detectors have no probe loop) would keep
            # its last ratio forever — a couple of transient task
            # failures would exclude it permanently and, excluded, it
            # never gets the task that could redeem it. After four
            # quiet decay windows the verdict expires and the node
            # earns a fresh chance.
            if time.time() - st.last_update > 4 * st.decay_seconds:
                return True
            return st.failure_ratio <= self.threshold

    def failed(self) -> List[str]:
        return [u for u in self.services() if not self.is_alive(u)]
