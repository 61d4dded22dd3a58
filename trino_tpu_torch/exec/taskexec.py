"""Worker-side multi-query task scheduler: the shared split runner pool.

Counterpart of ``trino_tpu/exec/taskexec.py`` (host only, without the
ragged multi-query batcher, which serves the JAX engine's compiled
chain programs; the port has none).

Reference parity: execution/executor/TaskExecutor.java — a fixed pool
of runner threads time-slices ALL concurrent queries' drivers on 1s
quanta through a MultilevelSplitQueue (TaskExecutor.java:79,172-217,
456-484; PrioritizedSplitRunner.java:35), so a worker serving many
queries interleaves them instead of letting the first arrival own the
node. The tensor-runtime execution model (arXiv 2203.01877) maps the
quantum onto chunk-granularity yield points, which this engine already
has: every split read (Executor._read_split) and every streamed chunk
(exec/streamjoin.py run_streamed) is a natural boundary.

Redesigned cooperative: each task keeps its own thread (the worker's
existing model), but only ``runners`` of them EXECUTE at any moment —
the rest wait at split/chunk boundaries for a slot grant. A quantum is
therefore "the work between two checkpoints" (one split or one chunk),
and preemption is a priority comparison at each boundary:

- **multilevel feedback**: priority is keyed on the QUERY's accumulated
  scheduled seconds on this worker. ``LEVEL_THRESHOLDS_S`` bucket
  queries into levels (the reference's 0s/1s/10s/60s/300s ladder);
  a long-running query decays to higher levels and any younger query's
  splits preempt it at the next boundary — short queries finish fast.
- **fair share by resource group**: within a level, groups drain by
  weighted virtual time (stride scheduling: each accounted second
  advances the group's virtual clock by ``elapsed / weight``, and the
  group with the SMALLEST virtual time runs next), so a group with
  scheduling_weight=3 drains ~3x the split quanta of a weight-1 group
  under contention REGARDLESS of how many queries each group runs —
  share follows weight, not query count (the WeightedFairQueue
  analog, applied at the worker instead of only at admission). A
  group re-activating after idling has its virtual clock clamped up
  to the busiest-waiting floor, so banked idle time cannot starve
  everyone else. Within a group, the query with the least scheduled
  time runs first.
- **blocked tasks release their slot**: a pipelined consumer waiting on
  an upstream exchange commit holds no runner slot (``blocked()``), so
  bounded runners can never deadlock a producer behind its consumer.

Thread model: task threads + HTTP status threads touch the shared
queue; ONE lock guards every mutation, and each handle carries its own
grant event so a wakeup never requires broadcast. Grant decisions
happen under the lock; waiting happens outside it.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from ..obs.metrics import (EXCHANGE_WAIT_SECONDS, TASK_QUANTUM_SECONDS,
                           TASK_SCHED_LEVEL_SECONDS, TASK_SCHED_QUANTA,
                           TASK_SCHED_QUEUE_DEPTH, TASK_SCHED_RUNNABLE,
                           TASK_SCHED_YIELDS)

# per-query scheduled-seconds thresholds for the feedback levels
# (reference: MultilevelSplitQueue.LEVEL_THRESHOLD_SECONDS)
LEVEL_THRESHOLDS_S = (1.0, 10.0, 60.0, 300.0)


class TaskCanceledError(Exception):
    """Raised out of a slot wait when the task's cancel event fires —
    the task thread unwinds like any cooperative cancellation instead
    of waiting forever for a grant it can no longer use."""


class TaskHandle:
    """One task's scheduling state. The owning task thread calls
    ``acquire()`` once before executing, ``checkpoint()`` at every
    split/chunk boundary, ``blocked()`` around off-CPU waits, and
    ``close()`` (or the context-manager exit) when done."""

    __slots__ = ("ex", "query_id", "task_id", "group", "weight",
                 "cancel", "seq", "state", "_grant_ev", "_since",
                 "quanta", "cpu_s", "_cpu_since")

    def __init__(self, ex: "TaskExecutor", query_id: str, task_id: str,
                 group: str, weight: float, cancel, seq: int):
        self.ex = ex
        self.query_id = query_id
        self.task_id = task_id
        self.group = group
        self.weight = max(float(weight), 1e-9)
        self.cancel = cancel
        self.seq = seq
        self.state = "new"          # new|waiting|running|blocked|closed
        self._grant_ev = threading.Event()
        self._since: float = 0.0    # clock() at the last grant/account
        self.quanta = 0
        # scheduler CPU attribution: per-thread CPU seconds
        # (time.thread_time) accumulated quantum by quantum — every
        # stamp happens ON the task's own thread (checkpoint / blocked
        # / close run there; grants re-stamp in _wait_grant after the
        # waiting thread wakes), so the delta is exactly this task's
        # thread CPU between checkpoints, per (query, task, split)
        self.cpu_s = 0.0
        self._cpu_since: float = time.thread_time()

    # -- the lifecycle entry points -----------------------------------
    def __enter__(self) -> "TaskHandle":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def acquire(self) -> None:
        """Block until this task is granted a runner slot."""
        ex = self.ex
        with ex._lock:
            if self.state == "closed":
                raise TaskCanceledError(
                    f"task {self.task_id} already closed")
            self._grant_ev.clear()
            self.state = "waiting"
            ex._waiting.append(self)
            ex._dispatch_locked()
        self._wait_grant()

    def checkpoint(self) -> None:
        """A split/chunk finished: account the quantum and, if any
        waiter now outranks this task, hand over the slot and wait for
        the next grant. O(waiters) under one lock — called per split/
        chunk, never per row."""
        ex = self.ex
        yielded = False
        with ex._lock:
            if self.state != "running":
                return              # blocked/closed callers are no-ops
            self._account_locked()
            best = ex._best_waiter_locked()
            if best is not None \
                    and ex._key_locked(best) < ex._key_locked(self):
                # the waiter outranks us: yield the slot (it may also
                # outrank every OTHER waiter, which _dispatch settles)
                self._grant_ev.clear()
                self.state = "waiting"
                ex._running.discard(self)
                ex._waiting.append(self)
                ex._dispatch_locked()
                yielded = True
        if yielded:
            TASK_SCHED_YIELDS.inc()
            self._wait_grant()

    def blocked(self) -> "_BlockedScope":
        """Context manager for off-CPU waits (exchange pulls): the
        slot is released on entry and re-acquired on exit, so bounded
        runners cannot deadlock a producer behind its blocked
        consumer."""
        return _BlockedScope(self)

    def run_blocked(self, fn, *args, **kwargs):
        """Run ``fn`` with the slot released (the exchange-reader
        wrapper: server/task_worker.py wires a consumer task's pulls
        through this)."""
        with self.blocked():
            return fn(*args, **kwargs)

    def close(self) -> None:
        ex = self.ex
        with ex._lock:
            if self.state == "closed":
                return
            if self.state == "running":
                self._account_locked()
                ex._running.discard(self)
            elif self.state == "waiting":
                try:
                    ex._waiting.remove(self)
                except ValueError:
                    pass
            self.state = "closed"
            ex._close_locked(self)
            ex._dispatch_locked()

    # -- internals ----------------------------------------------------
    def _account_locked(self) -> None:
        now = self.ex._clock()
        elapsed = max(now - self._since, 0.0)
        self._since = now
        # CPU stamp on the owning thread (every _account_locked caller
        # runs on the task thread): the quantum's thread-CPU seconds
        cpu_now = time.thread_time()
        cpu = max(cpu_now - self._cpu_since, 0.0)
        self._cpu_since = cpu_now
        self.cpu_s += cpu
        self.ex._charge_locked(self, elapsed, cpu)

    def _wait_grant(self) -> None:
        ex = self.ex
        try:
            while not self._grant_ev.wait(0.05):
                if self.cancel is not None and self.cancel.is_set():
                    with ex._lock:
                        if self.state == "running":
                            return  # granted while we checked cancel
                        try:
                            ex._waiting.remove(self)
                        except ValueError:
                            pass
                        ex._publish_depth_locked()
                        self.state = "closed"
                        ex._close_locked(self)
                    raise TaskCanceledError(
                        f"task {self.task_id} canceled while waiting "
                        "for a runner slot")
        finally:
            # CPU accounting restarts at the grant: time burned off-CPU
            # waiting for the slot must not charge the next quantum
            self._cpu_since = time.thread_time()  # tt-lint: ignore[race-attr-write] owning-task-thread-private: every _cpu_since reader/writer runs on the handle's own thread (thread_time is per-thread by definition)


class _BlockedScope:
    __slots__ = ("h", "_t0", "_released")

    def __init__(self, h: TaskHandle):
        self.h = h
        self._t0: float = 0.0
        self._released = False

    def __enter__(self):
        h, ex = self.h, self.h.ex
        self._t0 = time.perf_counter()
        with ex._lock:
            if h.state == "running":
                h._account_locked()
                h.state = "blocked"
                ex._running.discard(h)
                ex._dispatch_locked()
                self._released = True
        return self

    def __exit__(self, *exc):
        h, ex = self.h, self.h.ex
        if self._released:
            # the exchange-wait observable: how long this consumer sat
            # off-CPU with its runner slot RELEASED waiting for
            # upstream commits (a no-op enter — closed/canceled handle
            # — held no slot and must not skew the histogram)
            EXCHANGE_WAIT_SECONDS.observe(
                max(time.perf_counter() - self._t0, 0.0))
        with ex._lock:
            if h.state != "blocked":
                return              # closed while blocked
            h._grant_ev.clear()
            h.state = "waiting"
            ex._waiting.append(h)
            ex._dispatch_locked()
        h._wait_grant()


class TaskExecutor:
    """The shared runner pool + multilevel fair-share queue for one
    worker process. ``runners`` bounds concurrently EXECUTING tasks;
    registration is unbounded (admission/shedding is the caller's
    concern — server/task_worker.py)."""

    def __init__(self, runners: int, clock=time.perf_counter,
                 ema_tau_s: Optional[float] = None):
        self.runners = max(1, int(runners))
        self._clock = clock
        self._lock = threading.Lock()
        self._running: set = set()
        self._waiting: List[TaskHandle] = []
        # per-query accumulated scheduled seconds + open-handle count
        # (time drops with the query's last handle — qids are unique
        # per dispatch, so the table stays bounded by live queries)
        self._query_time: Dict[str, float] = {}
        self._query_cpu: Dict[str, float] = {}
        self._query_handles: Dict[str, int] = {}
        self._group_time: Dict[str, float] = {}
        # time-decayed EMA of the open-task count (the busy-shed
        # signal, server/task_worker.py _shed_reason): a dispatch
        # burst decays in, sustained overload saturates. tau from
        # config (TRINO_TPU_BUSY_SHED_EMA_S); 0 tracks the spot value.
        if ema_tau_s is None:
            from ..config import CONFIG
            ema_tau_s = CONFIG.busy_shed_ema_s
        self.ema_tau_s = max(float(ema_tau_s), 0.0)
        self._ema = 0.0
        self._ema_t = self._clock()
        # stride scheduling per group: virtual time advances by
        # elapsed/weight; the smallest virtual time drains next, so a
        # group's share follows its WEIGHT, not its query count. The
        # open-handle count drives re-activation clamping (an idle
        # group must not bank virtual time and then starve everyone).
        self._group_vtime: Dict[str, float] = {}
        self._group_handles: Dict[str, int] = {}
        self._open = 0
        self._seq = 0

    # -- registration -------------------------------------------------
    def register(self, query_id: str, task_id: str,
                 group: str = "global", weight: float = 1.0,
                 cancel=None) -> TaskHandle:
        with self._lock:
            self._seq += 1
            h = TaskHandle(self, query_id, task_id, group, weight,
                           cancel, self._seq)
            self._ema_update_locked()   # decay over the quiet window,
            #                             THEN admit the new task
            self._query_handles[query_id] = \
                self._query_handles.get(query_id, 0) + 1
            self._query_time.setdefault(query_id, 0.0)
            self._query_cpu.setdefault(query_id, 0.0)
            if self._group_handles.get(group, 0) == 0:
                # (re-)activation clamp: an idle group's virtual
                # clock catches up to the floor of currently-active
                # groups — fair share is over contention windows, not
                # all history
                active = [v for g, v in self._group_vtime.items()
                          if self._group_handles.get(g, 0) > 0]
                floor = min(active) if active else 0.0
                self._group_vtime[group] = max(
                    self._group_vtime.get(group, 0.0), floor)
            self._group_handles[group] = \
                self._group_handles.get(group, 0) + 1
            self._open += 1
            TASK_SCHED_RUNNABLE.set(self._open)
        return h

    # -- introspection ------------------------------------------------
    def open_tasks(self) -> int:
        with self._lock:
            return self._open

    def scheduled_seconds(self, group: Optional[str] = None) -> float:
        with self._lock:
            if group is None:
                return sum(self._group_time.values())
            return self._group_time.get(group, 0.0)

    def query_seconds(self, query_id: str) -> float:
        with self._lock:
            return self._query_time.get(query_id, 0.0)

    def query_cpu_seconds(self, query_id: str) -> float:
        """Accumulated thread-CPU seconds the scheduler accounted for
        this query's quanta on this worker (the figure task status
        reports back to the coordinator)."""
        with self._lock:
            return self._query_cpu.get(query_id, 0.0)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    def open_tasks_ema(self) -> float:
        """Time-decayed EMA of the open-task count — the smoothed
        busy-shed signal (reads also advance the decay, so a worker
        going quiet recovers without waiting for the next event)."""
        with self._lock:
            self._ema_update_locked()
            return self._ema

    def set_query_seconds(self, query_id: str, seconds: float) -> None:
        """Test hook: pin a query's accumulated scheduled time (drives
        the level/priority logic deterministically)."""
        with self._lock:
            self._query_time[query_id] = float(seconds)

    def set_group_vtime(self, group: str, vtime: float) -> None:
        """Test hook: pin a group's virtual clock (drives the
        weighted fair-share ordering deterministically)."""
        with self._lock:
            self._group_vtime[group] = float(vtime)

    # -- internals (all called under self._lock) ----------------------
    def _ema_update_locked(self) -> None:
        now = self._clock()
        dt = max(now - self._ema_t, 0.0)
        self._ema_t = now
        if self.ema_tau_s <= 0:
            self._ema = float(self._open)
            return
        import math
        alpha = 1.0 - math.exp(-dt / self.ema_tau_s)
        self._ema += alpha * (float(self._open) - self._ema)

    def _publish_depth_locked(self) -> None:
        TASK_SCHED_QUEUE_DEPTH.set(len(self._waiting))

    def _key_locked(self, h: TaskHandle
                    ) -> Tuple[int, float, float, int]:
        qtime = self._query_time.get(h.query_id, 0.0)
        level = bisect_right(LEVEL_THRESHOLDS_S, qtime)
        # level (short queries finish fast) dominates; then the
        # group's weighted virtual time (fair share follows WEIGHT,
        # not query count); then the least-served query; then arrival
        return (level, self._group_vtime.get(h.group, 0.0), qtime,
                h.seq)

    def _best_waiter_locked(self) -> Optional[TaskHandle]:
        if not self._waiting:
            return None
        return min(self._waiting, key=self._key_locked)

    def _dispatch_locked(self) -> None:
        while len(self._running) < self.runners and self._waiting:
            h = min(self._waiting, key=self._key_locked)
            self._waiting.remove(h)
            h.state = "running"
            h._since = self._clock()
            self._running.add(h)
            h._grant_ev.set()
        self._publish_depth_locked()

    def _charge_locked(self, h: TaskHandle, elapsed: float,
                       cpu: float = 0.0) -> None:
        # the level the quantum RAN at (pre-charge accumulated time):
        # the per-level scheduled-seconds counter is the decay ladder's
        # observable face
        level = bisect_right(LEVEL_THRESHOLDS_S,
                             self._query_time.get(h.query_id, 0.0))
        self._query_time[h.query_id] = \
            self._query_time.get(h.query_id, 0.0) + elapsed
        self._query_cpu[h.query_id] = \
            self._query_cpu.get(h.query_id, 0.0) + cpu
        self._group_time[h.group] = \
            self._group_time.get(h.group, 0.0) + elapsed
        self._group_vtime[h.group] = \
            self._group_vtime.get(h.group, 0.0) + elapsed / h.weight
        h.quanta += 1
        TASK_SCHED_QUANTA.inc(group=h.group)
        TASK_QUANTUM_SECONDS.observe(elapsed)
        TASK_SCHED_LEVEL_SECONDS.inc(elapsed, level=str(level))

    def _close_locked(self, h: TaskHandle) -> None:
        self._ema_update_locked()   # decay over the lived window,
        #                             THEN retire the task
        n = self._query_handles.get(h.query_id, 1) - 1
        if n <= 0:
            self._query_handles.pop(h.query_id, None)
            self._query_time.pop(h.query_id, None)
            self._query_cpu.pop(h.query_id, None)
        else:
            self._query_handles[h.query_id] = n
        self._group_handles[h.group] = \
            max(self._group_handles.get(h.group, 1) - 1, 0)
        self._open -= 1
        TASK_SCHED_RUNNABLE.set(self._open)
