"""Topological stage scheduler: SqlQueryScheduler for the stage DAG.

Counterpart of ``trino_tpu/stage/scheduler.py`` (host code).

Reference parity: SqlQueryScheduler driving one SqlStageExecution per
fragment — each stage's tasks dispatch once every input stage's output
is committed, and the coordinator participates only as the root
stage's consumer. Fault tolerance rides the same per-attempt machinery
as the flat path (fte/retry.py budgets + backoff + worker rotation,
fte/speculate.py straggler duplicates): every attempt of a stage task
commits its partition frames to the WORKER's spool under the
attempt-independent exchange key, so the spool's first-commit-wins
marker arbitrates duplicate attempts per-stage for free, and a task
retried after its worker died re-pulls its upstream partitions off the
spool (stage/exchange.py).

Two scheduling modes (``stage_pipelining`` session property):

- **eager pipelining** (default): every stage's tasks dispatch
  IMMEDIATELY, in topological order but without barriers. A consumer
  task's exchange puller blocks per upstream partition until the
  producing task COMMITS it (stage/exchange.py eager mode) — the
  spool's first-commit-wins frames make these partial reads safe, so
  a consumer starts joining/aggregating the moment its first upstream
  task lands while sibling producers are still running. Source
  records publish up front with winner URIs filled in as tasks
  complete; a ``candidates`` list (every live worker) covers the
  cross-host pull before a winner is known.
- **per-stage barrier** (``stage_pipelining=false``): the pre-PR-13
  behavior — a stage dispatches only after every input stage fully
  committed. Kept as the conservative mode and the bench A/B baseline.

The pipelining overlap (share of exchange wall time where >= 2 stages
had tasks in flight) is recorded per query in
``trino_tpu_mpp_pipeline_overlap_ratio``.

A permanently failed task aborts the whole DAG run: the execution-wide
``abort`` event cancels sibling stages' in-flight waits (without
blaming their workers) so a pipelined consumer never spins out its
full timeout against a producer that can no longer commit.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ..exec.executor import NodeStats
from ..fte.retry import (TASK_RETRIES, RetryController, RetryPolicy,
                         backoff_delay, pick_worker)
from ..fte.speculate import (SPECULATIVE_TASKS, SPECULATIVE_WINS,
                             StragglerDetector)
from ..fte.faultpoints import fault_point
from ..obs.metrics import (FAILOVER_PARTITIONS, MPP_OVERLAP_RATIO,
                           STAGES_SCHEDULED)
from ..plan.nodes import PlanNode, TableScanNode
from .exchange import exchange_task_key
from .fragmenter import Stage, StageDAG


class _Watch:
    """``is_set()`` ORs several events — aborts a status poll the
    moment a sibling attempt wins, the DAG run fails elsewhere, or the
    user cancels."""

    __slots__ = ("_events",)

    def __init__(self, *events):
        self._events = [e for e in events if e is not None]

    def is_set(self) -> bool:
        return any(e.is_set() for e in self._events)


def _plan_has_scan(plan: PlanNode) -> bool:
    """True when a stage body reads table splits (its fan-out follows
    the leaf policy even when it also consumes exchange inputs — the
    colocated scan+join shape)."""
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, TableScanNode):
            return True
        stack.extend(n.sources)
    return False


class _STask:
    """One (stage, partition) task's dispatch state across attempts."""

    __slots__ = ("sid", "part", "key", "done", "spec_done", "lock",
                 "failed", "errors", "winner", "_attempts",
                 "running_since", "running_worker", "speculated")

    def __init__(self, sid: int, part: int, key: str):
        self.sid = sid
        self.part = part
        self.key = key
        self.done = threading.Event()
        self.spec_done = threading.Event()
        self.lock = threading.Lock()
        self.failed = False
        self.errors: List[str] = []
        # (attempt, worker index, speculative) of the first completion
        self.winner: Optional[Tuple[int, int, bool]] = None
        self._attempts = 0
        self.running_since: Optional[float] = None
        self.running_worker: Optional[int] = None
        self.speculated = False

    def next_attempt(self) -> int:
        with self.lock:
            attempt = self._attempts
            self._attempts += 1
            return attempt


class _StageRun:
    """One launched stage's in-flight state (tasks + telemetry sinks),
    handed from ``_launch_stage`` to ``_await_stage``."""

    __slots__ = ("stage", "tasks", "worker_stats", "stop_ev")

    def __init__(self, stage: Stage, tasks: List[_STask]):
        self.stage = stage
        self.tasks = tasks
        self.worker_stats: List[List[NodeStats]] = []
        self.stop_ev = threading.Event()


class StageExecution:
    """Runs every worker stage of a DAG for one query; the caller
    (exec/remote.py RemoteScheduler) then executes the root plan on
    the coordinator against ``self.sources``."""

    def __init__(self, scheduler, dag: StageDAG,
                 payloads: Dict[int, dict],
                 qid: Optional[str] = None,
                 ntasks_override: Optional[Dict[int, int]] = None,
                 resume_spool=None):
        self.s = scheduler              # the owning RemoteScheduler
        self.dag = dag
        self.payloads = payloads
        self.qid = qid or uuid.uuid4().hex[:12]
        # failover resume (fte/recovery.py ExecutionManifestStore): the
        # exchange spool's first-commit-wins markers are the durable
        # progress log, so a resuming coordinator marks every already-
        # COMMITTED (stage, part) done WITHOUT dispatching it and
        # replays only the missing partitions. ``resume_spool`` is the
        # spool the workers committed exchange output to;
        # ``ntasks_override`` pins the fan-out recorded in the manifest
        # (the exchange keys embed it — a recomputed fan-out against a
        # different live-worker count would address different keys).
        self.resume_spool = resume_spool
        self._ntasks_override = ntasks_override
        self.resumed_parts = 0          # committed: served off spool
        self.replayed_parts = 0         # missing: re-dispatched
        session = scheduler.session
        self.policy = RetryPolicy.from_session(session)
        self.controller = RetryController(self.policy)
        self.straggler = StragglerDetector(
            multiplier=float(session.get("speculation_multiplier")),
            min_runtime_s=int(
                session.get("speculation_min_runtime_ms")) / 1000.0)
        self.speculation_on = bool(
            session.get("speculation_enabled")) \
            and len(scheduler.workers) > 1
        self.pipelined = bool(session.get("stage_pipelining"))
        # execution-wide abort: set when any stage fails permanently,
        # unblocking sibling stages' waits and eager exchange pulls
        self.abort = threading.Event()
        # sid -> {"tasks": [exchange keys], "uris": [winner uris],
        #         "kind": .., "candidates": [..], "eager": bool} —
        # published up front; task threads fill uris[part] at win time
        self.sources: Dict[int, dict] = {}
        self.ntasks: Dict[int, int] = {}
        self._assign_task_counts()
        # winning-attempt wall windows (sid, t0, t1) for the pipelining
        # overlap rollup; guarded by the scheduler's stats lock
        self._windows: List[Tuple[int, float, float]] = []
        self.overlap_ratio: float = 0.0
        # per-stage telemetry for the EXPLAIN ANALYZE rollup
        # (sid -> MERGED per-node stats across the stage's tasks)
        self.stage_stats: Dict[int, List[NodeStats]] = {}
        self.stage_reported: Dict[int, int] = {}
        self.resources: List[Tuple[int, int]] = []   # (peak, spill)
        # per-stage attribution sums: worker-reported scheduler CPU
        # seconds, summed across the stage's winning tasks (guarded by
        # the scheduler stats lock)
        self.stage_cpu: Dict[int, float] = {}

    # -- task-count assignment ----------------------------------------
    def _assign_task_counts(self) -> None:
        """Fix every stage's task fan-out up front (a stage's OUTPUT
        partition count is its consumer's task count — the bucket-count
        decision the plan deliberately does not carry). Split-reading
        stages (a plain leaf, or a colocated scan+join stage that also
        consumes a replicate input) follow hash_partition_count like
        the flat path; exchange-only stages follow
        exchange_partition_count; a stage fed by a gather exchange runs
        exactly one task (it consumes the single gathered
        partition)."""
        session = self.s.session
        nworkers = len(self.s.workers)
        hpc = int(session.get("hash_partition_count"))
        epc = int(session.get("exchange_partition_count"))
        for st in self.dag.stages:
            if not st.inputs or _plan_has_scan(st.plan):
                n = min(nworkers, hpc) if hpc > 0 else nworkers
            else:
                n = epc if epc > 0 else nworkers
            if st.max_tasks is not None:
                n = min(n, st.max_tasks)
            if any(self.dag.stage(i).output_node.kind == "gather"
                   for i in st.inputs):
                n = 1
            self.ntasks[st.sid] = max(1, n)
        if self._ntasks_override:
            for sid, n in self._ntasks_override.items():
                self.ntasks[int(sid)] = max(1, int(n))

    def _nparts_out(self, stage: Stage) -> int:
        if stage.consumer is None:
            return 1                    # the coordinator's root gather
        return self.ntasks[stage.consumer]

    # -- source records -----------------------------------------------
    def _publish_sources(self) -> None:
        """Pre-publish every stage's exchange record. Task threads fill
        ``uris[part]`` as winners land; under the barrier every uri is
        set before any consumer dispatches, under pipelining the
        ``candidates`` sweep covers the not-yet-known winners."""
        candidates = [c.base_uri for c in self.s.workers]
        for st in self.dag.stages:
            n = self.ntasks[st.sid]
            self.sources[st.sid] = {  # tt-lint: ignore[race-attr-write] published by the driver thread BEFORE any task thread launches; task threads only assign uris slots
                "tasks": [exchange_task_key(self.qid, st.sid, p)
                          for p in range(n)],
                "uris": [None] * n,
                "kind": st.output_node.kind,
                "candidates": candidates,
                "eager": self.pipelined}

    def _snapshot_sources(self, stage: Stage) -> Dict[str, dict]:
        """Per-attempt copy of the input stages' records (the uris
        list mutates as winners land — a submit must ship a stable
        snapshot)."""
        out: Dict[str, dict] = {}
        for i in stage.inputs:
            src = self.sources[i]
            out[str(i)] = {"tasks": list(src["tasks"]),
                           "uris": list(src["uris"]),
                           "kind": src["kind"],
                           "candidates": list(src["candidates"]),
                           "eager": src["eager"]}
        return out

    # -- overlap rollup ------------------------------------------------
    def _compute_overlap(self) -> float:
        """Share of covered wall time where tasks of >= 2 DIFFERENT
        stages ran concurrently — 0 under the barrier, the pipelining
        win when > 0."""
        with self.s._stats_lock:
            windows = list(self._windows)
        if not windows:
            return 0.0
        events: List[Tuple[float, int, int]] = []
        for sid, t0, t1 in windows:
            if t1 > t0:
                events.append((t0, 1, sid))
                events.append((t1, -1, sid))
        if not events:
            return 0.0
        events.sort(key=lambda e: e[0])
        live: Dict[int, int] = {}
        covered = multi = 0.0
        prev = events[0][0]
        for t, delta, sid in events:
            nstages = sum(1 for v in live.values() if v > 0)
            if t > prev and nstages > 0:
                covered += t - prev
                if nstages > 1:
                    multi += t - prev
            live[sid] = live.get(sid, 0) + delta
            prev = t
        return (multi / covered) if covered > 0 else 0.0

    # -- the run -------------------------------------------------------
    def run(self) -> Dict[int, dict]:
        self._publish_sources()
        if self.pipelined:
            self._run_pipelined()
        else:
            for stage in self.dag.stages:
                # deadline propagation: no stage is dispatched past the
                # query's wall-clock budget (the per-attempt waits
                # below are bounded by the same shrinking remainder)
                self.s._check_deadline(f"stage {stage.sid} dispatch")
                self._await_stage(self._launch_stage(stage))
        self.overlap_ratio = self._compute_overlap()  # tt-lint: ignore[race-attr-write] driver-thread-only, written after every stage's tasks completed
        MPP_OVERLAP_RATIO.set(self.overlap_ratio)
        return self.sources

    def _run_pipelined(self) -> None:
        """Eager mode: launch every stage now (topological order, no
        barrier); consumers block inside their exchange pulls until
        upstream partitions commit. Awaiting still walks producers
        first, so per-stage telemetry lands in DAG order; a failure
        aborts the remaining stages' waits."""
        runs: List[_StageRun] = []
        self.s._check_deadline("stage-DAG dispatch")
        for stage in self.dag.stages:
            runs.append(self._launch_stage(stage))
        first_err: Optional[BaseException] = None
        for sr in runs:
            try:
                self._await_stage(sr)
            except BaseException as e:  # noqa: BLE001 — propagate the
                # FIRST failure after unblocking every sibling stage
                self.abort.set()
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def _launch_stage(self, stage: Stage) -> _StageRun:
        s = self.s
        session = s.session
        sid = stage.sid
        ntasks = self.ntasks[sid]
        nout = self._nparts_out(stage)
        STAGES_SCHEDULED.inc()
        tasks = [_STask(sid, part,
                        exchange_task_key(self.qid, sid, part))
                 for part in range(ntasks)]
        sr = _StageRun(stage, tasks)
        trace = getattr(session, "trace", None)
        trace_parent = trace.current() if trace is not None else None
        timeout_s = float(session.get("remote_task_timeout"))

        def alive(wi: int) -> bool:
            det = s.failure_detector
            return det is None or det.is_alive(s.workers[wi].base_uri)

        def run_attempt(st: _STask, attempt: int, wi: int,
                        speculative: bool = False) -> Optional[str]:
            """One attempt of stage task ``st`` on worker ``wi``;
            None on success OR benign loss to a sibling attempt."""
            tid = f"{self.qid}.s{sid}.{st.part}.a{attempt}"
            client = s.workers[wi]
            t0 = time.perf_counter()
            if not speculative:
                with st.lock:
                    st.running_since = t0
                    st.running_worker = wi
            # live memory beats: while the task runs, every status
            # poll folds its current worker-side reservation into the
            # cluster pool (exec/remote.py _live_memory_hook ->
            # server/memory.py reserve_remote), so the low-memory
            # killer judges live worker bytes DURING execution
            beat = s._live_memory_hook(tid)
            on_status = None
            if beat is not None:
                def on_status(stt, _beat=beat):
                    _beat(stt.get("liveMemoryBytes") or 0)
            # distributed tracing: pre-mint this attempt's span id and
            # ship the W3C traceparent so the worker's spans are born
            # with the query's trace id and this id as their parent
            span_id = tp = None
            if trace is not None:
                span_id = trace.new_span_id()
                tp = trace.traceparent(span_id)
            try:
                client.submit_fragment(
                    tid, self.payloads[sid],
                    catalog=session.catalog, schema=session.schema,
                    part=st.part, nparts=ntasks,
                    properties=dict(session.properties),
                    collect_stats=s.collect_stats,
                    attempt=attempt, spool=True,
                    deadline_s=s._remaining_s(),
                    resource_group=getattr(session, "resource_group",
                                           None),
                    group_weight=getattr(session,
                                         "resource_group_weight",
                                         None),
                    stage={"sid": sid, "exchange_key": st.key,
                           "nparts_out": nout,
                           "sources": self._snapshot_sources(stage)},
                    traceparent=tp)
                watch = _Watch(getattr(session, "cancel", None),
                               st.done, self.abort)
                status = client.wait_done(
                    tid, cancel=watch,
                    timeout_s=s._attempt_budget_s(timeout_s),
                    on_status=on_status, traceparent=tp)
                if status.get("state") != "FINISHED":
                    raise RuntimeError(
                        f"task is {status.get('state')}: "
                        f"{status.get('error') or 'no error recorded'}")
            except Exception as e:      # noqa: BLE001
                if not speculative:
                    with st.lock:
                        st.running_since = None
                if st.done.is_set():
                    if not st.failed:
                        return None     # a sibling attempt already won
                    return (f"stage {sid} fragment task {tid}: aborted "
                            "(task already failed)")
                cancel = getattr(session, "cancel", None)
                if cancel is not None and cancel.is_set():
                    return f"stage {sid} fragment task {tid}: canceled"
                if self.abort.is_set():
                    # the DAG already failed elsewhere: this abort is
                    # not evidence against THIS worker — no detector
                    # demerit, no exclusion
                    return (f"stage {sid} fragment task {tid}: aborted "
                            "(query failed in another stage)")
                from ..exec.remote import BUSY_MARK, _busy_decline
                if _busy_decline(e):
                    # retryable BUSY shed (worker 503): rotate to
                    # another worker without a detector demerit or
                    # per-query exclusion — the worker is healthy
                    return (f"{BUSY_MARK} stage {sid} fragment task "
                            f"{tid} on worker {client.base_uri}: "
                            "busy (load shed)")
                if s.failure_detector is not None:
                    s.failure_detector.record_task_failure(
                        client.base_uri, f"{type(e).__name__}: {e}")
                with s._excl_lock:
                    s.excluded.add(wi)
                return (f"stage {sid} fragment task {tid} on worker "
                        f"{client.base_uri}: {type(e).__name__}: {e}")
            finally:
                if beat is not None:
                    beat.release()  # terminal attempt: stop charging
            t1 = time.perf_counter()
            if s.failure_detector is not None:
                s.failure_detector.record_task_success(client.base_uri)
            self.straggler.record(sid, t1 - t0)
            won = False
            with st.lock:
                if st.winner is None:
                    st.winner = (attempt, wi, speculative)
                    won = True
            if not won:
                return None     # duplicate output: the spool's
                #                 first-commit-wins already discarded it
            # publish the winner uri for consumers dispatched from now
            # on (pipelined consumers already in flight sweep the
            # candidates list instead)
            self.sources[sid]["uris"][st.part] = client.base_uri  # tt-lint: ignore[race-attr-write] slot-exclusive: one winner per part, list item assignment is atomic
            # the winner MUST set st.done (finally): a crash in the
            # best-effort telemetry would strand the untimed stage wait
            try:
                # the worker's observed per-operator selectivities /
                # rates ride the status beat into the learned-stats
                # registry (exec/learnedstats.py), origin-deduped
                from ..exec.learnedstats import LEARNED_STATS
                LEARNED_STATS.merge(status.get("learnedStats") or [])
                # and the worker's program shapes into the hot-shape
                # registry (exec/hotshapes.py), origin-deduped alike
                from ..exec.hotshapes import HOT_SHAPES
                HOT_SHAPES.merge(status.get("hotShapes") or [])
                cpu_s = float(status.get("cpuSeconds") or 0.0)
                with s._stats_lock:
                    # morsel-streaming rollup: stage tasks report
                    # their chunk counts + h2d bytes like peak memory
                    s.stream_chunks += int(
                        status.get("streamChunks") or 0)
                    s.stream_h2d_bytes += int(
                        status.get("streamH2dBytes") or 0)
                    s.cpu_seconds += cpu_s
                    self.stage_cpu[sid] = \
                        self.stage_cpu.get(sid, 0.0) + cpu_s
                    self._windows.append((sid, t0, t1))
                if speculative:
                    with s._stats_lock:
                        s.speculative_wins += 1
                    SPECULATIVE_WINS.inc()
                if s.collect_stats:
                    reported = [NodeStats.from_dict(d) for d in
                                status.get("nodeStats") or []]
                    if reported:
                        sr.worker_stats.append(reported)
                    with s._stats_lock:
                        self.resources.append((
                            int(status.get("peakMemoryBytes") or 0),
                            int(status.get("spillBytes") or 0)))
                    if trace is not None:
                        # the pre-minted id is what the worker's spans
                        # already name as parent: id-preserving merge
                        sp = trace.record(
                            f"stage_{sid}_execute", t0, t1,
                            parent=trace_parent, span_id=span_id,
                            worker=wi, task=tid,
                            attempt=attempt, speculative=speculative,
                            cpu_s=round(cpu_s, 6))
                        trace.graft(sp, status.get("spans") or [])
            except Exception:   # noqa: BLE001 — telemetry best-effort
                pass
            finally:
                st.done.set()
            return None

        def run_task(st: _STask) -> None:
            from ..exec.remote import BUSY_MARK, BUSY_RETRY_LIMIT
            failures = 0
            busy_declines = 0
            attempt = st.next_attempt()
            while True:
                if attempt > 0:
                    s._sync_workers()   # live membership: late joiners
                with s._excl_lock:
                    banned = frozenset(s.excluded)
                wi = pick_worker(len(s.workers), st.part, attempt,
                                 banned, alive)
                try:
                    err = run_attempt(st, attempt, wi)
                except Exception as e:  # noqa: BLE001 — an attempt-path
                    # bug must fail the task, not strand the stage wait
                    err = (f"stage {sid} attempt {attempt}: internal: "
                           f"{type(e).__name__}: {e}")
                if err is None:
                    return
                failures += 1
                st.errors.append(err)
                cancel = getattr(session, "cancel", None)
                canceled = (cancel is not None and cancel.is_set()) \
                    or self.abort.is_set()
                rem = s._remaining_s()
                if rem is not None and rem <= 0:
                    canceled = True     # deadline outranks the budget
                if err.startswith(BUSY_MARK) and not canceled:
                    # a BUSY decline never started the dispatch: back
                    # off and rotate without consuming the retry
                    # budget (bounded — a permanently wedged fleet
                    # still fails through the budget machinery)
                    busy_declines += 1
                    if busy_declines <= BUSY_RETRY_LIMIT:
                        delay = backoff_delay(
                            self.policy, failures,
                            f"{self.qid}.s{sid}.{st.part}")
                        if rem is not None:
                            delay = min(delay, max(rem, 0.0))
                        if st.done.wait(delay):
                            return
                        attempt = st.next_attempt()
                        continue
                if canceled or not self.controller.record_failure(
                        (sid, st.part)):
                    # out of attempts — but a healthy speculative
                    # duplicate still in flight decides the task's
                    # fate, not this exhausted primary
                    with st.lock:
                        spec_pending = (st.speculated
                                        and st.winner is None)
                    if spec_pending and not canceled:
                        st.spec_done.wait()
                    with st.lock:
                        if st.winner is None:
                            st.failed = True
                    st.done.set()
                    return
                with s._stats_lock:
                    s.task_retries += 1
                TASK_RETRIES.inc()
                if trace is not None:
                    trace.record(f"stage_{sid}_retry",
                                 time.perf_counter(),
                                 time.perf_counter(),
                                 parent=trace_parent, part=st.part,
                                 worker=wi, attempt=attempt,
                                 error=err[-160:])
                delay = backoff_delay(self.policy, failures,
                                      f"{self.qid}.s{sid}.{st.part}")
                if rem is not None:
                    delay = min(delay, max(rem, 0.0))
                if st.done.wait(delay):
                    return    # a speculative sibling won during backoff
                attempt = st.next_attempt()

        def run_speculative(st: _STask, attempt: int, wi: int) -> None:
            try:
                err = run_attempt(st, attempt, wi, speculative=True)
                if err is not None:
                    st.errors.append("[speculative] " + err)
            except Exception as e:      # noqa: BLE001
                st.errors.append("[speculative] internal: "
                                 f"{type(e).__name__}: {e}")
            finally:
                st.spec_done.set()

        def monitor() -> None:
            while not sr.stop_ev.wait(0.05):
                pending = [st for st in tasks if not st.done.is_set()]
                if not pending:
                    return
                for st in pending:
                    if st.speculated:
                        continue
                    with st.lock:
                        t0 = st.running_since
                        wi_cur = st.running_worker
                        settled = st.winner is not None
                    if settled or t0 is None:
                        continue
                    elapsed = time.perf_counter() - t0
                    if not self.straggler.is_straggler(sid, elapsed):
                        continue
                    rem = s._remaining_s()
                    if rem is not None and rem <= 0:
                        continue     # past the deadline: no new work
                    if not self.controller.grant_speculation(
                            (sid, st.part)):
                        continue
                    st.speculated = True
                    attempt = st.next_attempt()
                    s._sync_workers()
                    with s._excl_lock:
                        banned = frozenset(
                            s.excluded
                            | ({wi_cur} if wi_cur is not None
                               else set()))
                    wi = pick_worker(len(s.workers), st.part, attempt,
                                     banned, alive)
                    if wi == wi_cur:
                        st.spec_done.set()   # nowhere better to run
                        continue
                    with s._stats_lock:
                        s.speculative_launches += 1
                    SPECULATIVE_TASKS.inc()
                    if trace is not None:
                        trace.record(f"stage_{sid}_speculate", t0,
                                     time.perf_counter(),
                                     parent=trace_parent, part=st.part,
                                     attempt=attempt, worker=wi,
                                     straggler_worker=wi_cur)
                    threading.Thread(target=run_speculative,
                                     args=(st, attempt, wi),
                                     daemon=True).start()

        pending = tasks
        if self.resume_spool is not None:
            # failover resume: a COMMITTED exchange key means some
            # earlier attempt's output is durable on the spool —
            # consumers (and the root gather) read it from there, so
            # the task is done without dispatching anything. Only the
            # missing partitions are replayed.
            pending = []
            for st in tasks:
                committed = None
                try:
                    committed = self.resume_spool.committed_attempt(
                        st.key, 0, 0)
                except Exception:   # noqa: BLE001 — treat as missing
                    pass
                if committed is not None:
                    with st.lock:
                        st.winner = (committed, -1, False)
                    st.done.set()
                    self.resumed_parts += 1  # tt-lint: ignore[race-attr-write] driver-thread-only: counted before any task thread launches
                    FAILOVER_PARTITIONS.inc(outcome="resumed")
                else:
                    pending.append(st)
                    self.replayed_parts += 1  # tt-lint: ignore[race-attr-write] driver-thread-only: counted before any task thread launches
                    FAILOVER_PARTITIONS.inc(outcome="replayed")
        for st in pending:
            threading.Thread(target=run_task, args=(st,),
                             daemon=True).start()
        if self.speculation_on:
            threading.Thread(target=monitor, daemon=True).start()
        return sr

    def _await_stage(self, sr: _StageRun) -> None:
        s = self.s
        sid = sr.stage.sid
        try:
            for st in sr.tasks:
                st.done.wait()
        finally:
            sr.stop_ev.set()
        failed = [st for st in sr.tasks if st.failed]
        if failed:
            from ..exec.executor import QueryError
            raise QueryError(
                "remote task failed: " + "; ".join(
                    "; ".join(st.errors[-2:]) for st in failed[:3]))
        # deterministic chaos site: the stage's every partition is now
        # COMMITTED on the spool — the exact boundary where a crashed
        # coordinator leaves a resumable, partially-complete query
        fault_point("coordinator.post_stage_commit")
        if s.collect_stats:
            from ..exec.executor import merge_node_stats
            self.stage_stats[sid] = merge_node_stats(sr.worker_stats)  # tt-lint: ignore[race-attr-write] driver-thread-only, written after the stage's tasks completed
            self.stage_reported[sid] = len(sr.worker_stats)  # tt-lint: ignore[race-attr-write] driver-thread-only, written after the stage's tasks completed
