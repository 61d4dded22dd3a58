"""Coordinator: the client-facing HTTP control plane of one node.

Counterpart of ``trino_tpu/server/coordinator.py`` (host only), over the
port's ``LocalQueryRunner`` on one device: ``cuda`` unless the caller
passes ``device="cpu"``, and an error without a card. The Trino
statement protocol (POST /v1/statement, ``nextUri`` paging of
``PAGE_ROWS`` rows, DELETE to cancel), /v1/query, /v1/info,
/v1/cluster, /v1/stats, /v1/history, /v1/trace, /metrics, /ui and the
``X-Trino-*`` headers, with basic and JWT authentication
(security.py). Every query runs on a thread of its own, through
admission (server/resourcegroups.py), the cluster memory pool
(server/memory.py), events, the query history and, when enabled, the
result cache.

Workers (``worker_uris``, or workers that join at run time through
/v1/announcement) run the queries' fragments and stages on their own
devices through ``DistributedHostQueryRunner`` (exec/remote.py); the
coordinator scrapes their /metrics, runs the root stage on its device,
and resumes a RUNNING query whose first coordinator died from its
spooled execution manifest (``resume_query``, fte/recovery.py).
``leak_report`` is server/diagnostics.py.

Streaming (streaming/): producers POST /v1/ingest/{topic}, and
/v1/continuous creates, lists, reads and cancels continuous jobs whose
cycles are tracked queries; /v1/trace/{id} serves a finished query's
trace as OTLP/JSON (obs/otlp.py).

Not yet ported (each raises or answers HTTP 501 with that message):
the mesh (``distributed=True``) and /v1/hotshapes.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import urlparse

from ..config import CONFIG, DeviceLike, resolve_device
from ..obs.metrics import METRICS
from ..runner import LocalQueryRunner, QueryResult
from ..session import Session

PAGE_ROWS = 4096     # rows per QueryResults page

# query lifecycle counters (reference: QueryManager JMX stats). One
# increment per state ENTERED, so rates and totals are both readable.
_M_STATES = METRICS.counter(
    "trino_tpu_query_states_total",
    "Query state transitions by state entered", ("state",))
_M_DETAIL_PLAN_ERRORS = METRICS.counter(
    "trino_tpu_query_detail_plan_errors_total",
    "Failures re-deriving a plan for /v1/query/{id} (legacy fallback "
    "path; the plan is normally captured at execution time)")
# one wire encoding for live serving and spooled-result persistence —
# a recovered page must be byte-for-byte what the original coordinator
# would have served (fte/recovery.py owns the definition)
from ..fte.recovery import _M_RESULTS_RECOVERED  # noqa: E402
from ..fte.recovery import json_value as _json_value  # noqa: E402

# live worker membership (the discovery-service join/leave surface)
_M_WORKER_JOINS = METRICS.counter(
    "trino_tpu_worker_joins_total",
    "Workers added to the active set via /v1/announcement")
_M_WORKER_LEAVES = METRICS.counter(
    "trino_tpu_worker_leaves_total",
    "Workers removed from the active set via /v1/announcement")


@dataclass
class _Query:
    """Per-query state machine (execution/QueryStateMachine.java:
    QUEUED -> RUNNING -> FINISHED | FAILED | CANCELED). State
    transitions are lock-protected: the run thread and the cancel path
    race."""
    query_id: str
    slug: str
    sql: str
    session: Session
    state: str = "QUEUED"
    error: Optional[dict] = None
    result: Optional[QueryResult] = None
    created: float = field(default_factory=time.time)
    started: Optional[float] = None   # admission granted (left queue)
    ended: Optional[float] = None     # set at terminal transition
    source: str = ""
    group: Optional[object] = None   # assigned ResourceGroup
    # True when admission actually queued this query (gates the
    # post-hoc "queued" span: an immediately-admitted query's span
    # tree stays parse/plan/optimize/execute)
    admission_queued: bool = False
    # monotonic submit stamp: query_max_run_time budgets the WHOLE
    # run including queued time (the reference's QUERY_MAX_RUN_TIME,
    # as opposed to max_execution_time), so the deadline anchors here
    submit_mono: float = field(default_factory=time.monotonic)
    # the armed deadline timer (set at SUBMIT, not at dequeue: a query
    # that spends its whole budget QUEUED must die at t=limit, like
    # the reference's enforceTimeLimits covering queued queries)
    deadline_timer: Optional[threading.Timer] = None
    _done: threading.Event = field(default_factory=threading.Event)
    _cancel: threading.Event = field(default_factory=threading.Event)
    _state_lock: threading.Lock = field(default_factory=threading.Lock)

    def _transition(self, new_state: str) -> bool:
        """Move to a terminal/running state unless already terminal."""
        with self._state_lock:
            if self.state in ("FINISHED", "FAILED", "CANCELED"):
                return False
            self.state = new_state
            return True

    def run(self, runner_factory, on_result=None, on_discard=None):
        if not self._transition("RUNNING"):
            return
        # the executor polls this event between plan nodes, so cancel
        # actually interrupts execution rather than just flipping state
        self.session.cancel = self._cancel  # tt-lint: ignore[race-attr-write] run-thread setup; only this thread's executor reads session.cancel
        try:
            runner = runner_factory(self.session)
            result = runner.execute(self.sql)
            persisted = False
            if on_result is not None and self.state == "RUNNING":
                # durability-before-publication: the restart-recovery
                # persist completes BEFORE any client can observe
                # FINISHED, so "the client saw the query finish"
                # implies "its results are re-pullable". Skipped once
                # a cancel landed — a CANCELED query's results must
                # never become recoverable-as-FINISHED.
                try:
                    persisted = bool(on_result(self, result))
                except Exception:        # noqa: BLE001 — best-effort
                    pass
            if self._transition("FINISHED"):
                self.result = result  # tt-lint: ignore[race-attr-write] sole writer (transition winner); readers tolerate the pre-publication None (query_results re-polls)
            elif persisted and on_discard is not None:
                # cancel raced the persist between the state check and
                # the transition: the query ends CANCELED, so the
                # just-spooled results must not outlive it
                try:
                    on_discard(self)
                except Exception:        # noqa: BLE001
                    pass
        except Exception as e:   # error taxonomy: Appendix A.8
            if self._cancel.is_set() or not self._transition("FAILED"):
                return
            from ..errors import classify
            ename, ecode, etype = classify(e)
            self.error = {  # tt-lint: ignore[race-attr-write] sole writer (FAILED-transition winner); readers see None until _done gates them
                "message": str(e),
                "errorCode": ecode,
                "errorName": ename,
                "errorType": etype,
                "failureInfo": {"type": type(e).__name__,
                                "stack": traceback.format_exc()
                                .splitlines()[-5:]},
            }
        finally:
            if self.ended is None:
                self.ended = time.time()  # tt-lint: ignore[race-attr-write] benign last-write with do_cancel's stamp; both are wall-clock end times
            self._done.set()

    def _retire_deadline_timer(self):
        """A terminal query never needs its armed deadline timer again;
        leaving it would pin this query (and its Session) in a sleeping
        Timer thread for up to query_max_run_time — per canceled
        queued query, under exactly the overload this layer is for.
        (Timer.cancel from within its own callback is a no-op.)"""
        if self.deadline_timer is not None:
            self.deadline_timer.cancel()

    def do_cancel(self):
        self._cancel.set()
        if self._transition("CANCELED"):
            if self.ended is None:
                self.ended = time.time()  # tt-lint: ignore[race-attr-write] benign last-write with do_cancel's stamp; both are wall-clock end times
            self._done.set()
        self._retire_deadline_timer()

    def kill(self, message: str,
             error_name: str = "ADMINISTRATIVELY_KILLED") -> bool:
        """Engine-initiated termination (low-memory killer, deadline
        breach): unlike a user cancel this is a FAILURE carrying a
        specific error identity — the client must learn WHY the
        engine stopped its query, not just that it stopped. Sets the
        cancel event so the executor and every remote page pull /
        status watch abort their in-flight work cooperatively."""
        from ..errors import error_info
        code, etype = error_info(error_name)
        with self._state_lock:
            if self.state in ("FINISHED", "FAILED", "CANCELED"):
                return False
            self.state = "FAILED"
            self.error = {"message": message, "errorCode": code,
                          "errorName": error_name, "errorType": etype}
        self._cancel.set()
        if self.ended is None:
            self.ended = time.time()  # tt-lint: ignore[race-attr-write] benign last-write with do_cancel's stamp; both are wall-clock end times
        self._done.set()
        self._retire_deadline_timer()
        return True

    def wait_done(self, timeout: float) -> bool:
        return self._done.wait(timeout)


class QueryTracker:
    """dispatcher/DispatchManager + execution/QueryTracker: owns every
    query's lifecycle; one executor thread per query. Dispatch routes
    through the resource-group manager (admission control:
    dispatcher/DispatchManager.java:183 selectGroup) and emits
    lifecycle events (event/QueryMonitor.java:130,206)."""

    def __init__(self, make_runner, events=None, resource_groups=None,
                 result_store=None, memory=None, manifest_store=None,
                 history_sink=None):
        from .events import EventListenerManager
        self._queries: Dict[str, _Query] = {}
        self._lock = threading.Lock()
        self._counter = itertools.count(1)
        # per-tracker instance token baked into every query id (the
        # reference id's trailing coordinator component,
        # QueryId "yyyyMMdd_HHmmss_index_coordId"): the counter resets
        # with the process, so two coordinators started within the
        # same wall-clock second would otherwise mint COLLIDING ids —
        # and colliding ids share one spool directory, letting query
        # A's persisted results shadow query B's execution manifest
        self._instance = uuid.uuid4().hex[:5]
        self._make_runner = make_runner
        self.events = events or EventListenerManager()
        self.groups = resource_groups
        # cluster memory governance (server/memory.py
        # ClusterMemoryManager): every dispatched query registers a
        # reservation context (fed by Executor._reserve) with its
        # group's soft limit and a kill callback — the low-memory
        # killer's handle on the query
        self.memory = memory
        # coordinator-restart recovery (fte/recovery.py): finished
        # queries persist their combine output + manifest here so a
        # client can re-pull results from a NEW coordinator process
        self.results = result_store
        # mid-flight failover (fte/recovery.py ExecutionManifestStore):
        # execution manifests spooled at dispatch time, released here
        # once the query is terminal (any state — a finished, failed or
        # canceled query must not be resumable by a later coordinator)
        self.manifests = manifest_store
        # terminal-query observability (obs/history.py): called with
        # the query after EVERY terminal transition — normal runs AND
        # admission rejections — so the history store sees FINISHED,
        # FAILED, CANCELED and QUEUE_FULL alike
        self.history_sink = history_sink

    def submit(self, sql: str, session: Session,
               source: str = "") -> _Query:
        from .events import QueryCreatedEvent, SplitCompletedEvent
        qid = (time.strftime("%Y%m%d_%H%M%S") +
               f"_{next(self._counter):05d}_{self._instance}")
        q = _Query(qid, uuid.uuid4().hex[:16], sql, session)
        q.source = source
        # stamp the session so the trace spans carry the coordinator
        # query id, and the executor's split reads fan out
        # SplitCompletedEvents through this tracker's listeners
        session.query_id = qid
        session.on_split = lambda split_id, wall_s: \
            self.events.split_completed(
                SplitCompletedEvent(qid, split_id, wall_s))
        with self._lock:
            self._queries[qid] = q
        _M_STATES.inc(state="QUEUED")
        self.events.query_created(QueryCreatedEvent(
            qid, sql, session.user, session.catalog, session.schema))
        self._arm_deadline(q, session)
        self._launch(q, session, source)
        return q

    def submit_resumed(self, q: _Query, runner_factory) -> _Query:
        """Register and dispatch an already-rebuilt query — the
        mid-flight half of coordinator failover (Coordinator.
        resume_query built ``q`` from the spooled execution manifest
        with its ORIGINAL id, slug, sql, session and submit/start
        times). First registration wins: two clients whose polls both
        miss must converge on ONE resumed execution. The returned
        query is the registered one (which may be a concurrent
        winner's, or even a plain recover_query entry that landed
        first).

        Resumption goes through the full admission path: the deadline
        re-arms against the ORIGINAL submit time (a resume must not
        extend query_max_run_time) and ``_launch`` routes through the
        resource-group manager and cluster memory registration exactly
        like a fresh submit — a failed-over query competes for slots,
        it does not jump the queue."""
        from .events import QueryCreatedEvent
        session = q.session
        from .events import SplitCompletedEvent
        session.query_id = q.query_id
        qid = q.query_id
        session.on_split = lambda split_id, wall_s: \
            self.events.split_completed(
                SplitCompletedEvent(qid, split_id, wall_s))
        with self._lock:
            registered = self._queries.setdefault(q.query_id, q)
        if registered is not q:
            return registered
        _M_STATES.inc(state="QUEUED")
        self.events.query_created(QueryCreatedEvent(
            q.query_id, q.sql, session.user, session.catalog,
            session.schema))
        self._arm_deadline(q, session)
        self._launch(q, session, q.source, runner_factory=runner_factory)
        return q

    def _arm_deadline(self, q: _Query, session: Session) -> None:
        limit = int(session.get("query_max_run_time") or 0)
        if limit > 0:
            # QUERY_MAX_RUN_TIME, armed at submit: the budget covers the
            # whole run, queued time included, as an absolute deadline.
            # The session carries it so the executor stops before the
            # next plan node, split or chunk; the timer is the backstop
            # that fails the query with EXCEEDED_TIME_LIMIT at once and
            # sets its cancel event.
            from ..obs.metrics import DEADLINE_CANCELS
            session.deadline = q.submit_mono + limit

            def deadline_fire():
                if q.kill(
                        f"Query exceeded the maximum run time of "
                        f"{limit}s (query_max_run_time)",
                        "EXCEEDED_TIME_LIMIT"):
                    DEADLINE_CANCELS.inc()
                    self._withdraw_if_queued(q)

            q.deadline_timer = threading.Timer(
                max(session.deadline - time.monotonic(), 0.001),
                deadline_fire)
            q.deadline_timer.daemon = True
            q.deadline_timer.start()

    def _launch(self, q: _Query, session: Session, source: str,
                runner_factory=None) -> None:
        """Admission + execution of one registered query:
        resource-group routing, memory registration, the run thread,
        and every piece of terminal bookkeeping. ``runner_factory``
        (default: the coordinator's) lets a failover resume substitute
        a manifest-driven runner."""
        from .events import QueryCompletedEvent
        from .resourcegroups import QueryQueueFullError
        qid = q.query_id

        def run_and_release():
            if q.started is None:
                q.started = time.time()
            if q.group is not None:
                # the admitting group's identity and scheduling weight
                # ride the session (the worker slice's task payloads
                # carry them to the workers' split scheduler)
                session.resource_group = getattr(
                    q.group, "full_name", "global")
                session.resource_group_weight = float(
                    getattr(q.group, "scheduling_weight", 1) or 1)
            if self.memory is not None:
                # cluster memory governance: the pool ledger tracks
                # this query from first reservation to completion; the
                # group's soft limit and the per-query cap ride along
                session.memory = self.memory.register(
                    qid,
                    group=getattr(q.group, "full_name", "global")
                    if q.group is not None else "global",
                    kill_fn=q.kill,
                    group_limit_bytes=getattr(
                        q.group, "soft_memory_limit_bytes", 0) or 0
                    if q.group is not None else 0,
                    query_limit_bytes=int(
                        session.get("query_max_memory") or 0))
            _M_STATES.inc(state="RUNNING")
            persist = discard = None
            if self.results is not None:
                def persist(query, result):
                    # durable results: spool the combine output + a
                    # minimal manifest so a restarted coordinator can
                    # serve this query's re-pulls
                    return self.results.persist(
                        query.query_id, query.slug, query.sql,
                        query.session.user, result)

                def discard(query):
                    # cancel won the race against the persist: reap
                    # the entry so it cannot be recovered as FINISHED
                    self.results.release(query.query_id)
            try:
                q.run(runner_factory or self._make_runner,
                      on_result=persist, on_discard=discard)
            finally:
                if q.deadline_timer is not None:
                    q.deadline_timer.cancel()
                if self.manifests is not None:
                    # terminal in any state: the execution manifest
                    # exists only to let another coordinator finish a
                    # RUNNING query
                    self.manifests.release(qid)
                if self.memory is not None:
                    self.memory.unregister(qid)
                    session.memory = None
                if q.group is not None and self.groups is not None:
                    self.groups.query_finished(q.group)
                # queue-wait span: grafted post-hoc (the trace is born
                # inside the runner, after dequeue) so /v1/query shows
                # admission latency next to parse/plan/execute
                queued_s = ((q.started or q.created) - q.created)
                tr = getattr(q.result, "trace", None) \
                    if q.result is not None else None
                if tr is not None and q.admission_queued \
                        and queued_s > 0:
                    tr.record("queued", tr.origin_s - queued_s,
                              tr.origin_s, group=getattr(
                                  q.group, "full_name", ""))
                _M_STATES.inc(state=q.state)
                if self.results is not None:
                    try:
                        # ride-along TTL sweep (time-gated internally):
                        # clients don't DELETE fully-drained queries,
                        # so without this the persisted results of
                        # retry_policy=NONE queries — whose dispatch
                        # path never touches the spool — would pile up
                        # forever
                        self.results.spool.maybe_cleanup()
                    except Exception:    # noqa: BLE001
                        pass
                r = q.result
                stats = (getattr(r, "stats", None) or []) if r else []
                cum = None
                if stats:
                    cum = {
                        "input_rows": sum(max(s.input_rows, 0)
                                          for s in stats),
                        "output_rows": sum(max(s.output_rows, 0)
                                           for s in stats),
                        "output_bytes": sum(max(s.output_bytes, 0)
                                            for s in stats),
                        "compile_s": sum(s.compile_s for s in stats),
                        "wall_s": sum(s.wall_s for s in stats),
                    }
                self.events.query_completed(QueryCompletedEvent(
                    q.query_id, q.sql, q.session.user, q.state,
                    time.time() - q.created,
                    rows=len(r.rows) if r else 0,
                    error_name=(q.error or {}).get("errorName"),
                    error_message=(q.error or {}).get("message"),
                    peak_memory_bytes=getattr(
                        r, "peak_memory_bytes", 0) if r else 0,
                    spill_bytes=getattr(r, "spill_bytes", 0) if r else 0,
                    cumulative_operator_stats=cum,
                    operator_summaries=tuple(
                        s.to_dict() for s in stats)))
                if self.history_sink is not None:
                    try:
                        self.history_sink(q)
                    except Exception:    # noqa: BLE001 — history is
                        pass             # best-effort bookkeeping

        def start(group=None):
            # the group is recorded BEFORE the thread exists so a
            # fast-finishing query cannot race past run_and_release's
            # slot release (q.group would still be None)
            q.group = group
            with q._state_lock:
                dead = q.state in ("FINISHED", "FAILED", "CANCELED")
            if dead and group is not None and self.groups is not None:
                # a dequeued entry whose query already died (deadline
                # kill / cancel racing the withdrawal): release the
                # just-taken slot instead of spending a thread on a
                # query that will no-op
                self.groups.query_finished(group)
                return
            t = threading.Thread(target=run_and_release, daemon=True,
                                 name=f"query-{qid}")
            # tag for the leak detector: a thread outliving its
            # query's terminal state is an orphan
            # (server/diagnostics.py)
            t.trino_query_id = qid
            t.start()

        if self.groups is None:
            start()
        else:
            try:
                _, started_now = self.groups.submit(
                    session.user, source, start, tag=qid)
                if not started_now:
                    q.admission_queued = True
            except QueryQueueFullError as e:
                # protocol-correct rejection: the Trino error name with
                # ITS code and INSUFFICIENT_RESOURCES type (was a
                # hand-typed — and wrong — literal code), flowing to
                # the client as a FAILED QueryResults payload instead
                # of a bare 500
                if q.deadline_timer is not None:
                    q.deadline_timer.cancel()
                from ..errors import error_info
                code, etype = error_info("QUERY_QUEUE_FULL")
                q.error = {"message": str(e), "errorCode": code,
                           "errorName": "QUERY_QUEUE_FULL",
                           "errorType": etype}
                q._transition("FAILED")
                # terminal stamp: without it queuedTimeMillis /
                # elapsedTimeMillis grow on every poll of a query
                # that was rejected instantly
                q.ended = time.time()
                q._done.set()
                self.events.query_completed(QueryCompletedEvent(
                    q.query_id, q.sql, q.session.user, "FAILED",
                    0.0, error_name="QUERY_QUEUE_FULL",
                    error_message=str(e)))
                if self.history_sink is not None:
                    # rejections are history too: a queue-full storm
                    # must be diagnosable from system.runtime.queries
                    try:
                        self.history_sink(q)
                    except Exception:    # noqa: BLE001
                        pass

    def get(self, qid: str) -> Optional[_Query]:
        with self._lock:
            return self._queries.get(qid)

    def all(self) -> List[_Query]:
        with self._lock:
            return list(self._queries.values())

    def running(self) -> List[_Query]:
        return [q for q in self.all()
                if q.state in ("QUEUED", "RUNNING")]

    def cancel(self, qid: str) -> bool:
        q = self.get(qid)
        if q is None:
            return False
        q.do_cancel()
        self._withdraw_if_queued(q)
        return True

    def _withdraw_if_queued(self, q: _Query) -> None:
        """A query terminated before admission must leave its group's
        queue: a dead entry holds max_queued capacity and would later
        burn a concurrency slot. ``started is None`` = never dequeued;
        the dequeue-side terminal check in submit's start() covers the
        race where admission wins."""
        if self.groups is not None and q.started is None:
            self.groups.remove_queued(q.query_id)


class Coordinator:
    """HTTP server wrapper. ``start()`` binds an ephemeral (or given)
    port; ``base_uri`` mirrors server/Server.java's announcement.
    Queries run on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``; an error without a card): the whole query on a single
    node, the root stage when workers are live; with ``distributed=True``
    a query without workers runs over the device mesh (one shard per
    visible card; one CPU shard with ``device="cpu"``).
    ``scan_cache_bytes``, when given, is the process's
    scan-cache budget while it serves (``scan-cache.max-size`` in
    etc/config.properties)."""

    def __init__(self, port: int = 0, distributed: bool = False,
                 catalogs=None, resource_groups=None,
                 event_listeners=None, authenticator=None,
                 worker_uris=None, failure_detector=None,
                 spool=None, spool_backend: Optional[str] = None,
                 memory_pool_bytes: Optional[int] = None,
                 history_dir: Optional[str] = None,
                 scan_cache_bytes: Optional[int] = None,
                 device: DeviceLike = None):
        from .events import EventListenerManager
        self.device = resolve_device(device)
        self.node_id = f"coordinator-{uuid.uuid4().hex[:8]}"
        self.started = time.time()
        self.authenticator = authenticator
        # the worker fleet: queries dispatch fragments and stages to
        # these processes (exec/remote.py). Membership is live: workers
        # join and leave through /v1/announcement (add_worker,
        # remove_worker), under one lock.
        self.workers = [str(w).rstrip("/") for w in (worker_uris or [])]
        self._members_lock = threading.Lock()
        # the pre-warm readiness each worker announces (exec/hotshapes.py;
        # boot-configured workers count as warm)
        self.worker_prewarmed: Dict[str, bool] = {
            w: True for w in self.workers}
        # fault-tolerant execution (fte/): one failure detector and one
        # spool shared by every query. The default detector learns from
        # the schedulers' task failures; failure_detector.start() adds
        # the heartbeat loop (server/main.py does for configured fleets;
        # add_worker starts it for fleets born empty).
        self.failure_detector = failure_detector
        # a detector the caller gives is started with the coordinator;
        # the default one of a configured fleet learns from task
        # failures only, unless server/main.py starts its heartbeats
        self._start_detector = failure_detector is not None
        if self.failure_detector is None and self.workers:
            from .failure import HeartbeatFailureDetector
            self.failure_detector = HeartbeatFailureDetector()
        if self.failure_detector is not None:
            for w in self.workers:
                self.failure_detector.add_service(w)
        # the spool (fte/spool.py) carries fragment output of
        # fault-tolerant queries and the finished queries' results that
        # a restarted coordinator serves; a workerless coordinator has
        # one only when asked
        self.spool = spool
        if self.spool is None and (self.workers
                                   or spool_backend is not None):
            from ..fte.spool import make_spool
            self.spool = make_spool(spool_backend)
        self.results = None
        self.manifests = None
        if self.spool is not None:
            from ..fte.recovery import (ExecutionManifestStore,
                                        ResultStore)
            self.results = ResultStore(self.spool)
            # execution manifests of RUNNING distributed queries live on
            # the server spool, like results
            self.manifests = ExecutionManifestStore(self.spool)

        # one shared CatalogManager (memory-connector state spans
        # queries) and one shared mesh
        self._proto = LocalQueryRunner(catalogs=catalogs,
                                       device=self.device,
                                       distributed=distributed)
        self._catalogs = self._proto.catalogs
        # the system catalog, backed by this coordinator
        from ..connectors.system import SystemConnector
        self._catalogs.register("system",
                                SystemConnector(self, device=self.device))

        def make_runner(session: Session):
            # the result cache answers a repeated identical
            # deterministic query before the runner plans it; node
            # stats feed /v1/query and the history (OperatorStats is
            # always on in the reference coordinator)
            from ..exec.resultcache import CachingQueryRunner

            def wrap(runner):
                return CachingQueryRunner(runner, session,
                                          self._catalogs)

            live = self.live_workers()
            if live:
                from ..exec.remote import DistributedHostQueryRunner
                # SET SESSION spool_backend overrides the server's
                # fragment spool for this query (result persistence
                # stays on the server spool)
                backend = str(session.get("spool_backend") or "")
                spool = self.spool
                if backend:
                    from ..fte.spool import default_spool
                    spool = default_spool(backend)
                # mid-flight failover: the runner persists the execution
                # manifest at dispatch time, with the tracked query's
                # identity, admission and timing
                meta = None
                if self.manifests is not None:
                    tq = self.tracker.get(
                        getattr(session, "query_id", "") or "")
                    if tq is not None:
                        meta = {
                            "queryId": tq.query_id,
                            "slug": tq.slug,
                            "sql": tq.sql,
                            "user": session.user,
                            "source": tq.source,
                            "resourceGroup": getattr(
                                tq.group, "full_name", "global")
                            if tq.group is not None else "global",
                            "submitEpoch": tq.created,
                            "startedEpoch": tq.started,
                        }
                return wrap(DistributedHostQueryRunner(
                    live, session=session, catalogs=self._catalogs,
                    collect_node_stats=True,
                    failure_detector=self.failure_detector,
                    spool=spool,
                    manifest_store=self.manifests,
                    manifest_meta=meta,
                    # live membership: workers that join mid-query
                    # become retry and speculation targets
                    worker_supplier=self.live_workers,
                    device=self.device))
            return wrap(LocalQueryRunner(session=session,
                                         device=self.device,
                                         catalogs=self._catalogs,
                                         mesh=self._proto.mesh,
                                         collect_node_stats=True))

        events = EventListenerManager()
        for listener in (event_listeners or []):
            events.add_listener(listener)
        if resource_groups is None:
            # admission is always real: a default manager routes every
            # query through the root group's hard_concurrency and
            # max_queued gates
            from .resourcegroups import ResourceGroupManager
            resource_groups = ResourceGroupManager()
        self.resource_groups = resource_groups
        # cluster memory pool (server/memory.py): the argument beats the
        # config; 0 disables governance (per-node limits still apply)
        pool_bytes = (memory_pool_bytes
                      if memory_pool_bytes is not None
                      else CONFIG.cluster_memory_pool_bytes)
        self.memory = None
        if pool_bytes and pool_bytes > 0:
            from .memory import ClusterMemoryManager, ClusterMemoryPool
            self.memory = ClusterMemoryManager(
                ClusterMemoryPool(int(pool_bytes)))
        # query history and learned statistics (obs/history.py,
        # exec/learnedstats.py): terminal queries append JSONL records
        # under the history dir, and the learned-stats registry
        # checkpoints there, so both survive restarts
        from ..exec.learnedstats import LEARNED_STATS
        from ..obs.history import (MetricsRing, QueryHistoryStore,
                                   TraceRing)
        hist_dir = history_dir or os.path.join(CONFIG.spool_dir,
                                               "history")
        self.history = QueryHistoryStore(
            os.path.join(hist_dir, "queries.jsonl"))
        self.trace_ring = TraceRing()
        self.metrics_ring = MetricsRing()
        self._learned_stats_path = os.path.join(hist_dir,
                                                "learned_stats.json")
        self._learned_saved_at = 0.0
        LEARNED_STATS.load(self._learned_stats_path)
        # resume_query builds manifest-driven runners through the same
        # factory (live membership, failure detector, spool wiring)
        self._make_runner = make_runner
        self.tracker = QueryTracker(make_runner, events,
                                    resource_groups,
                                    result_store=self.results,
                                    memory=self.memory,
                                    manifest_store=self.manifests,
                                    history_sink=self._on_query_terminal)
        # streaming ingestion and continuous queries (streaming/): the
        # process-wide message log backs POST /v1/ingest/{topic} and the
        # stream catalog's scans; the continuous-query manager drives
        # long-lived jobs whose cycles are real tracked queries (source
        # "continuous"). Consumer offsets spool under reserved fragment
        # -3 on the server spool (or the process default for a
        # workerless coordinator), and the job ledger lives next to the
        # query history so a replacement coordinator restarts RUNNING
        # jobs (start()).
        from ..streaming.continuous import ContinuousQueryManager
        from ..streaming.log import get_log
        from ..streaming.offsets import OffsetStore
        self.stream_log = get_log()
        off_spool = self.spool
        if off_spool is None:
            from ..fte.spool import default_spool
            off_spool = default_spool()
        self.continuous = ContinuousQueryManager(
            self._run_continuous_sql, self._catalogs,
            OffsetStore(off_spool),
            jobs_path=os.path.join(hist_dir, "continuous.jsonl"),
            log=self.stream_log, device=self.device)
        self._register_metric_collectors()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _make_handler(self))
        self.port = self._httpd.server_address[1]
        # the scan cache's budget (exec/scancache.py) while this
        # coordinator serves: the cache is process-wide, so start() sets
        # it and stop() puts the earlier budget back
        self._scan_cache_bytes = scan_cache_bytes
        self._scan_cache_prev = None
        self._thread: Optional[threading.Thread] = None

    def _register_metric_collectors(self):
        """Polled gauges refreshed at scrape time (obs/metrics.py):
        query states and queue depth. The registry is process-global:
        the collector is unregistered on stop() (and self-unregisters
        if the coordinator is garbage-collected without stop), so test
        suites building many coordinators don't accumulate dead
        callbacks or stale gauges. With several LIVE coordinators in
        one process the gauge families are shared and last-writer-wins
        — production runs one coordinator per process."""
        import weakref
        wself = weakref.ref(self)
        g_state = METRICS.gauge(
            "trino_tpu_queries",
            "Queries currently tracked, by state", ("state",))
        g_queue = METRICS.gauge(
            "trino_tpu_queue_depth",
            "Queries admitted but not yet running (queue depth)")
        g_workers = METRICS.gauge(
            "trino_tpu_active_workers", "Known worker nodes")

        def collect():
            co = wself()
            if co is None:
                METRICS.unregister_collector(collect)
                return
            qs = co.tracker.all()
            for st in ("QUEUED", "RUNNING", "FINISHED", "FAILED",
                       "CANCELED"):
                g_state.set(sum(1 for q in qs if q.state == st),
                            state=st)
            g_queue.set(sum(1 for q in qs if q.state == "QUEUED"))
            g_workers.set(len(co.workers))

        self._metric_collector = collect
        METRICS.register_collector(collect)

    @property
    def base_uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self):
        if self._scan_cache_bytes is not None \
                and self._scan_cache_prev is None:
            self._scan_cache_prev = CONFIG.scan_cache_bytes
            CONFIG.scan_cache_bytes = int(self._scan_cache_bytes)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        if self._start_detector:
            self.failure_detector.start()
        # coordinator-failover restart of continuous jobs: replay the
        # durable ledger; restarted consumers resume from their
        # committed offset epochs
        self.continuous.restart_jobs()
        return self

    def stop(self):
        self.continuous.stop()
        METRICS.unregister_collector(self._metric_collector)
        try:
            # final learned-stats checkpoint: the throttled per-query
            # saves may be up to one interval stale at shutdown
            from ..exec.learnedstats import LEARNED_STATS
            LEARNED_STATS.save(self._learned_stats_path)
        except Exception:        # noqa: BLE001 — shutdown best-effort
            pass
        if self.failure_detector is not None:
            self.failure_detector.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._scan_cache_prev is not None:
            CONFIG.scan_cache_bytes = self._scan_cache_prev
            self._scan_cache_prev = None

    # ---- coordinator-restart result recovery -------------------------
    def recover_query(self, query_id: str,
                      slug: Optional[str] = None) -> Optional[_Query]:
        """Rebuild a FINISHED query this process never ran from its
        spooled manifest + result pages (fte/recovery.py) — the serving
        half of coordinator restart tolerance. ``slug`` (when the
        client supplied one) must match the manifest: the slug is the
        per-query capability token, and a restart must not weaken it."""
        if self.results is None:
            return None
        # slug checked against the manifest alone (load_manifest)
        # before the row frames are decoded: a wrong-slug probe 404s
        # without re-reading the whole persisted result
        rec = self.results.load(query_id, slug)
        if rec is None or (slug is not None and rec.slug != slug):
            return None
        q = _Query(query_id, rec.slug, rec.sql,
                   Session(user=rec.user or "user"))
        q.state = "FINISHED"
        q.result = rec.to_query_result()
        q.ended = time.time()
        q._done.set()
        with self.tracker._lock:
            # first-registration-wins: a concurrent recovery (two
            # clients re-pulling at once) must serve ONE entry
            registered = self.tracker._queries.setdefault(query_id, q)
        if registered is q:
            # counted here, not in ResultStore.load: a slug-mismatch
            # probe or a losing concurrent load is not a recovery
            _M_RESULTS_RECOVERED.inc()
        return registered

    def recovered_query_detail(self, query_id: str) -> Optional[dict]:
        """Manifest-only detail for an untracked query — the slug-less
        /v1/query/{id} surface. Full recovery (recover_query) decodes
        every persisted row frame and pins it in the tracker, which a
        request that presents no slug and needs only metadata must not
        trigger: probed ids would pin N x result_spool_max_bytes of
        rows in a process that never ran them."""
        if self.results is None:
            return None
        mf = self.results.load_manifest(query_id)
        if mf is None:
            return None
        return {
            "queryId": str(mf.get("queryId", query_id)),
            "state": "FINISHED",
            "query": str(mf.get("sql", "")),
            "user": str(mf.get("user", "")),
            "source": "",
            "error": None,
            "rows": int(mf.get("rows") or 0),
            "recovered": True,
        }

    # ---- resource payloads -------------------------------------------
    def query_results(self, q: _Query, token: int) -> dict:
        uri = f"{self.base_uri}/v1/statement/executing/{q.query_id}" \
              f"/{q.slug}"
        out = {
            "id": q.query_id,
            "infoUri": f"{self.base_uri}/ui/query.html?{q.query_id}",
            "stats": {"state": q.state,
                      "queued": q.state == "QUEUED",
                      "scheduled": q.state in ("RUNNING", "FINISHED"),
                      "elapsedTimeMillis":
                          int((time.time() - q.created) * 1000),
                      # admission latency: how long the query sat in
                      # its resource group's queue (still growing
                      # while QUEUED — the client watches back-
                      # pressure build in its nextUri polls; frozen at
                      # q.ended for queries that died without starting,
                      # e.g. queue-full rejections)
                      "queuedTimeMillis": int(
                          ((q.started or q.ended or time.time())
                           - q.created) * 1000)},
            "warnings": [],
        }
        if q.state == "FAILED":
            out["error"] = q.error
            return out
        if q.state == "CANCELED":
            out["error"] = {"message": "Query was canceled",
                            "errorCode": 2, "errorName": "USER_CANCELED",
                            "errorType": "USER_ERROR"}
            return out
        if q.state in ("QUEUED", "RUNNING") or q.result is None:
            out["nextUri"] = f"{uri}/{token}"
            return out
        res = q.result
        if res.update_type is not None:
            out["updateType"] = res.update_type
            if res.update_count is not None:
                out["updateCount"] = res.update_count
        start = token * PAGE_ROWS
        chunk = res.rows[start:start + PAGE_ROWS]
        if res.columns:
            out["columns"] = [
                {"name": n, "type": t.name,
                 "typeSignature": {"rawType": t.name.split("(")[0],
                                   "arguments": []}}
                for n, t in zip(res.columns, res.types)]
            if chunk:
                out["data"] = [[_json_value(v) for v in row]
                               for row in chunk]
        if start + PAGE_ROWS < len(res.rows):
            out["nextUri"] = f"{uri}/{token + 1}"
        return out

    def info(self) -> dict:
        return {"nodeVersion": {"version": "trino-tpu-0.1"},
                "environment": self.device.type,
                "coordinator": True,
                "starting": False,
                "nodeId": self.node_id,
                "uptime": f"{time.time() - self.started:.0f}s"}

    def query_detail(self, q: _Query) -> dict:
        """Query detail for /v1/query/{id} and the web UI: state,
        timing, per-node stats, and the optimized plan tree (webapp
        QueryDetail + LivePlan analog)."""
        out = {
            "queryId": q.query_id, "state": q.state, "query": q.sql,
            "user": q.session.user, "source": q.source,
            "created": time.strftime("%Y-%m-%d %H:%M:%S",
                                     time.localtime(q.created)),
            "elapsedTimeMillis": int(
                ((q.ended or time.time()) - q.created) * 1000),
            "queuedTimeMillis": int(
                ((q.started or q.ended or time.time()) - q.created)
                * 1000),
            "error": q.error,
        }
        if q.result is not None:
            out["rows"] = len(q.result.rows)
            out["wallMillis"] = int(
                (getattr(q.result, "wall_s", 0.0) or 0.0) * 1000)
            out["peakMemoryBytes"] = getattr(
                q.result, "peak_memory_bytes", 0)
            out["spillBytes"] = getattr(q.result, "spill_bytes", 0)
            stats = getattr(q.result, "stats", None)
            if stats:
                out["nodeStats"] = [
                    {"node": s.name, "detail": s.detail,
                     "wallMillis": round(s.wall_s * 1000, 2),
                     "outputRows": s.output_rows,
                     "inputRows": s.input_rows,
                     "inputBytes": s.input_bytes,
                     "outputBytes": s.output_bytes,
                     "compileMillis": round(s.compile_s * 1000, 2),
                     "cacheHit": s.cache_hit} for s in stats]
            trace = getattr(q.result, "trace", None)
            if trace is not None and trace.roots:
                out["spans"] = trace.to_dicts()
        # the plan captured at execution time (QueryResult.plan_lines) —
        # re-planning on every GET both wasted work and could silently
        # diverge from the plan that actually ran. Checked BEFORE the
        # mid-flight fallback cache, which a poll during RUNNING may
        # have populated with a re-derived (possibly divergent) plan.
        plan = (getattr(q.result, "plan_lines", None)
                if q.result is not None else None)
        if plan is None:
            plan = getattr(q, "_plan_lines", None)
        if plan is None and q.state in ("FINISHED", "RUNNING"):
            # legacy fallback (old results without captured plans, or a
            # query mid-flight): derive once and cache on the query
            try:
                from ..planner.logical import LogicalPlanner
                from ..planner.optimizer import optimize
                from ..plan.nodes import plan_tree_lines
                from ..sql import ast as A
                from ..sql.parser import parse_statement
                stmt = parse_statement(q.sql)
                if isinstance(stmt, A.QueryStatement):
                    p = optimize(
                        LogicalPlanner(self._catalogs,
                                       q.session).plan(stmt),
                        self._catalogs, q.session)
                    plan = plan_tree_lines(p)
                else:
                    plan = []
            except Exception as e:  # noqa: BLE001 — detail is best-effort
                _M_DETAIL_PLAN_ERRORS.inc()
                out["planError"] = f"{type(e).__name__}: {e}"
                plan = []
            q._plan_lines = plan
        if plan:
            out["plan"] = plan
        return out

    def query_infos(self) -> list:
        return [{"queryId": q.query_id, "state": q.state,
                 "query": q.sql, "user": q.session.user,
                 "source": q.source,
                 "created": time.strftime(
                     "%Y-%m-%d %H:%M:%S", time.localtime(q.created)),
                 "elapsedTimeMillis": int(
                     ((q.ended or time.time()) - q.created) * 1000)}
                for q in self.tracker.all()]

    # ---- live worker membership --------------------------------------
    def live_workers(self) -> List[str]:
        """Current worker set minus nodes the failure detector reports
        dead — the per-dispatch view the schedulers consume. Pre-warmed
        workers sort first (stable within each class), so a query's
        initial task fan-out lands on nodes whose hot-shape programs
        are already compiled; a scheduler's mid-query re-syncs are
        append-only and unaffected (exec/remote.py _sync_workers)."""
        detector = self.failure_detector
        with self._members_lock:
            workers = list(self.workers)
            warm = dict(self.worker_prewarmed)
        return sorted(
            (w for w in workers
             if detector is None or detector.is_alive(w)),
            key=lambda w: not warm.get(w, False))

    def add_worker(self, uri: str,
                   prewarmed: Optional[bool] = None) -> bool:
        """Join a worker at runtime (/v1/announcement POST; reference:
        DiscoveryNodeManager absorbing a service announcement). A
        joining worker immediately becomes a retry / speculation
        target for in-flight queries and a full member for new ones.
        Idempotent: re-announcement of a known worker is a no-op for
        membership but still refreshes its pre-warm readiness flag —
        that is how a joiner's background warm-up completion reaches
        the scheduler (the worker re-announces with prewarmed=true)."""
        uri = str(uri).rstrip("/")
        if not uri:
            return False
        with self._members_lock:
            # the whole join — membership, detector/spool bootstrap —
            # runs under the lock: concurrent first announcements must
            # not construct two detectors (a worker registered in the
            # discarded one would never be heartbeat-probed)
            if prewarmed is not None:
                self.worker_prewarmed[uri] = bool(prewarmed)
            if uri in self.workers:
                return False
            self.workers.append(uri)
            if self.failure_detector is None:
                from .failure import HeartbeatFailureDetector
                self.failure_detector = HeartbeatFailureDetector()
            self.failure_detector.add_service(uri)
            # a fleet born empty never started its heartbeat loop;
            # start() is idempotent for one already running
            self.failure_detector.start()
            if self.spool is None:
                # first worker ever: the cluster just became
                # distributed — it needs the spool (and with it
                # restart recovery and mid-flight failover)
                from ..fte.recovery import (ExecutionManifestStore,
                                            ResultStore)
                from ..fte.spool import make_spool
                self.spool = make_spool()
                self.results = ResultStore(self.spool)
                self.tracker.results = self.results
                self.manifests = ExecutionManifestStore(self.spool)
                self.tracker.manifests = self.manifests
        _M_WORKER_JOINS.inc()
        return True

    def remove_worker(self, uri: str) -> bool:
        """Graceful leave (/v1/announcement DELETE). Ungraceful deaths
        need no call — the heartbeat detector sidelines them and the
        retry engine routes around."""
        uri = str(uri).rstrip("/")
        with self._members_lock:
            self.worker_prewarmed.pop(uri, None)
            if uri not in self.workers:
                return False
            self.workers.remove(uri)
        if self.failure_detector is not None:
            self.failure_detector.remove_service(uri)
        _M_WORKER_LEAVES.inc()
        return True

    # ---- coordinator-restart result recovery -------------------------

    # ---- mid-flight query resumption (coordinator failover) ----------
    def resume_query(self, query_id: str,
                     slug: Optional[str] = None) -> Optional[_Query]:
        """Finish a RUNNING query dispatched by a coordinator that
        died: the mid-flight half of failover, next to
        ``recover_query``'s FINISHED half. The execution manifest
        spooled at dispatch time carries the stage DAG's serde-proven
        wire payloads, the fan-out, the session/admission context and
        the ORIGINAL submit/start times; stage progress is read off
        the exchange spool's first-commit-wins COMMITTED markers, so
        only the partitions the dead coordinator had NOT committed are
        re-dispatched (exec/remote.py resume + stage/scheduler.py
        resume_spool).

        Gated on retry_policy=TASK (the manifest is only written under
        it, and a NONE query's fragments never touch the spool — there
        is nothing safe to resume). Returns None when no slug-matching
        manifest exists, resumption is gated off, or no workers are
        live; the caller falls through to 404 and the client's retry
        loop keeps polling."""
        if self.manifests is None:
            return None
        mf = self.manifests.load(query_id, slug)
        if mf is None:
            return None
        if not self.live_workers():
            return None
        session = Session(catalog=mf.get("catalog"),
                          schema=mf.get("schema"),
                          user=str(mf.get("user") or "user"))
        for name, value in (mf.get("properties") or {}).items():
            try:
                session.set(str(name), value)
            except (KeyError, TypeError, ValueError):
                continue    # property from a newer/older build
        from ..fte.retry import RetryPolicy
        if not RetryPolicy.from_session(session).enabled:
            return None
        q = _Query(str(mf.get("queryId") or query_id),
                   str(mf.get("slug")), str(mf.get("sql") or ""),
                   session)
        q.source = str(mf.get("source") or "")
        # original-time accounting: queued/elapsed/deadline anchor at
        # the FIRST coordinator's submit — failover must not hand the
        # query a fresh query_max_run_time budget
        try:
            q.created = float(mf.get("submitEpoch") or q.created)
        except (TypeError, ValueError):
            pass
        q.submit_mono = time.monotonic() - max(
            time.time() - q.created, 0.0)
        started = mf.get("startedEpoch")
        if started:
            try:
                q.started = float(started)
            except (TypeError, ValueError):
                pass
        make_runner = self._make_runner

        def resume_runner_factory(sess: Session):
            runner = make_runner(sess)

            class _ResumeRunner:
                """execute() ignores the SQL text: the plan was
                fragmented, proven and spooled by the dead
                coordinator; re-planning here could fragment
                differently and orphan the committed partitions."""

                def execute(self, _sql: str):
                    return runner.resume(mf)

            return _ResumeRunner()

        registered = self.tracker.submit_resumed(q, resume_runner_factory)
        if registered is q:
            # counted only for the registration winner: a losing
            # concurrent resume (or one beaten by recover_query) did
            # not resume anything
            self.manifests.mark_resumed()
        return registered

    # ---- query history & learned stats (obs/history.py) ---------------
    def _on_query_terminal(self, q) -> None:
        """Terminal-query bookkeeping, called from the tracker's run
        thread (and the admission-rejection path): one history record,
        the slow-query side log, the trace ring, a metrics-ring sample
        and a throttled learned-stats checkpoint."""
        from ..exec.learnedstats import LEARNED_STATS
        from ..obs.history import record_from_query
        sess = q.session
        if bool(sess.get("query_history_enabled")):
            rec = self.history.record(record_from_query(q))
            threshold = int(sess.get("slow_query_log_ms") or 0)
            if threshold > 0 and rec["wall_s"] * 1000.0 >= threshold:
                self.history.slow_log(rec, threshold)
        trace = getattr(q.result, "trace", None) \
            if q.result is not None else None
        self.trace_ring.append(q.query_id, q.state, trace)
        self.metrics_ring.maybe_sample(self._collect_cluster_metrics)
        now = time.time()
        if now - self._learned_saved_at >= 5.0:
            # checkpoint throttle: racing terminal threads may both
            # save — harmless (atomic rename, same content modulo a
            # few observations); stop() takes the final one
            self._learned_saved_at = now
            LEARNED_STATS.save(self._learned_stats_path)

    def _collect_cluster_metrics(self) -> dict:
        """{node: parsed exposition}: this coordinator's registry plus a
        best-effort /metrics scrape of every live worker (the rollup
        behind system.runtime.metrics)."""
        from ..obs.metrics import parse_exposition
        nodes = {self.node_id: parse_exposition(METRICS.render())}
        import urllib.request
        for w in self.live_workers():
            try:
                with urllib.request.urlopen(f"{w}/metrics",
                                            timeout=2.0) as resp:
                    nodes[w] = parse_exposition(
                        resp.read().decode("utf-8", "replace"))
            except Exception:    # noqa: BLE001 — scrape best-effort
                continue
        return nodes

    def history_infos(self) -> list:
        """system.runtime.queries rows: live QUEUED/RUNNING queries
        first (record-shaped, built on the fly), then the durable
        terminal history, newest first."""
        from ..obs.history import record_from_query
        recs = self.history.records()
        seen = {r.get("query_id") for r in recs}
        live = [record_from_query(q) for q in self.tracker.all()
                if q.state in ("QUEUED", "RUNNING")
                and q.query_id not in seen]
        return live + recs

    def operator_stat_infos(self) -> list:
        from ..exec.learnedstats import LEARNED_STATS
        return LEARNED_STATS.snapshot()

    def metric_infos(self) -> list:
        """system.runtime.metrics rows: the current cluster-wide
        sample plus every ring snapshot, flattened."""
        self.metrics_ring.maybe_sample(self._collect_cluster_metrics)
        out = []

        def flatten(ts_ms, nodes, sample):
            for node, families in (nodes or {}).items():
                for name, series in families.items():
                    for labels, value in series.items():
                        out.append({"captured_ms": ts_ms, "node": node,
                                    "name": name,
                                    "labels": ",".join(labels),
                                    "value": value, "sample": sample})

        try:
            flatten(int(time.time() * 1000),
                    self._collect_cluster_metrics(), "current")
        except Exception:        # noqa: BLE001 — scan must not fail
            pass
        for snap in self.metrics_ring.snapshots():
            flatten(int(float(snap.get("ts") or 0.0) * 1000),
                    snap.get("nodes"), "ring")
        return out

    # ---- SystemProvider SPI (connectors/system.py) --------------------
    def node_infos(self) -> list:
        nodes = [{"nodeId": self.node_id, "uri": self.base_uri,
                  "nodeVersion": "trino-tpu-0.1", "coordinator": True,
                  "state": "active"}]
        detector = self.failure_detector
        for w in list(self.workers):
            state = "active"
            if detector is not None and not detector.is_alive(w):
                state = "failed"
            nodes.append({"nodeId": w, "uri": w,
                          "nodeVersion": "trino-tpu-0.1",
                          "coordinator": False, "state": state})
        return nodes

    def resource_group_infos(self) -> list:
        if self.resource_groups is None:
            return []
        return self.resource_groups.info()

    def kill_query(self, query_id: str) -> bool:
        return self.tracker.cancel(query_id)

    def continuous_query_infos(self) -> list:
        """system.runtime.continuous_queries rows."""
        return self.continuous.infos()

    # ---- continuous-query cycle driver --------------------------------
    def _run_continuous_sql(self, sql: str):
        """One continuous-query cycle = one real tracked query: it
        rides admission, the stage DAG, retries, history and the
        system.runtime.queries surface like any client submission."""
        session = Session(catalog="stream", schema="default",
                          user="continuous")
        q = self.tracker.submit(sql, session, source="continuous")
        if not q.wait_done(600.0):
            self.tracker.cancel(q.query_id)
            raise TimeoutError(f"continuous cycle timed out: {sql!r}")
        if q.state != "FINISHED":
            msg = (q.error or {}).get("message", f"query {q.state}")
            raise RuntimeError(msg)
        return q.result

    def leak_report(self, stuck_after_s: float = 3600.0,
                    orphan_grace_s: float = 5.0):
        """Leak and orphan snapshot (server/diagnostics.py)."""
        from .diagnostics import leak_report
        return leak_report(self, stuck_after_s=stuck_after_s,
                           orphan_grace_s=orphan_grace_s)

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: wait for active queries to finish
        (server/GracefulShutdownHandler.java:43,73), then stop."""
        deadline = time.time() + timeout
        for q in self.tracker.running():
            q.wait_done(max(0.0, deadline - time.time()))
        self.stop()
        return not self.tracker.running()


_UI_PAGE = """<!doctype html>
<html><head><title>trino-tpu</title><style>
body{font-family:system-ui,sans-serif;margin:2em;background:#fafafa}
h1{font-size:1.3em} table{border-collapse:collapse;width:100%}
td,th{border:1px solid #ddd;padding:6px 10px;text-align:left;
font-size:0.9em} th{background:#f0f0f0}
.FINISHED{color:#188038}.FAILED{color:#d93025}.RUNNING{color:#1a73e8}
.QUEUED{color:#e37400}.CANCELED{color:#5f6368}
</style></head><body>
<h1>trino-tpu cluster</h1><div id=info></div>
<h2>Queries</h2><table id=q><tr><th>Query ID</th><th>State</th>
<th>User</th><th>Elapsed</th><th>SQL</th></tr></table>
<script>
async function refresh(){
 const info=await (await fetch('/v1/info')).json();
 document.getElementById('info').textContent=
   'node '+info.nodeId+' — uptime '+info.uptime;
 const qs=await (await fetch('/v1/query')).json();
 const t=document.getElementById('q');
 while(t.rows.length>1)t.deleteRow(1);
 for(const q of qs.reverse()){
  const r=t.insertRow(); const c=r.insertCell();
  const a=document.createElement('a');
  a.href='/ui/query.html?'+q.queryId; a.textContent=q.queryId;
  c.appendChild(a);
  const s=r.insertCell(); s.textContent=q.state; s.className=q.state;
  r.insertCell().textContent=q.user||'';
  r.insertCell().textContent=(q.elapsedTimeMillis/1000).toFixed(1)+'s';
  r.insertCell().textContent=q.query.slice(0,120);}}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


_UI_QUERY_PAGE = """<!doctype html>
<html><head><title>query — trino-tpu</title><style>
body{font-family:system-ui,sans-serif;margin:2em;background:#fafafa}
h1{font-size:1.2em} pre{background:#fff;border:1px solid #ddd;
padding:10px;overflow-x:auto;font-size:0.85em}
table{border-collapse:collapse;margin:1em 0}
td,th{border:1px solid #ddd;padding:5px 9px;font-size:0.85em;
text-align:left} th{background:#f0f0f0}
.FINISHED{color:#188038}.FAILED{color:#d93025}.RUNNING{color:#1a73e8}
a{color:#1a73e8;text-decoration:none}
</style></head><body>
<a href="/ui">&larr; queries</a>
<h1 id=title>query</h1><div id=meta></div>
<h2>SQL</h2><pre id=sql></pre>
<h2>Plan</h2><pre id=plan>(not available)</pre>
<h2>Operator stats</h2>
<table id=stats><tr><th>Node</th><th>Wall ms</th><th>Rows</th>
<th>Detail</th></tr></table>
<pre id=error style="color:#d93025;display:none"></pre>
<script>
const qid=location.search.slice(1);
async function refresh(){
 const q=await (await fetch('/v1/query/'+qid)).json();
 document.getElementById('title').innerHTML=
   q.queryId+' — <span class="'+q.state+'">'+q.state+'</span>';
 document.getElementById('meta').textContent=
   'user '+(q.user||'')+' · created '+(q.created||'')+' · elapsed '+
   ((q.elapsedTimeMillis||0)/1000).toFixed(1)+'s'+
   (q.rows!==undefined?' · '+q.rows+' rows':'');
 document.getElementById('sql').textContent=q.query||'';
 if(q.plan)document.getElementById('plan').textContent=
   q.plan.join('\\n');
 const t=document.getElementById('stats');
 while(t.rows.length>1)t.deleteRow(1);
 for(const s of (q.nodeStats||[])){
  const r=t.insertRow(); r.insertCell().textContent=s.node;
  r.insertCell().textContent=s.wallMillis;
  r.insertCell().textContent=s.outputRows;
  r.insertCell().textContent=(s.detail||'').slice(0,100);}
 if(q.error){const e=document.getElementById('error');
  e.style.display='block';
  e.textContent=JSON.stringify(q.error,null,2);}
 if(q.state==='RUNNING'||q.state==='QUEUED')
   setTimeout(refresh,2000);}
refresh();
</script></body></html>"""


def _make_handler(co: Coordinator):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):   # quiet
            pass

        def _send(self, code: int, payload, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_html(self, body: str):
            raw = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def _auth_reject(self, code: int, payload: dict,
                         www: Optional[str] = None) -> bool:
            """Reject the request before the body is consumed: the
            connection must close (keep-alive would parse the unread
            POST body as the next request)."""
            self.close_connection = True
            self._send(code, payload,
                       headers={"WWW-Authenticate": www} if www
                       else None)
            return False

        def _authenticate(self) -> bool:
            """HTTP Basic auth against the configured password
            authenticator (server/security/PasswordAuthenticator
            analog); no authenticator = open access. On success the
            verified principal is recorded and MUST match any
            X-Trino-User header (server/security/
            AuthenticationFilter + the set-user authorization check) —
            session identity never comes from an unverified header."""
            self.principal = None
            if co.authenticator is None:
                return True
            import base64
            header = self.headers.get("Authorization", "")
            if header.startswith("Bearer ") and hasattr(
                    co.authenticator, "authenticate_token"):
                # JWT / bearer tokens (server/security/jwt/
                # JwtAuthenticator.java)
                principal = co.authenticator.authenticate_token(
                    header[7:].strip())
                if principal is not None:
                    claimed = self.headers.get("X-Trino-User")
                    if claimed and claimed != principal:
                        return self._auth_reject(403, {
                            "error": f"Access Denied: User {principal}"
                            f" cannot impersonate {claimed}"})
                    self.principal = principal
                    return True
            if header.startswith("Basic "):
                try:
                    raw = base64.b64decode(header[6:]).decode()
                    user, _, pw = raw.partition(":")
                    if co.authenticator.authenticate(user, pw):
                        claimed = self.headers.get("X-Trino-User")
                        if claimed and claimed != user:
                            return self._auth_reject(403, {
                                "error": f"Access Denied: User {user} "
                                f"cannot impersonate {claimed}"})
                        self.principal = user
                        return True
                except Exception:
                    pass
            return self._auth_reject(
                401, {"error": "Unauthorized"},
                www='Basic realm="trino-tpu"')

        def do_POST(self):
            if not self._authenticate():
                return
            path = urlparse(self.path).path
            if path == "/v1/statement":
                n = int(self.headers.get("Content-Length", 0))
                sql = self.rfile.read(n).decode()
                session = Session(
                    catalog=self.headers.get("X-Trino-Catalog", "tpch"),
                    schema=self.headers.get("X-Trino-Schema", "tiny"),
                    user=(self.principal
                          or self.headers.get("X-Trino-User", "user")))
                for kv in (self.headers.get("X-Trino-Session") or "") \
                        .split(","):
                    if "=" in kv:
                        k, v = kv.split("=", 1)
                        try:
                            session.set(k.strip(), v.strip())
                        except KeyError:
                            pass
                # client-held prepared statements (sessions are
                # per-request; the client replays its registry, the
                # reference's X-Trino-Prepared-Statement contract)
                from urllib.parse import unquote
                for kv in (self.headers.get(
                        "X-Trino-Prepared-Statement") or "").split(","):
                    if "=" in kv:
                        name, v = kv.split("=", 1)
                        session.prepared[name.strip()] = unquote(v)
                try:
                    q = co.tracker.submit(
                        sql, session,
                        source=self.headers.get("X-Trino-Source", ""))
                except Exception as e:   # noqa: BLE001 — a submission
                    # failure outside the tracked-query machinery
                    # (selector bug, bad session property) must answer
                    # with a classified error + mapped status, never
                    # the handler's bare 500 traceback
                    from ..errors import classify, http_status_for
                    name, code, etype = classify(e)
                    self._send(http_status_for(etype), {
                        "error": {"message": str(e), "errorCode": code,
                                  "errorName": name,
                                  "errorType": etype}})
                    return
                q.wait_done(0.05)   # fast queries answer immediately
                self._send(200, co.query_results(q, 0))
                return
            if path == "/v1/announcement":
                # worker join; idempotent, so workers re-announce on a
                # cadence
                n = int(self.headers.get("Content-Length", 0))
                prewarmed = None
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    uri = str(body.get("uri", "")).strip() \
                        if isinstance(body, dict) else ""
                    if isinstance(body, dict) \
                            and "prewarmed" in body:
                        prewarmed = bool(body.get("prewarmed"))
                except (ValueError, TypeError):
                    uri = ""
                if not uri:
                    self._send(400, {"error": "missing worker uri"})
                    return
                joined = co.add_worker(uri, prewarmed=prewarmed)
                self._send(200, {"joined": joined,
                                 "workers": co.live_workers()})
                return
            # /v1/ingest/{topic}: newline-delimited messages into the
            # append-only log (producers hit the coordinator or any
            # worker: the segment files are the shared truth)
            parts = [p for p in path.split("/") if p]
            if len(parts) == 3 and parts[:2] == ["v1", "ingest"]:
                from urllib.parse import parse_qs
                from ..streaming.log import ingest_http
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    self._send(200, ingest_http(
                        co.stream_log, parts[2], body,
                        parse_qs(urlparse(self.path).query)))
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                return
            if path == "/v1/continuous":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    spec = json.loads(self.rfile.read(n) or b"{}")
                    job = co.continuous.create(spec)
                except (ValueError, KeyError) as e:
                    self._send(400, {"error": str(e)})
                    return
                self._send(200, job)
                return
            self._send(404, {"error": "not found"})

        def do_GET(self):
            if not self._authenticate():
                return
            path = urlparse(self.path).path
            parts = [p for p in path.split("/") if p]
            if path == "/metrics":
                from ..obs.metrics import write_exposition
                write_exposition(self)
                return
            if path == "/ui" or path == "/ui/":
                self._send_html(_UI_PAGE)
                return
            if path == "/ui/query.html":
                self._send_html(_UI_QUERY_PAGE)
                return
            if path == "/v1/cluster":
                qs = co.tracker.all()
                out = {
                    "runningQueries": sum(
                        1 for q in qs if q.state == "RUNNING"),
                    "queuedQueries": sum(
                        1 for q in qs if q.state == "QUEUED"),
                    "totalQueries": len(qs),
                    "activeWorkers": len(co.node_infos())}
                if co.memory is not None:
                    # memory-pool state rides the cluster overview
                    # (webapp ClusterStats reservedMemory analog)
                    out["memory"] = co.memory.info()
                self._send(200, out)
                return
            if path == "/v1/info":
                self._send(200, co.info())
                return
            if path == "/v1/query":
                self._send(200, co.query_infos())
                return
            if path == "/v1/announcement":
                detector = co.failure_detector
                self._send(200, {"workers": [
                    {"uri": w,
                     "alive": (detector is None
                               or detector.is_alive(w)),
                     "prewarmed": co.worker_prewarmed.get(w, False)}
                    for w in list(co.workers)]})
                return
            if path == "/v1/hotshapes":
                # the worker pre-warm feed (exec/hotshapes.py): the top-k
                # hottest program shapes this coordinator has seen,
                # ranked by hit count then recency; ?k= bounds the list
                # (default: the hot_shape_top_k session default, the K a
                # joining worker warms before taking traffic)
                from urllib.parse import parse_qs
                from ..exec.hotshapes import HOT_SHAPES
                from ..session import SESSION_PROPERTIES
                qs = parse_qs(urlparse(self.path).query)
                try:
                    k = int((qs.get("k") or [0])[0])
                except ValueError:
                    k = 0
                if k <= 0:
                    k = int(SESSION_PROPERTIES["hot_shape_top_k"][1])
                self._send(200, {"shapes": HOT_SHAPES.top(k),
                                 "tracked": len(HOT_SHAPES)})
                return
            if path == "/v1/history":
                # the durable query-history surface (obs/history.py):
                # ?limit= bounds the page, ?state= filters (FINISHED /
                # FAILED / CANCELED)
                from urllib.parse import parse_qs
                qs = parse_qs(urlparse(self.path).query)
                try:
                    limit = int((qs.get("limit") or [0])[0]) or None
                except ValueError:
                    limit = None
                self._send(200, {
                    "records": co.history.records(
                        limit=limit,
                        state=(qs.get("state") or [None])[0]),
                    "tracked": len(co.history)})
                return
            if path == "/v1/stats":
                # learned operator statistics (exec/learnedstats.py):
                # per (plan key, operator, occurrence) selectivity and
                # throughput EMAs, most recently observed first
                from ..exec.learnedstats import LEARNED_STATS
                self._send(200, {
                    "entries": LEARNED_STATS.snapshot(),
                    "tracked": len(LEARNED_STATS)})
                return
            if path == "/v1/continuous":
                self._send(200, {"jobs": co.continuous_query_infos()})
                return
            if len(parts) == 3 and parts[:2] == ["v1", "continuous"]:
                job = co.continuous.get(parts[2])
                if job is None:
                    self._send(404, {"error": "no such job"})
                    return
                self._send(200, job)
                return
            if path == "/v1/trace":
                # recent trace ids and root-span summaries
                self._send(200, {"traces": co.trace_ring.list()})
                return
            if len(parts) == 3 and parts[:2] == ["v1", "trace"]:
                # the finished query's distributed trace as OTLP/JSON
                # (obs/otlp.py ResourceSpans shape): the pull surface of
                # the export, worker spans under the query's trace id
                # with their true parent span ids, no collector needed.
                # 404 until the query has a trace (still running,
                # untraced, or unknown id).
                q = co.tracker.get(parts[2])
                trace = (getattr(q.result, "trace", None)
                         if q is not None and q.result is not None
                         else None)
                if trace is None or not trace.roots:
                    self._send(404, {"error": "no trace for query"})
                    return
                from ..obs.otlp import trace_to_resource_spans
                self._send(200, trace_to_resource_spans(
                    trace, {"trino_tpu.query_id": q.query_id,
                            "trino_tpu.state": q.state,
                            "service.name": "trino_tpu-coordinator"}))
                return
            if len(parts) == 3 and parts[:2] == ["v1", "query"]:
                q = co.tracker.get(parts[2])
                if q is None:
                    # restart recovery, metadata-only: no slug is
                    # presented here, so serve the manifest without
                    # decoding or pinning the persisted rows
                    detail = co.recovered_query_detail(parts[2])
                    if detail is not None:
                        self._send(200, detail)
                        return
                    self._send(404, {"error": "no such query"})
                    return
                self._send(200, co.query_detail(q))
                return
            # /v1/statement/executing/{id}/{slug}/{token}
            if len(parts) == 6 and parts[:3] == ["v1", "statement",
                                                 "executing"]:
                q = co.tracker.get(parts[3])
                if q is None:
                    # a restarted coordinator serving a query the old
                    # process ran: rebuild it from the spooled manifest
                    # (slug-checked) and keep paging
                    q = co.recover_query(parts[3], parts[4])
                if q is None:
                    # no FINISHED result on the spool: the old
                    # coordinator died mid-flight, so resume the RUNNING
                    # query from its execution manifest and let this
                    # poll long-poll the resumed run
                    q = co.resume_query(parts[3], parts[4])
                if q is None or q.slug != parts[4]:
                    self._send(404, {"error": "no such query"})
                    return
                q.wait_done(1.0)   # long-poll like the reference
                self._send(200, co.query_results(q, int(parts[5])))
                return
            self._send(404, {"error": "not found"})

        def do_DELETE(self):
            if not self._authenticate():
                return
            parsed = urlparse(self.path)
            parts = [p for p in parsed.path.split("/") if p]
            if parsed.path == "/v1/announcement":
                from urllib.parse import parse_qs
                uri = (parse_qs(parsed.query).get("uri") or [""])[0]
                left = co.remove_worker(uri) if uri else False
                self._send(200, {"left": left,
                                 "workers": co.live_workers()})
                return
            if len(parts) == 3 and parts[:2] == ["v1", "continuous"]:
                if co.continuous.cancel(parts[2]):
                    self._send(200, {"canceled": parts[2]})
                else:
                    self._send(404, {"error": "no such job"})
                return
            if len(parts) >= 4 and parts[:2] == ["v1", "statement"]:
                co.tracker.cancel(parts[3])
                if co.results is not None:
                    # the client is done with this query: reap its
                    # spooled restart-recovery results now instead of
                    # waiting out the TTL sweep. The slug is the
                    # per-query capability token — destroying durable
                    # results demands it just like reading them does
                    # (recover_query), or any client that can list
                    # query ids could revoke another client's restart
                    # recoverability.
                    slug = parts[4] if len(parts) >= 5 else None
                    q = co.tracker.get(parts[3])
                    owner = q.slug if q is not None else None
                    if owner is None:
                        mf = co.results.load_manifest(parts[3])
                        owner = str(mf.get("slug")) if mf else None
                    if slug is not None and slug == owner:
                        co.results.release(parts[3])
                        if co.manifests is not None:
                            # an abandoned query must not be resumable
                            co.manifests.release(parts[3])
                    elif slug is not None and co.manifests is not None:
                        # the presented slug may still match the
                        # execution manifest of a query whose
                        # coordinator died mid-flight: reap it under
                        # its own slug, never anyone else's
                        if co.manifests.load(parts[3],
                                             slug=slug) is not None:
                            co.manifests.release(parts[3])
                # 204 carries no body (RFC 7230; a body would desync
                # keep-alive clients)
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self._send(404, {"error": "not found"})

    return Handler
