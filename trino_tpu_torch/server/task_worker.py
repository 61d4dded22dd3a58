"""The task worker and its host data plane.

Counterpart of ``trino_tpu/server/task_worker.py`` (host code) over the
port's executor on one torch device. A worker process accepts tasks
(POST /v1/task/{id}: a serialised plan fragment with its split share, or
a SQL string), runs each on its device (``cuda`` unless the caller
passes ``device="cpu"``; an error without a card) through the shared
split scheduler (exec/taskexec.py), and buffers the result as page
frames (serde.py) that the coordinator pulls token by token
(GET /v1/task/{id}/results/{token}). A stage task cuts its output into
partition frames on the card (stage/repartition.py) and commits them to
the spool, which /v1/partition serves to consumers on other hosts.
/v1/task/{id} answers the task's status (state, node stats, spans, live
and peak memory), /metrics the worker's registry, /v1/info its liveness;
producers may POST /v1/ingest/{topic} to any worker (streaming/log.py).
Each task's memory context counts the bytes its executor reserves and,
on a card, the bytes the card holds beyond those it held when the task
began; the status beats carry them to the coordinator's pool. A task's
status also carries the program shapes it recorded (``hotShapes``,
exec/hotshapes.py), and a worker that announces itself with ``prewarm``
warms the coordinator's hottest shapes first (``prewarm_from``,
exec/aot.py) and then announces ``prewarmed``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional

import torch

from ..columnar import Batch, map_row_lanes
from ..config import DeviceLike, resolve_device
from ..obs.metrics import METRICS
from ..serde import deserialize_batch, serialize_batch

PAGE_ROWS = 1 << 16

# exchange data-plane metrics (reference: ExchangeClient /
# ExchangeOperator JMX stats); "sent" counts frames buffered by this
# worker, "received" counts frames pulled by this process's clients
_M_PAGES = METRICS.counter(
    "trino_tpu_exchange_pages_total",
    "Exchange page frames by direction", ("direction",))
_M_PAGE_BYTES = METRICS.counter(
    "trino_tpu_exchange_bytes_total",
    "Serialized exchange bytes by direction", ("direction",))
_M_TASKS = METRICS.counter(
    "trino_tpu_worker_tasks_total",
    "Tasks executed by this worker, by terminal state", ("state",))
_M_TASKS_ABORTED = METRICS.counter(
    "trino_tpu_worker_tasks_aborted_total",
    "Tasks aborted by a coordinator DELETE while still tracked on "
    "this worker: user cancels, deadline breaches, attempt timeouts, "
    "and attempts superseded by a winning sibling")

from ..obs.metrics import WORKER_BUSY_REJECTS as _M_BUSY  # noqa: E402


class WorkerBusyError(Exception):
    """Raised by ``create_task`` when the worker sheds load under
    sustained pressure (open tasks past the shed threshold, or the
    worker memory budget breached). Surfaces as HTTP 503 — a
    RETRYABLE decline the dispatching scheduler's existing retry/
    rotation machinery absorbs by re-placing the task on another
    worker (no failure-detector demerit: a busy worker is healthy)."""


def _slice_batch(b: Batch, lo: int, hi: int) -> Batch:
    """Rows [lo, hi) as views of the lanes, on their device; the flat
    pools ride whole (sliced offsets still index into them)."""
    return Batch({s: map_row_lanes(c, lambda t: t[lo:hi])
                  for s, c in b.columns.items()}, hi - lo)


def paginate(b: Batch, page_rows: int = PAGE_ROWS,
             codec: Optional[int] = None) -> List[bytes]:
    """Serialize a result batch as page frames (PagesSerde.serialize).
    Array results ship as a single frame: offsets reference the shared
    flat elements column, so slicing rows would re-ship the whole
    elements buffer once per page. ``codec`` None picks the default
    (LZ4); the
    exchange_compression session property passes CODEC_STORE."""
    n = b.num_rows_host()
    if n == 0:
        frames = [serialize_batch(_slice_batch(b, 0, 0), codec=codec)]
    elif any(c.elements is not None or c.children is not None
             for c in b.columns.values()):
        frames = [serialize_batch(_slice_batch(b, 0, n), codec=codec)]
    else:
        frames = [
            serialize_batch(_slice_batch(b, lo, min(lo + page_rows, n)),
                            codec=codec)
            for lo in range(0, n, page_rows)]
    _M_PAGES.inc(len(frames), direction="sent")
    _M_PAGE_BYTES.inc(sum(len(f) for f in frames), direction="sent")
    return frames


class _TaskMemoryContext:
    """Worker-side ``session.memory``: records the task's live
    high-water reservation (the figure ``liveMemoryBytes`` status
    beats stream back to the coordinator's cluster pool DURING
    execution) and triggers worker-local cache-pressure relief. It
    never enforces — the coordinator pool owns kill verdicts, and a
    kill reaches this task as a DELETE."""

    __slots__ = ("_task", "_worker", "_device", "_base")

    def __init__(self, task: "_Task", worker, device: torch.device):
        self._task = task
        self._worker = worker
        self._device = device
        # the card's allocated bytes when the task began: what the card
        # holds beyond them counts toward the task
        self._base = (torch.cuda.memory_allocated(device)
                      if device.type == "cuda" else 0)

    def reserve(self, nbytes: int) -> None:
        t = self._task
        if self._device.type == "cuda":
            nbytes = max(int(nbytes), torch.cuda.memory_allocated(
                self._device) - self._base)
        if int(nbytes) > t.live_memory_bytes:
            t.live_memory_bytes = int(nbytes)
            if self._worker is not None:
                self._worker.relieve_memory_pressure()

    def budget_bytes(self):
        """The worker-local byte budget (streaming engagement consults
        this exactly like the coordinator pool's budget); None when
        worker-local governance is off."""
        from ..config import CONFIG
        b = int(CONFIG.worker_memory_bytes or 0)
        return b if b > 0 else None


class _Task:
    """One task's lifecycle + output buffer (execution/SqlTask.java +
    the ClientBuffer token protocol)."""

    def __init__(self, task_id: str, attempt: int = 0, spool=None,
                 catalogs=None, worker=None,
                 device: Optional[torch.device] = None):
        self.task_id = task_id
        # the torch device the task runs on (its worker's)
        self.device = device if device is not None \
            else resolve_device(None)
        # the owning TaskWorkerServer: carries the shared split
        # scheduler (exec/taskexec.py) this task's execution is
        # time-sliced through; None for schedulerless embedding
        self.worker = worker
        # live high-water reservation (bytes) of this task's executor,
        # updated DURING execution by _TaskMemoryContext and served in
        # every status response — the worker->coordinator live memory
        # feed
        self.live_memory_bytes = 0
        # the worker's shared CatalogManager (etc/catalog configs —
        # None falls back to the runner's built-in defaults): a
        # fragment naming an operator-configured catalog must resolve
        # it here exactly as it would on the coordinator
        self.catalogs = catalogs
        # fault-tolerant execution: which attempt of its (fragment,
        # part) this task is (exec/remote.py re-dispatches failed
        # tasks with fresh attempt ids), and the spool its completed
        # output is committed to so it survives task eviction
        self.attempt = attempt
        self.spool = spool
        # committed-attempt directory, cached at commit time: the
        # X-TT-Spool-Dir header is constant once the task commits, so
        # page GETs must not re-read the COMMITTED marker per request
        self.spool_dir: Optional[str] = None
        self.state = "RUNNING"
        self.error: Optional[str] = None
        self.pages: List[bytes] = []
        self.node_stats: List[dict] = []   # NodeStats.to_dict per node
        self.spans: List[dict] = []        # worker-local span tree
        # learned-stats observation delta (exec/learnedstats.py):
        # per-operator rows-in/rows-out/wall this task observed, keyed
        # by the fragment's canonical plan key — the coordinator's
        # registry merges these from the status beat (origin-deduped)
        self.learned_stats: List[dict] = []
        # program shapes this task recorded (exec/hotshapes.py delta):
        # they ride back in the task status, so the coordinator's
        # registry covers every dispatched fragment's shapes
        self.hot_shapes: List[dict] = []
        self.peak_memory_bytes = 0
        self.spill_bytes = 0
        # morsel streaming (exec/streamjoin.py): chunk count + h2d
        # bytes this task's streamed operators moved, rolled up by the
        # schedulers next to peak memory
        self.stream_chunks = 0
        self.stream_h2d_bytes = 0
        # ragged batching (exec/taskexec.py RaggedBatcher): chains this
        # task served through a co-batched group, rolled up per query
        self.ragged_batched = 0
        # scheduler attribution: thread-CPU seconds the shared split
        # scheduler accounted to this task's quanta (exec/taskexec.py
        # TaskHandle.cpu_s; a raw thread_time delta without a
        # scheduler), rolled into the trace and the EXPLAIN ANALYZE
        # stage rollup
        self.cpu_seconds = 0.0
        # distributed tracing: the query's 128-bit trace id this
        # task's spans were born with (from the traceparent the
        # payload carried); None when the task was untraced
        self.trace_id: Optional[str] = None
        self.done = threading.Event()
        # coordinator-side abort (DELETE /v1/task): flips the running
        # task's cooperative cancel — the executor stops between plan
        # nodes and a pipelined consumer's eager exchange pull stops
        # polling instead of spinning out remote_task_timeout against
        # a query that already failed
        self.cancel_ev = threading.Event()

    def run(self, payload: dict):
        import time as _time
        from ..exec.hotshapes import HOT_SHAPES
        from ..exec.learnedstats import LEARNED_STATS
        shapes_before = HOT_SHAPES.hit_counts()
        lstats_before = LEARNED_STATS.seq()
        handle = None
        cpu0 = _time.thread_time()
        try:
            from ..runner import LocalQueryRunner
            from ..session import Session
            session = Session(catalog=payload.get("catalog"),
                              schema=payload.get("schema"),
                              cancel=self.cancel_ev)
            for name, value in payload.get("properties", {}).items():
                session.set(name, value)
            if self.worker is not None:
                # shared split scheduler (exec/taskexec.py): every
                # task registers with its query identity (the task-id
                # prefix groups all of one dispatch's tasks) and its
                # resource group's fair-share weight; execution only
                # proceeds while holding one of the worker's bounded
                # runner slots, yielded at split/chunk boundaries
                handle = self.worker.task_executor.register(
                    self.task_id.split(".", 1)[0], self.task_id,
                    group=str(payload.get("resource_group")
                              or "global"),
                    weight=float(payload.get("group_weight") or 1.0),
                    cancel=self.cancel_ev)
                session.split_yield = handle.checkpoint
                # ragged batch formation (exec/taskexec.py
                # RaggedBatcher): both the leader's window sleep and a
                # member's result wait release the runner slot; members
                # holding every slot would deadlock the leader's
                # re-acquire
                session.slot_wait = handle.run_blocked
            # live memory accounting: the executor's reservations land
            # on this task (status beats carry them to the
            # coordinator's pool) and arm worker-local cache relief
            session.memory = _TaskMemoryContext(self, self.worker,
                                                self.device)
            # deadline propagation (server/coordinator.py -> exec/
            # remote.py): the coordinator ships the REMAINING budget
            # (relative seconds — wall clocks differ across hosts) and
            # the worker re-derives an absolute deadline, so its own
            # executor stops between plan nodes once the query's
            # wall-clock budget is spent
            rem = payload.get("deadline_s")
            if rem is not None:
                import time as _time
                session.deadline = _time.monotonic() + max(
                    float(rem), 0.0)
            # per-node stats + spans ride back in the task status (the
            # reference's TaskStatus/TaskStats carrying OperatorStats
            # to the coordinator for the stage rollup)
            collect = bool(payload.get("collect_stats"))
            stage = None
            if "fragment" in payload:
                # serialized PlanFragment + split share — the remote
                # task path (reference: SqlTaskManager.java:370-403
                # executing a TaskUpdateRequest's fragment)
                from ..exec.executor import Executor
                from ..obs.trace import QueryTrace
                from ..plan.serde import from_jsonable
                from ..plan.nodes import PartitionedOutputNode
                runner = LocalQueryRunner(session=session,
                                          device=self.device,
                                          catalogs=self.catalogs)
                plan = from_jsonable(payload["fragment"])
                # receiving-side sanity check: the coordinator proved
                # serde round-trip stability before dispatch, so a
                # violation HERE means the bytes changed in transit or
                # the worker runs a drifted plan-IR version — fail the
                # attempt with the validator named instead of tracing
                # a corrupt plan (the failure is retriable on another
                # worker like any task error)
                from ..analysis.sanity import PlanSanityChecker
                PlanSanityChecker().validate(plan, "worker-decode")
                # distributed tracing: the task payload
                # carries a W3C traceparent naming the query's trace
                # id and the coordinator's pre-minted span id for THIS
                # task — worker spans are born inside the query's
                # trace with their true parent, so the coordinator's
                # graft is an id-preserving merge, not a clock rebase
                trace = None
                if collect:
                    ctx = QueryTrace.parse_traceparent(
                        payload.get("traceparent"))
                    trace = QueryTrace(
                        self.task_id,
                        trace_id=ctx[0] if ctx else None,
                        parent_span_id=ctx[1] if ctx else None)
                    self.trace_id = trace.trace_id  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                session.trace = trace
                ex = Executor(runner.catalogs, session, self.device,
                              collect_stats=collect)
                ex.scan_partition = (int(payload["part"]),
                                     int(payload["nparts"]))
                # stage-DAG task (trino_tpu/stage/): RemoteSource
                # leaves pull this task's partition of every upstream
                # task through the spool / partition endpoint, and the
                # PartitionedOutputNode root is peeled — partitioning
                # happens below, at the page boundary
                stage = payload.get("stage")
                body = plan
                if stage is not None:
                    from ..stage.exchange import ExchangePuller
                    puller = ExchangePuller(
                        stage.get("sources") or {},
                        part=int(payload["part"]), spool=self.spool,
                        timeout_s=float(
                            session.get("remote_task_timeout")),
                        cancel=self.cancel_ev, device=self.device)
                    if handle is not None:
                        # a pipelined consumer blocked on an upstream
                        # commit must not hold a runner slot: bounded
                        # runners would otherwise deadlock a producer
                        # behind its own consumer
                        ex.exchange_reader = (
                            lambda fid: handle.run_blocked(
                                puller.read_fragment, fid))
                    else:
                        ex.exchange_reader = puller.read_fragment
                    if isinstance(plan, PartitionedOutputNode):
                        body = plan.source
                if handle is not None:
                    handle.acquire()   # wait for a fair-share slot
                if trace is not None:
                    with trace.span("task_execute",
                                    task=self.task_id):
                        res = ex.execute(body)
                    self.spans = trace.to_dicts()  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes; status readers wait on done
                else:
                    res = ex.execute(body)
                self.node_stats = [s.to_dict() for s in ex.stats]  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                if collect and ex.stats:
                    # learned stats: observe this fragment's operator
                    # flow under the fragment body's canonical key (the
                    # peeled plan — the program the executor actually
                    # ran); exported as a delta in the finally below
                    from ..exec.learnedstats import (plan_key_for,
                                                     record_node_stats)
                    try:
                        record_node_stats(plan_key_for(body), ex.stats,
                                          session)
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
                self.peak_memory_bytes = ex.peak_reserved_bytes  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                self.spill_bytes = ex.spilled_bytes  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                self.stream_chunks = ex.stream_chunks  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                self.stream_h2d_bytes = ex.stream_h2d_bytes  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                self.ragged_batched = ex.ragged_batched  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
            else:
                runner = LocalQueryRunner(session=session,
                                          device=self.device,
                                          catalogs=self.catalogs)
                if handle is not None:
                    handle.acquire()   # wait for a fair-share slot
                res = runner.execute_batch(payload["sql"])
            if self.device.type == "cuda":
                # the result's lanes may still be written by work queued
                # on another stream (the chunk copies of
                # exec/streamjoin.py): finish it before the copies out
                torch.cuda.synchronize(self.device)
            codec = None
            if not bool(session.get("exchange_compression")):
                from ..serde import CODEC_STORE
                codec = CODEC_STORE
            if stage is not None:
                # partitioned output: exactly one frame per downstream
                # task (frame i == partition i), committed to the spool
                # under the attempt-independent exchange key — the
                # spool IS the shuffle medium here, so an unwritable
                # spool must FAIL the attempt (the output would be
                # unreachable), unlike the best-effort legacy commit
                from ..stage.repartition import partition_frames
                from ..plan.nodes import PartitionedOutputNode as _PO
                keys, kind = (), "gather"
                if isinstance(plan, _PO):
                    keys, kind = plan.partition_keys, plan.kind
                self.pages = partition_frames(  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                    res, keys, kind,
                    int(stage.get("nparts_out") or 1), codec=codec,
                    session=session)
                self.spool.commit(str(stage["exchange_key"]), 0, 0,
                                  self.attempt, self.pages)
            else:
                self.pages = paginate(res, codec=codec)  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                if self.spool is not None:
                    # durable output: completed pages outlive the
                    # in-memory task entry, so an aborted/evicted
                    # task's consumer can still re-read them through
                    # /v1/spool (the exchange-spooling half of
                    # fault-tolerant execution)
                    try:
                        self.spool.commit(self.task_id, 0, 0,
                                          self.attempt, self.pages)
                        getdir = getattr(self.spool, "attempt_dir",
                                         None)
                        if getdir is not None:
                            self.spool_dir = getdir(self.task_id, 0, 0)  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
            self.state = "FINISHED"  # tt-lint: ignore[race-attr-write] races only with abort's CANCELED stamp; either terminal state is valid, done.set() publishes
        except Exception as e:   # noqa: BLE001
            self.state = "FAILED"  # tt-lint: ignore[race-attr-write] races only with abort's CANCELED stamp; either terminal state is valid, done.set() publishes
            self.error = f"{type(e).__name__}: {e}"  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
        finally:
            if handle is not None:
                handle.close()      # release the runner slot + the
                #                     scheduler's per-query accounting
                # scheduler-accounted CPU: the sum of this task's
                # quantum stamps (finalized by close() above)
                self.cpu_seconds = float(handle.cpu_s)  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
            else:
                # schedulerless embedding: the raw thread-CPU delta of
                # the whole run is the best available figure
                self.cpu_seconds = max(  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                    _time.thread_time() - cpu0, 0.0)
            try:
                # observation DELTAS since the task started, original
                # origins preserved — the coordinator-side merge skips
                # its own (shared-process workers) without losing a
                # remote worker's genuine observations
                self.learned_stats = LEARNED_STATS.export_delta(lstats_before)  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
                self.hot_shapes = HOT_SHAPES.export_delta(shapes_before)  # tt-lint: ignore[race-attr-write] task-thread-private until done.set() publishes
            except Exception:    # noqa: BLE001
                pass
            _M_TASKS.inc(state=self.state)
            self.done.set()


class TaskWorkerServer:
    """A worker node: accepts tasks, executes them on ``device`` (cuda
    unless the caller passes "cpu"; an error without a card), serves
    result pages. One process per worker, or several in one process."""

    def __init__(self, port: int = 0, spool_dir: Optional[str] = None,
                 spool_backend: Optional[str] = None, catalogs=None,
                 task_runners: Optional[int] = None,
                 busy_shed_factor: Optional[int] = None,
                 busy_shed_ema_s: Optional[float] = None,
                 device: DeviceLike = None, task_executor=None):
        self.device = resolve_device(device)
        self._tasks: Dict[str, _Task] = {}
        self._lock = threading.Lock()
        # shared split scheduler (exec/taskexec.py): ONE bounded
        # runner pool time-slices every concurrent query's task
        # splits/chunks with multilevel fair-share priority —
        # ``task_runners`` (default CONFIG.task_runner_threads; 0 =
        # max(4, 2 x cores)) bounds how many tasks EXECUTE at once
        import os as _os
        from ..config import CONFIG
        from ..exec.taskexec import TaskExecutor
        n = (int(task_runners) if task_runners is not None
             else int(CONFIG.task_runner_threads))
        if n <= 0:
            n = max(4, 2 * (_os.cpu_count() or 1))
        # busy_shed_ema_s: time constant of the queue-depth EMA the
        # shed decision smooths through (0 = spot value, the pre-EMA
        # behavior tests pin; default CONFIG.busy_shed_ema_s)
        # workers that share one interpreter may share one scheduler
        # (``task_executor``): their tasks then take turns at split
        # boundaries instead of contending for the interpreter lock
        self.task_executor = (task_executor if task_executor is not None
                              else TaskExecutor(n, ema_tau_s=busy_shed_ema_s))
        self.busy_shed_factor = (
            int(busy_shed_factor) if busy_shed_factor is not None
            else int(CONFIG.busy_shed_factor))
        # operator-configured catalogs (etc/catalog via
        # main.build_catalogs), or the runner's defaults, built once: a
        # standalone worker must resolve the same catalog names the
        # coordinator dispatches, and its tasks share the connectors,
        # so the scan cache (keyed by connector) serves them all
        if catalogs is None:
            from ..runner import LocalQueryRunner
            catalogs = LocalQueryRunner(device=self.device).catalogs
        self.catalogs = catalogs
        # worker-side spool (fte/spool.py): tasks submitted with
        # "spool": true commit their output pages here, keyed by task
        # id, and /v1/spool serves them even after the task is evicted.
        # Backend per arg/config (make_spool); for the local backend
        # the base is kept SEPARATE from the coordinator's (task-id
        # keys vs query-id keys) so neither side's TTL sweep can reap
        # the other's live entries. Non-local backends skip the
        # X-TT-Spool-Dir coalescing hint (no directory to link from).
        from ..fte.spool import make_spool, worker_spool_base
        self.spool = make_spool(
            spool_backend,
            local_base_dir=spool_dir or worker_spool_base())
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                parts = self.path.strip("/").split("/")
                # /v1/task/{id}
                if len(parts) == 3 and parts[:2] == ["v1", "task"]:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    # W3C context propagation: the traceparent rides
                    # the HTTP header AND the payload; the header is
                    # the fallback for payloads built by clients that
                    # predate the field
                    tp = self.headers.get("traceparent")
                    if tp and "traceparent" not in payload:
                        payload["traceparent"] = tp
                    try:
                        t = worker.create_task(parts[2], payload)
                    except WorkerBusyError as e:
                        # graceful degradation: a 503 is the RETRYABLE
                        # busy signal — the scheduler re-places the
                        # task on another worker without demeriting
                        # this one in the failure detector
                        body = json.dumps(
                            {"error": str(e), "busy": True}).encode()
                        self.send_response(503)
                        self.send_header("Content-Type",
                                         "application/json")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    body = json.dumps(
                        {"taskId": t.task_id, "state": t.state}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # /v1/ingest/{topic}: any worker accepts producer
                # appends; segment files under the shared stream dir
                # are the source of truth, so the coordinator's scans
                # see worker-side ingests with no forwarding hop
                from urllib.parse import parse_qs, urlparse
                parsed = urlparse(self.path)
                route = [p for p in parsed.path.split("/") if p]
                if len(route) == 3 and route[:2] == ["v1", "ingest"]:
                    from ..streaming.log import get_log, ingest_http
                    n = int(self.headers.get("Content-Length", 0))
                    data = self.rfile.read(n)
                    try:
                        out = ingest_http(get_log(), route[2], data,
                                          parse_qs(parsed.query))
                        code = 200
                    except ValueError as e:
                        out, code = {"error": str(e)}, 400
                    body = json.dumps(out).encode()
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_error(404)

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                # /v1/task/{id}/results/{token}
                if len(parts) == 5 and parts[3] == "results":
                    tid, token = parts[2], int(parts[4])
                    t = worker.get_task(tid)
                    if t is None:
                        self.send_error(404)
                        return
                    # short-poll: a still-running task answers 202 so
                    # the puller can notice cancellation between polls
                    # (reference: TaskResource's bounded long-poll)
                    if not t.done.wait(timeout=2.0) \
                            and t.state == "RUNNING":
                        self.send_response(202)
                        # live memory beat for the flat dispatch path:
                        # the puller's 202 polls carry the task's live
                        # reservation so the coordinator pool sees
                        # worker bytes DURING execution (the stage
                        # path reads the same figure off the status
                        # JSON its wait_done polls)
                        self.send_header("X-TT-Live-Memory",
                                         str(t.live_memory_bytes))
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    if t.state != "FINISHED":
                        # still RUNNING (wait timed out), FAILED, or
                        # CANCELED — never report an empty complete
                        # result for a task that didn't finish
                        body = (t.error
                                or f"task is {t.state}").encode()
                        self.send_response(500)
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    complete = token >= len(t.pages)
                    body = b"" if complete else t.pages[token]
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("X-TT-Complete",
                                     "true" if complete else "false")
                    self.send_header("X-TT-Next-Token", str(token + 1))
                    if t.spool_dir:
                        # same-host coalescing hint: where this task's
                        # committed frames live on disk, so a consumer
                        # sharing the filesystem can hard-link instead
                        # of re-writing them (LocalDirSpool
                        # .commit_linked). Meaningless (and ignored)
                        # across hosts — the path won't exist there.
                        # Cached on the task at commit (constant from
                        # then on; no marker read per page GET).
                        self.send_header("X-TT-Spool-Dir", t.spool_dir)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # /v1/spool/{task_id}/{token}: committed output pages
                # of a (possibly evicted) task, straight off the spool
                # — same complete/next-token protocol as /results
                if len(parts) == 4 and parts[:2] == ["v1", "spool"]:
                    tid, token = parts[2], int(parts[3])
                    # frame-at-a-time off the spool: reading the whole
                    # committed set per token request would make an
                    # N-page pull O(N^2) disk I/O and overcount the
                    # spool-read byte metric by ~N x
                    nframes = worker.spool.frame_count(tid, 0, 0)
                    if nframes is None:
                        self.send_error(404)
                        return
                    complete = token >= nframes
                    body = (b"" if complete else
                            worker.spool.read_frame(tid, 0, 0, token))
                    if body is None:     # reaped between count & read
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("X-TT-Complete",
                                     "true" if complete else "false")
                    self.send_header("X-TT-Next-Token", str(token + 1))
                    getdir = getattr(worker.spool, "attempt_dir", None)
                    if complete and getdir is not None:
                        # evicted-task path has no cached _Task entry;
                        # the consumer only needs the hint once, so pay
                        # the marker read on the final response alone
                        # (local backend only — object-store spools
                        # have no directory to link from)
                        sdir = getdir(tid, 0, 0)
                        if sdir:
                            self.send_header("X-TT-Spool-Dir", sdir)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # /v1/partition/{exchange_key}/{index}: ONE partition
                # frame of a committed stage-task attempt, straight
                # off the spool — the serve half of the worker-to-
                # worker exchange (consumers on a shared spool never
                # call this; it is the cross-host leg). 404 until the
                # attempt commits: the scheduler only advertises
                # FINISHED tasks, so a 404 here means eviction/reap —
                # a retriable consumer-attempt failure.
                if len(parts) == 4 and parts[:2] == ["v1", "partition"]:
                    key, index = parts[2], int(parts[3])
                    frame = worker.spool.read_frame(key, 0, 0, index)
                    if frame is None:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length",
                                     str(len(frame)))
                    self.end_headers()
                    self.wfile.write(frame)
                    return
                # /v1/task/{id} -> status (incl. the worker-side
                # operator stats + span tree for the stage rollup)
                if len(parts) == 3 and parts[:2] == ["v1", "task"]:
                    # deterministic chaos site: a raise here turns into
                    # the 503 a coordinator sees from a worker whose
                    # status surface is wedged (delay models a stalled
                    # beat; crash kills the worker process outright)
                    from ..fte.faultpoints import (FaultInjected,
                                                   fault_point)
                    try:
                        fault_point("worker.pre_status_beat")
                    except FaultInjected:
                        self.send_error(503)
                        return
                    t = worker.get_task(parts[2])
                    if t is None:
                        self.send_error(404)
                        return
                    body = json.dumps(
                        {"taskId": t.task_id,
                         "state": t.state,
                         "attempt": t.attempt,
                         "error": t.error,
                         "nodeStats": t.node_stats,
                         "spans": t.spans,
                         "learnedStats": t.learned_stats,
                         "hotShapes": t.hot_shapes,
                         "peakMemoryBytes": t.peak_memory_bytes,
                         "liveMemoryBytes": t.live_memory_bytes,
                         "spillBytes": t.spill_bytes,
                         "streamChunks": t.stream_chunks,
                         "streamH2dBytes": t.stream_h2d_bytes,
                         "raggedBatched": t.ragged_batched,
                         "cpuSeconds": t.cpu_seconds,
                         "traceId": t.trace_id}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path.split("?")[0] == "/metrics":
                    from ..obs.metrics import write_exposition
                    write_exposition(self)
                    return
                # liveness surface: the coordinator's heartbeat
                # failure detector probes /v1/info (server/failure.py
                # _http_probe expects a JSON 200). Without it a REAL
                # worker process is declared dead after the warmup
                # probes and the coordinator silently stops
                # dispatching to it — found driving the multi-process
                # cluster, invisible to in-process tests whose
                # feedback-only detectors never probe.
                if self.path.split("?")[0] == "/v1/info":
                    info = {"nodeId": worker.node_id,
                            "uri": worker.base_uri,
                            "coordinator": False,
                            "state": "active",
                            "device": str(worker.device)}
                    if worker.device.type == "cuda":
                        # the card's bytes this process holds and its
                        # peak (a worker process is a CUDA context)
                        info["memoryAllocatedBytes"] = \
                            torch.cuda.memory_allocated(worker.device)
                        info["memoryPeakBytes"] = \
                            torch.cuda.max_memory_allocated(worker.device)
                    body = json.dumps(info).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_error(404)

            def do_DELETE(self):
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[:2] == ["v1", "task"]:
                    worker.abort_task(parts[2])
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_error(404)

        from .coordinator import HTTPServer
        self._httpd = HTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self.base_uri = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None
        # live membership (discovery/Announcer.java analog): when told
        # a coordinator, the worker announces itself now and on a
        # cadence — re-announcement is idempotent at the coordinator
        # and doubles as re-registration after a coordinator restart
        self._announce_stop = threading.Event()
        self._announced_to: Optional[str] = None
        self._announce_token: Optional[str] = None
        self._announce_thread: Optional[threading.Thread] = None
        # serializes every announce beat with stop()'s graceful leave:
        # a beat that already passed its stop check must finish BEFORE
        # the leave is sent, or the late announce would resurrect the
        # registration the coordinator just removed (the worker never
        # re-leaves — a phantom member until the failure detector
        # notices)
        self._announce_lock = threading.Lock()
        # the pre-warm (exec/aot.py): a joining worker pulls the
        # coordinator's hot shapes and warms the top-K on a background
        # thread; ``prewarm_ready`` rides every announce payload, under
        # a lock against the announce loop reading it mid-flip
        self._prewarm_lock = threading.Lock()
        self.prewarm_ready = False
        self.prewarm_summary: Optional[dict] = None
        import uuid as _uuid
        self.node_id = f"worker-{_uuid.uuid4().hex[:8]}"

    # -- task manager (SqlTaskManager) --------------------------------
    def live_task_bytes(self) -> int:
        """Sum of RUNNING tasks' live high-water reservations — the
        worker-local half of the memory-governance arithmetic.
        Finished tasks stay in the registry to serve status/pages,
        but their memory is free: counting them would eventually trip
        the shed/relief thresholds on a long-lived worker."""
        with self._lock:
            return sum(t.live_memory_bytes
                       for t in self._tasks.values()
                       if t.state == "RUNNING")

    def relieve_memory_pressure(self) -> None:
        """Worker-local cache governance: when live task reservations
        plus shared-cache residency exceed the worker memory budget
        (CONFIG.worker_memory_bytes), shed cache entries — caches
        yield to queries, never the other way around. No-op when the
        budget is 0 (the coordinator pool still governs globally)."""
        from ..config import CONFIG
        budget = int(CONFIG.worker_memory_bytes or 0)
        if budget <= 0:
            return
        from ..exec.executor import (cache_memory_bytes,
                                     evict_cache_pressure)
        usage = self.live_task_bytes() + cache_memory_bytes()
        if usage > budget:
            evict_cache_pressure(usage - budget)

    def _shed_reason(self) -> Optional[str]:
        """Non-None when this worker should decline NEW dispatches
        with the retryable BUSY signal (graceful degradation): the
        EMA-smoothed open-task count past busy_shed_factor x runner
        slots, or the worker memory budget breached by live
        reservations alone. The factor threshold is the FLOOR (spot
        count must also exceed it — shedding never fires below the
        static cap), and the EMA gate means a momentary dispatch
        burst rides through while sustained overload still sheds
        (a static threshold flapped on bursts)."""
        factor = int(self.busy_shed_factor or 0)
        if factor > 0:
            open_tasks = self.task_executor.open_tasks()
            cap = factor * self.task_executor.runners
            if open_tasks >= 2 * cap:
                # hard ceiling regardless of the EMA: the smoothing
                # tolerates a burst WITHIN [cap, 2*cap), never an
                # unbounded pile-up while the EMA catches up — a cold
                # worker fanned the whole cluster's dispatch must
                # still push back
                return (f"{open_tasks} open tasks >= hard ceiling "
                        f"{2 * cap} (2 x shed threshold; EMA "
                        "smoothing does not apply)")
            if open_tasks >= cap:
                ema = self.task_executor.open_tasks_ema()
                if ema >= cap:
                    return (f"open-task EMA {ema:.1f} (spot "
                            f"{open_tasks}) >= shed threshold {cap} "
                            f"({self.task_executor.runners} runners "
                            f"x factor {factor})")
        from ..config import CONFIG
        budget = int(CONFIG.worker_memory_bytes or 0)
        if budget > 0:
            live = self.live_task_bytes()
            if live > budget:
                return (f"live task reservations {live} bytes over "
                        f"the worker memory budget {budget}")
        return None

    def create_task(self, tid: str, payload: dict) -> _Task:
        try:      # reap expired spooled output (time-gated internally)
            self.spool.maybe_cleanup()
        except Exception:        # noqa: BLE001
            pass
        with self._lock:
            t = self._tasks.get(tid)
        if t is not None:
            return t          # idempotent update (TaskResource) —
            #                   never shed a re-POST of a known task
        reason = self._shed_reason()
        if reason is not None:
            _M_BUSY.inc()
            raise WorkerBusyError(
                f"worker {self.base_uri} is shedding load: {reason}")
        with self._lock:
            t = self._tasks.get(tid)
            if t is not None:
                return t          # idempotent update (TaskResource)
            t = _Task(tid, attempt=int(payload.get("attempt") or 0),
                      # a stage task ALWAYS spools: the spool is the
                      # exchange medium its consumers read
                      spool=(self.spool if payload.get("spool")
                             or payload.get("stage") else None),
                      catalogs=self.catalogs, worker=self,
                      device=self.device)
            self._tasks[tid] = t
        threading.Thread(target=t.run, args=(payload,),
                         daemon=True).start()
        return t

    def get_task(self, tid: str) -> Optional[_Task]:
        with self._lock:
            return self._tasks.get(tid)

    def abort_task(self, tid: str):
        with self._lock:
            t = self._tasks.pop(tid, None)
        if t is not None:
            t.state = "CANCELED"
            t.cancel_ev.set()   # stop the running thread's executor
            #                     and its eager exchange pulls too
            t.done.set()
            # a coordinator-side stop (cancel, deadline breach, or a
            # superseded attempt) reached THIS worker and ended a live
            # task, observable in /metrics
            _M_TASKS_ABORTED.inc()

    # -- membership ---------------------------------------------------
    def _is_prewarmed(self) -> bool:
        with self._prewarm_lock:
            return self.prewarm_ready

    def prewarm_from(self, coordinator_uri: str,
                     top_k: Optional[int] = None,
                     token: Optional[str] = None) -> dict:
        """Pull the coordinator's hot-shape list and warm it on this
        worker's device (exec/aot.py): the announce hook that turns a
        cold joiner warm before its first fragment arrives. Sets
        ``prewarm_ready`` even when the list is empty or a shape fails:
        readiness means "the warm-up ran", not "every shape warmed" (a
        coordinator with no history must not leave its fleet
        cold-flagged forever)."""
        from ..config import CONFIG
        from ..exec import aot
        k = CONFIG.prewarm_top_k if top_k is None else int(top_k)
        shapes = []
        try:
            req = urllib.request.Request(
                f"{coordinator_uri.rstrip('/')}/v1/hotshapes?k={k}")
            if token:
                req.add_header("Authorization", f"Bearer {token}")
            with urllib.request.urlopen(req, timeout=10) as r:
                shapes = json.loads(r.read()).get("shapes") or []
        except Exception:       # noqa: BLE001 — an unreachable or older
            # coordinator gives an empty warm-up, not a dead worker
            shapes = []
        t0 = time.perf_counter()
        summary = aot.compile_entries(shapes, self.device)
        summary["pulled"] = len(shapes)
        summary["seconds"] = time.perf_counter() - t0
        with self._prewarm_lock:
            self.prewarm_ready = True
            self.prewarm_summary = summary
        return summary

    def announce(self, coordinator_uri: str,
                 interval_s: float = 10.0,
                 token: Optional[str] = None,
                 prewarm: Optional[bool] = None,
                 prewarm_top_k: Optional[int] = None) -> bool:
        """Join ``coordinator_uri``'s worker set now, then keep
        re-announcing on a daemon thread (registration survives a
        coordinator restart: the fresh coordinator learns this worker
        at the next beat). ``token`` rides as a Bearer credential on
        every announce/leave — required when the coordinator runs an
        authenticator, whose gate sits in front of /v1/announcement
        like every other resource. ``prewarm`` (default: config
        TRINO_TPU_PREWARM) starts the hot-shape warm-up on a background
        thread after the first announce; the readiness flag rides every
        announce payload, and the moment the warm-up finishes an extra
        beat pushes it to the coordinator. Returns whether the first
        announce landed. Safe to call repeatedly (e.g. re-pointing the
        worker at a new coordinator, or after stop()): each call retires
        the previous announcer loop via its own stop event, so exactly
        one loop ever beats."""
        from ..config import CONFIG
        self._announce_stop.set()       # retire any previous announcer
        stop = self._announce_stop = threading.Event()
        self._announced_to = coordinator_uri.rstrip("/")
        self._announce_token = token
        ok = announce_once(self._announced_to, self.base_uri,
                           self.node_id, token=token,
                           prewarmed=self._is_prewarmed())

        def loop():
            while not stop.wait(interval_s):
                try:
                    with self._announce_lock:
                        if stop.is_set():
                            return      # stop() won: no beat after it
                        announce_once(self._announced_to,
                                      self.base_uri, self.node_id,
                                      token=self._announce_token,
                                      prewarmed=self._is_prewarmed())
                except Exception:       # noqa: BLE001 — next beat
                    pass

        self._announce_thread = threading.Thread(target=loop,
                                                 daemon=True)
        self._announce_thread.start()

        if prewarm is None:
            prewarm = CONFIG.prewarm_enabled
        if prewarm and not self._is_prewarmed():
            uri, tok = self._announced_to, token

            def warmup():
                try:
                    self.prewarm_from(uri, top_k=prewarm_top_k, token=tok)
                except Exception:       # noqa: BLE001 — a failed warm-up
                    # leaves the worker cold-flagged but serving
                    return
                try:            # the readiness beat, ahead of the cadence
                    with self._announce_lock:
                        if not stop.is_set():
                            announce_once(uri, self.base_uri,
                                          self.node_id, token=tok,
                                          prewarmed=True)
                except Exception:       # noqa: BLE001
                    pass

            threading.Thread(target=warmup, daemon=True).start()
        return ok

    # -- lifecycle ----------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        # stop-then-leave under the announce lock: an in-flight beat
        # finishes first, and no beat can start after the stop event is
        # set — the leave is guaranteed to be the LAST membership write
        # this worker sends
        with self._announce_lock:
            self._announce_stop.set()
            if self._announced_to:
                try:  # graceful leave; the heartbeat detector is the
                    #   backstop for ungraceful deaths
                    req = urllib.request.Request(
                        f"{self._announced_to}/v1/announcement"
                        f"?uri={self.base_uri}", method="DELETE")
                    if self._announce_token:
                        req.add_header(
                            "Authorization",
                            f"Bearer {self._announce_token}")
                    with urllib.request.urlopen(req, timeout=5):
                        pass
                except Exception:       # noqa: BLE001
                    pass
        self._httpd.shutdown()
        self._httpd.server_close()


def announce_once(coordinator_uri: str, worker_uri: str,
                  node_id: Optional[str] = None,
                  token: Optional[str] = None,
                  prewarmed: bool = False) -> bool:
    """One worker-join announcement (POST /v1/announcement on the
    coordinator — the discovery-service registration analog).
    ``token`` is the Bearer credential for authenticated
    coordinators; ``prewarmed`` is the AOT warm-up readiness flag the
    scheduler's warm-worker preference keys on."""
    payload = json.dumps({"uri": worker_uri,
                          "nodeId": node_id or worker_uri,
                          "prewarmed": bool(prewarmed)}).encode()
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        f"{coordinator_uri.rstrip('/')}/v1/announcement",
        data=payload, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status == 200
    except Exception:               # noqa: BLE001
        return False


def worker_main(conn, device: DeviceLike = None):
    """Entry point for a worker child process: binds an ephemeral port on
    ``device``, reports the port through the pipe, serves until killed."""
    srv = TaskWorkerServer(device=device).start()
    conn.send(srv.port)
    conn.close()
    srv._thread.join()


def spawn_worker(device: DeviceLike = "cuda", timeout_s: float = 120.0):
    """Start a worker in a child process through the ``spawn`` start
    method (a child forked after CUDA initialised cannot use the card);
    returns (the process, the worker's base URI). The caller terminates
    the process."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=worker_main, args=(child, str(device)),
                       daemon=True)
    proc.start()
    child.close()
    if not parent.poll(timeout_s):
        proc.terminate()
        raise RuntimeError(f"worker did not start in {timeout_s}s")
    port = parent.recv()
    parent.close()
    return proc, f"http://127.0.0.1:{port}"


class RemoteTaskClient:
    """Coordinator-side proxy for one remote task (HttpRemoteTask +
    ExchangeClient/HttpPageBufferClient pull loop, collapsed)."""

    def __init__(self, base_uri: str):
        self.base_uri = base_uri.rstrip("/")

    def submit(self, task_id: str, sql: str, catalog: str = "tpch",
               schema: str = "tiny", properties: Optional[dict] = None):
        return self._post(task_id, {"sql": sql, "catalog": catalog,
                                    "schema": schema,
                                    "properties": properties or {}})

    def submit_fragment(self, task_id: str, fragment: dict,
                        catalog: str, schema: str, part: int,
                        nparts: int,
                        properties: Optional[dict] = None,
                        collect_stats: bool = False,
                        attempt: int = 0, spool: bool = False,
                        stage: Optional[dict] = None,
                        deadline_s: Optional[float] = None,
                        resource_group: Optional[str] = None,
                        group_weight: Optional[float] = None,
                        traceparent: Optional[str] = None):
        """POST a serialized plan fragment + split share (the
        HttpRemoteTask TaskUpdateRequest analog). ``attempt`` tags the
        task's retry/speculation generation; ``spool`` asks the worker
        to commit completed output pages to its spool. ``stage``
        carries the stage-DAG task context (trino_tpu/stage/): the
        stage id, the attempt-independent exchange key, the output
        partition count, and the upstream exchange sources to pull.
        ``deadline_s`` is the query's REMAINING wall-clock budget in
        seconds (relative — host clocks differ); the worker re-derives
        an absolute deadline for its executor. ``resource_group`` /
        ``group_weight`` carry the admitting group's identity and
        scheduling weight into the worker's shared split scheduler
        (exec/taskexec.py fair-share drain). ``traceparent`` is the
        W3C trace context naming the query's trace id and the
        coordinator's pre-minted span id for this task (obs/trace.py)
        — shipped both as a payload field and as the HTTP header."""
        body = {
            "fragment": fragment, "catalog": catalog, "schema": schema,
            "part": part, "nparts": nparts,
            "collect_stats": collect_stats,
            "attempt": attempt, "spool": spool,
            "properties": properties or {}}
        if stage is not None:
            body["stage"] = stage
        if deadline_s is not None:
            body["deadline_s"] = float(deadline_s)
        if resource_group is not None:
            body["resource_group"] = str(resource_group)
        if group_weight is not None:
            body["group_weight"] = float(group_weight)
        if traceparent is not None:
            body["traceparent"] = str(traceparent)
        return self._post(task_id, body, traceparent=traceparent)

    def status(self, task_id: str,
               traceparent: Optional[str] = None) -> dict:
        """GET the task status JSON, including worker-reported
        nodeStats and spans once the task finished."""
        req = urllib.request.Request(
            f"{self.base_uri}/v1/task/{task_id}")
        if traceparent:
            req.add_header("traceparent", traceparent)
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def wait_done(self, task_id: str, cancel=None,
                  timeout_s: float = 600.0,
                  poll_s: float = 0.05, on_status=None,
                  traceparent: Optional[str] = None) -> dict:
        """Poll task status until a terminal state and return the final
        status JSON (a stage task's consumers read its output off the
        spool/partition endpoint, so completion — not pages — is what
        the scheduler waits on). ``cancel`` (anything with ``is_set``)
        aborts between polls; ``timeout_s`` bounds the wait on a
        wedged worker, turning it into a retriable attempt failure.
        ``on_status`` receives every polled status dict WHILE the task
        runs — the live-memory beat hook (the stage scheduler feeds
        ``liveMemoryBytes`` into the cluster pool per poll)."""
        import time as _time
        deadline = _time.monotonic() + timeout_s
        while True:
            if cancel is not None and cancel.is_set():
                try:
                    self.abort(task_id)
                except Exception:       # noqa: BLE001
                    pass
                raise RuntimeError(f"task {task_id} canceled")
            if _time.monotonic() > deadline:
                try:
                    self.abort(task_id)
                except Exception:       # noqa: BLE001
                    pass
                raise RuntimeError(
                    f"task {task_id} did not finish in {timeout_s}s")
            st = self.status(task_id, traceparent=traceparent)
            if on_status is not None:
                try:
                    on_status(st)
                except Exception:       # noqa: BLE001 — a beat
                    pass                # consumer bug must not fail
                #                        the attempt
            if st.get("state") != "RUNNING":
                return st
            _time.sleep(poll_s)

    def _post(self, task_id: str, body: dict,
              traceparent: Optional[str] = None):
        payload = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        if traceparent:
            headers["traceparent"] = traceparent
        req = urllib.request.Request(
            f"{self.base_uri}/v1/task/{task_id}", data=payload,
            headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def pages_raw(self, task_id: str, cancel=None,
                  timeout_s: float = 600.0,
                  meta_out: Optional[dict] = None,
                  on_beat=None,
                  traceparent: Optional[str] = None) -> List[bytes]:
        """Pull every result page FRAME (token-acknowledged bounded
        poll) — raw serialized bytes, so callers can spool them without
        a decode/re-encode round trip. ``cancel`` (anything with
        ``is_set()``) aborts the remote task and raises between polls —
        the ExchangeClient cancel path; ``timeout_s`` bounds the total
        wait on a wedged task. A 404 mid-pull (task evicted after
        abort, worker restart) falls back to the worker's /v1/spool
        endpoint once: committed output survives the task entry.
        ``meta_out``, when given, receives pull side-channel data —
        currently ``spool_dir``, the worker's committed-attempt
        directory (X-TT-Spool-Dir) for same-host write coalescing."""
        import urllib.error
        import time as _time
        deadline = _time.monotonic() + timeout_s
        out: List[bytes] = []
        token = 0
        from_spool = False
        while True:
            if _time.monotonic() > deadline:
                try:
                    self.abort(task_id)
                except Exception:       # noqa: BLE001
                    pass
                raise RuntimeError(
                    f"task {task_id} produced no page for {timeout_s}s")
            if cancel is not None and cancel.is_set():
                try:
                    self.abort(task_id)
                except Exception:       # noqa: BLE001
                    pass
                raise RuntimeError(f"task {task_id} canceled")
            path = (f"/v1/spool/{task_id}/{token}" if from_spool
                    else f"/v1/task/{task_id}/results/{token}")
            try:
                # per-request timeout bounded by the remaining attempt
                # deadline: a half-open socket on a dead worker must
                # not pin this pull past its budget
                per_req = max(1.0, min(600.0,
                                       deadline - _time.monotonic()))
                pull = urllib.request.Request(f"{self.base_uri}{path}")
                if traceparent:
                    # trace context on the data-plane pulls too: a
                    # proxy/collector between hosts can correlate page
                    # traffic with the owning query's trace
                    pull.add_header("traceparent", traceparent)
                with urllib.request.urlopen(pull, timeout=per_req) as r:
                    if r.status == 202:     # still running: poll again
                        if on_beat is not None:
                            # live-memory beat on the flat path: the
                            # 202 carries the running task's current
                            # reservation (X-TT-Live-Memory)
                            live = r.headers.get("X-TT-Live-Memory")
                            if live:
                                try:
                                    on_beat(int(live))
                                except Exception:  # noqa: BLE001
                                    pass
                        continue
                    complete = r.headers.get("X-TT-Complete") == "true"
                    if meta_out is not None:
                        sdir = r.headers.get("X-TT-Spool-Dir")
                        if sdir:
                            meta_out["spool_dir"] = sdir
                    body = r.read()
            except urllib.error.HTTPError as e:
                if e.code == 404 and not from_spool:
                    from_spool = True   # restart the pull off the spool
                    out, token = [], 0
                    continue
                raise
            if complete:
                break
            out.append(body)
            token += 1
        # counted once at the end: a spool-fallback restart re-pulls
        # from token 0 and must not double-count the first pass
        if out:
            _M_PAGES.inc(len(out), direction="received")
            _M_PAGE_BYTES.inc(sum(len(b) for b in out),
                              direction="received")
        return out

    def pages(self, task_id: str, cancel=None,
              timeout_s: float = 600.0,
              device: DeviceLike = None) -> List[Batch]:
        """`pages_raw` decoded into Batches on ``device`` (cuda unless
        the caller asks for the CPU)."""
        return [deserialize_batch(b, device) for b in
                self.pages_raw(task_id, cancel=cancel,
                               timeout_s=timeout_s)]

    def abort(self, task_id: str):
        req = urllib.request.Request(
            f"{self.base_uri}/v1/task/{task_id}", method="DELETE")
        with urllib.request.urlopen(req, timeout=30):
            pass
