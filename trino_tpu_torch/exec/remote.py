"""Coordinator -> remote-worker query execution.

Counterpart of ``trino_tpu/exec/remote.py`` (host code). The coordinator
drives worker processes over HTTP: POST /v1/task with a serialised plan
fragment and a split share, token-acknowledged page pulls, and the
stages stitched together here. Two dispatch modes:

- **stage DAG** (``multistage_execution``, stage/): the plan is cut at
  exchange points into a DAG of stages — joins, final aggregations and
  windows execute on the workers over a hash-partitioned exchange
  riding the spool, and the coordinator executes only the root stage.
  Plans the stage fragmenter declines fall back to:
- **flat leaf fragments**: a leaf fragment (scan -> filter -> project,
  plus a partial aggregation, TopN or limit when the parent combines)
  is shipped as JSON (plan/serde.py) to every worker with a
  (part, nparts) split share; the workers run it on their card and
  serve page frames; the coordinator decodes the partials onto its own
  device in a fixed order (fragment, then part — never arrival order,
  so a result is bit-identical from run to run), substitutes them into
  the plan as preloaded batches and runs the combine.

``DistributedHostQueryRunner`` runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises without a card.
"""

from __future__ import annotations

import os
import threading
import uuid
from dataclasses import replace as dc_replace
from typing import Callable, Dict, List, Optional, Tuple

from ..catalog import CatalogManager
from ..columnar import Batch
from ..config import DeviceLike, resolve_device
from ..fte.retry import (COMBINE_RETRIES, TASK_RETRIES, RetryController,
                         RetryPolicy, backoff_delay, pick_worker)
from ..fte.speculate import (SPECULATIVE_TASKS, SPECULATIVE_WINS,
                             StragglerDetector)
from ..plan.nodes import (AggregationNode, FilterNode, LimitNode,
                          PlanNode, ProjectNode, TableScanNode,
                          TopNNode)
from ..plan.serde import to_jsonable
from ..session import Session
from .executor import (Executor, NodeStats, QueryError, _Pre,
                       device_concat, merge_node_stats)

# the PARTIAL/FINAL aggregation split lives in stage/fragmenter.py now
# (shared by this flat fragmenter and the stage-DAG fragmenter — one
# combine table, zero drift)
from ..stage.fragmenter import (build_final_aggregation,
                                split_aggregates,
                                splittable_aggregates)


class _Fragment:
    """One leaf fragment: a plan subtree rooted in a single table scan
    chain, executed by every worker over its split share."""

    def __init__(self, fid: int, plan: PlanNode,
                 final_builder) -> None:
        self.fid = fid
        self.plan = plan
        # final_builder(preloaded) -> PlanNode: rebuilds the
        # coordinator-side combine step over the gathered partials
        self.final_builder = final_builder


def _is_chain(node: PlanNode) -> bool:
    """scan | filter(chain) | project(chain) — independently executable
    per split share."""
    if isinstance(node, TableScanNode):
        return True
    if isinstance(node, (FilterNode, ProjectNode)):
        return _is_chain(node.source)
    return False


def _chain_scan(node: PlanNode) -> TableScanNode:
    while not isinstance(node, TableScanNode):
        node = node.source
    return node


def _splittable_agg(node: AggregationNode) -> bool:
    if node.step != "SINGLE" or node.group_id_symbol is not None:
        return False
    return splittable_aggregates(node)


class RemoteScheduler:
    """Dispatch a plan over remote workers. Under
    ``multistage_execution`` the stage fragmenter (stage/fragmenter.py)
    cuts a multi-stage DAG and the stage scheduler
    (stage/scheduler.py) runs joins/aggregations ON the workers with a
    partitioned worker-to-worker exchange; otherwise — or when the
    fragmenter declines the plan shape — the flat path ships leaf
    fragments and combines on the coordinator (SqlQueryScheduler,
    collapsed to leaf stages + coordinator combine)."""

    def __init__(self, worker_uris: List[str],
                 catalogs: CatalogManager, session: Session,
                 collect_stats: bool = False,
                 failure_detector=None, spool=None,
                 worker_supplier: Optional[
                     Callable[[], List[str]]] = None,
                 manifest_store=None, manifest_meta=None,
                 device: DeviceLike = None):
        if not worker_uris:
            raise ValueError("RemoteScheduler needs at least one worker")
        from ..server.task_worker import RemoteTaskClient
        # the coordinator's device: the gathered partials and the
        # combine run here
        self.device = resolve_device(device)
        self.workers = [RemoteTaskClient(u) for u in worker_uris]
        self.catalogs = catalogs
        self.session = session
        # mid-flight failover (fte/recovery.py ExecutionManifestStore):
        # when both are wired and the retry policy allows resumption,
        # the stage path persists an execution manifest BEFORE
        # dispatching any task. ``manifest_meta`` carries the
        # coordinator-side identity/admission facts (query id, slug,
        # SQL, user, resource group, original submit epoch) the
        # scheduler itself does not know.
        self.manifest_store = manifest_store
        self.manifest_meta = manifest_meta
        # failover-resume accounting for the most recent stage run
        self.failover_resumed = 0
        self.failover_replayed = 0
        # distributed stats rollup: workers report per-node stats in
        # task results; after execute_plan, fragment_stats[fid] holds
        # the per-stage merge and self.stats the full rollup (fragment
        # stages + the coordinator combine), powering EXPLAIN ANALYZE
        self.collect_stats = collect_stats
        self.fragment_stats: Dict[int, List[NodeStats]] = {}
        self.fragment_workers: Dict[int, int] = {}
        self.fragment_expected: int = 0     # tasks dispatched per frag
        self.stats: List[NodeStats] = []
        # cluster-wide resource figures: max of worker peaks (tasks run
        # concurrently) + the coordinator combine; spill sums, as do
        # the morsel-streaming rollups (chunks + h2d bytes across
        # every worker task and the coordinator stages)
        self.peak_memory_bytes = 0
        self.spill_bytes = 0
        self.stream_chunks = 0
        self.stream_h2d_bytes = 0
        # scheduler attribution rollup: thread-CPU seconds the
        # workers' split schedulers accounted to this query's tasks,
        # summed per fragment/stage for the EXPLAIN ANALYZE rollup and
        # query-wide for the result
        self.cpu_seconds = 0.0
        self.fragment_cpu: Dict[int, float] = {}
        # fault-tolerant execution (trino_tpu/fte/): the heartbeat
        # detector receives observed task failures and is consulted
        # when picking a replacement worker; the spool receives every
        # completed attempt's page frames (first-commit-wins) and is
        # what the combine reads. Workers observed failing a task this
        # query join ``excluded`` and are avoided for re-dispatch.
        self.failure_detector = failure_detector
        self.spool = spool
        self.excluded: set = set()
        self._excl_lock = threading.Lock()
        # attempt counters are written by dispatch threads + the
        # speculation monitor concurrently; += is read-modify-write, so
        # they share a dedicated lock (found by analysis/lint.py's
        # race-attr-write rule — lost increments would undercount
        # retries in EXPLAIN ANALYZE and the bench fault leg)
        self._stats_lock = threading.Lock()
        self.task_retries = 0
        self.combine_retries = 0
        self.speculative_launches = 0
        self.speculative_wins = 0
        # live membership (server/coordinator.py announce endpoint):
        # when a supplier is wired, every retry/speculation dispatch
        # first syncs the worker list, so a worker that JOINS mid-query
        # becomes eligible for replacement attempts and speculative
        # duplicates (the initial split fan-out stays fixed — only
        # extra attempts land on late joiners). Leaves need no sync:
        # the failure detector's liveness verdict already sidelines
        # departed workers.
        self.worker_supplier = worker_supplier
        self._members_lock = threading.Lock()
        self._known_uris = {c.base_uri for c in self.workers}
        self.workers_joined = 0
        # stage-DAG execution artifacts (multistage_execution): the cut
        # DAG and its text rendering for EXPLAIN ANALYZE's stage section
        self.stage_dag = None
        self.stage_lines: List[str] = []

    # -- deadline propagation ------------------------------------------
    def _remaining_s(self) -> Optional[float]:
        """Seconds left in this query's wall-clock budget (None = no
        deadline). The deadline is ABSOLUTE (session.deadline, set by
        the tracker/runner from query_max_run_time) so every dispatch,
        retry backoff, and page pull shares one shrinking budget —
        one computation, owned by Session.remaining_time."""
        rem = getattr(self.session, "remaining_time", None)
        return rem() if callable(rem) else None

    def _attempt_budget_s(self, default_s: float) -> float:
        """Per-attempt timeout bounded by the remaining query budget —
        an attempt must never outlive its query's deadline."""
        rem = self._remaining_s()
        if rem is None:
            return default_s
        return max(0.05, min(default_s, rem))

    def _check_deadline(self, where: str) -> None:
        """Raise EXCEEDED_TIME_LIMIT once the budget is spent; records
        a ``deadline_cancel`` span so the trace shows WHERE the breach
        cut execution (schedule, retry, combine...)."""
        import time as _time
        rem = self._remaining_s()
        if rem is None or rem > 0:
            return
        trace = getattr(self.session, "trace", None)
        if trace is not None:
            now = _time.perf_counter()
            trace.record("deadline_cancel", now, now, where=where)
        raise QueryError(
            f"Query exceeded the maximum run time "
            f"(query_max_run_time) during {where}",
            error_name="EXCEEDED_TIME_LIMIT")

    # -- live memory feedback ------------------------------------------
    def _live_memory_hook(self, task_id: str):
        """Per-task beat callback folding a worker's LIVE reservation
        into the cluster pool (server/memory.py reserve_remote) while
        the task runs — the low-memory killer then acts on live worker
        bytes, not completion-time peaks. None when no pool context
        governs this query or live_memory_feedback is off."""
        mem = getattr(self.session, "memory", None)
        feed = getattr(mem, "reserve_remote", None)
        if feed is None:
            return None
        try:
            if not bool(self.session.get("live_memory_feedback")):
                return None
        except KeyError:        # foreign session without the knob
            pass

        def beat(nbytes) -> None:
            n = int(nbytes or 0)
            if n > 0:
                feed(task_id, n)

        rel = getattr(mem, "release_remote", None)

        def release() -> None:
            # the attempt is terminal: its worker memory is free, so
            # the pool stops charging this query for it — without
            # this, retried attempts and sequential stage tasks
            # ACCUMULATE dead high-water marks until the killer fires
            # on a query that never held that much at once
            if rel is not None:
                try:
                    rel(task_id)
                except Exception:   # noqa: BLE001 — best-effort
                    pass
        beat.release = release
        return beat

    def _sync_workers(self) -> None:
        """Append clients for workers that joined since dispatch.
        Append-only: positions of known workers never move (attempt
        rotation in fte/retry.py is positional), and a departed URI
        keeps its slot for the detector to veto."""
        if self.worker_supplier is None:
            return
        try:
            uris = list(self.worker_supplier())
        except Exception:       # noqa: BLE001 — membership is advisory
            return
        from ..server.task_worker import RemoteTaskClient
        with self._members_lock:
            for u in uris:
                u = str(u).rstrip("/")
                if u in self._known_uris:
                    continue
                self._known_uris.add(u)
                self.workers.append(RemoteTaskClient(u))
                self.workers_joined += 1
                if self.failure_detector is not None:
                    self.failure_detector.add_service(u)

    # -- fragmentation -------------------------------------------------
    def _remotable(self, node: PlanNode) -> bool:
        """Only pure-generator scans may execute on a remote worker;
        coordinator-state-backed catalogs (system.runtime, memory
        tables, information_schema) must read THIS process (reference:
        system tables run on the coordinator via
        SystemPartitioningHandle.COORDINATOR_ONLY)."""
        scan = _chain_scan(node)
        try:
            conn = self.catalogs.connector(scan.handle.catalog)
        except Exception:       # noqa: BLE001
            return False
        return bool(getattr(conn, "remote_scan_ok",
                            getattr(conn, "scan_cache_ok", False)))

    def _cut(self, node: PlanNode, frags: List[_Fragment]) -> PlanNode:
        # parent-combinable shapes first: partial agg / topN / limit
        if isinstance(node, AggregationNode) and _is_chain(node.source) \
                and self._remotable(node.source) \
                and _splittable_agg(node):
            return self._cut_aggregation(node, frags)
        if isinstance(node, TopNNode) and _is_chain(node.source) \
                and self._remotable(node.source):
            fid = len(frags)
            if node.step == "SINGLE":
                part = dc_replace(node, step="PARTIAL")
                frags.append(_Fragment(
                    fid, part,
                    lambda pre, n=node: dc_replace(n, source=pre,
                                                   step="FINAL")))
            elif node.step == "PARTIAL":
                # an optimizer-created partial (CreatePartialTopN over
                # a union branch) ships whole; its FINAL stays above
                frags.append(_Fragment(fid, node, lambda pre: pre))
            else:
                frags.append(_Fragment(fid, node.source,
                                       lambda pre, n=node: dc_replace(
                                           n, source=pre)))
                return _Placeholder(fid, node.source.output_schema())
            return _Placeholder(fid, node.output_schema())
        if isinstance(node, LimitNode) and _is_chain(node.source) \
                and self._remotable(node.source):
            fid = len(frags)
            part = (node if node.partial
                    else dc_replace(node, partial=True))
            frags.append(_Fragment(
                fid, part,
                (lambda pre: pre) if node.partial
                else (lambda pre, n=node: dc_replace(n, source=pre))))
            return _Placeholder(fid, node.output_schema())
        if _is_chain(node) and not isinstance(node, TableScanNode) \
                and self._remotable(node):
            # a bare chain (scan+filter+project) below a non-combinable
            # parent: ship the chain, gather rows
            fid = len(frags)
            frags.append(_Fragment(fid, node, lambda pre: pre))
            return _Placeholder(fid, node.output_schema())
        if isinstance(node, TableScanNode) and self._remotable(node):
            fid = len(frags)
            frags.append(_Fragment(fid, node, lambda pre: pre))
            return _Placeholder(fid, node.output_schema())
        # recurse
        srcs = node.sources
        if not srcs:
            return node
        new = [self._cut(s, frags) for s in srcs]
        if all(a is b for a, b in zip(new, srcs)):
            return node
        return _replace_sources(node, new)

    def _cut_aggregation(self, node: AggregationNode,
                         frags: List[_Fragment]) -> PlanNode:
        """PARTIAL on workers, FINAL combine + avg reconstruction at
        the coordinator (PushPartialAggregationThroughExchange, host
        leg). The split itself is shared with the stage-DAG fragmenter
        (stage/fragmenter.py split_aggregates)."""
        partial_aggs, final_aggs, avg_posts = split_aggregates(
            node.aggregates, node.source.output_schema())
        part = AggregationNode(node.source, node.group_keys,
                               partial_aggs, step="SINGLE")
        fid = len(frags)

        def build_final(pre, n=node, finals=final_aggs,
                        posts=avg_posts):
            return build_final_aggregation(pre, n, finals, posts)

        frags.append(_Fragment(fid, part, build_final))
        return _Placeholder(fid, node.output_schema())

    # -- dispatch ------------------------------------------------------
    def execute_plan(self, plan: PlanNode) -> Batch:
        from ..analysis.sanity import PlanSanityChecker
        from ..obs.trace import null_span
        trace = getattr(self.session, "trace", None)
        sp = trace.span if trace is not None else null_span
        # ALWAYS validated before fragmentation (not only in the
        # plan_validation debug mode): a malformed plan crossing the
        # dispatch boundary costs a fleet-wide fan-out plus 30-90s of
        # XLA compile per worker before it fails — the checker costs a
        # plan walk. Fragments additionally prove serde round-trip
        # stability, because their wire form IS what workers execute.
        checker = PlanSanityChecker()
        frags: List[_Fragment] = []
        payloads: Dict[int, dict] = {}
        dag = stage_payloads = None
        with sp("schedule"):
            self._check_deadline("schedule")
            checker.validate(plan, "pre-dispatch")
            if self._multistage_enabled():
                from ..stage.fragmenter import StageFragmenter
                dag = StageFragmenter(self.catalogs,
                                      self.session).fragment(plan)
            if dag is not None:
                # always-on pre-dispatch battery, stage flavor: every
                # stage plan runs the fragment validators (its wire
                # form IS what workers execute) PLUS the stage-boundary
                # checks — partitioning-key closure and schema/type
                # agreement across every PartitionedOutput/RemoteSource
                # pair (analysis/sanity.py StageBoundaryChecker)
                from ..analysis.sanity import validate_stage_dag
                stage_payloads = validate_stage_dag(dag, checker)
            else:
                rewritten = self._cut(plan, frags)
                for f in frags:
                    # the round-trip-proven encoding IS the wire
                    # payload: ship the exact bytes that were validated
                    # instead of encoding the fragment a second time
                    payloads[f.fid] = checker.validate_fragment(
                        f.plan, "fragmenter")
        if dag is not None:
            return self._execute_stages(dag, stage_payloads)
        if not frags:
            ex = Executor(self.catalogs, self.session, self.device,
                          self.collect_stats)
            out = ex.execute(plan)
            self.stats = list(ex.stats)
            self.peak_memory_bytes = ex.peak_reserved_bytes
            self.spill_bytes = ex.spilled_bytes
            self.stream_chunks = ex.stream_chunks
            self.stream_h2d_bytes = ex.stream_h2d_bytes
            return out
        gathered = self._run_fragments(frags, payloads)
        final = _substitute(rewritten, {
            f.fid: f.final_builder(_Pre(gathered[f.fid]))
            for f in frags})
        out, ex = self._execute_combine(final)
        self.peak_memory_bytes = max(self.peak_memory_bytes,
                                     ex.peak_reserved_bytes)
        self.spill_bytes += ex.spilled_bytes
        self.stream_chunks += ex.stream_chunks
        self.stream_h2d_bytes += ex.stream_h2d_bytes
        if self.collect_stats:
            # full rollup: fragment stages first (leaf-to-root order),
            # annotated with their stage, then the coordinator combine
            self.stats = []
            for fid in sorted(self.fragment_stats):
                nw = self.fragment_workers.get(fid, 0)
                # a worker whose (best-effort) status fetch failed is
                # missing from the merge: say so, or an under-counted
                # rollup reads as a complete one
                tag = (f"fragment {fid} x{nw} workers"
                       if nw == self.fragment_expected else
                       f"fragment {fid} x{nw}/"
                       f"{self.fragment_expected} workers reported")
                # the per-fragment attribution rollup: scheduler-
                # accounted CPU, distinct from wall
                tag += f" [cpu {self.fragment_cpu.get(fid, 0.0):.3f}s]"
                for s in self.fragment_stats[fid]:
                    s.detail = f"{s.detail} {tag}".strip() \
                        if s.detail else tag
                    self.stats.append(s)
            self.stats.extend(ex.stats)
        return out

    def _multistage_enabled(self) -> bool:
        try:
            return bool(self.session.get("multistage_execution"))
        except KeyError:        # foreign session without the knob
            return False

    def _execute_stages(self, dag, payloads: Dict[int, dict],
                        resume: Optional[dict] = None) -> Batch:
        """Stage-DAG execution: every worker stage runs through the
        topological stage scheduler (stage/scheduler.py) with the
        partitioned exchange riding the workers' spools; the
        coordinator then executes ONLY the root plan, pulling the
        final gather partition from the last stage's tasks — under
        the same combine retry loop as the flat path.

        ``resume`` (coordinator failover, fte/recovery.py): a dict of
        ``{"exec_qid", "ntasks", "spool"}`` reconstructed from a
        spooled execution manifest — the stage scheduler then reuses
        the ORIGINAL execution id (exchange keys must match the
        partitions earlier attempts committed), pins the original
        fan-out, and dispatches only the partitions whose exchange
        keys carry no COMMITTED marker."""
        from ..stage.exchange import ExchangePuller
        from ..stage.scheduler import StageExecution
        from ..fte.faultpoints import fault_point
        self.stage_dag = dag
        self.stage_lines = dag.lines()
        if resume is not None:
            sx = StageExecution(
                self, dag, payloads, qid=str(resume["exec_qid"]),
                ntasks_override={int(k): int(v) for k, v in
                                 (resume.get("ntasks") or {}).items()},
                resume_spool=resume.get("spool"))
        else:
            sx = StageExecution(self, dag, payloads)
            self._persist_manifest(dag, payloads, sx)
        # deterministic chaos site: the manifest (when one was written)
        # is durable, no task has been dispatched — a crash here leaves
        # a fully-replayable query
        fault_point("coordinator.pre_dispatch")
        sources = sx.run()
        self.failover_resumed = sx.resumed_parts
        self.failover_replayed = sx.replayed_parts
        timeout_s = float(self.session.get("remote_task_timeout"))
        # spool-first root gather: on a shared local spool base the
        # coordinator reads the final stage's committed partitions
        # directly off the workers' spool dir — a worker dying AFTER
        # its last task committed costs nothing (the HTTP pull from
        # the winner URI stays as the cross-host fallback)
        root_spool = None
        try:
            from ..config import CONFIG
            from ..fte.spool import make_spool, worker_spool_base
            if (CONFIG.spool_backend or "local").lower() in (
                    "local", "filesystem", ""):
                root_spool = make_spool(
                    "local", local_base_dir=worker_spool_base())
        except Exception:       # noqa: BLE001 — HTTP path remains
            root_spool = None

        def setup(ex):
            ex.exchange_reader = ExchangePuller(
                sources, part=0, spool=root_spool,
                timeout_s=timeout_s,
                cancel=getattr(self.session, "cancel", None),
                device=self.device).read_fragment

        out, ex = self._execute_combine(dag.root_plan, setup=setup)
        self.peak_memory_bytes = max(self.peak_memory_bytes,
                                     ex.peak_reserved_bytes)
        self.spill_bytes += ex.spilled_bytes
        self.stream_chunks += ex.stream_chunks
        self.stream_h2d_bytes += ex.stream_h2d_bytes
        for peak, spill in sx.resources:
            self.peak_memory_bytes = max(self.peak_memory_bytes, peak)
            self.spill_bytes += spill
        if self.collect_stats:
            # per-stage rollup, leaf-to-root, then the coordinator's
            # root stage — EXPLAIN ANALYZE proves WHERE each operator
            # ran (the acceptance question: joins and final
            # aggregations tagged with worker stages, the coordinator
            # carrying only the root stream)
            self.stats = []
            for sid in sorted(sx.stage_stats):
                ntasks = sx.ntasks.get(sid, 0)
                nrep = sx.stage_reported.get(sid, 0)
                tag = (f"stage {sid} x{nrep} tasks"
                       if nrep == ntasks else
                       f"stage {sid} x{nrep}/{ntasks} tasks reported")
                # per-stage attribution: worker-side scheduler CPU,
                # distinct from the wall column
                tag += f" [cpu {sx.stage_cpu.get(sid, 0.0):.3f}s]"
                for s in sx.stage_stats[sid]:
                    s.detail = f"{s.detail} {tag}".strip() \
                        if s.detail else tag
                    self.stats.append(s)
            for s in ex.stats:
                s.detail = (f"{s.detail} stage root (coordinator)"
                            .strip() if s.detail
                            else "stage root (coordinator)")
            self.stats.extend(ex.stats)
        return out

    def _persist_manifest(self, dag, payloads: Dict[int, dict],
                          sx) -> None:
        """Spool the execution manifest for mid-flight failover —
        everything a coordinator that never saw this query needs to
        finish it (fte/recovery.py ExecutionManifestStore). Gated the
        same way spooling itself is: retry_policy=NONE queries are not
        resumable, exactly as they get no task retries. Best-effort by
        contract — a failed persist costs only resumability."""
        if self.manifest_store is None or not self.manifest_meta:
            return
        if not RetryPolicy.from_session(self.session).enabled:
            return
        try:
            doc = dict(self.manifest_meta)
            doc.update({
                "execId": sx.qid,
                "catalog": self.session.catalog,
                "schema": self.session.schema,
                "properties": dict(self.session.properties),
                "ntasks": {str(k): int(v)
                           for k, v in sx.ntasks.items()},
                "stages": [{
                    "sid": st.sid,
                    "inputs": list(st.inputs),
                    "consumer": st.consumer,
                    "maxTasks": st.max_tasks,
                    # the serde-proven wire encoding the scheduler
                    # ships (analysis/sanity.py validate_fragment
                    # round-trip-checked these exact bytes)
                    "payload": payloads[st.sid],
                } for st in dag.stages],
                "rootPlan": to_jsonable(dag.root_plan),
            })
            self.manifest_store.persist(doc)
        except Exception:       # noqa: BLE001 — resumability is
            pass                # opportunistic, never a query failure

    def _execute_combine(self, final: PlanNode, setup=None):
        """The root (combine) stage with its own retry loop: under
        retry_policy=TASK the combine re-executes on the coordinator
        up to the per-task attempt budget — the fragment output it
        consumes is already gathered (and, when spooled, durable), so
        re-running the root costs only coordinator compute. ``setup``
        configures each attempt's Executor (the stage path wires the
        exchange reader for the root gather — a
        failed pull retries with a fresh executor the same way). A
        user cancel or a deterministic ``QueryError`` is never
        retried."""
        import time as _time
        from ..fte.faultpoints import fault_point
        # deterministic chaos site: every input the combine needs is
        # durable (stage output committed / fragments gathered), only
        # the root execution and result publication remain — fired
        # BEFORE the retry loop so an injected raise is a coordinator
        # failure, not a retriable combine error
        fault_point("coordinator.mid_combine")
        policy = RetryPolicy.from_session(self.session)
        attempts = (max(policy.task_retry_attempts, 1)
                    if policy.enabled else 1)
        trace = getattr(self.session, "trace", None)
        for attempt in range(attempts):
            # the deadline bounds the combine retry loop too: a root
            # re-execution past the budget answers nobody
            self._check_deadline("combine" if attempt == 0
                                 else "combine retry")
            ex = Executor(self.catalogs, self.session, self.device,
                          self.collect_stats)
            if setup is not None:
                setup(ex)
            t0 = _time.perf_counter()
            try:
                return ex.execute(final), ex
            except Exception as e:      # noqa: BLE001
                cancel = getattr(self.session, "cancel", None)
                if cancel is not None and cancel.is_set():
                    raise
                if isinstance(e, QueryError):
                    # deterministic engine/user errors (memory limit,
                    # bad data at the root) fail identically on every
                    # attempt — re-running only delays the answer
                    raise
                if attempt + 1 >= attempts:
                    raise
                self.combine_retries += 1
                COMBINE_RETRIES.inc()
                if trace is not None:
                    trace.record("combine_retry", t0,
                                 _time.perf_counter(), attempt=attempt,
                                 error=f"{type(e).__name__}: {e}"[-160:])
                delay = backoff_delay(policy, attempt + 1, "combine")
                rem = self._remaining_s()
                if rem is not None:
                    delay = min(delay, max(rem, 0.0))
                _time.sleep(delay)
        raise AssertionError("unreachable")  # loop returns or raises

    def _run_fragments(self, frags: List[_Fragment],
                       payloads: Optional[Dict[int, dict]] = None
                       ) -> Dict[int, Batch]:
        """Attempt-aware dispatch: every (fragment, part) task runs a
        retry loop (fte/retry.py budgets + backoff, replacement worker
        per attempt), completed attempts commit their page frames to
        the spool (first-commit-wins; fte/spool.py), and a speculation
        monitor re-dispatches stragglers (fte/speculate.py). The old
        single-shot path is the degenerate case: retry_policy=NONE, no
        spool, zero extra attempts."""
        import time as _time
        from ..serde import deserialize_batch
        qid = uuid.uuid4().hex[:12]
        nparts = len(self.workers)
        session = self.session
        # hash_partition_count caps the remote fan-out
        # (SystemSessionProperties HASH_PARTITION_COUNT)
        hpc = int(session.get("hash_partition_count"))
        if hpc > 0:
            nparts = min(nparts, hpc)
        policy = RetryPolicy.from_session(session)
        speculation_on = bool(session.get("speculation_enabled")) \
            and len(self.workers) > 1
        # spooling engages only when a duplicate attempt is possible
        # (retry or speculation): retry_policy=NONE stays the legacy
        # in-memory path with zero disk traffic
        use_spool = policy.enabled or speculation_on
        if use_spool and self.spool is None:
            from ..fte.spool import default_spool
            self.spool = default_spool(
                str(session.get("spool_backend")) or None)
        spool = self.spool if use_spool else None
        if spool is not None:
            try:        # ride-along TTL sweep (time-gated internally)
                spool.maybe_cleanup()
            except Exception:   # noqa: BLE001
                pass
        controller = RetryController(policy)
        straggler = StragglerDetector(
            multiplier=float(session.get("speculation_multiplier")),
            min_runtime_s=int(
                session.get("speculation_min_runtime_ms")) / 1000.0)
        worker_stats: Dict[int, List[List[NodeStats]]] = {
            f.fid: [] for f in frags}
        worker_resources: List[Tuple[int, int]] = []  # (peak, spill)
        trace = getattr(session, "trace", None)
        trace_parent = trace.current() if trace is not None else None
        on_split = getattr(session, "on_split", None)

        if payloads is None:
            payloads = {f.fid: to_jsonable(f.plan) for f in frags}
        tasks = [_TaskRun(f, part)
                 for f in frags for part in range(nparts)]

        def alive(wi: int) -> bool:
            det = self.failure_detector
            return det is None or det.is_alive(self.workers[wi].base_uri)

        def run_attempt(st: _TaskRun, attempt: int, wi: int,
                        speculative: bool = False) -> Optional[str]:
            """One attempt of task ``st`` on worker ``wi``; returns an
            error string on failure, None on success OR benign loss to
            a sibling attempt."""
            f = st.fragment
            tid = f"{qid}.{f.fid}.{st.part}.a{attempt}"
            client = self.workers[wi]
            t0 = _time.perf_counter()
            if not speculative:
                with st.lock:
                    st.running_since = t0
                    st.running_worker = wi
            beat = self._live_memory_hook(tid)
            # distributed tracing: pre-mint THIS attempt's span id and
            # ship it W3C-style — the worker's spans are born with the
            # query's trace id and this id as their parent, so the
            # post-completion graft is an id-preserving merge
            span_id = tp = None
            if trace is not None:
                span_id = trace.new_span_id()
                tp = trace.traceparent(span_id)
            try:
                client.submit_fragment(
                    tid, payloads[f.fid],
                    catalog=session.catalog, schema=session.schema,
                    part=st.part, nparts=nparts,
                    properties=dict(session.properties),
                    collect_stats=self.collect_stats,
                    attempt=attempt, spool=spool is not None,
                    # the worker re-derives an absolute deadline from
                    # the remaining budget: its own executor stops
                    # between plan nodes instead of computing a result
                    # nobody will wait for
                    deadline_s=self._remaining_s(),
                    # the admitting group rides into the worker's
                    # shared split scheduler (fair-share by group)
                    resource_group=getattr(session, "resource_group",
                                           None),
                    group_weight=getattr(session,
                                         "resource_group_weight",
                                         None),
                    traceparent=tp)
                # the watch event aborts this attempt's page pull the
                # moment a sibling attempt wins (or the user cancels)
                watch = _MultiEvent(getattr(session, "cancel", None),
                                    st.done)
                meta: Dict[str, str] = {}
                frames = client.pages_raw(
                    tid, cancel=watch,
                    timeout_s=self._attempt_budget_s(
                        float(session.get("remote_task_timeout"))),
                    meta_out=meta,
                    # 202 polls carry the running task's live
                    # reservation into the cluster pool
                    on_beat=beat,
                    traceparent=tp)
            except Exception as e:     # noqa: BLE001
                st.last_window = (t0, _time.perf_counter())
                if not speculative:
                    with st.lock:
                        st.running_since = None  # not running anywhere:
                        # the speculation monitor must not read a retry
                        # backoff as a straggling attempt
                if st.done.is_set():
                    if not st.failed:
                        return None     # a sibling attempt already won
                    # the task already failed permanently elsewhere and
                    # this pull was watch-aborted: not evidence against
                    # THIS worker — no detector demerit, no exclusion
                    return (f"fragment {f.fid} task {tid}: aborted "
                            "(task already failed)")
                cancel = getattr(session, "cancel", None)
                if cancel is not None and cancel.is_set():
                    # a user cancel is not the worker's failure: no
                    # detector demerit, no exclusion
                    return (f"fragment {f.fid} task {tid}: canceled")
                if _busy_decline(e):
                    # retryable BUSY shed (worker 503): the worker is
                    # healthy, just loaded — rotate to another worker
                    # WITHOUT a detector demerit or per-query
                    # exclusion (it stays eligible for later attempts)
                    return (f"{BUSY_MARK} fragment {f.fid} task {tid} "
                            f"on worker {client.base_uri}: busy "
                            "(load shed)")
                if self.failure_detector is not None:
                    self.failure_detector.record_task_failure(
                        client.base_uri, f"{type(e).__name__}: {e}")
                with self._excl_lock:
                    self.excluded.add(wi)
                return (f"fragment {f.fid} task {tid} on worker "
                        f"{client.base_uri}: {type(e).__name__}: {e}")
            finally:
                if beat is not None:
                    beat.release()  # terminal attempt: stop charging
            t1 = _time.perf_counter()
            st.last_window = (t0, t1)
            if self.failure_detector is not None:
                self.failure_detector.record_task_success(
                    client.base_uri)
            straggler.record(f.fid, t1 - t0)
            batches = None
            if spool is None:
                # decode in the attempt thread so N pullers overlap
                # deserialization (the pre-FTE path's concurrency); a
                # bad frame is a retriable attempt failure
                try:
                    batches = [deserialize_batch(fr, self.device)
                               for fr in frames]
                except Exception as e:     # noqa: BLE001
                    return (f"fragment {f.fid} task {tid}: "
                            f"deserialize failed: "
                            f"{type(e).__name__}: {e}")
            # first-commit-wins: with a spool the COMMITTED marker is
            # the arbiter (a late duplicate is discarded on disk);
            # without one the in-memory winner slot is
            winner_attempt = attempt
            if spool is not None:
                try:
                    # single-host double-write coalescing: when the
                    # worker already committed these exact frames to
                    # ITS spool and that
                    # directory is visible on this host (shared spool
                    # root), hard-link instead of rewriting the bytes
                    src_dir = meta.get("spool_dir")
                    linker = getattr(spool, "commit_linked", None)
                    winner_attempt = None
                    if src_dir and linker is not None \
                            and os.path.isdir(src_dir):
                        try:
                            # expect_frames: the header is worker-
                            # supplied, so the linked bytes must match
                            # the pulled pages before they can become
                            # the authoritative spooled output
                            winner_attempt = linker(
                                qid, f.fid, st.part, attempt, src_dir,
                                expect_frames=frames)
                        except Exception:  # noqa: BLE001
                            # coalescing is strictly best-effort: a
                            # reaped source dir or a content mismatch
                            # falls through to the byte commit of the
                            # frames actually pulled, instead of
                            # failing a finished attempt
                            winner_attempt = None
                    if winner_attempt is None:
                        winner_attempt = spool.commit(
                            qid, f.fid, st.part, attempt, frames)
                except Exception as e:     # noqa: BLE001 — ENOSPC etc
                    # an unwritable spool is a retriable attempt
                    # failure, not a hung query
                    return (f"fragment {f.fid} task {tid}: spool "
                            f"commit failed: {type(e).__name__}: {e}")
            won = False
            with st.lock:
                if st.winner is None and winner_attempt == attempt:
                    st.winner = (attempt, wi, speculative)
                    if spool is None:
                        st.batches = batches
                    won = True
            if not won:
                return None     # duplicate output discarded
            # from here on the winner MUST set st.done (finally below):
            # a crash between winner-set and done-set would strand the
            # main thread's untimed wait
            try:
                if speculative:
                    with self._stats_lock:
                        self.speculative_wins += 1
                    SPECULATIVE_WINS.inc()
                # telemetry is best-effort: the result pages are
                # already committed, so a failed stats fetch (transient
                # status GET error, graft bug) must never fail the
                # query
                if self.collect_stats:
                    status = client.status(tid, traceparent=tp)
                    # the worker's observed per-operator rows/walls
                    # feed the coordinator's learned-stats registry
                    # (exec/learnedstats.py)
                    from .learnedstats import LEARNED_STATS
                    LEARNED_STATS.merge(status.get("learnedStats")
                                        or [])
                    # so do its program shapes, into the hot-shape
                    # registry (exec/hotshapes.py): dispatched fragments
                    # become pre-warmable though the coordinator never
                    # ran them
                    from .hotshapes import HOT_SHAPES
                    HOT_SHAPES.merge(status.get("hotShapes") or [])
                    reported = [NodeStats.from_dict(d) for d in
                                status.get("nodeStats") or []]
                    if reported:
                        worker_stats[f.fid].append(reported)
                    # list.append is atomic; sums happen after the wait
                    worker_resources.append((
                        int(status.get("peakMemoryBytes") or 0),
                        int(status.get("spillBytes") or 0)))
                    cpu_s = float(status.get("cpuSeconds") or 0.0)
                    with self._stats_lock:
                        self.stream_chunks += int(
                            status.get("streamChunks") or 0)
                        self.stream_h2d_bytes += int(
                            status.get("streamH2dBytes") or 0)
                        self.cpu_seconds += cpu_s
                        self.fragment_cpu[f.fid] = \
                            self.fragment_cpu.get(f.fid, 0.0) + cpu_s
                    if trace is not None:
                        # the pre-minted id becomes the span the
                        # worker's subtree already points at
                        sp = trace.record(
                            f"fragment_{f.fid}_execute", t0, t1,
                            parent=trace_parent, span_id=span_id,
                            worker=wi, task=tid, attempt=attempt,
                            speculative=speculative,
                            cpu_s=round(cpu_s, 6))
                        trace.graft(sp, status.get("spans") or [])
                # a remote task IS this engine's split of work: its
                # completion is the SplitCompleted lifecycle event
                if on_split is not None:
                    on_split(f"task:{tid}", t1 - t0)
            except Exception:      # noqa: BLE001
                pass
            finally:
                st.done.set()
            return None

        def run_task(st: _TaskRun):
            """Primary attempt loop: dispatch, and on failure consult
            the retry budgets, pick a replacement worker, back off,
            go again."""
            failures = 0
            busy_declines = 0
            attempt = st.next_attempt()
            while True:
                if attempt > 0:
                    # a replacement attempt may land on a worker that
                    # joined after dispatch (live membership)
                    self._sync_workers()
                with self._excl_lock:
                    banned = frozenset(self.excluded)
                wi = pick_worker(len(self.workers), st.part, attempt,
                                 banned, alive)
                try:
                    err = run_attempt(st, attempt, wi)
                except Exception as e:   # noqa: BLE001 — a bug in the
                    # attempt path must surface as a task failure, not
                    # kill this daemon thread with st.done forever
                    # unset (the main wait has no timeout)
                    err = (f"fragment {st.fragment.fid} attempt "
                           f"{attempt}: internal: "
                           f"{type(e).__name__}: {e}")
                if err is None:
                    return
                failures += 1
                st.errors.append(err)
                cancel = getattr(session, "cancel", None)
                canceled = cancel is not None and cancel.is_set()
                rem = self._remaining_s()
                if rem is not None and rem <= 0:
                    # the deadline outranks the retry budget: a retry
                    # past it would only burn worker time the client
                    # has already given up on
                    canceled = True
                if err.startswith(BUSY_MARK) and not canceled:
                    # a BUSY decline is not a task failure — the
                    # dispatch never started. Back off and rotate
                    # WITHOUT consuming the retry budget (bounded so
                    # a permanently wedged fleet still fails): this is
                    # how the existing machinery "absorbs" load shed
                    busy_declines += 1
                    if busy_declines <= BUSY_RETRY_LIMIT:
                        delay = backoff_delay(
                            policy, failures,
                            f"{qid}.{st.fragment.fid}.{st.part}")
                        if rem is not None:
                            delay = min(delay, max(rem, 0.0))
                        if st.done.wait(delay):
                            return
                        attempt = st.next_attempt()
                        continue
                if canceled or not controller.record_failure(
                        (st.fragment.fid, st.part)):
                    # out of attempts — but first-completion-wins cuts
                    # both ways: a healthy speculative duplicate still
                    # in flight decides the task's fate, not this
                    # exhausted primary (setting done now would abort
                    # its page pull via the _MultiEvent watch)
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
                with self._stats_lock:
                    self.task_retries += 1
                TASK_RETRIES.inc()
                if trace is not None:
                    t0, t1 = st.last_window
                    trace.record(
                        f"fragment_{st.fragment.fid}_retry", t0, t1,
                        parent=trace_parent, part=st.part,
                        worker=wi, attempt=attempt, error=err[-160:])
                delay = backoff_delay(
                    policy, failures,
                    f"{qid}.{st.fragment.fid}.{st.part}")
                if rem is not None:
                    delay = min(delay, max(rem, 0.0))
                if st.done.wait(delay):
                    return   # a speculative sibling won during backoff
                attempt = st.next_attempt()

        def run_speculative(st: _TaskRun, attempt: int, wi: int):
            try:
                err = run_attempt(st, attempt, wi, speculative=True)
                if err is not None:
                    st.errors.append("[speculative] " + err)
            except Exception as e:       # noqa: BLE001
                st.errors.append("[speculative] internal: "
                                 f"{type(e).__name__}: {e}")
            finally:
                # the retry loop may be blocked on this duplicate's
                # outcome before declaring the task failed
                st.spec_done.set()

        def monitor(stop_ev: threading.Event):
            """Straggler watch: poll running tasks' elapsed time
            against the fragment's completed-runtime median; launch at
            most one speculative duplicate per task on a different
            worker."""
            while not stop_ev.wait(0.05):
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
                    # winner set but done not yet (the winner thread is
                    # in its best-effort telemetry block): the task is
                    # finished — duplicating it would only burn query
                    # retry budget
                    if settled or t0 is None:
                        continue
                    elapsed = _time.perf_counter() - t0
                    if not straggler.is_straggler(st.fragment.fid,
                                                  elapsed):
                        continue
                    rem = self._remaining_s()
                    if rem is not None and rem <= 0:
                        continue     # past the deadline: no new work
                    if not controller.grant_speculation(
                            (st.fragment.fid, st.part)):
                        continue
                    st.speculated = True
                    attempt = st.next_attempt()
                    # a freshly joined worker is the ideal speculation
                    # target: idle by definition
                    self._sync_workers()
                    with self._excl_lock:
                        banned = frozenset(
                            self.excluded
                            | ({wi_cur} if wi_cur is not None
                               else set()))
                    wi = pick_worker(len(self.workers), st.part,
                                     attempt, banned, alive)
                    if wi == wi_cur:
                        # every other worker is banned or dead: a
                        # duplicate on the straggler itself cannot
                        # help — skip the launch (the consumed budget
                        # slot is the degenerate fleet's toll). The
                        # no-op duplicate is resolved immediately so
                        # the retry loop never waits on it
                        st.spec_done.set()
                        continue
                    with self._stats_lock:
                        self.speculative_launches += 1
                    SPECULATIVE_TASKS.inc()
                    if trace is not None:
                        trace.record(
                            f"fragment_{st.fragment.fid}_speculate",
                            t0, _time.perf_counter(),
                            parent=trace_parent, part=st.part,
                            attempt=attempt, worker=wi,
                            straggler_worker=wi_cur)
                    threading.Thread(target=run_speculative,
                                     args=(st, attempt, wi),
                                     daemon=True).start()

        # daemon threads + event-based completion: first-completion-
        # wins must not block on joining a loser thread stuck in a
        # page pull on a wedged worker (its watch event unblocks it at
        # the next poll; a fully hung socket times out on its own)
        for st in tasks:
            threading.Thread(target=run_task, args=(st,),
                             daemon=True).start()
        stop_ev = threading.Event()
        if speculation_on:
            threading.Thread(target=monitor, args=(stop_ev,),
                             daemon=True).start()
        try:
            for st in tasks:
                st.done.wait()
        finally:
            stop_ev.set()
        failed = [st for st in tasks if st.failed]
        if failed:
            if spool is not None:
                spool.release(qid)
            raise QueryError(
                "remote task failed: " + "; ".join(
                    "; ".join(st.errors[-2:]) for st in failed[:3]))
        if self.collect_stats:
            self.fragment_expected = nparts
            for f in frags:
                self.fragment_stats[f.fid] = merge_node_stats(
                    worker_stats[f.fid])
                self.fragment_workers[f.fid] = len(worker_stats[f.fid])
            for peak, spill in worker_resources:
                self.peak_memory_bytes = max(self.peak_memory_bytes,
                                             peak)
                self.spill_bytes += spill
        # gather: the combine input comes OFF THE SPOOL (when one is
        # configured) — completed fragment output survives outside the
        # dispatch threads' memory, which is what makes a late retry
        # of the combine (or a restarted coordinator reading a shared
        # spool dir) possible at all
        out: Dict[int, Batch] = {}
        try:
            for f in frags:
                batches: List[Batch] = []
                for st in tasks:
                    if st.fragment is not f:
                        continue
                    if spool is None:
                        part_batches = st.batches
                    else:
                        frames = spool.read(qid, f.fid, st.part)
                        part_batches = (None if frames is None else
                                        [deserialize_batch(fr,
                                                           self.device)
                                         for fr in frames])
                    if part_batches is None:
                        # the task WON, so its output must be readable
                        # — silently skipping a part would return an
                        # answer missing a whole shard's rows
                        raise QueryError(
                            f"fragment {f.fid} part {st.part}: "
                            "committed output missing from spool")
                    batches.extend(part_batches)
                if not batches:
                    raise QueryError(
                        f"fragment {f.fid} returned no pages")
                out[f.fid] = (device_concat(batches)
                              if len(batches) > 1 else batches[0])
        finally:
            if spool is not None:
                spool.release(qid)
        return out


# error-string marker for a worker's retryable BUSY shed, and the
# bound on budget-free re-dispatches per task (a permanently wedged
# fleet must still fail the query through the normal budget machinery
# instead of spinning forever)
BUSY_MARK = "[busy]"
BUSY_RETRY_LIMIT = 64


def _busy_decline(e: BaseException) -> bool:
    """True for a worker's retryable BUSY shed (HTTP 503 from
    server/task_worker.py WorkerBusyError): the dispatch was DECLINED,
    not failed — the retry machinery rotates to another worker and the
    shedding worker keeps its health record clean."""
    import urllib.error
    return isinstance(e, urllib.error.HTTPError) and e.code == 503


class _TaskRun:
    """One (fragment, part) task's dispatch state across attempts
    (the reference's per-task attempt bookkeeping in
    EventDrivenFaultTolerantQueryScheduler, collapsed)."""

    __slots__ = ("fragment", "part", "done", "spec_done", "lock",
                 "failed", "errors", "batches", "winner", "_attempts",
                 "running_since", "running_worker", "speculated",
                 "last_window")

    def __init__(self, fragment: _Fragment, part: int):
        self.fragment = fragment
        self.part = part
        self.done = threading.Event()
        # resolved outcome of the (at most one) speculative duplicate
        self.spec_done = threading.Event()
        self.lock = threading.Lock()
        self.failed = False
        self.errors: List[str] = []
        self.batches: Optional[List[Batch]] = None  # no-spool result
        self.winner: Optional[Tuple[int, int, bool]] = None
        self._attempts = 0
        self.running_since: Optional[float] = None
        self.running_worker: Optional[int] = None
        self.speculated = False
        self.last_window: Tuple[float, float] = (0.0, 0.0)

    def next_attempt(self) -> int:
        """Allocate a unique attempt id (shared by the retry loop and
        the speculation monitor — task ids must never collide)."""
        with self.lock:
            attempt = self._attempts
            self._attempts += 1
            return attempt


class _MultiEvent:
    """``is_set()`` ORs several events — the page pull's cancel hook
    combines user cancellation with sibling-attempt-won abort."""

    __slots__ = ("_events",)

    def __init__(self, *events):
        self._events = [e for e in events if e is not None]

    def is_set(self) -> bool:
        return any(e.is_set() for e in self._events)


class _Placeholder(PlanNode):
    """Marks a cut point until the gathered batch replaces it."""

    __slots__ = ("fid", "_schema")

    def __init__(self, fid: int, schema):
        self.fid = fid
        self._schema = dict(schema)

    def output_schema(self):
        return dict(self._schema)


def _replace_sources(node: PlanNode, new_sources) -> PlanNode:
    import dataclasses
    src_fields = [f.name for f in dataclasses.fields(node)
                  if f.name in ("source", "left", "right", "children",
                                "filtering_source")]
    updates = {}
    i = 0
    for fname in src_fields:
        cur = getattr(node, fname)
        if isinstance(cur, PlanNode):
            updates[fname] = new_sources[i]
            i += 1
        elif isinstance(cur, tuple):
            updates[fname] = tuple(new_sources[i:i + len(cur)])
            i += len(cur)
    return dc_replace(node, **updates)


class DistributedHostQueryRunner:
    """DistributedQueryRunner analog: parse/plan/optimize at the
    coordinator, execution on remote worker processes — multi-stage
    with a worker-to-worker partitioned exchange under
    ``multistage_execution``, flat leaf fragments + coordinator
    combine otherwise (reference: testing/trino-testing's
    DistributedQueryRunner booting a coordinator + N workers on
    ephemeral ports)."""

    def __init__(self, worker_uris: List[str],
                 session: Optional[Session] = None, catalogs=None,
                 collect_node_stats: bool = False,
                 failure_detector=None, spool=None,
                 worker_supplier: Optional[
                     Callable[[], List[str]]] = None,
                 manifest_store=None, manifest_meta=None,
                 device: DeviceLike = None):
        from ..runner import LocalQueryRunner
        self._local = LocalQueryRunner(session=session, device=device,
                                       catalogs=catalogs)
        self.device = self._local.device
        self.session = self._local.session
        self.catalogs = self._local.catalogs
        self.worker_uris = list(worker_uris)
        self.collect_node_stats = collect_node_stats
        # fault-tolerant execution plumbing (trino_tpu/fte/): both are
        # optional — the scheduler creates a default spool (config/
        # session-selected backend) when the session asks for
        # retry_policy=TASK and none was given. ``worker_supplier``
        # enables live membership: re-polled at retry/speculation time
        # so late-joining workers receive attempts mid-query.
        self.failure_detector = failure_detector
        self.spool = spool
        self.worker_supplier = worker_supplier
        # mid-flight failover plumbing (fte/recovery.py): when wired,
        # stage-DAG dispatches spool an execution manifest first
        self.manifest_store = manifest_store
        self.manifest_meta = manifest_meta
        # failover-resume accounting of the last execute()/resume()
        self.failover_resumed = 0
        self.failover_replayed = 0

    def execute(self, sql: str):
        import time as _time
        from ..obs.metrics import (QUERY_PEAK_MEMORY_BYTES,
                                   QUERY_WALL_SECONDS)
        from ..obs.trace import QueryTrace, null_span
        from ..planner.logical import LogicalPlanner
        from ..planner.optimizer import optimize
        from ..plan.nodes import plan_tree_lines
        from ..runner import QueryResult
        from ..sql import ast as A
        from ..sql.parser import parse_statement
        from ..types import VARCHAR
        t0 = _time.perf_counter()
        stmt = parse_statement(sql)
        analyze = False
        if isinstance(stmt, A.Explain):
            if not stmt.analyze \
                    or not isinstance(stmt.statement, A.QueryStatement):
                return self._local.execute(sql)
            # distributed EXPLAIN ANALYZE: run the inner query over the
            # workers WITH stats so the rendering shows real per-
            # fragment numbers, not coordinator-only timings
            analyze = True
            stmt = stmt.statement
        if not isinstance(stmt, A.QueryStatement):
            return self._local.execute(sql)   # DDL etc: coordinator-only
        collect = self.collect_node_stats or analyze
        trace = (QueryTrace(getattr(self.session, "query_id", ""))
                 if collect else None)
        sp = trace.span if trace is not None else null_span
        prev_trace = self.session.trace
        self.session.trace = trace
        try:
            with sp("plan"):
                planner = LogicalPlanner(self.catalogs, self.session)
                plan = planner.plan(stmt)
            with sp("optimize"):
                plan = optimize(plan, self.catalogs, self.session)
            sched = RemoteScheduler(
                self.worker_uris, self.catalogs, self.session,
                collect_stats=collect,
                failure_detector=self.failure_detector,
                spool=self.spool,
                worker_supplier=self.worker_supplier,
                manifest_store=self.manifest_store,
                manifest_meta=self.manifest_meta, device=self.device)
            with sp("execute"):
                batch = sched.execute_plan(plan)
            self.failover_resumed = sched.failover_resumed
            self.failover_replayed = sched.failover_replayed
        finally:
            self.session.trace = prev_trace
            # same latency histogram LocalQueryRunner feeds, in the
            # finally for the same reason: failed/timed-out queries
            # must not vanish from the SLO dashboards
            QUERY_WALL_SECONDS.observe(_time.perf_counter() - t0)
            # OTLP export (obs/otlp.py): the finished distributed
            # trace, worker spans included with their ids, leaves
            # through the configured sinks; in the finally so failed
            # queries' traces export too
            if trace is not None and trace.roots:
                from ..obs.otlp import maybe_export
                maybe_export(trace, session=self.session)
        if collect:
            # sched.peak_memory_bytes is only populated when worker
            # stats were fetched; a non-stats query must not clobber
            # the gauge's last real sample with 0
            QUERY_PEAK_MEMORY_BYTES.set(sched.peak_memory_bytes)
        if analyze:
            from .executor import render_analyze_lines
            plan_lines = plan_tree_lines(plan)
            if sched.stage_lines:
                # the stage DAG the fragmenter actually dispatched —
                # EXPLAIN ANALYZE's proof of WHERE operators ran
                plan_lines = plan_lines + [""] + sched.stage_lines
            lines = render_analyze_lines(plan_lines,
                                         sched.stats, trace)
            res = QueryResult(["Query Plan"], [VARCHAR],
                              [[l] for l in lines])
            res.stats = sched.stats
            res.trace = trace
            return res
        schema = batch.schema()
        types = [schema[s] for s in plan.symbols]
        res = QueryResult(list(plan.names), types, batch.to_pylist())
        res.plan_lines = plan_tree_lines(plan)
        res.trace = trace
        res.peak_reserved_bytes = sched.peak_memory_bytes
        res.spill_bytes = sched.spill_bytes
        res.stream_chunks = sched.stream_chunks
        res.stream_h2d_bytes = sched.stream_h2d_bytes
        res.cpu_seconds = sched.cpu_seconds
        res.speculative_wins = sched.speculative_wins
        # canonical plan key for the history record / learned stats
        # (exec/learnedstats.py): computed from the OPTIMIZED root
        # plan, the same identity a local run of this query would get
        from .learnedstats import plan_key_for
        res.plan_key = plan_key_for(plan)
        if self.collect_node_stats:
            res.stats = sched.stats
        return res

    def resume(self, manifest: dict, resume_spool=None):
        """Finish a RUNNING query from its spooled execution manifest
        (coordinator failover; fte/recovery.py). The stage DAG is
        rebuilt from the manifest's serde-proven wire encodings, the
        ORIGINAL execution id and fan-out are pinned (exchange keys
        must address the partitions earlier attempts committed), and
        only partitions without a COMMITTED marker are dispatched —
        then the combine re-runs and the result is assembled exactly
        like a first-run query's.

        ``resume_spool`` is the spool the WORKERS committed exchange
        output to; defaults to the shared local worker spool base."""
        import time as _time
        from ..obs.metrics import QUERY_WALL_SECONDS
        from ..plan.serde import from_jsonable
        from ..runner import QueryResult
        from ..stage.fragmenter import Stage, StageDAG
        t0 = _time.perf_counter()
        stages = []
        payloads: Dict[int, dict] = {}
        for rec in manifest.get("stages") or []:
            sid = int(rec["sid"])
            payloads[sid] = rec["payload"]
            stages.append(Stage(
                sid=sid, plan=from_jsonable(rec["payload"]),
                inputs=tuple(int(i) for i in (rec.get("inputs") or ())),
                consumer=(None if rec.get("consumer") is None
                          else int(rec["consumer"])),
                max_tasks=(None if rec.get("maxTasks") is None
                           else int(rec["maxTasks"]))))
        if not stages:
            raise QueryError("execution manifest carries no stages")
        stages.sort(key=lambda st: st.sid)
        root = from_jsonable(manifest["rootPlan"])
        dag = StageDAG(stages, root)
        if resume_spool is None:
            from ..fte.spool import make_spool, worker_spool_base
            resume_spool = make_spool(
                "local", local_base_dir=worker_spool_base())
        sched = RemoteScheduler(
            self.worker_uris, self.catalogs, self.session,
            collect_stats=self.collect_node_stats,
            failure_detector=self.failure_detector,
            spool=self.spool,
            worker_supplier=self.worker_supplier, device=self.device)
        try:
            batch = sched._execute_stages(
                dag, payloads,
                resume={"exec_qid": manifest["execId"],
                        "ntasks": manifest.get("ntasks") or {},
                        "spool": resume_spool})
        finally:
            QUERY_WALL_SECONDS.observe(_time.perf_counter() - t0)
        self.failover_resumed = sched.failover_resumed
        self.failover_replayed = sched.failover_replayed
        schema = batch.schema()
        types = [schema[s] for s in root.symbols]
        res = QueryResult(list(root.names), types, batch.to_pylist())
        res.peak_reserved_bytes = sched.peak_memory_bytes
        res.spill_bytes = sched.spill_bytes
        res.stream_chunks = sched.stream_chunks
        res.stream_h2d_bytes = sched.stream_h2d_bytes
        res.cpu_seconds = sched.cpu_seconds
        return res


def _substitute(node: PlanNode, repl: Dict[int, PlanNode]) -> PlanNode:
    if isinstance(node, _Placeholder):
        return repl[node.fid]
    srcs = node.sources
    if not srcs:
        return node
    new = [_substitute(s, repl) for s in srcs]
    if all(a is b for a, b in zip(new, srcs)):
        return node
    return _replace_sources(node, new)
