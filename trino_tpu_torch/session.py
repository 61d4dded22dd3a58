"""Query session: default catalog/schema + session properties.

Reference parity: core/trino-main/.../Session.java +
SystemSessionProperties.java (88 typed properties; we carry the subset the
TPU engine consults, same names where they exist in the reference).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from .config import CONFIG

_query_counter = itertools.count(1)

# name -> (type, default). Mirrors SystemSessionProperties.java entries.
# Every property here is CONSULTED by the JAX engine (flags that lie
# about capabilities are worse than no flags):
#   join_distribution_type   planner/stats.py choose_join_sides
#   join_reordering_strategy planner/optimizer.py optimize (NONE | AUTOMATIC)
#   task_concurrency         exec/executor.py split parallelism
#   spill_enabled            exec/executor.py streaming (split-wise) agg
#   enable_dynamic_filtering exec/distributed.py join probe pre-filter
#   query_max_memory_per_node config/capacity ceiling (QueryError on breach)
SESSION_PROPERTIES: Dict[str, Tuple[type, object]] = {
    "join_distribution_type": (str, "AUTOMATIC"),   # :53
    "join_reordering_strategy": (str, "AUTOMATIC"),  # :85
    "task_concurrency": (int, 1),                    # :61
    "spill_enabled": (bool, CONFIG.spill_enabled),   # :91
    "enable_dynamic_filtering": (bool, True),        # :123
    # range-exchange distributed ORDER BY (exec/distributed.py
    # _dexec_SortNode); reference SystemSessionProperties :106
    "distributed_sort": (bool, True),
    "query_max_memory_per_node": (int, CONFIG.max_query_memory_per_node),
    # connector pushdown (PushPredicateIntoTableScan /
    # PushLimitIntoTableScan); consulted by planner/optimizer.py
    "pushdown_into_scan": (bool, True),
    # remote-task fan-out cap (SystemSessionProperties
    # HASH_PARTITION_COUNT :58): 0 = one task per live worker
    # (exec/remote.py RemoteScheduler)
    "hash_partition_count": (int, 0),
    # LZ4 page frames on the exchange (exchange.compression-enabled;
    # server/task_worker.py paginate)
    "exchange_compression": (bool, True),
    # wall-clock limit in seconds, 0 = unlimited (QUERY_MAX_RUN_TIME
    # :72). The coordinator derives an ABSOLUTE per-query deadline
    # (session.deadline) from it before dispatch; the executor checks
    # it between plan nodes and the remote/stage schedulers bound every
    # attempt, retry backoff, and speculation grant by the remaining
    # budget — a breach cancels in-flight worker attempts instead of
    # only failing the next coordinator poll (EXCEEDED_TIME_LIMIT)
    "query_max_run_time": (int, 0),
    # cluster-wide per-query memory cap in bytes, 0 = pool-limit only
    # (QUERY_MAX_MEMORY; enforced by server/memory.py when a cluster
    # memory pool is configured — EXCEEDED_GLOBAL_MEMORY_LIMIT)
    "query_max_memory": (int, 0),
    # cost-based join reorder/side decisions from connector statistics
    # (optimizer.use-table-statistics; planner/optimizer.py)
    "use_table_statistics": (bool, True),
    # ---- fault-tolerant execution (trino_tpu/fte/) -------------------
    # NONE fails the query on the first task failure; TASK re-dispatches
    # failed leaf-fragment tasks (reference: RetryPolicy.java +
    # SystemSessionProperties RETRY_POLICY)
    "retry_policy": (str, "NONE"),
    # TOTAL attempts per task incl. the first
    # (task-retry-attempts-per-task)
    "task_retry_attempts": (int, 4),
    # extra attempts (retries + speculative duplicates) across the
    # whole query (query-retry-attempts)
    "query_retry_attempts": (int, 16),
    # exponential backoff window between attempts
    # (retry-initial-delay / retry-max-delay)
    "retry_initial_delay_ms": (int, 50),
    "retry_max_delay_ms": (int, 2000),
    # client-side bound on one task attempt producing pages; a wedged
    # worker turns into a retriable failure instead of a hung query
    "remote_task_timeout": (int, 600),
    # straggler speculation (fte/speculate.py): re-dispatch a running
    # task once it exceeds multiplier x the fragment's median completed
    # runtime (with an absolute floor), first-completion-wins
    "speculation_enabled": (bool, False),
    "speculation_multiplier": (float, 2.0),
    "speculation_min_runtime_ms": (int, 200),
    # ---- static analysis (trino_tpu/analysis/) -----------------------
    # run the PlanSanityChecker after EVERY optimizer pass (debug mode:
    # a broken rewrite is blamed on the pass that broke the invariant).
    # The checker always runs once before remote fragment dispatch
    # regardless of this flag. (reference: the sanity battery
    # PlanSanityChecker runs per-pass under tests/assertions)
    "plan_validation": (bool, False),
    # which spool backend a query's attempts commit through when the
    # scheduler has to create one (fte/spool.py make_spool): "" defers
    # to the process default (CONFIG.spool_backend / env
    # TRINO_TPU_SPOOL_BACKEND); "local" | "memory" override it
    # (reference: exchange-manager selection in exchange.properties)
    "spool_backend": (str, ""),
    # ---- multi-stage MPP (trino_tpu/stage/) --------------------------
    # route distributed queries through the stage-DAG scheduler: the
    # plan is cut at exchange points, joins/aggregations execute ON
    # WORKERS over a hash-partitioned worker-to-worker exchange, the
    # coordinator streams only the root stage. ON by default — the
    # stage DAG IS the engine; the flat leaf-fragment scatter-gather
    # path is the explicit fallback (set false to force it; plans the
    # fragmenter declines fall back to it either way).
    "multistage_execution": (bool, True),
    # eager cross-stage pipelining (stage/scheduler.py): consumer
    # stages dispatch immediately and pull committed upstream
    # partitions WHILE their producer stage is still running (the
    # spool's first-commit-wins frames make partial reads safe). Off =
    # the per-stage barrier (each stage waits for all of its inputs) —
    # kept as the A/B baseline and the conservative mode.
    "stage_pipelining": (bool, True),
    # lower in-slice stage exchanges to device collectives
    # (stage/ici.py): when the whole stage DAG executes on one TPU
    # slice (LocalQueryRunner(distributed=True) / a mesh-backed
    # worker), the hash repartition at stage boundaries runs as
    # jax.lax.all_to_all over ICI instead of spool+HTTP frames — only
    # cross-host edges touch the spool. Off = mesh queries keep the
    # node-at-a-time distributed executor (exec/distributed.py).
    "ici_exchange": (bool, True),
    # task fan-out of intermediate (exchange-fed) stages; 0 = one task
    # per live worker (the leaf fan-out keeps following
    # hash_partition_count — reference: SystemSessionProperties
    # FAULT_TOLERANT_EXECUTION_PARTITION_COUNT)
    "exchange_partition_count": (int, 0),
    # ---- compile amortization (exec/progkey.py + exec/hotshapes.py +
    # exec/aot.py) ----------------------------------------------------
    # record this query's structural program shapes into the hot-shape
    # registry (the worker pre-warm feed): off = the query still HITS
    # warm caches but contributes nothing to them (e.g. exploratory
    # one-off SQL that must not evict the fleet's hot shapes)
    "prewarm_enabled": (bool, CONFIG.prewarm_enabled),
    # per-query budget of NEW registry entries (a generated-SQL storm
    # of one-off shapes keeps hitting existing entries but cannot
    # flood the feed); also the default count served at /v1/hotshapes
    # when the puller names no k
    "hot_shape_top_k": (int, CONFIG.prewarm_top_k),
    # ---- beyond-HBM morsel streaming (exec/streamjoin.py) ------------
    # chunk row count for streamed operators: 0 (default) auto-engages
    # streaming only when an operator's full-materialization estimate
    # exceeds the memory budget, with the chunk capacity derived from
    # the budget; > 0 FORCES every streamable scan chain / probe join
    # / streaming aggregation to chunk at (the power-of-two bucket of)
    # this row count — tests and bench pin the capacity this way;
    # < 0 disables streaming (fall back to the materialized path and
    # its memory errors — the operator escape hatch)
    "stream_chunk_rows": (int, CONFIG.stream_chunk_rows),
    # ---- worker-side multi-query runtime (exec/taskexec.py) ----------
    # stream per-task live memory reservations from workers back into
    # the coordinator's cluster memory pool DURING execution (status-
    # poll beats), so the low-memory killer acts on live worker bytes
    # instead of coordinator-side estimates. Off = workers still
    # account locally but the pool only sees coordinator reservations
    # + completion-time peaks (the pre-PR-14 behavior; the escape
    # hatch for tests pinning killer provenance).
    "live_memory_feedback": (bool, True),
    # ---- point-lookup serving (exec/resultcache.py +
    # exec/taskexec.py RaggedBatcher) ----------------------------------
    # serve a repeated identical deterministic query straight from the
    # coordinator's result cache (canonical program key + split
    # fingerprint, invalidated by connector data version) with zero
    # dispatched tasks. Opt-in: a cached result is synthesized without
    # plan/trace/stats, so interactive EXPLAIN ANALYZE-style workflows
    # keep the default off (dashboards SET it on).
    "result_cache_enabled": (bool, False),
    # coalesce compatible small Filter/Project chains of concurrent
    # queries (same canonical program key, same connector, combined rows
    # under ragged_batch_max_rows) into ONE ragged batch that the chain
    # runs over once, demuxed per query (exec/taskexec.py
    # RaggedBatcher). Opt-in: the formation window adds latency to solo
    # queries, so only storm-shaped workloads should enable it.
    "ragged_batching": (bool, False),
    # combined-row cap for one ragged batch (the batch-capacity
    # bucket); fragments whose sum would exceed it run solo
    "ragged_batch_max_rows": (int, CONFIG.ragged_batch_rows),
    # ---- distributed tracing (obs/trace.py + obs/otlp.py) ------------
    # export this query's finished trace to the configured OTLP sinks
    # (TRINO_TPU_OTLP_FILE / TRINO_TPU_OTLP_ENDPOINT). Off = the trace
    # still exists (EXPLAIN ANALYZE, /v1/query, /v1/trace) but nothing
    # leaves the process — the per-query opt-out for sensitive SQL.
    "otlp_export": (bool, True),
    # ---- query history + learned statistics (obs/history.py +
    # exec/learnedstats.py) --------------------------------------------
    # append this query's terminal record to the coordinator's durable
    # history store (GET /v1/history, system.runtime.queries). Off =
    # the query runs unrecorded — the per-query opt-out for sensitive
    # SQL (the record carries the statement text and digest).
    "query_history_enabled": (bool, True),
    # fold this query's observed per-operator rows-in/rows-out and
    # wall time into the learned-stats registry (selectivity and
    # rows/s EMAs keyed by canonical program key — GET /v1/stats,
    # system.runtime.operator_stats, the adaptive cost model's seed).
    # Off = the query still BENEFITS from learned priors but
    # contributes nothing (e.g. deliberately skewed test corpora).
    "learned_stats_enabled": (bool, True),
    # slow-query log threshold in milliseconds: a terminal query whose
    # wall time (queued included) crosses it is written — full record,
    # trace id linked — to slow_queries.jsonl next to the history
    # file. 0 disables the outlier log (the default).
    "slow_query_log_ms": (int, 0),
    # ---- streaming ingestion + continuous queries (streaming/) -------
    # default re-dispatch cadence for continuous-query jobs created
    # without an explicit poll_interval_ms (streaming/continuous.py;
    # the per-job spec value always wins). Milliseconds between the
    # end of one incremental cycle and the start of the next.
    "stream_poll_interval_ms": (int, CONFIG.stream_poll_interval_ms),
    # default allowed event-time lateness for window jobs created
    # without an explicit lateness_ms: the watermark trails
    # max(event time) by this much, so late rows within the horizon
    # still re-aggregate on the next cycle
    "stream_lateness_ms": (int, CONFIG.stream_lateness_ms),
}


@dataclass
class Session:
    catalog: Optional[str] = None
    schema: Optional[str] = None
    user: str = "user"
    properties: Dict[str, object] = field(default_factory=dict)
    # cooperative cancellation: the executor checks this between plan
    # nodes (execution/QueryStateMachine's transitionToCanceled analog)
    cancel: Optional[object] = None
    # PREPARE name FROM stmt registry (reference: Session.java
    # preparedStatements + execution/PrepareTask.java)
    prepared: Dict[str, object] = field(default_factory=dict)
    # telemetry (obs/): the current query's span tree — the runner
    # installs one per query; the executor nests jit_trace /
    # device_execute children under the open execute span
    trace: Optional[object] = None
    # split-completion hook: when set (the coordinator sets one that
    # fans out SplitCompletedEvents), the executor calls it with the
    # split's id and read seconds after each split read
    on_split: Optional[Callable[[str, float], None]] = None
    # id of the query currently executing on this session (stamped by
    # the coordinator / runner; carried into events and spans)
    query_id: str = ""
    # absolute per-query deadline (time.monotonic() timebase), derived
    # from query_max_run_time by the coordinator's tracker (or by the
    # standalone runner) — the executor and the remote/stage schedulers
    # enforce it cooperatively (EXCEEDED_TIME_LIMIT on breach)
    deadline: Optional[float] = None
    # cluster memory governance (server/memory.py): a per-query
    # reservation context; when set, Executor._reserve feeds its
    # capacity estimates into the cluster pool, arming the per-group
    # limits and the low-memory killer
    memory: Optional[object] = None
    # the admitting resource group's identity + scheduling weight
    # (stamped by the coordinator tracker): the remote/stage
    # schedulers ship these in task payloads so the WORKER's shared
    # split scheduler (exec/taskexec.py) drains fair-share by group
    resource_group: str = "global"
    resource_group_weight: float = 1.0
    # worker-side split scheduler yield hook (exec/taskexec.py
    # TaskHandle.checkpoint, installed by server/task_worker.py on
    # task sessions): the executor calls it at split/chunk boundaries
    # so concurrent queries' tasks interleave on the shared runner
    # pool; None outside a scheduled worker task
    split_yield: Optional[object] = None
    # slot-releasing wait hook (exec/taskexec.py TaskHandle.run_blocked,
    # installed next to split_yield): ragged batch formation parks the
    # leader for the window and members for the leader's execution —
    # both waits MUST release the bounded runner slot or members
    # holding every slot deadlock the leader's re-acquire; None = wait
    # inline (standalone runner, no pool to starve)
    slot_wait: Optional[object] = None

    def remaining_time(self) -> Optional[float]:
        """Seconds left before the deadline (None = no deadline).
        Negative once the budget is spent."""
        if self.deadline is None:
            return None
        import time
        return self.deadline - time.monotonic()

    def get(self, name: str):
        if name in self.properties:
            return self.properties[name]
        if name in SESSION_PROPERTIES:
            return SESSION_PROPERTIES[name][1]
        raise KeyError(f"Session property '{name}' does not exist")

    def set(self, name: str, value) -> None:
        if name not in SESSION_PROPERTIES:
            raise KeyError(f"Session property '{name}' does not exist")
        want, _ = SESSION_PROPERTIES[name]
        if want is bool and isinstance(value, str):
            value = value.lower() in ("true", "1", "on")
        self.properties[name] = want(value)

    def reset(self, name: str) -> None:
        self.properties.pop(name, None)

    def next_query_id(self) -> str:
        return f"query_{next(_query_counter)}"
