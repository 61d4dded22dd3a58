"""Cluster memory governance: pool accounting + low-memory killer.

Counterpart of ``trino_tpu/server/memory.py`` (host only).

Reference parity: memory/ClusterMemoryManager.java (per-query
reservations aggregated into the GENERAL pool, enforcement of
query.max-memory) + memory/LowMemoryKiller.java
(TotalReservationOnBlockedNodesLowMemoryKiller collapsed to
"kill the largest reservation in the offending scope") +
resource-group soft memory limits (InternalResourceGroup
softMemoryLimit). Redesigned small: one ``ClusterMemoryPool`` tracks a
high-water reservation per query (fed by Executor._reserve capacity
estimates — the engine's single allocation decision point), a
``ClusterMemoryManager`` aggregates reservations per resource group,
and a breach of the pool (or a group's limit) kills the LARGEST query
in the offending scope with a ``CLUSTER_OUT_OF_MEMORY``-shaped error
naming the victim and the pool state. A query exceeding its own
``query_max_memory`` cap fails in-thread with
``EXCEEDED_GLOBAL_MEMORY_LIMIT`` — its reservation is the problem, so
no other query need die for it.

Thread model: reservations arrive from per-query executor threads
(dispatch threads under the coordinator tracker); one lock guards the
ledger. Kill callbacks run OUTSIDE the lock — they take the query's
own state lock (server/coordinator.py _Query._transition) and must
not nest under ours.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..exec.executor import QueryError
from ..obs.metrics import (LIVE_MEMORY_BEATS, MEMORY_KILLS,
                           MEMORY_POOL_BYTES, MEMORY_POOL_QUERIES)


def parse_data_size(value: str) -> int:
    """Trino DataSize strings ("50GB", "512MB", "1.5GB") or raw byte
    counts -> bytes (io.airlift.units.DataSize, decimal-suffix-free
    subset: the reference uses binary multipliers for B/kB/MB/...)."""
    s = str(value).strip()
    units = {"B": 1, "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30,
             "TB": 1 << 40, "PB": 1 << 50}
    up = s.upper()
    for suffix, mult in sorted(units.items(), key=lambda kv: -len(kv[0])):
        if up.endswith(suffix):
            num = s[:-len(suffix)].strip()
            return int(float(num) * mult)
    return int(float(s))


class MemoryGovernanceError(QueryError):
    """Raised in the reserving thread when ITS reservation is the
    violation (per-query cap, or the killer chose the caller). A
    QueryError, so it leaves the executor as it is; ``error_name``
    feeds errors.classify — the client sees the Trino error name, not
    a generic 500."""

    def __init__(self, message: str, error_name: str):
        super().__init__(message, error_name=error_name)


class ClusterMemoryPool:
    """The GENERAL pool: per-query high-water reservations against one
    cluster-wide byte budget (memory/ClusterMemoryPool.java)."""

    def __init__(self, max_bytes: int, name: str = "general"):
        self.name = name
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # qid -> ({source: bytes}, group full name). A query's
        # reservation is the SUM of its per-source high-water marks:
        # "coordinator" is the local executor's capacity estimates
        # (the pre-PR-14 figure), and every worker TASK that streams
        # live reservation beats (server/task_worker.py
        # liveMemoryBytes) contributes its own source — the reference
        # sums per-node task reservations the same way.
        self._reservations: Dict[str, Tuple[Dict[str, int], str]] = {}
        # running total maintained by source-level deltas: live-memory
        # beats arrive per status poll (20Hz per running task), so the
        # per-beat cost must not be a full-ledger re-sum under the
        # same lock the executors' reserve() path contends for
        self._total = 0
        MEMORY_POOL_BYTES.set(self.max_bytes, kind="total")
        MEMORY_POOL_BYTES.set(0, kind="reserved")

    # -- ledger ---------------------------------------------------------
    def _publish_locked(self) -> int:
        # gauges published under the lock: a preempted stale publish
        # would otherwise overwrite a newer total and persist on an
        # idle pool
        MEMORY_POOL_BYTES.set(self._total, kind="reserved")
        MEMORY_POOL_QUERIES.set(len(self._reservations))
        return self._total

    def set_reservation(self, qid: str, nbytes: int, group: str,
                        source: str = "coordinator"
                        ) -> Tuple[int, int]:
        """Record ``qid``'s high-water reservation for one source;
        returns (the query's current total reservation, the pool
        total) so the caller never re-scans the ledger on the
        per-allocation hot path."""
        with self._lock:
            entry = self._reservations.get(qid)
            if entry is None:
                entry = ({}, group)
                self._reservations[qid] = entry
            srcs = entry[0]     # mutated in place: only ever read
            #                     under this same lock
            prev = srcs.get(source, 0)
            if int(nbytes) > prev:
                srcs[source] = int(nbytes)
                self._total += int(nbytes) - prev
            mine = sum(srcs.values())
            total = self._publish_locked()
        return mine, total

    def clear_source(self, qid: str, source: str) -> None:
        """Drop one source's reservation (a worker task/attempt
        reached a terminal state: its memory is free on the worker,
        so the pool must stop charging the query for it — otherwise
        retried attempts and sequential stage tasks ACCUMULATE dead
        high-water marks until the killer fires on a query that never
        held that much at once). The coordinator source stays
        monotonic, exactly as before."""
        with self._lock:
            entry = self._reservations.get(qid)
            if entry is None:
                return
            self._total -= entry[0].pop(source, 0)
            self._publish_locked()

    def free(self, qid: str) -> None:
        with self._lock:
            entry = self._reservations.pop(qid, None)
            if entry is not None:
                self._total -= sum(entry[0].values())
            self._publish_locked()

    def reserved_bytes(self, group: Optional[str] = None) -> int:
        with self._lock:
            return sum(sum(srcs.values())
                       for srcs, g in self._reservations.values()
                       if group is None or g == group)

    def queries(self, group: Optional[str] = None
                ) -> List[Tuple[str, int, str]]:
        """(qid, bytes, group) snapshots, largest first."""
        with self._lock:
            items = [(q, sum(srcs.values()), g) for q, (srcs, g)
                     in self._reservations.items()
                     if group is None or g == group]
        return sorted(items, key=lambda t: -t[1])

    def info(self) -> dict:
        """system.runtime / /v1/cluster-shaped pool state."""
        with self._lock:
            items = sorted(
                ((q, sum(srcs.values()), g,
                  sum(1 for s in srcs if s != "coordinator"))
                 for q, (srcs, g) in self._reservations.items()),
                key=lambda t: -t[1])
            total = sum(b for _, b, _, _ in items)
        return {"pool": self.name, "maxBytes": self.max_bytes,
                "reservedBytes": total,
                "freeBytes": max(0, self.max_bytes - total),
                "queries": [{"queryId": q, "reservedBytes": b,
                             "group": g, "workerSources": ws}
                            for q, b, g, ws in items]}

    def describe(self, group: Optional[str] = None) -> str:
        """Human-readable pool state for kill messages — the operator
        reads WHICH queries held WHAT when the killer fired."""
        items = self.queries(group)[:5]
        held = ", ".join(f"{q}={b}B" for q, b, _ in items) or "none"
        scope = f"group {group}" if group else f"pool {self.name}"
        return (f"{scope}: reserved {self.reserved_bytes(group)} of "
                f"{self.max_bytes} bytes; top reservations: {held}")


class ClusterMemoryManager:
    """Registration + enforcement: every tracked query registers with
    its group, limits, and a kill callback; ``reserve`` (called from
    the executor via the per-query ``QueryMemoryContext``) updates the
    ledger and runs the low-memory killer when the pool or the
    query's group goes over budget."""

    def __init__(self, pool: ClusterMemoryPool):
        self.pool = pool
        self._lock = threading.Lock()
        # qid -> (kill_fn(message, error_name), group, group_limit,
        #         query_limit)
        self._queries: Dict[str, Tuple[Callable[[str, str], None],
                                       str, int, int]] = {}
        self.kills = 0

    # -- lifecycle ------------------------------------------------------
    def register(self, qid: str, group: str = "global",
                 kill_fn: Optional[Callable[[str, str], None]] = None,
                 group_limit_bytes: int = 0,
                 query_limit_bytes: int = 0) -> "QueryMemoryContext":
        with self._lock:
            self._queries[qid] = (kill_fn or (lambda m, n: None),
                                  group, int(group_limit_bytes),
                                  int(query_limit_bytes))
        return QueryMemoryContext(self, qid)

    def unregister(self, qid: str) -> None:
        with self._lock:
            self._queries.pop(qid, None)
        self.pool.free(qid)

    # -- enforcement ----------------------------------------------------
    def reserve(self, qid: str, nbytes: int) -> None:
        """Record ``qid``'s high-water reservation and enforce, in
        order: the per-query cap (fails the caller), the group limit,
        then the pool limit (each kills the LARGEST query in its
        scope). Raises MemoryGovernanceError when the calling query is
        the one that must stop."""
        with self._lock:
            # registration check and ledger write are ONE atomic step
            # w.r.t. _kill_largest's pop+free (same lock): a victim
            # killed mid-reserve must not re-insert its reservation
            # as a zombie that later gets an innocent query killed
            entry = self._queries.get(qid)
            if entry is None:
                return                   # unregistered: nothing governs
            _, group, group_limit, query_limit = entry
            mine, total = self.pool.set_reservation(qid, nbytes, group)
        if query_limit > 0 and mine > query_limit:
            self.pool.free(qid)
            raise MemoryGovernanceError(
                f"Query {qid} exceeded the global memory limit of "
                f"{query_limit} bytes (reserved {mine} bytes; "
                f"{self.pool.describe(group)})",
                "EXCEEDED_GLOBAL_MEMORY_LIMIT")
        self._relieve_cache_pressure(total)
        if group_limit > 0 \
                and self.pool.reserved_bytes(group) > group_limit:
            self._kill_largest(group, group_limit, caller=qid)
        if self.pool.max_bytes > 0 and total > self.pool.max_bytes:
            self._kill_largest(None, self.pool.max_bytes, caller=qid)

    def reserve_remote(self, qid: str, source: str,
                       nbytes: int) -> None:
        """Fold a WORKER task's live reservation beat into the ledger
        and enforce. Unlike ``reserve`` this never raises: the calling
        thread is a status-poll/page-pull thread, not the governed
        query's executor — every verdict lands through the victim's
        kill callback (whose cancel event propagates to worker tasks
        as a DELETE). This is the live half of the low-memory killer:
        a query ballooning ON a worker is judged by the bytes it
        actually holds there, DURING execution, not by coordinator
        estimates or completion-time peaks."""
        kill_fn = None
        with self._lock:
            entry = self._queries.get(qid)
            if entry is None:
                return                   # finished/killed: stale beat
            _, group, group_limit, query_limit = entry
            mine, total = self.pool.set_reservation(
                qid, nbytes, group, source=source)
            if query_limit > 0 and mine > query_limit:
                # the per-query cap breach is the query's own fault:
                # retire it under the lock (registry + ledger in one
                # step, like _kill_largest) and kill it outside
                kill_fn = entry[0]
                self._queries.pop(qid, None)
                self.kills += 1
                self.pool.free(qid)
                msg = (f"Query {qid} exceeded the global memory limit "
                       f"of {query_limit} bytes (live worker "
                       f"reservations reached {mine} bytes; "
                       f"{self.pool.describe(group)})")
        LIVE_MEMORY_BEATS.inc()
        if kill_fn is not None:
            MEMORY_KILLS.inc()
            kill_fn(msg, "EXCEEDED_GLOBAL_MEMORY_LIMIT")
            return
        self._relieve_cache_pressure(total)
        if group_limit > 0 \
                and self.pool.reserved_bytes(group) > group_limit:
            self._kill_largest(group, group_limit, caller=None)
        if self.pool.max_bytes > 0 and total > self.pool.max_bytes:
            self._kill_largest(None, self.pool.max_bytes, caller=None)

    def _relieve_cache_pressure(self, reserved_total: int) -> None:
        """Cross-query cache governance: the shared scan and replicate
        caches occupy the same memory the pool budgets, so when
        reservations + cache residency exceed the pool, evict cache
        entries FIRST — a cache full of one query's tables
        must never get a neighbor query killed. Only if reservations
        ALONE still breach the pool does the killer run."""
        if self.pool.max_bytes <= 0:
            return
        try:
            from ..exec.scancache import (cache_memory_bytes,
                                          evict_cache_pressure)
            cached = cache_memory_bytes()
            if cached > 0 \
                    and reserved_total + cached > self.pool.max_bytes:
                evict_cache_pressure(
                    reserved_total + cached - self.pool.max_bytes)
        except Exception:   # noqa: BLE001 — relief is best-effort;
            pass            # enforcement below never depends on it

    def _kill_largest(self, group: Optional[str], limit: int,
                      caller: Optional[str]) -> None:
        """LowMemoryKiller: cancel the single largest registered query
        in the offending scope. The victim's kill callback fails it
        with CLUSTER_OUT_OF_MEMORY naming the victim and the pool
        state; if the victim IS the caller, raise instead so the
        error surfaces on its own executor thread immediately.
        ``caller=None`` (remote live-beat feeds) always uses the kill
        callback — the feeding thread is never the victim's own
        executor."""
        victim = kill_fn = None
        vbytes = 0
        with self._lock:
            # re-check the breach under the lock: two threads that
            # BOTH observed an over-budget pool must not each kill a
            # query when freeing one victim already cures it
            if self.pool.reserved_bytes(group) <= limit:
                return
            for q, b, g in self.pool.queries(group):
                entry = self._queries.get(q)
                if entry is None:
                    continue             # finished between snapshots
                victim, vbytes = q, b
                kill_fn = entry[0]
                break
            if victim is None:
                return
            scope = f"resource group {group}" if group else "cluster"
            msg = (f"The cluster is out of memory ({scope} limit "
                   f"{limit} bytes exceeded) and the low-memory "
                   f"killer canceled query {victim} (largest "
                   f"reservation, {vbytes} bytes). Pool state before "
                   f"the kill — {self.pool.describe(group)}")
            # registry drop AND ledger free stay under the lock: a
            # racing reserve re-checking the breach must already see
            # the pool state this kill produces, or one breach kills
            # two queries
            self._queries.pop(victim, None)
            self.kills += 1
            self.pool.free(victim)
        MEMORY_KILLS.inc()
        if caller is not None and victim == caller:
            raise MemoryGovernanceError(msg, "CLUSTER_OUT_OF_MEMORY")
        kill_fn(msg, "CLUSTER_OUT_OF_MEMORY")

    def info(self) -> dict:
        out = self.pool.info()
        out["kills"] = self.kills
        return out


class QueryMemoryContext:
    """The per-query handle the executor feeds (Session.memory).
    ``reserve(bytes)`` is called from Executor._reserve with each
    capacity estimate; the manager keeps the high-water mark."""

    __slots__ = ("_manager", "query_id")

    def __init__(self, manager: ClusterMemoryManager, query_id: str):
        self._manager = manager
        self.query_id = query_id

    def reserve(self, nbytes: int) -> None:
        self._manager.reserve(self.query_id, nbytes)

    def reserve_remote(self, source: str, nbytes: int) -> None:
        """Fold a worker task's live reservation beat into the pool
        (never raises — verdicts land through the kill callback). The
        remote/stage schedulers feed this from task-status polls."""
        self._manager.reserve_remote(self.query_id, source, nbytes)

    def release_remote(self, source: str) -> None:
        """Drop one task attempt's live reservation (the attempt is
        terminal: its memory is free on the worker). Called by the
        schedulers when an attempt completes or fails, so retries and
        sequential stages never accumulate dead high-water marks."""
        self._manager.pool.clear_source(self.query_id, source)

    def budget_bytes(self) -> Optional[int]:
        """The tightest byte budget governing this query (its own
        query_max_memory cap, its group's soft limit, the pool size) —
        None when nothing binds. The streaming engagement check
        (exec/streamjoin.py memory_budget) consults this so a query
        that would breach the POOL un-streamed engages streaming and
        reserves its streamed peak instead of getting killed on the
        full-materialization estimate."""
        m = self._manager
        with m._lock:
            entry = m._queries.get(self.query_id)
        if entry is None:
            return None
        _, _, group_limit, query_limit = entry
        vals = [v for v in (query_limit, group_limit,
                            m.pool.max_bytes) if v and v > 0]
        return min(vals) if vals else None
