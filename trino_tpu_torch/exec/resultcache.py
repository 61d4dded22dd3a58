"""Coordinator result cache: an identical deterministic query is served
before planning runs it, with no kernel launch.

Counterpart of ``trino_tpu/exec/resultcache.py`` (host only). Results
are keyed on the canonical program (exec/progkey.py), not the SQL
text, so renamed but identical dashboard queries hit one entry. The
split fingerprint (table handle and accepted pushdowns) pins which data
the program read, and every scanned connector's ``data_version()`` pins
when: a version bump (a memory-connector INSERT, DDL) invalidates the
entry at the next lookup.

Cacheability is conservative: every scanned connector must report a
data version (jdbc and localfile do not), the plan must be
serde-encodable, and no expression may be volatile (now(), rand()).

The cache is mutated by concurrent query threads and by the
memory-pressure ladder (exec/scancache.py ``evict_cache_pressure``);
every traversal holds ``_lock``.
"""


from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from dataclasses import fields as dc_fields, is_dataclass
from typing import Dict, List, Optional, Tuple

from ..config import CONFIG
from ..obs.metrics import METRICS
from ..plan.nodes import OutputNode, PlanNode, TableScanNode
from ..rex import RowExpr, expr_volatile

RESULT_CACHE_LOOKUPS = METRICS.counter(
    "trino_tpu_result_cache_lookups_total",
    "Result-cache lookups by outcome", labelnames=("result",))
RESULT_CACHE_EVICTIONS = METRICS.counter(
    "trino_tpu_result_cache_evictions_total",
    "Result-cache entries dropped, by reason "
    "(lru | pressure | invalidated)", labelnames=("reason",))
RESULT_CACHE_BYTES = METRICS.gauge(
    "trino_tpu_result_cache_bytes", "Bytes held by the result cache")
RESULT_CACHE_ENTRIES = METRICS.gauge(
    "trino_tpu_result_cache_entries", "Entries in the result cache")


def _result_nbytes(columns: List[str], rows: List[list]) -> int:
    """Cheap host-side size estimate: per-cell overhead + string
    payloads (rows are plain python lists bound for JSON anyway)."""
    n = 64 + 16 * len(columns)
    for row in rows:
        n += 24 + 16 * len(row)
        for v in row:
            if isinstance(v, str):
                n += len(v)
    return n


class _Entry:
    __slots__ = ("columns", "types", "rows", "nbytes", "versions",
                 "created")

    def __init__(self, columns, types, rows, nbytes, versions):
        self.columns = columns
        self.types = types
        self.rows = rows
        self.nbytes = nbytes
        self.versions = versions     # ((catalog, data_version), ...)
        self.created = time.time()


class ResultCache:
    """Byte-capped LRU over final query results. ``get`` re-validates
    the captured connector versions against the caller's current ones:
    a mismatch drops the entry (counted ``invalidated``) and misses."""

    def __init__(self, capacity_bytes: int) -> None:
        self.capacity = capacity_bytes
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0

    # -- stats ---------------------------------------------------------
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- core ----------------------------------------------------------
    def get(self, key: tuple, current_versions: tuple
            ) -> Optional[Tuple[List[str], list, List[list]]]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                RESULT_CACHE_LOOKUPS.inc(result="miss")
                return None
            if e.versions != current_versions:
                self._drop(key, e, "invalidated")
                RESULT_CACHE_LOOKUPS.inc(result="miss")
                return None
            self._entries.move_to_end(key)
            RESULT_CACHE_LOOKUPS.inc(result="hit")
            # rows are handed to clients that may mutate them: return
            # a per-row copy, keep the cached master pristine
            return (list(e.columns), list(e.types),
                    [list(r) for r in e.rows])

    def put(self, key: tuple, columns: List[str], types: list,
            rows: List[list], versions: tuple) -> bool:
        nbytes = _result_nbytes(columns, rows)
        # one entry may not monopolize the cache
        if self.capacity <= 0 or nbytes > max(self.capacity // 4, 1):
            return False
        snap = [list(r) for r in rows]
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(list(columns), list(types),
                                        snap, nbytes, versions)
            self._bytes += nbytes
            while self._bytes > self.capacity and len(self._entries) > 1:
                k, e = next(iter(self._entries.items()))
                self._drop(k, e, "lru")
            self._publish()
        return True

    def evict(self, need_bytes: int) -> int:
        """Memory-pressure hook (exec/executor.py evict_cache_pressure):
        drop oldest entries until ``need_bytes`` are freed or the cache
        is empty. Returns bytes freed."""
        freed = 0
        with self._lock:
            while self._entries and freed < need_bytes:
                k, e = next(iter(self._entries.items()))
                self._drop(k, e, "pressure")
                freed += e.nbytes
            self._publish()
        return freed

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._publish()

    # -- internals (lock held) -----------------------------------------
    def _drop(self, key: tuple, e: _Entry, reason: str) -> None:
        self._entries.pop(key, None)
        self._bytes -= e.nbytes
        RESULT_CACHE_EVICTIONS.inc(reason=reason)
        self._publish()

    def _publish(self) -> None:
        RESULT_CACHE_BYTES.set(float(self._bytes))
        RESULT_CACHE_ENTRIES.set(float(len(self._entries)))


RESULT_CACHE = ResultCache(CONFIG.result_cache_bytes)


# ---- cache key ------------------------------------------------------

def _walk_nodes(nd: PlanNode):
    yield nd
    for s in nd.sources:
        yield from _walk_nodes(s)


def _any_volatile(nd: PlanNode) -> bool:
    def vol(v) -> bool:
        if isinstance(v, RowExpr):
            return expr_volatile(v)
        if isinstance(v, dict):
            return any(vol(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return any(vol(x) for x in v)
        return False
    for n in _walk_nodes(nd):
        if any(vol(getattr(n, f.name)) for f in dc_fields(n)
               if f.name != "source"):
            return True
    return False


def _scan_fingerprint(scan: TableScanNode) -> tuple:
    h = scan.handle
    return (h.catalog, h.schema, h.table, repr(h.constraint), h.limit)


def result_cache_key(plan: OutputNode, catalogs
                     ) -> Optional[Tuple[tuple, tuple]]:
    """(key, versions) for a cacheable plan, None for uncacheable.

    Fast path: an Output over a canonicalizable Filter/Project chain
    over one scan keys on the CANONICAL program (rename-invariant,
    exec/progkey.py).
    General path: sha256 of the serde-encoded plan. Both carry the
    split fingerprints; versions ride separately so ``get`` can
    distinguish invalidation from plain miss."""
    if not is_dataclass(plan) or not isinstance(plan, OutputNode):
        return None
    scans = [n for n in _walk_nodes(plan)
             if isinstance(n, TableScanNode)]
    if not scans:
        # catalog-less SELECT 1 etc.: cheap anyway, and caching them
        # would pin the no-scan fast path's identity semantics
        return None
    versions = []
    for s in scans:
        try:
            ver = catalogs.connector(s.handle.catalog).data_version()
        except KeyError:
            return None
        if ver is None:
            return None
        versions.append((s.handle.catalog, ver))
    if _any_volatile(plan):
        return None
    fps = tuple(sorted(set(_scan_fingerprint(s) for s in scans)))
    key = _chain_key(plan)
    if key is None:
        try:
            from ..plan.serde import to_jsonable
            blob = json.dumps(to_jsonable(plan), sort_keys=True,
                              default=str)
        except Exception:          # noqa: BLE001 — unencodable plan
            return None
        key = ("plan", hashlib.sha256(blob.encode()).hexdigest())
    return key + (fps,), tuple(sorted(set(versions)))


def _chain_key(plan: OutputNode) -> Optional[tuple]:
    """Canonical identity for the point-lookup shape: Output ->
    [canonicalizable chain] -> TableScan. The io signature maps
    canonical input names to CONNECTOR columns (through the scan's
    assignments) and client column names to their producing symbols'
    canonical names — so two plans differing only in planner symbol
    numbering share one entry."""
    from .progkey import canonicalize_nodes
    from ..plan.nodes import (FilterNode, LimitNode, OffsetNode,
                              ProjectNode, SampleNode, SortNode,
                              TopNNode)
    chain: List[PlanNode] = []
    cur = plan.source
    while isinstance(cur, (FilterNode, ProjectNode, LimitNode,
                           OffsetNode, SortNode, TopNNode, SampleNode)):
        chain.append(cur)
        cur = cur.source
    if not isinstance(cur, TableScanNode):
        return None
    canon = canonicalize_nodes(chain)
    if canon is None:
        return None
    ins = tuple(sorted(
        (cn, cur.assignments[orig])
        for orig, cn in canon.mapping.items()
        if orig in cur.assignments))
    outs = tuple(
        (name, canon.mapping.get(sym, cur.assignments.get(sym, sym)))
        for name, sym in zip(plan.names, plan.symbols))
    return ("chain", canon.key, ins, outs)


# ---- runner wrapper --------------------------------------------------

class CachingQueryRunner:
    """Transparent cache layer the coordinator's runner factory wraps
    around BOTH runner kinds (local and distributed). A hit returns a
    synthesized QueryResult without touching the inner runner — no
    planning against workers, no dispatched tasks. A miss double-plans
    (once here for the key, once inside the inner runner); point
    queries plan in microseconds, so key cost is noise next to one
    dispatch round-trip. Everything non-SELECT, non-deterministic or
    unkeyable passes straight through."""

    def __init__(self, inner, session, catalogs) -> None:
        self._inner = inner
        self._session = session
        self._catalogs = catalogs

    def __getattr__(self, name):
        # .resume / .session / .catalogs / anything else the
        # coordinator pokes at — behave like the wrapped runner
        return getattr(self._inner, name)

    def execute(self, sql: str):
        session = self._session
        try:
            enabled = bool(session.get("result_cache_enabled"))
        except KeyError:
            enabled = False
        if not enabled or CONFIG.result_cache_bytes <= 0:
            return self._inner.execute(sql)
        keyver = self._key_for(sql)
        if keyver is None:
            return self._inner.execute(sql)
        key, versions = keyver
        hit = RESULT_CACHE.get(key, versions)
        if hit is not None:
            return self._synthesize(hit)
        res = self._inner.execute(sql)
        # only successful plain SELECT results are cacheable (DDL/DML
        # mutate; a raised QueryError never reaches here)
        if getattr(res, "update_type", None) is None:
            RESULT_CACHE.put(key, res.columns, res.types, res.rows,
                             versions)
        return res

    # -- internals -----------------------------------------------------
    def _key_for(self, sql: str):
        from ..sql import ast as A
        from ..sql.parser import parse_statement
        try:
            stmt = parse_statement(sql)
            if not isinstance(stmt, A.QueryStatement):
                return None
            from ..planner import LogicalPlanner
            from ..planner.optimizer import optimize
            planner = LogicalPlanner(self._catalogs, self._session)
            plan = optimize(planner.plan(stmt), self._catalogs,
                            self._session)
            return result_cache_key(plan, self._catalogs)
        except Exception:           # noqa: BLE001 — any planning
            return None             # failure: let the inner runner
                                    # produce the real error/result

    def _synthesize(self, hit):
        from ..runner import QueryResult
        columns, types, rows = hit
        t0 = time.perf_counter()
        session = self._session
        # mirror LocalQueryRunner's id discipline: a coordinator-
        # stamped id wins and is consumed; standalone use mints one
        qid = session.query_id or session.next_query_id()
        session.query_id = ""
        return QueryResult(columns=columns, types=types, rows=rows,
                           query_id=qid,
                           wall_s=time.perf_counter() - t0)
