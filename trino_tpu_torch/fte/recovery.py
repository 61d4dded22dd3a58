"""Coordinator result recovery: spooled results and query manifests.

Counterpart of ``trino_tpu/fte/recovery.py`` (host only). A finished
query's client-visible rows, with a minimal manifest (query id, slug,
SQL, user, column and type names, update metadata), are committed to
the spool under a reserved fragment id, keyed by the coordinator's
query id. A restarted coordinator that is asked for
``/v1/statement/executing/{id}/{slug}/{token}`` of a query it never ran
loads the manifest, checks the slug, rebuilds a FINISHED query and
serves its pages. Rows are persisted in the client wire encoding
(``json_value``, the one encoding of a cell), so the recovered pages are
byte for byte what the first coordinator served.

``ExecutionManifestStore`` keeps the manifests of running distributed
queries; on a single node none is written.
"""


from __future__ import annotations

import datetime
import decimal
import json
from dataclasses import dataclass
from typing import List, Optional

from ..obs.metrics import METRICS

# fragment ids from the planner are >= 0; the query's final result
# spools under this reserved id (layout: <query_id>/f-1.p0/...)
RESULT_FRAGMENT = -1

# the EXECUTION manifest — everything a restarted coordinator needs to
# resume a RUNNING query — spools under this second reserved id
# (layout: <query_id>/f-2.p0/...), written at dispatch time and
# released on normal completion
MANIFEST_FRAGMENT = -2

# rows per persisted result frame — matches the coordinator's
# QueryResults paging so one frame serves ~one client page
RESULT_PAGE_ROWS = 4096

_M_RESULTS_PERSISTED = METRICS.counter(
    "trino_tpu_query_results_spooled_total",
    "Finished queries whose results + manifest were spooled for "
    "coordinator-restart recovery")
_M_RESULTS_RECOVERED = METRICS.counter(
    "trino_tpu_query_results_recovered_total",
    "Queries rebuilt from the spooled manifest by a coordinator that "
    "did not run them (restart recovery)")
_M_RESULTS_SKIPPED = METRICS.counter(
    "trino_tpu_query_results_spool_skipped_total",
    "Finished queries whose results exceeded result_spool_max_bytes "
    "and were not persisted for restart recovery")
_M_MANIFESTS_PERSISTED = METRICS.counter(
    "trino_tpu_exec_manifests_spooled_total",
    "Execution manifests spooled at dispatch time for mid-flight "
    "coordinator-failover resumption")
_M_MANIFESTS_RESUMED = METRICS.counter(
    "trino_tpu_exec_manifests_resumed_total",
    "RUNNING queries resumed from a spooled execution manifest by a "
    "coordinator that did not dispatch them")


def json_value(v):
    """Client wire encoding of one value (QueryResults data cell). A TIME
    cell is its ISO string; the JAX engine's encoder has no branch for
    it, so its coordinator drops the connection (ROADMAP C3)."""
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat(sep=" ") if isinstance(v, datetime.datetime) \
            else v.isoformat()
    if isinstance(v, datetime.time):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return str(v)
    return v


class _NamedType:
    """Type stand-in for recovered results: the serving path only needs
    ``.name`` (column rendering), never the engine type machinery."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"_NamedType({self.name!r})"


@dataclass
class RecoveredQuery:
    """A finished query reloaded from its spooled manifest."""
    query_id: str
    slug: str
    sql: str
    user: str
    columns: List[str]
    type_names: List[str]
    rows: List[list]
    update_type: Optional[str] = None
    update_count: Optional[int] = None

    def to_query_result(self):
        from ..runner import QueryResult
        res = QueryResult(list(self.columns),
                          [_NamedType(n) for n in self.type_names],
                          self.rows, query_id=self.query_id)
        res.update_type = self.update_type
        res.update_count = self.update_count
        return res


class ResultStore:
    """Persists / recovers finished query results through a
    ``SpoolManager`` (any backend)."""

    def __init__(self, spool):
        self.spool = spool

    def persist(self, query_id: str, slug: str, sql: str, user: str,
                result, max_bytes: Optional[int] = None) -> bool:
        """Spool a finished query's manifest + wire-encoded result
        pages. Best-effort by contract: the query already succeeded,
        so a failed persist costs only restart recoverability.

        ``max_bytes`` (default CONFIG.result_spool_max_bytes) bounds
        the encoded size: the persist runs ON the query thread before
        FINISHED is client-visible (durability precedes publication),
        so an unbounded result would add O(result) latency and a
        second in-memory copy — past the cap the query simply isn't
        restart-recoverable."""
        if max_bytes is None:
            from ..config import CONFIG
            max_bytes = int(CONFIG.result_spool_max_bytes)
        ncols = len(result.columns or []) or 1
        # floor-estimate before paying the wire re-encode: every row
        # costs at least "[v,…]," = 2 bytes per cell + brackets
        if max_bytes > 0 and len(result.rows) * (2 * ncols + 2) \
                > max_bytes:
            _M_RESULTS_SKIPPED.inc()
            return False
        rows = [[json_value(v) for v in row] for row in result.rows]
        manifest = {
            "queryId": query_id,
            "slug": slug,
            "sql": sql,
            "user": user,
            "columns": list(result.columns or []),
            "types": [t.name for t in (result.types or [])],
            "rows": len(rows),
            "updateType": result.update_type,
            "updateCount": result.update_count,
        }
        frames = [json.dumps(manifest).encode()]
        total = len(frames[0])
        for lo in range(0, len(rows), RESULT_PAGE_ROWS):
            frame = json.dumps(rows[lo:lo + RESULT_PAGE_ROWS]).encode()
            total += len(frame)
            if max_bytes > 0 and total > max_bytes:
                _M_RESULTS_SKIPPED.inc()
                return False
            frames.append(frame)
        try:
            self.spool.commit(query_id, RESULT_FRAGMENT, 0, 0, frames)
        except Exception:       # noqa: BLE001 — durable results are
            return False        # opportunistic, never a query failure
        _M_RESULTS_PERSISTED.inc()
        return True

    def load_manifest(self, query_id: str) -> Optional[dict]:
        """Read ONLY the manifest (frame 0) — the cheap peek callers
        use to verify the slug before paying for the full row decode
        (a wrong-slug probe must not re-read a 64MB result to 404)."""
        try:
            raw = self.spool.read_frame(query_id, RESULT_FRAGMENT, 0, 0)
        except Exception:       # noqa: BLE001
            return None
        if raw is None:
            return None
        try:
            mf = json.loads(raw)
        except ValueError:
            return None
        return mf if isinstance(mf, dict) else None

    def load(self, query_id: str,
             slug: Optional[str] = None) -> Optional[RecoveredQuery]:
        """Reload a query's manifest + rows, or None if nothing (or
        something unreadable) is spooled under its id. When ``slug``
        is given it is checked against the manifest BEFORE the row
        frames are read."""
        if slug is not None:
            mf = self.load_manifest(query_id)
            if mf is None or str(mf.get("slug")) != slug:
                return None
        try:
            frames = self.spool.read(query_id, RESULT_FRAGMENT, 0)
        except Exception:       # noqa: BLE001
            return None
        if not frames:
            return None
        try:
            manifest = json.loads(frames[0])
            rows: List[list] = []
            for fr in frames[1:]:
                rows.extend(json.loads(fr))
            if len(rows) != int(manifest.get("rows", len(rows))):
                return None     # torn manifest: refuse a partial answer
            rec = RecoveredQuery(
                query_id=str(manifest["queryId"]),
                slug=str(manifest["slug"]),
                sql=str(manifest.get("sql", "")),
                user=str(manifest.get("user", "")),
                columns=list(manifest.get("columns") or []),
                type_names=list(manifest.get("types") or []),
                rows=rows,
                update_type=manifest.get("updateType"),
                update_count=manifest.get("updateCount"),
            )
        except (KeyError, ValueError, TypeError):
            return None
        return rec

    def release(self, query_id: str) -> None:
        try:
            self.spool.release(query_id)
        except Exception:       # noqa: BLE001
            pass


class ExecutionManifestStore:
    """Persists / reloads the EXECUTION manifest of a RUNNING query —
    the mid-flight counterpart of ``ResultStore``.

    The manifest is written once, at dispatch time, after the stage DAG
    has been fragmented, serde-proven (``validate_stage_dag`` returns
    the round-trip-checked wire encodings) and its fan-out decided, but
    BEFORE any task is dispatched. It carries everything a coordinator
    that never saw the query needs to finish it: identity (query id,
    slug, SQL), admission context (user, catalog, schema, session
    properties, resource group + weight), timing (original submit and
    start epochs — a resume must not reset the query deadline), the
    execution id the stage scheduler keyed its exchange spool entries
    under, the per-stage fan-out, and the wire encoding of every stage
    fragment plus the root (combine) plan.

    Stage progress itself is NOT in the manifest: the stage exchange's
    first-commit-wins COMMITTED markers (keyed ``<exec>.s<sid>.p<part>``)
    are the durable progress log, and the resuming coordinator
    enumerates them directly."""

    def __init__(self, spool):
        self.spool = spool

    def persist(self, doc: dict) -> bool:
        """Spool one execution manifest (a JSON document built by the
        dispatch path). Best-effort: a failed persist costs only
        failover resumability, never the query."""
        query_id = str(doc.get("queryId"))
        try:
            frames = [json.dumps(doc).encode()]
            self.spool.commit(query_id, MANIFEST_FRAGMENT, 0, 0, frames)
        except Exception:       # noqa: BLE001
            return False
        _M_MANIFESTS_PERSISTED.inc()
        return True

    def load(self, query_id: str,
             slug: Optional[str] = None) -> Optional[dict]:
        """Reload a manifest, or None if nothing (or something
        unreadable) is spooled. ``slug`` is checked against the
        manifest when given — a wrong-slug probe must 404, not leak a
        foreign query's plan."""
        try:
            raw = self.spool.read_frame(query_id, MANIFEST_FRAGMENT,
                                        0, 0)
        except Exception:       # noqa: BLE001
            return None
        if raw is None:
            return None
        try:
            doc = json.loads(raw)
        except ValueError:
            return None
        if not isinstance(doc, dict):
            return None
        if slug is not None and str(doc.get("slug")) != slug:
            return None
        return doc

    def mark_resumed(self) -> None:
        _M_MANIFESTS_RESUMED.inc()

    def release(self, query_id: str) -> None:
        """Drop ONLY the manifest fragment: the finished result persists
        under the same query id and must survive (``spool.release``
        would tombstone the whole query)."""
        try:
            self.spool.release_fragment(query_id, MANIFEST_FRAGMENT)
        except Exception:       # noqa: BLE001
            pass
