"""System catalog: the runtime tables and the procedures.

Counterpart of ``trino_tpu/connectors/system.py`` (host only). The
connector reads from a provider that exposes ``query_infos()``,
``node_infos()``, ``history_infos()``, ``kill_query(id)`` and the like;
in a plain LocalQueryRunner the provider is the stub below, so every
``runtime`` table reads empty and ``CALL system.runtime.kill_query``
raises "query not found". Rows are built on the host and handed to the
engine on the connector's device.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from ..catalog import ColumnMetadata, Connector, Split, TableMetadata
from ..columnar import Batch, batch_from_pylist
from ..config import DeviceLike, resolve_device
from ..types import BIGINT, BOOLEAN, DOUBLE, VARCHAR

_RUNTIME_TABLES = {
    "queries": (
        ("query_id", VARCHAR), ("state", VARCHAR), ("user", VARCHAR),
        ("source", VARCHAR), ("query", VARCHAR),
        ("sql_digest", VARCHAR), ("plan_key", VARCHAR),
        ("error_code", VARCHAR), ("error_type", VARCHAR),
        ("queued_s", DOUBLE), ("wall_s", DOUBLE), ("cpu_s", DOUBLE),
        ("device_s", DOUBLE), ("rows", BIGINT),
        ("peak_memory_bytes", BIGINT), ("spill_bytes", BIGINT),
        ("stream_chunks", BIGINT), ("retries", BIGINT),
        ("trace_id", VARCHAR), ("created", VARCHAR),
    ),
    "operator_stats": (
        ("plan_key", VARCHAR), ("operator", VARCHAR),
        ("occurrence", BIGINT), ("observations", BIGINT),
        ("selectivity", DOUBLE), ("rows_per_s", DOUBLE),
        ("rows_in", BIGINT), ("rows_out", BIGINT),
        ("wall_s", DOUBLE), ("updated", VARCHAR),
    ),
    "metrics": (
        ("captured_ms", BIGINT), ("node", VARCHAR), ("name", VARCHAR),
        ("labels", VARCHAR), ("value", DOUBLE), ("sample", VARCHAR),
    ),
    "continuous_queries": (
        ("job_id", VARCHAR), ("kind", VARCHAR), ("state", VARCHAR),
        ("sql", VARCHAR), ("target", VARCHAR), ("topic", VARCHAR),
        ("poll_ms", BIGINT), ("cycles", BIGINT),
        ("rows_total", BIGINT), ("last_epoch", BIGINT),
        ("watermark", DOUBLE), ("last_error", VARCHAR),
        ("created", VARCHAR),
    ),
    "nodes": (
        ("node_id", VARCHAR), ("http_uri", VARCHAR),
        ("node_version", VARCHAR), ("coordinator", BOOLEAN),
        ("state", VARCHAR),
    ),
    "resource_groups": (
        ("name", VARCHAR), ("running", BIGINT), ("queued", BIGINT),
        ("hard_concurrency_limit", BIGINT), ("max_queued", BIGINT),
    ),
}


def _iso(epoch) -> str:
    try:
        return time.strftime("%Y-%m-%dT%H:%M:%S",
                             time.localtime(float(epoch)))
    except (TypeError, ValueError, OverflowError, OSError):
        return ""


class SystemProvider:
    """Provider SPI: a coordinator implements these; this stub has no
    queries, nodes or jobs."""

    def query_infos(self) -> List[dict]:
        return []

    def node_infos(self) -> List[dict]:
        return []

    def resource_group_infos(self) -> List[dict]:
        return []

    def history_infos(self) -> List[dict]:
        """Query-history records (the record schema of the JAX
        engine's obs/history.py) —
        terminal queries first, live ones appended by the
        coordinator's implementation."""
        return []

    def operator_stat_infos(self) -> List[dict]:
        """Learned-stats registry snapshot
        (LearnedStatsRegistry.snapshot of the JAX
        engine's exec/learnedstats.py)."""
        return []

    def continuous_query_infos(self) -> List[dict]:
        """Continuous-query job snapshots
        (ContinuousJob.to_dict of the JAX engine's
        streaming/continuous.py)."""
        return []

    def metric_infos(self) -> List[dict]:
        """Flattened metric samples: dicts with captured_ms, node,
        name, labels, value, sample ("current" | "ring")."""
        return []

    def kill_query(self, query_id: str) -> bool:
        raise KeyError(f"query not found: {query_id}")


class SystemConnector(Connector):
    name = "system"

    def __init__(self, provider: Optional[SystemProvider] = None,
                 device: DeviceLike = None):
        self.provider = provider or SystemProvider()
        self.device = resolve_device(device)

    def list_schemas(self) -> List[str]:
        return ["runtime"]

    def list_tables(self, schema: str) -> List[str]:
        if schema == "runtime":
            return sorted(_RUNTIME_TABLES)
        return []

    def get_table_metadata(self, schema, table) -> Optional[TableMetadata]:
        cols = _RUNTIME_TABLES.get(table) if schema == "runtime" else None
        if cols is None:
            return None
        return TableMetadata(schema, table, tuple(
            ColumnMetadata(n, t) for n, t in cols))

    def read_split(self, split: Split, columns: Sequence[str]) -> Batch:
        table = split.handle.table
        cols = _RUNTIME_TABLES[table]
        if table == "queries":
            rows = [
                (h.get("query_id", ""), h.get("state", ""),
                 h.get("user", ""), h.get("source", ""),
                 h.get("sql", h.get("query", "")),
                 h.get("sql_digest", ""), h.get("plan_key", ""),
                 h.get("error_name"), h.get("error_type"),
                 float(h.get("queued_s") or 0.0),
                 float(h.get("wall_s") or 0.0),
                 float(h.get("cpu_s") or 0.0),
                 float(h.get("device_s") or 0.0),
                 int(h.get("rows") or 0),
                 int(h.get("peak_memory_bytes") or 0),
                 int(h.get("spill_bytes") or 0),
                 int(h.get("stream_chunks") or 0),
                 int(h.get("retries") or 0),
                 h.get("trace_id"), _iso(h.get("created")))
                for h in self.provider.history_infos()]
        elif table == "operator_stats":
            rows = [
                (s.get("key", ""), s.get("op", ""),
                 int(s.get("idx") or 0), int(s.get("n") or 0),
                 s.get("selectivity"), s.get("rows_per_s"),
                 int(s.get("rows_in") or 0),
                 int(s.get("rows_out") or 0),
                 float(s.get("wall_s") or 0.0),
                 _iso(s.get("updated")))
                for s in self.provider.operator_stat_infos()]
        elif table == "metrics":
            rows = [
                (int(m.get("captured_ms") or 0), m.get("node", ""),
                 m.get("name", ""), m.get("labels", ""),
                 float(m.get("value") or 0.0),
                 m.get("sample", "current"))
                for m in self.provider.metric_infos()]
        elif table == "continuous_queries":
            rows = [
                (j.get("job_id", ""), j.get("kind", ""),
                 j.get("state", ""), j.get("sql", ""),
                 j.get("target"), j.get("topic"),
                 int(j.get("poll_interval_ms") or 0),
                 int(j.get("cycles") or 0),
                 int(j.get("rows_total") or 0),
                 int(j.get("last_epoch") or 0), j.get("watermark"),
                 j.get("last_error"), _iso(j.get("created")))
                for j in self.provider.continuous_query_infos()]
        elif table == "nodes":
            rows = [
                (i.get("nodeId", ""), i.get("uri", ""),
                 i.get("nodeVersion", ""), i.get("coordinator", False),
                 i.get("state", "active"))
                for i in self.provider.node_infos()]
        else:
            rows = [
                (i.get("name", ""), i.get("running", 0),
                 i.get("queued", 0), i.get("hardConcurrencyLimit", 0),
                 i.get("maxQueued", 0))
                for i in self.provider.resource_group_infos()]
        names = [n for n, _ in cols]
        data = {n: [r[i] for r in rows] for i, n in enumerate(names)}
        return batch_from_pylist(data, dict(cols),
                                 device=self.device).select_columns(
            [c for c in columns])

    # --- procedures -------------------------------------------------------
    def call_procedure(self, schema: str, name: str, args: list):
        if schema == "runtime" and name == "kill_query":
            if not args:
                raise ValueError("kill_query(query_id) requires an id")
            ok = self.provider.kill_query(str(args[0]))
            if not ok:
                raise KeyError(f"query not found: {args[0]}")
            return
        raise KeyError(f"Procedure '{schema}.{name}' not registered")
