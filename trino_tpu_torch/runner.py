"""LocalQueryRunner: in-process parse -> plan -> optimize -> execute,
and the statements around queries.

Counterpart of ``trino_tpu/runner.py`` over the PyTorch executor, with the
tpch, tpcds, memory, blackhole and system catalogs, or the catalogs the
caller gives it (localfile and jdbc ones among them, ``plugin.py``). The
runner runs on ``"cuda"`` unless its caller passes ``device="cpu"``;
without a card it raises (config.resolve_device).

Statements: SELECT, EXPLAIN, SHOW (CATALOGS, SCHEMAS, TABLES [LIKE],
COLUMNS, SESSION, FUNCTIONS, CREATE, STATS, GRANTS), DESCRIBE [INPUT |
OUTPUT], USE, SET/RESET SESSION, CREATE/DROP TABLE [AS], CREATE [OR
REPLACE]/DROP VIEW, INSERT, DELETE, UPDATE, MERGE, PREPARE, EXECUTE,
DEALLOCATE, CALL, START TRANSACTION/COMMIT/ROLLBACK and GRANT/REVOKE/DENY,
each checked against the catalogs' access control (security.py), and
EXPLAIN ANALYZE.

Query controls (the JAX runner's): the session's ``cancel`` event and
its ``deadline`` (from ``query_max_run_time``, stamped by the
coordinator or, standalone, by ``execute``) are checked before every
plan node and every streamed chunk. With ``collect_node_stats`` every
query records a ``NodeStats`` per plan node (nothing waits for the card
until the result is on the host; on a card each node's interval on its
stream is timed by events) and a span tree (obs/trace.py: a
``node.<Name>`` span a plan node, a ``device_wait`` span at each host
read of the card); EXPLAIN ANALYZE always does, and renders the plan that
ran with both.

Writes keep the data on the device: CREATE TABLE AS, INSERT, DELETE,
UPDATE and MERGE run their queries through the executor and hand its
result Batch to the connector (``_run_query_batch``); no row is decoded
on the host. INSERT casts a query column to the table's type on the
device when Trino coerces the pair implicitly, and raises "Insert query
has mismatched column types" for any other pair.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .catalog import (CatalogManager, ColumnMetadata, TableHandle,
                      TableMetadata, ViewDefinition)
from .columnar import Batch, Column, empty_batch
from .config import DeviceLike, resolve_device
from .connectors.memory import BlackholeConnector, MemoryConnector
from .connectors.stream import StreamConnector
from .connectors.system import SystemConnector
from .connectors.tpcds import TpcdsConnector
from .connectors.tpch import TpchConnector
from .exec.executor import (Executor, QueryError, device_concat,
                            render_analyze_lines)
from .exec.expr import cast_column, like_to_regex
from .functions import list_functions
from .obs.trace import QueryTrace, null_span
from .ops import compact
from .plan.nodes import OutputNode, plan_tree_lines
from .planner import LogicalPlanner, PlanningError
from .planner.optimizer import optimize
from .session import SESSION_PROPERTIES, Session
from .sql import ast as A
from .sql.parser import parse_statement
from .sql.tokenizer import ParseError
from .types import (BIGINT, BOOLEAN, DOUBLE, UNKNOWN, VARCHAR, ArrayType,
                    CharType, DecimalType, MapType, RowType, Type,
                    VarcharType, default_decimal_for, is_integral,
                    parse_type)


@dataclass
class QueryResult:
    """Client-facing result: column names, types and rows, or a
    statement's update type and count."""
    columns: List[str]
    types: List[Type]
    rows: List[list]
    query_id: str = ""
    wall_s: float = 0.0
    update_type: Optional[str] = None
    update_count: Optional[int] = None
    # (probe rows, build rows, output rows) of each join the query ran
    join_sizes: List[Tuple[int, int, int]] = field(default_factory=list)
    # bytes of join output the query wrote to host memory (host spill)
    spill_bytes: int = 0
    # the query's largest single memory reservation
    peak_reserved_bytes: int = 0
    # streamed operators (exec/streamjoin.py): chunks, bytes copied to
    # the device, copies complete before the compute stream needed them,
    # the copies' device ms and the compute stream's ms waiting for them
    # (the last three from CUDA events; 0 on the CPU), and chunks by
    # operator ("agg", "join", "chain")
    stream_chunks: int = 0
    stream_h2d_bytes: int = 0
    stream_overlapped: int = 0
    stream_copy_ms: float = 0.0
    stream_wait_ms: float = 0.0
    stream_ops: Dict[str, int] = field(default_factory=dict)
    # chains served through a ragged multi-query batch (exec/taskexec.py
    # RaggedBatcher, with the ragged_batching session property on)
    ragged_batched: int = 0
    # on a mesh (exec/distributed.py): each sharded scan's rows per shard
    shard_rows: List[List[int]] = field(default_factory=list)
    # telemetry (/v1/query, EXPLAIN ANALYZE, the query history): the
    # NodeStats list, the plan that ran, the span tree and the plan's
    # canonical key (exec/learnedstats.py)
    stats: Optional[list] = None
    plan_lines: Optional[List[str]] = None
    trace: Optional[object] = None
    plan_key: str = ""

    @property
    def peak_memory_bytes(self) -> int:
        """The JAX engine's name of ``peak_reserved_bytes``."""
        return self.peak_reserved_bytes

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)


class LocalQueryRunner:
    """Runs SQL in this process on one torch device or, with
    ``distributed=True``, over a mesh of ``n_devices`` shards
    (parallel/mesh.py: one shard per visible card by default, shards on
    the CPU with ``device="cpu"``), or over the ``mesh`` given."""

    def __init__(self, session: Optional[Session] = None,
                 device: DeviceLike = None,
                 catalogs: Optional[CatalogManager] = None,
                 collect_node_stats: bool = False,
                 distributed: bool = False,
                 n_devices: Optional[int] = None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.home
        else:
            self.device = resolve_device(device)
            if distributed:
                from .parallel.mesh import get_mesh
                self.mesh = get_mesh(n_devices, self.device)
        self.collect_node_stats = collect_node_stats
        if catalogs is not None:
            self.catalogs = catalogs
        else:
            self.catalogs = CatalogManager()
            dev = self.device
            self.catalogs.register("tpch", TpchConnector(device=dev))
            self.catalogs.register("tpcds", TpcdsConnector(device=dev))
            self.catalogs.register("memory", MemoryConnector(device=dev))
            self.catalogs.register("blackhole", BlackholeConnector(device=dev))
            self.catalogs.register("system", SystemConnector(device=dev))
            # disk-backed (CONFIG.stream_dir), so unlike memory this
            # default shares its state with worker processes
            self.catalogs.register("stream", StreamConnector(device=dev))
        self.session = session or Session(catalog="tpch", schema="tiny")
        # engine transaction state: each catalog's snapshot, taken at
        # START TRANSACTION and restored by ROLLBACK
        self._txn_snapshot = None

    def execute(self, sql: str) -> QueryResult:
        from .obs.metrics import QUERY_PEAK_MEMORY_BYTES, QUERY_WALL_SECONDS
        t0 = time.perf_counter()
        session = self.session
        trace = QueryTrace() if self.collect_node_stats else None
        sp = trace.span if trace is not None else null_span
        prev_trace = session.trace
        session.trace = trace
        # a coordinator stamps the deadline at submit; a runner used on
        # its own derives it here, so query_max_run_time holds either way
        owned_deadline = False
        if session.deadline is None:
            limit = int(session.get("query_max_run_time") or 0)
            if limit > 0:
                session.deadline = time.monotonic() + limit
                owned_deadline = True
        try:
            try:
                with sp("parse"):
                    stmt = parse_statement(sql)
            except ParseError as e:
                raise QueryError(f"SYNTAX_ERROR: {e}") from e
            # a coordinator-stamped id wins, and is consumed here
            qid = session.query_id or session.next_query_id()
            session.query_id = qid
            if trace is not None:
                trace.query_id = qid
            try:
                result = self._dispatch(stmt, sql)
            except PlanningError as e:
                raise QueryError(str(e)) from e
            except KeyError as e:
                raise QueryError(str(e).strip('"')) from e
        finally:
            session.trace = prev_trace
            session.query_id = ""
            if owned_deadline:
                session.deadline = None
            QUERY_WALL_SECONDS.observe(time.perf_counter() - t0)
            # OTLP export (obs/otlp.py): best-effort, sink-configured;
            # in the finally so failed queries' traces export too
            if trace is not None and trace.roots:
                from .obs.otlp import maybe_export
                maybe_export(trace, session=session)
        result.query_id = qid
        result.wall_s = time.perf_counter() - t0
        if trace is not None:
            result.trace = trace
        QUERY_PEAK_MEMORY_BYTES.set(result.peak_reserved_bytes)
        return result

    def plan_sql(self, sql: str, optimized: bool = True) -> OutputNode:
        stmt = parse_statement(sql)
        return self._plan(stmt.statement if isinstance(stmt, A.Explain)
                          else stmt, optimized)

    def _plan(self, stmt, optimized: bool = True) -> OutputNode:
        """The logical plan of a query, optimized unless asked not to;
        each step a span of the session's trace when it carries one."""
        if not isinstance(stmt, A.QueryStatement):
            raise QueryError("only queries can be planned")
        trace = self.session.trace
        sp = trace.span if trace is not None else null_span
        with sp("plan"):
            plan = LogicalPlanner(self.catalogs, self.session).plan(stmt)
        if not optimized:
            return plan
        with sp("optimize"):
            return optimize(plan, self.catalogs, self.session)

    # ------------------------------------------------------------------
    def _dispatch(self, stmt: A.Statement, sql: str = "") -> QueryResult:
        if isinstance(stmt, A.QueryStatement):
            return self._run_query(stmt)
        if isinstance(stmt, A.Explain):
            if not isinstance(stmt.statement, A.QueryStatement):
                raise QueryError("EXPLAIN supports queries only")
            if stmt.analyze:
                return self._explain_analyze(stmt.statement)
            return QueryResult(["Query Plan"], [VARCHAR],
                               [[line] for line in plan_tree_lines(
                                   self._plan(stmt.statement))])
        handler = getattr(self, "_stmt_" + type(stmt).__name__, None)
        if handler is None:
            raise QueryError(
                f"statement {type(stmt).__name__} not supported")
        return handler(stmt, sql)

    def _explain_analyze(self, stmt: A.QueryStatement) -> QueryResult:
        """Run the query with node stats and a trace (even on a runner
        whose queries collect neither) and render the plan that ran."""
        trace = self.session.trace
        owned = trace is None
        if owned:
            trace = self.session.trace = QueryTrace(self.session.query_id)
        try:
            res = self._run_query(stmt, collect_stats=True)
        finally:
            if owned:
                self.session.trace = None
        lines = render_analyze_lines(res.plan_lines, res.stats, trace)
        return QueryResult(["Query Plan"], [VARCHAR], [[l] for l in lines])

    # ---- queries ---------------------------------------------------------
    def _execute_plan(self, stmt: A.QueryStatement,
                      collect_stats: bool = False):
        plan = self._plan(stmt)
        trace = self.session.trace
        sp = trace.span if trace is not None else null_span
        ex = self._make_executor(collect_stats)
        with sp("execute"):
            batch = ex.execute(plan)
        return plan, ex, batch

    def _make_executor(self, collect_stats: bool = False) -> Executor:
        if self.mesh is not None:
            from .exec.distributed import DistributedExecutor
            return DistributedExecutor(self.catalogs, self.session,
                                       self.mesh, collect_stats)
        return Executor(self.catalogs, self.session, self.device,
                        collect_stats)

    def _run_query(self, stmt: A.QueryStatement,
                   collect_stats: Optional[bool] = None) -> QueryResult:
        if collect_stats is None:
            collect_stats = self.collect_node_stats
        plan, ex, batch = self._execute_plan(stmt, collect_stats)
        schema = batch.schema()
        result = QueryResult(list(plan.names),
                           [schema[s] for s in plan.symbols],
                           batch.to_pylist(), join_sizes=ex.join_sizes,
                           spill_bytes=ex.spilled_bytes,
                           peak_reserved_bytes=ex.peak_reserved_bytes,
                           stream_chunks=ex.stream_chunks,
                           stream_h2d_bytes=ex.stream_h2d_bytes,
                           stream_overlapped=ex.stream_overlapped,
                           stream_copy_ms=ex.stream_copy_ms,
                           stream_wait_ms=ex.stream_wait_ms,
                           stream_ops=dict(ex.stream_ops),
                           ragged_batched=ex.ragged_batched,
                           shard_rows=list(getattr(ex, "scan_shard_rows",
                                                   [])),
                           plan_lines=plan_tree_lines(plan))
        if collect_stats:
            result.stats = ex.stats
            # learned operator statistics: this execution's rows in and
            # out feed the EMAs under the plan's canonical key
            from .exec.learnedstats import plan_key_for, record_node_stats
            result.plan_key = plan_key_for(plan)
            try:
                record_node_stats(result.plan_key, ex.stats, self.session)
            except Exception:   # noqa: BLE001 — telemetry is best-effort
                pass
        return result

    def execute_batch(self, sql: str) -> Batch:
        """Run a query and return its result Batch, left on the device,
        its columns keyed by display name (a repeated name gets ``$i``):
        the task worker serialises it into page frames
        (server/task_worker.py)."""
        stmt = parse_statement(sql)
        if not isinstance(stmt, A.QueryStatement):
            raise QueryError("execute_batch supports queries only")
        return self._run_query_batch(stmt.query)[2]

    def _run_query_batch(self, query: A.Query
                         ) -> Tuple[List[str], List[Type], Batch]:
        """Run a query for a write: its display names, its types and the
        executor's result Batch, left on the device, its columns keyed by
        display name in output order (a repeated name gets ``$i``)."""
        plan, _, batch = self._execute_plan(A.QueryStatement(query))
        cols: Dict[str, Column] = {}
        for i, (name, sym) in enumerate(zip(plan.names, plan.symbols)):
            cols[name if name not in cols else f"{name}${i}"] = \
                batch.column(sym)
        return (list(plan.names), [c.type for c in cols.values()],
                Batch(cols, batch.num_rows))

    # ---- metadata statements ----------------------------------------------
    def _stmt_ShowCatalogs(self, stmt, sql) -> QueryResult:
        return QueryResult(["Catalog"], [VARCHAR],
                           [[c] for c in self.catalogs.list_catalogs()])

    def _stmt_ShowSchemas(self, stmt, sql) -> QueryResult:
        conn = self.catalogs.connector(stmt.catalog or self.session.catalog)
        return QueryResult(["Schema"], [VARCHAR],
                           [[s] for s in conn.list_schemas()])

    def _stmt_ShowTables(self, stmt, sql) -> QueryResult:
        cat, schema = self.session.catalog, self.session.schema
        if stmt.schema:
            if len(stmt.schema) == 2:
                cat, schema = stmt.schema
            else:
                schema = stmt.schema[0]
        conn = self.catalogs.connector(cat)
        tables = sorted(set(conn.list_tables(schema))
                        | set(self.catalogs.list_views(cat, schema)))
        if stmt.like:
            rx = re.compile(like_to_regex(stmt.like))
            tables = [t for t in tables if rx.fullmatch(t)]
        return QueryResult(["Table"], [VARCHAR], [[t] for t in tables])

    def _stmt_ShowColumns(self, stmt, sql) -> QueryResult:
        cat, schema, table = self._qualify(stmt.table)
        meta = self.catalogs.connector(cat).get_table_metadata(schema, table)
        if meta is None:
            raise QueryError(f"Table '{cat}.{schema}.{table}' does not exist")
        return QueryResult(["Column", "Type", "Extra", "Comment"],
                           [VARCHAR] * 4,
                           [[c.name, c.type.name, "", ""]
                            for c in meta.columns])

    def _stmt_Describe(self, stmt, sql) -> QueryResult:
        return self._stmt_ShowColumns(A.ShowColumns(stmt.table), sql)

    def _stmt_ShowSession(self, stmt, sql) -> QueryResult:
        rows = [[k, str(self.session.get(k)).lower(), str(d).lower()]
                for k, (_, d) in sorted(SESSION_PROPERTIES.items())]
        return QueryResult(["Name", "Value", "Default"], [VARCHAR] * 3, rows)

    def _stmt_ShowFunctions(self, stmt, sql) -> QueryResult:
        return QueryResult(["Function"], [VARCHAR],
                           [[f] for f in list_functions()])

    def _stmt_ShowCreate(self, stmt, sql) -> QueryResult:
        cat, schema, name = self._qualify(stmt.name)
        if stmt.kind == "view":
            view = self.catalogs.get_view(cat, schema, name)
            if view is None:
                raise QueryError(
                    f"View '{cat}.{schema}.{name}' does not exist")
            return QueryResult(["Create View"], [VARCHAR],
                               [[view.sql or f"CREATE VIEW "
                                 f"{cat}.{schema}.{name} AS ..."]])
        meta = self.catalogs.connector(cat).get_table_metadata(schema, name)
        if meta is None:
            raise QueryError(f"Table '{cat}.{schema}.{name}' does not exist")
        cols = ",\n   ".join(f"{c.name} {c.type}" for c in meta.columns)
        return QueryResult(
            ["Create Table"], [VARCHAR],
            [[f"CREATE TABLE {cat}.{schema}.{name} (\n   {cols}\n)"]])

    def _stmt_ShowStats(self, stmt, sql) -> QueryResult:
        """One row per column from the connector's statistics, then the
        row-count row."""
        cat, schema, name = self._qualify(stmt.table)
        conn = self.catalogs.connector(cat)
        meta = conn.get_table_metadata(schema, name)
        if meta is None:
            raise QueryError(f"Table '{cat}.{schema}.{name}' does not exist")
        handle = TableHandle(cat, schema, name)
        rows_est = conn.table_row_count(handle)
        out = []
        for c in meta.columns:
            cs = conn.column_statistics(handle, c.name)
            if cs is None:
                out.append([c.name] + [None] * 6)
                continue
            def fmt(v):
                return None if v is None else str(v)
            out.append([c.name, None, float(cs.ndv), float(cs.null_fraction),
                        None, fmt(cs.min_value), fmt(cs.max_value)])
        out.append([None, None, None, None,
                    None if rows_est is None else float(rows_est), None,
                    None])
        return QueryResult(
            ["column_name", "data_size", "distinct_values_count",
             "nulls_fraction", "row_count", "low_value", "high_value"],
            [VARCHAR, DOUBLE, DOUBLE, DOUBLE, DOUBLE, VARCHAR, VARCHAR],
            out)

    def _stmt_UseStatement(self, stmt, sql) -> QueryResult:
        if stmt.catalog:
            self.catalogs.connector(stmt.catalog)  # validate
            self.session.catalog = stmt.catalog
        self.session.schema = stmt.schema
        return _msg_result("USE")

    def _stmt_SetSession(self, stmt, sql) -> QueryResult:
        planner = LogicalPlanner(self.catalogs, self.session)
        self.session.set(stmt.name.split(".")[-1],
                         planner._const_expr(stmt.value).value)
        return _msg_result("SET SESSION")

    def _stmt_ResetSession(self, stmt, sql) -> QueryResult:
        self.session.reset(stmt.name.split(".")[-1])
        return _msg_result("RESET SESSION")

    # ---- views -------------------------------------------------------------
    def _stmt_CreateView(self, stmt, sql) -> QueryResult:
        cat, schema, name = self._qualify(stmt.name)
        self.catalogs.connector(cat)  # validate the catalog
        # the definition must plan now
        LogicalPlanner(self.catalogs, self.session).plan(
            A.QueryStatement(stmt.query))
        try:
            self.catalogs.create_view(cat, schema, name,
                                      ViewDefinition(stmt.query, sql),
                                      replace=stmt.replace)
        except KeyError as e:
            raise QueryError(str(e).strip('"')) from e
        return _msg_result("CREATE VIEW")

    def _stmt_DropView(self, stmt, sql) -> QueryResult:
        cat, schema, name = self._qualify(stmt.name)
        if not self.catalogs.drop_view(cat, schema, name) \
                and not stmt.if_exists:
            raise QueryError(f"View '{cat}.{schema}.{name}' does not exist")
        return _msg_result("DROP VIEW")

    # ---- prepared statements and procedures -------------------------------
    def _stmt_Prepare(self, stmt, sql) -> QueryResult:
        self.session.prepared[stmt.name] = stmt.statement
        return _msg_result("PREPARE")

    def _stmt_Deallocate(self, stmt, sql) -> QueryResult:
        if stmt.name not in self.session.prepared:
            raise QueryError(f"Prepared statement not found: {stmt.name}")
        del self.session.prepared[stmt.name]
        return _msg_result("DEALLOCATE")

    def _prepared(self, name: str):
        """A prepared statement by name; one given as SQL text parses
        here."""
        prep = self.session.prepared.get(name)
        if prep is None:
            raise QueryError(f"Prepared statement not found: {name}")
        return parse_statement(prep) if isinstance(prep, str) else prep

    def _stmt_ExecuteStmt(self, stmt, sql) -> QueryResult:
        prep = self._prepared(stmt.name)
        # each USING value binds as its own expression, so that its type
        # stays (a DATE literal stays a DATE, not its day number); the
        # planner checks here that it is a constant
        planner = LogicalPlanner(self.catalogs, self.session)
        for p in stmt.params:
            planner._const_expr(p)
        values = list(stmt.params)
        try:
            bound, used = A.replace_parameters(prep, values)
        except ValueError as e:
            raise QueryError(str(e)) from e
        if used < len(values):
            raise QueryError(f"statement takes {used} parameters but "
                             f"{len(values)} were given")
        return self._dispatch(bound)

    def _stmt_DescribeInput(self, stmt, sql) -> QueryResult:
        n = A.count_parameters(self._prepared(stmt.name))
        return QueryResult(["Position", "Type"], [BIGINT, VARCHAR],
                           [[i, "unknown"] for i in range(n)])

    def _stmt_DescribeOutput(self, stmt, sql) -> QueryResult:
        prep = self._prepared(stmt.name)
        if not isinstance(prep, A.QueryStatement):
            return QueryResult(["Column Name", "Type"], [VARCHAR, VARCHAR],
                               [])
        # NULLs bound to the parameters, so that the query plans
        bound, _ = A.replace_parameters(
            prep, [A.Literal(None)] * A.count_parameters(prep))
        plan = LogicalPlanner(self.catalogs, self.session).plan(bound)
        schema = plan.output_schema()
        return QueryResult(["Column Name", "Type"], [VARCHAR, VARCHAR],
                           [[name, str(schema[s])]
                            for name, s in zip(plan.names, plan.symbols)])

    def _stmt_CallStatement(self, stmt, sql) -> QueryResult:
        parts = tuple(p.lower() for p in stmt.name)
        if len(parts) != 3:
            raise QueryError("CALL requires catalog.schema.procedure")
        cat, schema, proc = parts
        planner = LogicalPlanner(self.catalogs, self.session)
        args = [planner._const_expr(a).value for a in stmt.args]
        try:
            self.catalogs.connector(cat).call_procedure(schema, proc, args)
        except (KeyError, ValueError) as e:
            raise QueryError(str(e).strip('"')) from e
        return _msg_result("CALL")

    # ---- transactions ------------------------------------------------------
    def _stmt_StartTransaction(self, stmt, sql) -> QueryResult:
        if self._txn_snapshot is not None:
            raise QueryError("Nested transactions not supported")
        self._txn_snapshot = {
            name: self.catalogs.connector(name).snapshot_state()
            for name in self.catalogs.list_catalogs()}
        return _msg_result("START TRANSACTION")

    def _stmt_Commit(self, stmt, sql) -> QueryResult:
        if self._txn_snapshot is None:
            raise QueryError("No transaction in progress")
        self._txn_snapshot = None
        return _msg_result("COMMIT")

    def _stmt_Rollback(self, stmt, sql) -> QueryResult:
        if self._txn_snapshot is None:
            raise QueryError("No transaction in progress")
        for name, snap in self._txn_snapshot.items():
            if snap is not None:
                self.catalogs.connector(name).restore_state(snap)
        self._txn_snapshot = None
        return _msg_result("ROLLBACK")

    # ---- privileges --------------------------------------------------------
    def _resolve_table(self, parts) -> Tuple[str, str, str]:
        cat, schema, name = self._qualify(parts)
        conn = self.catalogs.connector(cat)
        if conn.get_table_metadata(schema, name) is None \
                and self.catalogs.get_view(cat, schema, name) is None:
            raise QueryError(f"Table '{cat}.{schema}.{name}' does not exist")
        return cat, schema, name

    def _grant_revoke(self, stmt, sql) -> QueryResult:
        """GRANT, REVOKE and DENY on the engine-level store of
        ``CatalogManager``, so every connector has privileges."""
        cat, schema, name = self._resolve_table(stmt.table)
        store = self.catalogs.grants
        if isinstance(stmt, A.Grant):
            for p in stmt.privileges:
                key = (stmt.grantee, p, cat, schema, name)
                store[key] = stmt.grant_option or store.get(key, False)
            return _msg_result("GRANT")
        if isinstance(stmt, A.Deny):
            for p in stmt.privileges:
                self.catalogs.denies.add((stmt.grantee, p, cat, schema, name))
            return _msg_result("DENY")
        for p in stmt.privileges:
            key = (stmt.grantee, p, cat, schema, name)
            if stmt.grant_option_for:
                if key in store:
                    store[key] = False
            else:
                store.pop(key, None)
                self.catalogs.denies.discard(key)
        return _msg_result("REVOKE")

    _stmt_Grant = _stmt_Revoke = _stmt_Deny = _grant_revoke

    def _stmt_ShowGrants(self, stmt, sql) -> QueryResult:
        flt = None if stmt.table is None else self._resolve_table(stmt.table)
        rows = [[self.session.user or "admin", "USER", grantee, "USER", cat,
                 schema, name, p.upper(), opt, None]
                for (grantee, p, cat, schema, name), opt
                in sorted(self.catalogs.grants.items())
                if flt is None or (cat, schema, name) == flt]
        return QueryResult(
            ["Grantor", "Grantor Type", "Grantee", "Grantee Type",
             "Catalog", "Schema", "Table", "Privilege", "Grantable",
             "With Hierarchy"], [VARCHAR] * 8 + [BOOLEAN, BOOLEAN], rows)

    # ---- tables and writes -------------------------------------------------
    def _stmt_CreateTable(self, stmt, sql) -> QueryResult:
        cat, schema, table = self._qualify(stmt.name)
        self._check_access("create_table", cat, schema, table)
        conn = self.catalogs.connector(cat)
        if conn.get_table_metadata(schema, table) is not None:
            if stmt.if_not_exists:
                return _msg_result("CREATE TABLE")
            raise QueryError(f"Table '{cat}.{schema}.{table}' already exists")
        if stmt.query is not None:
            names, types, batch = self._run_query_batch(stmt.query)
            conn.create_table(TableMetadata(schema, table, tuple(
                ColumnMetadata(n, t) for n, t in zip(names, types))))
            return _msg_result("CREATE TABLE AS",
                               conn.insert(schema, table, batch))
        conn.create_table(TableMetadata(schema, table, tuple(
            ColumnMetadata(c.name.lower(), parse_type(c.type_name))
            for c in stmt.columns)))
        return _msg_result("CREATE TABLE")

    def _stmt_DropTable(self, stmt, sql) -> QueryResult:
        cat, schema, table = self._qualify(stmt.name)
        self._check_access("drop_table", cat, schema, table)
        conn = self.catalogs.connector(cat)
        if conn.get_table_metadata(schema, table) is None:
            if stmt.if_exists:
                return _msg_result("DROP TABLE")
            raise QueryError(f"Table '{cat}.{schema}.{table}' does not exist")
        conn.drop_table(schema, table)
        return _msg_result("DROP TABLE")

    def _stmt_Insert(self, stmt, sql) -> QueryResult:
        cat, schema, table = self._qualify(stmt.table)
        self._check_access("insert", cat, schema, table)
        conn = self.catalogs.connector(cat)
        meta = conn.get_table_metadata(schema, table)
        if meta is None:
            raise QueryError(f"Table '{cat}.{schema}.{table}' does not exist")
        _, types, batch = self._run_query_batch(stmt.query)
        targets = ([c.lower() for c in stmt.columns] if stmt.columns
                   else [c.name for c in meta.columns if not c.hidden])
        if len(types) != len(targets):
            raise QueryError(f"INSERT has {len(types)} columns but table "
                             f"expects {len(targets)}")
        want = [meta.column_type(t) for t in targets]
        if not all(_insert_coercible(q, t) for q, t in zip(types, want)):
            raise QueryError(
                "Insert query has mismatched column types: Table: ["
                + ", ".join(t.name for t in want) + "], Query: ["
                + ", ".join(q.name for q in types) + "]")
        given = dict(zip(targets, batch.columns.values()))
        # the table's columns in its order, each cast on the device to
        # the column's type; a column left out is NULL
        cols = {c.name: cast_column(given.get(c.name, _null_lane(batch)),
                                    c.type)
                for c in meta.columns}
        n = conn.insert(schema, table, Batch(cols, batch.num_rows))
        return _msg_result("INSERT", n)

    def _writable(self, cat: str, schema: str, table: str, what: str):
        conn = self.catalogs.connector(cat)
        meta = conn.get_table_metadata(schema, table)
        if meta is None:
            raise QueryError(f"Table '{cat}.{schema}.{table}' does not exist")
        if not hasattr(conn, "replace"):
            raise QueryError(f"{conn.name}: {what} not supported")
        return conn, meta

    def _stmt_Delete(self, stmt, sql) -> QueryResult:
        """DELETE as a rewrite of the table to its survivors."""
        cat, schema, table = self._qualify(stmt.table)
        self._check_access("delete", cat, schema, table)
        conn, meta = self._writable(cat, schema, table, "DELETE")
        total = int(conn.table_row_count(TableHandle(cat, schema, table))
                    or 0)
        if stmt.where is None:
            conn.replace(schema, table, empty_batch(
                {c.name: c.type for c in meta.columns}, self.device))
            return _msg_result("DELETE", total)
        # survivors: rows where the predicate is not TRUE
        _, _, kept = self._run_query_batch(A.Query(A.QuerySpecification(
            tuple(A.SelectItem(A.Identifier((c.name,)), c.name)
                  for c in meta.columns),
            from_=A.Table((cat, schema, table)),
            where=A.UnaryOp("not", A.FunctionCall(
                "coalesce", (stmt.where, A.Literal(False)))))))
        survivors = kept.num_rows_host()
        conn.replace(schema, table, kept)
        return _msg_result("DELETE", total - survivors)

    def _stmt_Update(self, stmt, sql) -> QueryResult:
        """UPDATE as a rewrite of the whole table: each assigned column
        becomes CASE WHEN pred THEN CAST(value) ELSE column END."""
        cat, schema, table = self._qualify(stmt.table)
        self._check_access("update", cat, schema, table)
        conn, meta = self._writable(cat, schema, table, "UPDATE")
        names = {c.name for c in meta.columns}
        assigns = {}
        for col, e in stmt.assignments:
            if col.lower() not in names:
                raise QueryError(f"Column '{col}' does not exist")
            assigns[col.lower()] = e
        cond = (A.FunctionCall("coalesce", (stmt.where, A.Literal(False)))
                if stmt.where is not None else A.Literal(True))
        items = [A.SelectItem(
            A.Case(((cond, A.Cast(assigns[c.name], str(c.type))),),
                   A.Identifier((c.name,))) if c.name in assigns
            else A.Identifier((c.name,)), c.name) for c in meta.columns]
        items.append(A.SelectItem(cond, "__updated"))
        _, _, out = self._run_query_batch(A.Query(A.QuerySpecification(
            tuple(items), from_=A.Table((cat, schema, table)))))
        updated = _count_true(out, "__updated")
        conn.replace(schema, table, out.select_columns(meta.column_names))
        return _msg_result("UPDATE", updated)

    def _stmt_Merge(self, stmt, sql) -> QueryResult:
        """MERGE INTO target USING source ON cond WHEN ..., run as
        queries: matched target rows go through nested CASE transforms
        (the first clause that holds wins; a DELETE arm drops the row),
        and unmatched source rows that satisfy a NOT MATCHED arm are
        appended. A target row that matches several source rows is not
        detected (Trino raises); the first join expansion wins."""
        cat, schema, table = self._qualify(stmt.target)
        self._check_access("update", cat, schema, table)
        conn, meta = self._writable(cat, schema, table, "MERGE")
        talias = (stmt.target_alias or table).lower()
        trel: A.Relation = A.Table((cat, schema, table))
        if stmt.target_alias:
            trel = A.AliasedRelation(trel, talias, ())
        # the source with a match indicator column
        ind = "__merge_m"
        src = stmt.source
        if isinstance(src, A.AliasedRelation):
            src_alias = src.alias.lower()
        elif isinstance(src, A.Table):
            src_alias = src.parts[-1].lower()
        else:
            raise QueryError("MERGE source subquery requires an alias")
        wrapped = A.AliasedRelation(
            A.SubqueryRelation(A.Query(A.QuerySpecification(
                (A.SelectItem(A.Star(), None),
                 A.SelectItem(A.Literal(1), ind)),
                from_=src))), src_alias, ())
        matched_flag = A.IsNull(A.Identifier((src_alias, ind)), negated=True)

        def arm_cond(cl: "A.MergeClause") -> A.Expression:
            c: A.Expression = matched_flag if cl.matched else \
                A.IsNull(A.Identifier((src_alias, ind)))
            if cl.condition is not None:
                c = A.BinaryOp("and", c, A.FunctionCall(
                    "coalesce", (cl.condition, A.Literal(False))))
            return c

        matched_clauses = [c for c in stmt.clauses if c.matched]
        insert_clauses = [c for c in stmt.clauses if not c.matched]
        for cl in insert_clauses:
            if cl.action != "insert":
                raise QueryError("WHEN NOT MATCHED supports only INSERT")
        for cl in matched_clauses:
            if cl.action not in ("update", "delete"):
                raise QueryError(
                    "WHEN MATCHED supports only UPDATE or DELETE")

        # pass 1: the target's rows, kept or transformed
        items = []
        for c in meta.columns:
            whens = []
            for cl in matched_clauses:
                if cl.action != "update":
                    continue
                assigns = {k.lower(): v for k, v in cl.assignments}
                whens.append((arm_cond(cl),
                              A.Cast(assigns[c.name], str(c.type))
                              if c.name in assigns
                              else A.Identifier((talias, c.name))))
            items.append(A.SelectItem(
                A.Case(tuple(whens), A.Identifier((talias, c.name)))
                if whens else A.Identifier((talias, c.name)), c.name))
        keep_whens = tuple((arm_cond(cl), A.Literal(cl.action != "delete"))
                           for cl in matched_clauses)
        fired_whens = tuple((arm_cond(cl), A.Literal(True))
                            for cl in matched_clauses)
        items.append(A.SelectItem(A.Case(keep_whens, A.Literal(True)),
                                  "__keep"))
        items.append(A.SelectItem(A.Case(fired_whens, A.Literal(False)),
                                  "__fired"))
        _, _, res = self._run_query_batch(A.Query(A.QuerySpecification(
            tuple(items), from_=A.Join("left", trel, wrapped, on=stmt.on))))
        n_changed = _count_true(res, "__fired")
        parts = [compact.filter_batch(_conform(res, meta),
                                      _true_lane(res.column("__keep")))]

        # pass 2: the NOT MATCHED inserts
        for cl in insert_clauses:
            cols = tuple(c.lower() for c in cl.insert_columns) or \
                tuple(meta.column_names)
            if len(cols) != len(cl.insert_values):
                raise QueryError("MERGE INSERT arity mismatch")
            by_col = dict(zip(cols, cl.insert_values))
            ins_items = tuple(
                A.SelectItem(A.Cast(by_col[c.name], str(c.type))
                             if c.name in by_col else A.Literal(None),
                             c.name)
                for c in meta.columns)
            where: A.Expression = A.Exists(A.Query(A.QuerySpecification(
                (A.SelectItem(A.Literal(1), None),),
                from_=trel, where=stmt.on)), negated=True)
            if cl.condition is not None:
                where = A.BinaryOp("and", where, A.FunctionCall(
                    "coalesce", (cl.condition, A.Literal(False))))
            _, _, ins = self._run_query_batch(A.Query(A.QuerySpecification(
                ins_items, from_=src, where=where)))
            n_changed += ins.num_rows_host()
            parts.append(_conform(ins, meta))
        conn.replace(schema, table, device_concat(parts))
        return _msg_result("MERGE", n_changed)

    def _check_access(self, privilege: str, cat: str, schema: str,
                      table: str) -> None:
        ac = self.catalogs.access_control
        if ac is None:
            return
        from .security import AccessDeniedError
        try:
            getattr(ac, f"check_can_{privilege}")(
                self.session.user, cat, schema, table)
        except AccessDeniedError as e:
            raise QueryError(str(e)) from e

    def _qualify(self, parts: Tuple[str, ...]):
        parts = tuple(p.lower() for p in parts)
        if len(parts) == 3:
            return parts
        if len(parts) == 2:
            return (self.session.catalog,) + parts
        return (self.session.catalog, self.session.schema or "default",
                parts[0])


def _msg_result(update_type: str,
                count: Optional[int] = None) -> QueryResult:
    return QueryResult([], [], [], update_type=update_type,
                       update_count=count)


def _true_lane(c: Column) -> torch.Tensor:
    """Rows where a BOOLEAN column is TRUE (NULL is not)."""
    return c.data if c.valid is None else c.data & c.valid


def _count_true(b: Batch, name: str) -> int:
    """Live rows where the BOOLEAN column ``name`` is TRUE: a sum on the
    device, one scalar to the host."""
    return int((_true_lane(b.column(name)) & b.row_valid()).sum())


def _conform(b: Batch, meta: TableMetadata) -> Batch:
    """The table's columns of ``b``, each of the table's type: a column
    left out of a MERGE insert is a NULL literal, of type unknown."""
    return Batch({c.name: cast_column(b.column(c.name), c.type)
                  for c in meta.columns}, b.num_rows)


def _null_lane(b: Batch) -> Column:
    """An all-NULL column of type unknown over ``b``'s capacity."""
    return Column(UNKNOWN, torch.zeros(b.capacity, dtype=torch.bool,
                                       device=b.device),
                  torch.zeros(b.capacity, dtype=torch.bool,
                              device=b.device))


_INT_RANK = {"tinyint": 0, "smallint": 1, "integer": 2, "bigint": 3}


def _insert_coercible(src: Type, dst: Type) -> bool:
    """Whether Trino's INSERT accepts a query column of type ``src`` for
    a table column of type ``dst``: the two are equal, or ``src`` coerces
    to ``dst`` implicitly (TypeCoercion.canCoerce): integer widening,
    integers and decimals to REAL and DOUBLE, REAL to DOUBLE, an integer
    or a decimal to a decimal that keeps its integer digits and its
    scale, a bounded VARCHAR or CHAR to one at least as long (or an
    unbounded VARCHAR), DATE to TIMESTAMP, and NULL to anything; an
    ARRAY, MAP or ROW when its parts coerce."""
    if src == dst or src == UNKNOWN:
        return True
    if isinstance(src, ArrayType) and isinstance(dst, ArrayType):
        return _insert_coercible(src.element, dst.element)
    if isinstance(src, MapType) and isinstance(dst, MapType):
        return (_insert_coercible(src.key, dst.key)
                and _insert_coercible(src.value, dst.value))
    if isinstance(src, RowType) and isinstance(dst, RowType):
        return len(src.fields) == len(dst.fields) and all(
            _insert_coercible(s, d)
            for (_, s), (_, d) in zip(src.fields, dst.fields))
    if is_integral(src) and is_integral(dst):
        return _INT_RANK[src.name] <= _INT_RANK[dst.name]
    if (is_integral(src) or isinstance(src, DecimalType)) \
            and dst.name in ("real", "double"):
        return True
    if src.name == "real" and dst.name == "double":
        return True
    if isinstance(dst, DecimalType) and (
            is_integral(src) or isinstance(src, DecimalType)):
        s = default_decimal_for(src) if is_integral(src) else src
        return (dst.scale >= s.scale
                and dst.precision - dst.scale >= s.precision - s.scale)
    if isinstance(src, VarcharType) and isinstance(dst, VarcharType):
        return dst.length is None or (
            src.length is not None and src.length <= dst.length)
    if isinstance(src, CharType) and isinstance(dst, CharType):
        return src.length <= dst.length
    return src.name == "date" and dst.name.startswith("timestamp")
