"""LocalQueryRunner: in-process parse -> plan -> optimize -> execute.

Counterpart of ``trino_tpu/runner.py`` for the SELECT and EXPLAIN paths,
over the PyTorch executor, with the tpch and tpcds catalogs. The runner runs on
``"cuda"`` unless its caller passes ``device="cpu"``; without a card it
raises (config.resolve_device).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .catalog import CatalogManager
from .config import DeviceLike, resolve_device
from .connectors.tpcds import TpcdsConnector
from .connectors.tpch import TpchConnector
from .exec.executor import Executor, QueryError
from .plan.nodes import OutputNode, plan_tree_lines
from .planner import LogicalPlanner, PlanningError
from .planner.optimizer import optimize
from .session import Session
from .sql import ast as A
from .sql.parser import parse_statement
from .sql.tokenizer import ParseError
from .types import VARCHAR, Type


@dataclass
class QueryResult:
    """Client-facing result: column names, types and rows."""
    columns: List[str]
    types: List[Type]
    rows: List[list]
    query_id: str = ""
    wall_s: float = 0.0
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


class LocalQueryRunner:
    """Runs SQL in this process on one torch device."""

    def __init__(self, session: Optional[Session] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.catalogs.register("tpch", TpchConnector(device=self.device))
        self.catalogs.register("tpcds", TpcdsConnector(device=self.device))
        self.session = session or Session(catalog="tpch", schema="tiny")

    def execute(self, sql: str) -> QueryResult:
        t0 = time.perf_counter()
        try:
            stmt = parse_statement(sql)
        except ParseError as e:
            raise QueryError(f"SYNTAX_ERROR: {e}") from e
        qid = self.session.query_id or self.session.next_query_id()
        try:
            if isinstance(stmt, A.QueryStatement):
                result = self._run_query(stmt)
            elif isinstance(stmt, A.Explain) and not stmt.analyze:
                result = QueryResult(
                    ["Query Plan"], [VARCHAR],
                    [[line] for line in plan_tree_lines(
                        self._plan(stmt.statement))])
            else:
                raise QueryError(
                    f"not yet ported: statement {type(stmt).__name__}")
        except PlanningError as e:
            raise QueryError(str(e)) from e
        except KeyError as e:
            raise QueryError(str(e).strip('"')) from e
        result.query_id = qid
        result.wall_s = time.perf_counter() - t0
        return result

    def plan_sql(self, sql: str) -> OutputNode:
        stmt = parse_statement(sql)
        return self._plan(stmt.statement if isinstance(stmt, A.Explain)
                          else stmt)

    def _plan(self, stmt) -> OutputNode:
        if not isinstance(stmt, A.QueryStatement):
            raise QueryError("only queries can be planned")
        plan = LogicalPlanner(self.catalogs, self.session).plan(stmt)
        return optimize(plan, self.catalogs, self.session)

    def _run_query(self, stmt: A.QueryStatement) -> QueryResult:
        plan = self._plan(stmt)
        ex = Executor(self.catalogs, self.session, self.device)
        batch = ex.execute(plan)
        schema = batch.schema()
        return QueryResult(list(plan.names),
                           [schema[s] for s in plan.symbols],
                           batch.to_pylist(), join_sizes=ex.join_sizes,
                           spill_bytes=ex.spilled_bytes,
                           peak_reserved_bytes=ex.peak_reserved_bytes,
                           stream_chunks=ex.stream_chunks,
                           stream_h2d_bytes=ex.stream_h2d_bytes,
                           stream_overlapped=ex.stream_overlapped,
                           stream_copy_ms=ex.stream_copy_ms,
                           stream_wait_ms=ex.stream_wait_ms,
                           stream_ops=dict(ex.stream_ops))
