"""Single-process plan executor over torch tensors.

Counterpart of ``trino_tpu/exec/executor.py``, eager: the executor walks
the plan bottom-up and evaluates each node as whole-column tensor
operations over capacity-padded Batches on one device. There are no jit
caches. An aggregation over a Filter/Project chain evaluates the filter
into a live mask that the aggregation consumes directly, with no
compaction (``_try_masked_filter_aggregation``).

Plan nodes, expressions and aggregates outside the ported slice raise
``QueryError("not yet ported: ...")``; nothing runs through another
engine.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..catalog import CatalogManager
from ..columnar import (Batch, Column, StringDictionary, batch_from_pylist,
                        take_clamped)
from ..config import (MemoryLimitExceeded, capacity_for, reserve_bytes)
from ..ops import compact, sort as sort_ops
from ..ops.groupby import AggInput, global_aggregate, group_aggregate
from ..plan.nodes import (Aggregate, AggregationNode, FilterNode, LimitNode,
                          OutputNode, PlanNode, ProjectNode, SortNode,
                          TableScanNode, TopNNode, ValuesNode)
from ..session import Session
from ..types import BIGINT, DecimalType, REAL, is_string
from .expr import EvalError, eval_expr, eval_predicate


class QueryError(Exception):
    """Engine/user-facing failure."""

    def __init__(self, message: str, error_name: Optional[str] = None):
        super().__init__(message)
        if error_name is not None:
            self.error_name = error_name


class Executor:
    def __init__(self, catalogs: CatalogManager, session: Session,
                 device: torch.device):
        self.catalogs = catalogs
        self.session = session
        self.device = device

    def execute(self, node: PlanNode) -> Batch:
        cancel = self.session.cancel
        if cancel is not None and cancel.is_set():
            raise QueryError("Query was canceled")
        deadline = self.session.deadline
        if deadline is not None and time.monotonic() > deadline:
            raise QueryError(
                "Query exceeded the maximum run time "
                "(query_max_run_time)", error_name="EXCEEDED_TIME_LIMIT")
        try:
            if isinstance(node, AggregationNode):
                masked = self._try_masked_filter_aggregation(node)
                if masked is not None:
                    return masked
            method = getattr(self, "_exec_" + type(node).__name__, None)
            if method is None:
                raise QueryError(
                    f"not yet ported: {type(node).__name__}")
            return method(node)
        except (EvalError, NotImplementedError) as e:
            raise QueryError(str(e)) from e

    # ------------------------------------------------------------------
    # masked (selection-vector) filter -> aggregation fusion: filters
    # below an aggregation become a live mask consumed by the
    # aggregation, with no compaction gather
    # ------------------------------------------------------------------
    def _masked_chain_eval(self, chain, b: Batch):
        """Evaluate a Filter/Project chain over ``b`` without compacting:
        returns (columns, live mask). Dead rows compute garbage values
        that the mask consumer ignores."""
        live = b.row_valid()
        cols = dict(b.columns)
        cap = b.capacity
        for nd in reversed(chain):
            # num_rows=cap: every row is live inside expression eval;
            # the real liveness is tracked in `live`
            bb = Batch(cols, cap)
            if isinstance(nd, FilterNode):
                live = live & eval_predicate(nd.predicate, bb)
            else:
                cols = {s: eval_expr(e, bb)
                        for s, e in nd.assignments.items()}
        return cols, live

    def _try_masked_filter_aggregation(self, node: AggregationNode):
        chain: List[PlanNode] = []
        cur = node.source
        while isinstance(cur, (FilterNode, ProjectNode)):
            chain.append(cur)
            cur = cur.source
        if not any(isinstance(n, FilterNode) for n in chain):
            return None
        cols, live = self._masked_chain_eval(chain, self.execute(cur))
        return _aggregate(node, Batch(cols, live.sum(dtype=torch.int64)),
                          live)

    # ------------------------------------------------------------------
    def _exec_TableScanNode(self, node: TableScanNode) -> Batch:
        conn = self.catalogs.connector(node.handle.catalog)
        columns = sorted(set(node.assignments.values()))
        par = int(self.session.get("task_concurrency")) or 1
        if node.handle.constraint is None and node.handle.limit is None \
                and hasattr(conn, "table_row_count"):
            # reserve before allocating, so an oversized table fails
            # with the memory-limit error instead of a device OOM
            est = conn.table_row_count(node.handle)
            if est:
                try:
                    reserve_bytes(
                        int(est), len(columns),
                        int(self.session.get("query_max_memory_per_node")),
                        f"table scan of {node.handle.table}")
                except MemoryLimitExceeded as e:
                    raise QueryError(
                        str(e), error_name="EXCEEDED_LOCAL_MEMORY_LIMIT"
                    ) from e
        splits = conn.get_splits(node.handle, par)
        parts = [conn.read_split(s, columns).to(self.device)
                 for s in splits]
        whole = device_concat(parts) if len(parts) > 1 else parts[0]
        return Batch({sym: whole.column(col)
                      for sym, col in node.assignments.items()},
                     whole.num_rows)

    def _exec_ValuesNode(self, node: ValuesNode) -> Batch:
        data = {s: [row[i] for row in node.rows]
                for i, s in enumerate(node.schema)}
        return batch_from_pylist(data, dict(node.schema),
                                 device=self.device)

    def _exec_FilterNode(self, node: FilterNode) -> Batch:
        src = self.execute(node.source)
        return compact.filter_batch(src, eval_predicate(node.predicate,
                                                        src))

    def _exec_ProjectNode(self, node: ProjectNode) -> Batch:
        src = self.execute(node.source)
        return Batch({s: eval_expr(e, src)
                      for s, e in node.assignments.items()}, src.num_rows)

    def _exec_OutputNode(self, node: OutputNode) -> Batch:
        src = self.execute(node.source)
        return Batch({s: src.column(s) for s in node.symbols},
                     src.num_rows)

    def _exec_LimitNode(self, node: LimitNode) -> Batch:
        return compact.limit_batch(self.execute(node.source), node.count)

    def _exec_SortNode(self, node: SortNode) -> Batch:
        return sort_ops.sort_batch(self.execute(node.source),
                                   _sort_keys(node.keys))

    def _exec_TopNNode(self, node: TopNNode) -> Batch:
        return sort_ops.topn_batch(self.execute(node.source),
                                   _sort_keys(node.keys), node.count)

    def _exec_AggregationNode(self, node: AggregationNode) -> Batch:
        return _aggregate(node, self.execute(node.source), None)


def _sort_keys(keys) -> List[sort_ops.SortKey]:
    return [sort_ops.SortKey(k.symbol, k.ascending, k.nulls_first)
            for k in keys]


def _aggregate(node: AggregationNode, src: Batch,
               live: Optional[torch.Tensor]) -> Batch:
    """Lower the logical aggregates, aggregate (grouped or global), then
    apply the post functions (avg = sum / count)."""
    phys, post = _lower_aggregates(node.aggregates)
    if node.group_keys:
        out = group_aggregate(src, list(node.group_keys), phys, live=live)
    elif phys:
        out = global_aggregate(src, phys, live=live)
    else:
        return _single_row(src.device)
    if post:
        cols = dict(out.columns)
        for sym, fn in post.items():
            cols[sym] = fn(out)
        keep = set(node.group_keys) | set(node.aggregates)
        out = Batch({s: c for s, c in cols.items() if s in keep},
                    out.num_rows)
    return out


def _single_row(device: torch.device) -> Batch:
    return Batch({"__one$": Column(
        BIGINT, torch.zeros(8, dtype=torch.int64, device=device))}, 1)


def _lower_aggregates(aggregates: Dict[str, Aggregate]):
    """Map logical aggregates onto the kernel-supported kinds, returning
    (phys_aggs, post_fns). avg becomes sum + count, as the reference's
    LongAndDoubleState."""
    phys: List[AggInput] = []
    post = {}
    for sym, a in aggregates.items():
        kind = a.kind
        if a.distinct:
            raise NotImplementedError(f"not yet ported: {kind}(DISTINCT)")
        if kind in ("sum", "min", "max", "count", "count_star"):
            phys.append(AggInput(kind, a.argument, a.mask, sym))
        elif kind in ("any_value", "arbitrary"):
            phys.append(AggInput("any_value", a.argument, a.mask, sym))
        elif kind == "avg":
            ssym, csym = sym + "$sum", sym + "$cnt"
            phys.append(AggInput("sum", a.argument, a.mask, ssym))
            phys.append(AggInput("count", a.argument, a.mask, csym))
            post[sym] = _avg_post(ssym, csym, a.type)
        else:
            raise NotImplementedError(f"not yet ported: aggregate {kind}")
    return phys, post


def _avg_post(ssym, csym, rtype):
    def fn(out: Batch) -> Column:
        s = out.column(ssym)
        cnt = out.column(csym).data.to(torch.float64)
        if isinstance(rtype, DecimalType) or isinstance(s.type,
                                                        DecimalType):
            raise NotImplementedError(f"not yet ported: avg to {rtype}")
        data = s.data.to(torch.float64) / torch.clamp(cnt, min=1.0)
        if rtype is REAL:
            data = data.to(torch.float32)
        return Column(rtype, data, cnt > 0)
    return fn


def device_concat(parts: Sequence[Batch]) -> Batch:
    """Concatenate the live rows of batches on one device, merging string
    dictionaries, into the capacity bucket of the total."""
    counts = [p.num_rows_host() for p in parts]
    total = sum(counts)
    cap = capacity_for(max(total, 1), minimum=8)
    cols: Dict[str, Column] = {}
    for name in parts[0].names:
        cs = [p.column(name) for p in parts]
        first = cs[0]
        datas = [c.data[:n] for c, n in zip(cs, counts)]
        dic: Optional[StringDictionary] = first.dictionary
        if is_string(first.type) and any(c.dictionary is not dic
                                         for c in cs):
            remapped = []
            for c, d in zip(cs, datas):
                dic, _, ro = dic.merge(c.dictionary)
                table = torch.from_numpy(np.asarray(ro, np.int32))
                remapped.append(take_clamped(table.to(d.device), d))
            datas = remapped
        valid = None
        if any(c.valid is not None for c in cs):
            valid = _cat_into([c.valid_mask()[:n]
                               for c, n in zip(cs, counts)], cap)
        data2 = None
        if any(c.data2 is not None for c in cs):
            if not all(c.data2 is not None for c in cs):
                raise NotImplementedError(
                    "not yet ported: concat of mixed high lanes")
            data2 = _cat_into([c.data2[:n] for c, n in zip(cs, counts)],
                              cap)
        cols[name] = Column(first.type, _cat_into(datas, cap), valid, dic,
                            data2)
    return Batch(cols, total)


def _cat_into(pieces: Sequence[torch.Tensor], cap: int) -> torch.Tensor:
    """Pieces copied one after another into a zeroed lane of ``cap``
    rows (one allocation, however many pieces)."""
    out = torch.zeros(cap, dtype=pieces[0].dtype, device=pieces[0].device)
    off = 0
    for p in pieces:
        out[off:off + p.shape[0]].copy_(p)
        off += p.shape[0]
    return out
