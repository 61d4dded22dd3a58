"""Single-process plan executor over torch tensors.

Counterpart of ``trino_tpu/exec/executor.py``, eager: the executor walks
the plan bottom-up and evaluates each node as whole-column tensor
operations over capacity-padded Batches on one device. There are no jit
caches. An aggregation over a Filter/Project chain evaluates the filter
into a live mask that the aggregation consumes directly, with no
compaction (``_try_masked_filter_aggregation``). Joins and semi-joins
are the sort + binary-search joins of ops/join.py, materialised whole
(the JAX engine's eager ``join_ops`` path).

Host spill: a join whose output exceeds ``max_batch_rows`` expands its
probe rows in chunks on the device, filters each chunk by the residual
there, and copies each chunk's live rows to host memory (pinned on a
card), as the JAX engine's ``_oversized_join`` does. The spilled batch
moves back to the device in one place, ``Executor.execute``, where a node
reads its child's output; a node that returns a batch on another device
without the spill mark is an error. Operators never compute on host
lanes (the one exception is ``device_concat``, which keeps a merge that
includes a spilled part on the host, as the JAX engine does).

Plan nodes, expressions and aggregates outside the ported slice raise
``QueryError("not yet ported: ...")``; nothing runs through another
engine.
"""

from __future__ import annotations

import time
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..catalog import CatalogManager
from ..columnar import (Batch, Column, StringDictionary, batch_from_pylist,
                        take_clamped)
from ..config import (CONFIG, MemoryLimitExceeded, capacity_for,
                      reserve_bytes)
from ..ops import compact, join as join_ops, sort as sort_ops
from ..ops.groupby import AggInput, global_aggregate, group_aggregate
from ..plan.nodes import (Aggregate, AggregationNode, EnforceSingleRowNode,
                          FilterNode, JoinClause, JoinNode, LimitNode,
                          OutputNode, PlanNode, ProjectNode, SemiJoinNode,
                          SortNode, TableScanNode, TopNNode, ValuesNode)
from ..planner.logical import SemiJoinMultiNode
from ..rex import Call, InputRef, and_all
from ..session import Session
from ..types import BIGINT, BOOLEAN, DOUBLE, DecimalType, REAL, is_string
from .expr import EvalError, eval_expr, eval_predicate
from .streamjoin import col_bytes, maybe_stream_join

# position lanes that carry probe / build row numbers through a residual
# filter, so outer rows whose matches all failed can be null-extended
_PPOS, _BPOS = "__probe_pos$", "__build_pos$"


class QueryError(Exception):
    """Engine/user-facing failure."""

    def __init__(self, message: str, error_name: Optional[str] = None):
        super().__init__(message)
        if error_name is not None:
            self.error_name = error_name


def _keys_inexact(cols: Dict[str, Column], keys: Sequence[str]) -> bool:
    """True when the u64 equality lane of ops/join.py is not bijective
    for these keys: several columns (hash-combined), a float (hashed) or
    an Int128 decimal (only the low lane is hashed)."""
    if len(keys) > 1:
        return True
    c = cols[keys[0]]
    return c.data2 is not None or c.data.is_floating_point()


def join_verify_filter(left_cols, right_cols, pkeys, bkeys, filt):
    """Hash-collision re-verification: when the key lane is inexact,
    append key-equality conjuncts to the residual filter, so the residual
    path drops collision rows and repairs outer rows from the surviving
    matches."""
    if not (_keys_inexact(left_cols, pkeys)
            or _keys_inexact(right_cols, bkeys)):
        return filt
    eqs = [Call("=", (InputRef(pk, left_cols[pk].type),
                      InputRef(bk, right_cols[bk].type)), BOOLEAN)
           for pk, bk in zip(pkeys, bkeys)]
    return and_all(([filt] if filt is not None else []) + eqs)


class Executor:
    def __init__(self, catalogs: CatalogManager, session: Session,
                 device: torch.device):
        self.catalogs = catalogs
        self.session = session
        self.device = device
        # (probe rows, build rows, output rows) of each join, in the
        # order the joins finish
        self.join_sizes: List[Tuple[int, int, int]] = []
        # bytes of join output written to host memory (host spill)
        self.spilled_bytes: int = 0

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
            out = None
            if isinstance(node, AggregationNode):
                out = self._try_masked_filter_aggregation(node)
            if out is None:
                method = getattr(self, "_exec_" + type(node).__name__,
                                 None)
                if method is None:
                    raise QueryError(
                        f"not yet ported: {type(node).__name__}")
                out = method(node)
        except (EvalError, NotImplementedError) as e:
            raise QueryError(str(e)) from e
        if out.spilled:
            # the one place a spilled batch returns to the device: the
            # parent reads its child's output here, from pinned memory
            return out.to(self.device, non_blocking=True)
        self._check_device(out, type(node).__name__)
        return out

    def _check_device(self, b: Batch, what: str) -> None:
        dev = self.device
        for name, c in b.columns.items():
            for t in (c.data, c.valid, c.data2):
                if t is not None and (t.device.type != dev.type or (
                        dev.index is not None
                        and t.device.index != dev.index)):
                    raise QueryError(
                        f"internal error: {what} returned column {name} "
                        f"on {t.device}, not on {dev}, without the spill "
                        "mark")

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
            est = conn.table_row_count(node.handle)
            if est:
                self._reserve(int(est), len(columns),
                              f"table scan of {node.handle.table}")
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

    def _exec_EnforceSingleRowNode(self, node: EnforceSingleRowNode
                                   ) -> Batch:
        src = self.execute(node.source)
        n = src.num_rows_host()
        if n > 1:
            raise QueryError("Scalar sub-query has returned multiple rows")
        if n == 0:
            # one all-NULL row
            return Batch({s: dc_replace(c, valid=torch.zeros(
                c.capacity, dtype=torch.bool, device=c.device))
                for s, c in src.columns.items()}, 1)
        return src

    # ------------------------------------------------------------------
    # joins
    # ------------------------------------------------------------------
    def _exec_JoinNode(self, node: JoinNode) -> Batch:
        jt = node.join_type
        if jt == "right":
            return self._exec_JoinNode(JoinNode(
                node.right, node.left, "left",
                tuple(JoinClause(c.right, c.left) for c in node.criteria),
                node.filter))
        pre_built = maybe_stream_join(self, node)
        left = self.execute(node.left)
        right = (pre_built if pre_built is not None
                 else self.execute(node.right))
        out = self._join(node, left, right)
        self.join_sizes.append((left.num_rows_host(), right.num_rows_host(),
                                out.num_rows_host()))
        return out

    def _join(self, node: JoinNode, left: Batch, right: Batch) -> Batch:
        jt = node.join_type
        if jt == "cross" or not node.criteria:
            return self._cross_join(left, right, node.filter, jt)

        pkeys = [c.left for c in node.criteria]
        bkeys = [c.right for c in node.criteria]
        filt = join_verify_filter(left.columns, right.columns, pkeys,
                                  bkeys, node.filter)
        width = len(left.columns) + len(right.columns)
        if filt is None:
            outer = jt in ("left", "full")
            start, count, order = join_ops.match_counts(left, right, pkeys,
                                                        bkeys)
            eff = (torch.where(left.row_valid(), count.clamp(min=1), 0)
                   if outer else count)
            total = int(eff.sum())
            if total > CONFIG.max_batch_rows:
                out = self._oversized_join(left, right, start, count, eff,
                                           order, total, width,
                                           "left" if outer else "inner")
            else:
                self._reserve(total, width, "join output")
                out = join_ops.expand_join(left, right, start, count,
                                           order, capacity_for(total),
                                           "left" if outer else "inner")
            if jt == "full":
                out = self._append_right_unmatched(out, left, right, pkeys,
                                                   bkeys)
            return out
        # residual filter: expand as inner candidates carrying probe and
        # build positions, filter, then null-extend the outer rows from
        # the surviving matches (a key match the filter rejects must
        # still null-extend)
        probe = (_with_pos(left, _PPOS) if jt in ("left", "full")
                 else left)
        build = _with_pos(right, _BPOS) if jt == "full" else right
        start, count, order = join_ops.match_counts(probe, build, pkeys,
                                                    bkeys)
        total = int(count.sum())
        if total > CONFIG.max_batch_rows and jt == "inner":
            return self._oversized_join(probe, build, start, count, count,
                                        order, total, width, "inner",
                                        residual=filt)
        self._reserve(total, width, "join candidates")
        cand = join_ops.expand_join(probe, build, start, count, order,
                                    capacity_for(total), "inner")
        out = compact.filter_batch(cand, eval_predicate(filt, cand))
        return self._repair_outer(out, left, right, jt)

    def _reserve(self, rows: int, n_lanes: int, what: str) -> None:
        """Check an allocation against query_max_memory_per_node before
        making it, so an oversized result fails with the memory-limit
        error instead of a device OOM."""
        limit = int(self.session.get("query_max_memory_per_node"))
        try:
            reserve_bytes(rows, n_lanes, limit, what)
        except MemoryLimitExceeded as e:
            raise QueryError(str(e), error_name="EXCEEDED_LOCAL_MEMORY_LIMIT"
                             ) from e

    def _oversized_join(self, probe: Batch, build: Batch, start, count,
                        eff, order, total: int, width: int, jt: str,
                        residual=None) -> Batch:
        """Join whose output exceeds the per-batch device budget: expand
        probe-row chunks of at most ``max_batch_rows`` output rows on the
        device, filter each by the residual there, and copy each chunk's
        live rows to host memory (the spiller role of the reference's
        HashBuilderOperator; host RAM is the first rung of the
        device -> host -> disk ladder). With spill disabled the memory
        guard decides first."""
        if not bool(self.session.get("spill_enabled")):
            self._reserve(total, width, "join output (spill disabled)")
        cum = np.cumsum(eff.cpu().numpy())
        budget = CONFIG.max_batch_rows
        n_live = probe.num_rows_host()
        dev = probe.device
        chunks: List[Batch] = []
        lo = consumed = 0
        while lo < probe.capacity and consumed < total:
            hi = max(int(np.searchsorted(cum, consumed + budget, "right")),
                     lo + 1)
            chunk_rows = int(cum[hi - 1] - consumed)
            if chunk_rows == 0:
                lo = hi
                continue
            sel = torch.arange(lo, hi, dtype=torch.int64, device=dev)
            # gathered rows are live iff their position was in the live
            # prefix, so the chunk's liveness is again a prefix
            sub = probe.gather(sel, max(min(n_live, hi) - lo, 0))
            out = join_ops.expand_join(sub, build, start[sel], count[sel],
                                       order, capacity_for(chunk_rows), jt)
            consumed += chunk_rows
            lo = hi
            if residual is not None:
                # only the survivors leave the device
                out = compact.filter_batch(out,
                                           eval_predicate(residual, out))
                chunk_rows = out.num_rows_host()
                if chunk_rows == 0:
                    continue
            spilled = _to_host(out, chunk_rows)
            self.spilled_bytes += sum(col_bytes(c)
                                      for c in spilled.columns.values())
            chunks.append(spilled)
        if not chunks:
            empty = _to_host(join_ops.expand_join(
                probe, build, start, torch.zeros_like(count), order, 8, jt),
                8)
            return Batch(empty.columns, 0, spilled=True)
        return device_concat(chunks)

    def _cross_join(self, left: Batch, right: Batch, filt,
                    jt: str = "inner") -> Batch:
        """Cross or non-equi join (no equi criteria); for left/full outer
        variants the positions ride through the filter, as in the
        residual path."""
        total = left.num_rows_host() * right.num_rows_host()
        self._reserve(total, len(left.columns) + len(right.columns),
                      "cross join output")
        probe = (_with_pos(left, _PPOS) if jt in ("left", "full")
                 else left)
        build = _with_pos(right, _BPOS) if jt == "full" else right
        start, count, order = join_ops.cross_counts(probe, build)
        out = join_ops.expand_join(probe, build, start, count, order,
                                   capacity_for(max(total, 1)), "inner")
        if filt is not None:
            out = compact.filter_batch(out, eval_predicate(filt, out))
        return self._repair_outer(out, left, right, jt)

    def _repair_outer(self, out: Batch, left: Batch, right: Batch,
                      jt: str) -> Batch:
        """Strip the position lanes; null-extend outer rows whose matches
        all died in the filter."""
        live_out = out.row_valid()
        pp = out.column(_PPOS).data if jt in ("left", "full") else None
        bb = out.column(_BPOS).data if jt == "full" else None
        if pp is None and bb is None:
            return out
        out = Batch({s: c for s, c in out.columns.items()
                     if s not in (_PPOS, _BPOS)}, out.num_rows)
        if pp is not None:
            unmatched = left.row_valid() & ~_hit(pp, live_out,
                                                 left.capacity)
            out = device_concat([out, _null_extend(left, right,
                                                   unmatched)])
        if bb is not None:
            unmatched_b = right.row_valid() & ~_hit(bb, live_out,
                                                    right.capacity)
            out = device_concat([out, _null_extend_right(left, right,
                                                         unmatched_b)])
        return out

    def _append_right_unmatched(self, out: Batch, left: Batch,
                                right: Batch, pkeys, bkeys) -> Batch:
        """FULL JOIN tail (no residual filter): right rows with no key
        match, null-extended."""
        _, count, _ = join_ops.match_counts(right, left, bkeys, pkeys)
        unmatched = right.row_valid() & (count == 0)
        return device_concat([out, _null_extend_right(left, right,
                                                      unmatched)])

    # ------------------------------------------------------------------
    # semi-joins
    # ------------------------------------------------------------------
    def _exec_SemiJoinNode(self, node: SemiJoinNode) -> Batch:
        src = self.execute(node.source)
        filt = self.execute(node.filtering_source)
        matched, key_null, build_null, nonempty = join_ops.semi_join_mask(
            src, filt, [node.source_key], [node.filtering_key])
        # x IN (...): TRUE if matched; FALSE if the build side is empty;
        # NULL if the probe key is NULL or the build side holds a NULL
        valid = matched | ~nonempty | (~key_null & ~build_null)
        cols = dict(src.columns)
        cols[node.output] = Column(BOOLEAN, matched, valid)
        return Batch(cols, src.num_rows)

    def _exec_SemiJoinMultiNode(self, node: SemiJoinMultiNode) -> Batch:
        src = self.execute(node.source)
        filt = self.execute(node.filtering_source)
        skeys = list(node.source_keys)
        fkeys = list(node.filtering_keys)
        residual = (join_verify_filter(src.columns, filt.columns, skeys,
                                       fkeys, node.filter)
                    if skeys else node.filter)
        cols = dict(src.columns)
        if residual is None and skeys:
            matched, _, _, _ = join_ops.semi_join_mask(src, filt, skeys,
                                                       fkeys)
            cols[node.output] = Column(BOOLEAN, matched, None)
            return Batch(cols, src.num_rows)
        # residual filter: expand the candidate matches, filter, then
        # mark the probe rows with a surviving match
        probe = _with_pos(src, _PPOS)
        if skeys:
            start, count, order = join_ops.match_counts(probe, filt, skeys,
                                                        fkeys)
        else:
            start, count, order = join_ops.cross_counts(probe, filt)
        total = int(count.sum())
        self._reserve(total, len(probe.columns) + len(filt.columns),
                      "semi-join candidates")
        cand = join_ops.expand_join(probe, filt, start, count, order,
                                    capacity_for(total), "inner")
        live = cand.row_valid()
        if residual is not None:
            live = live & eval_predicate(residual, cand)
        cols[node.output] = Column(
            BOOLEAN, _hit(cand.column(_PPOS).data, live, src.capacity),
            None)
        return Batch(cols, src.num_rows)


def _with_pos(b: Batch, name: str) -> Batch:
    cols = dict(b.columns)
    cols[name] = Column(BIGINT, torch.arange(b.capacity, dtype=torch.int64,
                                             device=b.device))
    return Batch(cols, b.num_rows)


def _hit(pos: torch.Tensor, live: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] mask of the positions that some live row carries. Every
    write stores True (dead rows write to a spare slot), so duplicate
    positions cannot race."""
    out = torch.zeros(cap + 1, dtype=torch.bool, device=pos.device)
    idx = torch.where(live, pos.clamp(0, cap - 1), cap)
    return out.index_fill_(0, idx, True)[:cap]


def _null_columns(cols: Dict[str, Column], cap: int,
                  device: torch.device) -> Dict[str, Column]:
    """All-NULL columns of the given types, ``cap`` rows each."""
    def zeros(dtype):
        return torch.zeros(cap, dtype=dtype, device=device)
    return {s: Column(c.type, zeros(c.data.dtype), zeros(torch.bool),
                      c.dictionary,
                      None if c.data2 is None else zeros(torch.int64))
            for s, c in cols.items()}


def _null_extend(left: Batch, right: Batch, row_mask) -> Batch:
    """Rows of ``left`` where mask, with all-NULL right columns."""
    sub = compact.filter_batch(left, row_mask)
    cols = dict(sub.columns)
    cols.update(_null_columns(right.columns, sub.capacity, sub.device))
    return Batch(cols, sub.num_rows)


def _null_extend_right(left: Batch, right: Batch, row_mask) -> Batch:
    """Rows of ``right`` where mask, with all-NULL left columns."""
    sub = compact.filter_batch(right, row_mask)
    cols = _null_columns(left.columns, sub.capacity, sub.device)
    cols.update(sub.columns)
    return Batch(cols, sub.num_rows)


def _sort_keys(keys) -> List[sort_ops.SortKey]:
    return [sort_ops.SortKey(k.symbol, k.ascending, k.nulls_first)
            for k in keys]


def _aggregate(node: AggregationNode, src: Batch,
               live: Optional[torch.Tensor]) -> Batch:
    """Lower the logical aggregates, aggregate (grouped or global), then
    apply the post functions (avg = sum / count, variance, ...)."""
    phys, post, extra = _lower_aggregates(node.aggregates, src)
    if extra:
        src = Batch({**src.columns, **extra}, src.num_rows)
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


def _lower_aggregates(aggregates: Dict[str, Aggregate], src: Batch):
    """Map logical aggregates onto the kinds ops/groupby.py computes
    (sum/count/count_star/min/max/any_value/count_distinct), returning
    (phys_aggs, post_fns, extra_columns). The decomposition mirrors the
    reference's accumulator states: avg = LongAndDoubleState, variance =
    CentralMomentsState."""
    phys: List[AggInput] = []
    post = {}
    extra: Dict[str, Column] = {}
    for sym, a in aggregates.items():
        kind = a.kind
        if kind == "count" and a.distinct or kind == "approx_distinct":
            # exact, as the JAX engine computes approx_distinct
            phys.append(AggInput("count_distinct", a.argument, a.mask,
                                 sym))
        elif a.distinct:
            raise NotImplementedError(f"not yet ported: {kind}(DISTINCT)")
        elif kind in ("sum", "min", "max", "count", "count_star"):
            phys.append(AggInput(kind, a.argument, a.mask, sym))
        elif kind in ("any_value", "arbitrary"):
            phys.append(AggInput("any_value", a.argument, a.mask, sym))
        elif kind == "avg":
            ssym, csym = sym + "$sum", sym + "$cnt"
            phys.append(AggInput("sum", a.argument, a.mask, ssym))
            phys.append(AggInput("count", a.argument, a.mask, csym))
            post[sym] = _avg_post(ssym, csym, a.type)
        elif kind == "count_if":
            msym = sym + "$mask"
            m = _true(src.column(a.argument))
            if a.mask is not None:
                m = m & _true(src.column(a.mask))
            extra[msym] = Column(BOOLEAN, m, None)
            phys.append(AggInput("count_star", None, msym, sym))
        elif kind in ("bool_and", "every", "bool_or"):
            op = "min" if kind in ("bool_and", "every") else "max"
            phys.append(AggInput(op, a.argument, a.mask, sym))
        elif kind in ("stddev", "stddev_samp", "stddev_pop", "variance",
                      "var_samp", "var_pop"):
            bsym, d, bvalid = _stat_lane(src, a.argument, extra, sym + "$f")
            sqsym = sym + "$sq"
            extra[sqsym] = Column(DOUBLE, d * d, bvalid)
            ssym, csym, s2sym = sym + "$s", sym + "$c", sym + "$s2"
            phys.append(AggInput("sum", bsym, a.mask, ssym))
            phys.append(AggInput("count", bsym, a.mask, csym))
            phys.append(AggInput("sum", sqsym, a.mask, s2sym))
            post[sym] = _variance_post(ssym, csym, s2sym,
                                       kind.endswith("_pop"),
                                       kind.startswith("stddev"))
        elif kind == "geometric_mean":
            lsym = sym + "$ln"
            _, d, bvalid = _stat_lane(src, a.argument, extra, sym + "$f")
            extra[lsym] = Column(DOUBLE, torch.log(d), bvalid)
            ssym, csym = sym + "$s", sym + "$c"
            phys.append(AggInput("sum", lsym, a.mask, ssym))
            phys.append(AggInput("count", lsym, a.mask, csym))
            post[sym] = _geomean_post(ssym, csym)
        else:
            raise NotImplementedError(f"not yet ported: aggregate {kind}")
    return phys, post, extra


def _true(c: Column) -> torch.Tensor:
    m = c.data.to(torch.bool)
    return m if c.valid is None else m & c.valid


def _stat_lane(src: Batch, name: str, extra: Dict[str, Column], tag: str):
    """(symbol, f64 lane, validity) of a numeric input of the statistical
    aggregates; a short decimal is unscaled into a new f64 lane."""
    col = src.column(name)
    d = col.data.to(torch.float64)
    if isinstance(col.type, DecimalType):
        if col.data2 is not None:
            raise NotImplementedError(
                f"not yet ported: statistical aggregates over {col.type}")
        d = d / torch.full((), 10.0 ** col.type.scale,
                           dtype=torch.float64, device=d.device)
        extra[tag] = Column(DOUBLE, d, col.valid)
        return tag, d, col.valid
    return name, d, col.valid


def _f64(out: Batch, sym: str) -> torch.Tensor:
    return out.column(sym).data.to(torch.float64)


def _variance_post(ssym, csym, s2sym, pop: bool, sqrt: bool):
    def fn(out: Batch) -> Column:
        s, n, s2 = _f64(out, ssym), _f64(out, csym), _f64(out, s2sym)
        m2 = s2 - s * s / torch.clamp(n, min=1.0)
        v = torch.clamp(m2 / torch.clamp(n if pop else n - 1.0, min=1.0),
                        min=0.0)
        return Column(DOUBLE, torch.sqrt(v) if sqrt else v,
                      n > (0.0 if pop else 1.0))
    return fn


def _geomean_post(ssym, csym):
    def fn(out: Batch) -> Column:
        s, n = _f64(out, ssym), _f64(out, csym)
        return Column(DOUBLE, torch.exp(s / torch.clamp(n, min=1.0)),
                      n > 0)
    return fn


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
    dictionaries, into the capacity bucket of the total. When a part was
    spilled to host memory and the total is over ``max_batch_rows``, the
    merge stays in host memory (the result is spilled, pinned when its
    parts are); a spilled part of a smaller merge moves to the device of
    the others first."""
    counts = [p.num_rows_host() for p in parts]
    total = sum(counts)
    spilled = pin = False
    if any(p.spilled for p in parts):
        on_device = [p.device for p in parts if not p.spilled]
        if total > CONFIG.max_batch_rows or not on_device:
            parts = [p if p.spilled else _to_host(p, n)
                     for p, n in zip(parts, counts)]
            spilled = True
            pin = any(next(iter(p.columns.values())).data.is_pinned()
                      for p in parts)
        else:
            parts = [p.to(on_device[0]) if p.spilled else p for p in parts]
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
                               for c, n in zip(cs, counts)], cap, pin)
        data2 = None
        if any(c.data2 is not None for c in cs):
            if not all(c.data2 is not None for c in cs):
                raise NotImplementedError(
                    "not yet ported: concat of mixed high lanes")
            data2 = _cat_into([c.data2[:n] for c, n in zip(cs, counts)],
                              cap, pin)
        cols[name] = Column(first.type, _cat_into(datas, cap, pin), valid,
                            dic, data2)
    return Batch(cols, total, spilled=spilled)


def _cat_into(pieces: Sequence[torch.Tensor], cap: int,
              pin: bool = False) -> torch.Tensor:
    """Pieces copied one after another into a zeroed lane of ``cap``
    rows (one allocation, however many pieces)."""
    out = torch.zeros(cap, dtype=pieces[0].dtype, device=pieces[0].device,
                      pin_memory=pin)
    off = 0
    for p in pieces:
        out[off:off + p.shape[0]].copy_(p)
        off += p.shape[0]
    return out


# ---- host spill -----------------------------------------------------------

def _to_host(b: Batch, n: int) -> Batch:
    """The live prefix of ``b`` copied to host memory (the spill write),
    into pinned tensors when it comes from a card so that the way back is
    an asynchronous copy."""
    pin = b.device.type == "cuda"

    def host(t):
        if t is None:
            return None
        out = torch.empty(n, dtype=t.dtype, pin_memory=pin)
        return out.copy_(t[:n])
    cols = {s: Column(c.type, host(c.data), host(c.valid), c.dictionary,
                      host(c.data2))
            for s, c in b.columns.items()}
    return Batch(cols, n, spilled=True)
