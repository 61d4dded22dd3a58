"""Stage-DAG fragmenter: cut an optimized plan at exchange points.

Counterpart of ``trino_tpu/stage/fragmenter.py`` (host code).

Reference parity: sql/planner/PlanFragmenter.java over an
AddExchanges-annotated plan — SURVEY L5: SqlQueryScheduler builds a
SqlStageExecution per fragment, fragments meet at
PartitionedOutput/RemoteSource pairs. Here the fragmenter performs
both jobs in one recursive walk: it decides WHERE the exchanges go
(partitioning requirements of each heavy operator) and cuts there.

Stage shapes produced (one "heavy" operator per worker stage plus its
row-local shell):

- **leaf**: a remotable scan chain (scan | filter | project | unnest,
  or a union of such chains), executed over (part, nparts) split
  shares — optionally with a PARTIAL aggregation fused above it;
- **join**: a JoinNode over two RemoteSources co-partitioned on the
  equi-clause keys (hash-partitioned join — both sides repartition by
  their key columns, equal values colocate);
- **aggregation**: FINAL (combinable kinds, avg split into sum+count)
  or SINGLE (holistic kinds and grouping sets — the rows themselves
  repartition by the group keys, including the grouping-set id, so
  every group is complete per task);
- **window**: partition_by-keyed repartition, window per task;
- **semi join**: the filtering source becomes a REPLICATE stage — every
  consumer task reads the WHOLE filtering relation, so SQL's NULL-IN
  semantics (a non-matching probe row's verdict depends on whether the
  filtering side contains a NULL *anywhere*) hold per task; this is
  the replicate-nulls-and-any partitioning collapsed to full
  replication. The probe side stays INLINE (colocated with its scan
  chain) — no probe-side exchange hop;
- **cross / replicated join**: joins without equi-criteria replicate
  the right side; equi-joins the optimizer marked REPLICATED
  (broadcast distribution) do the same, keeping the probe-side scan
  chain inline in the join stage — an exchange hop deleted outright;
- **values**: a single-task stage (inlining VALUES into a split-shared
  stage would duplicate its rows once per task).

Anything else raises ``_Fallback`` and ``fragment`` returns None — the
caller falls back to the flat leaf-fragment path (exec/remote.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Tuple

from ..plan.nodes import (Aggregate, AggregationNode,
                          EnforceSingleRowNode, FilterNode, GroupIdNode,
                          JoinNode, LimitNode, OffsetNode, OutputNode,
                          PartitionedOutputNode, PlanNode, ProjectNode,
                          RemoteSourceNode, SemiJoinNode, SortNode,
                          TableScanNode, TopNNode, UnionNode, UnnestNode,
                          ValuesNode, WindowNode)
from ..planner.logical import SemiJoinMultiNode
from ..rex import Call, InputRef
from ..types import BIGINT, DecimalType

# aggregate kinds a PARTIAL/FINAL split supports host-side, mapping to
# the FINAL combine kind (reference: AggregationNode PARTIAL->FINAL +
# InternalAggregationFunction combine; avg splits into sum+count).
# Shared with the flat fragmenter in exec/remote.py — one table, two
# consumers, zero drift.
COMBINABLE_AGGS = {"sum": "sum", "count": "sum", "count_star": "sum",
                   "min": "min", "max": "max", "any_value": "any_value",
                   "bool_and": "bool_and", "bool_or": "bool_or",
                   "every": "bool_and"}


def splittable_aggregates(node: AggregationNode) -> bool:
    """True when every aggregate of ``node`` combines through a
    PARTIAL/FINAL split (distinct never does; avg splits into
    sum+count)."""
    for a in node.aggregates.values():
        if a.distinct:
            return False
        if a.kind == "avg":
            continue
        if a.kind not in COMBINABLE_AGGS:
            return False
    return True


def split_aggregates(aggregates: Dict[str, Aggregate], src_schema
                     ) -> Tuple[Dict[str, Aggregate],
                                Dict[str, Aggregate],
                                Dict[str, Tuple[str, str]]]:
    """(partial, final, avg_posts) for a PARTIAL/FINAL aggregation
    split (PushPartialAggregationThroughExchange, host leg). ``posts``
    maps each avg output symbol to its (sum, count) partial symbols —
    the consumer reconstructs avg as sum/count AFTER the final
    combine."""
    from ..functions import aggregate_result_type
    partial: Dict[str, Aggregate] = {}
    final: Dict[str, Aggregate] = {}
    posts: Dict[str, Tuple[str, str]] = {}
    for sym, a in aggregates.items():
        if a.kind == "avg":
            ssym, csym = sym + "$rsum", sym + "$rcnt"
            sum_t = aggregate_result_type("sum",
                                          [src_schema[a.argument]])
            partial[ssym] = Aggregate("sum", a.argument, sum_t,
                                      mask=a.mask)
            partial[csym] = Aggregate("count", a.argument, BIGINT,
                                      mask=a.mask)
            final[ssym] = Aggregate("sum", ssym, sum_t)
            final[csym] = Aggregate("sum", csym, BIGINT)
            posts[sym] = (ssym, csym)
        else:
            partial[sym] = a
            final[sym] = Aggregate(COMBINABLE_AGGS[a.kind], sym, a.type)
    return partial, final, posts


def build_final_aggregation(pre: PlanNode, node: AggregationNode,
                            finals: Dict[str, Aggregate],
                            posts: Dict[str, Tuple[str, str]]
                            ) -> PlanNode:
    """FINAL combine over gathered/exchanged partials + the avg
    reconstruction projection (decimal division stays on the exact
    Int128 kernel via the planner's "decimal_/" op naming)."""
    out: PlanNode = AggregationNode(pre, node.group_keys, finals,
                                    step="SINGLE")
    if posts:
        assigns = {}
        schema = out.output_schema()
        for s in node.output_schema():
            if s in posts:
                ssym, csym = posts[s]
                a = node.aggregates[s]
                num = InputRef(ssym, schema[ssym])
                den = InputRef(csym, schema[csym])
                op = ("decimal_/" if isinstance(a.type, DecimalType)
                      else "/")
                assigns[s] = Call(op, (num, den), a.type)
            else:
                assigns[s] = InputRef(s, schema[s])
        out = ProjectNode(out, assigns)
    return out


class _Fallback(Exception):
    """This plan shape stays on the flat leaf-fragment path."""


@dataclass
class Stage:
    """One worker stage: N tasks each executing ``plan`` (rooted in a
    PartitionedOutputNode) over either a split share (leaf) or its own
    partition of every ``inputs`` stage's output."""
    sid: int
    plan: PlanNode
    inputs: Tuple[int, ...] = ()
    consumer: Optional[int] = None      # None == consumed by the root
    max_tasks: Optional[int] = None     # 1 for global-FINAL / VALUES

    @property
    def output_node(self) -> PartitionedOutputNode:
        return self.plan  # the fragmenter roots every stage plan here


@dataclass
class StageDAG:
    """Worker stages in topological order (producers first) + the
    coordinator's root plan whose leaves are RemoteSourceNodes."""
    stages: List[Stage]
    root_plan: PlanNode

    def stage(self, sid: int) -> Stage:
        return self.stages[sid]

    def lines(self) -> List[str]:
        """Text rendering for EXPLAIN (the textDistributedPlan analog):
        one block per stage, root last."""
        from ..plan.nodes import plan_tree_lines
        out: List[str] = []
        for st in self.stages:
            po = st.output_node
            head = (f"Stage {st.sid} [output: {po.kind}"
                    + (f" by {list(po.partition_keys)}"
                       if po.partition_keys else "")
                    + (f" <- stages {list(st.inputs)}" if st.inputs
                       else " <- table splits")
                    + (", single task" if st.max_tasks == 1 else "")
                    + "]")
            out.append(head)
            out.extend("   " + l for l in plan_tree_lines(po.source))
        out.append("Stage root [coordinator]")
        out.extend("   " + l for l in plan_tree_lines(self.root_plan))
        return out


class _Ctx:
    """Per-stage build context: upstream stages referenced by the body
    under construction, and a task-count cap the body imposes."""

    __slots__ = ("inputs", "max_tasks")

    def __init__(self):
        self.inputs: List[int] = []
        self.max_tasks: Optional[int] = None


# nodes the coordinator keeps for itself above the top-most exchange:
# inherently-gathered operations (global order, final limit, client
# output) — everything heavy below them runs on workers
_SHELL = (OutputNode, SortNode, TopNNode, LimitNode, OffsetNode,
          EnforceSingleRowNode)


class StageFragmenter:
    """Cuts an optimized plan into a StageDAG, or declines (None)."""

    def __init__(self, catalogs, session=None):
        self.catalogs = catalogs
        self.session = session
        self.stages: List[Stage] = []

    # -- entry ---------------------------------------------------------
    def fragment(self, plan: PlanNode) -> Optional[StageDAG]:
        self.stages = []
        try:
            shell: List[PlanNode] = []
            node = plan
            while True:
                if isinstance(node, _SHELL):
                    shell.append(node)
                    node = node.source
                    continue
                # a row-local wrapper directly above another shell node
                # (Project between Output and Sort) rides with the
                # coordinator; one directly above the core is pushed
                # into the core's stage by _build_body instead
                if isinstance(node, (ProjectNode, FilterNode)) \
                        and isinstance(node.source, _SHELL):
                    shell.append(node)
                    node = node.source
                    continue
                break
            sid = self._stage(node, "gather", ())
            if len(self.stages) < 2:
                # a lone leaf stage: the flat path already handles it,
                # streaming pages instead of spooling an exchange
                return None
            out: PlanNode = RemoteSourceNode(
                (sid,), self.stages[sid].plan.output_schema(), "gather")
            for n in reversed(shell):
                out = dc_replace(n, source=out)
            return StageDAG(self.stages, out)
        except (_Fallback, KeyError):
            return None

    # -- stage construction -------------------------------------------
    def _stage(self, node: PlanNode, out_kind: str,
               out_keys: Tuple[str, ...], post=None) -> int:
        ctx = _Ctx()
        body = self._build_body(node, ctx)
        if post is not None:
            body = post(body)
        schema = body.output_schema()
        missing = [k for k in out_keys if k not in schema]
        if missing:
            raise _Fallback(f"partition keys {missing} not produced")
        sid = len(self.stages)
        stage = Stage(sid, PartitionedOutputNode(body, tuple(out_keys),
                                                 out_kind),
                      tuple(ctx.inputs), None, ctx.max_tasks)
        for i in ctx.inputs:
            self.stages[i].consumer = sid
        self.stages.append(stage)
        return sid

    # -- distribution predicates --------------------------------------
    def _remotable_scan(self, scan: TableScanNode) -> bool:
        """Only pure-generator scans may execute on a remote worker
        (coordinator-state-backed catalogs — system.runtime, memory
        tables — must read THIS process; reference:
        SystemPartitioningHandle.COORDINATOR_ONLY)."""
        try:
            conn = self.catalogs.connector(scan.handle.catalog)
        except Exception:       # noqa: BLE001
            return False
        return bool(getattr(conn, "remote_scan_ok",
                            getattr(conn, "scan_cache_ok", False)))

    def _scan_subtree(self, node: PlanNode) -> bool:
        """Source-distributed subtree: executable per split share with
        the shares unioning to the full output (scan chains and unions
        of scan chains; every row-local node in between is fine —
        GroupIdNode replicates rows split-locally, so the shares still
        union to the full grouping-set expansion)."""
        if isinstance(node, TableScanNode):
            return self._remotable_scan(node)
        if isinstance(node, (FilterNode, ProjectNode, UnnestNode,
                             GroupIdNode)):
            return self._scan_subtree(node.source)
        if isinstance(node, UnionNode):
            return all(self._scan_subtree(c) for c in node.children)
        return False

    @staticmethod
    def _values_subtree(node: PlanNode) -> bool:
        while isinstance(node, (FilterNode, ProjectNode)):
            node = node.source
        return isinstance(node, ValuesNode)

    # -- body builder --------------------------------------------------
    def _build_body(self, node: PlanNode, ctx: _Ctx) -> PlanNode:
        """Rewrite ``node`` to execute inside ONE stage's tasks:
        source-distributed subtrees stay inline (split shares), heavy
        operators get RemoteSource inputs backed by freshly cut
        upstream stages with the partitioning the operator needs."""
        if self._scan_subtree(node):
            return node
        if self._values_subtree(node):
            # VALUES emits its rows once per executing task — legal
            # only in a single-task stage
            ctx.max_tasks = 1
            return node
        if isinstance(node, (FilterNode, ProjectNode, UnnestNode,
                             GroupIdNode)):
            return dc_replace(node,
                              source=self._build_body(node.source, ctx))
        if isinstance(node, JoinNode):
            return self._join_body(node, ctx)
        if isinstance(node, (SemiJoinNode, SemiJoinMultiNode)):
            return self._semi_join_body(node, ctx)
        if isinstance(node, AggregationNode):
            return self._aggregation_body(node, ctx)
        if isinstance(node, WindowNode) and node.partition_by:
            sid = self._stage(node.source, "hash",
                              tuple(node.partition_by))
            ctx.inputs.append(sid)
            return dc_replace(node, source=RemoteSourceNode(
                (sid,), node.source.output_schema()))
        raise _Fallback(type(node).__name__)

    def _replicate_input(self, node: PlanNode,
                         ctx: _Ctx) -> RemoteSourceNode:
        """Cut ``node`` into a REPLICATE stage: every task of the
        consuming stage reads its whole output (the reference's
        REPLICATE exchange / BroadcastOutputBuffer)."""
        sid = self._stage(node, "replicate", ())
        ctx.inputs.append(sid)
        return RemoteSourceNode((sid,), node.output_schema(),
                                "replicate")

    def _semi_join_body(self, node, ctx: _Ctx) -> PlanNode:
        """Semi join: the filtering source replicates WHOLE to every
        task, so each task sees any filtering-side NULL anywhere and
        NULL-IN semantics hold per task (the replicate-nulls-and-any
        partitioning, collapsed to full replication). The probe side
        stays inline — colocated with its scan chain, no probe
        exchange hop."""
        filt = self._replicate_input(node.filtering_source, ctx)
        src = self._build_body(node.source, ctx)
        return dc_replace(node, source=src, filtering_source=filt)

    def _join_body(self, node: JoinNode, ctx: _Ctx) -> PlanNode:
        if not node.criteria:
            # cross / filter-only join: replicate the build (right)
            # side, keep the probe inline. Sound only when each task
            # owns its probe rows exclusively — inner/cross always,
            # LEFT because unmatched-probe preservation is probe-local;
            # right/full would preserve the REPLICATED side once per
            # task (duplicates), so they stay on the fallback path.
            if node.join_type not in ("inner", "cross", "left"):
                raise _Fallback(
                    f"{node.join_type} join without equi-criteria")
            right = self._replicate_input(node.right, ctx)
            left = self._build_body(node.left, ctx)
            return dc_replace(node, left=left, right=right)
        if (str(node.distribution or "").lower() == "replicated"
                and node.join_type in ("inner", "left")):
            # REPLICATED (broadcast) distribution, chosen by the
            # optimizer's size heuristic: the build side replicates to
            # every task and the probe-side scan chain stays INLINE in
            # this stage — the probe-side exchange hop is deleted
            # outright (reference: AddExchanges' REPLICATED branch
            # keeps the probe source-distributed)
            right = self._replicate_input(node.right, ctx)
            left = self._build_body(node.left, ctx)
            return dc_replace(node, left=left, right=right)
        lkeys = tuple(c.left for c in node.criteria)
        rkeys = tuple(c.right for c in node.criteria)
        # co-partitioned hash join: both sides repartition on their
        # clause keys with the same bucket function and the same
        # downstream task count, so equal key values meet in the same
        # task (NULL keys hash to 0 on both sides: never match, and
        # outer-row preservation happens exactly once, on partition 0)
        lsid = self._stage(node.left, "hash", lkeys)
        rsid = self._stage(node.right, "hash", rkeys)
        ctx.inputs.extend((lsid, rsid))
        return dc_replace(
            node,
            left=RemoteSourceNode((lsid,),
                                  node.left.output_schema()),
            right=RemoteSourceNode((rsid,),
                                   node.right.output_schema()))

    def _aggregation_body(self, node: AggregationNode,
                          ctx: _Ctx) -> PlanNode:
        if node.step != "SINGLE":
            raise _Fallback("non-SINGLE aggregation")
        # grouping sets distribute like holistic kinds: the group keys
        # include the grouping-set id (planner/logical.py appends it),
        # and GroupIdNode's expansion runs split-locally below, so a
        # hash repartition on the full key tuple colocates every
        # (key values, set id) group — NULLed key lanes of subtotal
        # copies hash identically on every worker (NULL -> 0)
        combinable = (splittable_aggregates(node)
                      and node.group_id_symbol is None)
        gk = tuple(node.group_keys)
        if gk and combinable:
            # PARTIAL fused into the producer stage (above its join /
            # scan), hash exchange on the group keys, FINAL here
            partials, finals, posts = split_aggregates(
                node.aggregates, node.source.output_schema())
            psid = self._stage(
                node.source, "hash", gk,
                post=lambda p, k=gk, ag=partials: AggregationNode(
                    p, k, ag, step="SINGLE"))
            ctx.inputs.append(psid)
            pre = RemoteSourceNode(
                (psid,), self.stages[psid].plan.output_schema())
            return build_final_aggregation(pre, node, finals, posts)
        if gk:
            # holistic kinds (distinct, approx_*, min_by...): the ROWS
            # repartition by group key, every group is complete in one
            # task, the aggregation runs unsplit
            psid = self._stage(node.source, "hash", gk)
            ctx.inputs.append(psid)
            return dc_replace(node, source=RemoteSourceNode(
                (psid,), node.source.output_schema()))
        if not combinable:
            raise _Fallback("global holistic aggregation")
        # global combinable: per-task PARTIALs gather into ONE final
        # task (still a worker — the coordinator only streams the root)
        partials, finals, posts = split_aggregates(
            node.aggregates, node.source.output_schema())
        psid = self._stage(
            node.source, "gather", (),
            post=lambda p, ag=partials: AggregationNode(
                p, (), ag, step="SINGLE"))
        ctx.inputs.append(psid)
        ctx.max_tasks = 1
        pre = RemoteSourceNode(
            (psid,), self.stages[psid].plan.output_schema())
        return build_final_aggregation(pre, node, finals, posts)
