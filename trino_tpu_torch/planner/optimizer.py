"""Logical-plan optimizer passes.

Reference parity: sql/planner/optimizations/PredicatePushDown.java +
the Prune*Columns iterative-rule family (~45 rules, SURVEY.md Appendix
A.2) + InlineProjections/MergeFilters. Implemented as whole-tree rewrites
rather than a memo/rule engine — the rule set that matters for the TPU
engine is small and the passes run once per query.

Passes (in order, PlanOptimizers.java:240 analog):
1. push_filters   — move WHERE conjuncts down; extract equi conjuncts
                    into JoinNode criteria (turns the comma-join cross
                    products of TPC-H q2/q3/q5… into hash joins).
2. prune_columns  — project away unreferenced symbols all the way into
                    TableScan assignments (generator reads less).
3. cleanup_projects — drop identity projections.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Set, Tuple

from .. import rex
from ..plan.nodes import (AggregationNode, AssignUniqueIdNode,
                          EnforceSingleRowNode, ExchangeNode, FilterNode,
                          JoinClause, JoinNode, LimitNode,
                          MarkDistinctNode, OffsetNode, OutputNode,
                          PlanNode, ProjectNode, SampleNode, SemiJoinNode,
                          SetOpNode, SortNode, TableScanNode, TopNNode,
                          UnionNode, UnnestNode, ValuesNode, WindowNode)
from ..matching import Pattern as _Pat
from ..planner.logical import SemiJoinMultiNode
from ..rex import Call, Const, InputRef, RowExpr, TRUE


def _pass_checker(session):
    """The per-pass sanity checker when the session enables debug
    validation (analysis/sanity.py; reference: the PlanSanityChecker
    battery the IterativeOptimizer runs between rules under
    assertions). Returns None when off — the common case pays one dict
    lookup, no import."""
    if session is None:
        return None
    try:
        enabled = bool(session.get("plan_validation"))
    except KeyError:        # foreign session objects without the knob
        return None
    if not enabled:
        return None
    from ..analysis.sanity import PlanSanityChecker
    return PlanSanityChecker()


def optimize(plan: PlanNode, catalogs=None, session=None) -> PlanNode:
    checker = _pass_checker(session)

    def ck(p: PlanNode, pass_name: str) -> PlanNode:
        # validated AFTER the named pass so a violation is pinned on
        # the rewrite that introduced it, not discovered at execution
        if checker is not None:
            checker.validate(p, pass_name)
        return p

    plan = ck(plan, "logical-planner")
    plan = ck(unwrap_casts(plan), "unwrap_casts")
    plan = ck(push_filters(plan), "push_filters")
    plan = ck(single_distinct_to_groupby(plan),
              "single_distinct_to_groupby")
    if catalogs is not None:
        from .stats import choose_join_sides, reorder_joins
        force = "AUTOMATIC"
        reorder = "AUTOMATIC"
        pushdown = True
        use_stats = True
        if session is not None:
            force = session.get("join_distribution_type") or "AUTOMATIC"
            reorder = (session.get("join_reordering_strategy")
                       or "AUTOMATIC")
            pushdown = bool(session.get("pushdown_into_scan"))
            use_stats = bool(session.get("use_table_statistics"))
        if not use_stats:
            # optimizer.use-table-statistics=false: keep syntactic join
            # order and runtime-heuristic distributions
            reorder = "NONE"
        if str(reorder).upper() != "NONE":
            plan = ck(reorder_joins(plan, catalogs), "reorder_joins")
        if use_stats or str(force).upper() != "AUTOMATIC":
            plan = ck(choose_join_sides(plan, catalogs, force),
                      "choose_join_sides")
        if pushdown:
            plan = ck(push_into_scan(plan, catalogs), "push_into_scan")
    plan = ck(partial_topn_through_union(plan),
              "partial_topn_through_union")
    plan = ck(prune_columns(plan), "prune_columns")
    plan = ck(cleanup_projects(plan), "cleanup_projects")
    return plan


# --------------------------------------------------------------------------
# connector pushdown (PushPredicateIntoTableScan / PushLimitIntoTableScan)
# --------------------------------------------------------------------------

def _domain_pushable(t) -> bool:
    """Types whose plan-constant values compare 1:1 against the
    connector's host lanes (predicate.filter_batch_host): integrals,
    date, bool, float, dictionary strings. DECIMAL consts are strings
    at plan time — skip."""
    from ..types import DecimalType, is_string
    if isinstance(t, DecimalType):
        return False
    return t.name in ("tinyint", "smallint", "integer", "bigint",
                      "real", "double", "date", "boolean") \
        or is_string(t)


def push_into_scan(node: PlanNode, catalogs) -> PlanNode:
    """Offer filter domains and limits to connectors
    (sql/planner/iterative/rule/PushPredicateIntoTableScan.java,
    PushLimitIntoTableScan.java). Accepted domains are baked into the
    TableHandle; fully-enforced conjuncts leave the plan."""
    from ..predicate import TupleDomain, extract_tuple_domain

    if isinstance(node, FilterNode) and \
            isinstance(node.source, TableScanNode):
        scan = node.source
        ok_syms = {sym: scan.schema[sym]
                   for sym in scan.assignments
                   if _domain_pushable(scan.schema[sym])}
        td_sym, residual = extract_tuple_domain(node.predicate, ok_syms)
        if not td_sym.is_all():
            td_conn = TupleDomain(
                tuple((scan.assignments[sym], dom)
                      for sym, dom in td_sym.domains), td_sym.is_none)
            conn = catalogs.connector(scan.handle.catalog)
            got = conn.apply_filter(scan.handle, td_conn)
            if got is not None:
                new_handle, fully = got
                new_scan = dc_replace(scan, handle=new_handle)
                if fully and not residual:
                    return new_scan
                pred = rex.and_all(residual) if fully else node.predicate
                return FilterNode(new_scan, pred)
        return node

    if isinstance(node, LimitNode):
        # limit commutes with row-preserving projections
        # (PushLimitThroughProject + PushLimitIntoTableScan)
        below = node.source
        projs = []
        while isinstance(below, ProjectNode):
            projs.append(below)
            below = below.source
        if isinstance(below, TableScanNode):
            conn = catalogs.connector(below.handle.catalog)
            got = conn.apply_limit(below.handle, node.count)
            if got is not None:
                rebuilt: PlanNode = dc_replace(below, handle=got)
                for p in reversed(projs):
                    rebuilt = dc_replace(p, source=rebuilt)
                return dc_replace(node, source=rebuilt)
        return _replace_sources(
            node, [push_into_scan(node.source, catalogs)])

    srcs = getattr(node, "sources", ())
    if not srcs:
        return node
    new_srcs = [push_into_scan(s, catalogs) for s in srcs]
    if all(a is b for a, b in zip(new_srcs, srcs)):
        return node
    return _replace_sources(node, new_srcs)


def _replace_sources(node: PlanNode, new_sources) -> PlanNode:
    """Rebuild a node with new child nodes, mapping them back onto the
    dataclass fields in ``sources`` order."""
    import dataclasses
    it = iter(new_sources)
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, PlanNode):
            changes[f.name] = next(it)
        elif isinstance(v, tuple) and v and \
                all(isinstance(x, PlanNode) for x in v):
            changes[f.name] = tuple(next(it) for _ in v)
    return dc_replace(node, **changes)


# --------------------------------------------------------------------------
# predicate pushdown
# --------------------------------------------------------------------------

def push_filters(node: PlanNode) -> PlanNode:
    return _push(node, [])


def extract_common_disjunct_conjuncts(e: RowExpr) -> List[RowExpr]:
    """(A and X) or (A and Y) -> [A, (X or Y)] — the
    ExtractCommonPredicates rewriter (sql/planner/iterative/rule/
    ExtractCommonPredicatesExpressionRewriter.java). Essential for
    TPC-H q19, whose equi-join condition lives inside every disjunct."""
    if not (isinstance(e, Call) and e.fn == "or"):
        return [e]
    disjuncts: List[RowExpr] = []

    def flatten_or(x):
        if isinstance(x, Call) and x.fn == "or":
            flatten_or(x.args[0])
            flatten_or(x.args[1])
        else:
            disjuncts.append(x)

    flatten_or(e)
    conj_sets = [rex.split_conjuncts(d) for d in disjuncts]
    common = [c for c in conj_sets[0]
              if all(c in s for s in conj_sets[1:])]
    if not common:
        return [e]
    rests = [rex.and_all([c for c in s if c not in common])
             for s in conj_sets]
    return common + [rex.or_all(rests)]


def _split_normalized(e: RowExpr) -> List[RowExpr]:
    out: List[RowExpr] = []
    for c in rex.split_conjuncts(e):
        out.extend(extract_common_disjunct_conjuncts(c))
    return out


def _push(node: PlanNode, conjuncts: List[RowExpr]) -> PlanNode:
    if isinstance(node, FilterNode):
        return _push(node.source,
                     conjuncts + _split_normalized(node.predicate))

    if isinstance(node, ProjectNode):
        # inline through the projection when conjuncts only reference
        # pass-through or cheap assignments (InlineProjections analog)
        inlineable, keep = [], []
        for c in conjuncts:
            refs = rex.input_names(c)
            if all(r in node.assignments for r in refs):
                inlineable.append(
                    rex.replace_inputs(c, dict(node.assignments)))
            else:
                keep.append(c)
        src = _push(node.source, inlineable)
        out: PlanNode = dc_replace(node, source=src)
        return _wrap(out, keep)

    if isinstance(node, JoinNode):
        return _push_join(node, conjuncts)

    if isinstance(node, (SemiJoinNode, SemiJoinMultiNode)):
        # conjuncts not referencing the mark column push to the source
        mark = node.output
        down, keep = [], []
        for c in conjuncts:
            (keep if mark in rex.input_names(c) else down).append(c)
        src = _push(node.sources[0], down)
        filt = _push(node.sources[1], [])
        if isinstance(node, SemiJoinNode):
            out = dc_replace(node, source=src, filtering_source=filt)
        else:
            out = dc_replace(node, source=src, filtering_source=filt)
        return _wrap(out, keep)

    if isinstance(node, AggregationNode):
        # conjuncts over group keys push below (PushPredicateThroughAgg)
        keys = set(node.group_keys)
        down, keep = [], []
        for c in conjuncts:
            (down if rex.input_names(c) <= keys else keep).append(c)
        src = _push(node.source, down)
        return _wrap(dc_replace(node, source=src), keep)

    if isinstance(node, WindowNode):
        # DETERMINISTIC conjuncts over the PARTITION BY keys push below
        # the window: dropping whole partitions cannot change surviving
        # rows' window values. A volatile conjunct (random() < x) would
        # thin partitions instead of dropping them whole.
        # (iterative/rule/PushdownFilterIntoWindow.java /
        # PushdownFilterIntoRowNumber.java)
        pkeys = set(node.partition_by)

        def pushable(c):
            return (rex.input_names(c) <= pkeys
                    and not rex.expr_volatile(c))
        down = [c for c in conjuncts if pushable(c)]
        keep = [c for c in conjuncts if not pushable(c)]
        src = _push(node.source, down)
        return _wrap(dc_replace(node, source=src), keep)

    if isinstance(node, (SortNode, MarkDistinctNode, AssignUniqueIdNode,
                         SampleNode, EnforceSingleRowNode,
                         ExchangeNode)):
        src = _push(node.sources[0], conjuncts
                    if not isinstance(node, (EnforceSingleRowNode,
                                             SampleNode))
                    else [])
        rest = (conjuncts if isinstance(node, (EnforceSingleRowNode,
                                               SampleNode))
                else [])
        return _wrap(dc_replace(node, source=src), rest)

    if isinstance(node, (LimitNode, OffsetNode, TopNNode)):
        # cannot push through limits
        src = _push(node.sources[0], [])
        return _wrap(dc_replace(node, source=src), conjuncts)

    if isinstance(node, UnionNode):
        children = []
        for child, smap in zip(node.children, node.symbol_maps):
            mapped = [rex.replace_inputs(c, smap) for c in conjuncts]
            children.append(_push(child, mapped))
        return dc_replace(node, children=tuple(children))

    if isinstance(node, SetOpNode):
        lmapped = [rex.replace_inputs(c, node.left_map)
                   for c in conjuncts]
        rmapped = [rex.replace_inputs(c, node.right_map)
                   for c in conjuncts]
        return dc_replace(node, left=_push(node.left, lmapped),
                          right=_push(node.right, rmapped))

    if isinstance(node, OutputNode):
        return dc_replace(node, source=_push(node.source, conjuncts))

    # leaves (TableScan, Values, RemoteSource)
    new_sources = tuple(_push(s, []) for s in node.sources)
    if new_sources != node.sources and hasattr(node, "source"):
        node = dc_replace(node, source=new_sources[0])
    return _wrap(node, conjuncts)


def _push_join(node: JoinNode, conjuncts: List[RowExpr]) -> PlanNode:
    lsyms = set(node.left.output_schema())
    rsyms = set(node.right.output_schema())
    jt = node.join_type

    left_down: List[RowExpr] = []
    right_down: List[RowExpr] = []
    new_criteria = list(node.criteria)
    keep: List[RowExpr] = []
    residual = _split_normalized(node.filter) if node.filter else []

    for c in conjuncts:
        refs = rex.input_names(c)
        if refs and refs <= lsyms and jt in ("inner", "left", "cross"):
            left_down.append(c)
        elif refs and refs <= rsyms and jt in ("inner", "cross"):
            right_down.append(c)
        elif jt in ("inner", "cross"):
            pair = _equi_pair(c, lsyms, rsyms)
            if pair is not None:
                new_criteria.append(JoinClause(*pair))
            else:
                residual.append(c)
        else:
            keep.append(c)

    # residuals that are side-local can also sink; equalities surfaced
    # by common-predicate extraction become criteria (from ON clauses)
    final_residual = []
    for c in residual:
        refs = rex.input_names(c)
        if refs and refs <= lsyms and jt in ("inner", "cross"):
            left_down.append(c)
        elif refs and refs <= rsyms and jt in ("inner", "cross"):
            right_down.append(c)
        elif jt in ("inner", "cross") and \
                (pair := _equi_pair(c, lsyms, rsyms)) is not None:
            new_criteria.append(JoinClause(*pair))
        else:
            final_residual.append(c)

    left = _push(node.left, left_down)
    right = _push(node.right, right_down)
    new_jt = "inner" if (jt == "cross" and new_criteria) else jt
    out = JoinNode(left, right, new_jt, tuple(new_criteria),
                   rex.and_all(final_residual) if final_residual else None,
                   node.distribution)
    return _wrap(out, keep)


def _equi_pair(c: RowExpr, lsyms: Set[str], rsyms: Set[str]):
    if isinstance(c, Call) and c.fn == "=" and len(c.args) == 2:
        a, b = c.args
        if isinstance(a, InputRef) and isinstance(b, InputRef):
            if a.name in lsyms and b.name in rsyms:
                return (a.name, b.name)
            if b.name in lsyms and a.name in rsyms:
                return (b.name, a.name)
    return None


def _wrap(node: PlanNode, conjuncts: List[RowExpr]) -> PlanNode:
    if not conjuncts:
        return node
    return FilterNode(node, rex.and_all(conjuncts))


# --------------------------------------------------------------------------
# column pruning
# --------------------------------------------------------------------------

def prune_columns(node: PlanNode) -> PlanNode:
    if isinstance(node, OutputNode):
        return dc_replace(node, source=_prune(node.source,
                                              set(node.symbols)))
    return _prune(node, set(node.output_schema()))


def _prune(node: PlanNode, needed: Set[str]) -> PlanNode:
    if isinstance(node, TableScanNode):
        keep = {s: c for s, c in node.assignments.items() if s in needed}
        if not keep:  # keep one column for row counting
            s = next(iter(node.assignments))
            keep = {s: node.assignments[s]}
        return TableScanNode(node.handle, keep,
                             {s: node.schema[s] for s in keep})

    if isinstance(node, ProjectNode):
        keep = {s: e for s, e in node.assignments.items() if s in needed}
        if not keep and node.assignments:
            s = next(iter(node.assignments))
            keep = {s: node.assignments[s]}
        child_needed = set()
        for e in keep.values():
            child_needed |= rex.input_names(e)
        return ProjectNode(_prune(node.source, child_needed), keep)

    if isinstance(node, FilterNode):
        child_needed = needed | rex.input_names(node.predicate)
        return FilterNode(_prune(node.source, child_needed),
                          node.predicate)

    if isinstance(node, AggregationNode):
        child_needed = set(node.group_keys)
        aggs = {s: a for s, a in node.aggregates.items()
                if s in needed or not node.aggregates}
        if not aggs and node.aggregates:
            # aggregates all pruned -> keep none; grouping keys remain
            aggs = {}
        for a in aggs.values():
            for sym in (a.argument, a.argument2, a.mask):
                if sym:
                    child_needed.add(sym)
        return dc_replace(node, source=_prune(node.source, child_needed),
                          aggregates=aggs)

    if isinstance(node, JoinNode):
        child = set(needed)
        for c in node.criteria:
            child.add(c.left)
            child.add(c.right)
        if node.filter is not None:
            child |= rex.input_names(node.filter)
        lsyms = set(node.left.output_schema())
        rsyms = set(node.right.output_schema())
        return dc_replace(
            node,
            left=_prune(node.left, child & lsyms),
            right=_prune(node.right, child & rsyms))

    if isinstance(node, SemiJoinNode):
        child = (needed - {node.output}) | {node.source_key}
        return dc_replace(
            node, source=_prune(node.source, child),
            filtering_source=_prune(node.filtering_source,
                                    {node.filtering_key}))

    if isinstance(node, SemiJoinMultiNode):
        child = (needed - {node.output}) | set(node.source_keys)
        fneed = set(node.filtering_keys)
        if node.filter is not None:
            refs = rex.input_names(node.filter)
            fsyms = set(node.filtering_source.output_schema())
            child |= (refs - fsyms)
            fneed |= (refs & fsyms)
        return dc_replace(
            node, source=_prune(node.source, child),
            filtering_source=_prune(node.filtering_source, fneed))

    if isinstance(node, (SortNode, TopNNode)):
        child = needed | {k.symbol for k in node.keys}
        return dc_replace(node, source=_prune(node.sources[0], child))

    if isinstance(node, MarkDistinctNode):
        child = (needed - {node.marker}) | set(node.keys)
        return dc_replace(node, source=_prune(node.source, child))

    if isinstance(node, UnnestNode):
        # every array stays (each one's length sets the row count); a
        # replicated column stays only where a parent reads it
        keep = tuple(s for s in node.replicate if s in needed)
        child = set(keep) | set(node.unnest.values())
        return dc_replace(node, source=_prune(node.source, child),
                          replicate=keep)

    if isinstance(node, AssignUniqueIdNode):
        return dc_replace(node, source=_prune(
            node.source, needed - {node.symbol}))

    if isinstance(node, WindowNode):
        child = needed - set(node.functions)
        child |= set(node.partition_by)
        child |= {k.symbol for k in node.order_by}
        for f in node.functions.values():
            for sym in (f.argument, f.offset, f.default):
                if sym:
                    child.add(sym)
        return dc_replace(node, source=_prune(node.source, child))

    if isinstance(node, UnionNode):
        keep_out = [s for s in node.schema if s in needed] or \
            list(node.schema)[:1]
        children = []
        maps = []
        for child, smap in zip(node.children, node.symbol_maps):
            cneed = {smap[s] for s in keep_out}
            children.append(_prune(child, cneed))
            maps.append({s: smap[s] for s in keep_out})
        return dc_replace(
            node, children=tuple(children),
            schema={s: node.schema[s] for s in keep_out},
            symbol_maps=tuple(maps))

    if isinstance(node, SetOpNode):
        # set-op semantics compare whole rows; keep all columns
        return dc_replace(node, left=_prune(
            node.left, set(node.left_map.values())),
            right=_prune(node.right, set(node.right_map.values())))

    if isinstance(node, (LimitNode, OffsetNode, SampleNode,
                         EnforceSingleRowNode, ExchangeNode)):
        src = node.sources[0]
        pruned = _prune(src, needed if not isinstance(
            node, EnforceSingleRowNode) else set(src.output_schema()))
        return dc_replace(node, source=pruned)

    if isinstance(node, ValuesNode):
        keep = [s for s in node.schema if s in needed] or \
            list(node.schema)[:1]
        idx = [list(node.schema).index(s) for s in keep]
        return ValuesNode({s: node.schema[s] for s in keep},
                          tuple(tuple(r[i] for i in idx)
                                for r in node.rows))

    if not node.sources:
        return node
    if len(node.sources) == 1 and hasattr(node, "source"):
        return dc_replace(node, source=_prune(
            node.sources[0], set(node.sources[0].output_schema())))
    return node


# --------------------------------------------------------------------------
# project cleanup
# --------------------------------------------------------------------------

def cleanup_projects(node: PlanNode) -> PlanNode:
    if isinstance(node, ProjectNode):
        src = cleanup_projects(node.source)
        if isinstance(src, ProjectNode):
            # merge Project(Project(x)) when outer refs inline trivially
            inlined = {}
            simple = True
            for s, e in node.assignments.items():
                inlined[s] = rex.replace_inputs(e, dict(src.assignments))
            merged = ProjectNode(src.source, inlined)
            node = merged
            src = merged.source
        else:
            node = dc_replace(node, source=src)
        if node.is_identity and \
                set(node.assignments) == set(node.source.output_schema()):
            return node.source
        return node
    if not node.sources:
        return node
    import dataclasses
    fields = {f.name for f in dataclasses.fields(node)}
    if "source" in fields:
        return dc_replace(node, source=cleanup_projects(node.sources[0]),
                          **({"left": cleanup_projects(node.left),
                              "right": cleanup_projects(node.right)}
                             if isinstance(node, SetOpNode) else {}))
    if isinstance(node, JoinNode):
        return dc_replace(node, left=cleanup_projects(node.left),
                          right=cleanup_projects(node.right))
    if isinstance(node, (SemiJoinNode, SemiJoinMultiNode)):
        return dc_replace(
            node, source=cleanup_projects(node.sources[0]),
            filtering_source=cleanup_projects(node.sources[1]))
    if isinstance(node, UnionNode):
        return dc_replace(node, children=tuple(
            cleanup_projects(c) for c in node.children))
    if isinstance(node, SetOpNode):
        return dc_replace(node, left=cleanup_projects(node.left),
                          right=cleanup_projects(node.right))
    return node


# --------------------------------------------------------------------------
# UnwrapCastInComparison (iterative/rule/UnwrapCastInComparison.java):
# CAST(col AS wider) CMP literal  ->  col CMP narrowed-literal, which
# unlocks domain pushdown into the scan for the uncast column.
# --------------------------------------------------------------------------

_CMPS = {"=", "<>", "<", "<=", ">", ">="}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
         "=": "=", "<>": "<>"}
_INT_ORDER = ["tinyint", "smallint", "integer", "bigint"]
_INT_RANGE = {"tinyint": (-2 ** 7, 2 ** 7 - 1),
              "smallint": (-2 ** 15, 2 ** 15 - 1),
              "integer": (-2 ** 31, 2 ** 31 - 1),
              "bigint": (-2 ** 63, 2 ** 63 - 1)}


def _unwrap_cmp(fn: str, cast: rex.Cast, const: Const):
    """The rewritten comparison, or None when not provably safe."""
    import math
    if not isinstance(cast.arg, InputRef) or cast.safe:
        return None
    s = cast.arg.type
    t = cast.type
    v = const.value
    if v is None:
        return None
    s_name = getattr(s, "name", "")
    t_name = getattr(t, "name", "")
    if s_name in _INT_ORDER and t_name in _INT_ORDER \
            and _INT_ORDER.index(t_name) > _INT_ORDER.index(s_name):
        lo, hi = _INT_RANGE[s_name]
        if lo <= int(v) <= hi:
            return Call(fn, (cast.arg, Const(int(v), s)),
                        rex.TRUE.type)
        return None   # out-of-range: constant-fold territory, skip
    if s_name in ("tinyint", "smallint", "integer") \
            and t_name == "double":
        # bigint deliberately excluded: values above 2^53 are not exact
        # in double, so the unwrap would change results (the reference
        # rule proves round-trip exactness; int32 and below always
        # round-trip)
        fv = float(v)
        if not math.isfinite(fv):
            return None
        lo, hi = _INT_RANGE[s_name]
        if fv == math.floor(fv) and lo <= fv <= hi:
            return Call(fn, (cast.arg, Const(int(fv), s)),
                        rex.TRUE.type)
        if fn in ("<", "<=", ">", ">=") and lo <= fv <= hi:
            # non-integral bound: snap to the neighboring integer
            if fn in ("<", "<="):
                return Call("<=", (cast.arg,
                                   Const(math.floor(fv), s)),
                            rex.TRUE.type)
            return Call(">=", (cast.arg, Const(math.ceil(fv), s)),
                        rex.TRUE.type)
    return None


def _unwrap_expr(e: RowExpr) -> RowExpr:
    if isinstance(e, Call):
        args = tuple(_unwrap_expr(a) for a in e.args)
        if e.fn in _CMPS and len(args) == 2:
            a, b = args
            fn = e.fn
            if isinstance(b, rex.Cast) and isinstance(a, Const):
                a, b, fn = b, a, _FLIP[e.fn]
                out = _unwrap_cmp(fn, a, b)
            elif isinstance(a, rex.Cast) and isinstance(b, Const):
                out = _unwrap_cmp(fn, a, b)
            else:
                out = None
            if out is not None:
                return out
        if args != e.args:
            return Call(e.fn, args, e.type)
        return e
    return e


def unwrap_casts(node: PlanNode) -> PlanNode:
    srcs = node.sources
    if srcs:
        new = [unwrap_casts(s) for s in srcs]
        if any(a is not b for a, b in zip(new, srcs)):
            node = _replace_sources(node, new)
    if isinstance(node, FilterNode):
        return dc_replace(node, predicate=_unwrap_expr(node.predicate))
    if isinstance(node, JoinNode) and node.filter is not None:
        return dc_replace(node, filter=_unwrap_expr(node.filter))
    return node


# --------------------------------------------------------------------------
# SingleDistinctAggregationToGroupBy (iterative/rule/
# SingleDistinctAggregationToGroupBy.java): when EVERY aggregate is
# DISTINCT over the same argument, dedup with an inner GROUP BY and run
# plain aggregates on top — the two-level form is partial/final
# combinable, which the distributed and remote schedulers exploit.
# --------------------------------------------------------------------------

def single_distinct_to_groupby(node: PlanNode) -> PlanNode:
    from ..plan.nodes import Aggregate
    srcs = node.sources
    if srcs:
        new = [single_distinct_to_groupby(s) for s in srcs]
        if any(a is not b for a, b in zip(new, srcs)):
            node = _replace_sources(node, new)
    if not (isinstance(node, AggregationNode) and node.step == "SINGLE"
            and node.group_id_symbol is None and node.aggregates):
        return node
    aggs = node.aggregates
    if not all(a.distinct for a in aggs.values()):
        return node
    arg0 = next(iter(aggs.values())).argument
    if arg0 is None or not all(
            a.argument == arg0 and a.mask is None
            and a.argument2 is None
            and a.kind in ("count", "sum", "avg", "min", "max")
            for a in aggs.values()):
        return node
    inner_keys = tuple(dict.fromkeys(node.group_keys + (arg0,)))
    inner = AggregationNode(node.source, inner_keys, {}, "SINGLE")
    outer = {s: Aggregate(a.kind, arg0, a.type, False, None)
             for s, a in aggs.items()}
    return AggregationNode(inner, node.group_keys, outer, "SINGLE")


# --------------------------------------------------------------------------
# CreatePartialTopN / partial limit (iterative/rule/CreatePartialTopN
# .java): TopN/Limit over a UNION runs PARTIAL in every branch before
# the merge — each branch keeps only its own top n rows.
# --------------------------------------------------------------------------

def _through_projects(node: PlanNode):
    """(projects-from-top, innermost-source): the chain of row
    -preserving projections under ``node`` (TopN/Limit commute with
    them — PushLimitThroughProject)."""
    projs = []
    src = node
    while isinstance(src, ProjectNode):
        projs.append(src)
        src = src.source
    return projs, src


# rule shapes, declared with the matching engine (the reference's
# Rule.pattern() contract — lib/trino-matching; CreatePartialTopN
# declares topN().with(step SINGLE) the same way)
_TOPN_SINGLE = _Pat.type_of(TopNNode).with_prop("step", "SINGLE")
_LIMIT_FULL = _Pat.type_of(LimitNode).with_prop("partial", False)


def partial_topn_through_union(node: PlanNode) -> PlanNode:
    from ..plan.nodes import SortKey
    srcs = node.sources
    if srcs:
        new = [partial_topn_through_union(s) for s in srcs]
        if any(a is not b for a, b in zip(new, srcs)):
            node = _replace_sources(node, new)
    if _TOPN_SINGLE.match(node):
        projs, u = _through_projects(node.source)
        if isinstance(u, UnionNode):
            # remap the sort keys through the (rename) projections
            def remap(sym):
                for p in projs:
                    e = p.assignments.get(sym)
                    if not isinstance(e, InputRef):
                        return None
                    sym = e.name
                return sym
            mapped = [remap(k.symbol) for k in node.keys]
            if all(m is not None and all(m in smap
                                         for smap in u.symbol_maps)
                   for m in mapped):
                kids = []
                for child, smap in zip(u.children, u.symbol_maps):
                    ckeys = tuple(
                        SortKey(smap[m], k.ascending, k.nulls_first)
                        for m, k in zip(mapped, node.keys))
                    kids.append(TopNNode(child, node.count, ckeys,
                                         "PARTIAL"))
                rebuilt: PlanNode = dc_replace(u,
                                               children=tuple(kids))
                for p in reversed(projs):
                    rebuilt = dc_replace(p, source=rebuilt)
                return dc_replace(node, source=rebuilt, step="FINAL")
    if _LIMIT_FULL.match(node):
        projs, u = _through_projects(node.source)
        if isinstance(u, UnionNode):
            kids = tuple(LimitNode(c, node.count, True)
                         for c in u.children)
            rebuilt = dc_replace(u, children=kids)
            for p in reversed(projs):
                rebuilt = dc_replace(p, source=rebuilt)
            return dc_replace(node, source=rebuilt)
    return node
