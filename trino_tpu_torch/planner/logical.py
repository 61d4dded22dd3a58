"""Analyzer + logical planner: AST -> typed PlanNode DAG.

Reference parity: this file fuses the roles of
- sql/analyzer/StatementAnalyzer.java (name/scope resolution, aggregation
  analysis) + ExpressionAnalyzer.java (type derivation, coercions),
- sql/planner/{LogicalPlanner,QueryPlanner,RelationPlanner,
  TranslationMap}.java (AST -> PlanNodes over unique symbols),
- sql/planner/SubqueryPlanner.java + the TransformCorrelated* /
  TransformUncorrelatedInPredicateSubqueryToSemiJoin iterative rules:
  subqueries are decorrelated AT PLAN TIME here (scalar-aggregate
  subqueries with equality correlation -> grouped aggregate + LEFT join;
  EXISTS -> [null-unaware] semi join with residual filter; uncorrelated
  IN -> null-aware semi join; uncorrelated scalar -> EnforceSingleRow +
  cross join).

The reference keeps Analysis as a side table; here scopes carry
(name, symbol, type) directly and expressions are translated straight to
the typed rex IR, so a separate Analysis object is unnecessary.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import rex
from ..catalog import CatalogManager
from ..functions import (FunctionResolutionError, aggregate_result_type,
                         is_aggregate, is_window, scalar_result_type)
from ..plan.nodes import (Aggregate, AggregationNode, AssignUniqueIdNode,
                          EnforceSingleRowNode, FilterNode, JoinClause,
                          JoinNode, LimitNode, MarkDistinctNode, OffsetNode,
                          OutputNode, PlanNode, ProjectNode, SampleNode,
                          SemiJoinNode, SetOpNode, SortKey, SortNode,
                          TableScanNode, TopNNode, UnionNode, UnnestNode,
                          ValuesNode, WindowFunction, WindowNode)
from ..rex import (Call, CaseExpr, Cast, Const, InputRef, Lambda, RowExpr,
                   TRUE)
from ..session import Session
from ..sql import ast as A
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, UNKNOWN,
                     VARCHAR, DecimalType, IntervalDayTime,
                     IntervalYearMonth, TimestampType, Type, VarcharType,
                     common_super_type, is_exact_numeric, is_integral,
                     is_numeric, is_string, parse_type)


class _NonConstValues(Exception):
    """Internal: a VALUES entry didn't constant-fold (triggers the
    UNION-ALL-of-SELECTs fallback in _plan_values)."""


class PlanningError(Exception):
    """SemanticException analog (error codes in Appendix A.8 taxonomy)."""


# --------------------------------------------------------------------------
# scopes
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Field:
    name: Optional[str]          # column name; None for anonymous exprs
    symbol: str                  # plan symbol
    type: Type
    qualifier: Optional[str] = None   # relation alias ('l', 'lineitem')

    def matches(self, parts: Tuple[str, ...]) -> bool:
        if self.name is None:
            return False
        if len(parts) == 1:
            return parts[0] == self.name
        if len(parts) == 2:
            return (self.qualifier is not None
                    and parts[0] == self.qualifier
                    and parts[1] == self.name)
        return False


@dataclass
class Scope:
    """sql/analyzer/Scope.java — visible fields + optional outer scope for
    correlated subqueries."""
    fields: List[Field]
    outer: Optional["Scope"] = None

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[Field, bool]:
        """Returns (field, is_outer)."""
        lparts = tuple(p.lower() for p in parts)
        hits = [f for f in self.fields if f.matches(lparts)]
        if len(hits) > 1:
            raise PlanningError(f"Column '{'.'.join(parts)}' is ambiguous")
        if hits:
            return hits[0], False
        if self.outer is not None:
            f, _ = self.outer.resolve(parts)
            return f, True
        raise PlanningError(
            f"Column '{'.'.join(parts)}' cannot be resolved")

    def try_resolve(self, parts):
        try:
            return self.resolve(parts)
        except PlanningError:
            return None, False


@dataclass
class RelationPlan:
    root: PlanNode
    scope: Scope


# --------------------------------------------------------------------------
# planner
# --------------------------------------------------------------------------

class SymbolAllocator:
    def __init__(self):
        self._c = itertools.count()

    def new(self, hint: str) -> str:
        hint = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                       for ch in (hint or "expr"))[:24].lower() or "expr"
        return f"{hint}${next(self._c)}"


class LogicalPlanner:
    def __init__(self, catalogs: CatalogManager, session: Session):
        self.catalogs = catalogs
        self.session = session
        self.symbols = SymbolAllocator()
        self._ctes: List[Dict[str, A.WithQuery]] = [{}]

    # ---- entry points ----------------------------------------------------
    def plan(self, stmt: A.Statement) -> OutputNode:
        if isinstance(stmt, A.QueryStatement):
            rp, names = self.plan_query(stmt.query)
            return OutputNode(rp.root, tuple(names),
                              tuple(f.symbol for f in rp.scope.fields))
        raise PlanningError(f"Cannot plan statement {type(stmt).__name__}")

    def plan_query(self, q: A.Query,
                   outer: Optional[Scope] = None
                   ) -> Tuple[RelationPlan, List[str]]:
        """Returns (plan, output column names)."""
        self._ctes.append({**self._ctes[-1],
                           **{w.name.lower(): w for w in q.with_queries}})
        try:
            rp, names = self._plan_body(q.body, outer)
            # outer-level ORDER BY / LIMIT / OFFSET (set-op queries)
            if q.order_by or q.limit is not None or q.offset:
                rp = self._order_limit(rp, names, q.order_by, q.limit,
                                       q.offset, outer)
            return rp, names
        finally:
            self._ctes.pop()

    # ---- query bodies ----------------------------------------------------
    def _plan_body(self, body: A.QueryBody, outer) -> Tuple[RelationPlan,
                                                            List[str]]:
        if isinstance(body, A.QuerySpecification):
            return self._plan_spec(body, outer)
        if isinstance(body, A.ValuesBody):
            return self._plan_values(body.rows), None or [
                f"_col{i}" for i in range(len(body.rows[0]))]
        if isinstance(body, A.SetOperation):
            return self._plan_setop(body, outer)
        raise PlanningError(f"unsupported query body {type(body).__name__}")

    def _plan_values(self, rows) -> RelationPlan:
        # evaluate constant expressions host-side; rows with
        # non-constant entries (map(...)/ARRAY[x]/scalar calls — the
        # reference allows arbitrary expressions in VALUES,
        # sql/planner/QueryPlanner.planValues) fall back to a UNION ALL
        # of single-row SELECTs
        try:
            return self._plan_values_const(rows)
        except _NonConstValues:
            # balanced UNION ALL tree (a left-deep chain would recurse
            # once per row and overflow on long VALUES lists)
            parts: List[A.QueryBody] = [
                A.QuerySpecification(select_items=tuple(
                    A.SelectItem(e, f"_col{i}")
                    for i, e in enumerate(row)))
                for row in rows]
            while len(parts) > 1:
                parts = [A.SetOperation("union", False, parts[i],
                                        parts[i + 1])
                         if i + 1 < len(parts) else parts[i]
                         for i in range(0, len(parts), 2)]
            rp, _ = self._plan_body(parts[0], None)
            return rp

    def _plan_values_const(self, rows) -> RelationPlan:
        n_cols = len(rows[0])
        values: List[List[object]] = []
        types: List[Type] = [UNKNOWN] * n_cols
        for row in rows:
            if len(row) != n_cols:
                raise PlanningError("VALUES rows must be the same length")
            vals = []
            for i, e in enumerate(row):
                ex = self._const_expr(e)
                t = common_super_type(types[i], ex.type)
                if t is None:
                    raise PlanningError(
                        f"VALUES column {i+1}: incompatible types "
                        f"{types[i]} and {ex.type}")
                types[i] = t
                vals.append(ex.value)
            values.append(vals)
        syms = [self.symbols.new(f"_col{i}") for i in range(n_cols)]
        node = ValuesNode(dict(zip(syms, types)),
                          tuple(tuple(r) for r in values))
        scope = Scope([Field(f"_col{i}", s, t) for i, (s, t) in
                       enumerate(zip(syms, types))])
        return RelationPlan(node, scope)

    def _const_expr(self, e: A.Expression) -> Const:
        ex = self._rewrite_expr(e, _ExprContext(self, Scope([]), None))
        folded = _const_fold(ex)
        if not isinstance(folded, Const):
            raise _NonConstValues("VALUES entries must be constant")
        return folded

    def _plan_setop(self, body: A.SetOperation, outer):
        lrp, lnames = self._plan_body(body.left, outer)
        rrp, rnames = self._plan_body(body.right, outer)
        lf, rf = lrp.scope.fields, rrp.scope.fields
        if len(lf) != len(rf):
            raise PlanningError(
                f"{body.op.upper()} sides have different column counts")
        types = []
        for a, b in zip(lf, rf):
            t = common_super_type(a.type, b.type)
            if t is None:
                raise PlanningError(
                    f"{body.op.upper()}: incompatible column types "
                    f"{a.type} / {b.type}")
            types.append(t)
        lrp = self._coerce_fields(lrp, types)
        rrp = self._coerce_fields(rrp, types)
        out_syms = [self.symbols.new(f.name or "col") for f in lf]
        schema = dict(zip(out_syms, types))
        lmap = {o: f.symbol for o, f in zip(out_syms, lrp.scope.fields)}
        rmap = {o: f.symbol for o, f in zip(out_syms, rrp.scope.fields)}
        if body.op == "union":
            node: PlanNode = UnionNode((lrp.root, rrp.root), schema,
                                       (lmap, rmap))
            if body.distinct:
                node = AggregationNode(node, tuple(out_syms), {})
        else:
            node = SetOpNode(body.op, body.distinct, lrp.root, rrp.root,
                             schema, lmap, rmap)
        scope = Scope([Field(f.name, s, t) for f, s, t in
                       zip(lf, out_syms, types)])
        return RelationPlan(node, scope), [f.name or f"_col{i}"
                                           for i, f in enumerate(lf)]

    def _coerce_fields(self, rp: RelationPlan,
                       types: List[Type]) -> RelationPlan:
        if all(f.type == t for f, t in zip(rp.scope.fields, types)):
            return rp
        assigns, fields = {}, []
        for f, t in zip(rp.scope.fields, types):
            e: RowExpr = InputRef(f.symbol, f.type)
            if f.type != t:
                e = Cast(e, t)
                sym = self.symbols.new(f.name or "cast")
            else:
                sym = f.symbol
            assigns[sym] = e
            fields.append(dc_replace(f, symbol=sym, type=t))
        return RelationPlan(ProjectNode(rp.root, assigns),
                            Scope(fields, rp.scope.outer))

    # ---- SELECT specification -------------------------------------------
    def _plan_spec(self, spec: A.QuerySpecification, outer):
        # FROM
        if spec.from_ is not None:
            rp = self._plan_relation(spec.from_, outer)
        else:
            sym = self.symbols.new("dual")
            rp = RelationPlan(
                ValuesNode({sym: BIGINT}, ((0,),)), Scope([]))
        rp.scope.outer = outer

        ctx = _ExprContext(self, rp.scope, rp.root)

        # WHERE
        if spec.where is not None:
            pred = ctx.rewrite(spec.where)
            _require_boolean(pred, "WHERE")
            ctx.root = FilterNode(ctx.root, pred)

        # aggregation analysis
        agg_calls = self._collect_aggregates(spec)
        grouped = bool(spec.group_by) or bool(agg_calls)

        select_items = self._expand_stars(spec.select_items, rp.scope)

        if grouped:
            post_ctx, group_syms = self._plan_aggregation(
                spec, agg_calls, ctx, select_items)
        else:
            post_ctx = ctx

        # window functions
        win_calls = [e for item in select_items
                     for e in A.walk_expressions(
                         item.expr, cross_subqueries=False)
                     if isinstance(e, A.FunctionCall) and e.window]
        if win_calls:
            post_ctx = self._plan_windows(post_ctx, win_calls)

        # SELECT projections
        out_syms: List[str] = []
        out_names: List[str] = []
        assigns: Dict[str, RowExpr] = {}
        for item in select_items:
            e = post_ctx.rewrite(item.expr)
            name = item.alias or _derive_name(item.expr)
            sym = self.symbols.new(name or "expr")
            assigns[sym] = e
            out_syms.append(sym)
            out_names.append((name or f"_col{len(out_names)}").lower())

        # HAVING
        if spec.having is not None:
            if not grouped:
                raise PlanningError("HAVING requires aggregation")
            h = post_ctx.rewrite(spec.having)
            _require_boolean(h, "HAVING")
            post_ctx.root = FilterNode(post_ctx.root, h)

        proj = ProjectNode(post_ctx.root, dict(assigns))
        out_fields = [Field((item.alias or _derive_name(item.expr)
                             or f"_col{i}").lower(), s, assigns[s].type)
                      for i, (item, s) in
                      enumerate(zip(select_items, out_syms))]
        result = RelationPlan(proj, Scope(out_fields, outer))

        # DISTINCT
        if spec.distinct:
            result = RelationPlan(
                AggregationNode(result.root, tuple(out_syms), {}),
                result.scope)

        # ORDER BY / LIMIT / OFFSET
        if spec.order_by or spec.limit is not None or spec.offset:
            result = self._order_limit(
                result, out_names, spec.order_by, spec.limit, spec.offset,
                outer, pre_ctx=post_ctx if not spec.distinct else None,
                pre_assigns=assigns if not spec.distinct else None)
        return result, out_names

    # ---- ORDER BY / LIMIT ------------------------------------------------
    def _order_limit(self, rp: RelationPlan, names: List[str], order_by,
                     limit, offset, outer, pre_ctx=None, pre_assigns=None):
        root = rp.root
        if order_by:
            keys: List[SortKey] = []
            extra: Dict[str, RowExpr] = {}
            out_fields = rp.scope.fields
            for si in order_by:
                sym = None
                e = si.expr
                # ordinal
                if isinstance(e, A.Literal) and isinstance(e.value, int) \
                        and e.type_name is None:
                    i = e.value
                    if not (1 <= i <= len(out_fields)):
                        raise PlanningError(
                            f"ORDER BY position {i} is out of range")
                    sym = out_fields[i - 1].symbol
                # select alias / output column
                elif isinstance(e, A.Identifier) and len(e.parts) == 1:
                    for f in out_fields:
                        if f.name == e.parts[0].lower():
                            sym = f.symbol
                            break
                if sym is None:
                    if pre_ctx is None:
                        raise PlanningError(
                            "ORDER BY expression must be an output column "
                            "for DISTINCT / set-operation queries")
                    ex = pre_ctx.rewrite(e)
                    sym = self.symbols.new("sortkey")
                    extra[sym] = ex
                asc = si.ascending
                nf = si.nulls_first if si.nulls_first is not None else False
                keys.append(SortKey(sym, asc, nf))
            if extra:
                # extend the final projection with sort keys, sort, then
                # project back down (reference: QueryPlanner sort channel
                # handling)
                assert isinstance(root, ProjectNode) and pre_assigns
                widened = dict(root.assignments)
                widened.update(extra)
                root = ProjectNode(root.source, widened)
            if limit is not None:
                root = TopNNode(root, limit + (offset or 0), tuple(keys))
            else:
                root = SortNode(root, tuple(keys))
            if extra:
                keep = {s: InputRef(s, e.type)
                        for s, e in (rp.root.assignments.items()
                                     if isinstance(rp.root, ProjectNode)
                                     else [])}
                root = ProjectNode(root, keep)
        if offset:
            root = OffsetNode(root, offset)
        if limit is not None and not order_by:
            root = LimitNode(root, limit)
        elif limit is not None and offset:
            root = LimitNode(root, limit)
        return RelationPlan(root, rp.scope)

    # ---- aggregation -----------------------------------------------------
    def _collect_aggregates(self, spec) -> List[A.FunctionCall]:
        out, seen = [], set()
        sources = [i.expr for i in spec.select_items]
        if spec.having is not None:
            sources.append(spec.having)
        for si in spec.order_by:
            sources.append(si.expr)
        for src in sources:
            for e in A.walk_expressions(src, cross_subqueries=False):
                if isinstance(e, A.FunctionCall) and not e.window \
                        and is_aggregate(e.name) and e not in seen:
                    # nested aggregates are illegal
                    for a in e.args:
                        for sub in A.walk_expressions(
                                a, cross_subqueries=False):
                            if isinstance(sub, A.FunctionCall) \
                                    and is_aggregate(sub.name):
                                raise PlanningError(
                                    "Cannot nest aggregate functions")
                    seen.add(e)
                    out.append(e)
        return out

    def _plan_aggregation(self, spec, agg_calls, ctx, select_items):
        # 1. group keys planned against the pre-agg scope
        group_exprs: List[A.Expression] = []
        grouping_sets: List[Tuple[int, ...]] = [()]
        if spec.group_by:
            group_exprs = list(spec.group_by.exprs)
            grouping_sets = list(spec.group_by.sets)
        # resolve ordinals / aliases in GROUP BY (SQL allows ordinals)
        resolved_groups: List[A.Expression] = []
        for g in group_exprs:
            if isinstance(g, A.Literal) and isinstance(g.value, int) \
                    and g.type_name is None:
                i = g.value
                if not (1 <= i <= len(select_items)):
                    raise PlanningError(
                        f"GROUP BY position {i} is out of range")
                resolved_groups.append(select_items[i - 1].expr)
            else:
                resolved_groups.append(g)

        pre_assigns: Dict[str, RowExpr] = {}
        key_syms: List[str] = []
        key_map: Dict[A.Expression, str] = {}
        for g in resolved_groups:
            e = ctx.rewrite(g)
            if isinstance(e, InputRef):
                sym = e.name
            else:
                sym = self.symbols.new("groupkey")
                pre_assigns[sym] = e
            key_syms.append(sym)
            key_map[g] = sym

        # 2. aggregate arguments pre-projected
        aggregates: Dict[str, Aggregate] = {}
        agg_map: Dict[A.Expression, Tuple[str, Type]] = {}
        for call in agg_calls:
            args: List[RowExpr] = [ctx.rewrite(a) for a in call.args
                                   if not isinstance(a, A.Star)]
            star = any(isinstance(a, A.Star) for a in call.args)
            mask_sym = None
            if call.filter is not None:
                m = ctx.rewrite(call.filter)
                _require_boolean(m, "FILTER")
                mask_sym = self.symbols.new("mask")
                pre_assigns[mask_sym] = m
            arg2_sym = None
            param = None
            if call.name == "count" and (star or not args):
                kind, arg_sym, rtype = "count_star", None, BIGINT
            elif call.name == "numeric_histogram":
                # numeric_histogram(buckets, value[, weight]): buckets
                # is a constant; value and weight are lanes
                kind = call.name
                if len(args) < 2 or len(args) > 3 \
                        or not isinstance(args[0], Const) \
                        or args[0].value is None:
                    raise PlanningError(
                        "numeric_histogram(buckets, value[, weight]): "
                        "buckets must be a constant")
                param = float(args[0].value)
                if param < 2:
                    raise PlanningError(
                        "numeric_histogram: buckets must be >= 2")
                from ..types import MapType
                rtype = MapType(DOUBLE, DOUBLE)
                a1 = args[1]
                if isinstance(a1, InputRef):
                    arg_sym = a1.name
                else:
                    arg_sym = self.symbols.new(f"{kind}_arg")
                    pre_assigns[arg_sym] = a1
                if len(args) == 3:
                    a2 = args[2]
                    if isinstance(a2, InputRef):
                        arg2_sym = a2.name
                    else:
                        arg2_sym = self.symbols.new(f"{kind}_arg2")
                        pre_assigns[arg2_sym] = a2
            elif call.name == "approx_most_frequent":
                # approx_most_frequent(buckets, value[, capacity]):
                # buckets/capacity are constants, value is the lane
                kind = call.name
                if len(args) < 2 or not isinstance(args[0], Const) \
                        or args[0].value is None:
                    raise PlanningError(
                        "approx_most_frequent(buckets, value): buckets "
                        "must be a constant")
                param = float(args[0].value)
                if param < 1:
                    raise PlanningError(
                        "approx_most_frequent: buckets must be a "
                        "positive integer")
                a1 = args[1]
                from ..types import MapType
                rtype = MapType(a1.type, BIGINT)
                if isinstance(a1, InputRef):
                    arg_sym = a1.name
                else:
                    arg_sym = self.symbols.new(f"{kind}_arg")
                    pre_assigns[arg_sym] = a1
            else:
                kind = call.name
                rtype = aggregate_result_type(kind,
                                              [a.type for a in args])
                a0 = args[0]
                if isinstance(a0, InputRef):
                    arg_sym = a0.name
                else:
                    arg_sym = self.symbols.new(f"{kind}_arg")
                    pre_assigns[arg_sym] = a0
                if len(args) > 1:
                    if kind == "approx_percentile":
                        # percentage must be constant (the reference's
                        # ApproximateDoublePercentileAggregations also
                        # requires a per-query-constant percentile)
                        a1 = args[1]
                        if not isinstance(a1, Const) or a1.value is None:
                            raise PlanningError(
                                "approx_percentile: percentage must be "
                                "a constant")
                        param = float(a1.value)
                    elif kind in ("approx_set", "approx_distinct"):
                        a1 = args[1]
                        if not isinstance(a1, Const) or a1.value is None:
                            raise PlanningError(
                                f"{kind}: max standard error must be a "
                                "constant")
                        param = float(a1.value)
                        if kind == "approx_set":
                            # validate eagerly (plan-time error beats a
                            # kernel-trace error) and re-type so the
                            # declared bucket bits match the runtime
                            # sketch
                            raise PlanningError(
                                "not yet ported: approx_set")
                    elif kind in ("min_by", "max_by", "corr",
                                  "covar_samp", "covar_pop",
                                  "regr_slope", "regr_intercept",
                                  "map_agg", "multimap_agg",
                                  "tdigest_agg", "qdigest_agg"):
                        a1 = args[1]
                        if isinstance(a1, InputRef):
                            arg2_sym = a1.name
                        else:
                            arg2_sym = self.symbols.new(f"{kind}_arg2")
                            pre_assigns[arg2_sym] = a1
                    else:
                        raise PlanningError(
                            f"{kind}: multi-argument aggregates not yet "
                            "supported")
                    if len(args) > 2:
                        if kind == "qdigest_agg" and len(args) == 3 \
                                and isinstance(args[2], Const) \
                                and args[2].value is not None:
                            # qdigest_agg(x, w, accuracy)
                            param = float(args[2].value)
                        else:
                            raise PlanningError(
                                f"{kind}: too many arguments")
            out_sym = self.symbols.new(call.name)
            aggregates[out_sym] = Aggregate(kind, arg_sym, rtype,
                                            call.distinct, mask_sym,
                                            arg2_sym, param)
            agg_map[call] = (out_sym, rtype)

        root = ctx.root
        if pre_assigns:
            src_schema = root.output_schema()
            full = {s: InputRef(s, t) for s, t in src_schema.items()}
            full.update(pre_assigns)
            root = ProjectNode(root, full)

        group_key_tuple = tuple(dict.fromkeys(key_syms))
        id_sym = None
        if len(grouping_sets) > 1:
            # GROUPING SETS / ROLLUP / CUBE: replicate rows per set with
            # a set-id column (plan/GroupIdNode.java). Aggregate
            # arguments/masks that coincide with grouping keys must read
            # a COPY of the column — GroupId nulls the key lanes in
            # subtotal copies but the aggregates see the original values
            # (the reference keeps separate argument mappings for this).
            from ..plan.nodes import GroupIdNode
            arg_copies: Dict[str, str] = {}
            new_aggs = {}
            for out_sym, a in aggregates.items():
                upd = {}
                for field_name in ("argument", "mask"):
                    s = getattr(a, field_name)
                    if s is not None and s in group_key_tuple:
                        if s not in arg_copies:
                            arg_copies[s] = self.symbols.new(s + "_arg")
                        upd[field_name] = arg_copies[s]
                new_aggs[out_sym] = dc_replace(a, **upd) if upd else a
            aggregates = new_aggs
            if arg_copies:
                schema = root.output_schema()
                full = {s: InputRef(s, t) for s, t in schema.items()}
                for orig, copy in arg_copies.items():
                    full[copy] = InputRef(orig, schema[orig])
                root = ProjectNode(root, full)
            id_sym = self.symbols.new("groupid")
            # grouping sets index into group_exprs; map to symbols
            expr_syms = [key_map[g] for g in resolved_groups]
            set_syms = tuple(
                tuple(dict.fromkeys(expr_syms[i] for i in s))
                for s in grouping_sets)
            root = GroupIdNode(root, set_syms, group_key_tuple, id_sym)
            group_key_tuple = group_key_tuple + (id_sym,)

        agg_node = AggregationNode(root, group_key_tuple, aggregates,
                                   group_id_symbol=id_sym)
        agg_node = self._rewrite_distinct_aggregation(agg_node)

        post = _ExprContext(self, ctx.scope, agg_node,
                            agg_map=agg_map, key_map=key_map,
                            group_symbols=set(agg_node.group_keys))
        if id_sym is not None:
            post.grouping_info = (id_sym, set_syms)
        return post, key_syms

    def _rewrite_distinct_aggregation(self, node: AggregationNode):
        """SingleDistinctAggregationToGroupBy (iterative/rule/): when every
        distinct aggregate shares one argument and there are no masks,
        dedupe via an inner group-by. count(DISTINCT x) needs no rewrite —
        the executor lowers it to the exact count_distinct kernel
        (ops/groupby.py), so it mixes freely with plain aggregates."""
        distinct = {s: a for s, a in node.aggregates.items()
                    if a.distinct}
        if not distinct:
            return node
        if all(a.kind == "count" for a in distinct.values()):
            # every distinct aggregate is count(DISTINCT) -> executor
            # handles them natively, mixing freely with plain aggs
            return node
        args = {a.argument for a in distinct.values()}
        plain = {s: a for s, a in node.aggregates.items()
                 if s not in distinct}
        if len(args) != 1 or plain or any(
                a.mask for a in distinct.values()):
            raise PlanningError(
                "mixed / multi-column DISTINCT aggregates not yet "
                "supported")
        arg = next(iter(args))
        inner_keys = tuple(dict.fromkeys(node.group_keys + ((arg,)
                           if arg else ())))
        inner = AggregationNode(node.source, inner_keys, {})
        outer_aggs = {s: dc_replace(a, distinct=False)
                      for s, a in distinct.items()}
        return AggregationNode(inner, node.group_keys, outer_aggs)

    # ---- windows ---------------------------------------------------------
    def _plan_windows(self, ctx: "_ExprContext", calls):
        win_map: Dict[A.Expression, Tuple[str, Type]] = {}
        root = ctx.root
        for call in calls:
            spec = call.window
            pre: Dict[str, RowExpr] = {}

            def to_sym(aexpr, label="winexpr") -> str:
                return as_sym(ctx.rewrite(aexpr), label)

            def as_sym(e, label="winexpr") -> str:
                if isinstance(e, InputRef):
                    return e.name
                s = self.symbols.new(label)
                pre[s] = e
                return s

            part = tuple(to_sym(p) for p in spec.partition_by)
            order = tuple(SortKey(to_sym(si.expr), si.ascending,
                                  si.nulls_first or False)
                          for si in spec.order_by)
            args = [a for a in call.args if not isinstance(a, A.Star)]
            arg_sym = None
            atype: Optional[Type] = None
            off_sym = None
            def_sym = None
            if call.name == "ntile":
                # ntile(n): the single argument is the bucket count,
                # not a value lane (operator/window/NTileFunction.java)
                if args:
                    off_sym = to_sym(args[0], "ntile_n")
            elif args:
                e0 = ctx.rewrite(args[0])
                atype = e0.type
                arg_sym = as_sym(e0, "winarg")
                if call.name in ("lag", "lead"):
                    # lag(x [, offset [, default]])
                    if len(args) > 1:
                        off_sym = to_sym(args[1], "winoff")
                    if len(args) > 2:
                        def_sym = to_sym(args[2], "windef")
                elif call.name == "nth_value":
                    # nth_value(x, n): second argument is the position
                    if len(args) < 2:
                        raise PlanningError(
                            "nth_value requires a position argument")
                    n_ex = ctx.rewrite(args[1])
                    if isinstance(n_ex, Const) and \
                            n_ex.value is not None and \
                            int(n_ex.value) <= 0:
                        raise PlanningError(
                            "Argument of nth_value must be a positive "
                            "integer")
                    off_sym = as_sym(n_ex, "winoff")
            if is_window(call.name):
                rtype = {"row_number": BIGINT, "rank": BIGINT,
                         "dense_rank": BIGINT, "ntile": BIGINT,
                         "percent_rank": DOUBLE, "cume_dist": DOUBLE,
                         }.get(call.name, atype or BIGINT)
            elif is_aggregate(call.name):
                rtype = (BIGINT if call.name == "count" and arg_sym is None
                         else aggregate_result_type(
                             call.name, [atype] if atype else []))
            else:
                raise PlanningError(
                    f"'{call.name}' is not a window function")
            if pre:
                schema = root.output_schema()
                full = {s: InputRef(s, t) for s, t in schema.items()}
                full.update(pre)
                root = ProjectNode(root, full)
            frame = spec.frame

            def frame_const(value_expr, what):
                if value_expr is None:
                    return None
                v = self._const_expr(value_expr).value
                if v is None or int(v) < 0:
                    raise PlanningError(
                        f"window frame {what} offset must be a "
                        "non-negative constant")
                return int(v)

            out_sym = self.symbols.new(call.name)
            fn = WindowFunction(
                call.name, arg_sym, rtype,
                frame_unit=frame.unit if frame else "range",
                frame_start=frame.start_type if frame
                else "unbounded_preceding",
                frame_end=frame.end_type if frame else "current",
                offset=off_sym, default=def_sym,
                frame_start_value=frame_const(
                    frame.start_value if frame else None, "start"),
                frame_end_value=frame_const(
                    frame.end_value if frame else None, "end"))
            root = WindowNode(root, part, order, {out_sym: fn})
            win_map[call] = (out_sym, rtype)
        out = _ExprContext(self, ctx.scope, root, agg_map=ctx.agg_map,
                           key_map=ctx.key_map,
                           group_symbols=ctx.group_symbols)
        out.win_map = win_map
        if hasattr(ctx, "grouping_info"):
            # grouping() must keep decoding the set index after window
            # planning replaces the context (silently-0 otherwise)
            out.grouping_info = ctx.grouping_info
        return out

    # ---- relations -------------------------------------------------------
    def _plan_relation(self, rel: A.Relation, outer) -> RelationPlan:
        if isinstance(rel, A.Table):
            return self._plan_table(rel, outer)
        if isinstance(rel, A.AliasedRelation):
            inner = self._plan_relation(rel.relation, outer)
            alias = rel.alias.lower()
            fields = []
            for i, f in enumerate(inner.scope.fields):
                name = (rel.column_names[i].lower()
                        if i < len(rel.column_names) else f.name)
                fields.append(Field(name, f.symbol, f.type, alias))
            return RelationPlan(inner.root, Scope(fields, outer))
        if isinstance(rel, A.SubqueryRelation):
            rp, _ = self.plan_query(rel.query, outer)
            return rp
        if isinstance(rel, A.ValuesRelation):
            return self._plan_values(rel.rows)
        if isinstance(rel, A.Unnest):
            return self._plan_unnest(rel, outer, None)
        if isinstance(rel, A.Join):
            return self._plan_join(rel, outer)
        if isinstance(rel, A.TableSample):
            inner = self._plan_relation(rel.relation, outer)
            ratio = self._const_expr(rel.percentage).value
            return RelationPlan(
                SampleNode(inner.root, rel.method, float(ratio) / 100.0),
                inner.scope)
        raise PlanningError(
            f"unsupported relation {type(rel).__name__}")

    def _plan_table(self, rel: A.Table, outer) -> RelationPlan:
        parts = tuple(p.lower() for p in rel.parts)
        # CTE?
        if len(parts) == 1 and parts[0] in self._ctes[-1]:
            w = self._ctes[-1][parts[0]]
            rp, names = self.plan_query(w.query)
            fields = []
            for i, f in enumerate(rp.scope.fields):
                name = (w.column_names[i].lower()
                        if i < len(w.column_names) else f.name)
                fields.append(Field(name, f.symbol, f.type, parts[0]))
            return RelationPlan(rp.root, Scope(fields, outer))
        catalog, schema, table = self._qualify(parts)
        if schema == "information_schema":
            return self._plan_information_schema(catalog, table, outer)
        view = self.catalogs.get_view(catalog, schema, table)
        if view is not None:
            # view expansion: plan the stored definition in place
            # (reference: StatementAnalyzer visitTable view branch,
            # with the analyzer's recursive-view detection)
            key = (catalog, schema, table)
            stack = getattr(self, "_view_stack", None)
            if stack is None:
                stack = self._view_stack = []
            if key in stack:
                raise PlanningError(
                    "View is recursive: " + ".".join(key))
            stack.append(key)
            try:
                rp, names = self.plan_query(view.query)
            finally:
                stack.pop()
            fields = [Field(f.name, f.symbol, f.type, table)
                      for f in rp.scope.fields]
            return RelationPlan(rp.root, Scope(fields, outer))
        if self.catalogs.access_control is not None:
            raise PlanningError("not yet ported: access control")
        handle, meta = self.catalogs.resolve_table(catalog, schema, table)
        assignments, schema_map, fields = {}, {}, []
        for cm in meta.columns:
            sym = self.symbols.new(cm.name)
            assignments[sym] = cm.name
            schema_map[sym] = cm.type
            fields.append(Field(cm.name.lower(), sym, cm.type,
                                table.lower()))
        return RelationPlan(TableScanNode(handle, assignments, schema_map),
                            Scope(fields, outer))

    def _plan_information_schema(self, catalog: str, table: str,
                                 outer) -> RelationPlan:
        """information_schema synthesized from connector metadata at plan
        time (reference: connector/informationschema/ — a virtual
        connector per catalog)."""
        conn = self.catalogs.connector(catalog)
        if table == "schemata":
            cols = [("catalog_name", VARCHAR), ("schema_name", VARCHAR)]
            rows = [(catalog, s) for s in conn.list_schemas()]
        elif table == "tables":
            cols = [("table_catalog", VARCHAR), ("table_schema", VARCHAR),
                    ("table_name", VARCHAR), ("table_type", VARCHAR)]
            rows = [(catalog, s, t, "BASE TABLE")
                    for s in conn.list_schemas()
                    for t in conn.list_tables(s)]
        elif table == "columns":
            cols = [("table_catalog", VARCHAR), ("table_schema", VARCHAR),
                    ("table_name", VARCHAR), ("column_name", VARCHAR),
                    ("ordinal_position", BIGINT),
                    ("column_default", VARCHAR),
                    ("is_nullable", VARCHAR), ("data_type", VARCHAR)]
            rows = []
            for s in conn.list_schemas():
                for t in conn.list_tables(s):
                    meta = conn.get_table_metadata(s, t)
                    for i, cm in enumerate(meta.columns):
                        rows.append((catalog, s, t, cm.name, i + 1,
                                     None, "YES", cm.type.name))
        elif table == "views":
            cols = [("table_catalog", VARCHAR), ("table_schema", VARCHAR),
                    ("table_name", VARCHAR), ("view_definition", VARCHAR)]
            rows = []
            for s in conn.list_schemas():
                for v in self.catalogs.list_views(catalog, s):
                    vd = self.catalogs.get_view(catalog, s, v)
                    rows.append((catalog, s, v,
                                 vd.sql if vd is not None else None))
        else:
            raise PlanningError(
                f"Table '{catalog}.information_schema.{table}' does not "
                "exist")
        syms = [self.symbols.new(n) for n, _ in cols]
        schema_map = {sym: ty for sym, (_, ty) in zip(syms, cols)}
        node = ValuesNode(schema_map, tuple(rows))
        scope = Scope([Field(n, sym, ty, table)
                       for sym, (n, ty) in zip(syms, cols)], outer)
        return RelationPlan(node, scope)

    def _qualify(self, parts: Tuple[str, ...]):
        if len(parts) == 3:
            return parts
        if len(parts) == 2:
            if self.session.catalog is None:
                raise PlanningError("Catalog must be specified")
            return (self.session.catalog,) + parts
        if self.session.catalog is None or self.session.schema is None:
            raise PlanningError(
                "Schema must be specified when session schema is not set")
        return (self.session.catalog, self.session.schema, parts[0])

    def _plan_unnest(self, rel: "A.Unnest", outer, lateral,
                     alias: Optional[str] = None,
                     colnames: Tuple[str, ...] = ()) -> RelationPlan:
        """FROM UNNEST(arr) [WITH ORDINALITY], standalone or lateral
        (CROSS JOIN UNNEST referencing earlier FROM items). Reference:
        RelationPlanner.visitUnnest + operator/unnest/UnnestOperator."""
        from ..types import ArrayType
        if lateral is None:
            one = self.symbols.new("unnest_src")
            base_root: PlanNode = ValuesNode({one: BIGINT}, ((0,),))
            base_scope = Scope([], outer)
        else:
            base_root, base_scope = lateral.root, lateral.scope
        replicate = tuple(base_root.output_schema())
        ctx = _ExprContext(self, base_scope, base_root)
        pre: Dict[str, RowExpr] = {}
        unnest_map: Dict[str, str] = {}
        out_fields: List[Field] = []
        i = 0
        for ex in rel.exprs:
            rx = ctx.rewrite(ex)
            if not isinstance(rx.type, ArrayType):
                raise PlanningError(
                    f"UNNEST argument must be an array (got {rx.type})")
            if isinstance(rx, InputRef):
                sym = rx.name
            else:
                sym = self.symbols.new("unnest_arg")
                pre[sym] = rx
            osym = self.symbols.new("unnest")
            unnest_map[osym] = sym
            name = colnames[i].lower() if i < len(colnames) \
                else f"col{i + 1}"
            out_fields.append(Field(name, osym, rx.type.element, alias))
            i += 1
        ord_sym = None
        if rel.with_ordinality:
            ord_sym = self.symbols.new("ordinality")
            name = colnames[i].lower() if i < len(colnames) \
                else "ordinality"
            out_fields.append(Field(name, ord_sym, BIGINT, alias))
        root = base_root
        if pre:
            schema = root.output_schema()
            full = {s: InputRef(s, t) for s, t in schema.items()}
            full.update(pre)
            root = ProjectNode(root, full)
        node = UnnestNode(root, replicate, unnest_map, ord_sym)
        base_fields = list(base_scope.fields) if lateral else []
        return RelationPlan(node, Scope(base_fields + out_fields, outer))

    def _plan_join(self, rel: A.Join, outer) -> RelationPlan:
        # lateral UNNEST: the right side references the left's columns
        un = rel.right
        un_alias, un_cols = None, ()
        if isinstance(un, A.AliasedRelation) and \
                isinstance(un.relation, A.Unnest):
            un_alias = un.alias.lower()
            un_cols = tuple(un.column_names)
            un = un.relation
        if isinstance(un, A.Unnest):
            if rel.join_type != "cross" and rel.on is not None:
                raise PlanningError(
                    "JOIN UNNEST supports only CROSS JOIN")
            left0 = self._plan_relation(rel.left, outer)
            return self._plan_unnest(un, outer, left0, un_alias, un_cols)
        left = self._plan_relation(rel.left, outer)
        right = self._plan_relation(rel.right, outer)
        combined = Scope(left.scope.fields + right.scope.fields, outer)

        if rel.join_type == "cross" and rel.on is None and not rel.using:
            return RelationPlan(
                JoinNode(left.root, right.root, "cross"), combined)

        if rel.using:
            conj = []
            for name in rel.using:
                lf, _ = Scope(left.scope.fields).resolve((name,))
                rf, _ = Scope(right.scope.fields).resolve((name,))
                conj.append(Call("=", (
                    InputRef(lf.symbol, lf.type),
                    InputRef(rf.symbol, rf.type)), BOOLEAN))
            on_expr = rex.and_all(conj)
        else:
            ctx = _ExprContext(self, combined, None)
            on_expr = ctx.rewrite(rel.on)
            _require_boolean(on_expr, "JOIN ON")

        lsyms = {f.symbol for f in left.scope.fields}
        rsyms = {f.symbol for f in right.scope.fields}
        criteria, residual = _extract_equi_criteria(on_expr, lsyms, rsyms)

        # non-equi comparisons referencing both sides stay as join filter;
        # side-local conjuncts sink only to the INNER side of the join —
        # an ON conjunct over the outer side's columns disqualifies
        # matches but must never drop outer rows (reference:
        # optimizations/PredicatePushDown.java outer-join handling)
        push_left, push_right, keep = [], [], []
        for c in residual:
            refs = rex.input_names(c)
            if refs <= lsyms and rel.join_type in ("inner", "right"):
                push_left.append(c)
            elif refs <= rsyms and rel.join_type in ("inner", "left"):
                push_right.append(c)
            else:
                keep.append(c)
        lroot = (FilterNode(left.root, rex.and_all(push_left))
                 if push_left else left.root)
        rroot = (FilterNode(right.root, rex.and_all(push_right))
                 if push_right else right.root)

        # criteria argument symbols may be expressions — pre-project
        lassign, rassign = {}, {}
        clauses = []
        for le, re_ in criteria:
            ls = self._as_symbol(le, lassign)
            rs = self._as_symbol(re_, rassign)
            clauses.append(JoinClause(ls, rs))
        if lassign:
            schema = lroot.output_schema()
            full = {s: InputRef(s, t) for s, t in schema.items()}
            full.update(lassign)
            lroot = ProjectNode(lroot, full)
        if rassign:
            schema = rroot.output_schema()
            full = {s: InputRef(s, t) for s, t in schema.items()}
            full.update(rassign)
            rroot = ProjectNode(rroot, full)

        jt = rel.join_type if rel.join_type != "cross" else "inner"
        if not clauses and jt == "inner":
            node: PlanNode = JoinNode(lroot, rroot, "cross")
            if keep:
                node = FilterNode(node, rex.and_all(keep))
        else:
            node = JoinNode(lroot, rroot, jt, tuple(clauses),
                            rex.and_all(keep) if keep else None)
        return RelationPlan(node, combined)

    def _as_symbol(self, e: RowExpr, assigns: Dict[str, RowExpr]) -> str:
        if isinstance(e, InputRef):
            return e.name
        sym = self.symbols.new("joinkey")
        assigns[sym] = e
        return sym

    # ---- subqueries (SubqueryPlanner + decorrelation rules) -------------
    def plan_scalar_subquery(self, ctx: "_ExprContext",
                             q: A.Query) -> RowExpr:
        sub, _ = self.plan_query(q, outer=ctx.scope)
        if len(sub.scope.fields) != 1:
            raise PlanningError(
                "Scalar subquery must return exactly one column")
        out_f = sub.scope.fields[0]
        corr = _correlated_symbols(sub.root, _all_symbols(ctx.root))
        if not corr:
            single = EnforceSingleRowNode(sub.root)
            ctx.root = JoinNode(ctx.root, single, "cross")
            return InputRef(out_f.symbol, out_f.type)
        # correlated: decorrelate scalar-aggregate pattern
        new_root, pairs = _decorrelate_scalar_agg(
            sub.root, corr, self.symbols)
        criteria = tuple(JoinClause(o, i) for o, i in pairs)
        ctx.root = JoinNode(ctx.root, new_root, "left", criteria)
        return InputRef(out_f.symbol, out_f.type)

    def plan_in_subquery(self, ctx: "_ExprContext", operand: RowExpr,
                         q: A.Query, negated: bool) -> RowExpr:
        sub, _ = self.plan_query(q, outer=ctx.scope)
        if len(sub.scope.fields) != 1:
            raise PlanningError(
                "IN subquery must return exactly one column")
        corr = _correlated_symbols(sub.root, _all_symbols(ctx.root))
        if corr:
            if negated:
                # the null-unaware rewrite below would turn NULL into
                # FALSE, which NOT inverts into spurious TRUE rows
                raise PlanningError(
                    "correlated NOT IN subqueries not supported")
            # correlated IN -> EXISTS-style semi join on the correlation
            # pairs plus (operand = subquery output). Null-unaware: where
            # full IN semantics would yield NULL this yields FALSE —
            # output-equivalent for a positive IN in WHERE
            # (TransformCorrelatedInPredicateToJoin's non-null-aware
            # branch in the reference).
            f = sub.scope.fields[0]
            t = common_super_type(operand.type, f.type)
            if t is None:
                raise PlanningError(
                    f"IN: incompatible types {operand.type} / {f.type}")
            new_root, pairs, residual = _decorrelate_exists(
                sub.root, corr, self.symbols)
            schema = new_root.output_schema()
            filt_sym = f.symbol
            if f.type != t:
                filt_sym = self.symbols.new("inkey")
                assigns = {s: InputRef(s, ty)
                           for s, ty in schema.items()}
                assigns[filt_sym] = Cast(InputRef(f.symbol, f.type), t)
                new_root = ProjectNode(new_root, assigns)
            src_sym = self._attach_symbol(ctx, _maybe_cast(operand, t))
            src_keys = (src_sym,) + tuple(o for o, _ in pairs)
            filt_keys = (filt_sym,) + tuple(i for _, i in pairs)
            mark = self.symbols.new("insubquery")
            ctx.root = SemiJoinMultiNode(
                ctx.root, new_root, src_keys, filt_keys, residual, mark,
                null_aware=False)
            e2: RowExpr = InputRef(mark, BOOLEAN)
            return Call("not", (e2,), BOOLEAN) if negated else e2
        f = sub.scope.fields[0]
        t = common_super_type(operand.type, f.type)
        if t is None:
            raise PlanningError(
                f"IN: incompatible types {operand.type} / {f.type}")
        src_sym = self._attach_symbol(ctx, _maybe_cast(operand, t))
        filt_root = sub.root
        if f.type != t:
            filt_sym = self.symbols.new("inkey")
            filt_root = ProjectNode(
                filt_root,
                {filt_sym: Cast(InputRef(f.symbol, f.type), t)})
        else:
            filt_sym = f.symbol
        mark = self.symbols.new("insubquery")
        ctx.root = SemiJoinNode(ctx.root, filt_root, src_sym, filt_sym,
                                mark)
        e: RowExpr = InputRef(mark, BOOLEAN)
        return Call("not", (e,), BOOLEAN) if negated else e

    def plan_exists(self, ctx: "_ExprContext", q: A.Query,
                    negated: bool) -> RowExpr:
        sub, _ = self.plan_query(q, outer=ctx.scope)
        corr = _correlated_symbols(sub.root, _all_symbols(ctx.root))
        mark = self.symbols.new("exists")
        if not corr:
            # EXISTS (uncorrelated) -> cross join against count(*)>0
            agg_sym = self.symbols.new("cnt")
            agg = AggregationNode(
                sub.root, (),
                {agg_sym: Aggregate("count_star", None, BIGINT)})
            flag = ProjectNode(agg, {mark: Call(
                ">", (InputRef(agg_sym, BIGINT), Const(0, BIGINT)),
                BOOLEAN)})
            ctx.root = JoinNode(ctx.root, flag, "cross")
        else:
            new_root, pairs, residual = _decorrelate_exists(
                sub.root, corr, self.symbols)
            src_keys, filt_keys = [], []
            schema = new_root.output_schema()
            for o, i in pairs:
                src_keys.append(o)
                filt_keys.append(i)
            ctx.root = SemiJoinMultiNode(
                ctx.root, new_root, tuple(src_keys), tuple(filt_keys),
                residual, mark, null_aware=False)
        e: RowExpr = InputRef(mark, BOOLEAN)
        return Call("not", (e,), BOOLEAN) if negated else e

    def plan_quantified(self, ctx: "_ExprContext",
                        e: A.QuantifiedComparison) -> RowExpr:
        """x <op> ALL/ANY (subquery) — rewritten over (min/max, count,
        count-non-null) of the subquery with full three-valued logic
        (reference rules: QuantifiedComparison -> aggregation rewrite in
        TransformQuantifiedComparisonApplyToCorrelatedJoin)."""
        op = "<>" if e.op == "!=" else e.op
        quant = e.quantifier.lower()
        is_all = quant == "all"
        if op == "=" and not is_all:
            return self.plan_in_subquery(
                ctx, self._rewrite_expr(e.operand, ctx), e.query, False)
        if op == "<>" and is_all:
            return self.plan_in_subquery(
                ctx, self._rewrite_expr(e.operand, ctx), e.query, True)
        if op in ("=", "<>"):
            raise PlanningError(f"{op} {quant.upper()} not supported")
        sub, _ = self.plan_query(e.query, outer=ctx.scope)
        if len(sub.scope.fields) != 1:
            raise PlanningError(
                "quantified subquery must return exactly one column")
        if _correlated_symbols(sub.root, _all_symbols(ctx.root)):
            raise PlanningError(
                "correlated quantified subqueries not supported")
        operand = self._rewrite_expr(e.operand, ctx)
        f = sub.scope.fields[0]
        t = common_super_type(operand.type, f.type)
        if t is None:
            raise PlanningError(
                f"{op} {quant}: incompatible types "
                f"{operand.type} / {f.type}")
        sub_root = sub.root
        arg_sym = f.symbol
        if f.type != t:
            arg_sym = self.symbols.new("qarg")
            sub_root = ProjectNode(
                sub_root, {arg_sym: Cast(InputRef(f.symbol, f.type), t)})
        # ALL with >/>= bounds against max; ANY against min (and
        # symmetrically for </<=)
        want_max = (op in (">", ">=")) == is_all
        b_sym = self.symbols.new("bound")
        n_sym = self.symbols.new("cnt")
        nn_sym = self.symbols.new("cnt_nonnull")
        agg = AggregationNode(sub_root, (), {
            b_sym: Aggregate("max" if want_max else "min", arg_sym, t),
            n_sym: Aggregate("count_star", None, BIGINT),
            nn_sym: Aggregate("count", arg_sym, BIGINT)})
        ctx.root = JoinNode(ctx.root, agg, "cross")
        x = _maybe_cast(operand, t)
        cmp = Call(op, (x, InputRef(b_sym, t)), BOOLEAN)
        empty = Call("=", (InputRef(n_sym, BIGINT), Const(0, BIGINT)),
                     BOOLEAN)
        has_null = Call("<", (InputRef(nn_sym, BIGINT),
                              InputRef(n_sym, BIGINT)), BOOLEAN)
        if is_all:
            # TRUE on empty; FALSE when the comparison fails against the
            # bound; NULL when it holds but the set contains NULLs
            return CaseExpr((
                (empty, rex.TRUE),
                (Call("not", (cmp,), BOOLEAN), rex.FALSE),
                (has_null, Const(None, BOOLEAN))),
                cmp, BOOLEAN)
        return CaseExpr((
            (empty, rex.FALSE),
            (cmp, rex.TRUE),
            (has_null, Const(None, BOOLEAN))),
            cmp, BOOLEAN)

    def _attach_symbol(self, ctx: "_ExprContext", e: RowExpr) -> str:
        if isinstance(e, InputRef):
            return e.name
        sym = self.symbols.new("subqkey")
        schema = ctx.root.output_schema()
        full = {s: InputRef(s, t) for s, t in schema.items()}
        full[sym] = e
        ctx.root = ProjectNode(ctx.root, full)
        return sym

    def _expand_stars(self, items, scope: Scope) -> List[A.SelectItem]:
        out = []
        for item in items:
            if isinstance(item.expr, A.Star):
                q = item.expr.qualifier
                matched = False
                for f in scope.fields:
                    if q is None or f.qualifier == q.lower():
                        matched = True
                        out.append(A.SelectItem(
                            A.Identifier(
                                ((f.qualifier, f.name) if f.qualifier
                                 else (f.name,))), f.name))
                if not matched:
                    raise PlanningError(
                        f"SELECT {q + '.' if q else ''}* has no columns")
            else:
                out.append(item)
        return out


# --------------------------------------------------------------------------
# multi-key semi join node (EXISTS decorrelation target)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SemiJoinMultiNode(PlanNode):
    """Generalized semi join: multiple equi keys + residual filter, used
    by EXISTS decorrelation (the single-key null-aware SemiJoinNode stays
    dedicated to IN, mirroring plan/SemiJoinNode.java)."""
    source: PlanNode
    filtering_source: PlanNode
    source_keys: Tuple[str, ...]
    filtering_keys: Tuple[str, ...]
    filter: Optional[RowExpr]
    output: str
    null_aware: bool = False

    @property
    def sources(self):
        return (self.source, self.filtering_source)

    def output_schema(self):
        out = dict(self.source.output_schema())
        out[self.output] = BOOLEAN
        return out


# --------------------------------------------------------------------------
# expression translation (ExpressionAnalyzer + TranslationMap)
# --------------------------------------------------------------------------

class _ExprContext:
    """Carries the scope + current plan root (subqueries attach joins to
    the root as they are planned) + agg/window substitution maps."""

    def __init__(self, planner: LogicalPlanner, scope: Scope,
                 root: Optional[PlanNode], agg_map=None, key_map=None,
                 group_symbols=None):
        self.planner = planner
        self.scope = scope
        self.root = root
        self.agg_map = agg_map or {}
        self.key_map = key_map or {}
        self.group_symbols = group_symbols
        self.win_map: Dict[A.Expression, Tuple[str, Type]] = {}
        self.in_aggregate = False
        # lambda parameter bindings: name -> (synthetic symbol, type);
        # pushed/popped around lambda-body rewriting (reference:
        # ExpressionAnalyzer lambda scopes)
        self.lambda_params: Dict[str, Tuple[str, Type]] = {}

    def rewrite(self, e: A.Expression) -> RowExpr:
        return self.planner._rewrite_expr(e, self)


def _require_boolean(e: RowExpr, where: str):
    if e.type not in (BOOLEAN, UNKNOWN):
        raise PlanningError(
            f"{where} clause must evaluate to boolean (got {e.type})")


# the translation itself is a method of LogicalPlanner for access to
# symbols/catalogs; defined here to keep the class body readable
def _rewrite_expr(self: LogicalPlanner, e: A.Expression,
                  ctx: _ExprContext) -> RowExpr:
    # agg / group-key / window substitution first (TranslationMap)
    if ctx.agg_map or ctx.key_map or ctx.win_map:
        if e in ctx.win_map:
            sym, t = ctx.win_map[e]
            return InputRef(sym, t)
        if e in ctx.agg_map and not ctx.in_aggregate:
            sym, t = ctx.agg_map[e]
            return InputRef(sym, t)
        if e in ctx.key_map:
            sym = ctx.key_map[e]
            t = _symbol_type(ctx.root, sym)
            return InputRef(sym, t)

    if isinstance(e, A.Literal):
        return _plan_literal(e)
    if isinstance(e, A.IntervalLiteral):
        return _plan_interval(e)
    if isinstance(e, A.Identifier):
        if len(e.parts) == 1 and e.parts[0] in ctx.lambda_params:
            sym, t = ctx.lambda_params[e.parts[0]]
            return InputRef(sym, t)
        try:
            f, is_outer = ctx.scope.resolve(e.parts)
        except PlanningError:
            # row-field dereference: a.b where a is a row-typed column
            deref = _try_row_dereference(self, e, ctx)
            if deref is not None:
                return deref
            raise
        ref = InputRef(f.symbol, f.type)
        if not is_outer and ctx.group_symbols is not None \
                and not ctx.in_aggregate \
                and f.symbol not in ctx.group_symbols:
            raise PlanningError(
                f"Column '{'.'.join(e.parts)}' must appear in GROUP BY "
                "or be used in an aggregate function")
        return ref
    if isinstance(e, A.BinaryOp):
        return _plan_binary(self, e, ctx)
    if isinstance(e, A.UnaryOp):
        arg = self._rewrite_expr(e.operand, ctx)
        if e.op == "not":
            _require_boolean(arg, "NOT")
            return Call("not", (arg,), BOOLEAN)
        if e.op == "-":
            if isinstance(arg, Const) and is_numeric(arg.type):
                v = arg.value
                if v is None:
                    return Const(None, arg.type)
                if isinstance(v, str):   # decimal literals carry text
                    from decimal import Decimal
                    return Const(str(-Decimal(v)), arg.type)
                return Const(-v, arg.type)
            return Call("negate", (arg,), arg.type)
        return arg
    if isinstance(e, A.IsNull):
        arg = self._rewrite_expr(e.operand, ctx)
        out = Call("is_null", (arg,), BOOLEAN)
        return Call("not", (out,), BOOLEAN) if e.negated else out
    if isinstance(e, A.IsDistinctFrom):
        l = self._rewrite_expr(e.left, ctx)
        r = self._rewrite_expr(e.right, ctx)
        l, r = _coerce_pair(l, r, "IS DISTINCT FROM")
        out = Call("is_distinct_from", (l, r), BOOLEAN)
        return Call("not", (out,), BOOLEAN) if e.negated else out
    if isinstance(e, A.Between):
        op = self._rewrite_expr(e.operand, ctx)
        lo = self._rewrite_expr(e.low, ctx)
        hi = self._rewrite_expr(e.high, ctx)
        a, lo = _coerce_pair(op, lo, "BETWEEN")
        b, hi = _coerce_pair(op, hi, "BETWEEN")
        out = Call("and", (Call(">=", (a, lo), BOOLEAN),
                           Call("<=", (b, hi), BOOLEAN)), BOOLEAN)
        return Call("not", (out,), BOOLEAN) if e.negated else out
    if isinstance(e, A.InList):
        op = self._rewrite_expr(e.operand, ctx)
        eqs = []
        for item in e.items:
            it = self._rewrite_expr(item, ctx)
            a, b = _coerce_pair(op, it, "IN")
            eqs.append(Call("=", (a, b), BOOLEAN))
        out = rex.or_all(eqs)
        return Call("not", (out,), BOOLEAN) if e.negated else out
    if isinstance(e, A.InSubquery):
        op = self._rewrite_expr(e.operand, ctx)
        return self.plan_in_subquery(ctx, op, e.query, e.negated)
    if isinstance(e, A.Exists):
        return self.plan_exists(ctx, e.query, e.negated)
    if isinstance(e, A.ScalarSubquery):
        return self.plan_scalar_subquery(ctx, e.query)
    if isinstance(e, A.QuantifiedComparison):
        return self.plan_quantified(ctx, e)
    if isinstance(e, A.Like):
        op = self._rewrite_expr(e.operand, ctx)
        pat = self._rewrite_expr(e.pattern, ctx)
        if not is_string(op.type) or not is_string(pat.type):
            raise PlanningError("LIKE requires varchar operands")
        args = [op, pat]
        if e.escape is not None:
            args.append(self._rewrite_expr(e.escape, ctx))
        out = Call("like", tuple(args), BOOLEAN)
        return Call("not", (out,), BOOLEAN) if e.negated else out
    if isinstance(e, A.Case):
        whens = []
        val_types: List[Type] = []
        conds = []
        for c, v in e.whens:
            cc = self._rewrite_expr(c, ctx)
            _require_boolean(cc, "CASE WHEN")
            vv = self._rewrite_expr(v, ctx)
            conds.append(cc)
            whens.append(vv)
            val_types.append(vv.type)
        default = (self._rewrite_expr(e.default, ctx)
                   if e.default is not None else None)
        if default is not None:
            val_types.append(default.type)
        t = val_types[0]
        for vt in val_types[1:]:
            nt = common_super_type(t, vt)
            if nt is None:
                raise PlanningError(
                    f"CASE branches have incompatible types {t} / {vt}")
            t = nt
        whens = [_maybe_cast(v, t) for v in whens]
        default = _maybe_cast(default, t) if default is not None else None
        return CaseExpr(tuple(zip(conds, whens)), default, t)
    if isinstance(e, A.Cast):
        arg = self._rewrite_expr(e.operand, ctx)
        return Cast(arg, parse_type(e.type_name), e.safe)
    if isinstance(e, A.Extract):
        arg = self._rewrite_expr(e.operand, ctx)
        return Call(e.field.lower(), (arg,), BIGINT)
    if isinstance(e, A.FunctionCall):
        return _plan_function(self, e, ctx)
    if isinstance(e, A.ArrayConstructor):
        from ..types import ArrayType
        if not e.items:
            raise PlanningError("empty ARRAY[] requires a cast")
        items = [self._rewrite_expr(i, ctx) for i in e.items]
        t = items[0].type
        for it in items[1:]:
            nt = common_super_type(t, it.type)
            if nt is None:
                raise PlanningError(
                    f"ARRAY elements have incompatible types {t} / "
                    f"{it.type}")
            t = nt
        items = [_maybe_cast(i, t) for i in items]
        return Call("$array", tuple(items), ArrayType(t))
    if isinstance(e, A.RowConstructor):
        from ..types import RowType
        items = [self._rewrite_expr(i, ctx) for i in e.items]
        t = RowType([(None, i.type) for i in items])
        return Call("$row", tuple(items), t)
    if isinstance(e, A.LambdaExpression):
        raise PlanningError(
            "lambda expressions are only valid as arguments of "
            "higher-order functions (transform, filter, reduce, ...)")
    if isinstance(e, A.Subscript):
        from ..types import ArrayType, MapType, RowType
        base = self._rewrite_expr(e.base, ctx)
        idx = self._rewrite_expr(e.index, ctx)
        if isinstance(base.type, MapType):
            # m[k]: missing key yields NULL (element_at semantics; the
            # reference's strict m[k] raise cannot surface from a
            # compiled whole-column program)
            key = _maybe_cast(idx, base.type.key)
            return Call("element_at", (base, key), base.type.value)
        if isinstance(base.type, RowType):
            if not (isinstance(idx, Const) and idx.value is not None):
                raise PlanningError(
                    "ROW subscript must be a constant")
            i = int(idx.value)
            if not (1 <= i <= len(base.type.fields)):
                raise PlanningError(f"ROW subscript out of range: {i}")
            return Call("$field", (base, Const(i - 1, BIGINT)),
                        base.type.fields[i - 1][1])
        if not isinstance(base.type, ArrayType):
            raise PlanningError(
                f"subscript requires an array (got {base.type})")
        # constant non-positive subscripts error at plan time (the
        # reference's runtime errors, hoisted); data-dependent indexes
        # diverge: out of range yields NULL (element_at semantics)
        # because raises can't surface from inside a compiled
        # whole-column XLA program (SURVEY.md §7.2 static-shape rule)
        if isinstance(idx, Const) and idx.value is not None \
                and int(idx.value) <= 0:
            raise PlanningError(
                "Array subscript must be positive: SQL array indices "
                "start at 1")
        return Call("element_at", (base, idx), base.type.element)
    if isinstance(e, A.Star):
        raise PlanningError("'*' not allowed here")
    raise PlanningError(f"unsupported expression {type(e).__name__}")


LogicalPlanner._rewrite_expr = _rewrite_expr


def _try_row_dereference(self: LogicalPlanner, e: A.Identifier,
                         ctx: _ExprContext):
    """Resolve a.b / t.a.b where the prefix is a ROW-typed column and the
    suffix names fields (reference: ExpressionAnalyzer dereference
    resolution, sql/planner/iterative/rule/PushDownDereference*)."""
    from ..types import RowType
    parts = e.parts
    for cut in range(len(parts) - 1, 0, -1):
        base = None
        prefix = parts[:cut]
        if len(prefix) == 1 and prefix[0] in ctx.lambda_params:
            sym, t = ctx.lambda_params[prefix[0]]
            base = InputRef(sym, t)
        else:
            f, _ = ctx.scope.try_resolve(prefix)
            if f is not None:
                base = InputRef(f.symbol, f.type)
        if base is None:
            continue
        expr = base
        ok = True
        for fld in parts[cut:]:
            if not isinstance(expr.type, RowType):
                ok = False
                break
            idx = None
            for i, (fn, ft) in enumerate(expr.type.fields):
                if fn is not None and fn.lower() == fld.lower():
                    idx = i
                    break
            if idx is None:
                ok = False
                break
            expr = Call("$field", (expr, Const(idx, BIGINT)),
                        expr.type.fields[idx][1])
        if ok:
            return expr
    return None


# higher-order (lambda-taking) functions and the positions of their
# lambda arguments (reference: operator/scalar/ArrayTransformFunction
# and friends, SURVEY.md Appendix A.10)
_HIGHER_ORDER = {"transform", "filter", "reduce", "any_match",
                 "all_match", "none_match", "zip_with", "map_filter",
                 "transform_keys", "transform_values", "map_zip_with"}


def _plan_lambda(self: LogicalPlanner, lam: A.LambdaExpression,
                 ctx: _ExprContext, param_types) -> Lambda:
    if len(lam.params) != len(param_types):
        raise PlanningError(
            f"lambda has {len(lam.params)} parameters, expected "
            f"{len(param_types)}")
    saved = dict(ctx.lambda_params)
    syms = []
    for p, t in zip(lam.params, param_types):
        sym = self.symbols.new("lam_" + p)
        ctx.lambda_params[p] = (sym, t)
        syms.append(sym)
    try:
        body = self._rewrite_expr(lam.body, ctx)
    finally:
        ctx.lambda_params.clear()
        ctx.lambda_params.update(saved)
    return Lambda(tuple(syms), body, body.type)


def _plan_higher_order(self: LogicalPlanner, e: A.FunctionCall,
                       ctx: _ExprContext) -> RowExpr:
    from ..types import ArrayType, BOOLEAN as _B, MapType
    name = e.name

    def arr_of(i):
        a = self._rewrite_expr(e.args[i], ctx)
        if not isinstance(a.type, ArrayType):
            raise PlanningError(f"{name} argument {i + 1} must be an "
                                f"array (got {a.type})")
        return a

    def map_of(i):
        m = self._rewrite_expr(e.args[i], ctx)
        if not isinstance(m.type, MapType):
            raise PlanningError(f"{name} argument {i + 1} must be a map "
                                f"(got {m.type})")
        return m

    def lam(i, ptypes):
        a = e.args[i]
        if not isinstance(a, A.LambdaExpression):
            raise PlanningError(
                f"{name} argument {i + 1} must be a lambda")
        return _plan_lambda(self, a, ctx, ptypes)

    if name == "transform":
        a = arr_of(0)
        fn = lam(1, [a.type.element])
        return Call(name, (a, fn), ArrayType(fn.type))
    if name == "filter":
        a = arr_of(0)
        fn = lam(1, [a.type.element])
        _require_boolean(fn.body, "filter lambda")
        return Call(name, (a, fn), a.type)
    if name in ("any_match", "all_match", "none_match"):
        a = arr_of(0)
        fn = lam(1, [a.type.element])
        _require_boolean(fn.body, f"{name} lambda")
        return Call(name, (a, fn), BOOLEAN)
    if name == "reduce":
        a = arr_of(0)
        init = self._rewrite_expr(e.args[1], ctx)
        step = lam(2, [init.type, a.type.element])
        state_t = common_super_type(init.type, step.type) or step.type
        if state_t != step.type:
            # re-plan the step with the widened state type
            step = lam(2, [state_t, a.type.element])
        out = lam(3, [state_t])
        return Call(name, (a, _maybe_cast(init, state_t), step, out),
                    out.type)
    if name == "zip_with":
        a, b = arr_of(0), arr_of(1)
        fn = lam(2, [a.type.element, b.type.element])
        return Call(name, (a, b, fn), ArrayType(fn.type))
    if name == "map_filter":
        m = map_of(0)
        fn = lam(1, [m.type.key, m.type.value])
        _require_boolean(fn.body, "map_filter lambda")
        return Call(name, (m, fn), m.type)
    if name == "transform_keys":
        m = map_of(0)
        fn = lam(1, [m.type.key, m.type.value])
        return Call(name, (m, fn), MapType(fn.type, m.type.value))
    if name == "transform_values":
        m = map_of(0)
        fn = lam(1, [m.type.key, m.type.value])
        return Call(name, (m, fn), MapType(m.type.key, fn.type))
    if name == "map_zip_with":
        m1, m2 = map_of(0), map_of(1)
        k = common_super_type(m1.type.key, m2.type.key)
        if k is None:
            raise PlanningError("map_zip_with keys are incompatible")
        fn = lam(2, [k, m1.type.value, m2.type.value])
        return Call(name, (m1, m2, fn), MapType(k, fn.type))
    raise PlanningError(f"unsupported higher-order function {name}")


def _plan_function(self: LogicalPlanner, e: A.FunctionCall,
                   ctx: _ExprContext) -> RowExpr:
    name = e.name
    if e.window is not None:
        raise PlanningError(
            f"window function '{name}' used outside SELECT list")
    if name == "$field":
        # parser-desugared row dereference on a non-identifier base
        from ..types import RowType
        base = self._rewrite_expr(e.args[0], ctx)
        fld = e.args[1].value
        if not isinstance(base.type, RowType):
            raise PlanningError(
                f"cannot dereference .{fld} on {base.type}")
        for i, (fn_, ft) in enumerate(base.type.fields):
            if fn_ is not None and fn_.lower() == str(fld).lower():
                return Call("$field", (base, Const(i, BIGINT)), ft)
        raise PlanningError(f"row has no field named '{fld}'")
    if name in _HIGHER_ORDER and any(
            isinstance(a, A.LambdaExpression) for a in e.args):
        return _plan_higher_order(self, e, ctx)
    if name == "grouping":
        # grouping(c1, .., cn): bitmask with bit (n-1-i) set when ci is
        # NOT grouped in this row's grouping set (reference:
        # sql/analyzer + GroupingOperationRewriter — decoded here from
        # the GroupIdNode set index; constant 0 for plain GROUP BY)
        if ctx.group_symbols is None and not ctx.agg_map:
            raise PlanningError("grouping() requires GROUP BY")
        info = getattr(ctx, "grouping_info", None)
        arg_refs = []
        for a in e.args:
            r = self._rewrite_expr(a, ctx)
            if not isinstance(r, InputRef):
                raise PlanningError(
                    "grouping() arguments must be grouping expressions")
            arg_refs.append(r.name)
        if info is None:
            return Const(0, BIGINT)
        id_sym, set_syms = info
        from ..rex import CaseExpr
        whens = []
        for k, sset in enumerate(set_syms):
            mask = 0
            for s in arg_refs:
                mask = (mask << 1) | (0 if s in sset else 1)
            whens.append((Call("=", (InputRef(id_sym, BIGINT),
                                     Const(k, BIGINT)), BOOLEAN),
                          Const(mask, BIGINT)))
        return CaseExpr(tuple(whens), Const(None, BIGINT), BIGINT)
    if is_aggregate(name):
        if ctx.group_symbols is None and not ctx.agg_map:
            raise PlanningError(
                f"aggregate '{name}' not allowed here")
        raise PlanningError(f"unexpected unmapped aggregate '{name}'")
    args = tuple(self._rewrite_expr(a, ctx) for a in e.args)
    if name in ("if",) and len(args) == 2:
        args = args + (Const(None, args[1].type),)
    try:
        rtype = scalar_result_type(name, [a.type for a in args])
    except FunctionResolutionError as exc:
        raise PlanningError(str(exc)) from None
    # coerce numeric args of variadic common-type functions
    if name in ("coalesce", "greatest", "least", "if"):
        tgt = rtype
        head = args[:1] if name == "if" else ()
        tail = args[1:] if name == "if" else args
        args = tuple(head) + tuple(_maybe_cast(a, tgt) for a in tail)
    return Call(name, args, rtype)


def _plan_literal(e: A.Literal) -> Const:
    v = e.value
    if e.type_name == "decimal" and not isinstance(v, (int, float)):
        # bare decimal literal: infer (precision, scale) from the text
        # (reference: Literal analysis in ExpressionAnalyzer — "1.5" is
        # DECIMAL(2,1), never the parse_type default decimal(38,0))
        from decimal import Decimal as _D
        d = _D(str(v))
        tup = d.as_tuple()
        scale = max(0, -tup.exponent)
        precision = max(len(tup.digits), scale, 1)
        return Const(str(v), DecimalType(precision, scale))
    if e.type_name is not None:
        t = parse_type(e.type_name)
        if t is DATE:
            import datetime
            d = datetime.date.fromisoformat(str(v).strip())
            return Const(d.toordinal()
                         - datetime.date(1970, 1, 1).toordinal(), DATE)
        if isinstance(t, TimestampType):
            from ..types import TimestampTZType, iso_timestamp_tz
            ms, off = iso_timestamp_tz(str(v))
            if off is None:
                return Const(ms, t)
            return Const((ms, off), TimestampTZType(t.precision))
        from ..types import TimestampTZType as _TTZ
        if isinstance(t, _TTZ):
            from ..types import iso_timestamp_tz
            ms, off = iso_timestamp_tz(str(v))
            return Const((ms, off or 0), t)
        from ..types import TimeType as _TimeType
        if isinstance(t, _TimeType):
            from ..types import iso_time_millis
            return Const(iso_time_millis(str(v)), t)
        if isinstance(t, DecimalType):
            return Const(v, t)
        return Const(v, t)
    if v is None:
        return Const(None, UNKNOWN)
    if isinstance(v, bool):
        return Const(v, BOOLEAN)
    if isinstance(v, int):
        t = INTEGER if -(2**31) <= v < 2**31 else BIGINT
        return Const(v, t)
    if isinstance(v, float):
        # decimal literals parse as DOUBLE (reference FeaturesConfig
        # parse-decimal-literals-as-double mode)
        return Const(v, DOUBLE)
    if isinstance(v, str):
        return Const(v, VarcharType(len(v)))
    raise PlanningError(f"cannot type literal {v!r}")


def _plan_interval(e: A.IntervalLiteral) -> Const:
    n = int(e.value) * e.sign
    u = e.unit.lower()
    if u in ("year", "month", "quarter"):
        months = n * {"year": 12, "quarter": 3, "month": 1}[u]
        return Const(months, IntervalYearMonth)
    millis = n * {"day": 86400000, "hour": 3600000, "minute": 60000,
                  "second": 1000, "week": 7 * 86400000}[u]
    return Const(millis, IntervalDayTime)


_CMP = {"=", "<>", "!=", "<", "<=", ">", ">="}
_ARITH = {"+", "-", "*", "/", "%"}


def _plan_binary(self: LogicalPlanner, e: A.BinaryOp,
                 ctx: _ExprContext) -> RowExpr:
    op = e.op
    l = self._rewrite_expr(e.left, ctx)
    r = self._rewrite_expr(e.right, ctx)
    if op in ("and", "or"):
        _require_boolean(l, op.upper())
        _require_boolean(r, op.upper())
        return Call(op, (l, r), BOOLEAN)
    if op == "||":
        if is_string(l.type) and is_string(r.type):
            return Call("concat", (l, r), VARCHAR)
        raise PlanningError(f"|| not supported for {l.type}, {r.type}")
    if op in _CMP:
        op = "<>" if op == "!=" else op
        l2, r2 = _coerce_pair(l, r, op)
        return Call(op, (l2, r2), BOOLEAN)
    if op in _ARITH:
        # date/timestamp ± interval
        if l.type is DATE and r.type in (IntervalDayTime,
                                         IntervalYearMonth):
            return Call(f"date_{'add' if op == '+' else 'sub'}_interval",
                        (l, r), DATE)
        if isinstance(l.type, TimestampType) and r.type in (
                IntervalDayTime, IntervalYearMonth):
            return Call(f"ts_{'add' if op == '+' else 'sub'}_interval",
                        (l, r), l.type)
        if l.type is DATE and r.type is DATE and op == "-":
            return Call("date_diff_days", (l, r), BIGINT)
        if not (is_numeric(l.type) and is_numeric(r.type)):
            raise PlanningError(
                f"'{op}' not supported for {l.type}, {r.type}")
        t = _arith_type(op, l.type, r.type)
        l2, r2 = _maybe_cast(l, t), _maybe_cast(r, t)
        if isinstance(t, DecimalType):
            # operate on scaled int lanes; executor knows the scales
            return Call(f"decimal_{op}", (l, r), t)
        return Call(op, (l2, r2), t)
    raise PlanningError(f"unknown operator '{op}'")


def _arith_type(op: str, a: Type, b: Type) -> Type:
    """sql/planner result types for arithmetic
    (reference: spi/type/DecimalOperators precision math)."""
    if a.name == "double" or b.name == "double":
        return DOUBLE
    if a.name == "real" or b.name == "real":
        from ..types import REAL
        return REAL
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        from ..types import default_decimal_for
        da = a if isinstance(a, DecimalType) else default_decimal_for(a)
        db = b if isinstance(b, DecimalType) else default_decimal_for(b)
        if op in ("+", "-"):
            s = max(da.scale, db.scale)
            p = min(38, max(da.precision - da.scale,
                            db.precision - db.scale) + s + 1)
            return DecimalType(p, s)
        if op == "*":
            return DecimalType(min(38, da.precision + db.precision),
                               min(38, da.scale + db.scale))
        if op == "/":
            s = max(6, da.scale)
            return DecimalType(38, s)
        if op == "%":
            return DecimalType(max(da.precision, db.precision),
                               max(da.scale, db.scale))
    t = common_super_type(a, b)
    if t is None:
        raise PlanningError(f"no common type for {a}, {b}")
    return t


def _coerce_pair(l: RowExpr, r: RowExpr, what: str):
    t = common_super_type(l.type, r.type)
    if t is None:
        raise PlanningError(
            f"{what}: incompatible types {l.type} and {r.type}")
    return _maybe_cast(l, t), _maybe_cast(r, t)


def _maybe_cast(e: RowExpr, t: Type) -> RowExpr:
    if e.type == t or e.type == UNKNOWN and isinstance(e, Const) \
            and e.value is None:
        if e.type == UNKNOWN and isinstance(e, Const):
            return Const(None, t)
        return e
    if isinstance(e, Const) and e.value is not None:
        folded = _fold_cast_const(e, t)
        if folded is not None:
            return folded
    return Cast(e, t)


def _fold_cast_const(e: Const, t: Type) -> Optional[Const]:
    v = e.value
    try:
        if t.name == "double":
            return Const(float(v), t)
        if t.name == "real":
            import numpy as np
            return Const(float(np.float32(v)), t)
        if is_integral(t):
            return Const(int(v), t)
        if isinstance(t, DecimalType):
            return Const(v, t)
        if is_string(t) and isinstance(v, str):
            return Const(v, t)
    except (TypeError, ValueError):
        return None
    return None


def _derive_name(e: A.Expression) -> Optional[str]:
    if isinstance(e, A.Identifier):
        return e.parts[-1].lower()
    if isinstance(e, A.FunctionCall):
        return e.name
    if isinstance(e, A.Extract):
        return e.field.lower()
    if isinstance(e, A.Cast):
        return _derive_name(e.operand)
    return None


def _symbol_type(root: PlanNode, sym: str) -> Type:
    return root.output_schema()[sym]


def _const_fold(e: RowExpr) -> RowExpr:
    """Minimal constant folding for VALUES (full interpreter parity with
    sql/planner/ExpressionInterpreter.java is executor-side)."""
    if isinstance(e, Const):
        return e
    if isinstance(e, Cast):
        inner = _const_fold(e.arg)
        if isinstance(inner, Const):
            if inner.value is None:
                return Const(None, e.type)
            folded = _fold_cast_const(inner, e.type)
            if folded is not None:
                return folded
    if isinstance(e, Call):
        args = [_const_fold(a) for a in e.args]
        if all(isinstance(a, Const) for a in args):
            vals = [a.value for a in args]
            if any(v is None for v in vals):
                return Const(None, e.type)
            try:
                if e.fn == "+":
                    return Const(vals[0] + vals[1], e.type)
                if e.fn == "-":
                    return Const(vals[0] - vals[1], e.type)
                if e.fn == "*":
                    return Const(vals[0] * vals[1], e.type)
                if e.fn == "/":
                    if is_integral(e.type):
                        q = abs(vals[0]) // abs(vals[1])
                        if (vals[0] < 0) != (vals[1] < 0):
                            q = -q
                        return Const(q, e.type)
                    return Const(vals[0] / vals[1], e.type)
                if e.fn == "negate":
                    return Const(-vals[0], e.type)
                if e.fn == "concat":
                    return Const("".join(vals), e.type)
            except (TypeError, ZeroDivisionError):
                pass
    return e


# --------------------------------------------------------------------------
# decorrelation helpers (TransformCorrelated* rules, at plan time)
# --------------------------------------------------------------------------

def _all_symbols(node: Optional[PlanNode]) -> Set[str]:
    if node is None:
        return set()
    syms = set(node.output_schema())
    for s in node.sources:
        syms |= _all_symbols(s)
    return syms


def _correlated_symbols(node: PlanNode, outer_syms: Set[str]) -> Set[str]:
    """Outer symbols referenced free inside the subquery plan."""
    used: Set[str] = set()

    def visit(n: PlanNode):
        produced = set()
        for s in n.sources:
            visit(s)
            produced |= set(s.output_schema())
        exprs: List[RowExpr] = []
        if isinstance(n, FilterNode):
            exprs.append(n.predicate)
        elif isinstance(n, ProjectNode):
            exprs.extend(n.assignments.values())
        elif isinstance(n, JoinNode) and n.filter is not None:
            exprs.append(n.filter)
        for e in exprs:
            for name in rex.input_names(e):
                if name not in produced and name in outer_syms:
                    used.add(name)

    visit(node)
    return used


def _decorrelate_scalar_agg(root: PlanNode, corr: Set[str], symbols):
    """TransformCorrelatedScalarAggregationToJoin: rewrite
      [Project] -> Aggregation(global) -> tree-with-correlated-filters
    into an aggregation grouped by the inner correlation keys; returns
    (new_root, [(outer_sym, inner_sym)])."""
    # peel projects above the aggregation
    projects: List[ProjectNode] = []
    node = root
    while isinstance(node, ProjectNode):
        projects.append(node)
        node = node.source
    if not isinstance(node, AggregationNode) or node.group_keys:
        raise PlanningError(
            "correlated scalar subquery must be a single aggregate "
            "(decorrelation pattern not supported)")
    agg = node
    stripped, pairs = _strip_correlated_filters(agg.source, corr)
    if not pairs:
        raise PlanningError(
            "could not extract equality correlation from subquery")
    inner_keys = tuple(dict.fromkeys(i for _, i in pairs))
    new_agg = AggregationNode(stripped, inner_keys, agg.aggregates,
                              agg.step)
    new_root: PlanNode = new_agg
    # re-apply projects, widened to carry the correlation keys through
    for p in reversed(projects):
        assigns = dict(p.assignments)
        schema = new_root.output_schema()
        for k in inner_keys:
            assigns.setdefault(k, InputRef(k, schema[k]))
        new_root = ProjectNode(new_root, assigns)
    return new_root, [(o, i) for o, i in pairs]


def _decorrelate_exists(root: PlanNode, corr: Set[str], symbols):
    """Correlated EXISTS -> semi-join shape: strip correlated conjuncts;
    equality pairs become join keys, the rest becomes a residual filter
    over (outer ∪ inner) columns."""
    stripped, pairs, residual = _strip_correlated_filters(
        root, corr, allow_residual=True)
    if not pairs and residual is None:
        raise PlanningError(
            "could not extract correlation from EXISTS subquery")
    return stripped, pairs, residual


def _strip_correlated_filters(node: PlanNode, corr: Set[str],
                              allow_residual: bool = False):
    """Remove conjuncts referencing outer symbols from Filter nodes in the
    subtree. Returns (new_node, [(outer_sym, inner_sym)]) and optionally a
    residual expression (conjuncts that are correlated but not simple
    equalities)."""
    pairs: List[Tuple[str, str]] = []
    residuals: List[RowExpr] = []

    def visit(n: PlanNode) -> PlanNode:
        if isinstance(n, FilterNode):
            src = visit(n.source)
            keep: List[RowExpr] = []
            # normalize (A and X) or (A and Y) -> A and (X or Y) first:
            # q41-style subqueries repeat the correlated conjunct inside
            # every OR arm, and only the factored form decorrelates
            from .optimizer import _split_normalized
            for c in _split_normalized(n.predicate):
                refs = rex.input_names(c)
                if refs & corr:
                    pair = _as_correlation_pair(c, corr)
                    if pair is not None:
                        pairs.append(pair)
                    elif allow_residual:
                        residuals.append(c)
                    else:
                        raise PlanningError(
                            "unsupported correlated predicate: "
                            f"{c}")
                else:
                    keep.append(c)
            if keep:
                return FilterNode(src, rex.and_all(keep))
            return src
        if isinstance(n, ProjectNode):
            src = visit(n.source)
            # widen projection to keep correlation key symbols visible
            assigns = dict(n.assignments)
            schema = src.output_schema()
            for _, i in pairs:
                if i not in assigns and i in schema:
                    assigns[i] = InputRef(i, schema[i])
            if residuals:
                for r in residuals:
                    for name in rex.input_names(r):
                        if name not in assigns and name in schema:
                            assigns[name] = InputRef(name, schema[name])
            return ProjectNode(src, assigns)
        if isinstance(n, (JoinNode,)):
            return dc_replace(n, left=visit(n.left), right=visit(n.right))
        if isinstance(n, (AggregationNode,)):
            src = visit(n.source)
            gk = n.group_keys
            extra = tuple(i for _, i in pairs if i not in gk
                          and i in src.output_schema())
            return dc_replace(n, source=src, group_keys=gk + extra)
        if not n.sources:
            return n
        if len(n.sources) == 1:
            return dc_replace(n, source=visit(n.sources[0]))
        return n

    new = visit(node)
    if allow_residual:
        return new, pairs, (rex.and_all(residuals) if residuals else None)
    return new, pairs


def _as_correlation_pair(c: RowExpr, corr: Set[str]):
    """Match `outer_sym = inner_sym` (modulo argument order)."""
    if isinstance(c, Call) and c.fn == "=" and len(c.args) == 2:
        a, b = c.args
        if isinstance(a, InputRef) and isinstance(b, InputRef):
            if a.name in corr and b.name not in corr:
                return (a.name, b.name)
            if b.name in corr and a.name not in corr:
                return (b.name, a.name)
    return None


def _extract_equi_criteria(on_expr: RowExpr, lsyms: Set[str],
                           rsyms: Set[str]):
    """Split a join condition into equi-clauses (left expr, right expr)
    and residual conjuncts (reference: JoinNode criteria extraction in
    RelationPlanner + ExtractCommonPredicates)."""
    criteria: List[Tuple[RowExpr, RowExpr]] = []
    residual: List[RowExpr] = []
    for c in rex.split_conjuncts(on_expr):
        ok = False
        if isinstance(c, Call) and c.fn == "=" and len(c.args) == 2:
            a, b = c.args
            ra, rb = rex.input_names(a), rex.input_names(b)
            if ra and rb:
                if ra <= lsyms and rb <= rsyms:
                    criteria.append((a, b))
                    ok = True
                elif ra <= rsyms and rb <= lsyms:
                    criteria.append((b, a))
                    ok = True
        if not ok:
            residual.append(c)
    return criteria, residual
