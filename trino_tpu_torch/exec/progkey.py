"""Canonical program keys: plan chains rewritten over canonical symbols.

Counterpart of ``trino_tpu/exec/progkey.py`` (host only). A chain of
plan nodes is rewritten over canonical symbol names (``c0, c1, ...`` in
execution-order first use), so two plans that differ only in the
planner's symbol numbering or column order get one key. The port has
no compiled-program caches; the key is the identity that the result
cache (exec/resultcache.py), the learned statistics
(exec/learnedstats.py, through ``node_fingerprint``) and the hot-shape
registry (exec/hotshapes.py) share. A ``Binding`` renames a plan's
columns to the canonical names and back; ``wire_fragment`` and
``peel_wire_fragment`` carry a canonical stack in plan/serde's wire form
(the pre-warm's payload, exec/aot.py). Constant
literals are canonicalized to their typed planner values but never
erased: different constants are different programs.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

from ..columnar import Batch
from ..plan.nodes import (Aggregate, AggregationNode, AssignUniqueIdNode,
                          FilterNode, LimitNode, MarkDistinctNode,
                          OffsetNode, PlanNode, ProjectNode,
                          RemoteSourceNode, SampleNode, SortKey,
                          SortNode, TopNNode, WindowFunction, WindowNode)
from ..rex import (VOLATILE_FNS, Call, CaseExpr, Cast, Const, InputRef,
                   Lambda, RowExpr)


class _NotCanonical(Exception):
    """Node/expression outside the canonicalizable subset (volatile
    calls, unknown node kinds): callers fall back to identity keys."""


class _SymbolMap:
    """Deterministic symbol renaming: first use (in execution order)
    wins ``c<i>``. The map is a bijection — two distinct source
    symbols can never alias one canonical name."""

    __slots__ = ("names",)

    def __init__(self) -> None:
        self.names: Dict[str, str] = {}

    def sym(self, name: str) -> str:
        got = self.names.get(name)
        if got is None:
            got = f"c{len(self.names)}"
            self.names[name] = got
        return got


def _canon_expr(e: RowExpr, m: _SymbolMap) -> RowExpr:
    if isinstance(e, InputRef):
        return InputRef(m.sym(e.name), e.type)
    if isinstance(e, Const):
        return e
    if isinstance(e, Call):
        if e.fn in VOLATILE_FNS:
            raise _NotCanonical(e.fn)
        return Call(e.fn, tuple(_canon_expr(a, m) for a in e.args),
                    e.type)
    if isinstance(e, Cast):
        return Cast(_canon_expr(e.arg, m), e.type, e.safe)
    if isinstance(e, CaseExpr):
        return CaseExpr(tuple((_canon_expr(c, m), _canon_expr(v, m))
                              for c, v in e.whens),
                        None if e.default is None
                        else _canon_expr(e.default, m), e.type)
    if isinstance(e, Lambda):
        # lambda params are fresh symbols referenced via InputRef in
        # the body — they rename through the same map
        return Lambda(tuple(m.sym(p) for p in e.params),
                      _canon_expr(e.body, m), e.type)
    raise _NotCanonical(type(e).__name__)


def _canon_aggregate(a: Aggregate, m: _SymbolMap) -> Aggregate:
    return Aggregate(
        a.kind,
        None if a.argument is None else m.sym(a.argument),
        a.type, a.distinct,
        None if a.mask is None else m.sym(a.mask),
        None if a.argument2 is None else m.sym(a.argument2),
        a.param)


def _canon_node(nd: PlanNode, m: _SymbolMap) -> PlanNode:
    """Rebuild one chain node over canonical symbols (source link left
    untouched — chain execution dispatches per node, never through
    ``.source``)."""
    if isinstance(nd, FilterNode):
        return dc_replace(nd, predicate=_canon_expr(nd.predicate, m))
    if isinstance(nd, ProjectNode):
        # input symbols rename before output symbols: every InputRef of
        # every assignment maps first, THEN the assignment targets —
        # keeps pass-through projections (x -> x) idempotent
        exprs = {s: _canon_expr(e, m) for s, e in nd.assignments.items()}
        return dc_replace(nd, assignments={m.sym(s): e
                                           for s, e in exprs.items()})
    if isinstance(nd, (SampleNode, LimitNode, OffsetNode)):
        return nd
    if isinstance(nd, SortNode):
        return dc_replace(nd, keys=tuple(
            SortKey(m.sym(k.symbol), k.ascending, k.nulls_first)
            for k in nd.keys))
    if isinstance(nd, TopNNode):
        return dc_replace(nd, keys=tuple(
            SortKey(m.sym(k.symbol), k.ascending, k.nulls_first)
            for k in nd.keys))
    if isinstance(nd, AssignUniqueIdNode):
        return dc_replace(nd, symbol=m.sym(nd.symbol))
    if isinstance(nd, MarkDistinctNode):
        return dc_replace(nd, keys=tuple(m.sym(k) for k in nd.keys),
                          marker=m.sym(nd.marker))
    if isinstance(nd, AggregationNode):
        if nd.group_id_symbol is not None:
            raise _NotCanonical("grouping-set aggregation")
        return dc_replace(
            nd,
            group_keys=tuple(m.sym(k) for k in nd.group_keys),
            aggregates={m.sym(out): _canon_aggregate(a, m)
                        for out, a in nd.aggregates.items()})
    if isinstance(nd, WindowNode):
        # inputs before outputs (same discipline as ProjectNode):
        # partition/order keys and per-function argument symbols map
        # first, then the function output symbols
        part = tuple(m.sym(s) for s in nd.partition_by)
        order = tuple(SortKey(m.sym(k.symbol), k.ascending,
                              k.nulls_first) for k in nd.order_by)
        fns = {out: _canon_window_fn(f, m)
               for out, f in nd.functions.items()}
        return dc_replace(nd, partition_by=part, order_by=order,
                          functions={m.sym(out): f
                                     for out, f in fns.items()})
    raise _NotCanonical(type(nd).__name__)


def _canon_window_fn(f: WindowFunction, m: _SymbolMap) -> WindowFunction:
    return dc_replace(
        f,
        argument=None if f.argument is None else m.sym(f.argument),
        offset=None if f.offset is None else m.sym(f.offset),
        default=None if f.default is None else m.sym(f.default))


def node_fingerprint(nd: PlanNode) -> Optional[tuple]:
    """Serialize every field an evaluation of this node depends
    on (row expressions are frozen dataclasses — repr() is total).
    Returns None for node types outside the whitelist or volatile
    expressions; callers fall back to per-query identity keys. A
    collision between genuinely different plans would reuse the wrong
    program, so any new field on these nodes MUST be added here."""
    from ..rex import expr_volatile
    if isinstance(nd, FilterNode):
        if expr_volatile(nd.predicate):
            return None
        return ("F", repr(nd.predicate))
    if isinstance(nd, ProjectNode):
        if any(expr_volatile(e) for e in nd.assignments.values()):
            return None
        return ("P", tuple((s, repr(e))
                           for s, e in nd.assignments.items()))
    if isinstance(nd, SampleNode):
        return ("S", nd.method, nd.ratio)
    if isinstance(nd, LimitNode):
        return ("L", nd.count, nd.partial)
    if isinstance(nd, OffsetNode):
        return ("O", nd.count)
    if isinstance(nd, SortNode):
        return ("So", nd.keys)
    if isinstance(nd, TopNNode):
        return ("T", nd.count, nd.keys, nd.step)
    if isinstance(nd, AssignUniqueIdNode):
        return ("U", nd.symbol)
    if isinstance(nd, MarkDistinctNode):
        return ("M", nd.marker, nd.keys)
    if isinstance(nd, AggregationNode):
        return ("A", tuple(nd.group_keys), nd.step, nd.group_id_symbol,
                tuple((out, a.kind, a.argument, a.argument2, a.mask,
                       a.distinct, a.param, repr(a.type))
                      for out, a in nd.aggregates.items()))
    if isinstance(nd, WindowNode):
        return ("W", tuple(nd.partition_by), nd.order_by,
                tuple((out, f.kind, f.argument, repr(f.type),
                       f.frame_unit, f.frame_start, f.frame_end,
                       f.offset, f.default, f.frame_start_value,
                       f.frame_end_value)
                      for out, f in nd.functions.items()))
    return None


class Binding:
    """Per-plan rename shim around one canonical program: input columns
    to canonical names before the call, canonical output names back to
    this plan's after it. Columns the chain never references
    (pass-through lanes under a filter) extend the map in sorted
    original-name order, so every split of one scan binds alike."""

    __slots__ = ("fwd", "inv")

    def __init__(self, mapping: Dict[str, str],
                 columns: Sequence[str]) -> None:
        self.fwd = dict(mapping)
        for name in sorted(c for c in columns if c not in self.fwd):
            self.fwd[name] = f"x{len(self.fwd)}"
        self.inv = {v: k for k, v in self.fwd.items()}

    def rename_in(self, b: Batch) -> Batch:
        cols = sorted(b.columns, key=lambda c: self.fwd[c])
        return Batch({self.fwd[c]: b.columns[c] for c in cols},
                     b.num_rows)

    def rename_out(self, b: Batch) -> Batch:
        return Batch({self.inv.get(s, s): c
                      for s, c in b.columns.items()}, b.num_rows)


class CanonicalProgram:
    """A canonicalized node stack (top-down order), its key and the
    plan's symbol map."""

    __slots__ = ("key", "nodes", "mapping")

    def __init__(self, key: tuple, nodes: List[PlanNode],
                 mapping: Dict[str, str]) -> None:
        self.key = key
        self.nodes = nodes          # top-down
        self.mapping = mapping      # original symbol -> canonical

    def binding(self, b: Batch) -> Binding:
        return Binding(self.mapping, list(b.columns))

    def wire_fragment(self, input_schema: Dict[str, object]) -> dict:
        """The canonical stack as a plan fragment rooted in its top node
        over a schema-carrying RemoteSourceNode leaf (plan/serde.py): the
        hot-shape registry's transport form, which a pre-warming worker
        decodes back into the nodes it runs (exec/aot.py)."""
        from ..plan.serde import to_jsonable
        body: PlanNode = RemoteSourceNode((), dict(input_schema),
                                          "gather")
        for nd in reversed(self.nodes):
            body = dc_replace(nd, source=body)
        return to_jsonable(body)


def peel_wire_fragment(root: PlanNode) -> Tuple[List[PlanNode], Dict]:
    """Inverse of ``wire_fragment``: (top-down node stack, input schema)
    from a decoded fragment."""
    nodes: List[PlanNode] = []
    nd = root
    while not isinstance(nd, RemoteSourceNode):
        nodes.append(nd)
        nd = nd.source
    return nodes, dict(nd.schema)


def canonicalize_nodes(nodes_top_down: Sequence[PlanNode]
                       ) -> Optional[CanonicalProgram]:
    """Canonicalize a traceable node stack (top-down, the executor's
    chain order — for the streaming-aggregation program the
    AggregationNode leads). Returns None when any node or expression
    falls outside the canonical subset; callers keep per-query
    identity keys for those."""
    m = _SymbolMap()
    canon: List[PlanNode] = []
    try:
        # execution order (bottom-up): input symbols take the low
        # canonical indices, so the data-flow reading of c0.. matches
        # what the program consumes first
        for nd in reversed(list(nodes_top_down)):
            canon.append(_canon_node(nd, m))
    except _NotCanonical:
        return None
    canon.reverse()
    fps = tuple(node_fingerprint(n) for n in canon)
    if any(f is None for f in fps):
        return None
    return CanonicalProgram(fps, canon, dict(m.names))
