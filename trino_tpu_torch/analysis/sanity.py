"""Plan sanity checker: invariant validators over optimized plans.

Counterpart of ``trino_tpu/analysis/sanity.py``, with the same validators
over this package's plan nodes. It runs after every ``optimize()`` pass
when the ``plan_validation`` session property is set, and always before
the remote schedulers dispatch fragments or stages (exec/remote.py):
the fragment battery, and for a stage DAG the boundary checks of
``StageBoundaryChecker``.

Reference parity: sql/planner/sanity/PlanSanityChecker.java and its
validator battery (SURVEY.md A.4) — TypeValidator,
ValidateDependenciesChecker, NoDuplicatePlanNodeIds,
AllFunctionsResolved... The reference runs the battery after every
IterativeOptimizer pass in tests and once before execution in
production; ours runs after every ``optimize()`` pass when the
``plan_validation`` session property is set (debug mode) — a malformed
plan would otherwise surface as an error deep in execution, or worse, as
a wrong answer.

Validators (each named like its reference analog):

- ``NoDuplicatePlanNodeIds`` — the plan must be a proper tree: no node
  OBJECT may appear at two positions. Engine nodes carry no explicit
  ids (frozen dataclasses), so object identity plays the id role: a
  rewrite that grafts one subtree under two parents breaks every
  whole-tree rewriter that assumes single ownership.
- ``ValidateDependenciesChecker`` — symbol dependency closure: every
  symbol a node references (expression InputRefs, group/sort/partition
  keys, union symbol maps, ...) must exist in its sources' output
  schemas. Catches dangling InputRefs left by pruning bugs.
- ``TypeValidator`` — expression/output type consistency: InputRef
  types must agree with the source schema column they name, predicates
  must be boolean, comparisons must compare one type family, and
  set-operation symbol maps must be type-stable across branches.
- ``JoinCriteriaChecker`` — every equi-join clause must name a left
  symbol from the left source and a right symbol from the right
  source, with type agreement between the two sides (the analyzer
  inserts casts for coercions, so criteria reaching execution must
  already agree).
- ``SerdeRoundTripChecker`` (fragments only) — a fragment crossing the
  spool/exchange boundary must survive the plan wire format
  (plan/serde.py) bit-stably: encode -> JSON -> decode -> re-encode
  must reproduce the original encoding AND an equivalent plan.

A failed validator raises ``PlanValidationError`` naming the validator
and the optimizer pass that broke the invariant, and increments
``trino_tpu_plan_validation_failures_total`` (obs/metrics.py).
"""

from __future__ import annotations

import json
from dataclasses import fields as dc_fields, is_dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ..plan.nodes import (AggregationNode, ExchangeNode, FilterNode,
                          GroupIdNode, JoinNode, MarkDistinctNode,
                          OutputNode, PartitionedOutputNode, PlanNode,
                          ProjectNode, RemoteSourceNode, SemiJoinNode,
                          SetOpNode, SortNode, TableDeleteNode,
                          TableScanNode, TableWriterNode, TopNNode,
                          UnionNode, UnnestNode, ValuesNode,
                          WindowNode)
from ..rex import Call, CaseExpr, Cast, InputRef, Lambda, RowExpr
from ..types import DecimalType, Type, is_numeric, is_string
from ..obs.metrics import PLAN_VALIDATION_FAILURES, PLAN_VALIDATIONS


class PlanValidationError(Exception):
    """A plan invariant does not hold. ``validator`` names the check
    that failed (the reference's checker class name), ``pass_name`` the
    optimizer pass (or pipeline stage) after which the invariant was
    found broken — the pass is the suspect, not the plan author."""

    # errors.classify picks this up: a broken plan is the engine's
    # compiler failing its own output, never the user's fault
    error_name = "COMPILER_ERROR"

    def __init__(self, validator: str, message: str,
                 pass_name: str = ""):
        self.validator = validator
        self.pass_name = pass_name
        where = f" after pass '{pass_name}'" if pass_name else ""
        super().__init__(
            f"plan validation failed{where}: [{validator}] {message}")


class _Violation(Exception):
    """Internal: a validator's finding before it is stamped with the
    validator name + pass name."""


# --------------------------------------------------------------------------
# traversal helpers
# --------------------------------------------------------------------------

def walk_plan(node: PlanNode) -> Iterator[PlanNode]:
    yield node
    for s in node.sources:
        yield from walk_plan(s)


def _schema(node: PlanNode,
            memo: Optional[Dict[int, Dict[str, Type]]] = None
            ) -> Dict[str, Type]:
    """output_schema, with schema-derivation failures (a dangling key
    crashing a derived schema) reported as violations instead of raw
    KeyErrors. ``memo`` (id(node) -> schema) amortizes the recursive
    derivation across a battery run — every validator visits every
    node, so uncached schemas would be recomputed once per validator
    per reference."""
    if memo is not None:
        got = memo.get(id(node))
        if got is not None:
            return got
    try:
        out = node.output_schema()
    except KeyError as e:
        raise _Violation(
            f"{type(node).__name__}: output schema references unknown "
            f"symbol {str(e)}") from e
    if memo is not None:
        memo[id(node)] = out
    return out


def _env(node: PlanNode,
         memo: Optional[Dict[int, Dict[str, Type]]] = None
         ) -> Dict[str, Type]:
    """Union of the node's source schemas (later sources win, like
    JoinNode.output_schema)."""
    env: Dict[str, Type] = {}
    for s in node.sources:
        env.update(_schema(s, memo))
    return env


def _node_label(node: PlanNode) -> str:
    return type(node).__name__


# --------------------------------------------------------------------------
# type agreement
# --------------------------------------------------------------------------

def _family(t: Type) -> str:
    """Comparison family: values of one family are mutually comparable
    after the analyzer's implicit coercions."""
    name = getattr(t, "name", "")
    base = name.split("(")[0]
    if is_string(t) or base in ("varchar", "char", "json"):
        return "string"
    if is_numeric(t) or isinstance(t, DecimalType):
        return "numeric"
    if base in ("date",) or base.startswith("timestamp") \
            or base.startswith("time"):
        return "temporal"
    if base == "boolean":
        return "boolean"
    if base == "unknown":
        return "unknown"   # typed NULL compares with anything
    return base


def types_agree(a: Type, b: Type) -> bool:
    """Loose agreement for symbol references: exact equality, or the
    same parametric base (varchar lengths may differ between a scan
    schema and a projected reference), or the same comparison family
    for families whose physical lanes are interchangeable."""
    if a == b:
        return True
    fa, fb = _family(a), _family(b)
    if "unknown" in (fa, fb):
        return True
    return fa == fb


def comparable(a: Type, b: Type) -> bool:
    fa, fb = _family(a), _family(b)
    return fa == fb or "unknown" in (fa, fb)


# --------------------------------------------------------------------------
# expression walking (lambda-aware)
# --------------------------------------------------------------------------

_CMPS = ("=", "<>", "<", "<=", ">", ">=")


def _check_expr(e: RowExpr, env: Dict[str, Type], where: str,
                bound: frozenset = frozenset()) -> None:
    if isinstance(e, InputRef):
        if e.name in bound:
            return
        t = env.get(e.name)
        if t is not None and not types_agree(e.type, t):
            raise _Violation(
                f"{where}: InputRef '{e.name}' carries type {e.type} "
                f"but the source column is {t}")
        return
    if isinstance(e, Call):
        if e.fn in _CMPS and len(e.args) == 2:
            ta, tb = e.args[0].type, e.args[1].type
            if not comparable(ta, tb):
                raise _Violation(
                    f"{where}: comparison '{e.fn}' over incomparable "
                    f"types {ta} and {tb}")
        for a in e.args:
            _check_expr(a, env, where, bound)
        return
    if isinstance(e, Cast):
        _check_expr(e.arg, env, where, bound)
        return
    if isinstance(e, Lambda):
        _check_expr(e.body, env, where, bound | frozenset(e.params))
        return
    if isinstance(e, CaseExpr):
        for c, v in e.whens:
            _check_expr(c, env, where, bound)
            _check_expr(v, env, where, bound)
        if e.default is not None:
            _check_expr(e.default, env, where, bound)


def _free_refs(e: RowExpr) -> Set[str]:
    from ..rex import input_names
    return input_names(e)


def _node_exprs(node: PlanNode) -> List[Tuple[str, RowExpr]]:
    """(description, expression) pairs evaluated against the node's
    source env."""
    out: List[Tuple[str, RowExpr]] = []
    if isinstance(node, FilterNode):
        out.append(("predicate", node.predicate))
    elif isinstance(node, ProjectNode):
        out.extend((f"assignment '{s}'", e)
                   for s, e in node.assignments.items())
    elif isinstance(node, JoinNode):
        if node.filter is not None:
            out.append(("join filter", node.filter))
    elif _is_semi_multi(node):
        if node.filter is not None:
            out.append(("semi-join filter", node.filter))
    return out


def _is_semi_multi(node: PlanNode) -> bool:
    return type(node).__name__ == "SemiJoinMultiNode"


# --------------------------------------------------------------------------
# validators
# --------------------------------------------------------------------------

class NoDuplicatePlanNodeIds:
    """The plan is a tree: one owner per node object (the reference
    checks PlanNodeId uniqueness; object identity is the id here)."""

    name = "NoDuplicatePlanNodeIds"

    def validate(self, plan: PlanNode, memo=None) -> None:
        seen: Set[int] = set()
        for node in walk_plan(plan):
            if id(node) in seen:
                raise _Violation(
                    f"{_node_label(node)} appears at more than one "
                    "position in the plan tree (shared subtree object)")
            seen.add(id(node))


class ValidateDependenciesChecker:
    """Symbol dependency closure: no dangling references anywhere."""

    name = "ValidateDependenciesChecker"

    def validate(self, plan: PlanNode, memo=None) -> None:
        memo = {} if memo is None else memo
        for node in walk_plan(plan):
            self._check_node(node, memo)

    def _require(self, node: PlanNode, syms: Iterable[str],
                 env: Dict[str, Type], what: str) -> None:
        missing = [s for s in syms if s not in env]
        if missing:
            raise _Violation(
                f"{_node_label(node)}: {what} references symbols "
                f"{missing} absent from the source schema "
                f"(available: {sorted(env)[:12]}...)")

    def _check_node(self, node: PlanNode, memo) -> None:
        label = _node_label(node)
        if isinstance(node, TableScanNode):
            if set(node.assignments) != set(node.schema):
                raise _Violation(
                    f"{label}: assignments {sorted(node.assignments)} "
                    f"and schema {sorted(node.schema)} disagree")
            return
        if isinstance(node, (ValuesNode, RemoteSourceNode,
                             TableDeleteNode)):
            return
        env = _env(node, memo)
        for what, e in _node_exprs(node):
            self._require(node, _free_refs(e), env, what)
        if isinstance(node, AggregationNode):
            self._require(node, node.group_keys, env, "group keys")
            for sym, a in node.aggregates.items():
                refs = [s for s in (a.argument, a.argument2, a.mask)
                        if s is not None]
                self._require(node, refs, env, f"aggregate '{sym}'")
        elif isinstance(node, GroupIdNode):
            self._require(node, node.all_keys, env, "grouping keys")
            for gs in node.grouping_sets:
                self._require(node, gs, env, "grouping set")
        elif isinstance(node, SemiJoinNode):
            self._require(node, [node.source_key],
                          _schema(node.source, memo), "source key")
            self._require(node, [node.filtering_key],
                          _schema(node.filtering_source, memo),
                          "filtering key")
        elif _is_semi_multi(node):
            self._require(node, node.source_keys,
                          _schema(node.source, memo), "source keys")
            self._require(node, node.filtering_keys,
                          _schema(node.filtering_source, memo),
                          "filtering keys")
        elif isinstance(node, (SortNode, TopNNode)):
            self._require(node, [k.symbol for k in node.keys], env,
                          "sort keys")
        elif isinstance(node, MarkDistinctNode):
            self._require(node, node.keys, env, "distinct keys")
        elif isinstance(node, WindowNode):
            self._require(node, node.partition_by, env, "partition by")
            self._require(node, [k.symbol for k in node.order_by], env,
                          "order by")
            for sym, f in node.functions.items():
                refs = [s for s in (f.argument, f.offset, f.default)
                        if s is not None]
                self._require(node, refs, env, f"window '{sym}'")
        elif isinstance(node, UnnestNode):
            self._require(node, node.replicate, env, "replicate")
            self._require(node, node.unnest.values(), env,
                          "unnest inputs")
        elif isinstance(node, UnionNode):
            for i, (child, smap) in enumerate(
                    zip(node.children, node.symbol_maps)):
                missing_out = [s for s in node.schema if s not in smap]
                if missing_out:
                    raise _Violation(
                        f"{label}: branch {i} symbol map is missing "
                        f"output symbols {missing_out}")
                self._require(node, [smap[s] for s in node.schema],
                              _schema(child, memo),
                              f"branch {i} symbols")
        elif isinstance(node, SetOpNode):
            self._require(node, node.left_map.values(),
                          _schema(node.left, memo), "left map")
            self._require(node, node.right_map.values(),
                          _schema(node.right, memo), "right map")
        elif isinstance(node, OutputNode):
            self._require(node, node.symbols, env, "output symbols")
        elif isinstance(node, ExchangeNode):
            self._require(node, node.partition_keys, env,
                          "partition keys")
        elif isinstance(node, PartitionedOutputNode):
            # partitioning-key closure, producer half: a key the body
            # does not produce would make the bucketing kernel KeyError
            # on every worker (or worse, partition on a stale column)
            self._require(node, node.partition_keys, env,
                          "partition keys")
        elif isinstance(node, TableWriterNode):
            self._require(node, node.symbols, env, "writer symbols")


class TypeValidator:
    """Expression/output type consistency (sanity/TypeValidator)."""

    name = "TypeValidator"

    def validate(self, plan: PlanNode, memo=None) -> None:
        memo = {} if memo is None else memo
        for node in walk_plan(plan):
            env = _env(node, memo)
            for what, e in _node_exprs(node):
                _check_expr(e, env, f"{_node_label(node)} {what}")
            if isinstance(node, FilterNode) \
                    and _family(node.predicate.type) not in (
                        "boolean", "unknown"):
                raise _Violation(
                    f"FilterNode predicate has type "
                    f"{node.predicate.type}, expected boolean")
            if isinstance(node, JoinNode) and node.filter is not None \
                    and _family(node.filter.type) not in (
                        "boolean", "unknown"):
                raise _Violation(
                    f"JoinNode filter has type {node.filter.type}, "
                    "expected boolean")
            if isinstance(node, UnionNode):
                for i, (child, smap) in enumerate(
                        zip(node.children, node.symbol_maps)):
                    cschema = _schema(child, memo)
                    for s, t in node.schema.items():
                        src = cschema.get(smap.get(s, ""), None)
                        if src is not None and not types_agree(t, src):
                            raise _Violation(
                                f"UnionNode output '{s}' is {t} but "
                                f"branch {i} provides {src}")
            if isinstance(node, AggregationNode):
                src = env
                nschema = _schema(node, memo)
                for k in node.group_keys:
                    # existence is the dependency checker's finding;
                    # here only agreement between derived and source
                    if k in src and k in nschema \
                            and not types_agree(nschema[k], src[k]):
                        raise _Violation(
                            f"AggregationNode group key '{k}' changes "
                            f"type {src[k]} -> {nschema[k]}")


class JoinCriteriaChecker:
    """Equi-join clause sidedness + type agreement."""

    name = "JoinCriteriaChecker"

    def validate(self, plan: PlanNode, memo=None) -> None:
        memo = {} if memo is None else memo
        for node in walk_plan(plan):
            if isinstance(node, JoinNode):
                lschema = _schema(node.left, memo)
                rschema = _schema(node.right, memo)
                for c in node.criteria:
                    if c.left not in lschema:
                        raise _Violation(
                            f"join clause '{c.left} = {c.right}': left "
                            f"symbol '{c.left}' is not produced by the "
                            "left source")
                    if c.right not in rschema:
                        raise _Violation(
                            f"join clause '{c.left} = {c.right}': "
                            f"right symbol '{c.right}' is not produced "
                            "by the right source")
                    lt, rt = lschema[c.left], rschema[c.right]
                    if not comparable(lt, rt):
                        raise _Violation(
                            f"join clause '{c.left} = {c.right}' "
                            f"compares {lt} with {rt} — the analyzer "
                            "should have inserted a coercion")
            elif isinstance(node, SemiJoinNode):
                st = _schema(node.source, memo).get(node.source_key)
                ft = _schema(node.filtering_source, memo).get(
                    node.filtering_key)
                if st is not None and ft is not None \
                        and not comparable(st, ft):
                    raise _Violation(
                        f"semi-join key '{node.source_key}' ({st}) "
                        f"incomparable with '{node.filtering_key}' "
                        f"({ft})")


class SerdeRoundTripChecker:
    """Fragment wire-format stability (a fragment crossing an exchange
    or spool boundary as JSON — plan/serde.py)."""

    name = "SerdeRoundTripChecker"

    def validate(self, plan: PlanNode, memo=None) -> None:
        check_serde_round_trip(plan)


def check_serde_round_trip(plan: PlanNode):
    """Prove the wire format round-trips, returning the proven-stable
    encoding so the dispatcher can ship the exact bytes it validated
    instead of re-encoding the fragment (raises ``_Violation`` — use
    through the checker for the stamped error)."""
    from ..plan.serde import from_jsonable, to_jsonable
    try:
        enc = to_jsonable(plan)
        wire = json.dumps(enc)
    except (TypeError, ValueError) as e:
        raise _Violation(
            f"fragment is not serializable: {e}") from e
    try:
        dec = from_jsonable(json.loads(wire))
    except Exception as e:      # noqa: BLE001 — any decode break
        raise _Violation(
            f"fragment does not decode from its own wire form: "
            f"{type(e).__name__}: {e}") from e
    try:
        enc2 = to_jsonable(dec)
    except (TypeError, ValueError) as e:
        raise _Violation(
            f"decoded fragment is not re-serializable: {e}") from e
    if enc2 != enc:
        raise _Violation(
            "fragment encoding is unstable: encode(decode(x)) != "
            "encode(x) — a worker retry would execute a different "
            "plan than the first attempt")
    if not _deep_eq(plan, dec):
        raise _Violation(
            "fragment round-trip changes the plan: decode(encode("
            "x)) != x (value or key types drift across the wire)")
    return enc


def _deep_eq(a, b) -> bool:
    """Structural equality, key-type-strict for dicts (JSON stringifies
    non-str keys; dataclass __eq__ would hide the drift when both
    sides re-stringify)."""
    if is_dataclass(a) and not isinstance(a, type):
        if type(a) is not type(b):
            return False
        return all(_deep_eq(getattr(a, f.name), getattr(b, f.name))
                   for f in dc_fields(a))
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return False
        ka = {k: type(k) for k in a}
        kb = {k: type(k) for k in b}
        if ka != kb:
            return False
        return all(_deep_eq(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        if type(a) is not type(b) or len(a) != len(b):
            return False
        return all(_deep_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)    # NaN-stable
    try:
        return bool(a == b)
    except Exception:       # noqa: BLE001 — array-valued fields
        return a is b


# --------------------------------------------------------------------------
# the checker
# --------------------------------------------------------------------------

DEFAULT_VALIDATORS = (NoDuplicatePlanNodeIds(),
                      ValidateDependenciesChecker(),
                      TypeValidator(),
                      JoinCriteriaChecker())

FRAGMENT_VALIDATORS = DEFAULT_VALIDATORS + (SerdeRoundTripChecker(),)


class PlanSanityChecker:
    """Runs the validator battery; the first broken invariant raises a
    ``PlanValidationError`` naming the validator + pass."""

    def __init__(self, validators: Optional[tuple] = None):
        self.validators = (DEFAULT_VALIDATORS if validators is None
                           else tuple(validators))

    def _run(self, validators, plan: PlanNode, pass_name: str) -> None:
        PLAN_VALIDATIONS.inc()
        # one schema memo for the whole battery: every validator walks
        # every node, and output_schema() re-derives recursively
        memo: Dict[int, Dict[str, Type]] = {}
        for v in validators:
            try:
                v.validate(plan, memo)
            except _Violation as e:
                PLAN_VALIDATION_FAILURES.inc(validator=v.name)
                raise PlanValidationError(v.name, str(e),
                                          pass_name) from e

    def validate(self, plan: PlanNode, pass_name: str = "") -> None:
        self._run(self.validators, plan, pass_name)

    def validate_fragment(self, plan: PlanNode,
                          pass_name: str = "fragmenter"):
        """Fragment battery: the plan checks plus wire-format
        round-trip stability (the fragment is about to cross the
        exchange/spool boundary as JSON). Returns the proven-stable
        encoding so the dispatcher ships the bytes it validated
        instead of encoding the fragment a second time."""
        base = tuple(v for v in self.validators
                     if not isinstance(v, SerdeRoundTripChecker))
        self._run(base, plan, pass_name)
        try:
            return check_serde_round_trip(plan)
        except _Violation as e:
            PLAN_VALIDATION_FAILURES.inc(
                validator=SerdeRoundTripChecker.name)
            raise PlanValidationError(SerdeRoundTripChecker.name,
                                      str(e), pass_name) from e


def validate_plan(plan: PlanNode, pass_name: str = "",
                  fragment: bool = False) -> None:
    """One-shot convenience entry (the module-level analog of the
    reference's PlanSanityChecker.validateFinalPlan)."""
    checker = PlanSanityChecker()
    if fragment:
        checker.validate_fragment(plan, pass_name)
    else:
        checker.validate(plan, pass_name)


class StageBoundaryChecker:
    """Stage-DAG boundary validator (multi-stage MPP,
    trino_tpu/stage/): partitioning-key closure and schema agreement
    across every PartitionedOutput/RemoteSource pair. Unlike the
    per-plan validators above it sees the WHOLE DAG — a single stage
    plan is internally consistent even when its RemoteSource schema
    silently drifted from what the producer stage actually emits, so
    the edge itself is the thing to check:

    - every RemoteSourceNode names an existing producer stage;
    - the producer's plan is rooted in a PartitionedOutputNode whose
      partition keys the producer body produces (key closure — the
      per-plan dependency checker covers this half too);
    - the consumer's RemoteSource schema matches the producer's output
      symbol-for-symbol with agreeing types (a drift here executes,
      then joins/aggregates garbage — the exact class of wrong-answer
      bug a validator exists for);
    - a hash-partitioned producer carries at least one key; a gather
      producer carries none.
    """

    name = "StageBoundaryChecker"

    def validate_dag(self, stages, root_plan: PlanNode) -> None:
        by_sid = {st.sid: st for st in stages}
        for st in stages:
            po = st.plan
            if not isinstance(po, PartitionedOutputNode):
                raise _Violation(
                    f"stage {st.sid} plan is rooted in "
                    f"{_node_label(po)}, expected PartitionedOutput")
            body_schema = _schema(po.source)
            missing = [k for k in po.partition_keys
                       if k not in body_schema]
            if missing:
                raise _Violation(
                    f"stage {st.sid} partitions by {missing} which its "
                    f"body does not produce "
                    f"(available: {sorted(body_schema)[:12]}...)")
            if po.kind == "hash" and not po.partition_keys:
                raise _Violation(
                    f"stage {st.sid} hash-partitions with no keys")
            if po.kind in ("gather", "replicate") and po.partition_keys:
                raise _Violation(
                    f"stage {st.sid} {po.kind}s but carries partition "
                    f"keys {list(po.partition_keys)}")
        for where, plan in [(f"stage {st.sid}", st.plan)
                            for st in stages] + [("root", root_plan)]:
            for node in walk_plan(plan):
                if not isinstance(node, RemoteSourceNode):
                    continue
                for fid in node.fragment_ids:
                    producer = by_sid.get(fid)
                    if producer is None:
                        raise _Violation(
                            f"{where}: RemoteSource names unknown "
                            f"stage {fid}")
                    pschema = _schema(producer.plan)
                    for sym, t in node.schema.items():
                        pt = pschema.get(sym)
                        if pt is None:
                            raise _Violation(
                                f"{where}: RemoteSource expects symbol "
                                f"'{sym}' which stage {fid} does not "
                                f"produce (produces: "
                                f"{sorted(pschema)[:12]}...)")
                        if not types_agree(t, pt):
                            raise _Violation(
                                f"{where}: RemoteSource symbol '{sym}' "
                                f"expects {t} but stage {fid} produces "
                                f"{pt}")


def validate_stage_dag(dag, checker: Optional["PlanSanityChecker"]
                       = None,
                       pass_name: str = "stage-fragmenter"
                       ) -> Dict[int, dict]:
    """The stage flavor of the always-on pre-dispatch battery
    (exec/remote.py): every stage plan runs the FRAGMENT battery (its
    wire form is what workers execute — serde round-trip included),
    the root plan runs the base battery, and the StageBoundaryChecker
    proves every exchange edge. Returns the round-trip-proven encoding
    per stage id — the exact bytes the scheduler ships."""
    checker = checker or PlanSanityChecker()
    payloads: Dict[int, dict] = {}
    for st in dag.stages:
        payloads[st.sid] = checker.validate_fragment(
            st.plan, pass_name)
    checker.validate(dag.root_plan, pass_name)
    boundary = StageBoundaryChecker()
    PLAN_VALIDATIONS.inc()
    try:
        boundary.validate_dag(dag.stages, dag.root_plan)
    except _Violation as e:
        PLAN_VALIDATION_FAILURES.inc(validator=boundary.name)
        raise PlanValidationError(boundary.name, str(e),
                                  pass_name) from e
    return payloads


# --------------------------------------------------------------------------
# the checker
# --------------------------------------------------------------------------

DEFAULT_VALIDATORS = (NoDuplicatePlanNodeIds(),
                      ValidateDependenciesChecker(),
                      TypeValidator(),
                      JoinCriteriaChecker())

FRAGMENT_VALIDATORS = DEFAULT_VALIDATORS + (SerdeRoundTripChecker(),)


class PlanSanityChecker:
    """Runs the validator battery; the first broken invariant raises a
    ``PlanValidationError`` naming the validator + pass."""

    def __init__(self, validators: Optional[tuple] = None):
        self.validators = (DEFAULT_VALIDATORS if validators is None
                           else tuple(validators))

    def _run(self, validators, plan: PlanNode, pass_name: str) -> None:
        PLAN_VALIDATIONS.inc()
        # one schema memo for the whole battery: every validator walks
        # every node, and output_schema() re-derives recursively
        memo: Dict[int, Dict[str, Type]] = {}
        for v in validators:
            try:
                v.validate(plan, memo)
            except _Violation as e:
                PLAN_VALIDATION_FAILURES.inc(validator=v.name)
                raise PlanValidationError(v.name, str(e),
                                          pass_name) from e

    def validate(self, plan: PlanNode, pass_name: str = "") -> None:
        self._run(self.validators, plan, pass_name)

    def validate_fragment(self, plan: PlanNode,
                          pass_name: str = "fragmenter"):
        """Fragment battery: the plan checks plus wire-format
        round-trip stability (the fragment is about to cross the
        exchange/spool boundary as JSON). Returns the proven-stable
        encoding so the dispatcher ships the bytes it validated
        instead of encoding the fragment a second time."""
        base = tuple(v for v in self.validators
                     if not isinstance(v, SerdeRoundTripChecker))
        self._run(base, plan, pass_name)
        try:
            return check_serde_round_trip(plan)
        except _Violation as e:
            PLAN_VALIDATION_FAILURES.inc(
                validator=SerdeRoundTripChecker.name)
            raise PlanValidationError(SerdeRoundTripChecker.name,
                                      str(e), pass_name) from e


def validate_plan(plan: PlanNode, pass_name: str = "",
                  fragment: bool = False) -> None:
    """One-shot convenience entry (the module-level analog of the
    reference's PlanSanityChecker.validateFinalPlan)."""
    checker = PlanSanityChecker()
    if fragment:
        checker.validate_fragment(plan, pass_name)
    else:
        checker.validate(plan, pass_name)
