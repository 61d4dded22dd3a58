"""SQL abstract syntax tree.

Reference parity: core/trino-parser/src/main/java/io/trino/sql/tree/
(~100 node classes, AstVisitor pattern). Nodes here are frozen dataclasses;
traversal is structural (match on type) rather than a visitor hierarchy —
idiomatic Python, and the analyzer/planner are the only consumers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


class Node:
    """Base of every AST node."""
    __slots__ = ()


# --------------------------------------------------------------------------
# Expressions (reference: sql/tree/Expression.java subclasses)
# --------------------------------------------------------------------------

class Expression(Node):
    __slots__ = ()


@dataclass(frozen=True)
class Literal(Expression):
    value: object            # python int / float / str / bool / None
    type_name: Optional[str] = None   # e.g. 'date', 'decimal(3,1)'; None=infer


@dataclass(frozen=True)
class IntervalLiteral(Expression):
    value: str               # e.g. '3'
    unit: str                # day | month | year | hour | minute | second
    sign: int = 1


@dataclass(frozen=True)
class Identifier(Expression):
    """Possibly-qualified column reference, e.g. l.orderkey."""
    parts: Tuple[str, ...]

    @property
    def name(self) -> str:
        return self.parts[-1]

    def __str__(self) -> str:
        return ".".join(self.parts)


@dataclass(frozen=True)
class Star(Expression):
    """`*` or `t.*` in a select list or count(*)."""
    qualifier: Optional[str] = None


@dataclass(frozen=True)
class BinaryOp(Expression):
    op: str                  # + - * / % = <> < <= > >= and or ||
    left: Expression
    right: Expression


@dataclass(frozen=True)
class UnaryOp(Expression):
    op: str                  # - + not
    operand: Expression


@dataclass(frozen=True)
class IsNull(Expression):
    operand: Expression
    negated: bool = False


@dataclass(frozen=True)
class IsDistinctFrom(Expression):
    left: Expression
    right: Expression
    negated: bool = False


@dataclass(frozen=True)
class Between(Expression):
    operand: Expression
    low: Expression
    high: Expression
    negated: bool = False


@dataclass(frozen=True)
class InList(Expression):
    operand: Expression
    items: Tuple[Expression, ...]
    negated: bool = False


@dataclass(frozen=True)
class InSubquery(Expression):
    operand: Expression
    query: "Query"
    negated: bool = False


@dataclass(frozen=True)
class Exists(Expression):
    query: "Query"
    negated: bool = False


@dataclass(frozen=True)
class ScalarSubquery(Expression):
    query: "Query"


@dataclass(frozen=True)
class QuantifiedComparison(Expression):
    """x > ALL (subquery) / x = ANY (subquery)."""
    op: str
    quantifier: str          # all | any | some
    operand: Expression
    query: "Query"


@dataclass(frozen=True)
class Like(Expression):
    operand: Expression
    pattern: Expression
    escape: Optional[Expression] = None
    negated: bool = False


@dataclass(frozen=True)
class Case(Expression):
    """Searched CASE; simple CASE is desugared by the parser
    (reference: sql/tree/SimpleCaseExpression rewritten in analysis)."""
    whens: Tuple[Tuple[Expression, Expression], ...]
    default: Optional[Expression] = None


@dataclass(frozen=True)
class Cast(Expression):
    operand: Expression
    type_name: str
    safe: bool = False       # TRY_CAST


@dataclass(frozen=True)
class FunctionCall(Expression):
    name: str                # lower-cased
    args: Tuple[Expression, ...]
    distinct: bool = False
    filter: Optional[Expression] = None       # FILTER (WHERE ...)
    order_by: Tuple["SortItem", ...] = ()     # for array_agg etc.
    window: Optional["WindowSpec"] = None     # OVER (...)


@dataclass(frozen=True)
class WindowSpec(Node):
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple["SortItem", ...] = ()
    frame: Optional["WindowFrame"] = None


@dataclass(frozen=True)
class WindowFrame(Node):
    unit: str                # rows | range | groups
    start_type: str          # unbounded_preceding|preceding|current|following|unbounded_following
    start_value: Optional[Expression] = None
    end_type: str = "current"
    end_value: Optional[Expression] = None


@dataclass(frozen=True)
class Extract(Expression):
    field: str               # year | month | day | hour | minute | second ...
    operand: Expression


@dataclass(frozen=True)
class Subscript(Expression):
    base: Expression
    index: Expression


@dataclass(frozen=True)
class RowConstructor(Expression):
    items: Tuple[Expression, ...]


@dataclass(frozen=True)
class ArrayConstructor(Expression):
    items: Tuple[Expression, ...]


@dataclass(frozen=True)
class LambdaExpression(Expression):
    params: Tuple[str, ...]
    body: Expression


# --------------------------------------------------------------------------
# Relations (reference: sql/tree/Relation.java subclasses)
# --------------------------------------------------------------------------

class Relation(Node):
    __slots__ = ()


@dataclass(frozen=True)
class Table(Relation):
    parts: Tuple[str, ...]   # [catalog.][schema.]table

    def __str__(self) -> str:
        return ".".join(self.parts)


@dataclass(frozen=True)
class AliasedRelation(Relation):
    relation: Relation
    alias: str
    column_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class SubqueryRelation(Relation):
    query: "Query"


@dataclass(frozen=True)
class Join(Relation):
    join_type: str           # inner | left | right | full | cross
    left: Relation
    right: Relation
    on: Optional[Expression] = None
    using: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Unnest(Relation):
    exprs: Tuple[Expression, ...]
    with_ordinality: bool = False


@dataclass(frozen=True)
class ValuesRelation(Relation):
    rows: Tuple[Tuple[Expression, ...], ...]


@dataclass(frozen=True)
class TableSample(Relation):
    relation: Relation
    method: str              # bernoulli | system
    percentage: Expression = None  # type: ignore


# --------------------------------------------------------------------------
# Query structure (reference: sql/tree/{Query,QuerySpecification,...}.java)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SelectItem(Node):
    expr: Expression
    alias: Optional[str] = None


@dataclass(frozen=True)
class SortItem(Node):
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = type default (last for asc)


@dataclass(frozen=True)
class GroupingSets(Node):
    """GROUP BY GROUPING SETS / CUBE / ROLLUP — normalized to explicit
    sets of expression indices into a flat expression list."""
    exprs: Tuple[Expression, ...]
    sets: Tuple[Tuple[int, ...], ...]


class QueryBody(Node):
    __slots__ = ()


@dataclass(frozen=True)
class QuerySpecification(QueryBody):
    select_items: Tuple[SelectItem, ...]
    distinct: bool = False
    from_: Optional[Relation] = None
    where: Optional[Expression] = None
    group_by: Optional[GroupingSets] = None
    having: Optional[Expression] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


@dataclass(frozen=True)
class SetOperation(QueryBody):
    op: str                  # union | intersect | except
    distinct: bool
    left: QueryBody
    right: QueryBody


@dataclass(frozen=True)
class ValuesBody(QueryBody):
    rows: Tuple[Tuple[Expression, ...], ...]


@dataclass(frozen=True)
class WithQuery(Node):
    name: str
    query: "Query"
    column_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Query(Node):
    """Full query: WITH list + body + outer ORDER BY/LIMIT (for set ops)."""
    body: QueryBody
    with_queries: Tuple[WithQuery, ...] = ()
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


# --------------------------------------------------------------------------
# Statements (reference: sql/tree/Statement.java subclasses)
# --------------------------------------------------------------------------

class Statement(Node):
    __slots__ = ()


@dataclass(frozen=True)
class QueryStatement(Statement):
    query: Query


@dataclass(frozen=True)
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    type: str = "distributed"   # logical | distributed | io


@dataclass(frozen=True)
class ShowTables(Statement):
    schema: Optional[Tuple[str, ...]] = None
    like: Optional[str] = None


@dataclass(frozen=True)
class ShowSchemas(Statement):
    catalog: Optional[str] = None


@dataclass(frozen=True)
class ShowCatalogs(Statement):
    pass


@dataclass(frozen=True)
class ShowColumns(Statement):
    table: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ShowSession(Statement):
    pass


@dataclass(frozen=True)
class ShowFunctions(Statement):
    pass


@dataclass(frozen=True)
class SetSession(Statement):
    name: str = ""
    value: Expression = None  # type: ignore


@dataclass(frozen=True)
class ResetSession(Statement):
    name: str = ""


@dataclass(frozen=True)
class ColumnDefinition(Node):
    name: str
    type_name: str
    nullable: bool = True


@dataclass(frozen=True)
class CreateTable(Statement):
    name: Tuple[str, ...]
    columns: Tuple[ColumnDefinition, ...] = ()
    query: Optional[Query] = None          # CREATE TABLE AS
    if_not_exists: bool = False
    properties: Tuple[Tuple[str, Expression], ...] = ()


@dataclass(frozen=True)
class DropTable(Statement):
    name: Tuple[str, ...] = ()
    if_exists: bool = False


@dataclass(frozen=True)
class Insert(Statement):
    table: Tuple[str, ...] = ()
    columns: Tuple[str, ...] = ()
    query: Query = None  # type: ignore


@dataclass(frozen=True)
class Delete(Statement):
    table: Tuple[str, ...] = ()
    where: Optional[Expression] = None


@dataclass(frozen=True)
class Update(Statement):
    table: Tuple[str, ...] = ()
    assignments: Tuple[Tuple[str, Expression], ...] = ()
    where: Optional[Expression] = None


@dataclass(frozen=True)
class MergeClause(Node):
    """One WHEN [NOT] MATCHED [AND cond] THEN action arm."""
    matched: bool
    condition: Optional[Expression]
    action: str                                  # update | delete | insert
    assignments: Tuple[Tuple[str, Expression], ...] = ()
    insert_columns: Tuple[str, ...] = ()
    insert_values: Tuple[Expression, ...] = ()


@dataclass(frozen=True)
class Merge(Statement):
    target: Tuple[str, ...] = ()
    target_alias: Optional[str] = None
    source: Relation = None  # type: ignore
    on: Expression = None    # type: ignore
    clauses: Tuple[MergeClause, ...] = ()


@dataclass(frozen=True)
class UseStatement(Statement):
    catalog: Optional[str] = None
    schema: str = ""


@dataclass(frozen=True)
class CreateView(Statement):
    name: Tuple[str, ...] = ()
    query: Query = None  # type: ignore
    replace: bool = False


@dataclass(frozen=True)
class DropView(Statement):
    name: Tuple[str, ...] = ()
    if_exists: bool = False


@dataclass(frozen=True)
class ShowCreate(Statement):
    kind: str = "table"       # table | view
    name: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Prepare(Statement):
    name: str = ""
    statement: Statement = None  # type: ignore


@dataclass(frozen=True)
class ExecuteStmt(Statement):
    name: str = ""
    params: Tuple[Expression, ...] = ()


@dataclass(frozen=True)
class Deallocate(Statement):
    name: str = ""


@dataclass(frozen=True)
class ShowStats(Statement):
    table: Tuple[str, ...]


@dataclass(frozen=True)
class Describe(Statement):
    table: Tuple[str, ...] = ()


@dataclass(frozen=True)
class DescribeInput(Statement):
    name: str = ""


@dataclass(frozen=True)
class DescribeOutput(Statement):
    name: str = ""


@dataclass(frozen=True)
class Grant(Statement):
    """GRANT privileges ON [TABLE] t TO grantee [WITH GRANT OPTION]
    (reference: sql/tree/Grant.java, execution/GrantTask.java)."""
    privileges: Tuple[str, ...] = ()   # empty = ALL PRIVILEGES
    table: Tuple[str, ...] = ()
    grantee: str = ""
    grant_option: bool = False


@dataclass(frozen=True)
class Revoke(Statement):
    privileges: Tuple[str, ...] = ()
    table: Tuple[str, ...] = ()
    grantee: str = ""
    grant_option_for: bool = False


@dataclass(frozen=True)
class Deny(Statement):
    privileges: Tuple[str, ...] = ()
    table: Tuple[str, ...] = ()
    grantee: str = ""


@dataclass(frozen=True)
class ShowGrants(Statement):
    table: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class CallStatement(Statement):
    name: Tuple[str, ...] = ()
    args: Tuple[Expression, ...] = ()


@dataclass(frozen=True)
class StartTransaction(Statement):
    pass


@dataclass(frozen=True)
class Commit(Statement):
    pass


@dataclass(frozen=True)
class Rollback(Statement):
    pass


def replace_parameters(node, values):
    """Substitute `?` placeholders (Literal(type_name='parameter')) with
    the given Literal values, in source order (reference:
    sql/planner/ParameterRewriter.java). Raises ValueError on arity
    mismatch."""
    import dataclasses as _dc
    state = [0]

    def conv(v):
        if isinstance(v, Node):
            return go(v)
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v

    def go(n):
        if isinstance(n, Literal) and n.type_name == "parameter":
            i = state[0]
            state[0] += 1
            if i >= len(values):
                raise ValueError(
                    f"query takes at least {state[0]} parameters but "
                    f"only {len(values)} were given")
            return values[i]
        if hasattr(n, "__dataclass_fields__"):
            changes = {}
            for f in n.__dataclass_fields__:
                v = getattr(n, f)
                nv = conv(v)
                if nv is not v:
                    changes[f] = nv
            return _dc.replace(n, **changes) if changes else n
        return n

    out = go(node)
    return out, state[0]


def count_parameters(node) -> int:
    return sum(1 for e in walk_expressions(node)
               if isinstance(e, Literal) and e.type_name == "parameter")


def walk_expressions(node, cross_subqueries: bool = True):
    """Yield every Expression reachable from an AST node (pre-order).

    ``cross_subqueries=False`` stops at subquery boundaries
    (QueryStatement/Relation values): an aggregate or window call
    inside a ScalarSubquery belongs to THAT query's planning, not the
    enclosing one — descending made `CASE WHEN (SELECT count(*) ...)`
    hoist the inner aggregate into the outer AggregationNode."""
    def _push(stack, v):
        if isinstance(v, (Query, QueryBody, QueryStatement, Relation)) \
                and not cross_subqueries:
            return
        if isinstance(v, Node):
            stack.append(v)

    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, Expression):
            yield n
        if hasattr(n, "__dataclass_fields__"):
            for f in n.__dataclass_fields__:
                v = getattr(n, f)
                if isinstance(v, Node):
                    _push(stack, v)
                elif isinstance(v, tuple):
                    for item in v:
                        if isinstance(item, Node):
                            _push(stack, item)
                        elif isinstance(item, tuple):
                            for x in item:
                                if isinstance(x, Node):
                                    _push(stack, x)
