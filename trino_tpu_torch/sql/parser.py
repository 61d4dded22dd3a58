"""Recursive-descent SQL parser.

Reference parity: core/trino-parser (SqlBase.g4 888-line grammar +
AstBuilder.java). Covers the executable surface: SELECT queries (joins,
subqueries, set operations, WITH, window functions, grouping sets),
VALUES, EXPLAIN, SHOW, SET/RESET SESSION, CREATE TABLE [AS], INSERT,
DELETE, USE. Operator precedence follows the grammar's booleanExpression/
valueExpression/primaryExpression stratification.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import ast as A
from .tokenizer import ParseError, Token, tokenize

_RESERVED_STOP = {
    # keywords that terminate an expression / select item / relation
    "from", "where", "group", "having", "order", "limit", "offset", "union",
    "intersect", "except", "on", "using", "join", "inner", "left", "right",
    "full", "cross", "as", "by", "asc", "desc", "nulls", "when", "then",
    "else", "end", "and", "or", "not", "in", "like", "between", "is",
    "select", "with", "fetch", "escape", "case", "cast", "distinct", "all",
    "any", "some", "exists", "over", "partition", "rows", "range", "groups",
    "filter", "tablesample",
}

_INTERVAL_UNITS = {"year", "month", "day", "hour", "minute", "second",
                   "week", "quarter"}

_EXTRACT_FIELDS = {"year", "quarter", "month", "week", "day", "day_of_month",
                   "day_of_week", "dow", "day_of_year", "doy",
                   "year_of_week", "yow", "hour", "minute", "second",
                   "timezone_hour", "timezone_minute"}


def parse_statement(sql: str) -> A.Statement:
    return _Parser(tokenize(sql)).parse_statement()


def parse_expression(sql: str) -> A.Expression:
    p = _Parser(tokenize(sql))
    e = p.expression()
    p.expect_eof()
    return e


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.pos = 0

    # --- token utilities --------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.pos + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at_kw(self, *kws: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == "ident" and t.value in kws

    def at_op(self, *ops: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == "op" and t.value in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        t = self.peek()
        if not self.at_kw(kw):
            raise ParseError(f"expected {kw.upper()}, found {t.value!r}",
                             t.line, t.column)
        return self.next()

    def expect_op(self, op: str) -> Token:
        t = self.peek()
        if not self.at_op(op):
            raise ParseError(f"expected {op!r}, found {t.value!r}",
                             t.line, t.column)
        return self.next()

    def expect_eof(self):
        t = self.peek()
        if t.kind == "op" and t.value == ";":
            self.next()     # one trailing semicolon is fine ...
            t = self.peek()
        if t.kind != "eof":  # ... but further statements are rejected
            raise ParseError(f"unexpected trailing input {t.value!r}",
                             t.line, t.column)

    def integer(self) -> int:
        t = self.peek()
        if t.kind != "integer":
            raise ParseError(f"expected integer, found {t.value!r}",
                             t.line, t.column)
        self.next()
        return int(t.value)

    def identifier(self) -> str:
        t = self.peek()
        if t.kind in ("ident", "qident"):
            self.next()
            return t.value
        raise ParseError(f"expected identifier, found {t.value!r}",
                         t.line, t.column)

    def qualified_name(self) -> Tuple[str, ...]:
        parts = [self.identifier()]
        while self.accept_op("."):
            parts.append(self.identifier())
        return tuple(parts)

    # --- statements -------------------------------------------------------
    def parse_statement(self) -> A.Statement:
        stmt = self._statement()
        self.expect_eof()
        return stmt

    def _statement(self) -> A.Statement:
        if self.at_kw("explain"):
            self.next()
            analyze = self.accept_kw("analyze")
            etype = "distributed"
            if self.accept_op("("):
                while not self.accept_op(")"):
                    if self.peek().kind == "eof":
                        raise ParseError("unexpected end of EXPLAIN "
                                         "options", self.peek().line,
                                         self.peek().column)
                    if self.accept_kw("type"):
                        etype = self.identifier()
                    elif self.accept_kw("format"):
                        self.identifier()
                    else:
                        self.next()
                    self.accept_op(",")
            return A.Explain(self._statement(), analyze, etype)
        if self.at_kw("show"):
            return self._show()
        if self.at_kw("grant", "revoke", "deny"):
            return self._grant()
        if self.at_kw("set"):
            self.next()
            self.expect_kw("session")
            name = ".".join(self.qualified_name())
            self.expect_op("=")
            return A.SetSession(name, self.expression())
        if self.at_kw("reset"):
            self.next()
            self.expect_kw("session")
            return A.ResetSession(".".join(self.qualified_name()))
        if self.at_kw("use"):
            self.next()
            parts = self.qualified_name()
            if len(parts) == 2:
                return A.UseStatement(parts[0], parts[1])
            return A.UseStatement(None, parts[0])
        if self.at_kw("create"):
            if self.at_kw("view", ahead=1) or (
                    self.at_kw("or", ahead=1)
                    and self.at_kw("replace", ahead=2)
                    and self.at_kw("view", ahead=3)):
                self.next()
                replace = False
                if self.accept_kw("or"):
                    self.expect_kw("replace")
                    replace = True
                self.expect_kw("view")
                name = self.qualified_name()
                self.expect_kw("as")
                return A.CreateView(name, self.query(), replace)
            return self._create_table()
        if self.at_kw("drop"):
            self.next()
            kind = "view" if self.accept_kw("view") else "table"
            if kind == "table":
                self.expect_kw("table")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            if kind == "view":
                return A.DropView(self.qualified_name(), if_exists)
            return A.DropTable(self.qualified_name(), if_exists)
        if self.at_kw("describe", "desc"):
            self.next()
            if self.accept_kw("input"):
                return A.DescribeInput(self.identifier())
            if self.accept_kw("output"):
                return A.DescribeOutput(self.identifier())
            return A.Describe(self.qualified_name())
        if self.at_kw("prepare"):
            self.next()
            name = self.identifier()
            self.expect_kw("from")
            return A.Prepare(name, self._statement())
        if self.at_kw("execute"):
            self.next()
            name = self.identifier()
            params: List[A.Expression] = []
            if self.accept_kw("using"):
                params.append(self.expression())
                while self.accept_op(","):
                    params.append(self.expression())
            return A.ExecuteStmt(name, tuple(params))
        if self.at_kw("deallocate"):
            self.next()
            self.accept_kw("prepare")
            return A.Deallocate(self.identifier())
        if self.at_kw("call"):
            self.next()
            name = self.qualified_name()
            args: List[A.Expression] = []
            self.expect_op("(")
            if not self.at_op(")"):
                args.append(self.expression())
                while self.accept_op(","):
                    args.append(self.expression())
            self.expect_op(")")
            return A.CallStatement(name, tuple(args))
        if self.at_kw("start"):
            self.next()
            self.expect_kw("transaction")
            # isolation/read-only modifiers accepted and ignored
            while self.peek().kind != "eof":
                self.next()
            return A.StartTransaction()
        if self.at_kw("commit"):
            self.next()
            self.accept_kw("work")
            return A.Commit()
        if self.at_kw("rollback"):
            self.next()
            self.accept_kw("work")
            return A.Rollback()
        if self.at_kw("insert"):
            self.next()
            self.expect_kw("into")
            table = self.qualified_name()
            columns: Tuple[str, ...] = ()
            if self.at_op("(") and self._looks_like_column_list():
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                columns = tuple(cols)
            return A.Insert(table, columns, self.query())
        if self.at_kw("delete"):
            self.next()
            self.expect_kw("from")
            table = self.qualified_name()
            where = self.expression() if self.accept_kw("where") else None
            return A.Delete(table, where)
        if self.at_kw("update"):
            self.next()
            table = self.qualified_name()
            self.expect_kw("set")
            assigns = [self._assignment()]
            while self.accept_op(","):
                assigns.append(self._assignment())
            where = self.expression() if self.accept_kw("where") else None
            return A.Update(table, tuple(assigns), where)
        if self.at_kw("merge"):
            return self._merge()
        return A.QueryStatement(self.query())

    def _assignment(self):
        name = self.identifier()
        self.expect_op("=")
        return (name, self.expression())

    def _merge(self) -> "A.Merge":
        self.expect_kw("merge")
        self.expect_kw("into")
        target = self.qualified_name()
        alias = None
        if self.accept_kw("as"):
            alias = self.identifier()
        elif not self.at_kw("using"):
            alias = self.identifier()
        self.expect_kw("using")
        source = self._table_or_subquery()
        self.expect_kw("on")
        on = self.expression()
        clauses = []
        while self.at_kw("when"):
            self.next()
            matched = not self.accept_kw("not")
            self.expect_kw("matched")
            cond = self.expression() if self.accept_kw("and") else None
            self.expect_kw("then")
            if self.accept_kw("update"):
                self.expect_kw("set")
                assigns = [self._assignment()]
                while self.accept_op(","):
                    assigns.append(self._assignment())
                clauses.append(A.MergeClause(matched, cond, "update",
                                             tuple(assigns)))
            elif self.accept_kw("delete"):
                clauses.append(A.MergeClause(matched, cond, "delete"))
            else:
                self.expect_kw("insert")
                cols: List[str] = []
                if self.at_op("("):
                    self.expect_op("(")
                    cols.append(self.identifier())
                    while self.accept_op(","):
                        cols.append(self.identifier())
                    self.expect_op(")")
                self.expect_kw("values")
                self.expect_op("(")
                vals = [self.expression()]
                while self.accept_op(","):
                    vals.append(self.expression())
                self.expect_op(")")
                clauses.append(A.MergeClause(
                    matched, cond, "insert", (), tuple(cols),
                    tuple(vals)))
        if not clauses:
            t = self.peek()
            raise ParseError("MERGE requires at least one WHEN clause",
                             t.line, t.column)
        return A.Merge(target, alias, source, on, tuple(clauses))

    def _table_or_subquery(self) -> "A.Relation":
        if self.at_op("("):
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            rel: A.Relation = A.SubqueryRelation(q)
        else:
            rel = A.Table(self.qualified_name())
        return self._maybe_alias(rel)

    def _looks_like_column_list(self) -> bool:
        # distinguish INSERT INTO t (a, b) SELECT  from  INSERT INTO t (SELECT ...)
        return not self.at_kw("select", "with", "values", ahead=1)

    def _show(self) -> A.Statement:
        self.expect_kw("show")
        if self.accept_kw("tables"):
            schema = None
            if self.accept_kw("from", "in"):
                schema = self.qualified_name()
            like = None
            if self.accept_kw("like"):
                like = self.next().value
            return A.ShowTables(schema, like)
        if self.accept_kw("schemas"):
            catalog = None
            if self.accept_kw("from", "in"):
                catalog = self.identifier()
            return A.ShowSchemas(catalog)
        if self.accept_kw("catalogs"):
            return A.ShowCatalogs()
        if self.accept_kw("columns"):
            self.expect_kw("from")
            return A.ShowColumns(self.qualified_name())
        if self.accept_kw("session"):
            return A.ShowSession()
        if self.accept_kw("functions"):
            return A.ShowFunctions()
        if self.accept_kw("create"):
            kind = "view" if self.accept_kw("view") else "table"
            if kind == "table":
                self.expect_kw("table")
            return A.ShowCreate(kind, self.qualified_name())
        if self.accept_kw("stats"):
            self.expect_kw("for")
            return A.ShowStats(self.qualified_name())
        if self.accept_kw("grants"):
            table = None
            if self.accept_kw("on"):
                self.accept_kw("table")
                table = self.qualified_name()
            return A.ShowGrants(table)
        t = self.peek()
        raise ParseError(f"unsupported SHOW {t.value!r}", t.line, t.column)

    _PRIVILEGES = ("select", "insert", "delete", "update")

    def _privilege_list(self) -> Tuple[Tuple[str, ...], bool]:
        """privilege [, ...] | ALL PRIVILEGES -> (privs, is_all)."""
        if self.accept_kw("all"):
            self.accept_kw("privileges")
            return tuple(self._PRIVILEGES), True
        privs = []
        while True:
            t = self.peek()
            p = self.identifier().lower()
            if p not in self._PRIVILEGES:
                raise ParseError(f"unknown privilege {p!r}", t.line,
                                 t.column)
            privs.append(p)
            if not self.accept_op(","):
                break
        return tuple(privs), False

    def _grant(self) -> A.Statement:
        """GRANT/REVOKE/DENY (reference: sql/tree/{Grant,Revoke,Deny}
        grammar rules in SqlBase.g4)."""
        if self.accept_kw("grant"):
            privs, _ = self._privilege_list()
            self.expect_kw("on")
            self.accept_kw("table")
            table = self.qualified_name()
            self.expect_kw("to")
            self.accept_kw("user", "role")
            grantee = self.identifier()
            opt = False
            if self.accept_kw("with"):
                self.expect_kw("grant")
                self.expect_kw("option")
                opt = True
            return A.Grant(privs, table, grantee, opt)
        if self.accept_kw("deny"):
            privs, _ = self._privilege_list()
            self.expect_kw("on")
            self.accept_kw("table")
            table = self.qualified_name()
            self.expect_kw("to")
            self.accept_kw("user", "role")
            return A.Deny(privs, table, self.identifier())
        self.expect_kw("revoke")
        opt = False
        if self.accept_kw("grant"):
            self.expect_kw("option")
            self.expect_kw("for")
            opt = True
        privs, _ = self._privilege_list()
        self.expect_kw("on")
        self.accept_kw("table")
        table = self.qualified_name()
        self.expect_kw("from")
        self.accept_kw("user", "role")
        return A.Revoke(privs, table, self.identifier(), opt)

    def _create_table(self) -> A.Statement:
        self.expect_kw("create")
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.qualified_name()
        columns: List[A.ColumnDefinition] = []
        query = None
        if self.at_op("(") and not self.at_kw(
                "select", "with", "values", ahead=1):
            self.expect_op("(")
            while True:
                cname = self.identifier()
                ctype = self._type_name()
                nullable = True
                if self.accept_kw("not"):
                    self.expect_kw("null")
                    nullable = False
                columns.append(A.ColumnDefinition(cname, ctype, nullable))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        props: List[Tuple[str, A.Expression]] = []
        if self.accept_kw("with"):
            self.expect_op("(")
            while True:
                pname = self.identifier()
                self.expect_op("=")
                props.append((pname, self.expression()))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        if self.accept_kw("as"):
            if self.accept_op("("):
                query = self.query()
                self.expect_op(")")
            else:
                query = self.query()
        return A.CreateTable(name, tuple(columns), query, if_not_exists,
                             tuple(props))

    # --- queries ----------------------------------------------------------
    def query(self) -> A.Query:
        with_queries: List[A.WithQuery] = []
        if self.accept_kw("with"):
            self.accept_kw("recursive")
            while True:
                name = self.identifier()
                cols: Tuple[str, ...] = ()
                if self.accept_op("("):
                    cl = [self.identifier()]
                    while self.accept_op(","):
                        cl.append(self.identifier())
                    self.expect_op(")")
                    cols = tuple(cl)
                self.expect_kw("as")
                self.expect_op("(")
                q = self.query()
                self.expect_op(")")
                with_queries.append(A.WithQuery(name, q, cols))
                if not self.accept_op(","):
                    break
        body = self._set_operation()
        order_by: Tuple[A.SortItem, ...] = ()
        limit = None
        offset = 0
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by = self._sort_items()
        if self.accept_kw("offset"):
            offset = self.integer()
            self.accept_kw("rows", "row")
        if self.accept_kw("limit"):
            limit = None if self.accept_kw("all") else self.integer()
            # postgres-style trailing OFFSET (Trino puts OFFSET first;
            # accept both orders)
            if self.accept_kw("offset"):
                offset = self.integer()
                self.accept_kw("rows", "row")
        if self.accept_kw("fetch"):
            self.accept_kw("first", "next")
            limit = self.integer()
            self.accept_kw("rows", "row")
            self.accept_kw("only")
        if isinstance(body, A.QuerySpecification) and (
                order_by or limit is not None or offset):
            # ORDER BY / LIMIT / OFFSET of a plain SELECT live on the spec
            # (reference: SqlBase.g4 puts them at the query level; the
            # planner reads them off QuerySpecification for a simple query)
            body = A.QuerySpecification(
                body.select_items, body.distinct, body.from_, body.where,
                body.group_by, body.having, order_by, limit, offset)
            order_by, limit, offset = (), None, 0
        if not with_queries and not order_by and limit is None \
                and not offset:
            return A.Query(body)
        return A.Query(body, tuple(with_queries), order_by, limit, offset)

    def _set_operation(self) -> A.QueryBody:
        # UNION/EXCEPT level; INTERSECT binds tighter (SQL standard,
        # reference: SqlBase.g4 queryTerm stratification)
        left = self._intersect_term()
        while self.at_kw("union", "except"):
            op = self.next().value
            distinct = True
            if self.accept_kw("all"):
                distinct = False
            else:
                self.accept_kw("distinct")
            right = self._intersect_term()
            left = A.SetOperation(op, distinct, left, right)
        return left

    def _intersect_term(self) -> A.QueryBody:
        left = self._query_term()
        while self.at_kw("intersect"):
            self.next()
            distinct = True
            if self.accept_kw("all"):
                distinct = False
            else:
                self.accept_kw("distinct")
            right = self._query_term()
            left = A.SetOperation("intersect", distinct, left, right)
        return left

    def _query_term(self) -> A.QueryBody:
        if self.accept_op("("):
            q = self.query()
            self.expect_op(")")
            # flatten parenthesized query back into a body
            if (not q.with_queries and not q.order_by and q.limit is None
                    and not q.offset):
                return q.body
            # wrap: a parenthesized full query inside a set op — treat as
            # a subquery spec selecting all of it
            return A.QuerySpecification(
                select_items=(A.SelectItem(A.Star()),),
                from_=A.SubqueryRelation(q))
        if self.at_kw("values"):
            self.next()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return A.ValuesBody(tuple(rows))
        return self._query_spec()

    def _values_row(self) -> Tuple[A.Expression, ...]:
        if self.accept_op("("):
            items = [self.expression()]
            while self.accept_op(","):
                items.append(self.expression())
            self.expect_op(")")
            return tuple(items)
        return (self.expression(),)

    def _query_spec(self) -> A.QuerySpecification:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self._relation()
            while self.accept_op(","):
                right = self._relation()
                from_ = A.Join("cross", from_, right)
        where = self.expression() if self.accept_kw("where") else None
        group_by = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by = self._grouping()
        having = self.expression() if self.accept_kw("having") else None
        return A.QuerySpecification(tuple(items), distinct, from_, where,
                                    group_by, having)

    def _select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Star())
        # t.*  — lookahead: ident . *
        if (self.peek().kind in ("ident", "qident")
                and self.at_op(".", ahead=1) and self.at_op("*", ahead=2)):
            q = self.identifier()
            self.next()
            self.next()
            return A.SelectItem(A.Star(q))
        e = self.expression()
        alias = None
        if self.accept_kw("as"):
            alias = self.identifier()
        elif (self.peek().kind == "qident"
              or (self.peek().kind == "ident"
                  and self.peek().value not in _RESERVED_STOP)):
            alias = self.identifier()
        return A.SelectItem(e, alias)

    def _sort_items(self) -> Tuple[A.SortItem, ...]:
        items = [self._sort_item()]
        while self.accept_op(","):
            items.append(self._sort_item())
        return tuple(items)

    def _sort_item(self) -> A.SortItem:
        e = self.expression()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        else:
            self.accept_kw("asc")
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return A.SortItem(e, asc, nulls_first)

    def _grouping(self) -> A.GroupingSets:
        """GROUP BY list, with GROUPING SETS/ROLLUP/CUBE normalized to
        explicit index sets (reference: sql/analyzer groupingSets
        normalization in StatementAnalyzer)."""
        exprs: List[A.Expression] = []
        sets: List[Tuple[int, ...]] = []
        simple: List[int] = []

        def intern(e: A.Expression) -> int:
            exprs.append(e)
            return len(exprs) - 1

        def parse_set() -> Tuple[int, ...]:
            if self.accept_op("("):
                if self.accept_op(")"):
                    return ()
                ids = [intern(self.expression())]
                while self.accept_op(","):
                    ids.append(intern(self.expression()))
                self.expect_op(")")
                return tuple(ids)
            return (intern(self.expression()),)

        complex_sets: List[List[Tuple[int, ...]]] = []
        while True:
            if self.at_kw("grouping"):
                self.next()
                self.expect_kw("sets")
                self.expect_op("(")
                gs = [parse_set()]
                while self.accept_op(","):
                    gs.append(parse_set())
                self.expect_op(")")
                complex_sets.append(gs)
            elif self.at_kw("rollup"):
                self.next()
                self.expect_op("(")
                ids = [intern(self.expression())]
                while self.accept_op(","):
                    ids.append(intern(self.expression()))
                self.expect_op(")")
                complex_sets.append(
                    [tuple(ids[:k]) for k in range(len(ids), -1, -1)])
            elif self.at_kw("cube"):
                self.next()
                self.expect_op("(")
                ids = [intern(self.expression())]
                while self.accept_op(","):
                    ids.append(intern(self.expression()))
                self.expect_op(")")
                out = []
                for mask in range(1 << len(ids)):
                    out.append(tuple(ids[k] for k in range(len(ids))
                                     if mask & (1 << k)))
                complex_sets.append(out[::-1])
            else:
                simple.append(intern(self.expression()))
            if not self.accept_op(","):
                break
        if not complex_sets:
            sets = [tuple(simple)]
        else:
            # cross-product of grouping element sets, prefixed by simple cols
            base: List[Tuple[int, ...]] = [tuple(simple)]
            for gs in complex_sets:
                base = [b + s for b in base for s in gs]
            sets = base
        return A.GroupingSets(tuple(exprs), tuple(sets))

    # --- relations --------------------------------------------------------
    def _relation(self) -> A.Relation:
        left = self._sampled_relation()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self._sampled_relation()
                left = A.Join("cross", left, right)
                continue
            jt = None
            if self.at_kw("join"):
                jt = "inner"
            elif self.at_kw("inner") and self.at_kw("join", ahead=1):
                self.next()
                jt = "inner"
            elif self.at_kw("left", "right", "full"):
                jt = self.peek().value
                self.next()
                self.accept_kw("outer")
            if jt is None:
                return left
            self.expect_kw("join")
            right = self._sampled_relation()
            if self.accept_kw("on"):
                left = A.Join(jt, left, right, on=self.expression())
            elif self.accept_kw("using"):
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                left = A.Join(jt, left, right, using=tuple(cols))
            else:
                t = self.peek()
                raise ParseError("JOIN requires ON or USING",
                                 t.line, t.column)

    def _sampled_relation(self) -> A.Relation:
        rel = self._aliased_relation()
        if self.accept_kw("tablesample"):
            method = self.identifier()
            self.expect_op("(")
            pct = self.expression()
            self.expect_op(")")
            rel = A.TableSample(rel, method, pct)
            # alias may follow the sample
            rel = self._maybe_alias(rel)
        return rel

    def _aliased_relation(self) -> A.Relation:
        rel = self._primary_relation()
        return self._maybe_alias(rel)

    def _maybe_alias(self, rel: A.Relation) -> A.Relation:
        alias = None
        cols: Tuple[str, ...] = ()
        if self.accept_kw("as"):
            alias = self.identifier()
        elif (self.peek().kind == "qident"
              or (self.peek().kind == "ident"
                  and self.peek().value not in _RESERVED_STOP)):
            alias = self.identifier()
        if alias is not None:
            if self.at_op("(") and self.peek(1).kind in ("ident", "qident") \
                    and (self.at_op(",", ahead=2) or self.at_op(")", ahead=2)):
                self.expect_op("(")
                cl = [self.identifier()]
                while self.accept_op(","):
                    cl.append(self.identifier())
                self.expect_op(")")
                cols = tuple(cl)
            return A.AliasedRelation(rel, alias, cols)
        return rel

    def _primary_relation(self) -> A.Relation:
        if self.accept_op("("):
            if self.at_kw("select", "with", "values") or self.at_op("("):
                q = self.query()
                self.expect_op(")")
                return A.SubqueryRelation(q)
            rel = self._relation()
            self.expect_op(")")
            return rel
        if self.at_kw("unnest"):
            self.next()
            self.expect_op("(")
            exprs = [self.expression()]
            while self.accept_op(","):
                exprs.append(self.expression())
            self.expect_op(")")
            with_ord = False
            if self.accept_kw("with"):
                self.expect_kw("ordinality")
                with_ord = True
            return A.Unnest(tuple(exprs), with_ord)
        if self.at_kw("values"):
            self.next()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return A.ValuesRelation(tuple(rows))
        return A.Table(self.qualified_name())

    # --- expressions ------------------------------------------------------
    def expression(self) -> A.Expression:
        return self._or_expr()

    def _or_expr(self) -> A.Expression:
        left = self._and_expr()
        while self.accept_kw("or"):
            left = A.BinaryOp("or", left, self._and_expr())
        return left

    def _and_expr(self) -> A.Expression:
        left = self._not_expr()
        while self.accept_kw("and"):
            left = A.BinaryOp("and", left, self._not_expr())
        return left

    def _not_expr(self) -> A.Expression:
        if self.accept_kw("not"):
            return A.UnaryOp("not", self._not_expr())
        return self._predicate()

    def _predicate(self) -> A.Expression:
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return A.Exists(q)
        left = self._value_expr()
        while True:
            negated = False
            if self.at_kw("not") and self.at_kw(
                    "in", "like", "between", ahead=1):
                self.next()
                negated = True
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.query()
                    self.expect_op(")")
                    left = A.InSubquery(left, q, negated)
                else:
                    items = [self.expression()]
                    while self.accept_op(","):
                        items.append(self.expression())
                    self.expect_op(")")
                    left = A.InList(left, tuple(items), negated)
                continue
            if self.accept_kw("like"):
                pattern = self._value_expr()
                escape = None
                if self.accept_kw("escape"):
                    escape = self._value_expr()
                left = A.Like(left, pattern, escape, negated)
                continue
            if self.accept_kw("between"):
                low = self._value_expr()
                self.expect_kw("and")
                high = self._value_expr()
                left = A.Between(left, low, high, negated)
                continue
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                if self.accept_kw("null"):
                    left = A.IsNull(left, neg)
                elif self.accept_kw("distinct"):
                    self.expect_kw("from")
                    right = self._value_expr()
                    left = A.IsDistinctFrom(left, right, neg)
                elif self.accept_kw("true"):
                    # x IS [NOT] TRUE == x IS [NOT] NOT-DISTINCT-FROM TRUE
                    # (never NULL, unlike = under 3-valued logic)
                    left = A.IsDistinctFrom(left, A.Literal(True),
                                            negated=not neg)
                elif self.accept_kw("false"):
                    left = A.IsDistinctFrom(left, A.Literal(False),
                                            negated=not neg)
                else:
                    t = self.peek()
                    raise ParseError("expected NULL or DISTINCT after IS",
                                     t.line, t.column)
                continue
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                if self.at_kw("all", "any", "some"):
                    quant = self.next().value
                    self.expect_op("(")
                    q = self.query()
                    self.expect_op(")")
                    left = A.QuantifiedComparison(op, quant, left, q)
                else:
                    left = A.BinaryOp(op, left, self._value_expr())
                continue
            return left

    def _value_expr(self) -> A.Expression:
        left = self._additive()
        while self.at_op("||"):
            self.next()
            left = A.BinaryOp("||", left, self._additive())
        return left

    def _additive(self) -> A.Expression:
        left = self._multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().value
                left = A.BinaryOp(op, left, self._multiplicative())
                continue
            # expr AT TIME ZONE 'zone' (reference: AtTimeZone desugar)
            if (self.at_kw("at") and self.at_kw("time", ahead=1)
                    and self.at_kw("zone", ahead=2)):
                self.next()
                self.next()
                self.next()
                left = A.FunctionCall("at_timezone",
                                      (left, self._multiplicative()))
                continue
            return left

    def _multiplicative(self) -> A.Expression:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = A.BinaryOp(op, left, self._unary())
        return left

    def _unary(self) -> A.Expression:
        if self.at_op("-"):
            self.next()
            return A.UnaryOp("-", self._unary())
        if self.at_op("+"):
            self.next()
            return self._unary()
        return self._postfix()

    def _postfix(self) -> A.Expression:
        e = self._primary()
        while True:
            if self.at_op("["):
                self.next()
                idx = self.expression()
                self.expect_op("]")
                e = A.Subscript(e, idx)
                continue
            if (self.at_op(".") and isinstance(e, A.Identifier)
                    and self.peek(1).kind in ("ident", "qident")):
                self.next()
                e = A.Identifier(e.parts + (self.identifier(),))
                continue
            if (self.at_op(".") and not isinstance(e, A.Identifier)):
                # row-field dereference on a non-identifier base
                self.next()
                e = A.FunctionCall("$field", (e, A.Literal(
                    self.identifier())))
                continue
            return e

    def _primary(self) -> A.Expression:
        t = self.peek()
        if t.kind == "integer":
            self.next()
            return A.Literal(int(t.value))
        if t.kind == "decimal":
            self.next()
            return A.Literal(t.value, "decimal")
        if t.kind == "float":
            self.next()
            return A.Literal(float(t.value))
        if t.kind == "string":
            self.next()
            return A.Literal(t.value)
        if t.kind == "qident":
            return A.Identifier((self.identifier(),))
        if self.at_op("("):
            self.next()
            if self.at_kw("select", "with"):
                q = self.query()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.expression()
            if self.at_op(","):
                items = [e]
                while self.accept_op(","):
                    items.append(self.expression())
                self.expect_op(")")
                # (x, y) -> expr multi-parameter lambda
                if self.at_op("->", "=>") and all(
                        isinstance(i, A.Identifier) and len(i.parts) == 1
                        for i in items):
                    self.next()
                    return A.LambdaExpression(
                        tuple(i.parts[0] for i in items),
                        self.expression())
                return A.RowConstructor(tuple(items))
            self.expect_op(")")
            # (x) -> y lambda
            if self.at_op("->", "=>") and isinstance(e, A.Identifier) \
                    and len(e.parts) == 1:
                self.next()
                return A.LambdaExpression((e.parts[0],), self.expression())
            return e
        if self.at_op("?"):
            self.next()
            return A.Literal(None, "parameter")
        if t.kind != "ident":
            raise ParseError(f"unexpected token {t.value!r}",
                             t.line, t.column)
        kw = t.value
        if kw == "null":
            self.next()
            return A.Literal(None)
        if kw in ("true", "false"):
            self.next()
            return A.Literal(kw == "true")
        if kw in ("date", "timestamp", "time") and \
                self.peek(1).kind == "string":
            self.next()
            s = self.next().value
            return A.Literal(s, kw)
        if kw == "interval":
            self.next()
            sign = 1
            if self.accept_op("-"):
                sign = -1
            elif self.accept_op("+"):
                pass
            v = self.next()
            ut = self.peek()
            unit = self.identifier().rstrip("s")
            if unit not in _INTERVAL_UNITS:
                raise ParseError(f"invalid interval unit {unit!r}",
                                 ut.line, ut.column)
            # INTERVAL 'n' DAY TO SECOND — accept and keep leading unit
            if self.accept_kw("to"):
                self.identifier()
            return A.IntervalLiteral(v.value, unit, sign)
        if kw == "case":
            return self._case()
        if kw in ("cast", "try_cast"):
            self.next()
            self.expect_op("(")
            e = self.expression()
            self.expect_kw("as")
            tn = self._type_name()
            self.expect_op(")")
            return A.Cast(e, tn, safe=(kw == "try_cast"))
        if kw == "extract":
            self.next()
            self.expect_op("(")
            fld = self.identifier()
            if fld not in _EXTRACT_FIELDS:
                raise ParseError(f"invalid EXTRACT field {fld!r}",
                                 t.line, t.column)
            self.expect_kw("from")
            e = self.expression()
            self.expect_op(")")
            return A.Extract(fld, e)
        if kw == "substring" and self.at_op("(", ahead=1):
            # substring(x FROM a [FOR b]) or substring(x, a, b)
            self.next()
            self.expect_op("(")
            e = self.expression()
            if self.accept_kw("from"):
                start = self.expression()
                length = None
                if self.accept_kw("for"):
                    length = self.expression()
                self.expect_op(")")
                args = (e, start) if length is None else (e, start, length)
                return A.FunctionCall("substring", args)
            args = [e]
            while self.accept_op(","):
                args.append(self.expression())
            self.expect_op(")")
            return A.FunctionCall("substring", tuple(args))
        if kw == "position" and self.at_op("(", ahead=1):
            self.next()
            self.expect_op("(")
            sub = self.expression()
            self.expect_kw("in")
            s = self.expression()
            self.expect_op(")")
            return A.FunctionCall("strpos", (s, sub))
        if kw == "trim" and self.at_op("(", ahead=1):
            self.next()
            self.expect_op("(")
            fn = "trim"
            if self.at_kw("leading", "trailing", "both"):
                side = self.next().value
                fn = {"leading": "ltrim", "trailing": "rtrim",
                      "both": "trim"}[side]
                if self.accept_kw("from"):
                    e = self.expression()
                    self.expect_op(")")
                    return A.FunctionCall(fn, (e,))
                chars = self.expression()
                self.expect_kw("from")
                e = self.expression()
                self.expect_op(")")
                return A.FunctionCall(fn, (e, chars))
            e = self.expression()
            self.expect_op(")")
            return A.FunctionCall(fn, (e,))
        if kw == "array" and self.at_op("[", ahead=1):
            self.next()
            self.next()
            items = []
            if not self.at_op("]"):
                items.append(self.expression())
                while self.accept_op(","):
                    items.append(self.expression())
            self.expect_op("]")
            return A.ArrayConstructor(tuple(items))
        if kw == "row" and self.at_op("(", ahead=1):
            self.next()
            self.expect_op("(")
            items = [self.expression()]
            while self.accept_op(","):
                items.append(self.expression())
            self.expect_op(")")
            return A.RowConstructor(tuple(items))
        if kw in ("current_date", "current_timestamp", "current_time",
                  "localtime", "localtimestamp", "current_user"):
            self.next()
            if self.accept_op("("):
                self.expect_op(")")
            return A.FunctionCall(kw, ())
        # function call or plain identifier
        if self.at_op("(", ahead=1):
            return self._function_call()
        name = self.identifier()
        # single-param lambda:  x -> expr
        if self.at_op("->", "=>"):
            self.next()
            return A.LambdaExpression((name,), self.expression())
        return A.Identifier((name,))

    def _case(self) -> A.Expression:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expression()
        whens: List[Tuple[A.Expression, A.Expression]] = []
        while self.accept_kw("when"):
            cond = self.expression()
            if operand is not None:
                cond = A.BinaryOp("=", operand, cond)
            self.expect_kw("then")
            whens.append((cond, self.expression()))
        default = self.expression() if self.accept_kw("else") else None
        self.expect_kw("end")
        return A.Case(tuple(whens), default)

    def _function_call(self) -> A.Expression:
        name = self.identifier()
        self.expect_op("(")
        distinct = False
        args: List[A.Expression] = []
        order_by: Tuple[A.SortItem, ...] = ()
        if self.at_op("*"):
            self.next()
            self.expect_op(")")
            args = [A.Star()]
        else:
            if self.accept_kw("distinct"):
                distinct = True
            else:
                self.accept_kw("all")
            if not self.at_op(")"):
                args.append(self.expression())
                while self.accept_op(","):
                    args.append(self.expression())
            if self.accept_kw("order"):
                self.expect_kw("by")
                order_by = self._sort_items()
            self.expect_op(")")
        filt = None
        if self.at_kw("filter") and self.at_op("(", ahead=1):
            self.next()
            self.expect_op("(")
            self.expect_kw("where")
            filt = self.expression()
            self.expect_op(")")
        window = None
        if self.accept_kw("over"):
            window = self._window_spec()
        return A.FunctionCall(name, tuple(args), distinct, filt, order_by,
                              window)

    def _window_spec(self) -> A.WindowSpec:
        self.expect_op("(")
        partition: Tuple[A.Expression, ...] = ()
        order_by: Tuple[A.SortItem, ...] = ()
        frame = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            pl = [self.expression()]
            while self.accept_op(","):
                pl.append(self.expression())
            partition = tuple(pl)
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by = self._sort_items()
        if self.at_kw("rows", "range", "groups"):
            unit = self.next().value
            if self.accept_kw("between"):
                st, sv = self._frame_bound()
                self.expect_kw("and")
                et, ev = self._frame_bound()
            else:
                st, sv = self._frame_bound()
                et, ev = "current", None
            frame = A.WindowFrame(unit, st, sv, et, ev)
        self.expect_op(")")
        return A.WindowSpec(partition, order_by, frame)

    def _frame_bound(self) -> Tuple[str, Optional[A.Expression]]:
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return "unbounded_preceding", None
            self.expect_kw("following")
            return "unbounded_following", None
        if self.accept_kw("current"):
            self.expect_kw("row")
            return "current", None
        e = self.expression()
        if self.accept_kw("preceding"):
            return "preceding", e
        self.expect_kw("following")
        return "following", e

    def _type_name(self) -> str:
        base = self.identifier()
        if base == "double" and self.accept_kw("precision"):
            base = "double"
        if base == "interval":
            u1 = self.identifier()
            if self.accept_kw("to"):
                self.identifier()
            return ("interval day to second"
                    if u1.startswith(("day", "hour", "minute", "second"))
                    else "interval year to month")
        if base in ("array", "map", "row") and self.at_op("("):
            # parameters are themselves types (recursive), plus field
            # names for row(...)
            self.expect_op("(")
            inner: List[str] = []
            while True:
                if base == "row" and self.peek().kind in ("ident", "qident") \
                        and not self.at_op("(", ahead=1) \
                        and not self.at_op(",", ahead=1) \
                        and not self.at_op(")", ahead=1):
                    fname = self.identifier()
                    inner.append(f"{fname} {self._type_name()}")
                else:
                    inner.append(self._type_name())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return f"{base}({', '.join(inner)})"
        params: List[str] = []
        if self.accept_op("("):
            params.append(self.next().value)
            while self.accept_op(","):
                params.append(self.next().value)
            self.expect_op(")")
        name = f"{base}({','.join(params)})" if params else base
        if base in ("timestamp", "time") and self.at_kw("with", "without"):
            without = self.at_kw("without")
            self.next()
            self.expect_kw("time")
            self.expect_kw("zone")
            if not without:
                name += " with time zone"
        return name
