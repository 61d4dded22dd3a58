"""JDBC-class connector over a SQL database — the base-jdbc framework.

Counterpart of ``trino_tpu/connectors/jdbc.py``: ``SqliteConnector``
plays the remote system (sqlite3 is the one SQL database in the standard
library), metadata comes from the remote catalog, a split is one remote
query, and ``apply_filter``/``apply_limit`` push domains and limits into
its WHERE and LIMIT clauses (``domain_to_sql``, TupleDomain -> SQL text
with bound parameters). The remote rows land column by column on the
connector's device (cuda unless ``device="cpu"``): one fetchall,
transposed, each lane built by numpy from its value list.

Reference parity: plugin/trino-base-jdbc (JdbcClient, QueryBuilder).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..catalog import (ColumnMetadata, Connector, Split, TableHandle,
                       TableMetadata, accept_filter_pushdown,
                       accept_limit_pushdown)
from ..columnar import Batch, Column, StringDictionary, pad_batch
from ..config import DeviceLike, capacity_for, resolve_device
from ..types import BIGINT, BOOLEAN, DOUBLE, Type, VARCHAR, is_string

_TYPE_MAP = {
    "integer": BIGINT, "int": BIGINT, "bigint": BIGINT,
    "smallint": BIGINT, "tinyint": BIGINT,
    "real": DOUBLE, "double": DOUBLE, "float": DOUBLE,
    "numeric": DOUBLE, "decimal": DOUBLE,
    "text": VARCHAR, "varchar": VARCHAR, "char": VARCHAR,
    "clob": VARCHAR, "boolean": BOOLEAN, "date": VARCHAR,
}


def _sql_type(decl: str) -> Type:
    base = decl.split("(")[0].strip().lower() if decl else "text"
    return _TYPE_MAP.get(base, VARCHAR)


def _quote(ident: str) -> str:
    return '"' + ident.replace('"', '""') + '"'


def domain_to_sql(column: str, dom) -> Tuple[str, list]:
    """One column Domain -> (SQL predicate, parameters) — the WHERE
    half of base-jdbc's QueryBuilder.toPredicate."""
    if dom.is_all:
        return "1=1", []
    parts = []
    params: list = []
    for r in dom.ranges:
        if r.is_point():
            parts.append(f"{_quote(column)} = ?")
            params.append(r.low)
            continue
        conj = []
        if r.low is not None:
            conj.append(f"{_quote(column)} "
                        f"{'>=' if r.low_inclusive else '>'} ?")
            params.append(r.low)
        if r.high is not None:
            conj.append(f"{_quote(column)} "
                        f"{'<=' if r.high_inclusive else '<'} ?")
            params.append(r.high)
        if not conj:
            # unbounded range (e.g. the IS NOT NULL domain): matches
            # every non-null value
            parts.append("1=1")
        elif len(conj) > 1:
            parts.append("(" + " AND ".join(conj) + ")")
        else:
            parts.append(conj[0])
    pred = "(" + " OR ".join(parts) + ")" if parts else "1=0"
    if dom.null_allowed:
        pred = f"({pred} OR {_quote(column)} IS NULL)"
    else:
        pred = f"({pred} AND {_quote(column)} IS NOT NULL)"
    return pred, params


def lane_column(values: list, t: Type) -> Column:
    """A CPU column of python values (None is NULL), built by numpy."""
    arr = np.asarray(values, dtype=object)
    valid = np.not_equal(arr, None) if len(arr) else np.ones(0, bool)
    if is_string(t):
        strs = [v.decode("utf-8", "replace") if isinstance(v, bytes)
                else (None if v is None else str(v)) for v in values]
        d, codes = StringDictionary.from_strings(strs)
        return Column(t, codes, None if valid.all() else valid, d)
    fill = np.where(valid, arr, False if t is BOOLEAN else 0)
    data = fill.astype(bool if t is BOOLEAN else t.np_dtype)
    return Column(t, data, None if valid.all() else valid)


class SqliteConnector(Connector):
    """base-jdbc over sqlite3: schemas/tables/columns read from the
    remote catalog, filters and limits pushed into the remote query."""

    name = "jdbc"

    def __init__(self, database: str = ":memory:",
                 schema: str = "public", device: DeviceLike = None):
        self._db = database
        self._schema = schema
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(database, check_same_thread=False)
        self._col_cache: Dict[str, List[Tuple[str, Type]]] = {}
        # the last remote query a scan sent: (SQL text, parameters)
        self.last_remote: Optional[Tuple[str, list]] = None

    # -- remote access -------------------------------------------------
    def execute_remote(self, sql: str, params: Sequence = ()) -> list:
        """Run a statement on the remote side (test setup / the
        reference's TestingH2JdbcModule role). DDL/DML invalidates the
        column cache."""
        with self._lock:
            cur = self._conn.execute(sql, tuple(params))
            rows = cur.fetchall()
            self._conn.commit()
        if sql.lstrip()[:6].upper().startswith(("CREATE", "DROP",
                                                "ALTER")):
            self._col_cache.clear()
        return rows

    def load_rows(self, sql: str, rows) -> None:
        """``executemany`` of one statement over ``rows`` (bulk setup)."""
        with self._lock:
            self._conn.executemany(sql, rows)
            self._conn.commit()

    # -- metadata ------------------------------------------------------
    def list_schemas(self) -> List[str]:
        return [self._schema]

    def list_tables(self, schema: str) -> List[str]:
        if schema != self._schema:
            return []
        return [r[0].lower() for r in self.execute_remote(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "ORDER BY name")]

    def _columns(self, table: str) -> List[Tuple[str, Type]]:
        cached = self._col_cache.get(table)
        if cached is None:
            rows = self.execute_remote(
                f"PRAGMA table_info({_quote(table)})")
            cached = [(r[1].lower(), _sql_type(r[2])) for r in rows]
            self._col_cache[table] = cached
        return cached

    def get_table_metadata(self, schema: str,
                           table: str) -> Optional[TableMetadata]:
        if schema != self._schema \
                or table not in self.list_tables(schema):
            return None
        return TableMetadata(schema, table, tuple(
            ColumnMetadata(n, t) for n, t in self._columns(table)))

    def table_row_count(self, handle: TableHandle) -> Optional[float]:
        try:
            return float(self.execute_remote(
                f"SELECT count(*) FROM {_quote(handle.table)}")[0][0])
        except sqlite3.Error:
            return None

    # -- pushdown (applyFilter/applyLimit -> remote WHERE/LIMIT) -------
    def apply_filter(self, handle: TableHandle, constraint):
        return accept_filter_pushdown(handle, constraint)

    def apply_limit(self, handle: TableHandle, limit: int):
        return accept_limit_pushdown(handle, limit)

    # -- data ----------------------------------------------------------
    def get_splits(self, handle: TableHandle,
                   desired_parallelism: int = 1) -> List[Split]:
        return [Split(handle, 0, 1)]   # one remote query per scan

    def remote_sql(self, handle: TableHandle,
                   columns: Sequence[str]) -> Tuple[str, list]:
        """The remote query of a scan: its projection, the handle's
        domains as its WHERE clause and its limit."""
        sel = ", ".join(_quote(c) for c in columns)
        sql = f"SELECT {sel} FROM {_quote(handle.table)}"
        params: list = []
        if handle.constraint is not None \
                and not handle.constraint.is_all():
            if handle.constraint.is_none:
                sql += " WHERE 1=0"
            else:
                preds = []
                for col, dom in handle.constraint.domains:
                    p, ps = domain_to_sql(col, dom)
                    preds.append(p)
                    params.extend(ps)
                sql += " WHERE " + " AND ".join(preds)
        if handle.limit is not None:
            sql += f" LIMIT {int(handle.limit)}"
        return sql, params

    def read_split(self, split: Split,
                   columns: Sequence[str]) -> Batch:
        handle = split.handle
        cols = list(columns) or [
            n for n, _ in self._columns(handle.table)][:1]
        types = dict(self._columns(handle.table))
        sql, params = self.remote_sql(handle, cols)
        self.last_remote = (sql, params)
        rows = self.execute_remote(sql, params)
        # C-speed transpose: rows -> one value list per column
        lanes = (list(map(list, zip(*rows))) if rows
                 else [[] for _ in cols])
        out = {c: lane_column(lane, types.get(c, VARCHAR))
               for c, lane in zip(cols, lanes)}
        n = len(rows)
        batch = pad_batch(Batch(out, n), capacity_for(n, minimum=8))
        return batch.select_columns(list(columns)).to(self.device)
