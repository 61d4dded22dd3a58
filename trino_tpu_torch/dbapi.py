"""PEP 249 (DB-API 2.0) driver over the client protocol.

Counterpart of ``trino_tpu/dbapi.py`` (host only).

Reference parity: client/trino-jdbc (10.2k loc, JDBC 4 over
trino-client). Python's database ecosystem equivalent of JDBC is
DB-API 2.0, so this module plays the trino-jdbc role: ``connect()`` /
``Connection`` / ``Cursor`` with qmark-style parameter binding
(rendered through PREPARE/EXECUTE on the server), ``description``
metadata, fetchone/fetchmany/fetchall, and iteration.

    from trino_tpu_torch.dbapi import connect
    conn = connect("http://127.0.0.1:8080", user="alice")
    cur = conn.cursor()
    cur.execute("SELECT n_name FROM tpch.tiny.nation WHERE "
                "n_nationkey = ?", (3,))
    print(cur.fetchall())
"""

from __future__ import annotations

import datetime
import itertools
from typing import Any, List, Optional, Sequence, Tuple

from .client import ClientError, StatementClient

apilevel = "2.0"
threadsafety = 1          # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class ProgrammingError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


def connect(uri: str, user: str = "user", catalog: str = "tpch",
            schema: str = "tiny", **kw) -> "Connection":
    return Connection(uri, user=user, catalog=catalog, schema=schema,
                      **kw)


class Connection:
    def __init__(self, uri: str, user: str = "user",
                 catalog: str = "tpch", schema: str = "tiny",
                 session_properties=None, timeout: float = 600.0):
        self._client = StatementClient(
            uri, user=user, catalog=catalog, schema=schema,
            session_properties=session_properties, timeout=timeout)
        self._closed = False

    # --- DB-API surface --------------------------------------------------
    def cursor(self) -> "Cursor":
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def close(self) -> None:
        self._closed = True

    def commit(self) -> None:
        """Engine statements auto-commit; explicit transactions go
        through cursor.execute('START TRANSACTION') etc."""

    def rollback(self) -> None:
        raise OperationalError(
            "rollback() outside an explicit transaction; run "
            "START TRANSACTION / ROLLBACK statements instead")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_PREP_COUNTER = itertools.count(1)


def _render_param(v: Any) -> str:
    """Literal rendering for qmark parameters (the reference JDBC
    driver binds through PREPARE/EXECUTE; we inline EXECUTE ... USING
    literals, which round-trips through the same parameter machinery
    server-side)."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, float):
        import math
        if math.isnan(v):
            return "nan()"
        if math.isinf(v):
            return "infinity()" if v > 0 else "-infinity()"
        return repr(v)
    if isinstance(v, int):
        return repr(v)
    import decimal
    if isinstance(v, decimal.Decimal):
        return str(v)          # lexes as an exact DECIMAL literal
    if isinstance(v, datetime.datetime):
        return f"TIMESTAMP '{v.isoformat(sep=' ')}'"
    if isinstance(v, datetime.date):
        return f"DATE '{v.isoformat()}'"
    s = str(v).replace("'", "''")
    return f"'{s}'"


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection):
        self._conn = conn
        self._rows: List[list] = []
        self._pos = 0
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1
        self.query_id: Optional[str] = None

    # --- execution -------------------------------------------------------
    def execute(self, operation: str,
                parameters: Optional[Sequence] = None) -> "Cursor":
        if self._conn._closed:
            raise InterfaceError("connection is closed")
        client = self._conn._client
        sql = operation
        try:
            if parameters:
                name = f"dbapi_{next(_PREP_COUNTER)}"
                client.execute(f"PREPARE {name} FROM {operation}")
                args = ", ".join(_render_param(p) for p in parameters)
                try:
                    res = client.execute(f"EXECUTE {name} USING {args}")
                finally:
                    try:
                        client.execute(f"DEALLOCATE PREPARE {name}")
                    except ClientError:
                        pass
            else:
                res = client.execute(sql)
        except ClientError as e:
            raise ProgrammingError(str(e)) from e
        self._rows = res.rows
        self._pos = 0
        self.query_id = res.query_id
        self.description = [
            (c["name"], c.get("type"), None, None, None, None, None)
            for c in res.columns] or None
        self.rowcount = (res.update_count
                         if res.update_count is not None
                         else len(res.rows))
        return self

    def executemany(self, operation: str,
                    seq_of_parameters: Sequence[Sequence]) -> "Cursor":
        for params in seq_of_parameters:
            self.execute(operation, params)
        return self

    # --- fetching --------------------------------------------------------
    def fetchone(self) -> Optional[list]:
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[list]:
        n = size if size is not None else self.arraysize
        out = self._rows[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[list]:
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self) -> None:
        self._rows = []

    def setinputsizes(self, sizes) -> None:
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass
