"""The PyTorch engine's file and database connectors, record decoders,
plugin loader and test toolkit against the JAX engine's, on the CPU.

Every case of tests/test_jdbc_connector.py, tests/test_record_decoder.py,
tests/test_decoder_toolkit.py and tests/test_plugin_loader.py runs here
against the port; CSV and JSON tables, CTAS/INSERT/DROP in both file
formats and the filter and limit pushdown into localfile and sqlite are
held equal to the JAX engine's rows.
"""

import json
import sys
import textwrap

import numpy as np
import pytest

from trino_tpu.connectors.jdbc import SqliteConnector as JaxSqlite
from trino_tpu.connectors.localfile import \
    LocalFileConnector as JaxLocalFile
from trino_tpu.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import plugin
from trino_tpu_torch.catalog import CatalogManager
from trino_tpu_torch.connectors.jdbc import SqliteConnector, domain_to_sql
from trino_tpu_torch.connectors.localfile import LocalFileConnector
from trino_tpu_torch.formats.record_decoder import (CsvRowDecoder,
                                                    DecoderField,
                                                    JsonRowDecoder,
                                                    RawRowDecoder,
                                                    create_decoder)
from trino_tpu_torch.plan.nodes import TableScanNode
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session
from trino_tpu_torch.testing import (TestingConnector, assert_query,
                                     assert_query_fails)
from trino_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, VARCHAR

CPU = "cpu"
REL = 1e-9


def _scans(n):
    out = [n] if isinstance(n, TableScanNode) else []
    for s in n.sources:
        out.extend(_scans(s))
    return out


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=REL)
            else:
                assert a == b


# --------------------------------------------------------------------------
# tests/test_jdbc_connector.py
# --------------------------------------------------------------------------

EMP = [(1, "ann", "eng", 120.0), (2, "bo", "eng", 95.5),
       (3, "cy", "ops", 80.0), (4, None, "ops", None),
       (5, "di", None, 110.25)]


def _emp(conn):
    conn.execute_remote(
        "CREATE TABLE emp (id INTEGER, name TEXT, dept TEXT, "
        "salary DOUBLE)")
    for row in EMP:
        conn.execute_remote("INSERT INTO emp VALUES (?,?,?,?)", row)
    return conn


@pytest.fixture
def runner():
    conn = _emp(SqliteConnector(device=CPU))
    r = LocalQueryRunner(device=CPU)
    r.catalogs.register("pg", conn)
    return r, conn


@pytest.fixture
def jax_runner():
    r = JaxRunner()
    r.catalogs.register("pg", _emp(JaxSqlite()))
    return r


def test_metadata_and_full_scan(runner, jax_runner):
    r, _ = runner
    assert r.execute("SHOW TABLES FROM pg.public").rows == [["emp"]]
    sql = "SELECT id, name, salary FROM pg.public.emp ORDER BY id"
    rows = r.execute(sql).rows
    assert rows[0] == [1, "ann", 120.0]
    assert rows[3] == [4, None, None]
    assert rows == jax_runner.execute(sql).rows


def test_filter_pushdown_reaches_remote(runner, jax_runner):
    r, conn = runner
    # plan check: the domain lands in the handle (pushed remote)
    plan = r.plan_sql("SELECT id FROM pg.public.emp WHERE id >= 3")
    sc = _scans(plan)
    assert sc and sc[0].handle.constraint is not None
    sql = "SELECT id FROM pg.public.emp WHERE id >= 3 ORDER BY id"
    got = r.execute(sql).rows
    exp = conn.execute_remote(
        "SELECT id FROM emp WHERE id >= 3 ORDER BY id")
    assert [tuple(x) for x in got] == exp
    # ... and into the remote WHERE clause
    remote, params = conn.last_remote
    assert '"id" >= ?' in remote and params == [3]
    assert got == jax_runner.execute(sql).rows


def test_aggregation_joins_against_engine_tables(runner, jax_runner):
    r, _ = runner
    sqls = ["SELECT dept, count(*), sum(salary) FROM pg.public.emp "
            "WHERE dept IS NOT NULL GROUP BY dept ORDER BY dept",
            "SELECT e.name, n.n_name FROM pg.public.emp e "
            "JOIN tpch.tiny.nation n ON e.id = n.n_nationkey "
            "WHERE e.id <= 2 ORDER BY e.id"]
    assert r.execute(sqls[0]).rows == [["eng", 2, 215.5], ["ops", 2, 80.0]]
    # join remote against a generator table
    assert r.execute(sqls[1]).rows == [["ann", "ARGENTINA"],
                                       ["bo", "BRAZIL"]]
    for s in sqls:
        assert r.execute(s).rows == jax_runner.execute(s).rows


def test_limit_pushdown(runner):
    r, conn = runner
    rows = r.execute("SELECT id FROM pg.public.emp LIMIT 2").rows
    assert len(rows) == 2
    assert conn.last_remote[0].endswith("LIMIT 2")


def test_domain_to_sql_shapes():
    from trino_tpu.connectors.jdbc import domain_to_sql as jax_domain_sql
    from trino_tpu.predicate import Domain as JDomain, Range as JRange
    from trino_tpu.types import BIGINT as J_BIGINT
    from trino_tpu_torch.predicate import Domain, Range
    d = Domain(BIGINT, (Range(1, True, 1, True),
                        Range(5, False, 9, True)))
    sql, params = domain_to_sql("x", d)
    assert '"x" = ?' in sql and params == [1, 5, 9]
    assert "IS NOT NULL" in sql
    d2 = Domain(BIGINT, (), True)       # only null
    sql2, p2 = domain_to_sql("x", d2)
    assert "IS NULL" in sql2 and p2 == []
    jd = JDomain(J_BIGINT, (JRange(1, True, 1, True),
                            JRange(5, False, 9, True)))
    assert (sql, params) == jax_domain_sql("x", jd)
    assert (sql2, p2) == jax_domain_sql("x", JDomain(J_BIGINT, (), True))


def test_jdbc_rows_land_on_the_connectors_device():
    conn = _emp(SqliteConnector(device=CPU))
    r = LocalQueryRunner(device=CPU)
    r.catalogs.register("pg", conn)
    handle, _ = r.catalogs.resolve_table("pg", "public", "emp")
    from trino_tpu_torch.catalog import Split
    b = conn.read_split(Split(handle, 0, 1), ["id", "name", "salary"])
    assert b.device.type == "cpu" and b.num_rows_host() == 5
    assert b.to_pylist() == [[i, n, s] for i, n, _, s in EMP]


@pytest.mark.parametrize("where", [
    "o_custkey BETWEEN 100 AND 600",
    "o_orderpriority IN ('1-URGENT', '5-LOW') AND o_totalprice > 150000",
    "o_custkey < 50 OR o_custkey >= 1400",
    "o_orderkey IS NOT NULL AND o_totalprice < 2000"])
def test_sqlite_pushdown_equals_the_engine_over_tpch(where):
    """orders of tpch.tiny loaded into sqlite: a grouped query with its
    domains pushed into the remote SQL equals the same query over
    tpch.tiny.orders, in the port and in the JAX engine."""
    cols = "o_orderkey, o_custkey, o_totalprice, o_orderpriority"
    port = LocalQueryRunner(device=CPU)
    rows = port.execute(f"SELECT {cols} FROM tpch.tiny.orders").rows
    runners = []
    for mk, r in ((SqliteConnector, port), (JaxSqlite, JaxRunner())):
        conn = mk(device=CPU) if mk is SqliteConnector else mk()
        conn.execute_remote("CREATE TABLE orders (o_orderkey BIGINT, "
                            "o_custkey BIGINT, o_totalprice DOUBLE, "
                            "o_orderpriority TEXT)")
        for row in rows:
            conn.execute_remote("INSERT INTO orders VALUES (?,?,?,?)", row)
        r.catalogs.register("lite", conn)
        runners.append((r, conn))
    q = ("SELECT o_orderpriority, count(*), sum(o_totalprice) FROM {t} "
         f"WHERE {where} GROUP BY 1 ORDER BY 1")
    got = port.execute(q.format(t="lite.public.orders")).rows
    _same_rows(got, port.execute(q.format(t="tpch.tiny.orders")).rows)
    _same_rows(got, runners[1][0].execute(
        q.format(t="lite.public.orders")).rows)
    remote, _ = runners[0][1].last_remote
    assert " WHERE " in remote


# --------------------------------------------------------------------------
# localfile: CSV/JSON, CTAS/INSERT/DROP, pushdown
# --------------------------------------------------------------------------

@pytest.fixture
def files(tmp_path):
    with open(tmp_path / "people.csv", "w") as f:
        f.write("name,age,score,member\nalice,30,1.5,true\n"
                "bob,25,2.25,false\ncarol,,3.0,\n")
    with open(tmp_path / "grid.tsv", "w") as f:
        f.write("x\ty\n1\tone\n2\ttwo\n3\t\n")
    with open(tmp_path / "events.ndjson", "w") as f:
        for k, n, ok in (("click", 3, True), ("view", 7, False),
                         ("click", 1.5, None), ("buy", None, True)):
            f.write(json.dumps({"Kind": k, "n": n, "ok": ok}) + "\n")
    return tmp_path


def _both(path, fmt="parquet"):
    port = LocalFileConnector(str(path), device=CPU)
    jax = JaxLocalFile(str(path))
    port.write_format = jax.write_format = fmt
    pr, jr = LocalQueryRunner(device=CPU), JaxRunner()
    pr.catalogs.register("files", port)
    jr.catalogs.register("files", jax)
    return pr, jr


@pytest.mark.parametrize("sql", [
    "SELECT * FROM files.default.people ORDER BY name",
    "SELECT name, age + 1, score * 2 FROM files.default.people "
    "WHERE age IS NOT NULL ORDER BY age",
    "SELECT count(*), sum(x) FROM files.default.grid WHERE y IS NULL",
    "SELECT kind, count(*), sum(n), count(ok) FROM files.default.events "
    "GROUP BY kind ORDER BY kind",
    "SELECT * FROM files.default.events WHERE ok ORDER BY kind",
])
def test_csv_json_tables_equal_the_jax_engine(files, sql):
    pr, jr = _both(files)
    _same_rows(pr.execute(sql).rows, jr.execute(sql).rows)


def test_csv_json_schemas_equal_the_jax_engine(files):
    pr, jr = _both(files)
    for t in ("people", "grid", "events"):
        sql = f"DESCRIBE files.default.{t}"
        assert pr.execute(sql).rows == jr.execute(sql).rows


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_ctas_insert_drop_equal_the_jax_engine(tmp_path, fmt):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    pr, _ = _both(tmp_path / "p", fmt)
    _, jr = _both(tmp_path / "j", fmt)
    stmts = [
        "CREATE TABLE files.default.o AS SELECT o_orderkey, o_custkey, "
        "o_orderstatus, o_totalprice, o_orderdate FROM tpch.tiny.orders "
        "WHERE o_orderkey < 3000",
        "INSERT INTO files.default.o SELECT o_orderkey, o_custkey, "
        "o_orderstatus, o_totalprice, o_orderdate FROM tpch.tiny.orders "
        "WHERE o_orderkey BETWEEN 3000 AND 4000",
        "INSERT INTO files.default.o (o_orderkey, o_orderstatus) "
        "VALUES (99999, 'X')",
        "CREATE TABLE files.default.t (a BIGINT, b VARCHAR, c BOOLEAN, "
        "d DATE, e DOUBLE, f INTEGER)",
        "INSERT INTO files.default.t VALUES (1, 'é', true, DATE "
        "'2020-02-29', 0.5, 7), (NULL, NULL, NULL, NULL, NULL, NULL)"]
    for s in stmts:
        assert pr.execute(s).update_count == jr.execute(s).update_count
    for t in ("o", "t"):
        assert (tmp_path / "p" / f"{t}.{fmt}").read_bytes() == \
            (tmp_path / "j" / f"{t}.{fmt}").read_bytes()
    for q in ["SELECT o_orderstatus, count(*), sum(o_totalprice), "
              "min(o_orderdate), max(o_custkey) FROM files.default.o "
              "GROUP BY 1 ORDER BY 1",
              "SELECT * FROM files.default.t ORDER BY a"]:
        _same_rows(pr.execute(q).rows, jr.execute(q).rows)
    with pytest.raises(Exception, match="cannot"):
        pr.execute("CREATE TABLE files.default.bad (x SMALLINT)")
    for t in ("o", "t"):
        pr.execute(f"DROP TABLE files.default.{t}")
    assert not list((tmp_path / "p").iterdir())


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_localfile_pushdown_is_enforced_in_read_split(tmp_path, fmt):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    pr, _ = _both(tmp_path / "p", fmt)
    _, jr = _both(tmp_path / "j", fmt)
    for r in (pr, jr):
        r.execute("CREATE TABLE files.default.li AS SELECT l_orderkey, "
                  "l_quantity, l_discount, l_shipdate, l_returnflag "
                  "FROM tpch.tiny.lineitem")
    sql = ("SELECT l_returnflag, count(*), sum(l_quantity) FROM "
           "files.default.li WHERE l_shipdate >= DATE '1994-01-01' AND "
           "l_shipdate < DATE '1995-01-01' AND l_discount BETWEEN 0.05 "
           "AND 0.07 AND l_quantity < 24 GROUP BY 1 ORDER BY 1")
    sc = _scans(pr.plan_sql(sql))
    assert sc and sc[0].handle.constraint is not None
    got = pr.execute(sql).rows
    _same_rows(got, jr.execute(sql).rows)
    _same_rows(got, pr.execute(sql.replace("files.default.li",
                                           "tpch.tiny.lineitem")).rows)
    # a pushed limit still returns the limit's rows
    assert len(pr.execute("SELECT l_orderkey FROM files.default.li "
                          "LIMIT 7").rows) == 7


def test_localfile_splits_per_row_group(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    pa = pytest.importorskip("pyarrow")
    n = 5000
    rng = np.random.default_rng(1)
    pq.write_table(pa.table({"k": pa.array(np.arange(n)),
                             "v": pa.array(rng.normal(size=n))}),
                   tmp_path / "t.parquet", row_group_size=700)
    pr, jr = _both(tmp_path)
    conn = pr.catalogs.connector("files")
    handle, _ = pr.catalogs.resolve_table("files", "default", "t")
    assert len(conn.get_splits(handle)) == 8
    sql = "SELECT count(*), sum(v), max(k) FROM files.default.t WHERE k > 99"
    _same_rows(pr.execute(sql).rows, jr.execute(sql).rows)


# --------------------------------------------------------------------------
# tests/test_record_decoder.py
# --------------------------------------------------------------------------

def _rows(batch):
    return batch.to_pylist()


def _jax_rows(kind, fields, messages):
    from trino_tpu.formats.record_decoder import (
        DecoderField as JField, create_decoder as jax_create)
    return jax_create(kind, [JField(f.name, _jax_type(f.type), f.mapping)
                             for f in fields]).decode(messages).to_pylist()


def _jax_type(t):
    from trino_tpu import types as jt
    return jt.parse_type(str(t))


def test_json_decodes_fields_and_paths():
    fields = [DecoderField("k", BIGINT),
              DecoderField("nested", DOUBLE, "a.b"),
              DecoderField("first", VARCHAR, "tags/0")]
    msgs = [b'{"k": 1, "a": {"b": 2.5}, "tags": ["x", "y"]}',
            b'{"k": 2, "a": {}, "tags": []}']
    rows = _rows(JsonRowDecoder(fields, CPU).decode(msgs))
    assert rows == [[1, 2.5, "x"], [2, None, None]]
    assert rows == _jax_rows("json", fields, msgs)


def test_json_malformed_message_is_null_lane_row_not_error():
    fields = [DecoderField("k", BIGINT), DecoderField("v", VARCHAR)]
    msgs = [b'{"k": 1, "v": "ok"}', b'{"k": truncated',
            b"\xff\xfe not even text", b"", b'{"k": 2, "v": "also ok"}']
    rows = _rows(JsonRowDecoder(fields, CPU).decode(msgs))
    assert rows[0] == [1, "ok"]
    assert rows[1] == [None, None]
    assert rows[2] == [None, None]
    assert rows[3] == [None, None]
    assert rows[4] == [2, "also ok"]
    assert rows == _jax_rows("json", fields, msgs)


def test_json_type_coercion_failures_are_null_not_error():
    fields = [DecoderField("n", BIGINT), DecoderField("b", BOOLEAN),
              DecoderField("s", VARCHAR)]
    msgs = [b'{"n": "not-a-number", "b": "true", "s": {"obj": 1}}']
    rows = _rows(JsonRowDecoder(fields, CPU).decode(msgs))
    assert rows == [[None, True, '{"obj": 1}']]
    assert rows == _jax_rows("json", fields, msgs)


def test_csv_decodes_by_index_mapping():
    fields = [DecoderField("name", VARCHAR, "0"),
              DecoderField("qty", BIGINT, "1")]
    msgs = [b"widget,3", b'"a,b",7']
    rows = _rows(CsvRowDecoder(fields, CPU).decode(msgs))
    assert rows == [["widget", 3], ["a,b", 7]]
    assert rows == _jax_rows("csv", fields, msgs)


def test_csv_requires_numeric_mapping():
    with pytest.raises(ValueError, match="numeric mapping"):
        CsvRowDecoder([DecoderField("name", VARCHAR)], CPU)
    with pytest.raises(ValueError, match="numeric mapping"):
        CsvRowDecoder([DecoderField("name", VARCHAR, "zero")], CPU)


def test_csv_nul_invalid_utf8_and_short_rows_are_null_lanes():
    fields = [DecoderField("a", VARCHAR, "0"),
              DecoderField("n", BIGINT, "1")]
    msgs = [b"ok,1", b"x\x00y,2", b"\xff\xfe,3", b"only-one-field", b""]
    rows = _rows(CsvRowDecoder(fields, CPU).decode(msgs))
    assert rows[0] == ["ok", 1]
    assert rows[1][1] in (2, None)
    assert rows[2][1] in (3, None)
    assert rows[3] == ["only-one-field", None]
    assert rows[4] == [None, None]
    assert rows == _jax_rows("csv", fields, msgs)


def test_raw_whole_message_single_field():
    fields = [DecoderField("_message", VARCHAR)]
    rows = _rows(RawRowDecoder(fields, CPU).decode([b"hello",
                                                    b"\xffworld"]))
    assert rows[0] == ["hello"]
    assert "world" in rows[1][0]
    assert rows == _jax_rows("raw", fields, [b"hello", b"\xffworld"])


def test_create_decoder_dispatch_and_unknown_kind():
    assert isinstance(
        create_decoder("json", [DecoderField("k", BIGINT)], CPU),
        JsonRowDecoder)
    assert isinstance(
        create_decoder("csv", [DecoderField("k", BIGINT, "0")], CPU),
        CsvRowDecoder)
    assert isinstance(
        create_decoder("raw", [DecoderField("m", VARCHAR)], CPU),
        RawRowDecoder)
    with pytest.raises(ValueError, match="unknown decoder"):
        create_decoder("avro", [DecoderField("k", BIGINT)], CPU)


# --------------------------------------------------------------------------
# tests/test_decoder_toolkit.py
# --------------------------------------------------------------------------

def test_json_decoder_paths_and_nulls():
    fields = [DecoderField("id", BIGINT, "user.id"),
              DecoderField("name", VARCHAR, "user.name"),
              DecoderField("score", DOUBLE, "score"),
              DecoderField("ok", BOOLEAN, "flags.ok")]
    msgs = [b'{"user": {"id": 1, "name": "a"}, "score": 1.5,'
            b' "flags": {"ok": true}}',
            b'{"user": {"id": 2}, "score": "2.5"}',
            b'not json at all']
    rows = create_decoder("json", fields, CPU).decode(msgs).to_pylist()
    assert rows == [[1, "a", 1.5, True], [2, None, 2.5, None],
                    [None, None, None, None]]
    assert rows == _jax_rows("json", fields, msgs)


def test_csv_decoder_indices():
    fields = [DecoderField("a", BIGINT, "0"), DecoderField("b", VARCHAR, "2")]
    msgs = [b"1,x,alpha", b'2,y,"q,uoted"', b"3"]
    rows = create_decoder("csv", fields, CPU).decode(msgs).to_pylist()
    assert rows == [[1, "alpha"], [2, "q,uoted"], [3, None]]
    assert rows == _jax_rows("csv", fields, msgs)


def test_raw_decoder_and_unknown_kind():
    dec = create_decoder("raw", [DecoderField("msg", VARCHAR)], CPU)
    assert dec.decode([b"hello", b"world"]).to_pylist() == \
        [["hello"], ["world"]]
    with pytest.raises(ValueError, match="unknown decoder"):
        create_decoder("avro", [], CPU)


def test_testing_connector_and_assertions():
    conn = TestingConnector(device=CPU)
    conn.add_table("people", {"id": BIGINT, "city": VARCHAR},
                   [{"id": 1, "city": "oslo"},
                    {"id": 2, "city": "lima"},
                    {"id": 3, "city": None}])
    r = LocalQueryRunner(device=CPU)
    r.catalogs.register("t", conn)
    assert_query(r, "SELECT city, count(*) FROM t.default.people "
                    "GROUP BY city",
                 [["oslo", 1], ["lima", 1], [None, 1]])
    assert_query(r, "SELECT id FROM t.default.people ORDER BY id DESC",
                 [[3], [2], [1]], ordered=True)
    assert_query_fails(r, "SELECT nope FROM t.default.people",
                       "cannot be resolved")
    with pytest.raises(AssertionError):
        assert_query(r, "SELECT 1", [[2]])


# --------------------------------------------------------------------------
# tests/test_plugin_loader.py
# --------------------------------------------------------------------------

@pytest.fixture()
def plugin_module(tmp_path, monkeypatch):
    p = tmp_path / "my_torch_test_plugin.py"
    p.write_text(textwrap.dedent("""
        import numpy as np
        import torch

        from trino_tpu_torch.catalog import (ColumnMetadata, Connector,
                                             TableMetadata)
        from trino_tpu_torch.columnar import Batch, Column
        from trino_tpu_torch.exec.expr import eval_expr
        from trino_tpu_torch.types import BIGINT


        class TinyConnector(Connector):
            name = "tiny"

            def __init__(self, start, device="cpu"):
                self.start = start
                self.device = device

            def list_schemas(self):
                return ["default"]

            def list_tables(self, schema):
                return ["nums"]

            def get_table_metadata(self, schema, table):
                if (schema, table) != ("default", "nums"):
                    return None
                return TableMetadata(
                    "default", "nums",
                    [ColumnMetadata("n", BIGINT)])

            def read_split(self, split, columns):
                data = np.arange(self.start, self.start + 4,
                                 dtype=np.int64)
                return Batch({"n": Column(BIGINT, data)}, 4).to(
                    torch.device(self.device))


        def get_connector_factories():
            return [("tiny", lambda name, props: TinyConnector(
                int(props.get("tiny.start", "0"))))]


        def _triple(e, batch):
            a = eval_expr(e.args[0], batch)
            return Column(BIGINT, a.data * 3, a.valid)


        def get_functions():
            return [("triple", lambda n, a: BIGINT, _triple)]
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    yield "my_torch_test_plugin"
    sys.modules.pop("my_torch_test_plugin", None)


def test_load_plugin_and_query(plugin_module):
    added = plugin.load_plugin(plugin_module)
    assert "tiny" in added and "triple" in added
    conn = plugin.create_connector("tiny", "t1", {"tiny.start": "10"})
    cats = CatalogManager()
    cats.register("t1", conn)
    r = LocalQueryRunner(
        session=Session(catalog="t1", schema="default"), device=CPU,
        catalogs=cats)
    assert r.execute("SELECT sum(n) FROM nums").rows == [[10+11+12+13]]
    # the plugin's function reaches the port's dispatch
    assert r.execute("SELECT sum(triple(n)) FROM nums").rows == [[138]]


def test_create_connector_module_ref(plugin_module):
    conn = plugin.create_connector(
        f"{plugin_module}:tiny", "t2", {})
    assert conn.read_split(None, ["n"]).num_rows == 4


def test_unknown_connector_errors():
    with pytest.raises(KeyError, match="unknown connector.name"):
        plugin.create_connector("no-such-thing", "x", {})


def test_builtin_factories_present():
    names = plugin.connector_factories()
    for k in ("tpch", "tpcds", "memory", "blackhole", "system",
              "localfile", "jdbc"):
        assert k in names


def test_builtin_factories_build_on_the_named_device(tmp_path):
    for kind, props in (("tpch", {"tpch.rows-per-split": "4096"}),
                        ("tpcds", {}), ("memory", {}), ("blackhole", {}),
                        ("system", {}),
                        ("localfile", {"localfile.root": str(tmp_path)}),
                        ("jdbc", {})):
        conn = plugin.create_connector(kind, kind, props, device=CPU)
        assert conn.device.type == "cpu", kind
    assert plugin.create_connector(
        "tpch", "x", {"tpch.rows-per-split": "4096"},
        device=CPU).rows_per_split == 4096
    with pytest.raises(NotImplementedError, match="not yet ported"):
        plugin.create_connector("stream", "s", {}, device=CPU)
