"""The statement layer of the PyTorch engine (trino_tpu_torch) against the
JAX engine (trino_tpu) on the CPU, at tpch.tiny.

Each script runs statement by statement through a fresh
``trino_tpu.runner.LocalQueryRunner()`` and a fresh
``trino_tpu_torch.runner.LocalQueryRunner(device="cpu")``. For every
statement both give the same columns, type names, rows (doubles within
rel 1e-9, everything else exactly), ``update_type`` and ``update_count``,
or an error of the same class whose message starts alike. The scripts
hold the SQL of tests/test_dml.py, tests/test_views_prepare_txn.py,
test_queries.py's SHOW, memory-connector and OFFSET cases and
test_sql_features.py's DELETE and information_schema cases, and more of
each statement kind.

Also here: TABLESAMPLE (the same rows as a multiset, the same count), a
hand-built AssignUniqueId plan, a guard that no write decodes rows on
the host (``Batch.to_pylist`` raises during CREATE TABLE AS, INSERT,
DELETE, UPDATE and MERGE), the memory connector's chunks, and the INSERT
coercions: the implicit ones equal the JAX engine; the others raise
Trino's "Insert query has mismatched column types" in the port, where
the JAX engine truncates (a fault of the reference, ROADMAP C).
"""

import math

import numpy as np
import pytest

from trino_tpu.exec.executor import Executor as TpuExecutor
from trino_tpu.plan import nodes as tpu_nodes
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch import columnar as port_columnar
from trino_tpu_torch.config import CONFIG, capacity_for
from trino_tpu_torch.exec.executor import Executor, QueryError
from trino_tpu_torch.plan import nodes as port_nodes
from trino_tpu_torch.runner import LocalQueryRunner

REL = 1e-9

ACCT = ("CREATE TABLE memory.default.acct AS "
        "SELECT * FROM (VALUES (1, 'alice', 100.0), "
        "(2, 'bob', 250.0), (3, 'carol', 0.0), "
        "(4, 'dan', 75.0)) t(id, name, balance)")

SCRIPTS = {
    # tests/test_dml.py
    "update_where": [
        ACCT,
        "UPDATE memory.default.acct SET balance = balance + 10 "
        "WHERE balance < 100",
        "SELECT id, balance FROM memory.default.acct ORDER BY id",
    ],
    "update_all_and_multiple_columns": [
        ACCT,
        "UPDATE memory.default.acct SET balance = 0, name = 'x'",
        "SELECT DISTINCT name, balance FROM memory.default.acct",
        "SELECT * FROM memory.default.acct",
    ],
    "update_unknown_column": [
        ACCT, "UPDATE memory.default.acct SET nope = 1",
    ],
    "merge_update_insert_delete": [
        ACCT,
        "CREATE TABLE memory.default.delta AS "
        "SELECT * FROM (VALUES (2, 40.0), (3, -1.0), (9, 500.0)) "
        "t(id, amount)",
        "MERGE INTO memory.default.acct a "
        "USING memory.default.delta d ON a.id = d.id "
        "WHEN MATCHED AND d.amount < 0 THEN DELETE "
        "WHEN MATCHED THEN UPDATE SET balance = balance + d.amount "
        "WHEN NOT MATCHED THEN INSERT (id, name, balance) "
        "VALUES (d.id, 'new', d.amount)",
        "SELECT id, name, balance FROM memory.default.acct ORDER BY id",
        "SELECT * FROM memory.default.acct",
    ],
    "merge_not_matched_condition": [
        ACCT,
        "CREATE TABLE memory.default.adds AS "
        "SELECT * FROM (VALUES (7, 5.0), (8, -3.0)) t(id, amount)",
        "MERGE INTO memory.default.acct a "
        "USING memory.default.adds d ON a.id = d.id "
        "WHEN NOT MATCHED AND d.amount > 0 THEN "
        "INSERT (id, name, balance) VALUES (d.id, 'pos', d.amount)",
        "SELECT id FROM memory.default.acct WHERE id >= 7 ORDER BY id",
    ],
    "merge_insert_leaves_a_column_out": [
        ACCT,
        "CREATE TABLE memory.default.adds AS "
        "SELECT * FROM (VALUES (7, 5.0), (2, 1.5)) t(id, amount)",
        "MERGE INTO memory.default.acct a "
        "USING memory.default.adds d ON a.id = d.id "
        "WHEN MATCHED THEN UPDATE SET name = 'seen' "
        "WHEN NOT MATCHED THEN INSERT (id, balance) "
        "VALUES (d.id, d.amount)",
        "SELECT * FROM memory.default.acct ORDER BY id",
    ],
    "merge_errors": [
        ACCT,
        "MERGE INTO memory.default.acct a USING (SELECT 1 AS id) "
        "ON a.id = id WHEN MATCHED THEN DELETE",
        "MERGE INTO memory.default.acct a USING tpch.tiny.nation n "
        "ON a.id = n.n_nationkey WHEN NOT MATCHED THEN DELETE",
        "MERGE INTO tpch.tiny.nation a USING memory.default.acct n "
        "ON a.n_nationkey = n.id WHEN MATCHED THEN DELETE",
    ],
    "show_stats": [
        ACCT,
        "SHOW STATS FOR tpch.tiny.lineitem",
        "SHOW STATS FOR memory.default.acct",
        "SHOW STATS FOR memory.default.nope",
    ],
    # tests/test_views_prepare_txn.py
    "create_select_drop_view": [
        "CREATE VIEW memory.default.v AS "
        "SELECT n_name, n_regionkey FROM tpch.tiny.nation "
        "WHERE n_nationkey < 5",
        "SELECT n_name FROM memory.default.v ORDER BY n_name",
        "SELECT count(*) FROM memory.default.v v "
        "JOIN tpch.tiny.region r ON v.n_regionkey = r.r_regionkey",
        "SHOW CREATE VIEW memory.default.v",
        "SHOW TABLES FROM memory.default",
        "SELECT table_name, view_definition "
        "FROM memory.information_schema.views",
        "DROP VIEW memory.default.v",
        "SELECT * FROM memory.default.v",
        "SHOW CREATE VIEW memory.default.v",
    ],
    "create_or_replace_view": [
        "CREATE VIEW memory.default.v2 AS SELECT 1 AS x",
        "CREATE VIEW memory.default.v2 AS SELECT 2 AS x",
        "CREATE OR REPLACE VIEW memory.default.v2 AS SELECT 2 AS x",
        "SELECT x FROM memory.default.v2",
        "CREATE VIEW memory.default.bad AS SELECT nope FROM tpch.tiny.nation",
    ],
    "drop_view_if_exists": [
        "DROP VIEW IF EXISTS memory.default.nope",
        "DROP VIEW memory.default.nope",
    ],
    "prepare_execute_deallocate": [
        "PREPARE q FROM SELECT n_name FROM "
        "tpch.tiny.nation WHERE n_nationkey = ?",
        "EXECUTE q USING 3",
        "EXECUTE q USING 0",
        "DESCRIBE OUTPUT q",
        "DESCRIBE INPUT q",
        "DEALLOCATE PREPARE q",
        "EXECUTE q USING 1",
        "DEALLOCATE PREPARE q",
        "DESCRIBE INPUT q",
    ],
    "execute_param_arity": [
        "PREPARE p2 FROM SELECT ? + ?",
        "EXECUTE p2 USING 1, 2",
        "EXECUTE p2 USING 1",
        "EXECUTE p2 USING 1, 2, 3",
    ],
    "prepared_write": [
        "CREATE TABLE memory.default.px (k bigint, v varchar)",
        "PREPARE ins FROM INSERT INTO memory.default.px VALUES (?, ?)",
        "EXECUTE ins USING 1, 'a'",
        "EXECUTE ins USING 2, 'b'",
        "DESCRIBE OUTPUT ins",
        "DESCRIBE INPUT ins",
        "PREPARE del FROM DELETE FROM memory.default.px WHERE k = ?",
        "EXECUTE del USING 1",
        "SELECT * FROM memory.default.px",
    ],
    "describe_table": [
        "DESCRIBE tpch.tiny.region",
        "DESCRIBE memory.default.nope",
        "SHOW COLUMNS FROM tpch.tiny.orders",
    ],
    "show_create_table": [
        "SHOW CREATE TABLE tpch.tiny.region",
        ACCT,
        "SHOW CREATE TABLE memory.default.acct",
        "SHOW CREATE TABLE memory.default.nope",
    ],
    "transaction_rollback_commit": [
        "CREATE TABLE memory.default.tx (x bigint)",
        "INSERT INTO memory.default.tx VALUES (1)",
        "START TRANSACTION",
        "INSERT INTO memory.default.tx VALUES (2)",
        "DELETE FROM memory.default.tx WHERE x = 1",
        "SELECT x FROM memory.default.tx",
        "ROLLBACK",
        "SELECT x FROM memory.default.tx",
        "START TRANSACTION",
        "INSERT INTO memory.default.tx VALUES (9)",
        "COMMIT",
        "SELECT x FROM memory.default.tx ORDER BY x",
    ],
    "transaction_ddl_rollback": [
        "START TRANSACTION",
        "CREATE TABLE memory.default.ephemeral (x bigint)",
        "SHOW TABLES FROM memory.default",
        "ROLLBACK",
        "SELECT * FROM memory.default.ephemeral",
        "SHOW TABLES FROM memory.default",
    ],
    "transaction_update_merge_rollback": [
        ACCT,
        "START TRANSACTION",
        "UPDATE memory.default.acct SET balance = 1 WHERE id > 2",
        "DROP TABLE memory.default.acct",
        "SHOW TABLES FROM memory.default",
        "ROLLBACK",
        "SELECT * FROM memory.default.acct",
    ],
    "transaction_errors": [
        "COMMIT",
        "ROLLBACK",
        "START TRANSACTION",
        "START TRANSACTION",
        "COMMIT",
    ],
    # tests/test_queries.py
    "show_statements": [
        "SHOW TABLES",
        "SHOW COLUMNS FROM lineitem",
        "SHOW SCHEMAS",
        "SHOW SCHEMAS FROM tpcds",
        "SHOW SCHEMAS FROM memory",
        "SHOW TABLES FROM tpch.sf1",
        "SHOW TABLES FROM tpcds.tiny LIKE 'store%'",
        "SHOW TABLES LIKE '%item'",
        "SHOW FUNCTIONS",
        "SHOW SCHEMAS FROM nope",
    ],
    "memory_connector_dml": [
        "CREATE TABLE memory.default.t1 (a bigint, b varchar)",
        "INSERT INTO memory.default.t1 VALUES (1, 'x'), (2, 'y')",
        "SELECT a, b FROM memory.default.t1 ORDER BY a",
        "CREATE TABLE memory.default.t2 AS "
        "SELECT a * 10 AS a10 FROM memory.default.t1",
        "SELECT sum(a10) FROM memory.default.t2",
        "DROP TABLE memory.default.t1",
        "SELECT * FROM memory.default.t1",
        "DROP TABLE memory.default.t1",
        "DROP TABLE IF EXISTS memory.default.t1",
    ],
    "order_by_limit_offset": [
        "SELECT x FROM (VALUES (3), (1), (2), (5), (4)) AS t(x) "
        "ORDER BY x DESC LIMIT 2 OFFSET 1",
        "SELECT n_name FROM nation ORDER BY n_name DESC LIMIT 3 OFFSET 2",
        "SELECT x FROM (VALUES (3), (1), (2), (5), (4)) AS t(x) "
        "ORDER BY x OFFSET 2",
        "SELECT x FROM (VALUES (3), (1), (2), (5), (4)) AS t(x) "
        "ORDER BY x OFFSET 9",
        "SELECT o_orderkey, o_totalprice FROM orders "
        "ORDER BY o_totalprice DESC, o_orderkey OFFSET 14990",
        "SELECT DISTINCT l_orderkey FROM lineitem "
        "ORDER BY 1 DESC LIMIT 5 OFFSET 10",
        "SELECT n_name FROM nation WHERE n_regionkey = 1 "
        "ORDER BY n_name OFFSET 1 LIMIT 2",
    ],
    # tests/test_sql_features.py
    "delete": [
        "CREATE TABLE memory.default.del_t AS "
        "SELECT * FROM (VALUES (1),(2),(3),(NULL)) t(x)",
        "DELETE FROM memory.default.del_t WHERE x >= 2",
        "SELECT x FROM memory.default.del_t ORDER BY x",
        "DELETE FROM memory.default.del_t",
        "SELECT count(*) FROM memory.default.del_t",
        "SELECT * FROM memory.default.del_t",
        "INSERT INTO memory.default.del_t VALUES (5)",
        "SELECT * FROM memory.default.del_t",
        "DROP TABLE memory.default.del_t",
        "DELETE FROM tpch.tiny.nation WHERE n_nationkey = 1",
        "DELETE FROM memory.default.nope",
    ],
    "delete_with_date_column": [
        "CREATE TABLE memory.default.del_d AS "
        "SELECT o_orderkey, o_orderdate FROM orders LIMIT 10",
        "DELETE FROM memory.default.del_d WHERE o_orderkey > 0",
        "DROP TABLE memory.default.del_d",
    ],
    "information_schema": [
        "SELECT table_name FROM information_schema.tables "
        "WHERE table_schema = 'tiny' ORDER BY 1",
        "SELECT column_name, data_type FROM information_schema.columns "
        "WHERE table_schema = 'tiny' AND table_name = 'nation' "
        "ORDER BY ordinal_position",
        "SELECT schema_name FROM information_schema.schemata",
        ACCT,
        "SELECT table_name, column_name, data_type "
        "FROM memory.information_schema.columns ORDER BY 1, 2",
    ],
    # more of each kind
    "ctas_from_tpch": [
        "CREATE TABLE memory.default.li AS SELECT l_orderkey, l_returnflag, "
        "l_linestatus, l_quantity, l_extendedprice, l_discount, l_tax, "
        "l_shipdate FROM tpch.tiny.lineitem",
        "SELECT l_returnflag, l_linestatus, sum(l_quantity), "
        "sum(l_extendedprice * (1 - l_discount)), avg(l_discount), "
        "count(*) FROM memory.default.li "
        "WHERE l_shipdate <= DATE '1998-09-02' GROUP BY 1, 2 ORDER BY 1, 2",
        "DELETE FROM memory.default.li WHERE l_returnflag = 'R'",
        "UPDATE memory.default.li SET l_discount = 0 "
        "WHERE l_linestatus = 'O'",
        "SELECT l_returnflag, l_linestatus, sum(l_discount), count(*) "
        "FROM memory.default.li GROUP BY 1, 2 ORDER BY 1, 2",
        "INSERT INTO memory.default.li SELECT l_orderkey, l_returnflag, "
        "l_linestatus, l_quantity, l_extendedprice, l_discount, l_tax, "
        "l_shipdate FROM tpch.tiny.lineitem WHERE l_returnflag = 'R'",
        "SELECT count(*), sum(l_orderkey), min(l_shipdate), "
        "max(l_shipdate) FROM memory.default.li",
        "SELECT * FROM memory.default.li ORDER BY l_orderkey, l_quantity, "
        "l_extendedprice LIMIT 20 OFFSET 100",
        "START TRANSACTION",
        "DELETE FROM memory.default.li",
        "SELECT count(*) FROM memory.default.li",
        "ROLLBACK",
        "SELECT count(*) FROM memory.default.li",
        "SHOW STATS FOR memory.default.li",
        "DROP TABLE memory.default.li",
    ],
    "ctas_types_and_names": [
        "CREATE TABLE memory.default.ty AS SELECT o_orderkey AS k, "
        "o_orderdate AS d, o_orderpriority AS p, "
        "CAST(o_totalprice AS DECIMAL(12,2)) AS m, "
        "CAST(o_totalprice AS DECIMAL(30,2)) * 3 AS big, "
        "o_totalprice > 100000 AS b, CAST(o_custkey AS INTEGER) AS c "
        "FROM orders WHERE o_orderkey < 200",
        "DESCRIBE memory.default.ty",
        "SELECT * FROM memory.default.ty ORDER BY k",
        "SELECT p, count(*), sum(m), sum(big) FROM memory.default.ty "
        "GROUP BY p ORDER BY p",
        "CREATE TABLE memory.default.ty AS SELECT 1 AS x",
        "CREATE TABLE IF NOT EXISTS memory.default.ty AS SELECT 1 AS x",
        "CREATE TABLE IF NOT EXISTS memory.default.ty (x bigint)",
        "CREATE TABLE memory.default.empty AS "
        "SELECT * FROM nation WHERE n_nationkey < 0",
        "SELECT count(*) FROM memory.default.empty",
        "DESCRIBE memory.default.empty",
        "CREATE TABLE tpch.tiny.nope AS SELECT 1 AS x",
    ],
    "insert_implicit_coercions": [
        "CREATE TABLE memory.default.co (i bigint, d double, "
        "m decimal(14,3), r real, s varchar, n integer)",
        "INSERT INTO memory.default.co VALUES "
        "(1, 2, 3, 4, 'a', 5), (NULL, NULL, NULL, NULL, NULL, NULL)",
        "INSERT INTO memory.default.co SELECT CAST(7 AS INTEGER), 1.25, "
        "2.5, CAST(1.5 AS REAL), n_name, CAST(n_nationkey AS SMALLINT) "
        "FROM nation WHERE n_nationkey < 3",
        "INSERT INTO memory.default.co SELECT n_nationkey, "
        "CAST(n_nationkey AS REAL), 12.125, NULL, 'x', NULL "
        "FROM nation WHERE n_nationkey > 22",
        "SELECT * FROM memory.default.co",
        "INSERT INTO memory.default.co SELECT 1, 2, 3",
        "INSERT INTO memory.default.nope SELECT 1",
        "SELECT count(*) FROM memory.default.co",
    ],
    "blackhole_and_system": [
        "CREATE TABLE blackhole.default.sink (x bigint, y varchar)",
        "INSERT INTO blackhole.default.sink SELECT n_nationkey, n_name "
        "FROM nation",
        "SELECT count(*) FROM blackhole.default.sink",
        "SHOW TABLES FROM blackhole.default",
        "CREATE TABLE blackhole.default.s2 AS SELECT * FROM region",
        "SELECT * FROM blackhole.default.s2",
        "DROP TABLE blackhole.default.sink",
        "SHOW SCHEMAS FROM system",
        "SHOW TABLES FROM system.runtime",
        "SELECT * FROM system.runtime.queries",
        "SELECT count(*) FROM system.runtime.nodes",
        "DESCRIBE system.runtime.resource_groups",
        "SELECT * FROM system.runtime.metrics",
        "CALL system.runtime.kill_query('20240101_000000_00000_aaaaa')",
        "CALL system.runtime.nope()",
        "CALL runtime.kill_query('x')",
    ],
    "session_and_use": [
        "SET SESSION task_concurrency = 4",
        "SHOW SESSION",
        "RESET SESSION task_concurrency",
        "USE memory.default",
        "CREATE TABLE u (x bigint)",
        "INSERT INTO u VALUES (3), (4)",
        "SELECT * FROM u",
        "SHOW TABLES",
        "USE tpch.sf1",
        "SHOW TABLES LIKE 'n%'",
        "USE nope.x",
    ],
    "grants": [
        ACCT,
        "GRANT SELECT ON memory.default.acct TO alice",
        "GRANT INSERT, DELETE ON memory.default.acct TO bob "
        "WITH GRANT OPTION",
        "GRANT SELECT ON tpch.tiny.nation TO alice",
        "SHOW GRANTS",
        "SHOW GRANTS ON memory.default.acct",
        "REVOKE GRANT OPTION FOR INSERT ON memory.default.acct FROM bob",
        "DENY UPDATE ON memory.default.acct TO carol",
        "REVOKE SELECT ON memory.default.acct FROM alice",
        "SHOW GRANTS",
        "GRANT SELECT ON memory.default.nope TO alice",
    ],
    "explain_and_errors": [
        "EXPLAIN SELECT count(*) FROM lineitem WHERE l_quantity > 10",
        "EXPLAIN CREATE TABLE memory.default.x AS SELECT 1 AS a",
        "UPDATE tpch.tiny.nation SET n_name = 'x'",
        "UPDATE memory.default.nope SET x = 1",
        "SELECT * FROM memory.default.nope",
    ],
}


def _outcome(runner, sql):
    try:
        r = runner.execute(sql)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return ("error", type(e).__name__, str(e))
    return ("ok", list(r.columns), [t.name for t in r.types], r.rows,
            r.update_type, r.update_count)


def same_value(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if isinstance(b, float):
        return isinstance(a, float) and a == pytest.approx(b, rel=REL)
    return a == b and type(a) is type(b)


def same_rows(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        assert all(same_value(a, b) for a, b in zip(g, w)), (g, w)


def same_outcome(got, want, sql):
    assert got[0] == want[0], (sql, got, want)
    if want[0] == "error":
        assert got[1] == want[1], (sql, got, want)
        n = min(len(want[2]), 40)
        assert got[2][:n] == want[2][:n], (sql, got, want)
        return
    assert got[1:3] == want[1:3], sql
    assert got[4:] == want[4:], (sql, got[4:], want[4:])
    same_rows(got[3], want[3])


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_the_jax_engine(name):
    jax_runner, port = TpuRunner(), LocalQueryRunner(device="cpu")
    for sql in SCRIPTS[name]:
        same_outcome(_outcome(port, sql), _outcome(jax_runner, sql), sql)


def test_show_catalogs_lacks_only_stream():
    """The port registers every catalog of the JAX runner but ``stream``,
    which waits for its connector (ROADMAP A8)."""
    want = TpuRunner().execute("SHOW CATALOGS").rows
    got = LocalQueryRunner(device="cpu").execute("SHOW CATALOGS").rows
    assert [c for c in want if c != ["stream"]] == got
    assert ["stream"] in want


def test_explain_analyze_is_not_yet_ported():
    """EXPLAIN ANALYZE was outside the statement slice; it came with the
    coordinator slice and now renders the plan that ran, a stats line
    per node and the trace, with the JAX engine's plan and rows."""
    from _torch_server import analyze_shape
    sql = "EXPLAIN ANALYZE SELECT count(*) FROM nation"
    got = LocalQueryRunner(device="cpu").execute(sql)
    want = TpuRunner().execute(sql)
    assert got.columns == want.columns == ["Query Plan"]
    g = analyze_shape([r[0] for r in got.rows])
    w = analyze_shape([r[0] for r in want.rows])
    assert g == w
    assert g[2] == ["plan", "optimize", "execute"]


def test_access_control_is_not_yet_ported():
    """Access control was outside the statement slice; the runner now
    consults it (security.py) before a write and the planner before a
    read, with the reference's message."""
    from trino_tpu_torch.security import AccessRule, RuleBasedAccessControl
    port = LocalQueryRunner(device="cpu")
    port.catalogs.access_control = RuleBasedAccessControl(
        [AccessRule(table=r"tpch\..*", privileges=("select",))])
    with pytest.raises(QueryError, match="Access Denied: Cannot create "
                       "table memory.default.t"):
        port.execute("CREATE TABLE memory.default.t (x bigint)")
    assert port.execute("SELECT count(*) FROM tpch.tiny.nation").rows \
        == [[25]]


# ---- TABLESAMPLE -----------------------------------------------------------

def _mix64(x):
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


@pytest.mark.parametrize("pct", [10, 50])
def test_tablesample_draws_the_jax_engine_rows(pct):
    jax_runner, port = TpuRunner(), LocalQueryRunner(device="cpu")
    sql = ("SELECT l_orderkey, l_linenumber, l_extendedprice "
           f"FROM lineitem TABLESAMPLE BERNOULLI ({pct})")
    want = jax_runner.execute(sql).rows
    got = port.execute(sql).rows
    assert sorted(got) == sorted(want)
    count = f"SELECT count(*) FROM lineitem TABLESAMPLE BERNOULLI ({pct})"
    n = port.execute("SELECT count(*) FROM lineitem").rows[0][0]
    u = (_mix64(np.arange(n)) >> np.uint64(11)).astype(np.float64) \
        / float(1 << 53)
    expect = int((u < pct / 100.0).sum())
    assert port.execute(count).rows == jax_runner.execute(count).rows \
        == [[expect]]
    assert len(got) == expect


@pytest.mark.parametrize("sql", [
    "SELECT l_returnflag, count(*), sum(l_quantity) FROM lineitem "
    "TABLESAMPLE SYSTEM (10) GROUP BY 1 ORDER BY 1",
    "SELECT count(*) FROM lineitem TABLESAMPLE BERNOULLI (10) "
    "WHERE l_quantity > 10",
    "SELECT count(*) FROM (SELECT * FROM orders TABLESAMPLE BERNOULLI (25)"
    ") o JOIN customer c ON o.o_custkey = c.c_custkey",
])
def test_tablesample_under_aggregation_and_join(sql):
    same_outcome(_outcome(LocalQueryRunner(device="cpu"), sql),
                 _outcome(TpuRunner(), sql), sql)


# ---- AssignUniqueId --------------------------------------------------------

def test_assign_unique_id_plan_matches_the_jax_engine():
    """No planner builds AssignUniqueIdNode; both engines run the same
    hand-built plan: an id lane over a filtered scan, then a sort."""
    jax_runner, port = TpuRunner(), LocalQueryRunner(device="cpu")
    sql = ("SELECT n_nationkey, n_name FROM nation WHERE n_regionkey = 2 "
           "ORDER BY n_name")

    def run(runner, nodes, executor, device):
        plan = runner.plan_sql(sql)
        wrapped = nodes.AssignUniqueIdNode(plan.source, "uid$")
        out = nodes.OutputNode(wrapped, plan.names + ("uid",),
                               plan.symbols + ("uid$",))
        ex = (executor(runner.catalogs, runner.session) if device is None
              else executor(runner.catalogs, runner.session, device))
        return ex.execute(out).to_pylist()

    want = run(jax_runner, tpu_nodes, TpuExecutor, None)
    got = run(port, port_nodes, Executor, port.device)
    assert got == want
    assert [r[2] for r in got] == list(range(len(got)))


# ---- writes keep the Batch on the device -----------------------------------

def test_no_write_decodes_rows_on_the_host(monkeypatch):
    """``Batch.to_pylist`` raises while the port writes; each write's
    count and the tables it leaves equal the JAX engine's."""
    jax_runner, port = TpuRunner(), LocalQueryRunner(device="cpu")
    setup = [ACCT, "CREATE TABLE memory.default.delta AS SELECT * FROM "
                   "(VALUES (2, 40.0), (9, 5.0)) t(id, amount)"]
    writes = [
        "CREATE TABLE memory.default.li AS SELECT l_orderkey, "
        "l_returnflag, l_quantity FROM lineitem",
        "INSERT INTO memory.default.li SELECT l_orderkey, l_returnflag, "
        "l_quantity FROM lineitem WHERE l_returnflag = 'R'",
        "DELETE FROM memory.default.li WHERE l_returnflag = 'A'",
        "UPDATE memory.default.li SET l_quantity = 0 "
        "WHERE l_returnflag = 'N'",
        "MERGE INTO memory.default.acct a USING memory.default.delta d "
        "ON a.id = d.id WHEN MATCHED THEN UPDATE SET balance = d.amount "
        "WHEN NOT MATCHED THEN INSERT (id, name, balance) "
        "VALUES (d.id, 'n', d.amount)",
        "INSERT INTO memory.default.acct VALUES (5, 'e', 1.5)",
        "DELETE FROM memory.default.acct",
    ]
    for sql in setup:
        jax_runner.execute(sql)
        port.execute(sql)
    want = [jax_runner.execute(sql).update_count for sql in writes]

    def refuse(self):
        raise AssertionError("a write decoded rows on the host")
    monkeypatch.setattr(port_columnar.Batch, "to_pylist", refuse)
    got = [port.execute(sql).update_count for sql in writes]
    monkeypatch.undo()
    assert got == want
    for sql in ["SELECT * FROM memory.default.li",
                "SELECT * FROM memory.default.acct"]:
        same_outcome(_outcome(port, sql), _outcome(jax_runner, sql), sql)


def test_memory_tables_are_chunks_with_no_padding(monkeypatch):
    """A stored table is slices of at most ``max_batch_rows`` rows, each in
    lanes of ``capacity_for(rows)``, one split each; reads, aggregation
    split by split, DELETE and INSERT across chunks equal the JAX engine,
    whose table is one batch."""
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    jax_runner, port = TpuRunner(), LocalQueryRunner(device="cpu")
    script = [
        "CREATE TABLE memory.default.li AS SELECT l_orderkey, "
        "l_returnflag, l_linestatus, l_quantity, l_extendedprice, "
        "l_discount, l_shipdate FROM lineitem",
        "SELECT l_returnflag, l_linestatus, sum(l_quantity), "
        "sum(l_extendedprice * (1 - l_discount)), count(*) "
        "FROM memory.default.li WHERE l_shipdate <= DATE '1998-09-02' "
        "GROUP BY 1, 2 ORDER BY 1, 2",
        "DELETE FROM memory.default.li WHERE l_linestatus = 'F'",
        "INSERT INTO memory.default.li SELECT l_orderkey, l_returnflag, "
        "l_linestatus, l_quantity, l_extendedprice, l_discount, l_shipdate "
        "FROM lineitem WHERE l_orderkey < 100",
        "SELECT * FROM memory.default.li",
        "SELECT count(*) FROM memory.default.li TABLESAMPLE BERNOULLI (10)",
        "SELECT DISTINCT l_orderkey FROM memory.default.li "
        "ORDER BY 1 DESC LIMIT 5 OFFSET 10",
    ]
    for sql in script:
        same_outcome(_outcome(port, sql), _outcome(jax_runner, sql), sql)
    conn = port.catalogs.connector("memory")
    chunks = conn.stored_chunks("default", "li")
    rows = [c.num_rows_host() for c in chunks]
    assert len(chunks) > 2 and max(rows) <= 4096
    assert all(c.capacity == capacity_for(n, minimum=8)
               for c, n in zip(chunks, rows))
    total = port.execute("SELECT count(*) FROM memory.default.li").rows
    assert total == [[sum(rows)]]


# ---- INSERT coercions ------------------------------------------------------

MISMATCHED = [
    "INSERT INTO memory.default.t SELECT 2.7, 1.25, 2.125, 'y'",
    "INSERT INTO memory.default.t SELECT -2.5e0, 1, 7, 'z'",
    "INSERT INTO memory.default.t SELECT 2, 1.25, 2.125, 'y'",
    "INSERT INTO memory.default.t SELECT 'a', 1.25, 2.5, 'y'",
]
TABLE_T = ("CREATE TABLE memory.default.t (a BIGINT, b DOUBLE, "
           "c DECIMAL(10,2), d VARCHAR)")


@pytest.mark.parametrize("sql", MISMATCHED)
def test_insert_of_a_type_trino_does_not_coerce_raises(sql):
    port = LocalQueryRunner(device="cpu")
    port.execute(TABLE_T)
    with pytest.raises(QueryError,
                       match="^Insert query has mismatched column types: "
                             r"Table: \[bigint, double, decimal\(10,2\), "
                             r"varchar\], Query: \["):
        port.execute(sql)
    assert port.execute("SELECT count(*) FROM memory.default.t").rows \
        == [[0]]


def test_insert_of_a_narrower_integer_type_raises():
    port = LocalQueryRunner(device="cpu")
    port.execute("CREATE TABLE memory.default.n (k integer)")
    with pytest.raises(QueryError, match=r"^Insert query has mismatched "
                       r"column types: Table: \[integer\], Query: "
                       r"\[bigint\]"):
        port.execute("INSERT INTO memory.default.n SELECT CAST(5 AS BIGINT)")
    port.execute("INSERT INTO memory.default.n SELECT CAST(5 AS SMALLINT)")
    assert port.execute("SELECT k FROM memory.default.n").rows == [[5]]


def test_the_jax_engine_truncates_what_trino_rejects():
    """The fault of the reference that the port does not copy: its INSERT
    coerces through python values, so 2.7 and -2.5 become 2 and -2 in a
    BIGINT column and 2.125 becomes 2.13 in DECIMAL(10,2)."""
    jax_runner = TpuRunner()
    jax_runner.execute(TABLE_T)
    jax_runner.execute(MISMATCHED[0])
    jax_runner.execute(MISMATCHED[1])
    rows = jax_runner.execute("SELECT a, c FROM memory.default.t").rows
    assert [r[0] for r in rows] == [2, -2]
    assert str(rows[0][1]) == "2.13"


def test_insert_reorders_named_columns():
    """INSERT with a column list stores each value under its column,
    whatever the list's order, and NULL in a column left out."""
    port = LocalQueryRunner(device="cpu")
    port.execute("CREATE TABLE memory.default.r (a bigint, b varchar, "
                 "c double)")
    port.execute("INSERT INTO memory.default.r (b, a) VALUES ('x', 1)")
    port.execute("INSERT INTO memory.default.r (c, b, a) "
                  "VALUES (2.5, 'y', 2)")
    assert port.execute("SELECT * FROM memory.default.r ORDER BY a").rows \
        == [[1, "x", None], [2, "y", 2.5]]


def test_the_jax_engine_stores_a_column_list_by_position():
    """A second fault of the reference that the port does not copy: its
    INSERT renames the listed columns to the table's first names by
    position, so a reordered list swaps the values' columns and a short
    list leaves the table's other columns out of the stored batch."""
    jax_runner = TpuRunner()
    jax_runner.execute("CREATE TABLE memory.default.r (a bigint, b varchar, "
                       "c double)")
    jax_runner.execute("INSERT INTO memory.default.r (b, a) "
                       "VALUES ('x', 1)")
    with pytest.raises(Exception):
        jax_runner.execute("SELECT a, b, c FROM memory.default.r")
