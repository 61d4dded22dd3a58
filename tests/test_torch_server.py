"""The port's coordinator against the JAX coordinator over HTTP.

Both coordinators start on ephemeral ports (the port's with
``device="cpu"``) and take the same statements through each package's
own ``StatementClient`` or the raw statement protocol: payloads (column
names and types, cells as JSON), paging past ``PAGE_ROWS``, error
payloads with their HTTP status, session properties, query states and
lists, DML counts and EXPLAIN ANALYZE. Then the counterparts of
tests/test_server.py, each holding the port's answer against the JAX
coordinator's.
"""

import json
import threading
import urllib.request

import pytest

from _torch_server import (analyze_shape, assert_same_result, http, pair,
                           payload_shape, protocol_pages, same_rows)
from trino_tpu.client import StatementClient as TpuClient
from trino_tpu_torch.client import StatementClient
from trino_tpu_torch.server import Coordinator
from trino_tpu_torch.server.coordinator import PAGE_ROWS

__all__ = ["pair"]


def both(pair, sql, **kw):
    """(port result, JAX result) of one statement through each package's
    client."""
    jco, tco = pair
    return (StatementClient(tco.base_uri, **kw).execute(sql),
            TpuClient(jco.base_uri, **kw).execute(sql))


def get_json(uri):
    with urllib.request.urlopen(uri, timeout=60) as r:
        return json.loads(r.read())


# ---- payloads --------------------------------------------------------------

PAYLOAD_SQL = [
    "SELECT 1 + 2 AS x, 'hi' AS s, NULL AS n, true AS b",
    "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS q, "
    "avg(l_extendedprice) AS p, count(*) AS c FROM lineitem "
    "GROUP BY 1, 2 ORDER BY 1, 2",
    "SELECT o_orderdate, o_totalprice, o_orderpriority FROM orders "
    "ORDER BY o_orderkey LIMIT 7",
    "SELECT date '2001-08-22' AS d, timestamp '2001-08-22 03:04:05.678' "
    "AS ts, CAST('12.345' AS DECIMAL(10, 3)) AS dec, "
    "CAST(7 AS DECIMAL(30, 2)) AS big",
    "SELECT n_name, r_name FROM nation JOIN region "
    "ON n_regionkey = r_regionkey WHERE r_name = 'ASIA' ORDER BY 1",
    "SHOW SCHEMAS FROM tpch",
    "DESCRIBE tpch.tiny.region",
]


@pytest.mark.parametrize("sql", PAYLOAD_SQL)
def test_payloads_equal_the_jax_coordinators(pair, sql):
    jco, tco = pair
    got_status, got = protocol_pages(tco.base_uri, sql)
    want_status, want = protocol_pages(jco.base_uri, sql)
    assert got_status == want_status == 200
    g, w = payload_shape(got), payload_shape(want)
    assert g["state"] == w["state"] == "FINISHED"
    assert g["columns"] == w["columns"]
    assert same_rows(g["data"], w["data"]), (g["data"][:3], w["data"][:3])
    assert g["rows_per_page"] == w["rows_per_page"]


def test_paging_crosses_page_rows(pair):
    jco, tco = pair
    sql = "SELECT l_orderkey FROM lineitem LIMIT 6000"
    _, got = protocol_pages(tco.base_uri, sql)
    _, want = protocol_pages(jco.base_uri, sql)
    g, w = payload_shape(got), payload_shape(want)
    assert PAGE_ROWS == 4096
    assert g["rows_per_page"] == w["rows_per_page"] == [4096, 1904]
    assert g["data"] == w["data"]


ERROR_SQL = [
    "SELECT nosuch FROM lineitem",
    "SELECT * FROM tpch.tiny.not_a_table",
    "SELECT FROM WHERE",
    "SELECT CAST('x' AS integer)",
    "SET SESSION no_such_property = 1",
    "DROP TABLE memory.default.never_made",
]


@pytest.mark.parametrize("sql", ERROR_SQL)
def test_error_payloads_equal_the_jax_coordinators(pair, sql):
    jco, tco = pair
    got_status, got = protocol_pages(tco.base_uri, sql)
    want_status, want = protocol_pages(jco.base_uri, sql)
    assert got_status == want_status == 200
    g, w = payload_shape(got), payload_shape(want)
    assert g["state"] == w["state"] == "FAILED"
    assert g["error"] == w["error"]
    assert g["failureType"] == w["failureType"]


def test_time_cells_encode_where_the_jax_coordinator_drops_the_connection(
        pair):
    """ROADMAP C3: the JAX coordinator's cell encoder has no branch for
    TIME, so json.dumps raises in its handler and the client sees the
    connection close; the port sends the ISO string."""
    import http.client
    jco, tco = pair
    sql = "SELECT time '01:02:03' AS t, time '10:11:12.345' AS u"
    _, got = protocol_pages(tco.base_uri, sql)
    assert payload_shape(got)["data"] == [["01:02:03", "10:11:12.345000"]]
    with pytest.raises(http.client.RemoteDisconnected):
        protocol_pages(jco.base_uri, sql)


def test_submission_failure_status_equals_the_jax_coordinators(pair):
    """A failure outside the tracked query (here a resource-group queue
    that rejects at once) answers with its classified error and HTTP
    status, the same on both."""
    from trino_tpu.server.resourcegroups import (
        ResourceGroup as TpuGroup, ResourceGroupManager as TpuManager)
    from trino_tpu_torch.server.resourcegroups import (
        ResourceGroup, ResourceGroupManager)
    results = []
    for co in (Coordinator(device="cpu", resource_groups=ResourceGroupManager(
            ResourceGroup("global", hard_concurrency=0, max_queued=0))),
               __import__("trino_tpu.server.coordinator", fromlist=["x"])
               .Coordinator(resource_groups=TpuManager(
                   TpuGroup("global", hard_concurrency=0, max_queued=0)))):
        co.start()
        try:
            status, pages = protocol_pages(co.base_uri, "SELECT 1")
            results.append((status, payload_shape(pages)["error"]))
        finally:
            co.stop()
    assert results[0] == results[1]
    assert results[0][1]["errorName"] == "QUERY_QUEUE_FULL"


def test_http_status_of_unknown_routes_and_auth(pair):
    jco, tco = pair
    for path in ("/v1/nowhere", "/v1/query/no_such_query"):
        got = http("GET", tco.base_uri + path)
        want = http("GET", jco.base_uri + path)
        assert got == want and got[0] == 404


def test_not_yet_ported_routes_answer_501(pair):
    _, tco = pair
    for method, path in (("GET", "/v1/announcement"),
                         ("GET", "/v1/hotshapes"),
                         ("GET", "/v1/continuous"),
                         ("POST", "/v1/ingest/clicks"),
                         ("GET", "/v1/trace/q1")):
        status, body = http(method, tco.base_uri + path,
                            b"{}" if method == "POST" else None)
        assert status == 501 and "not yet ported" in body["error"]


# ---- session properties ------------------------------------------------------

def test_session_properties_through_the_header(pair):
    kw = {"session_properties": {"task_concurrency": "4",
                                 "query_max_run_time": "120"}}
    got, want = both(pair, "SHOW SESSION", **kw)
    assert_same_result(got, want)
    row = [r for r in got.rows if r[0] == "task_concurrency"][0]
    assert row[1] == "4"


def test_unknown_header_property_is_dropped_and_set_session_rejects(pair):
    """An unknown property in X-Trino-Session is dropped by both
    coordinators (the query runs); SET SESSION of one fails with the
    same error."""
    got, want = both(pair, "SELECT 1",
                     session_properties={"no_such_property": "1"})
    assert_same_result(got, want)
    errors = []
    for client in (StatementClient(pair[1].base_uri),
                   TpuClient(pair[0].base_uri)):
        with pytest.raises(Exception) as e:
            client.execute("SET SESSION no_such_property = 1")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "does not exist" in errors[0]


# ---- states, lists, system.runtime ------------------------------------------

def test_query_states_and_lists(pair):
    jco, tco = pair
    tag = "/* states */ SELECT 41 + 1"
    for co, cls in ((tco, StatementClient), (jco, TpuClient)):
        cls(co.base_uri).execute(tag)
        with pytest.raises(Exception):
            cls(co.base_uri).execute("/* states */ SELECT nosuch")
    seen = []
    for co in (tco, jco):
        infos = [i for i in get_json(co.base_uri + "/v1/query")
                 if i["query"].startswith("/* states */")]
        seen.append(sorted((i["query"], i["state"], i["user"])
                           for i in infos))
        assert set(infos[0]) == {"queryId", "state", "query", "user",
                                 "source", "created",
                                 "elapsedTimeMillis"}
    assert seen[0] == seen[1]
    assert [s for _, s, _ in seen[0]] == ["FINISHED", "FAILED"]


def test_system_runtime_queries_lists_the_same_states(pair):
    sql = ("SELECT state, error_code, query FROM system.runtime.queries "
           "WHERE query LIKE '/* rt */%' ORDER BY query")
    for co, cls in ((pair[1], StatementClient), (pair[0], TpuClient)):
        cls(co.base_uri).execute("/* rt */ SELECT 1")
        with pytest.raises(Exception):
            cls(co.base_uri).execute("/* rt */ SELECT * FROM nowhere")
    got, want = both(pair, sql)
    assert_same_result(got, want)
    assert sorted(r[0] for r in got.rows) == ["FAILED", "FINISHED"]


# ---- statements --------------------------------------------------------------

DML = [
    "CREATE TABLE memory.default.par_t (k bigint, v double, s varchar)",
    "INSERT INTO memory.default.par_t VALUES (1, 1.5, 'a'), (2, 2.5, 'b'), "
    "(3, 3.5, 'c')",
    "INSERT INTO memory.default.par_t SELECT n_nationkey + 10, "
    "CAST(n_regionkey AS double), n_name FROM nation",
    "UPDATE memory.default.par_t SET v = v * 2 WHERE k < 3",
    "DELETE FROM memory.default.par_t WHERE k > 30",
    "SELECT k, v, s FROM memory.default.par_t ORDER BY k",
    "CREATE TABLE memory.default.par_u AS SELECT * FROM "
    "memory.default.par_t WHERE k >= 10",
    "SELECT count(*), sum(v) FROM memory.default.par_u",
    "DROP TABLE memory.default.par_u",
    "DROP TABLE memory.default.par_t",
]


def test_dml_counts_and_rows_equal_the_jax_coordinators(pair):
    for sql in DML:
        got, want = both(pair, sql)
        assert_same_result(got, want)


EXPLAIN_SQL = [
    "SELECT l_returnflag, l_linestatus, sum(l_quantity), count(*) "
    "FROM lineitem WHERE l_shipdate <= DATE '1998-09-02' GROUP BY 1, 2 "
    "ORDER BY 1, 2",
    "SELECT n_name, count(*) FROM nation JOIN region "
    "ON n_regionkey = r_regionkey GROUP BY n_name ORDER BY 2 DESC, 1 "
    "LIMIT 3",
]


@pytest.mark.parametrize("sql", EXPLAIN_SQL)
def test_explain_analyze_plan_and_rows_equal_the_jax_coordinators(
        pair, sql):
    got, want = both(pair, "EXPLAIN ANALYZE " + sql)
    g = analyze_shape([r[0] for r in got.rows])
    w = analyze_shape([r[0] for r in want.rows])
    assert g[0] == w[0]                 # the plan that ran
    assert g[1] == w[1]                 # each node's rows in and out
    assert g[2] == ["parse", "plan", "optimize", "execute"]


# ---- counterparts of tests/test_server.py -------------------------------------

def test_info(pair):
    jco, tco = pair
    got = get_json(f"{tco.base_uri}/v1/info")
    want = get_json(f"{jco.base_uri}/v1/info")
    assert got["coordinator"] is True
    assert set(got) == set(want)
    assert got["environment"] == "cpu"


def test_simple_query(pair):
    got, want = both(pair, "SELECT 1 + 2 AS x, 'hi' AS s")
    assert got.column_names == ["x", "s"]
    assert got.rows == [[3, "hi"]]
    assert got.state == "FINISHED"
    assert_same_result(got, want)


def test_query_over_tpch(pair):
    got, want = both(pair, "SELECT l_returnflag, count(*) FROM lineitem "
                           "GROUP BY l_returnflag ORDER BY 1")
    assert [r[0] for r in got.rows] == ["A", "N", "R"]
    assert_same_result(got, want)


def test_paging(pair):
    got, want = both(pair, "SELECT l_orderkey FROM lineitem LIMIT 6000")
    assert len(got.rows) == 6000
    assert got.rows == want.rows


def test_error_payload(pair):
    messages = []
    for client in (StatementClient(pair[1].base_uri),
                   TpuClient(pair[0].base_uri)):
        with pytest.raises(Exception, match="cannot be resolved") as e:
            client.execute("SELECT nosuch FROM lineitem")
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_session_properties(pair):
    got, want = both(pair, "SHOW SESSION",
                     session_properties={"task_concurrency": "4"})
    row = [r for r in got.rows if r[0] == "task_concurrency"][0]
    assert row[1] == "4"
    assert_same_result(got, want)


def test_date_json_encoding(pair):
    got, want = both(pair, "SELECT date '2001-08-22' AS d")
    assert got.rows == [["2001-08-22"]] == want.rows


def test_query_list(pair):
    jco, tco = pair
    StatementClient(tco.base_uri).execute("SELECT 42")
    infos = get_json(f"{tco.base_uri}/v1/query")
    assert any(i["state"] == "FINISHED" for i in infos)
    assert set(infos[0]) == set(get_json(f"{jco.base_uri}/v1/query")[0])


def test_update_statement(pair):
    got, want = both(pair,
                     "CREATE TABLE memory.default.srv_t AS SELECT 1 AS a")
    assert got.update_type
    assert (got.update_type, got.update_count) == \
        (want.update_type, want.update_count)
    got, want = both(pair, "SELECT a FROM memory.default.srv_t")
    assert got.rows == [[1]] == want.rows


def test_cli_execute(capsys):
    from trino_tpu.cli import main as tpu_main
    from trino_tpu_torch.cli import main
    rc = main(["--local", "--device", "cpu", "-e",
               "SELECT 1 AS one, 'x' AS s"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "one" in out and "1" in out and "(1 row" in out
    assert tpu_main(["--local", "-e", "SELECT 1 AS one, 'x' AS s"]) == 0
    want = capsys.readouterr().out
    # the table is the same; only the elapsed time differs
    assert out.splitlines()[:3] == want.splitlines()[:3]


def test_cli_execute_against_the_server(pair, capsys):
    from trino_tpu_torch.cli import main
    rc = main(["--server", pair[1].base_uri, "--execute",
               "SELECT r_name FROM region ORDER BY 1 LIMIT 2"])
    out = capsys.readouterr().out
    assert rc == 0 and "AFRICA" in out and "(2 rows" in out
    rc = main(["--server", pair[1].base_uri, "--execute",
               "SELECT * FROM nowhere"])
    assert rc == 1 and "TABLE_NOT_FOUND" in capsys.readouterr().err


def test_cancel_interrupts_execution():
    """Cancellation stops the executor between plan nodes, in both
    engines."""
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu.session import Session as TpuSession
    from trino_tpu_torch.exec.executor import QueryError
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.session import Session

    ev = threading.Event()
    ev.set()
    r = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny",
                                         cancel=ev), device="cpu")
    with pytest.raises(QueryError, match="canceled") as got:
        r.execute("SELECT count(*) FROM lineitem")
    j = TpuRunner(session=TpuSession(catalog="tpch", schema="tiny",
                                     cancel=ev))
    with pytest.raises(Exception, match="canceled") as want:
        j.execute("SELECT count(*) FROM lineitem")
    assert str(got.value) == str(want.value)


def test_unknown_session_property_rejected():
    from trino_tpu_torch.session import Session

    s = Session()
    with pytest.raises(KeyError, match="does not exist"):
        s.set("no_such_property", "1")
    with pytest.raises(KeyError, match="does not exist"):
        s.get("tpu_enabled")   # deleted inert flag stays deleted


def test_query_detail_endpoint_and_ui_pages(pair):
    """/v1/query/{id} carries the state, per-node stats and the plan
    that ran; both UI pages serve."""
    jco, tco = pair
    sql = ("SELECT o_orderpriority, count(*) FROM orders "
           "GROUP BY o_orderpriority")
    details = []
    for co, cls in ((tco, StatementClient), (jco, TpuClient)):
        qid = cls(co.base_uri, catalog="tpch", schema="tiny") \
            .execute(sql).query_id
        details.append(get_json(f"{co.base_uri}/v1/query/{qid}"))
    d, want = details
    assert d["state"] == "FINISHED"
    assert d["rows"] == 5
    assert any("Aggregation" in line for line in d["plan"])
    assert any("TableScan" in line for line in d["plan"])
    stats = d.get("nodeStats") or []
    assert stats and any(s["outputRows"] >= 5 for s in stats)
    assert d["plan"] == want["plan"]
    assert [(s["node"], s["inputRows"], s["outputRows"])
            for s in stats] == \
        [(s["node"], s["inputRows"], s["outputRows"])
         for s in want["nodeStats"]]
    assert set(d) == set(want)
    for page in ("/ui", f"/ui/query.html?{d['queryId']}"):
        with urllib.request.urlopen(tco.base_uri + page) as r:
            body = r.read().decode()
        assert "<html" in body


def test_coordinator_needs_a_card_unless_cpu_is_asked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Coordinator()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Coordinator(device="cpu", distributed=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Coordinator(device="cpu", worker_uris=["http://127.0.0.1:1"])


def test_merge_node_stats_equals_the_jax_engines():
    """The roll-up of several executions' node stats (the worker slice's
    per-stage merge): keyed by (name, occurrence), rows summed, walls
    maxed, in the longest list's order, as in the JAX engine."""
    from trino_tpu.exec.executor import NodeStats as TpuStats
    from trino_tpu.exec.executor import merge_node_stats as tpu_merge
    from trino_tpu.exec.executor import stats_lines as tpu_lines
    from trino_tpu_torch.exec.executor import (NodeStats, merge_node_stats,
                                               stats_lines)
    lists = [[("TableScan", 0.5, 100, -1), ("Filter", 0.7, 40, 100),
              ("Filter", 0.8, 20, 40)],
             [("TableScan", 0.4, 90, -1), ("Aggregation", 0.9, 3, 90)],
             []]

    def build(cls):
        return [[cls(n, "", wall_s=w, output_rows=o, input_rows=i,
                     cpu_s=w / 2) for n, w, o, i in lst] for lst in lists]
    got = merge_node_stats(build(NodeStats))
    want = tpu_merge(build(TpuStats))
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert [s.name for s in got] == ["TableScan", "Filter", "Filter",
                                     "Aggregation"]
    assert got[0].output_rows == 190 and got[0].wall_s == 0.5
    assert stats_lines(got) == tpu_lines(want)
    assert NodeStats.from_dict(got[1].to_dict()) == got[1]


def test_explain_analyze_reports_the_streamed_chunks_as_the_jax_engine():
    """A streamed aggregation's stats line names its chunks, counted on
    the node that streamed them, as in the JAX engine."""
    import re
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu_torch.runner import LocalQueryRunner
    sql = ("EXPLAIN ANALYZE SELECT l_returnflag, sum(l_quantity) "
           "FROM lineitem WHERE l_quantity < 5 GROUP BY 1")
    seen = []
    for r in (LocalQueryRunner(device="cpu"), TpuRunner()):
        r.session.set("stream_chunk_rows", 4096)
        lines = [x[0] for x in r.execute(sql).rows if ", out " in x[0]]
        seen.append([(ln.split(":")[0],
                      re.search(r"streamed (\d+) chunks", ln)
                      and re.search(r"streamed (\d+) chunks", ln)[1])
                     for ln in lines])
    assert seen[0] == seen[1]
    assert seen[0][0] == ("Aggregation", "2")
    assert all(c is None for _, c in seen[0][1:])
