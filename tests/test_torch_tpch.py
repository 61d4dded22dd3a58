"""The TPC-H corpus and small join SQL through the PyTorch engine
(device="cpu") against the JAX engine (Pallas in interpret mode) at
tpch.tiny.

Each of the 22 queries must equal the JAX engine's rows, in order. The
port runs first, and the JAX engine only where the port answers. Keys,
integers, strings and dates must match exactly, doubles within rel 1e-9.
"""

import math

import pytest

from trino_tpu.benchmarks.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.runner import LocalQueryRunner

REL = 1e-9
MUST_ANSWER = set(range(1, 23))


def _same(got, want):
    assert got.columns == want.columns
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        for a, b in zip(g, w):
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a)
            elif isinstance(b, float):
                assert a == pytest.approx(b, rel=REL)
            else:
                assert a == b


def _port_then_jax(sql, monkeypatch, must_answer=True):
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    try:
        got = LocalQueryRunner(device="cpu").execute(sql)
    except QueryError as e:
        assert not must_answer, f"the port raised: {e}"
        assert str(e).startswith("not yet ported"), str(e)
        return None
    want = TpuRunner().execute(sql)
    _same(got, want)
    return got


@pytest.mark.parametrize("q", [
    pytest.param(q, marks=pytest.mark.slow) if q == 21 else q
    for q in sorted(TPCH_QUERIES)])
def test_tpch_query(q, monkeypatch):
    _port_then_jax(TPCH_QUERIES[q], monkeypatch, q in MUST_ANSWER)


SQL = {
    "left_residual":
        "SELECT n_name, r_name FROM nation LEFT JOIN region "
        "ON n_regionkey = r_regionkey AND n_nationkey > r_regionkey * 5",
    "right_residual":
        "SELECT r_name, n_name FROM nation RIGHT JOIN region "
        "ON n_regionkey = r_regionkey AND n_nationkey < 3",
    "full_residual":
        "SELECT n_name, r_name FROM nation FULL JOIN region "
        "ON n_regionkey = r_regionkey AND n_nationkey < r_regionkey * 6",
    "full_keys_only":
        "SELECT n_name, r_name FROM "
        "(SELECT n_name, n_regionkey FROM nation WHERE n_nationkey < 8) n "
        "FULL JOIN (SELECT r_name, r_regionkey FROM region "
        "WHERE r_regionkey > 1) r ON n_regionkey = r_regionkey",
    "cross":
        "SELECT n_name, r_name FROM nation CROSS JOIN region "
        "WHERE n_nationkey < 3",
    "in_with_null_on_build_side":
        "SELECT n_name, n_regionkey IN (SELECT x FROM "
        "(VALUES 1, NULL, 3) t(x)) FROM nation",
    "not_in_with_null_on_build_side":
        "SELECT count(*) FROM nation WHERE n_regionkey NOT IN "
        "(SELECT x FROM (VALUES 1, NULL) t(x))",
    "exists_with_residual":
        "SELECT n_name FROM nation WHERE EXISTS (SELECT * FROM supplier "
        "WHERE s_nationkey = n_nationkey AND s_suppkey > n_nationkey * 4)",
    "scalar_subquery_no_rows":
        "SELECT n_name, (SELECT r_name FROM region WHERE r_regionkey = 99) "
        "FROM nation WHERE n_nationkey < 3",
    "q18_lower_threshold":
        TPCH_QUERIES[18].replace("> 300", "> 250"),
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_join_sql(name, monkeypatch):
    got = _port_then_jax(SQL[name], monkeypatch)
    assert got.rows


def test_scalar_subquery_two_rows_raises():
    sql = ("SELECT n_name, (SELECT r_name FROM region "
           "WHERE r_regionkey < 2) FROM nation")
    with pytest.raises(QueryError, match="multiple rows"):
        LocalQueryRunner(device="cpu").execute(sql)
    with pytest.raises(Exception, match="multiple rows"):
        TpuRunner().execute(sql)


def _small_memory_runner():
    from trino_tpu_torch.session import Session
    session = Session(catalog="tpch", schema="tiny")
    # lineitem's scan (60K rows x 1 lane, 480 KB) fits; it does not fit
    # beside the orders build side, and the join output (2 lanes, 960 KB)
    # does not fit at all
    session.set("query_max_memory_per_node", 1 << 19)
    return LocalQueryRunner(session, device="cpu")


def test_join_output_over_the_memory_limit_raises():
    # materialised, the join's output breaches the limit and raises; a
    # pushed-down constraint leaves the table's size as an upper bound
    # of the probe scan, which is over the budget, so by default the
    # probe streams instead and the query completes
    sql = ("SELECT count(*) FROM lineitem JOIN orders "
           "ON l_orderkey = o_orderkey WHERE l_quantity > 0")
    runner = _small_memory_runner()
    runner.session.set("stream_chunk_rows", -1)
    with pytest.raises(QueryError, match="memory limit") as e:
        runner.execute(sql)
    assert e.value.error_name == "EXCEEDED_LOCAL_MEMORY_LIMIT"
    got = _small_memory_runner().execute(sql)
    assert got.stream_ops.get("join", 0) > 0
    assert got.rows == LocalQueryRunner(device="cpu").execute(sql).rows


def test_join_the_jax_engine_would_stream_raises():
    # the name predates the streamed join: where the JAX engine streams
    # the probe, the port now streams it too, and the rows agree
    sql = ("SELECT count(*) FROM lineitem JOIN orders "
           "ON l_orderkey = o_orderkey")
    got = _small_memory_runner().execute(sql)
    assert got.stream_ops.get("join", 0) > 0
    from trino_tpu.session import Session as TpuSession
    session = TpuSession(catalog="tpch", schema="tiny")
    session.set("query_max_memory_per_node", 1 << 19)
    assert got.rows == TpuRunner(session=session).execute(sql).rows
