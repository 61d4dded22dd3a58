"""The port's remote dispatch against the JAX package's: plan fragments
through two spawned port worker processes (``--device cpu``), the
coordinator's combine on this process's CPU, each result held against
the JAX engine's rows. Counterparts of tests/test_remote_dispatch.py.
"""

import pytest

from trino_tpu.benchmarks.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu_torch.exec.remote import (DistributedHostQueryRunner,
                                         RemoteScheduler)
from trino_tpu_torch.plan.serde import from_jsonable, to_jsonable
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.server.task_worker import spawn_worker
from trino_tpu_torch.session import Session


@pytest.fixture(scope="module")
def workers():
    procs, uris = [], []
    try:
        for _ in range(2):
            p, uri = spawn_worker("cpu")
            procs.append(p)
            uris.append(uri)
        yield uris
    finally:
        for p in procs:
            p.terminate()
            p.join(10)


def _check(workers, sql, approx_cols=(), catalog="tpch"):
    dist = DistributedHostQueryRunner(
        workers, session=Session(catalog=catalog, schema="tiny"),
        device="cpu")
    got = dist.execute(sql)
    exp = TpuRunner(session=TpuSession(catalog=catalog,
                                       schema="tiny")).execute(sql)
    assert got.columns == exp.columns
    assert len(got.rows) == len(exp.rows)
    for g, e in zip(got.rows, exp.rows):
        for i, (gv, ev) in enumerate(zip(g, e)):
            if i in approx_cols:
                assert gv == pytest.approx(ev, rel=1e-9)
            else:
                assert gv == ev
    return got


def _optimized(r, qn):
    from trino_tpu_torch.planner.logical import LogicalPlanner
    from trino_tpu_torch.planner.optimizer import optimize
    from trino_tpu_torch.sql.parser import parse_statement
    return optimize(LogicalPlanner(r.catalogs, r.session).plan(
        parse_statement(TPCH_QUERIES[qn])), r.catalogs, r.session)


def test_plan_serde_roundtrips_tpch_plans():
    r = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"),
                         device="cpu")
    for qn in (1, 3, 6, 18):
        plan = _optimized(r, qn)
        assert from_jsonable(to_jsonable(plan)) == plan


def test_fragmenter_cuts_scan_chains():
    """q3 gives one fragment per base table; q1 pushes a partial
    aggregation into its fragment; the JAX package's flat fragmenter
    cuts the same fragments."""
    from trino_tpu.exec.remote import RemoteScheduler as TpuScheduler
    from trino_tpu.plan.serde import to_jsonable as tpu_jsonable
    from trino_tpu.planner.logical import LogicalPlanner as TpuPlanner
    from trino_tpu.planner.optimizer import optimize as tpu_optimize
    from trino_tpu.sql.parser import parse_statement as tpu_parse
    from trino_tpu_torch.plan.nodes import AggregationNode
    r = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"),
                         device="cpu")
    sched = RemoteScheduler.__new__(RemoteScheduler)  # no workers needed
    sched.catalogs, sched.session = r.catalogs, r.session
    tr = TpuRunner(session=TpuSession(catalog="tpch", schema="tiny"))
    tsched = TpuScheduler.__new__(TpuScheduler)
    tsched.catalogs, tsched.session = tr.catalogs, tr.session
    for qn, want in ((3, 3), (1, 1)):
        frags, tfrags = [], []
        sched._cut(_optimized(r, qn), frags)
        tsched._cut(tpu_optimize(TpuPlanner(tr.catalogs, tr.session).plan(
            tpu_parse(TPCH_QUERIES[qn])), tr.catalogs, tr.session), tfrags)
        assert len(frags) == len(tfrags) == want
        assert [to_jsonable(f.plan) for f in frags] == \
            [tpu_jsonable(f.plan) for f in tfrags]
        if qn == 1:
            assert isinstance(frags[0].plan, AggregationNode)


def test_remote_q6(workers):
    _check(workers, TPCH_QUERIES[6], approx_cols=(0,))


def test_remote_q1(workers):
    _check(workers, TPCH_QUERIES[1], approx_cols=(2, 3, 4, 5, 6, 7, 8))


@pytest.mark.slow
def test_remote_q3(workers):
    _check(workers, TPCH_QUERIES[3], approx_cols=(1,))


def test_remote_decimal_and_strings(workers):
    _check(workers,
           "SELECT n_name, count(*) FROM nation "
           "JOIN region ON n_regionkey = r_regionkey "
           "WHERE r_name = 'ASIA' GROUP BY n_name ORDER BY n_name")


def test_remote_topn_pushdown(workers):
    _check(workers,
           "SELECT o_orderkey, o_totalprice FROM orders "
           "ORDER BY o_totalprice DESC LIMIT 10", approx_cols=(1,))


def test_remote_cancel_aborts_task(workers):
    """A set cancel event makes the page pull abort the remote task and
    raise instead of blocking until completion."""
    import threading
    from trino_tpu_torch.server.task_worker import RemoteTaskClient
    c = RemoteTaskClient(workers[0])
    c.submit("cancel-me", "SELECT count(*) FROM lineitem l1, nation",
             catalog="tpch", schema="tiny")
    ev = threading.Event()
    ev.set()
    with pytest.raises(RuntimeError, match="canceled"):
        c.pages("cancel-me", cancel=ev, device="cpu")


def test_remote_decimal_aggregates_exact(workers):
    """Decimal sum/avg through remote partial/final are bit-exact
    against the JAX engine, NULL groups included."""
    got = _check(workers,
                 "SELECT ss_store_sk, sum(ss_ext_sales_price), "
                 "avg(ss_sales_price), min(ss_net_paid), "
                 "max(ss_net_paid) FROM store_sales GROUP BY ss_store_sk "
                 "ORDER BY ss_store_sk", catalog="tpcds")
    assert got.rows


def test_http_coordinator_dispatches_to_workers(workers, tmp_path):
    """client -> port coordinator HTTP -> port worker HTTP -> frames back
    -> client rows, equal to the JAX engine's."""
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.server.coordinator import Coordinator
    coord = Coordinator(worker_uris=list(workers), device="cpu",
                        history_dir=str(tmp_path)).start()
    try:
        c = StatementClient(coord.base_uri, catalog="tpch",
                            schema="tiny")
        got = c.execute(TPCH_QUERIES[3])
        exp = TpuRunner(session=TpuSession(
            catalog="tpch", schema="tiny")).execute(TPCH_QUERIES[3])
        assert [r[0] for r in got.rows] == [r[0] for r in exp.rows]
        nodes = c.execute("SELECT count(*) FROM system.runtime.nodes")
        assert nodes.rows[0][0] == 3      # coordinator + 2 workers
    finally:
        coord.stop()
