"""The port's overload governance against the JAX package's: admission
through resource groups, the cluster memory pool and its low-memory
killer, deadlines, the error identities and the governance metrics.

Counterparts of tests/test_governance.py, all but
``test_deadline_cancels_inflight_worker_attempts`` (it needs the task
worker, ROADMAP 11b). Tracker-level cases drive the port's QueryTracker
with a gated fake runner, as the reference does; the real-executor and
HTTP cases run the port on the CPU and compare the outcome with the JAX
engine's.
"""

import json
import threading
import time
import urllib.request

import pytest

from trino_tpu_torch.client import StatementClient
from trino_tpu_torch.errors import error_info, http_status_for
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.obs.metrics import METRICS, parse_exposition
from trino_tpu_torch.runner import LocalQueryRunner, QueryResult
from trino_tpu_torch.server.coordinator import Coordinator, QueryTracker
from trino_tpu_torch.server.memory import (ClusterMemoryManager,
                                           ClusterMemoryPool,
                                           MemoryGovernanceError)
from trino_tpu_torch.server.resourcegroups import (ResourceGroup,
                                                   ResourceGroupManager)
from trino_tpu_torch.session import Session


def _wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


class _GatedRunner:
    """Fake runner: execute() reserves pool memory (by SQL tag), then
    blocks until its gate opens or the query is canceled."""

    def __init__(self, session, gates, started, reservations):
        self.session = session
        self.gates = gates
        self.started = started
        self.reservations = reservations

    def execute(self, sql):
        self.started.append(sql)
        nbytes = self.reservations.get(sql, 0)
        if nbytes and self.session.memory is not None:
            self.session.memory.reserve(nbytes)
        gate = self.gates.get(sql)
        cancel = self.session.cancel
        while gate is not None and not gate.is_set():
            if cancel is not None and cancel.is_set():
                raise QueryError("Query was canceled")
            gate.wait(0.01)
        return QueryResult(["x"], [], [[1]])


# --- admission ------------------------------------------------------------

def test_admission_caps_concurrency_and_drains_fifo():
    """Six queries against hard_concurrency=2: two run, four queue, and
    completions drain the queue in arrival order."""
    mgr = ResourceGroupManager()
    g = mgr.root.add(ResourceGroup("small", hard_concurrency=2,
                                   max_queued=100))
    mgr.add_selector(g)
    gates = {f"q{i}": threading.Event() for i in range(6)}
    started = []
    tracker = QueryTracker(
        lambda s: _GatedRunner(s, gates, started, {}),
        resource_groups=mgr)
    queries = [tracker.submit(f"q{i}", Session(user="alice"))
               for i in range(6)]
    _wait_until(lambda: len(started) == 2, what="2 running")
    time.sleep(0.1)
    assert set(started) == {"q0", "q1"} and len(started) == 2
    assert g.running == 2 and g.queued() == 4
    assert sum(1 for q in queries if q.state == "QUEUED") == 4
    for i in range(6):
        gates[f"q{i}"].set()
        _wait_until(lambda i=i: queries[i].state == "FINISHED",
                    what=f"q{i} finished")
        # the completion admitted the next query in line; its thread
        # records its start before the next completion admits another,
        # so ``started`` is in admission order
        _wait_until(lambda i=i: len(started) == min(i + 3, 6),
                    what=f"the successor of q{i} started")
    assert started[2:] == ["q2", "q3", "q4", "q5"]
    assert all(q.state == "FINISHED" for q in queries)
    assert g.running == 0 and g.queued() == 0


def test_queue_full_rejected_with_trino_error_identity():
    from trino_tpu.errors import error_info as tpu_error_info
    mgr = ResourceGroupManager()
    g = mgr.root.add(ResourceGroup("tiny", hard_concurrency=1,
                                   max_queued=1))
    mgr.add_selector(g)
    gates = {"q0": threading.Event()}
    started = []
    tracker = QueryTracker(
        lambda s: _GatedRunner(s, gates, started, {}),
        resource_groups=mgr)
    rej0 = METRICS.counter("trino_tpu_queue_rejections_total").value()
    q0 = tracker.submit("q0", Session())           # running
    q1 = tracker.submit("q1", Session())           # queued
    q2 = tracker.submit("q2", Session())           # rejected
    _wait_until(lambda: q2.state == "FAILED", what="rejection")
    code, etype = error_info("QUERY_QUEUE_FULL")
    assert (code, etype) == tpu_error_info("QUERY_QUEUE_FULL")
    assert q2.error["errorName"] == "QUERY_QUEUE_FULL"
    assert q2.error["errorCode"] == code == 0x0002_0000 + 2
    assert q2.error["errorType"] == etype == "INSUFFICIENT_RESOURCES"
    assert METRICS.counter(
        "trino_tpu_queue_rejections_total").value() == rej0 + 1
    gates["q0"].set()
    _wait_until(lambda: q0.state == "FINISHED", what="q0 finished")
    _wait_until(lambda: q1.state == "FINISHED", what="q1 drained")


def test_http_burst_completes_via_queueing(tmp_path):
    """Five clients over hard_concurrency=1 all complete through nextUri
    polling while QUEUED; queuedTimeMillis rides the stats payload and
    the queued-time histogram moves."""
    mgr = ResourceGroupManager()
    g = mgr.root.add(ResourceGroup("capped", hard_concurrency=1,
                                   max_queued=50))
    mgr.add_selector(g)
    co = Coordinator(resource_groups=mgr, device="cpu",
                     history_dir=str(tmp_path)).start()
    h = METRICS.histogram("trino_tpu_query_queued_seconds")
    n0 = h.count()
    try:
        results = []
        errors = []

        def run():
            try:
                c = StatementClient(co.base_uri)
                results.append(c.execute(
                    "SELECT count(*) FROM tpch.tiny.region").rows)
            except Exception as e:      # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=run) for _ in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors
        assert results == [[[5]]] * 5
        assert h.count() >= n0 + 1
        assert g.running == 0 and g.queued() == 0
        c = StatementClient(co.base_uri)
        r = c._request("POST", f"{co.base_uri}/v1/statement",
                       b"SELECT 1")
        assert "queuedTimeMillis" in r["stats"]
    finally:
        co.stop()


# --- memory governance ----------------------------------------------------

def test_low_memory_killer_kills_largest_survivor_completes():
    memory = ClusterMemoryManager(ClusterMemoryPool(1000))
    gates = {"big": threading.Event(), "small": threading.Event()}
    started = []
    reservations = {"big": 700, "small": 400}
    tracker = QueryTracker(
        lambda s: _GatedRunner(s, gates, started, reservations),
        memory=memory)
    kills0 = METRICS.counter("trino_tpu_memory_kills_total").value()
    qbig = tracker.submit("big", Session())
    _wait_until(lambda: "big" in started, what="big running")
    qsmall = tracker.submit("small", Session())   # 700+400 > 1000
    _wait_until(lambda: qbig.state == "FAILED", what="big killed")
    err = qbig.error
    assert err["errorName"] == "CLUSTER_OUT_OF_MEMORY"
    assert err["errorType"] == "INSUFFICIENT_RESOURCES"
    assert qbig.query_id in err["message"]
    assert "700" in err["message"] and "low-memory killer" \
        in err["message"]
    assert "reserved" in err["message"]
    gates["small"].set()
    _wait_until(lambda: qsmall.state == "FINISHED", what="survivor")
    gates["big"].set()
    qbig.wait_done(5)
    assert METRICS.counter(
        "trino_tpu_memory_kills_total").value() == kills0 + 1
    assert memory.pool.reserved_bytes() == 0


def test_group_soft_memory_limit_kills_within_group():
    mgr = ResourceGroupManager()
    etl = mgr.root.add(ResourceGroup("etl", hard_concurrency=10,
                                     soft_memory_limit_bytes=500))
    adhoc = mgr.root.add(ResourceGroup("adhoc", hard_concurrency=10))
    mgr.add_selector(etl, user_regex="etl")
    mgr.add_selector(adhoc)
    memory = ClusterMemoryManager(ClusterMemoryPool(10_000))
    gates = {k: threading.Event() for k in ("e1", "e2", "a1")}
    started = []
    reservations = {"e1": 300, "e2": 300, "a1": 5000}
    tracker = QueryTracker(
        lambda s: _GatedRunner(s, gates, started, reservations),
        resource_groups=mgr, memory=memory)
    qa = tracker.submit("a1", Session(user="bob"))
    qe1 = tracker.submit("e1", Session(user="etl"))
    _wait_until(lambda: len(started) >= 2, what="first two running")
    qe2 = tracker.submit("e2", Session(user="etl"))  # 600 > 500 in etl
    _wait_until(lambda: qe1.state == "FAILED"
                or qe2.state == "FAILED", what="etl kill")
    victim = qe1 if qe1.state == "FAILED" else qe2
    assert victim.error["errorName"] == "CLUSTER_OUT_OF_MEMORY"
    assert "global.etl" in victim.error["message"]
    assert qa.state == "RUNNING"        # the outsider is untouched
    for k in gates:
        gates[k].set()
    for q in (qa, qe1, qe2):
        q.wait_done(5)


def test_real_executor_feeds_pool_and_dies_with_trino_error():
    """A join's reservation flows from the port's executor into the pool
    through session.memory, and the breach fails the query with
    CLUSTER_OUT_OF_MEMORY in the reserving thread, as in the JAX
    engine."""
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu.server.memory import (
        ClusterMemoryManager as TpuManager, ClusterMemoryPool as TpuPool)
    from trino_tpu.session import Session as TpuSession
    sql = ("SELECT count(*) FROM lineitem JOIN orders "
           "ON l_orderkey = o_orderkey")
    errors = []
    for mgr_cls, pool_cls, sess_cls, run in (
            (ClusterMemoryManager, ClusterMemoryPool, Session,
             lambda s: LocalQueryRunner(session=s, device="cpu")),
            (TpuManager, TpuPool, TpuSession,
             lambda s: TpuRunner(session=s))):
        memory = mgr_cls(pool_cls(1 << 19))
        s = sess_cls(catalog="tpch", schema="tiny")
        s.set("stream_chunk_rows", -1)      # the materialised join
        s.memory = memory.register("qx", kill_fn=lambda m, n: None)
        with pytest.raises(Exception) as exc:
            run(s).execute(sql)
        errors.append(exc.value)
        memory.unregister("qx")
        assert memory.pool.reserved_bytes() == 0
    got, want = errors
    assert isinstance(got, QueryError)
    assert got.error_name == want.error_name == "CLUSTER_OUT_OF_MEMORY"
    assert "low-memory killer" in str(got)


def test_query_max_memory_cap_exceeds_global_limit():
    memory = ClusterMemoryManager(ClusterMemoryPool(1 << 30))
    ctx = memory.register("qy", kill_fn=lambda m, n: None,
                          query_limit_bytes=100)
    with pytest.raises(MemoryGovernanceError) as exc:
        ctx.reserve(500)
    assert exc.value.error_name == "EXCEEDED_GLOBAL_MEMORY_LIMIT"
    memory.unregister("qy")


def test_memory_kill_error_name_classifies():
    from trino_tpu.errors import classify as tpu_classify
    from trino_tpu_torch.errors import classify
    cases = [QueryError("The cluster is out of memory ..."),
             QueryError("Query q exceeded the global memory limit of 5 "
                        "bytes"),
             QueryError("Query exceeded the maximum run time "
                        "(query_max_run_time)"),
             QueryError("whatever", error_name="QUERY_QUEUE_FULL"),
             QueryError("Query was canceled"),
             QueryError("Table 'tpch.tiny.x' does not exist"),
             KeyError("boom")]
    got = [classify(e) for e in cases]
    assert [g[0] for g in got] == [
        "CLUSTER_OUT_OF_MEMORY", "EXCEEDED_GLOBAL_MEMORY_LIMIT",
        "EXCEEDED_TIME_LIMIT", "QUERY_QUEUE_FULL", "USER_CANCELED",
        "TABLE_NOT_FOUND", "GENERIC_INTERNAL_ERROR"]
    assert got[0][2] == "INSUFFICIENT_RESOURCES"
    assert got == [tpu_classify(e) for e in cases]
    assert http_status_for("INSUFFICIENT_RESOURCES") == 429
    assert http_status_for("USER_ERROR") == 400
    assert http_status_for("INTERNAL_ERROR") == 500


# --- deadlines ------------------------------------------------------------

def test_deadline_fires_while_still_queued():
    """query_max_run_time budgets the whole run, queue time included: a
    query that spends its budget queued dies at t=limit."""
    mgr = ResourceGroupManager()
    g = mgr.root.add(ResourceGroup("wedged", hard_concurrency=1,
                                   max_queued=10))
    mgr.add_selector(g)
    gates = {"blocker": threading.Event()}
    started = []
    tracker = QueryTracker(
        lambda s: _GatedRunner(s, gates, started, {}),
        resource_groups=mgr)
    blocker = tracker.submit("blocker", Session())
    _wait_until(lambda: "blocker" in started, what="blocker running")
    s = Session()
    s.set("query_max_run_time", 1)
    victim = tracker.submit("victim", Session(properties=s.properties))
    assert victim.state == "QUEUED"
    assert victim.wait_done(5), "queued query missed its deadline"
    assert victim.state == "FAILED"
    assert victim.error["errorName"] == "EXCEEDED_TIME_LIMIT"
    assert "victim" not in started
    _wait_until(lambda: g.queued() == 0, what="dead entry withdrawn")
    q2 = tracker.submit("victim2", Session())
    assert q2.state == "QUEUED" and g.queued() == 1
    tracker.cancel(q2.query_id)
    assert q2.state == "CANCELED" and g.queued() == 0
    gates["blocker"].set()
    blocker.wait_done(5)
    assert g.running == 0


def test_parse_data_size():
    from trino_tpu.server.memory import parse_data_size as tpu_parse
    from trino_tpu_torch.server.memory import parse_data_size
    cases = ["50GB", "512MB", "1.5GB", " 2kB ", "12345", "100B"]
    assert [parse_data_size(c) for c in cases] == [
        50 << 30, 512 << 20, int(1.5 * (1 << 30)), 2048, 12345, 100]
    assert [parse_data_size(c) for c in cases] == \
        [tpu_parse(c) for c in cases]


def test_deadline_enforced_by_standalone_runner():
    """A runner used without a coordinator enforces the deadline: the
    executor stops before the next plan node with EXCEEDED_TIME_LIMIT,
    as the JAX executor does."""
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu.session import Session as TpuSession
    outcomes = []
    for sess_cls, run in ((Session, lambda s: LocalQueryRunner(
            session=s, device="cpu")),
            (TpuSession, lambda s: TpuRunner(session=s))):
        s = sess_cls(catalog="tpch", schema="tiny")
        s.set("query_max_run_time", 1)
        s.deadline = time.monotonic() - 0.1      # already spent
        with pytest.raises(Exception) as exc:
            run(s).execute("SELECT count(*) FROM nation")
        outcomes.append((type(exc.value).__name__, str(exc.value),
                         getattr(exc.value, "error_name", None)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][2] == "EXCEEDED_TIME_LIMIT"


def test_deadline_from_the_property_alone_stops_a_long_query():
    """With no deadline stamped, the standalone runner derives one from
    query_max_run_time and clears it afterwards, so the session runs
    the next query with a fresh budget."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.catalog import CatalogManager

    class SlowTpch(TpchConnector):
        def read_split(self, split, columns):
            time.sleep(0.6)
            return super().read_split(split, columns)

    cats = CatalogManager()
    cats.register("tpch", SlowTpch(device="cpu"))
    s = Session(catalog="tpch", schema="tiny")
    s.set("query_max_run_time", 1)
    lr = LocalQueryRunner(session=s, device="cpu", catalogs=cats)
    with pytest.raises(QueryError) as exc:
        lr.execute("SELECT count(*) FROM nation JOIN region "
                   "ON n_regionkey = r_regionkey JOIN customer "
                   "ON c_nationkey = n_nationkey")
    assert exc.value.error_name == "EXCEEDED_TIME_LIMIT"
    assert s.deadline is None
    assert lr.execute("SELECT count(*) FROM region").rows == [[5]]


# --- observability of the governance layer --------------------------------

def test_governance_metrics_visible_in_exposition(tmp_path):
    co = Coordinator(memory_pool_bytes=123456789, device="cpu",
                     history_dir=str(tmp_path)).start()
    try:
        StatementClient(co.base_uri).execute("SELECT 1")
        raw = urllib.request.urlopen(
            co.base_uri + "/metrics").read().decode()
        fams = parse_exposition(raw)
        assert "trino_tpu_queue_depth" in fams
        assert fams["trino_tpu_memory_pool_bytes"][
            ("kind=total",)] == 123456789
        assert "trino_tpu_memory_kills_total" in fams
        assert "trino_tpu_queue_rejections_total" in fams
        assert "trino_tpu_deadline_cancels_total" in fams
        assert "trino_tpu_query_queued_seconds_count" in raw
        cl = json.loads(urllib.request.urlopen(
            co.base_uri + "/v1/cluster").read())
        assert cl["memory"]["maxBytes"] == 123456789
        assert "reservedBytes" in cl["memory"]
        assert any(i["name"] == "global"
                   for i in co.resource_group_infos())
    finally:
        co.stop()
