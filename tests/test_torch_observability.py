"""The port's telemetry against the JAX package's, on the CPU: the
metrics registry (exposition parsed back), query traces, node stats and
EXPLAIN ANALYZE, the coordinator's /metrics and query detail, the
lifecycle events, and the distributed rollup through port workers.
Counterparts of tests/test_observability.py: each case drives both
packages with the same SQL and holds the port's observations (names,
row counts, shapes) to the JAX package's and to the reference test's
own expectations. Where the port differs by design it is stated: the
port compiles no programs, so it has no jit cache and its node stats
carry no compile time.
"""

import json
import urllib.request

import pytest

from trino_tpu.obs import metrics as tpu_metrics
from trino_tpu.obs.trace import QueryTrace as TpuTrace
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu_torch.obs.metrics import (MetricsRegistry,
                                         parse_exposition)
from trino_tpu_torch.obs.trace import QueryTrace
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

REGISTRIES = (MetricsRegistry, tpu_metrics.MetricsRegistry)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_registry_counter_labels_and_render():
    texts = []
    for cls in REGISTRIES:
        reg = cls()
        c = reg.counter("t_total", "help text", ("op", "ok"))
        c.inc(op="scan", ok="true")
        c.inc(2, op="scan", ok="false")
        assert c.value(op="scan", ok="true") == 1
        assert c.value(op="scan", ok="false") == 2
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert "# TYPE t_total counter" in texts[0]
    assert parse_exposition(texts[0])["t_total"][("op=scan", "ok=false")] \
        == 2.0


def test_registry_counter_rejects_label_drift_and_negatives():
    for cls in REGISTRIES:
        reg = cls()
        c = reg.counter("t2_total", "", ("a",))
        with pytest.raises(ValueError):
            c.inc(b="x")
        with pytest.raises(ValueError):
            c.inc(-1, a="x")
        assert reg.counter("t2_total", "", ("a",)) is c
        with pytest.raises(ValueError):
            reg.gauge("t2_total")


def test_registry_histogram_buckets():
    parsed = []
    for cls in REGISTRIES:
        reg = cls()
        h = reg.histogram("t_seconds", "", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        parsed.append(parse_exposition(reg.render()))
    assert parsed[0] == parsed[1]
    p = parsed[0]
    assert p["t_seconds_bucket"][("le=0.1",)] == 1.0
    assert p["t_seconds_bucket"][("le=1",)] == 2.0
    assert p["t_seconds_bucket"][("le=+Inf",)] == 3.0
    assert p["t_seconds_count"][()] == 3.0
    assert p["t_seconds_sum"][()] == pytest.approx(5.55)


def test_registry_collector_refreshes_gauge_at_render():
    for cls in REGISTRIES:
        reg = cls()
        g = reg.gauge("t_depth", "")
        state = {"n": 0}
        reg.register_collector(lambda: g.set(state["n"]))
        state["n"] = 7
        assert parse_exposition(reg.render())["t_depth"][()] == 7.0


def _shape(dicts):
    """A span tree without its ids and clocks."""
    return [(d["name"], d.get("attrs"), _shape(d.get("children") or []))
            for d in dicts]


def test_trace_span_nesting_and_lines():
    shapes = []
    for cls in (QueryTrace, TpuTrace):
        tr = cls("q1")
        with tr.span("plan"):
            pass
        with tr.span("execute"):
            with tr.span("jit_trace", cache="chain"):
                pass
        assert [s.name for s in tr.roots] == ["plan", "execute"]
        assert tr.roots[1].children[0].name == "jit_trace"
        assert any("jit_trace" in ln for ln in tr.lines())
        shapes.append(_shape(tr.to_dicts()))
    assert shapes[0] == shapes[1]
    assert shapes[0][1][2][0][1] == {"cache": "chain"}


# ---------------------------------------------------------------------------
# single node: spans, node stats, EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runners():
    return (LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"),
                             device="cpu", collect_node_stats=True),
            TpuRunner(session=TpuSession(catalog="tpch", schema="tiny"),
                      collect_node_stats=True))


def test_span_tree_single_node(runners):
    sql = ("SELECT l_returnflag, count(*) FROM lineitem "
           "GROUP BY l_returnflag")
    for r in runners:
        res = r.execute(sql)
        assert [s.name for s in res.trace.roots] == \
            ["parse", "plan", "optimize", "execute"]
        assert all(s.wall_s >= 0 for s in res.trace.roots)
        assert res.trace.query_id == res.query_id


def test_node_stats_rows_and_bytes(runners):
    sql = "SELECT count(*) AS n FROM lineitem WHERE l_quantity > 30"
    flows = []
    for r in runners:
        res = r.execute(sql)
        scan = [s for s in res.stats if s.name == "TableScan"]
        agg = [s for s in res.stats if s.name == "Aggregation"]
        assert scan and agg
        assert agg[0].input_rows == scan[0].output_rows > 0
        assert agg[0].output_rows == 1
        assert all(s.output_bytes >= 0 for s in res.stats)
        assert scan[0].output_bytes > 0
        flows.append((scan[0].output_rows, agg[0].output_rows,
                      res.rows))
    assert flows[0] == flows[1]


def test_explain_analyze_reports_flow(runners):
    for r in runners:
        text = "\n".join(row[0] for row in r.execute(
            "EXPLAIN ANALYZE SELECT count(*) FROM orders").rows)
        assert "TableScan" in text
        assert " in " in text and " out " in text and " rows" in text
        assert "Trace:" in text and "execute" in text


def test_jit_cache_counters_and_compile_attribution(runners):
    """The JAX executor's second run of a plan hits its program cache;
    the port compiles no programs, so its node stats carry no compile
    time and no cache verdict, run after run."""
    from trino_tpu.exec.executor import Executor as TpuExecutor, _M_JIT
    from trino_tpu.exec.executor import _CHAIN_JIT_CACHE
    from trino_tpu_torch.exec.executor import Executor
    sql = ("SELECT l_orderkey + 7 AS k FROM lineitem "
           "WHERE l_quantity > 30")
    port, tpu = runners
    plan = tpu.plan_sql(sql)
    # the JAX package's program cache is process-wide: a test file that
    # ran this canonical chain earlier in the same worker process
    # (tests/test_observability.py runs this very query) would make the
    # first run a hit too
    _CHAIN_JIT_CACHE.clear()
    before_hit = _M_JIT.value(cache="chain", result="hit")
    for _ in range(2):
        ex = TpuExecutor(tpu.catalogs,
                         TpuSession(catalog="tpch", schema="tiny"),
                         collect_stats=True, fragment_jit=True)
        want = ex.execute(plan)
    assert _M_JIT.value(cache="chain", result="hit") == before_hit + 1
    assert any(s.cache_hit is True for s in ex.stats)
    pplan = port.plan_sql(sql)
    for _ in range(2):
        pex = Executor(port.catalogs, Session(catalog="tpch",
                                              schema="tiny"),
                       port.device, collect_stats=True)
        got = pex.execute(pplan)
        assert pex.stats
        assert all(s.compile_s == 0.0 and s.cache_hit is None
                   for s in pex.stats)
    assert got.num_rows_host() == int(want.num_rows)


def test_peak_memory_reported(runners):
    for r in runners:
        res = r.execute("SELECT count(*) FROM orders")
        assert res.peak_memory_bytes > 0
        assert res.spill_bytes == 0


# ---------------------------------------------------------------------------
# coordinator: /metrics and query detail
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coordinators(tmp_path_factory):
    from trino_tpu.server import Coordinator as TpuCoordinator
    from trino_tpu_torch.server import Coordinator
    cos = (Coordinator(device="cpu", history_dir=str(
        tmp_path_factory.mktemp("hist_port"))).start(),
           TpuCoordinator(history_dir=str(
               tmp_path_factory.mktemp("hist_jax"))).start())
    yield cos
    for co in cos:
        co.stop()


def _scrape(co):
    with urllib.request.urlopen(f"{co.base_uri}/metrics") as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        return parse_exposition(r.read().decode())


def _run(co, sql):
    from trino_tpu_torch.client import StatementClient
    return StatementClient(co.base_uri, catalog="tpch",
                           schema="tiny").execute(sql)


def test_metrics_endpoint_counters_monotonic(coordinators):
    for co in coordinators:
        _run(co, "SELECT 1")
        m1 = _scrape(co)
        finished1 = m1["trino_tpu_query_states_total"][("state=FINISHED",)]
        assert finished1 >= 1
        assert m1["trino_tpu_query_states_total"][("state=QUEUED",)] >= \
            finished1
        _run(co, "SELECT count(*) FROM orders")
        m2 = _scrape(co)
        assert m2["trino_tpu_query_states_total"][("state=FINISHED",)] \
            == finished1 + 1
        assert m2["trino_tpu_queries"][("state=FINISHED",)] >= 2
        assert "trino_tpu_queue_depth" in m2
        assert m2["trino_tpu_query_wall_seconds_count"][()] > \
            m1["trino_tpu_query_wall_seconds_count"][()] - 1


def test_metrics_endpoint_includes_jit_and_scan_counters(coordinators):
    """Both expose scan-cache lookups on /metrics; only the JAX package
    has a jit cache to count."""
    port, tpu = coordinators
    from trino_tpu.exec.executor import Executor as TpuExecutor
    r = TpuRunner(session=TpuSession(catalog="tpch", schema="tiny"))
    TpuExecutor(r.catalogs, r.session, fragment_jit=True).execute(
        r.plan_sql("SELECT l_orderkey * 2 AS k FROM lineitem "
                   "WHERE l_quantity > 40"))
    for co in coordinators:
        _run(co, "SELECT count(*) FROM lineitem")
        m = _scrape(co)
        assert sum(m["trino_tpu_scan_cache_total"].values()) >= 1
    assert sum(_scrape(tpu)["trino_tpu_jit_cache_total"].values()) >= 1
    port_families = {name for name in _scrape(port)}
    assert not any(n.startswith("trino_tpu_jit_cache")
                   for n in port_families)


def test_query_detail_serves_cached_plan_and_spans(coordinators):
    details = []
    for co in coordinators:
        res = _run(co, "SELECT o_orderpriority, count(*) FROM orders "
                       "GROUP BY o_orderpriority")
        q = co.tracker.get(res.query_id)
        assert q.result.plan_lines
        with urllib.request.urlopen(
                f"{co.base_uri}/v1/query/{res.query_id}") as r:
            d = json.loads(r.read())
        assert d["plan"] == q.result.plan_lines
        assert "planError" not in d
        assert [s["name"] for s in d.get("spans") or []] == \
            ["parse", "plan", "optimize", "execute"]
        stats = d.get("nodeStats") or []
        assert stats and all("inputRows" in s and "compileMillis" in s
                             for s in stats)
        assert d["peakMemoryBytes"] > 0
        details.append([(s["inputRows"], s["outputRows"]) for s in stats])
    assert details[0] == details[1]


def test_enriched_query_completed_event(coordinators):
    from trino_tpu.server.events import EventListener as TpuListener
    from trino_tpu_torch.server.events import EventListener
    events = []
    for co, base in zip(coordinators, (EventListener, TpuListener)):
        done = []

        class L(base):
            def query_completed(self, event):
                done.append(event)
        co.tracker.events.add_listener(L())
        _run(co, "SELECT count(*) FROM orders")
        ev = done[-1]
        assert ev.state == "FINISHED"
        assert ev.peak_memory_bytes > 0
        assert ev.cumulative_operator_stats is not None
        assert ev.cumulative_operator_stats["output_rows"] >= 1
        assert ev.operator_summaries and \
            ev.operator_summaries[0].get("name")
        events.append(ev.cumulative_operator_stats["output_rows"])
    assert events[0] == events[1]


def test_split_completed_event_fires_with_wall_time():
    """A split read fires a SplitCompletedEvent naming the table's
    split: through the JAX session's listener manager, and through the
    port session's ``on_split`` hook (what the port's coordinator wires
    to its manager)."""
    from trino_tpu.server.events import (
        EventListener as TpuListener,
        EventListenerManager as TpuManager)
    from trino_tpu_torch.server.events import (EventListener,
                                               EventListenerManager,
                                               SplitCompletedEvent)
    got = {"jax": [], "torch": []}

    class L(TpuListener):
        def split_completed(self, event):
            got["jax"].append(event)

    class P(EventListener):
        def split_completed(self, event):
            got["torch"].append(event)
    tmgr = TpuManager()
    tmgr.add_listener(L())
    TpuRunner(session=TpuSession(catalog="tpch", schema="tiny",
                                 events=tmgr)).execute(
        "SELECT count(*) FROM orders")
    pmgr = EventListenerManager()
    pmgr.add_listener(P())
    s = Session(catalog="tpch", schema="tiny")
    r = LocalQueryRunner(session=s, device="cpu")
    s.on_split = lambda split_id, wall_s: pmgr.split_completed(
        SplitCompletedEvent(s.query_id, split_id, wall_s))
    r.execute("SELECT count(*) FROM orders")
    for ev in (got["jax"][0], got["torch"][0]):
        assert ev.query_id.startswith("query_")
        assert "tpch.tiny.orders" in ev.split_id
        assert ev.wall_s >= 0
    assert len(got["torch"]) == len(got["jax"])


# ---------------------------------------------------------------------------
# distributed: the rollup, fragment spans, EXPLAIN ANALYZE, worker /metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workers():
    from trino_tpu.server.task_worker import TaskWorkerServer as TpuWorker
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    port = [TaskWorkerServer(device="cpu").start() for _ in range(2)]
    tpu = [TpuWorker().start() for _ in range(2)]
    yield ([w.base_uri for w in port], [w.base_uri for w in tpu])
    for w in port + tpu:
        w.stop()


def _dist_runners(workers):
    """(port, JAX) distributed runners pinned to the flat leaf path."""
    from trino_tpu.exec.remote import DistributedHostQueryRunner as TpuDist
    from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
    port_uris, tpu_uris = workers
    flat = {"multistage_execution": False}
    return (DistributedHostQueryRunner(
        port_uris, session=Session(catalog="tpch", schema="tiny",
                                   properties=dict(flat)),
        collect_node_stats=True, device="cpu"),
        TpuDist(tpu_uris, session=TpuSession(
            catalog="tpch", schema="tiny", properties=dict(flat)),
            collect_node_stats=True))


def test_distributed_stats_rollup_sums_to_totals(workers):
    out = []
    for d in _dist_runners(workers):
        res = d.execute("SELECT count(*) AS n FROM lineitem")
        total = res.rows[0][0]
        frag = [s for s in res.stats if "fragment" in s.detail]
        assert frag
        agg_in = [s.input_rows for s in frag if s.name == "Aggregation"]
        assert agg_in and agg_in[0] == total
        combine = [s for s in res.stats
                   if s.name == "Aggregation" and "fragment" not in s.detail]
        frag_out = [s.output_rows for s in frag
                    if s.name == "Aggregation"][0]
        assert combine and combine[0].input_rows == frag_out
        out.append((total, agg_in[0], frag_out))
    assert out[0] == out[1]


def test_distributed_span_tree_has_fragment_children(workers):
    for d in _dist_runners(workers):
        res = d.execute("SELECT sum(l_quantity) FROM lineitem")
        assert [s.name for s in res.trace.roots] == \
            ["plan", "optimize", "execute"]
        execute = res.trace.roots[-1]
        assert "schedule" in [c.name for c in execute.children]
        frags = [c for c in execute.children
                 if c.name.startswith("fragment_")]
        assert len(frags) == 2
        assert any(g.name == "task_execute"
                   for f in frags for g in f.children)


def test_distributed_explain_analyze_per_fragment(workers):
    for d in _dist_runners(workers):
        text = "\n".join(r[0] for r in d.execute(
            "EXPLAIN ANALYZE SELECT l_returnflag, count(*) FROM lineitem "
            "GROUP BY l_returnflag").rows)
        assert "fragment 0 x2 workers" in text
        assert " in " in text and " rows" in text
        assert "Trace:" in text and "fragment_0_execute" in text


def test_worker_metrics_endpoint_and_task_stats(workers):
    from trino_tpu.plan.serde import to_jsonable as tpu_jsonable
    from trino_tpu.server.task_worker import RemoteTaskClient as TpuClient
    from trino_tpu_torch.plan.serde import to_jsonable
    from trino_tpu_torch.server.task_worker import RemoteTaskClient
    sql = "SELECT o_orderkey FROM orders WHERE o_orderkey < 100"
    port_uris, tpu_uris = workers
    sides = (
        (RemoteTaskClient(port_uris[0]), to_jsonable(
            LocalQueryRunner(device="cpu").plan_sql(sql)), port_uris[0]),
        (TpuClient(tpu_uris[0]), tpu_jsonable(TpuRunner().plan_sql(sql)),
         tpu_uris[0]))
    scans = []
    for client, frag, uri in sides:
        client.submit_fragment("obs-task-1", frag, catalog="tpch",
                               schema="tiny", part=0, nparts=1,
                               collect_stats=True)
        assert client.pages_raw("obs-task-1")
        status = client.status("obs-task-1")
        assert status["state"] == "FINISHED"
        stats = status["nodeStats"]
        assert stats and any(s["name"] == "TableScan" for s in stats)
        assert status["spans"][0]["name"] == "task_execute"
        with urllib.request.urlopen(f"{uri}/metrics") as resp:
            m = parse_exposition(resp.read().decode())
        assert m["trino_tpu_worker_tasks_total"].get(
            ("state=FINISHED",), 0) >= 1
        assert sum(m["trino_tpu_exchange_pages_total"].values()) >= 1
        scans.append([s["output_rows"] for s in stats
                      if s["name"] == "TableScan"])
    assert scans[0] == scans[1]


# ---------------------------------------------------------------------------
# the overhead bound of the stats
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_telemetry_overhead_under_5_percent():
    """Node stats stay cheap enough to leave on at the coordinator: the
    port's q1 at tpch.sf1 with them on against off, interleaved,
    best of five a side."""
    import time as _time
    from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
    sql = TPCH_QUERIES[1]
    runners = {c: LocalQueryRunner(
        session=Session(catalog="tpch", schema="sf1"), device="cpu",
        collect_node_stats=c) for c in (False, True)}
    for r in runners.values():
        r.execute(sql)
    best = {False: float("inf"), True: float("inf")}
    for _ in range(5):
        for collect, r in runners.items():
            t0 = _time.perf_counter()
            r.execute(sql)
            best[collect] = min(best[collect], _time.perf_counter() - t0)
    overhead = best[True] / best[False] - 1.0
    assert overhead < 0.05, f"telemetry overhead {overhead:.1%} exceeds 5%"


@pytest.mark.slow
def test_telemetry_overhead_under_5_percent_distributed_mpp(tmp_path):
    """The same bound on the port's default (multistage) distributed
    path with the whole telemetry on: traces, worker spans merged and
    OTLP export to a file."""
    import time as _time
    from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.config import CONFIG
    from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    sql = TPCH_QUERIES[1]
    workers = [TaskWorkerServer(device="cpu").start() for _ in range(2)]
    sink = str(tmp_path / "otlp.jsonl")
    old = CONFIG.otlp_file
    try:
        runners = {c: DistributedHostQueryRunner(
            [w.base_uri for w in workers],
            session=Session(catalog="tpch", schema="sf1"),
            collect_node_stats=c, device="cpu") for c in (False, True)}
        for r in runners.values():
            r.execute(sql)
        best = {False: float("inf"), True: float("inf")}
        for _ in range(5):
            for collect, r in runners.items():
                CONFIG.otlp_file = sink if collect else ""
                t0 = _time.perf_counter()
                r.execute(sql)
                best[collect] = min(best[collect],
                                    _time.perf_counter() - t0)
        overhead = best[True] / best[False] - 1.0
        assert overhead < 0.05, \
            f"MPP telemetry overhead {overhead:.1%} exceeds 5%"
        assert sum(1 for _ in open(sink)) >= 5
    finally:
        CONFIG.otlp_file = old
        for w in workers:
            w.stop()
