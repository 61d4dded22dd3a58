"""The port's distributed tracing against the JAX package's, on the CPU:
span identity, W3C ``traceparent`` propagation, the id-preserving graft,
the OTLP export (obs/otlp.py: documents, sinks, validation, the session
opt-out), the worker's status attribution, one trace id end to end
through port workers, GET /v1/trace/{id} on the port's coordinator, and
the split scheduler's observables. Counterparts of
tests/test_distributed_trace.py: the same traces and SQL go through both
packages; OTLP documents must be equal apart from ids and timestamps.
The port measures no device time (its node stats and stage spans carry
none), which the device cases state.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from trino_tpu.obs import otlp as tpu_otlp
from trino_tpu.obs import trace as tpu_trace
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu_torch.obs import otlp, trace
from trino_tpu_torch.obs.otlp import (FileSink, HttpSink, spans_from_otlp,
                                      trace_to_resource_spans,
                                      validate_resource_spans)
from trino_tpu_torch.obs.trace import (QueryTrace, format_traceparent,
                                       new_span_id, new_trace_id,
                                       parse_traceparent)
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

_IDS = ("traceId", "spanId", "parentSpanId", "startTimeUnixNano",
        "endTimeUnixNano")


def normalized(doc: dict) -> dict:
    """An OTLP document without its ids and clocks; each span's parent
    named by the parent's position in the span list instead."""
    doc = json.loads(json.dumps(doc))
    for rs in doc["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            index = {s["spanId"]: i for i, s in enumerate(ss["spans"])}
            for s in ss["spans"]:
                s["parent"] = index.get(s.get("parentSpanId"))
                for k in _IDS:
                    s.pop(k, None)
    return doc


# ---------------------------------------------------------------------------
# span identity and W3C context
# ---------------------------------------------------------------------------

def test_span_and_trace_id_shapes():
    for mod in (trace, tpu_trace):
        tid, sid = mod.new_trace_id(), mod.new_span_id()
        assert len(tid) == 32 and int(tid, 16) >= 0
        assert len(sid) == 16 and int(sid, 16) >= 0
        assert mod.new_span_id() != sid
        tp = mod.format_traceparent(tid, sid)
        assert tp == f"00-{tid}-{sid}-01"
        assert mod.parse_traceparent(tp) == (tid, sid)
    # each package parses the other's header
    tid, sid = new_trace_id(), new_span_id()
    assert tpu_trace.parse_traceparent(format_traceparent(tid, sid)) == \
        (tid, sid)


@pytest.mark.parametrize("bad", [
    None, 42, "", "00-zz-yy-01", "00-" + "a" * 32,
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01"])
def test_parse_traceparent_rejects_malformed(bad):
    assert parse_traceparent(bad) is None
    assert tpu_trace.parse_traceparent(bad) is None


def test_every_span_carries_identity():
    for cls in (QueryTrace, tpu_trace.QueryTrace):
        tr = cls("q")
        with tr.span("a"):
            with tr.span("b"):
                pass
        a, b = tr.roots[0], tr.roots[0].children[0]
        assert len(a.span_id) == 16 and len(b.span_id) == 16
        assert a.span_id != b.span_id
        d = tr.to_dicts()[0]
        assert d["spanId"] == a.span_id
        assert d["children"][0]["spanId"] == b.span_id
        assert d["startUnixNanos"] > 0 and d["endUnixNanos"] >= \
            d["startUnixNanos"]


def test_two_thread_span_stack_isolation():
    """A span opened on a second thread does not nest under what the
    first thread has open."""
    for cls in (QueryTrace, tpu_trace.QueryTrace):
        tr = cls("q")
        entered, release, errors = (threading.Event(), threading.Event(),
                                    [])

        def dispatcher():
            try:
                with tr.span("dispatch_side") as sp:
                    with tr.span("dispatch_child"):
                        pass
                    assert tr.current() is sp
                entered.set()
                release.wait(5)
            except Exception as e:     # noqa: BLE001
                errors.append(e)
                entered.set()

        with tr.span("executor_side") as main_sp:
            t = threading.Thread(target=dispatcher)
            t.start()
            assert entered.wait(5)
            assert tr.current() is main_sp
            release.set()
            t.join()
        assert not errors
        assert {r.name for r in tr.roots} == {"executor_side",
                                              "dispatch_side"}
        disp = next(r for r in tr.roots if r.name == "dispatch_side")
        assert [c.name for c in disp.children] == ["dispatch_child"]
        assert not next(r for r in tr.roots
                        if r.name == "executor_side").children


def test_explicit_parent_escape_hatch():
    for cls in (QueryTrace, tpu_trace.QueryTrace):
        tr = cls("q")
        with tr.span("root") as root:
            done = threading.Event()

            def worker():
                with tr.span("attached", parent=root, part=1):
                    pass
                done.set()
            threading.Thread(target=worker).start()
            assert done.wait(5)
        assert [c.name for c in root.children] == ["attached"]


# ---------------------------------------------------------------------------
# the id-preserving graft
# ---------------------------------------------------------------------------

def test_graft_preserves_ids_and_realigns_clock():
    """A worker subtree born under the query's trace id and a pre-minted
    parent span merges with its ids and its durations; a port worker's
    wire dicts graft into a JAX trace and the other way round."""
    for co_cls, wk_cls in ((QueryTrace, QueryTrace),
                           (QueryTrace, tpu_trace.QueryTrace),
                           (tpu_trace.QueryTrace, QueryTrace)):
        co = co_cls("query_9")
        minted = co.new_span_id()
        tid, psid = parse_traceparent(co.traceparent(minted))
        wk = wk_cls("task_9.0", trace_id=tid, parent_span_id=psid)
        assert wk.trace_id == co.trace_id
        with wk.span("task_execute", task="t0"):
            with wk.span("device_execute", cache="chain"):
                time.sleep(0.002)
        frag = co.record("stage_0_execute", co.origin_s,
                         co.origin_s + 0.05, span_id=minted)
        co.graft(frag, wk.to_dicts())
        merged = frag.children[0]
        assert merged.span_id == wk.roots[0].span_id
        assert merged.parent_id == minted
        assert merged.children[0].span_id == \
            wk.roots[0].children[0].span_id
        assert merged.children[0].wall_s == pytest.approx(
            wk.roots[0].children[0].wall_s, abs=1e-4)


def test_graft_legacy_dicts_without_ids_still_merge():
    for cls in (QueryTrace, tpu_trace.QueryTrace):
        co = cls("q")
        parent = co.record("fragment_0_execute", co.origin_s,
                           co.origin_s + 0.01)
        co.graft(parent, [{"name": "task_execute", "startMillis": 0.0,
                           "wallMillis": 5.0}])
        child = parent.children[0]
        assert len(child.span_id) == 16
        assert child.parent_id == parent.span_id


# ---------------------------------------------------------------------------
# OTLP: ResourceSpans, sinks, round trip
# ---------------------------------------------------------------------------

def _demo_trace(cls=QueryTrace):
    tr = cls("query_42")
    with tr.span("plan"):
        pass
    with tr.span("execute", rows=10):
        with tr.span("jit_trace", cache="chain", device_ms=1.5):
            pass
    return tr


def test_otlp_document_shape_and_roundtrip():
    tr = _demo_trace()
    doc = trace_to_resource_spans(tr, {"extra": "x"})
    validate_resource_spans(doc)
    tpu_otlp.validate_resource_spans(doc)
    # the JAX package's document of the same trace is the same apart
    # from ids and clocks
    want = tpu_otlp.trace_to_resource_spans(
        _demo_trace(tpu_trace.QueryTrace), {"extra": "x"})
    assert normalized(doc) == normalized(want)
    doc2 = json.loads(json.dumps(doc))
    validate_resource_spans(doc2)
    spans = spans_from_otlp(doc2)
    assert spans == tpu_otlp.spans_from_otlp(doc2)
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"plan", "execute", "jit_trace"}
    assert all(s["traceId"] == tr.trace_id for s in spans)
    assert by_name["jit_trace"]["parentSpanId"] == \
        by_name["execute"]["spanId"]
    assert "parentSpanId" not in by_name["plan"]
    keys = {a["key"] for a in
            doc2["resourceSpans"][0]["resource"]["attributes"]}
    assert {"service.name", "trino_tpu.query_id", "extra"} <= keys
    attrs = {a["key"]: a["value"]
             for a in by_name["execute"]["attributes"]}
    assert attrs["rows"] == {"intValue": "10"}


def test_otlp_validation_catches_bad_ids():
    for mod in (otlp, tpu_otlp):
        doc = mod.trace_to_resource_spans(_demo_trace())
        doc["resourceSpans"][0]["scopeSpans"][0]["spans"][0]["spanId"] = \
            "short"
        with pytest.raises(ValueError, match="spanId"):
            mod.validate_resource_spans(doc)


def test_otlp_file_sink_appends_jsonl(tmp_path):
    for mod in (otlp, tpu_otlp):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        sink = mod.FileSink(path)
        sink.export(mod.trace_to_resource_spans(_demo_trace()))
        sink.export(mod.trace_to_resource_spans(_demo_trace()))
        lines = open(path).read().splitlines()
        assert len(lines) == 2
        for line in lines:
            validate_resource_spans(json.loads(line))
    assert FileSink.name == tpu_otlp.FileSink.name == "file"


def test_otlp_http_sink_posts_to_collector():
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    got = []

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            got.append((self.path, json.loads(self.rfile.read(n))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        uri = f"http://127.0.0.1:{srv.server_address[1]}"
        HttpSink(uri).export(trace_to_resource_spans(_demo_trace()))
        tpu_otlp.HttpSink(uri).export(tpu_otlp.trace_to_resource_spans(
            _demo_trace(tpu_trace.QueryTrace)))
        assert [p for p, _ in got] == ["/v1/traces", "/v1/traces"]
        validate_resource_spans(got[0][1])
        assert normalized(got[0][1]) == normalized(got[1][1])
    finally:
        srv.shutdown()
        srv.server_close()


def test_maybe_export_respects_config_and_session(tmp_path):
    from trino_tpu.config import CONFIG as TPU_CONFIG
    from trino_tpu_torch.config import CONFIG
    out = []
    for mod, config, sess in ((otlp, CONFIG, Session),
                              (tpu_otlp, TPU_CONFIG, TpuSession)):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        old = config.otlp_file
        config.otlp_file = path
        try:
            tr = _demo_trace()
            s = sess(catalog="tpch", schema="tiny")
            s.set("otlp_export", False)
            assert mod.maybe_export(tr, session=s) == 0
            s.set("otlp_export", True)
            assert mod.maybe_export(tr, session=s) == 1
            doc = json.loads(open(path).read())
            validate_resource_spans(doc)
            out.append(normalized(doc))
        finally:
            config.otlp_file = old
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# device and CPU attribution
# ---------------------------------------------------------------------------

def test_device_time_attribution_on_jitted_dispatch(monkeypatch):
    """The JAX engine's jitted dispatches carry device_ms on their spans
    and device_s on their nodes; the port dispatches no programs and
    measures no device time: its nodes carry device_s 0 and cpu_s >= 0,
    over the same rows, and EXPLAIN ANALYZE renders no device time."""
    monkeypatch.setenv("TRINO_TPU_FRAGMENT_JIT", "1")
    sql = ("SELECT l_orderkey + 1 AS k FROM lineitem "
           "WHERE l_quantity > 30")
    r = TpuRunner(session=TpuSession(catalog="tpch", schema="tiny"),
                  collect_node_stats=True)
    r.execute(sql)
    want = r.execute(sql)
    assert any(s.device_s > 0 for s in want.stats)
    p = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"),
                         device="cpu", collect_node_stats=True)
    got = p.execute(sql)
    assert sorted(got.rows) == sorted(want.rows)
    assert got.stats and all(s.device_s == 0 and s.cpu_s >= 0
                             for s in got.stats)
    text = "\n".join(row[0] for row in p.execute(
        "EXPLAIN ANALYZE " + sql).rows)
    assert "TableScan" in text and "device " not in text


# ---------------------------------------------------------------------------
# workers: traceparent in, cpu and trace id out
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workers():
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    ws = [TaskWorkerServer(device="cpu").start() for _ in range(2)]
    yield ws
    for w in ws:
        w.stop()


def test_worker_status_carries_attribution_and_trace_id(workers):
    from trino_tpu_torch.plan.serde import to_jsonable
    from trino_tpu_torch.server.task_worker import RemoteTaskClient
    plan = LocalQueryRunner(device="cpu").plan_sql(
        "SELECT o_orderkey FROM orders WHERE o_orderkey < 500")
    tid, psid = new_trace_id(), new_span_id()
    client = RemoteTaskClient(workers[0].base_uri)
    client.submit_fragment(
        "trace-task-1", to_jsonable(plan), catalog="tpch", schema="tiny",
        part=0, nparts=1, collect_stats=True,
        traceparent=format_traceparent(tid, psid))
    status = client.wait_done("trace-task-1")
    assert status["state"] == "FINISHED"
    assert status["traceId"] == tid
    roots = status["spans"]
    assert roots and roots[0]["name"] == "task_execute"
    assert roots[0]["parentSpanId"] == psid
    assert len(roots[0]["spanId"]) == 16
    assert status["cpuSeconds"] > 0
    # the port's status carries no device seconds (not measured)
    assert "deviceSeconds" not in status


def test_traceparent_header_fallback(workers):
    from trino_tpu_torch.plan.serde import to_jsonable
    from trino_tpu_torch.server.task_worker import RemoteTaskClient
    plan = LocalQueryRunner(device="cpu").plan_sql(
        "SELECT r_name FROM region")
    tid, psid = new_trace_id(), new_span_id()
    body = {"fragment": to_jsonable(plan), "catalog": "tpch",
            "schema": "tiny", "part": 0, "nparts": 1,
            "collect_stats": True, "properties": {}}
    req = urllib.request.Request(
        f"{workers[0].base_uri}/v1/task/trace-task-hdr",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "traceparent": format_traceparent(tid, psid)},
        method="POST")
    with urllib.request.urlopen(req, timeout=30):
        pass
    status = RemoteTaskClient(workers[0].base_uri).wait_done(
        "trace-task-hdr")
    assert status["traceId"] == tid
    assert status["spans"][0]["parentSpanId"] == psid


# ---------------------------------------------------------------------------
# one trace id end to end on the default (multistage) path
# ---------------------------------------------------------------------------

JOIN_AGG_SQL = (
    "SELECT o_orderpriority, count(*) AS n FROM orders "
    "JOIN lineitem ON o_orderkey = l_orderkey "
    "WHERE l_quantity > 30 GROUP BY o_orderpriority")


def _walk_dicts(ds, out):
    for d in ds:
        out.append(d)
        _walk_dicts(d.get("children") or [], out)


def _want_rows():
    return sorted(TpuRunner().execute(JOIN_AGG_SQL).rows)


def test_distributed_trace_single_identity_default_mpp(workers):
    from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
    before = {tid for w in workers for tid in w._tasks}
    res = DistributedHostQueryRunner(
        [w.base_uri for w in workers],
        session=Session(catalog="tpch", schema="tiny"),
        collect_node_stats=True, device="cpu").execute(JOIN_AGG_SQL)
    assert sorted(res.rows) == _want_rows()
    tr = res.trace
    assert len(tr.trace_id) == 32
    flat = []
    _walk_dicts(tr.to_dicts(), flat)
    stage_spans = {d["spanId"]: d for d in flat
                   if re.match(r"stage_\d+_execute", d["name"])}
    assert stage_spans, "no stage spans: did the stage DAG run?"
    task_spans = [d for d in flat if d["name"] == "task_execute"]
    assert task_spans, "no worker subtrees grafted"
    for t in task_spans:
        assert t.get("parentSpanId") in stage_spans
    for sp in stage_spans.values():
        assert "cpu_s" in (sp.get("attrs") or {})
    born = [t.trace_id for w in workers
            for tid, t in w._tasks.items()
            if tid not in before and t.trace_id is not None]
    assert born and all(tid == tr.trace_id for tid in born)


def test_distributed_explain_analyze_shows_cpu_and_device(workers):
    """Each stage's rollup carries its tasks' CPU seconds (the JAX
    package adds device ms, which the port does not measure)."""
    from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
    res = DistributedHostQueryRunner(
        [w.base_uri for w in workers],
        session=Session(catalog="tpch", schema="tiny"),
        collect_node_stats=True, device="cpu").execute(
            "EXPLAIN ANALYZE " + JOIN_AGG_SQL)
    text = "\n".join(r[0] for r in res.rows)
    tags = re.findall(r"stage \d+ x\d+ tasks \[cpu ([0-9.]+)s\]", text)
    assert tags, text
    assert any(float(cpu) > 0 for cpu in tags), tags


def test_coordinator_v1_trace_endpoint_e2e(workers, tmp_path):
    """A distributed query through the port's coordinator and port
    workers; GET /v1/trace/{id} serves OTLP/JSON with one trace id and
    worker spans under their dispatching stage spans, shaped as the JAX
    coordinator's document of the same query."""
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.server import Coordinator
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    try:
        for w in workers:
            co.add_worker(w.base_uri)
        res = StatementClient(co.base_uri, catalog="tpch",
                              schema="tiny").execute(JOIN_AGG_SQL)
        assert sorted(res.rows) == _want_rows()
        with urllib.request.urlopen(
                f"{co.base_uri}/v1/trace/{res.query_id}") as r:
            doc = json.loads(r.read())
        validate_resource_spans(doc)
        tpu_otlp.validate_resource_spans(doc)
        spans = spans_from_otlp(doc)
        assert len({s["traceId"] for s in spans}) == 1
        by_id = {s["spanId"]: s for s in spans}
        tasks = [s for s in spans if s["name"] == "task_execute"]
        assert tasks, "no worker spans in the exported trace"
        for t in tasks:
            parent = by_id.get(t.get("parentSpanId"))
            assert parent is not None
            assert re.match(r"(stage|fragment)_\d+_execute",
                            parent["name"])
        attrs = {a["key"]: a["value"]
                 for a in doc["resourceSpans"][0]["resource"]
                 ["attributes"]}
        assert attrs["trino_tpu.query_id"]["stringValue"] == res.query_id
        assert attrs["service.name"]["stringValue"] == \
            "trino_tpu-coordinator"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{co.base_uri}/v1/trace/nope_404")
        assert exc.value.code == 404
    finally:
        co.stop()


# ---------------------------------------------------------------------------
# the split scheduler's observables
# ---------------------------------------------------------------------------

def test_busy_shed_ema_smooths_bursts():
    from trino_tpu.exec.taskexec import TaskExecutor as TpuExecutor
    from trino_tpu_torch.exec.taskexec import TaskExecutor
    for cls in (TaskExecutor, TpuExecutor):
        now = [0.0]
        ex = cls(1, clock=lambda: now[0], ema_tau_s=10.0)
        handles = [ex.register("q", f"t{i}") for i in range(8)]
        assert ex.open_tasks() == 8
        assert ex.open_tasks_ema() < 1.0
        now[0] = 30.0
        assert ex.open_tasks_ema() > 7.0
        for h in handles:
            h.close()
        now[0] = 60.0
        assert ex.open_tasks_ema() < 1.0
        ex0 = cls(1, clock=lambda: now[0], ema_tau_s=0)
        ex0.register("q", "t")
        assert ex0.open_tasks_ema() == 1.0


def test_shed_reason_uses_ema_with_factor_floor():
    from trino_tpu.server.task_worker import TaskWorkerServer as TpuWorker
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    reasons = []
    for w in (TaskWorkerServer(task_runners=1, busy_shed_factor=2,
                               busy_shed_ema_s=120.0, device="cpu"),
              TpuWorker(task_runners=1, busy_shed_factor=2,
                        busy_shed_ema_s=120.0)):
        w.start()
        try:
            hs = [w.task_executor.register("q", f"t{i}")
                  for i in range(3)]
            assert w._shed_reason() is None
            hs.append(w.task_executor.register("q", "t3"))
            reason = w._shed_reason()
            assert reason is not None and "hard ceiling" in reason
            reasons.append(reason)
            for h in hs:
                h.close()
        finally:
            w.stop()
    assert reasons[0] == reasons[1]


def test_quantum_level_and_queue_depth_metrics():
    from trino_tpu_torch.exec.taskexec import TaskExecutor
    from trino_tpu_torch.obs.metrics import (TASK_QUANTUM_SECONDS,
                                             TASK_SCHED_LEVEL_SECONDS,
                                             TASK_SCHED_QUEUE_DEPTH)
    q0 = TASK_QUANTUM_SECONDS.count()
    l0 = TASK_SCHED_LEVEL_SECONDS.value(level="0")
    ex = TaskExecutor(1)
    h = ex.register("qm", "t0")
    h.acquire()
    h.checkpoint()
    h2 = ex.register("qm", "t1")
    waiter = threading.Thread(target=h2.acquire)
    waiter.start()
    deadline = time.time() + 5
    while ex.queue_depth() < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert TASK_SCHED_QUEUE_DEPTH.value() >= 1
    h.close()
    waiter.join(5)
    h2.close()
    assert TASK_QUANTUM_SECONDS.count() > q0
    assert TASK_SCHED_LEVEL_SECONDS.value(level="0") >= l0
    # the same families, names and labels as the JAX package's
    from trino_tpu.obs import metrics as tpu_metrics
    for ours, theirs in ((TASK_QUANTUM_SECONDS,
                          tpu_metrics.TASK_QUANTUM_SECONDS),
                         (TASK_SCHED_LEVEL_SECONDS,
                          tpu_metrics.TASK_SCHED_LEVEL_SECONDS),
                         (TASK_SCHED_QUEUE_DEPTH,
                          tpu_metrics.TASK_SCHED_QUEUE_DEPTH)):
        assert (ours.name, ours.labelnames) == \
            (theirs.name, theirs.labelnames)


def test_exchange_wait_histogram_observes_blocked_scope():
    from trino_tpu_torch.exec.taskexec import TaskExecutor
    from trino_tpu_torch.obs.metrics import EXCHANGE_WAIT_SECONDS
    c0 = EXCHANGE_WAIT_SECONDS.count()
    ex = TaskExecutor(1)
    h = ex.register("qw", "t0")
    h.acquire()
    with h.blocked():
        time.sleep(0.005)
    h.close()
    assert EXCHANGE_WAIT_SECONDS.count() == c0 + 1


def test_scheduler_cpu_accounting_per_query():
    from trino_tpu.exec.taskexec import TaskExecutor as TpuExecutor
    from trino_tpu_torch.exec.taskexec import TaskExecutor
    for cls in (TaskExecutor, TpuExecutor):
        ex = cls(2)
        h = ex.register("qcpu", "t0")
        h.acquire()
        x = 0
        for _ in range(200_000):
            x += 1
        h.checkpoint()
        assert ex.query_cpu_seconds("qcpu") > 0
        h.close()
        assert h.cpu_s > 0
