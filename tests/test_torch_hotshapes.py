"""The port's hot-shape registry and worker pre-warm (exec/hotshapes.py,
exec/aot.py) against the JAX package's, on the CPU: the registry's
ranking, eviction, merge and delta export run the same scripts in both
packages; the same queries record the same kinds and canonical keys;
/v1/hotshapes serves the same JSON; and a port worker warms from a port
coordinator and announces ``prewarmed``.

Fields that differ by design are named where they are compared: the
JAX package's join keys are its jit-cache keys (``mjoin`` program keys)
and the port's are its own (exec/hotshapes.py ``join_key``), and a
chain payload's ``num_rows`` spells the row-count lane's dtype, which
differs where the two engines carry the count differently.
"""

import json
import time
import urllib.request

from trino_tpu.benchmarks.tpch_queries import TPCH_QUERIES
from trino_tpu.exec import hotshapes as tpu_hotshapes
from trino_tpu.runner import LocalQueryRunner as TpuRunner

from trino_tpu_torch.exec import aot, hotshapes
from trino_tpu_torch.obs.metrics import METRICS
from trino_tpu_torch.runner import LocalQueryRunner


def _both(script):
    """Run ``script(registry_class)`` on both packages' registries."""
    return (script(hotshapes.HotShapeRegistry),
            script(tpu_hotshapes.HotShapeRegistry))


def _ranked(reg, k=10):
    return [(e["kind"], e["key"], e["hits"]) for e in reg.top(k)]


def test_registry_ranking_and_lru_bound():
    def script(cls):
        reg = cls(capacity=3)
        out = []
        for key, hits in (("a", 1), ("b", 5), ("c", 2)):
            for _ in range(hits):
                out.append(reg.record("chain", key, lambda: {"k": key}))
        out.append(_ranked(reg, 2))
        reg.record("chain", "a", lambda: {"k": "a"})   # recency ties
        out.append(_ranked(reg, 3))
        reg.record("chain", "d", lambda: {"k": "d"})   # evicts the coldest
        out.append((len(reg), _ranked(reg)))
        return out
    port, tpu = _both(script)
    assert port == tpu
    assert [k for _, k, _ in port[-1][1]] == ["b", "a", "d"]


def test_registry_unsupported_payload_not_tracked():
    def script(cls):
        reg = cls(capacity=4)
        return reg.record("chain", "nope", lambda: None), len(reg)
    assert _both(script) == ((None, 0), (None, 0))


def test_registry_merge_and_export_delta():
    def script(cls):
        reg = cls(capacity=4)
        reg.record("chain", "k1", lambda: {"x": 1})
        n = reg.merge([
            {"kind": "chain", "key": "k1", "hits": 3, "payload": {"x": 1}},
            {"kind": "stream", "key": "k2", "hits": 1,
             "payload": {"y": 2}},
            {"bogus": True}])                   # skipped, no raise
        base = reg.hit_counts()
        reg.record("chain", "k1", lambda: {"x": 1})
        reg.record("window", "k3", lambda: {"z": 3})
        delta = reg.export_delta(base)
        coord = cls(capacity=4)
        coord.merge(delta)
        coord.merge(reg.export_delta(reg.hit_counts()))   # nothing new
        own = coord.merge(coord.export_delta({}))   # self-originated
        return (n, _ranked(reg), sorted((e["key"], e["hits"])
                                        for e in delta),
                _ranked(coord), own)
    port, tpu = _both(script)
    assert port == tpu
    assert port[0] == 2 and port[4] == 0


def test_record_program_gate_and_budget():
    """prewarm_enabled gates recording; hot_shape_top_k caps a query's
    new entries (hits still count)."""
    from trino_tpu.session import Session as TpuSession
    from trino_tpu_torch.session import Session

    def script(mod, session):
        reg = mod.HotShapeRegistry(capacity=16)
        saved = mod.HOT_SHAPES
        mod.HOT_SHAPES = reg
        try:
            session.query_id = "q1"
            session.set("prewarm_enabled", False)
            mod.record_program("chain", "off", None, None, session,
                               payload_fn=lambda: {"k": 0})
            session.set("prewarm_enabled", True)
            session.set("hot_shape_top_k", 2)
            for i in range(4):
                mod.record_program("chain", f"s{i}", None, None, session,
                                   payload_fn=lambda: {"k": 1})
            mod.record_program("chain", "s0", None, None, session,
                               payload_fn=lambda: {"k": 1})
            session.query_id = "q2"      # a new query: a fresh budget
            mod.record_program("chain", "t0", None, None, session,
                               payload_fn=lambda: {"k": 2})
            return _ranked(reg)
        finally:
            mod.HOT_SHAPES = saved
    port = script(hotshapes, Session())
    tpu = script(tpu_hotshapes, TpuSession())
    assert port == tpu
    assert sorted(k for _, k, _ in port) == ["'s0'", "'s1'", "'t0'"]


def test_same_queries_record_the_same_kinds_and_keys(monkeypatch):
    """q6 and q3 at tiny record the same kinds in both packages (the JAX
    package records only with its fragment programs on); chain keys and
    payloads are equal, but the named fields."""
    monkeypatch.setenv("TRINO_TPU_FRAGMENT_JIT", "1")
    monkeypatch.setattr(hotshapes, "HOT_SHAPES",
                        hotshapes.HotShapeRegistry(capacity=64))
    monkeypatch.setattr(tpu_hotshapes, "HOT_SHAPES",
                        tpu_hotshapes.HotShapeRegistry(capacity=64))
    port, tpu = LocalQueryRunner(device="cpu"), TpuRunner()
    for q in (6, 3):
        port.execute(TPCH_QUERIES[q])
        tpu.execute(TPCH_QUERIES[q])
    pe, te = hotshapes.HOT_SHAPES.top(64), tpu_hotshapes.HOT_SHAPES.top(64)
    assert sorted(e["kind"] for e in pe) == sorted(e["kind"] for e in te)
    pchains = {e["key"]: e["payload"] for e in pe if e["kind"] == "chain"}
    tchains = {e["key"]: e["payload"] for e in te if e["kind"] == "chain"}
    assert pchains.keys() == tchains.keys() and pchains
    for key, p in pchains.items():
        t = tchains[key]
        assert {k: v for k, v in p.items() if k != "num_rows"} == \
            {k: v for k, v in t.items() if k != "num_rows"}
    # the join entries: the JAX key is its jit-cache key; the payloads'
    # fragments and lane specs agree
    pj = sorted((e["payload"] for e in pe if e["kind"] == "join"),
                key=lambda p: json.dumps(p["fragment"], sort_keys=True))
    tj = sorted((e["payload"] for e in te if e["kind"] == "join"),
                key=lambda p: json.dumps(p["fragment"], sort_keys=True))
    assert [p["fragment"] for p in pj] == [p["fragment"] for p in tj]
    # lane specs per column (the column order of a side's batch may
    # differ between the engines) and the capacities agree
    def spec(p):
        return ([sorted(p[s], key=lambda c: c["name"])
                 for s in ("probe_cols", "build_cols")],
                [p[k] for k in ("chunk_capacity", "build_capacity",
                                "out_capacity")])
    assert [spec(p) for p in pj] == [spec(p) for p in tj]


def _get(uri):
    with urllib.request.urlopen(uri, timeout=10) as r:
        return json.loads(r.read())


def test_hotshapes_endpoint_json_equals_the_jax_coordinators(monkeypatch):
    from trino_tpu.server.coordinator import Coordinator as TpuCoordinator
    from trino_tpu_torch.server.coordinator import Coordinator
    entries = [{"kind": "chain", "key": f"k{i}", "hits": i + 1,
                "payload": {"kind": "chain", "i": i}} for i in range(5)]
    for mod in (hotshapes, tpu_hotshapes):
        reg = mod.HotShapeRegistry(capacity=16)
        reg.merge(entries)
        monkeypatch.setattr(mod, "HOT_SHAPES", reg)
    co, tco = Coordinator(device="cpu").start(), TpuCoordinator().start()
    try:
        got = _get(co.base_uri + "/v1/hotshapes?k=3")
        want = _get(tco.base_uri + "/v1/hotshapes?k=3")
        assert got == want
        assert [e["key"] for e in got["shapes"]] == ["k4", "k3", "k2"]
        assert got["tracked"] == 5
        assert len(_get(co.base_uri + "/v1/hotshapes")["shapes"]) == \
            len(_get(tco.base_uri + "/v1/hotshapes")["shapes"])
    finally:
        co.stop()
        tco.stop()


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _aot_count(kind, result):
    return sum(v for labels, v in METRICS.counter(
        "trino_tpu_aot_compiles_total").samples()
        if tuple(labels) == (kind, result))


def test_prewarm_handshake_between_port_coordinator_and_worker(
        monkeypatch):
    """Queries through a worker fill the coordinator's registry (task
    status hotShapes); a fresh worker that announces with prewarm pulls
    /v1/hotshapes, warms every entry on its device and is then seen
    ``prewarmed`` in /v1/announcement; the warm-up counts by kind and
    result."""
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.server.coordinator import Coordinator
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    monkeypatch.setattr(hotshapes, "HOT_SHAPES",
                        hotshapes.HotShapeRegistry(capacity=64))
    monkeypatch.setattr(aot, "_WARMED", set())
    first = TaskWorkerServer(device="cpu").start()
    co = Coordinator(device="cpu", worker_uris=[first.base_uri]).start()
    fresh = cold = None
    try:
        client = StatementClient(co.base_uri, catalog="tpch",
                                 schema="tiny")
        for q in (1, 6):
            client.execute(TPCH_QUERIES[q])
        shapes = _get(co.base_uri + "/v1/hotshapes?k=16")["shapes"]
        assert shapes
        kinds = {e["kind"] for e in shapes}
        before = {k: _aot_count(k, "compiled") for k in kinds}
        errors = {k: _aot_count(k, "error") for k in kinds}
        fresh = TaskWorkerServer(device="cpu").start()
        cold = TaskWorkerServer(device="cpu").start()
        cold.announce(co.base_uri, prewarm=False)
        fresh.announce(co.base_uri, prewarm=True, prewarm_top_k=16)

        def seen():
            ann = _get(co.base_uri + "/v1/announcement")["workers"]
            return any(w["uri"] == fresh.base_uri and w["prewarmed"]
                       for w in ann)
        assert _wait(seen)
        ann = {w["uri"]: w for w in
               _get(co.base_uri + "/v1/announcement")["workers"]}
        assert ann[cold.base_uri]["prewarmed"] is False
        summary = fresh.prewarm_summary
        assert summary["pulled"] == len(shapes)
        assert summary["errors"] == 0
        assert summary["compiled"] + summary["cached"] == len(shapes)
        for k in kinds:
            assert _aot_count(k, "error") == errors[k]
        assert sum(_aot_count(k, "compiled") - before[k]
                   for k in kinds) == summary["compiled"] > 0
        # a second warm-up of the same shapes in this process: cached
        again = aot.compile_entries(shapes, "cpu")
        assert again["cached"] == len(shapes) and again["compiled"] == 0
    finally:
        for w in (fresh, cold):
            if w is not None:
                w.stop()
        co.stop()
        first.stop()


def test_warm_up_of_each_kind_runs_its_path(monkeypatch):
    """Every kind the port records warms without error from its payload
    alone, on a fresh registry: chain, window and join shapes from tiny
    queries, the streaming aggregation's chunk and whole-table programs,
    a streamed join's probe chunk, and the repartition signature."""
    from trino_tpu_torch.exec import scancache
    from trino_tpu_torch.exec.executor import Executor
    reg = hotshapes.HotShapeRegistry(capacity=64)
    saved = hotshapes.HOT_SHAPES
    hotshapes.HOT_SHAPES = reg
    try:
        r = LocalQueryRunner(device="cpu")
        r.execute(TPCH_QUERIES[3])
        r.execute("SELECT o_custkey, rank() OVER (PARTITION BY o_custkey "
                  "ORDER BY o_totalprice) FROM orders")
        s = r.session
        s.set("stream_chunk_rows", 4096)
        r.execute(TPCH_QUERIES[1])      # chunk by chunk: "stream"
        r.execute(TPCH_QUERIES[12])     # a streamed probe: "streamjoin"
        s.set("stream_chunk_rows", -1)
        monkeypatch.setattr(scancache, "_whole_table_mode", lambda dev: True)
        r.execute(TPCH_QUERIES[6])      # the whole table: "stream_full"
        from trino_tpu_torch.stage.repartition import partition_buckets
        b = Executor(r.catalogs, s, r.device).execute(
            r.plan_sql("SELECT n_nationkey FROM nation"))
        partition_buckets(b, list(b.columns), 4, session=s)
    finally:
        hotshapes.HOT_SHAPES = saved
    entries = reg.top(64)
    kinds = {e["kind"] for e in entries}
    assert {"chain", "window", "join", "stream", "stream_full",
            "streamjoin", "repartition"} <= kinds
    saved_warm = set(aot._WARMED)
    aot._WARMED.clear()
    try:
        out = aot.compile_entries(entries, "cpu")
    finally:
        aot._WARMED.clear()
        aot._WARMED.update(saved_warm)
    assert out["errors"] == 0 and out["compiled"] == len(entries)
