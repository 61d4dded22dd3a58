"""The port's query history, learned operator statistics and result
cache against the JAX package's.

Counterparts of tests/test_query_history.py (all but
``test_mpp_query_lands_in_system_runtime_tables``, which needs workers)
and tests/test_result_cache.py (all but
``test_repeat_query_hits_with_zero_dispatched_tasks``, likewise; ROADMAP
11b). Registry and store cases drive the port's class and the JAX one
through the same calls and compare what they hold; coordinator cases run
the port's coordinator (``device="cpu"``) and compare its records with
the JAX coordinator's where the two run the same statements.
"""

import json
import threading
import time
import urllib.request

import pytest

from trino_tpu.exec import learnedstats as tpu_ls
from trino_tpu.obs import history as tpu_history
from trino_tpu.server.coordinator import Coordinator as TpuCoordinator
from trino_tpu_torch.client import ClientError, StatementClient
from trino_tpu_torch.exec.learnedstats import (LEARNED_STATS,
                                               LearnedStatsRegistry,
                                               record_node_stats)
from trino_tpu_torch.exec.resultcache import (RESULT_CACHE,
                                              RESULT_CACHE_EVICTIONS,
                                              RESULT_CACHE_LOOKUPS,
                                              ResultCache)
from trino_tpu_torch.obs.history import (QueryHistoryStore, TraceRing,
                                         record_from_query, sql_digest)
from trino_tpu_torch.runner import LocalQueryRunner, QueryResult
from trino_tpu_torch.server.coordinator import Coordinator, QueryTracker
from trino_tpu_torch.session import Session


def _wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _get_json(uri):
    with urllib.request.urlopen(uri, timeout=10) as resp:
        return json.load(resp)


def _entry(reg, *key):
    """A registry entry without its time stamp (the two registries run
    at different instants)."""
    ent = reg.lookup(*key)
    return None if ent is None else {k: v for k, v in ent.items()
                                     if k not in ("updated", "origin")}


# --- learned-stats registry (exec/learnedstats.py) -------------------------

def test_learned_stats_ema_selectivity_and_rate():
    def drive(cls):
        reg = cls(capacity=8, alpha=0.5)
        out = []
        reg.observe("k1", "Filter", 0, rows_in=100, rows_out=50,
                    wall_s=0.5)
        out.append(_entry(reg, "k1", "Filter", 0))
        reg.observe("k1", "Filter", 0, rows_in=100, rows_out=100,
                    wall_s=0.5)
        out.append(_entry(reg, "k1", "Filter", 0))
        # unknown rows (-1) must not poison the EMAs
        reg.observe("k1", "Filter", 0, rows_in=-1, rows_out=-1,
                    wall_s=0.1)
        out.append(_entry(reg, "k1", "Filter", 0))
        # the occurrence index separates repeated operator names
        reg.observe("k1", "Filter", 1, rows_in=10, rows_out=1, wall_s=0.1)
        out.append(_entry(reg, "k1", "Filter", 1))
        return out

    got = drive(LearnedStatsRegistry)
    assert got[0]["selectivity"] == pytest.approx(0.5)
    assert got[0]["rows_per_s"] == pytest.approx(100.0)
    assert got[1]["selectivity"] == pytest.approx(0.75)
    assert got[1]["n"] == 2 and got[1]["rows_in"] == 200
    assert got[2]["selectivity"] == pytest.approx(0.75)
    assert got[3]["selectivity"] == pytest.approx(0.1)
    assert got == drive(tpu_ls.LearnedStatsRegistry)


def test_learned_stats_lru_capacity():
    def drive(cls):
        reg = cls(capacity=2, alpha=0.5)
        for i in range(4):
            reg.observe(f"k{i}", "Scan", 0, 10, 10, 0.1)
        return len(reg), [reg.lookup(f"k{i}", "Scan", 0) is not None
                          for i in range(4)]

    got = drive(LearnedStatsRegistry)
    assert got == (2, [False, False, True, True])
    assert got == drive(tpu_ls.LearnedStatsRegistry)


def test_learned_stats_merge_dedups_self_origin():
    """A registry never re-absorbs its own exported observations,
    merges foreign ones, and a relay keeps the original origin."""
    def drive(cls):
        a, b = cls(capacity=8), cls(capacity=8)
        before = a.seq()
        a.observe("k", "Join", 0, 100, 20, 0.2)
        delta = a.export_delta(before)
        assert len(delta) == 1 and delta[0]["origin"] == a.origin
        out = [a.merge(delta), a.lookup("k", "Join", 0)["n"]]
        b_before = b.seq()
        out += [b.merge(delta), b.lookup("k", "Join", 0)["selectivity"]]
        relayed = b.export_delta(b_before)
        assert relayed[0]["origin"] == a.origin
        out += [a.merge(relayed), a.lookup("k", "Join", 0)["n"]]
        return out

    got = drive(LearnedStatsRegistry)
    assert got == [0, 1, 1, pytest.approx(0.2), 0, 1]
    assert got == drive(tpu_ls.LearnedStatsRegistry)


def test_learned_stats_save_load_roundtrip(tmp_path):
    reg = LearnedStatsRegistry(capacity=8)
    reg.observe("k", "Scan", 0, 1000, 500, 1.0)
    path = str(tmp_path / "learned_stats.json")
    assert reg.save(path)
    fresh = LearnedStatsRegistry(capacity=8)
    assert fresh.load(path) == 1
    ent = fresh.lookup("k", "Scan", 0)
    assert ent["selectivity"] == pytest.approx(0.5)
    assert ent["rows_per_s"] == pytest.approx(500.0)
    # live entries win over persisted ones on load
    fresh.observe("k2", "Scan", 0, 10, 1, 0.1)
    assert fresh.load(path) == 0
    assert len(fresh) == 2
    # the file is the JAX registry's format: each loads the other's
    ref = tpu_ls.LearnedStatsRegistry(capacity=8)
    assert ref.load(path) == 1
    assert _entry(ref, "k", "Scan", 0) == _entry(reg, "k", "Scan", 0)


def test_record_node_stats_respects_session_gate():
    reg_len = len(LEARNED_STATS)
    s = Session()
    s.set("learned_stats_enabled", False)
    stats = [{"name": "Output", "input_rows": 5, "output_rows": 5,
              "wall_s": 0.01}]
    assert record_node_stats("gatedkey", stats, s) == 0
    assert len(LEARNED_STATS) == reg_len
    s.set("learned_stats_enabled", True)
    assert record_node_stats("gatedkey", stats, s) == 1
    assert LEARNED_STATS.lookup("gatedkey", "Output", 0) is not None


def test_plan_key_stable_and_distinct():
    """Every executed plan gets a non-empty deterministic key; the same
    SQL keys alike, different programs differ."""
    r = LocalQueryRunner(collect_node_stats=True, device="cpu")
    k1 = r.execute("SELECT count(*) FROM tpch.tiny.nation").plan_key
    k2 = r.execute("SELECT count(*) FROM tpch.tiny.nation").plan_key
    k3 = r.execute("SELECT count(*) FROM tpch.tiny.region").plan_key
    assert k1 and k1 == k2
    assert k3 and k3 != k1


# --- history store (obs/history.py) ----------------------------------------

def _fake_record(i, state="FINISHED", created=None):
    return {"query_id": f"q{i}", "state": state, "sql": f"SELECT {i}",
            "sql_digest": sql_digest(f"SELECT {i}"), "wall_s": 0.1,
            "created": created if created is not None else time.time()}


def test_history_store_bounded_and_jsonl_durable(tmp_path):
    path = str(tmp_path / "queries.jsonl")
    store = QueryHistoryStore(path, capacity=4, ttl_s=3600)
    for i in range(10):
        store.record(_fake_record(i))
    assert len(store) == 4
    recs = store.records()
    assert [r["query_id"] for r in recs] == ["q9", "q8", "q7", "q6"]
    assert store.get("q9") is not None and store.get("q0") is None
    store.record(_fake_record(99, state="FAILED"))
    assert [r["query_id"] for r in store.records(state="FAILED")] \
        == ["q99"]
    assert len(store.records(limit=2)) == 2
    # a new store over the same file reloads the survivors, and so does
    # the JAX store: the file format is shared
    again = QueryHistoryStore(path, capacity=4, ttl_s=3600)
    assert {r["query_id"] for r in again.records()} \
        == {"q99", "q9", "q8", "q7"}
    ref = tpu_history.QueryHistoryStore(path, capacity=4, ttl_s=3600)
    assert ref.records() == again.records()
    assert sql_digest("SELECT 1") == tpu_history.sql_digest("SELECT 1")


def test_history_store_ttl_prunes(tmp_path):
    store = QueryHistoryStore(str(tmp_path / "q.jsonl"), capacity=8,
                              ttl_s=60)
    old = _fake_record(0, created=time.time() - 3600)
    old["recorded_at"] = time.time() - 3600
    store._records.append(old)        # pre-aged entry
    store.record(_fake_record(1))
    assert [r["query_id"] for r in store.records()] == ["q1"]
    # the reload path drops expired lines too
    store2 = QueryHistoryStore(str(tmp_path / "q2.jsonl"), capacity=8,
                               ttl_s=60)
    store2.record(dict(_fake_record(2),
                       recorded_at=time.time() - 3600))
    assert QueryHistoryStore(store2.path, capacity=8,
                             ttl_s=60).records() == []


def test_slow_query_log_side_channel(tmp_path):
    store = QueryHistoryStore(str(tmp_path / "queries.jsonl"))
    rec = store.record(_fake_record(1))
    store.slow_log(rec, 50)
    lines = (tmp_path / "slow_queries.jsonl").read_text().splitlines()
    entry = json.loads(lines[-1])
    assert entry["query_id"] == "q1"
    assert entry["slow_query_threshold_ms"] == 50


def test_trace_ring_bounded_and_traceless_noop():
    class _Span:
        def __init__(self, name):
            self.name, self.wall_s, self.children = name, 0.5, []

    class _Trace:
        def __init__(self, tid):
            self.trace_id = tid
            self.roots = [_Span("query")]

    def drive(cls):
        ring = cls(capacity=2)
        ring.append("q0", "FINISHED", None)         # traceless: no entry
        assert len(ring) == 0
        for i in range(3):
            ring.append(f"q{i}", "FINISHED", _Trace(f"t{i}"))
        return [{k: v for k, v in e.items() if k != "recordedAt"}
                for e in ring.list()]

    out = drive(TraceRing)
    assert [e["traceId"] for e in out] == ["t2", "t1"]
    assert out[0]["rootSpans"][0]["name"] == "query"
    assert out == drive(tpu_history.TraceRing)


# --- terminal records through the coordinator ------------------------------

_KEYS_THAT_DIFFER = {"query_id", "created", "queued_s", "wall_s", "cpu_s",
                     "device_s", "trace_id", "recorded_at", "operators",
                     "peak_memory_bytes"}


def test_coordinator_records_history_and_serves_endpoints(tmp_path):
    recs = []
    for make in (lambda: Coordinator(device="cpu",
                                     history_dir=str(tmp_path / "t")),
                 lambda: TpuCoordinator(history_dir=str(tmp_path / "j"))):
        co = make().start()
        try:
            c = StatementClient(co.base_uri, session_properties={
                "slow_query_log_ms": "1"})
            res = c.execute("SELECT count(*) FROM tpch.tiny.nation")
            _wait_until(lambda: co.history.get(res.query_id) is not None,
                        what="history record")
            out = _get_json(f"{co.base_uri}/v1/history")
            rec = next(r for r in out["records"]
                       if r["query_id"] == res.query_id)
            recs.append(rec)
            assert rec["state"] == "FINISHED"
            assert rec["plan_key"] and rec["sql_digest"]
            assert rec["wall_s"] > 0 and rec["cpu_s"] > 0
            assert rec["rows"] == 1
            assert rec["operators"], "per-operator rows-in/out missing"
            assert _get_json(f"{co.base_uri}/v1/history?state=FAILED"
                             )["records"] == []
            assert len(_get_json(f"{co.base_uri}/v1/history?limit=1"
                                 )["records"]) == 1
            stats = _get_json(f"{co.base_uri}/v1/stats")
            mine = [e for e in stats["entries"]
                    if e["key"] == rec["plan_key"]]
            assert mine and any(e["selectivity"] is not None
                                for e in mine)
            traces = _get_json(f"{co.base_uri}/v1/trace")["traces"]
            assert any(t["queryId"] == res.query_id for t in traces)
            slow = (tmp_path / ("t" if isinstance(co, Coordinator)
                                else "j") / "slow_queries.jsonl")
            assert res.query_id in slow.read_text()
        finally:
            co.stop()
    got, want = ({k: v for k, v in r.items() if k not in _KEYS_THAT_DIFFER}
                 for r in recs)
    assert got == want
    assert [(o["name"], o["rows_in"], o["rows_out"])
            for o in recs[0]["operators"]] == \
        [(o["name"], o["rows_in"], o["rows_out"])
         for o in recs[1]["operators"]]


def test_history_disabled_by_session_property(tmp_path):
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    try:
        c = StatementClient(co.base_uri, session_properties={
            "query_history_enabled": "false"})
        res = c.execute("SELECT 1")
        q = co.tracker.get(res.query_id)
        assert q.wait_done(5.0)
        time.sleep(0.3)
        assert co.history.get(res.query_id) is None
    finally:
        co.stop()


# --- failure-path records ----------------------------------------------------

def test_oom_kill_lands_classified_record(tmp_path):
    """A CLUSTER_OUT_OF_MEMORY victim leaves one FAILED record with the
    kill's error identity and non-zero timing."""
    from trino_tpu_torch.exec.executor import QueryError
    from trino_tpu_torch.server.memory import (ClusterMemoryManager,
                                               ClusterMemoryPool)
    store = QueryHistoryStore(str(tmp_path / "queries.jsonl"))
    gates = {"big": threading.Event(), "small": threading.Event()}

    class _Gated:
        def __init__(self, session):
            self.session = session

        def execute(self, sql):
            if self.session.memory is not None:
                self.session.memory.reserve(
                    700 if sql == "big" else 400)
            gate = gates[sql]
            while not gate.is_set():
                if self.session.cancel is not None \
                        and self.session.cancel.is_set():
                    raise QueryError("Query was canceled")
                gate.wait(0.01)
            return QueryResult(["x"], [], [[1]])

    tracker = QueryTracker(
        _Gated, memory=ClusterMemoryManager(ClusterMemoryPool(1000)),
        history_sink=lambda q: store.record(record_from_query(q)))
    qbig = tracker.submit("big", Session())
    _wait_until(lambda: qbig.state == "RUNNING", what="big running")
    time.sleep(0.05)
    qsmall = tracker.submit("small", Session())   # 700+400 > 1000
    gates["small"].set()
    _wait_until(lambda: store.get(qbig.query_id) is not None,
                what="OOM record")
    rec = store.get(qbig.query_id)
    assert rec["state"] == "FAILED"
    assert rec["error_name"] == "CLUSTER_OUT_OF_MEMORY"
    assert rec["error_type"] == "INSUFFICIENT_RESOURCES"
    assert rec["wall_s"] > 0
    _wait_until(lambda: store.get(qsmall.query_id) is not None,
                what="survivor record")
    assert store.get(qsmall.query_id)["state"] == "FINISHED"
    assert len(store) == 2


def test_deadline_breach_lands_classified_record(tmp_path):
    """EXCEEDED_TIME_LIMIT through the coordinator: the record carries
    the deadline's error identity and a wall of at least the budget."""
    from trino_tpu_torch.catalog import CatalogManager
    from trino_tpu_torch.connectors.tpch import TpchConnector

    class SlowTpch(TpchConnector):
        def read_split(self, split, columns):
            time.sleep(5)
            return super().read_split(split, columns)

    cats = CatalogManager()
    cats.register("tpch", SlowTpch(device="cpu"))
    co = Coordinator(catalogs=cats, history_dir=str(tmp_path),
                     device="cpu").start()
    try:
        c = StatementClient(co.base_uri, session_properties={
            "query_max_run_time": "1"})
        with pytest.raises(ClientError, match="EXCEEDED_TIME_LIMIT"):
            c.execute("SELECT count(*) FROM nation")
        _wait_until(lambda: any(
            r["error_name"] == "EXCEEDED_TIME_LIMIT"
            for r in co.history.records()), what="deadline record")
        rec = next(r for r in co.history.records()
                   if r["error_name"] == "EXCEEDED_TIME_LIMIT")
        assert rec["state"] == "FAILED"
        assert rec["error_type"] == "INSUFFICIENT_RESOURCES"
        assert rec["wall_s"] >= 0.9
    finally:
        co.stop()


def test_queue_full_rejection_lands_classified_record(tmp_path):
    """A QUEUE_FULL admission rejection is history too (the second
    recording site)."""
    from trino_tpu_torch.server.resourcegroups import (ResourceGroup,
                                                       ResourceGroupManager)
    mgr = ResourceGroupManager()
    g = mgr.root.add(ResourceGroup("tiny", hard_concurrency=1,
                                   max_queued=0))
    mgr.add_selector(g)
    co = Coordinator(resource_groups=mgr, history_dir=str(tmp_path),
                     device="cpu").start()
    gate = threading.Event()

    class Gated:
        """The occupant holds its slot until the test lets it go."""

        def __init__(self, inner):
            self.inner = inner

        def execute(self, sql):
            gate.wait(30)
            return self.inner.execute(sql)
    make = co.tracker._make_runner
    co.tracker._make_runner = lambda session: Gated(make(session))
    try:
        errors = []

        def occupy():
            try:
                StatementClient(co.base_uri).execute(
                    "SELECT count(*) FROM tpch.tiny.lineitem")
            except Exception as e:      # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=occupy, daemon=True)
        t.start()
        _wait_until(lambda: any(q.state == "RUNNING"
                                for q in co.tracker.all()),
                    what="occupant running")
        with pytest.raises(ClientError, match="QUERY_QUEUE_FULL"):
            StatementClient(co.base_uri).execute("SELECT 1")
        _wait_until(lambda: any(
            r["error_name"] == "QUERY_QUEUE_FULL"
            for r in co.history.records()), what="rejection record")
        rec = next(r for r in co.history.records()
                   if r["error_name"] == "QUERY_QUEUE_FULL")
        assert rec["state"] == "FAILED"
        assert rec["error_type"] == "INSUFFICIENT_RESOURCES"
        assert rec["wall_s"] > 0          # rejected, but time passed
        gate.set()
        t.join(60)
        assert not errors
    finally:
        gate.set()
        co.stop()


def test_history_and_learned_stats_survive_restart(tmp_path):
    LEARNED_STATS.clear()
    co1 = Coordinator(history_dir=str(tmp_path), device="cpu").start()
    try:
        res = StatementClient(co1.base_uri).execute(
            "SELECT count(*) FROM tpch.tiny.nation")
        _wait_until(lambda: co1.history.get(res.query_id) is not None,
                    what="history record")
        assert len(LEARNED_STATS) > 0
    finally:
        co1.stop()                 # final learned-stats checkpoint
    LEARNED_STATS.clear()          # a fresh process
    co2 = Coordinator(history_dir=str(tmp_path), device="cpu").start()
    try:
        out = _get_json(f"{co2.base_uri}/v1/history")
        rec = next(r for r in out["records"]
                   if r["query_id"] == res.query_id)
        assert rec["state"] == "FINISHED" and rec["plan_key"]
        stats = _get_json(f"{co2.base_uri}/v1/stats")
        assert stats["tracked"] > 0
        assert any(e["key"] == rec["plan_key"]
                   for e in stats["entries"])
    finally:
        co2.stop()


# ---- counterparts of tests/test_result_cache.py -------------------------------

PROPS = {"result_cache_enabled": "true"}


def test_connector_version_bump_invalidates(tmp_path):
    """An INSERT bumps the memory connector's data version: the cached
    entry is dropped at the next lookup (reason=invalidated) and the
    query runs again over the new rows."""
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    try:
        c = StatementClient(co.base_uri, session_properties=PROPS)
        c.execute("CREATE TABLE memory.default.rc_inv (x bigint)")
        c.execute("INSERT INTO memory.default.rc_inv VALUES (1), (2)")
        sql = "SELECT x FROM memory.default.rc_inv WHERE x = 1"
        assert c.execute(sql).rows == [[1]]     # miss + store
        h0 = RESULT_CACHE_LOOKUPS.value(result="hit")
        assert c.execute(sql).rows == [[1]]     # hit
        assert RESULT_CACHE_LOOKUPS.value(result="hit") == h0 + 1
        i0 = RESULT_CACHE_EVICTIONS.value(reason="invalidated")
        c.execute("INSERT INTO memory.default.rc_inv VALUES (1)")
        assert c.execute(sql).rows == [[1], [1]]    # fresh, not stale
        assert RESULT_CACHE_EVICTIONS.value(
            reason="invalidated") == i0 + 1
    finally:
        co.stop()


def test_cache_hit_launches_nothing_and_equals_the_jax_answer(tmp_path):
    """A hit returns before the runner plans: the executor is never
    built (the port's stand-in for the JAX test's zero dispatched
    tasks), and the rows equal the JAX coordinator's."""
    from trino_tpu.client import StatementClient as TpuClient
    from trino_tpu_torch.exec import executor as ex
    sql = "SELECT r_name FROM tpch.tiny.region WHERE r_regionkey = 1"
    co = Coordinator(device="cpu", history_dir=str(tmp_path / "t")).start()
    built = []
    real_init = ex.Executor.__init__

    def counting_init(self, *a, **k):
        built.append(1)
        real_init(self, *a, **k)
    try:
        c = StatementClient(co.base_uri, session_properties=PROPS)
        first = c.execute(sql).rows
        ex.Executor.__init__ = counting_init
        second = c.execute(sql).rows
    finally:
        ex.Executor.__init__ = real_init
        co.stop()
    assert first == second == [["AMERICA"]]
    assert built == []
    jco = TpuCoordinator(history_dir=str(tmp_path / "j")).start()
    try:
        assert TpuClient(jco.base_uri, session_properties=PROPS) \
            .execute(sql).rows == first
    finally:
        jco.stop()


def test_cache_off_by_default_no_lookups(tmp_path):
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    try:
        c = StatementClient(co.base_uri)    # no session property
        sql = "SELECT r_name FROM tpch.tiny.region WHERE r_regionkey = 1"
        s0 = sum(v for _, v in RESULT_CACHE_LOOKUPS.samples())
        assert c.execute(sql).rows == c.execute(sql).rows
        assert sum(v for _, v in RESULT_CACHE_LOOKUPS.samples()) == s0
    finally:
        co.stop()


def test_pressure_ladder_sheds_result_cache_after_the_scan_cache():
    """evict_cache_pressure sheds the scan cache first, then cached
    result rows, and counts the shed under {cache="result"}; governance
    sees the result cache's bytes."""
    from trino_tpu_torch.exec import scancache
    from trino_tpu_torch.obs.metrics import CACHE_PRESSURE_EVICTS

    scancache.evict_cache_pressure(1 << 40)     # empty both tiers
    RESULT_CACHE.put(("test-pressure",), ["x"], ["bigint"],
                     [[i] for i in range(64)], (("memory", 1),))
    assert len(RESULT_CACHE) >= 1
    nbytes = RESULT_CACHE.bytes()
    assert scancache.cache_memory_bytes() >= nbytes
    r0 = CACHE_PRESSURE_EVICTS.value(cache="result")
    entries_before = len(RESULT_CACHE)
    freed = scancache.evict_cache_pressure(1)
    assert freed >= 1
    assert len(RESULT_CACHE) < entries_before
    assert CACHE_PRESSURE_EVICTS.value(cache="result") > r0


def test_lru_and_capacity_bounds():
    from trino_tpu.exec.resultcache import ResultCache as TpuCache

    def drive(cls):
        rc = cls(capacity_bytes=4096)
        v = (("memory", 1),)
        # an entry over capacity // 4 is refused outright
        refused = rc.put(("big",), ["x"], ["varchar"], [["y" * 8192]], v)
        for i in range(64):
            rc.put((f"k{i}",), ["x"], ["bigint"], [[i] * 8], v)
        return (refused, rc.bytes(), len(rc), rc.get(("k0",), v),
                rc.get(("k63",), v))

    got = drive(ResultCache)
    assert got[0] is False and got[1] <= 4096
    assert got[3] is None                     # LRU-evicted
    assert got[4] is not None and got[4][2] == [[63] * 8]
    assert got == drive(TpuCache)
