"""The port's cluster infrastructure against the JAX package's: events,
resource groups, system.runtime, kill_query, authentication, access
control, the failure detector, the web UI, cluster stats and the
graceful drain.

Counterparts of tests/test_cluster_infra.py, all but the leak-report and
thread-leak cases (``server/diagnostics.py`` comes with the worker
slice, ROADMAP 11b). A case that starts a coordinator starts the port's
(``device="cpu"``) and, where the answer is data, the JAX one too, and
holds the two answers equal.
"""

import base64
import json
import time
import urllib.error
import urllib.request

import pytest

from trino_tpu.server import events as tpu_events
from trino_tpu.server import resourcegroups as tpu_rg
from trino_tpu.server.coordinator import Coordinator as TpuCoordinator
from trino_tpu.server.failure import HeartbeatFailureDetector as TpuDetector
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.security import (AccessDeniedError, AccessRule,
                                      InMemoryPasswordAuthenticator,
                                      RuleBasedAccessControl,
                                      load_password_file)
from trino_tpu_torch.server.coordinator import Coordinator
from trino_tpu_torch.server.events import (EventListener,
                                           EventListenerManager,
                                           QueryCompletedEvent,
                                           QueryCreatedEvent)
from trino_tpu_torch.server.failure import HeartbeatFailureDetector
from trino_tpu_torch.server.resourcegroups import (QueryQueueFullError,
                                                   ResourceGroupManager)


def _get(uri, headers=None):
    req = urllib.request.Request(uri, headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as r:
        body = r.read()
    return r.status, body


def _post(uri, data, headers=None):
    req = urllib.request.Request(uri, data=data.encode(),
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _run_sql(base, sql, headers=None):
    out = _post(base + "/v1/statement", sql, headers)
    while "nextUri" in out:
        _, body = _get(out["nextUri"], headers)
        out = json.loads(body)
    return out


def _both(make_port, make_jax, fn):
    """fn(coordinator) on a started port coordinator, then on a started
    JAX one; both stopped whatever happens. Returns (port's, JAX's)."""
    out = []
    for make in (make_port, make_jax):
        co = make().start()
        try:
            out.append(fn(co))
        finally:
            co.stop()
    return tuple(out)


# --- events ---------------------------------------------------------------

def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.created = []
            self.completed = []

        def query_created(self, event):
            self.created.append(event)

        def query_completed(self, event):
            self.completed.append(event)
    return Recorder()


def test_event_listener_lifecycle(tmp_path):
    recs = (_recorder(EventListener), _recorder(tpu_events.EventListener))

    def drive(co):
        rec = recs[0] if isinstance(co, Coordinator) else recs[1]
        out = _run_sql(co.base_uri, "SELECT 1")
        assert out["stats"]["state"] == "FINISHED"
        deadline = time.time() + 5
        while not rec.completed and time.time() < deadline:
            time.sleep(0.02)
        return ([(e.sql, e.user, e.catalog, e.schema) for e in rec.created],
                [(e.sql, e.state, e.rows, e.error_name)
                 for e in rec.completed])

    got, want = _both(
        lambda: Coordinator(device="cpu", event_listeners=[recs[0]],
                            history_dir=str(tmp_path / "t")),
        lambda: TpuCoordinator(event_listeners=[recs[1]],
                               history_dir=str(tmp_path / "j")),
        drive)
    rec = recs[0]
    assert len(rec.created) == 1
    assert isinstance(rec.created[0], QueryCreatedEvent)
    done = rec.completed[0]
    assert isinstance(done, QueryCompletedEvent)
    assert done.state == "FINISHED" and done.rows == 1
    assert done.operator_summaries          # node stats ride the event
    assert got == want


def test_event_listener_error_isolated():
    class Bomb(EventListener):
        def query_created(self, event):
            raise RuntimeError("boom")
    mgr = EventListenerManager()
    mgr.add_listener(Bomb())
    mgr.query_created(QueryCreatedEvent("q", "SELECT 1", "u", None,
                                        None))   # must not raise


def test_split_completed_events_carry_the_query_id(tmp_path):
    """The port's executor fires a SplitCompletedEvent per split read,
    as the JAX executor does."""
    seen = []

    class Splits(EventListener):
        def split_completed(self, event):
            seen.append(event)
    co = Coordinator(device="cpu", event_listeners=[Splits()],
                     history_dir=str(tmp_path)).start()
    try:
        out = _run_sql(co.base_uri,
                       "SELECT count(*) FROM tpch.tiny.lineitem")
    finally:
        co.stop()
    assert out["data"] == [[59969]]
    assert seen and all(e.query_id == out["id"] for e in seen)
    assert all(e.split_id.startswith("tpch.tiny.lineitem[")
               for e in seen)


# --- resource groups ------------------------------------------------------

def test_resource_group_concurrency_and_queueing():
    def drive(mod):
        mgr = mod.ResourceGroupManager()
        g = mgr.root.add(mod.ResourceGroup("small", hard_concurrency=1,
                                           max_queued=1))
        mgr.add_selector(g, user_regex="alice")
        order = []
        grp, started = mgr.submit("alice", "",
                                  lambda group: order.append("first"))
        assert started and order == ["first"]
        grp2, started2 = mgr.submit("alice", "",
                                    lambda group: order.append("second"))
        assert not started2 and order == ["first"]     # queued
        with pytest.raises(mod.QueryQueueFullError):
            mgr.submit("alice", "", lambda group: None)    # queue full
        mgr.query_finished(grp)
        assert order == ["first", "second"]
        mgr.query_finished(grp2)
        assert g.running == 0
        return mgr.info()

    import trino_tpu_torch.server.resourcegroups as port_rg
    got, want = drive(port_rg), drive(tpu_rg)
    assert QueryQueueFullError is port_rg.QueryQueueFullError
    for row in got + want:
        row.pop("queued_seconds", None)
    assert got == want


def test_resource_group_from_config_and_selectors():
    cfg = {
        "rootGroups": [
            {"name": "adhoc", "hardConcurrencyLimit": 5},
            {"name": "etl", "hardConcurrencyLimit": 2,
             "subGroups": [{"name": "nightly"}]},
        ],
        "selectors": [
            {"user": "etl_.*", "group": "etl.nightly"},
            {"group": "adhoc"},
        ]}
    mgr = ResourceGroupManager.from_config(cfg)
    ref = tpu_rg.ResourceGroupManager.from_config(cfg)
    assert mgr.select("etl_loader").full_name == "global.etl.nightly"
    assert mgr.select("bob").full_name == "global.adhoc"
    assert mgr.info() == ref.info()


def test_resource_groups_on_coordinator(tmp_path):
    def make(mod, cls, **kw):
        def build():
            mgr = mod.ResourceGroupManager()
            g = mgr.root.add(mod.ResourceGroup("all", hard_concurrency=2))
            mgr.add_selector(g)
            return cls(resource_groups=mgr, **kw)
        return build

    def drive(co):
        out = _run_sql(co.base_uri, "SELECT count(*) FROM "
                                    "tpch.tiny.nation")
        assert out["data"] == [[25]]
        return _run_sql(co.base_uri,
                        "SELECT name, hard_concurrency_limit FROM "
                        "system.runtime.resource_groups "
                        "WHERE name = 'global.all'")["data"]

    import trino_tpu_torch.server.resourcegroups as port_rg
    got, want = _both(
        make(port_rg, Coordinator, device="cpu",
             history_dir=str(tmp_path / "t")),
        make(tpu_rg, TpuCoordinator, history_dir=str(tmp_path / "j")),
        drive)
    assert got == [["global.all", 2]] == want


# --- system.runtime + kill_query ------------------------------------------

def test_system_runtime_queries_and_nodes(tmp_path):
    def drive(co):
        _run_sql(co.base_uri, "SELECT 42")
        out = _run_sql(co.base_uri,
                       "SELECT state, query FROM system.runtime.queries "
                       "WHERE query LIKE '%42%'")
        nodes = _run_sql(co.base_uri, "SELECT node_id, coordinator "
                                      "FROM system.runtime.nodes")
        return sorted(map(tuple, out["data"])), \
            [r[1] for r in nodes["data"]]

    got, want = _both(
        lambda: Coordinator(device="cpu", history_dir=str(tmp_path / "t")),
        lambda: TpuCoordinator(history_dir=str(tmp_path / "j")), drive)
    assert "FINISHED" in [s for s, _ in got[0]]
    assert got[1] == [True]
    assert got == want


def test_kill_query_procedure(tmp_path):
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    try:
        # a long query: a self join of sf1 lineitem
        slow_sql = ("SELECT count(*) FROM tpch.sf1.lineitem a, "
                    "tpch.sf1.lineitem b WHERE a.l_orderkey = "
                    "b.l_orderkey AND a.l_suppkey + b.l_suppkey > 1")
        out = _post(co.base_uri + "/v1/statement", slow_sql)
        qid = out["id"]
        killed = _run_sql(
            co.base_uri,
            f"CALL system.runtime.kill_query('{qid}')")
        assert killed.get("error") is None
        assert killed["updateType"] == "CALL"
        deadline = time.time() + 20
        q = co.tracker.get(qid)
        while q.state not in ("CANCELED", "FINISHED", "FAILED") \
                and time.time() < deadline:
            time.sleep(0.05)
        assert q.state in ("CANCELED", "FINISHED")
        # the run thread stops at the next plan node
        assert q.wait_done(20.0)
        unknown = _run_sql(co.base_uri,
                           "CALL system.runtime.kill_query('nope')")
    finally:
        co.stop()
    jco = TpuCoordinator(history_dir=str(tmp_path / "j")).start()
    try:
        want = _run_sql(jco.base_uri,
                        "CALL system.runtime.kill_query('nope')")
    finally:
        jco.stop()
    assert unknown["error"]["errorName"] == want["error"]["errorName"]
    assert unknown["error"]["message"] == want["error"]["message"]


# --- security -------------------------------------------------------------

def test_password_authenticator():
    auth = InMemoryPasswordAuthenticator({"alice": "secret"})
    assert auth.authenticate("alice", "secret")
    assert not auth.authenticate("alice", "wrong")
    assert not auth.authenticate("bob", "secret")
    auth2 = load_password_file("bob:pw123\n# comment\n")
    assert auth2.authenticate("bob", "pw123")


def _basic(user_pw: bytes):
    return {"Authorization":
            "Basic " + base64.b64encode(user_pw).decode()}


def test_http_basic_auth(tmp_path):
    from trino_tpu.security import InMemoryPasswordAuthenticator as TpuAuth

    def drive(co):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(co.base_uri + "/v1/info")
        status, _ = _get(co.base_uri + "/v1/info",
                         _basic(b"alice:secret"))
        return e.value.code, e.value.headers.get("WWW-Authenticate"), \
            status

    got, want = _both(
        lambda: Coordinator(
            device="cpu", history_dir=str(tmp_path / "t"),
            authenticator=InMemoryPasswordAuthenticator(
                {"alice": "secret"})),
        lambda: TpuCoordinator(history_dir=str(tmp_path / "j"),
                               authenticator=TpuAuth({"alice": "secret"})),
        drive)
    assert got[0] == 401 and got[2] == 200
    assert got == want


def test_authenticated_principal_binds_session_user(tmp_path):
    from trino_tpu.security import InMemoryPasswordAuthenticator as TpuAuth

    def drive(co):
        codes = []
        for claimed in ("admin", "alice"):
            req = urllib.request.Request(
                co.base_uri + "/v1/statement", data=b"SELECT 1",
                headers={**_basic(b"alice:pw"), "X-Trino-User": claimed},
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        return codes

    got, want = _both(
        lambda: Coordinator(
            device="cpu", history_dir=str(tmp_path / "t"),
            authenticator=InMemoryPasswordAuthenticator({"alice": "pw"})),
        lambda: TpuCoordinator(history_dir=str(tmp_path / "j"),
                               authenticator=TpuAuth({"alice": "pw"})),
        drive)
    assert got == [403, 200] == want     # no impersonation by header


def test_access_control_rules():
    ac = RuleBasedAccessControl([
        AccessRule(user="alice", table=r"tpch\..*",
                   privileges=("select",)),
    ])
    ac.check_can_select("alice", "tpch", "tiny", "nation")
    with pytest.raises(AccessDeniedError):
        ac.check_can_select("bob", "tpch", "tiny", "nation")
    with pytest.raises(AccessDeniedError):
        ac.check_can_insert("alice", "tpch", "tiny", "nation")


def test_access_control_enforced_in_engine():
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu.security import AccessRule as TpuRule
    from trino_tpu.security import RuleBasedAccessControl as TpuRules
    from trino_tpu.session import Session as TpuSession
    from trino_tpu_torch.session import Session
    runner = LocalQueryRunner(
        session=Session(catalog="tpch", schema="tiny", user="bob"),
        device="cpu")
    runner.catalogs.access_control = RuleBasedAccessControl([
        AccessRule(user="alice", table=".*"),
    ])
    ref = TpuRunner(
        session=TpuSession(catalog="tpch", schema="tiny", user="bob"))
    ref.catalogs.access_control = TpuRules([TpuRule(user="alice",
                                                    table=".*")])
    with pytest.raises(QueryError, match="Access Denied") as got:
        runner.execute("SELECT * FROM tpch.tiny.nation")
    with pytest.raises(Exception, match="Access Denied") as want:
        ref.execute("SELECT * FROM tpch.tiny.nation")
    assert str(got.value) == str(want.value)
    runner.session.user = "alice"
    assert len(runner.execute(
        "SELECT * FROM tpch.tiny.region").rows) == 5


# --- failure detector -----------------------------------------------------

def test_failure_detector_decay():
    def drive(cls):
        health = {"w1": True, "w2": True}
        det = cls(probe=lambda uri: health[uri], warmup_probes=2)
        det.add_service("w1")
        det.add_service("w2")
        for _ in range(5):
            det.probe_once()
        assert det.is_alive("w1") and det.is_alive("w2")
        health["w2"] = False
        for _ in range(10):
            det.probe_once()
        return det.is_alive("w1"), det.is_alive("w2"), det.failed()

    assert drive(HeartbeatFailureDetector) == (True, False, ["w2"]) \
        == drive(TpuDetector)


def test_failure_detector_http_probe(tmp_path):
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    try:
        det = HeartbeatFailureDetector()
        det.add_service(co.base_uri)
        det.add_service("http://127.0.0.1:1")      # nothing listens
        for _ in range(5):
            det.probe_once()
        assert det.is_alive(co.base_uri)
        assert not det.is_alive("http://127.0.0.1:1")
    finally:
        co.stop()


# --- web UI + cluster stats + drain ---------------------------------------

def test_web_ui_and_cluster_stats(tmp_path):
    def drive(co):
        status, body = _get(co.base_uri + "/ui")
        assert status == 200 and b"trino-tpu" in body
        _run_sql(co.base_uri, "SELECT 1")
        status, body = _get(co.base_uri + "/v1/cluster")
        return json.loads(body)

    got, want = _both(
        lambda: Coordinator(device="cpu", history_dir=str(tmp_path / "t"),
                            memory_pool_bytes=1 << 30),
        lambda: TpuCoordinator(history_dir=str(tmp_path / "j"),
                               memory_pool_bytes=1 << 30), drive)
    assert got["totalQueries"] >= 1
    assert set(got) == set(want)
    assert got["activeWorkers"] == want["activeWorkers"] == 1
    assert set(got["memory"]) == set(want["memory"])


def test_graceful_drain(tmp_path):
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    out = _post(co.base_uri + "/v1/statement",
                "SELECT count(*) FROM tpch.tiny.orders")
    q = co.tracker.get(out["id"])
    assert co.drain(timeout=10.0)
    assert q.state == "FINISHED"
    assert not co.tracker.running()


def test_leak_report_is_not_yet_ported(tmp_path):
    co = Coordinator(device="cpu", history_dir=str(tmp_path))
    try:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            co.leak_report()
    finally:
        co._httpd.server_close()
        from trino_tpu_torch.obs.metrics import METRICS
        METRICS.unregister_collector(co._metric_collector)
