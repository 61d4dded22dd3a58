"""The port's DB-API driver, proxy, server bootstrap, grants and JWT
authentication, against the JAX package's.

Counterparts of tests/test_dbapi.py (all of it) and of
tests/test_services.py's properties, ``etc/`` catalogs, proxy, grant,
JWT and verifier cases. Each case runs the same calls against the JAX
coordinator and the port's (``device="cpu"``) and holds the port's
answers to the reference's.
"""

import decimal
import json
import time
import urllib.error
import urllib.request

import pytest

from _torch_server import assert_same_result, pair
from trino_tpu.client import StatementClient as TpuClient
from trino_tpu.dbapi import connect as tpu_connect
from trino_tpu.server.proxy import Proxy as TpuProxy
from trino_tpu_torch.client import StatementClient
from trino_tpu_torch.dbapi import ProgrammingError, _render_param, connect
from trino_tpu_torch.server.coordinator import Coordinator
from trino_tpu_torch.server.proxy import Proxy

__all__ = ["pair"]


def cursors(pair, **kw):
    """(port cursor, JAX cursor)."""
    jco, tco = pair
    return (connect(tco.base_uri, **kw).cursor(),
            tpu_connect(jco.base_uri, **kw).cursor())


# ---- counterparts of tests/test_dbapi.py ------------------------------------

def test_basic_query(pair):
    cur, ref = cursors(pair)
    sql = "SELECT r_regionkey, r_name FROM tpch.tiny.region ORDER BY 1"
    cur.execute(sql)
    ref.execute(sql)
    assert cur.description == ref.description
    assert cur.description[0][0] == "r_regionkey"
    assert cur.rowcount == 5 == ref.rowcount
    first = cur.fetchone()
    assert first == [0, "AFRICA"]
    rest = cur.fetchall()
    assert len(rest) == 4
    assert [first] + rest == ref.fetchall()


def test_qmark_parameters(pair):
    cur, ref = cursors(pair)
    for c in (cur, ref):
        c.execute("SELECT n_name FROM tpch.tiny.nation WHERE "
                  "n_nationkey = ?", (3,))
    assert cur.fetchall() == [["CANADA"]] == ref.fetchall()
    for c in (cur, ref):
        c.execute("SELECT count(*) FROM tpch.tiny.nation WHERE "
                  "n_name < ? AND n_regionkey = ?", ("CANADA", 1))
    assert cur.fetchone() == [2] == ref.fetchone()


def test_fetchmany_iteration(pair):
    cur, ref = cursors(pair)
    for c in (cur, ref):
        c.execute("SELECT n_nationkey FROM tpch.tiny.nation "
                  "ORDER BY n_nationkey")
    assert cur.fetchmany(3) == [[0], [1], [2]] == ref.fetchmany(3)
    assert list(cur) == list(ref)
    assert len(list(cur)) == 0


def test_ddl_and_rowcount(pair):
    cur, ref = cursors(pair, catalog="memory", schema="default")
    for c in (cur, ref):
        c.execute("CREATE TABLE memory.default.dbapi_t (x bigint)")
        c.execute("INSERT INTO memory.default.dbapi_t VALUES (1), (2)")
        assert c.rowcount == 2
        c.execute("SELECT count(*) FROM memory.default.dbapi_t")
        assert c.fetchone() == [2]
        c.execute("DROP TABLE memory.default.dbapi_t")


def test_parameters_through_proxy(pair):
    jco, tco = pair
    got = []
    for proxy_cls, co, conn in ((Proxy, tco, connect),
                                (TpuProxy, jco, tpu_connect)):
        px = proxy_cls(co.base_uri).start()
        try:
            cur = conn(px.base_uri).cursor()
            cur.execute("SELECT n_name FROM tpch.tiny.nation WHERE "
                        "n_nationkey = ?", (3,))
            got.append(cur.fetchall())
        finally:
            px.stop()
    assert got[0] == [["CANADA"]] == got[1]


def test_render_param_edge_values():
    from trino_tpu.dbapi import _render_param as tpu_render
    values = (float("inf"), float("-inf"), float("nan"),
              decimal.Decimal("1.25"), None, "o'brien", True, 7,
              2.5)
    assert _render_param(float("inf")) == "infinity()"
    assert _render_param(float("-inf")) == "-infinity()"
    assert _render_param(float("nan")) == "nan()"
    assert _render_param(decimal.Decimal("1.25")) == "1.25"
    assert _render_param(None) == "NULL"
    assert _render_param("o'brien") == "'o''brien'"
    assert [_render_param(v) for v in values] == \
        [tpu_render(v) for v in values]


def test_error_raises(pair):
    cur, ref = cursors(pair)
    messages = []
    for c in (cur, ref):
        with pytest.raises(Exception) as e:
            c.execute("SELECT * FROM tpch.tiny.not_a_table")
        messages.append(str(e.value))
    with pytest.raises(ProgrammingError):
        cur.execute("SELECT * FROM tpch.tiny.not_a_table")
    assert messages[0] == messages[1]


# ---- counterparts of tests/test_services.py ----------------------------------

def test_proxy_forwards_and_rewrites(pair):
    jco, tco = pair
    answers = []
    for proxy_cls, co, cls in ((Proxy, tco, StatementClient),
                               (TpuProxy, jco, TpuClient)):
        px = proxy_cls(co.base_uri).start()
        try:
            res = cls(px.base_uri).execute(
                "SELECT count(*) FROM tpch.tiny.region")
            answers.append(res.rows)
            # nextUri rewriting: polls go through the proxy only
            req = urllib.request.Request(
                px.base_uri + "/v1/statement", data=b"SELECT 1",
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                out = json.loads(r.read())
            assert co.base_uri not in out.get("nextUri", "")
        finally:
            px.stop()
    assert answers[0] == [[5]] == answers[1]


def test_proxy_shared_secret(pair):
    jco, tco = pair
    for proxy_cls, co in ((Proxy, tco), (TpuProxy, jco)):
        px = proxy_cls(co.base_uri, shared_secret="s3cret").start()
        try:
            req = urllib.request.Request(px.base_uri + "/v1/info")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            assert e.value.code == 403
            req = urllib.request.Request(
                px.base_uri + "/v1/info",
                headers={"X-Proxy-Secret": "s3cret"})
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status == 200
        finally:
            px.stop()


def test_load_properties(tmp_path):
    from trino_tpu.server.main import load_properties as tpu_load
    from trino_tpu_torch.server.main import load_properties
    p = tmp_path / "config.properties"
    p.write_text("# comment\nhttp-server.http.port=8099\n"
                 "coordinator=true\n")
    props = load_properties(str(p))
    assert props == {"http-server.http.port": "8099",
                     "coordinator": "true"}
    assert props == tpu_load(str(p))


def test_build_catalogs_from_etc(tmp_path):
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu.server.main import build_catalogs as tpu_build
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.server.main import build_catalogs
    cat = tmp_path / "catalog"
    cat.mkdir()
    (cat / "analytics.properties").write_text("connector.name=tpch\n")
    (cat / "scratch.properties").write_text("connector.name=memory\n")
    mgr = build_catalogs(str(tmp_path), device="cpu")
    assert set(mgr.list_catalogs()) == {"analytics", "scratch"}
    assert set(tpu_build(str(tmp_path)).list_catalogs()) == \
        {"analytics", "scratch"}
    sql = "SELECT count(*) FROM analytics.tiny.region"
    assert LocalQueryRunner(catalogs=mgr, device="cpu").execute(sql).rows \
        == [[5]] == TpuRunner(catalogs=tpu_build(str(tmp_path))) \
        .execute(sql).rows
    # with no catalog files: the default set, the JAX one's
    assert sorted(build_catalogs(None, device="cpu").list_catalogs()) == \
        sorted(tpu_build(None).list_catalogs())


def test_coordinator_from_etc_settings(tmp_path):
    """config.properties sets the memory pool and the scan cache's
    budget, which holds while the coordinator serves and is put back by
    stop(); a config naming the worker role is refused (the worker waits
    for ROADMAP 11b)."""
    from trino_tpu_torch.config import CONFIG
    from trino_tpu_torch.server.main import coordinator_from_etc
    (tmp_path / "config.properties").write_text(
        "http-server.http.port=0\nquery.max-memory=1GB\n"
        "scan-cache.max-size=64MB\n")
    before = CONFIG.scan_cache_bytes
    co = coordinator_from_etc(str(tmp_path), device="cpu").start()
    try:
        assert CONFIG.scan_cache_bytes == 64 << 20
        assert co.memory.pool.max_bytes == 1 << 30
        assert StatementClient(co.base_uri).execute(
            "SELECT count(*) FROM tpch.tiny.nation").rows == [[25]]
    finally:
        co.stop()
    assert CONFIG.scan_cache_bytes == before
    # a worker's config is not a coordinator's: it starts with
    # --role worker
    (tmp_path / "config.properties").write_text("node.role=worker\n")
    with pytest.raises(SystemExit, match="--role worker"):
        coordinator_from_etc(str(tmp_path), device="cpu")


def test_grant_revoke_show_grants_over_http(pair):
    steps = [
        "CREATE TABLE memory.default.gr_t AS SELECT 1 AS x",
        "GRANT SELECT, INSERT ON memory.default.gr_t TO alice",
        "SHOW GRANTS ON memory.default.gr_t",
        "REVOKE INSERT ON memory.default.gr_t FROM alice",
        "SHOW GRANTS ON memory.default.gr_t",
        "GRANT ALL PRIVILEGES ON TABLE memory.default.gr_t "
        "TO USER bob WITH GRANT OPTION",
        "SHOW GRANTS ON memory.default.gr_t",
        "DROP TABLE memory.default.gr_t",
    ]
    jco, tco = pair
    shown = []
    for sql in steps:
        got = StatementClient(tco.base_uri).execute(sql)
        want = TpuClient(jco.base_uri).execute(sql)
        assert_same_result(got, want)
        if sql.startswith("SHOW"):
            shown.append(got.rows)
    assert sorted(r[7] for r in shown[0]) == ["INSERT", "SELECT"]
    assert all(r[2] == "alice" for r in shown[0])
    assert [r[7] for r in shown[1]] == ["SELECT"]
    bob = [r for r in shown[2] if r[2] == "bob"]
    assert len(bob) == 4 and all(r[8] is True for r in bob)


def test_grant_enforcement_through_the_coordinator(tmp_path):
    """Grant-based access control on the coordinator's catalogs: the
    user of X-Trino-User is denied, granted, then denied again, on both
    coordinators alike."""
    from trino_tpu.security import GrantBasedAccessControl as TpuGrants
    from trino_tpu.server.coordinator import Coordinator as TpuCoordinator
    from trino_tpu_torch.security import GrantBasedAccessControl
    outcomes = []
    for co, cls, grants in (
            (Coordinator(device="cpu", history_dir=str(tmp_path / "t")),
             StatementClient, GrantBasedAccessControl),
            (TpuCoordinator(history_dir=str(tmp_path / "j")), TpuClient,
             TpuGrants)):
        co.start()
        try:
            admin = cls(co.base_uri, user="admin", catalog="memory",
                        schema="default")
            alice = cls(co.base_uri, user="alice", catalog="memory",
                        schema="default")
            admin.execute("CREATE TABLE memory.default.sec_t AS "
                          "SELECT 1 AS x")
            cats = co._catalogs
            cats.access_control = grants(cats)
            seen = []
            for who, sql in (
                    (alice, "SELECT * FROM memory.default.sec_t"),
                    (admin, "GRANT SELECT ON memory.default.sec_t "
                            "TO alice"),
                    (alice, "SELECT * FROM memory.default.sec_t"),
                    (admin, "DENY SELECT ON memory.default.sec_t "
                            "TO alice"),
                    (alice, "SELECT * FROM memory.default.sec_t")):
                try:
                    seen.append(who.execute(sql).rows)
                except Exception as e:          # noqa: BLE001
                    seen.append(str(e))
            outcomes.append(seen)
        finally:
            co.stop()
    assert outcomes[0] == outcomes[1]
    assert "Access Denied" in outcomes[0][0]
    assert outcomes[0][2] == [[1]]
    assert "Access Denied" in outcomes[0][4]


def _jwt_statuses(coord, auth):
    def post(token, extra=None):
        req = urllib.request.Request(
            coord.base_uri + "/v1/statement", data=b"SELECT 1",
            headers={"Authorization": f"Bearer {token}",
                     **(extra or {})}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, "error" in json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    good = auth.sign({"sub": "alice", "iss": "tt",
                      "exp": time.time() + 60})
    return [post(good),
            post(auth.sign({"sub": "alice", "iss": "tt",
                            "exp": time.time() - 5})),
            post(good[:-4] + "AAAA"),
            post(auth.sign({"sub": "alice", "iss": "other",
                            "exp": time.time() + 60})),
            post(good, {"X-Trino-User": "mallory"})]


def test_jwt_bearer_authentication(tmp_path):
    """JWT HS256 end to end: a valid token runs a query as its
    principal; expired, forged and wrong-issuer tokens get 401; an
    impersonation mismatch gets 403 — on both coordinators."""
    from trino_tpu.security import JwtAuthenticator as TpuJwt
    from trino_tpu.server.coordinator import Coordinator as TpuCoordinator
    from trino_tpu_torch.security import JwtAuthenticator
    got = want = None
    auth = JwtAuthenticator(b"secret-key", required_issuer="tt")
    coord = Coordinator(authenticator=auth, device="cpu",
                        history_dir=str(tmp_path / "t")).start()
    try:
        got = _jwt_statuses(coord, auth)
    finally:
        coord.stop()
    tauth = TpuJwt(b"secret-key", required_issuer="tt")
    coord = TpuCoordinator(authenticator=tauth,
                           history_dir=str(tmp_path / "j")).start()
    try:
        want = _jwt_statuses(coord, tauth)
    finally:
        coord.stop()
    assert got == [(200, False), (401, None), (401, None), (401, None),
                   (403, None)]
    assert got == want


def test_jwt_missing_exp_rejected_by_default():
    """A token with no exp claim never ages out, so the default rejects
    it; require_exp=False accepts it, and still enforces expiry."""
    from trino_tpu.security import JwtAuthenticator as TpuJwt
    from trino_tpu_torch.security import JwtAuthenticator

    strict = JwtAuthenticator(b"secret-key")
    eternal = strict.sign({"sub": "alice"})
    assert eternal == TpuJwt(b"secret-key").sign({"sub": "alice"})
    assert strict.authenticate_token(eternal) is None
    bounded = strict.sign({"sub": "alice", "exp": time.time() + 60})
    assert strict.authenticate_token(bounded) == "alice"

    lax = JwtAuthenticator(b"secret-key", require_exp=False)
    assert lax.authenticate_token(eternal) == "alice"
    expired = lax.sign({"sub": "alice", "exp": time.time() - 5})
    assert lax.authenticate_token(expired) is None


# ---- the verifier (verifier.py) ----------------------------------------------

def test_rows_match_tolerance_and_order():
    from trino_tpu.verifier import rows_match as tpu_rows_match
    from trino_tpu_torch.verifier import rows_match
    cases = [([[1, 2.0]], [[1, 2.0 + 1e-12]], {}),
             ([[1], [2]], [[2], [1]], {}),
             ([[1], [2]], [[2], [1]], {"ordered": True}),
             ([[1]], [[1], [2]], {}),
             ([[None]], [[None]], {}),
             ([[None]], [[1]], {})]
    for a, b, kw in cases:
        assert rows_match(a, b, **kw) == tpu_rows_match(a, b, **kw)
    assert rows_match([[1, 2.0]], [[1, 2.0 + 1e-12]]) is None
    assert rows_match([[1], [2]], [[2], [1]]) is None
    assert rows_match([[1], [2]], [[2], [1]], ordered=True)
    assert "row count" in rows_match([[1]], [[1], [2]])
    assert rows_match([[None]], [[None]]) is None
    assert rows_match([[None]], [[1]])


@pytest.mark.slow
def test_verifier_local_vs_distributed():
    """The port's local runner against the port's stage DAG on two port
    workers, and the JAX engine against the same distributed runner."""
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    from trino_tpu_torch.verifier import Verifier, report
    workers = [TaskWorkerServer(device="cpu").start() for _ in range(2)]
    try:
        test = DistributedHostQueryRunner([w.base_uri for w in workers],
                                          device="cpu")
        suite = [
            "SELECT count(*) FROM tpch.tiny.nation",
            "SELECT n_regionkey, count(*) FROM tpch.tiny.nation "
            "GROUP BY n_regionkey ORDER BY n_regionkey",
            "SELECT sum(l_extendedprice * l_discount) FROM "
            "tpch.tiny.lineitem WHERE l_quantity < 10",
        ]
        for control in (LocalQueryRunner(device="cpu"), TpuRunner()):
            results = Verifier(control, test, rel_tol=1e-9).run_suite(
                suite)
            assert all(r.status == "MATCH" for r in results), \
                report(results)
    finally:
        for w in workers:
            w.stop()


def test_verifier_detects_mismatch():
    from trino_tpu.verifier import Verifier as TpuVerifier
    from trino_tpu_torch.verifier import Verifier

    class Fake:
        def __init__(self, rows):
            self._rows = rows

        def execute(self, sql):
            class R:
                rows = self._rows
            return R()
    r = Verifier(Fake([[1]]), Fake([[2]])).verify("SELECT 1")
    assert r.status == "MISMATCH" and "1" in r.detail
    t = TpuVerifier(Fake([[1]]), Fake([[2]])).verify("SELECT 1")
    assert (r.status, r.detail) == (t.status, t.detail)


def test_verifier_error_classification():
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.verifier import Verifier
    good = LocalQueryRunner(device="cpu")

    class Broken:
        def execute(self, sql):
            raise RuntimeError("down")
    assert Verifier(good, Broken()).verify(
        "SELECT 1").status == "TEST_ERROR"
    assert Verifier(Broken(), good).verify(
        "SELECT 1").status == "CONTROL_ERROR"
    assert Verifier(good, TpuRunner()).verify(
        "SELECT 1").status == "MATCH"
