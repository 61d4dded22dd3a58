"""The port's chaos cases against the JAX package's: coordinator
restarts mid-pull, combine-stage failures, workers joining and leaving
through /v1/announcement, spool backends and single-host coalescing,
with port coordinators and port workers on the CPU; every query result
is held against the JAX engine's rows. Counterparts of
tests/test_chaos.py.

The reference's own description:
Chaos harness: coordinator restarts, worker joins, combine failures.

Reference parity: Trino's fault-tolerant execution spools the root
stage's output through the exchange manager so a client can re-pull
`QueryResults` after a coordinator restart, retries every stage
including the root, and absorbs discovery-service announcements so the
worker set grows mid-query. The scenarios here kill and restart the
processes those guarantees protect — a coordinator serving spooled
results, the combine (root) stage, and the worker fleet — with the
object-store-shaped spool backend active where durability is the point
under test.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession

from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
from trino_tpu_torch.fte.objectstore import (InMemoryObjectStore,
                                       ObjectStoreSpool)
from trino_tpu_torch.fte.spool import LocalDirSpool
from trino_tpu_torch.obs.metrics import METRICS
from trino_tpu_torch.server.coordinator import Coordinator
from trino_tpu_torch.server.task_worker import (TaskWorkerServer,
                                                announce_once)
from trino_tpu_torch.session import Session


def _dist(*args, **kwargs):
    """The port's distributed runner; its combine runs on the CPU."""
    return DistributedHostQueryRunner(*args, device="cpu", **kwargs)

SQL = ("SELECT n_name, count(*) FROM nation "
       "JOIN region ON n_regionkey = r_regionkey "
       "WHERE r_name = 'ASIA' GROUP BY n_name ORDER BY n_name")


def _counter(name: str) -> float:
    return METRICS.counter(name).value()


def _get_json(uri):
    with urllib.request.urlopen(uri, timeout=10) as r:
        return json.loads(r.read())


def _task_session(**props) -> Session:
    s = Session(catalog="tpch", schema="tiny")
    s.set("retry_policy", "TASK")
    s.set("retry_initial_delay_ms", 10)
    s.set("remote_task_timeout", 30)
    for k, v in props.items():
        s.set(k, v)
    return s


@pytest.fixture(scope="module")
def workers():
    w1 = TaskWorkerServer(device="cpu").start()
    w2 = TaskWorkerServer(device="cpu").start()
    yield [w1.base_uri, w2.base_uri]
    w1.stop()
    w2.stop()


@pytest.fixture(scope="module")
def expected():
    return TpuRunner(session=TpuSession(catalog="tpch",
                                        schema="tiny")).execute(SQL)


class _HangWorker:
    """A fake worker that accepts task POSTs then answers every result
    pull with 202 forever — a wedged node that can never produce data,
    so any query completing against it PROVES another worker ran the
    retried tasks."""

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                body = b'{"taskId": "x", "state": "RUNNING"}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self.send_response(202)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_DELETE(self):
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base_uri = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# --------------------------------------------------------------------------
# coordinator restart: results re-pulled off the spooled manifest
# --------------------------------------------------------------------------

def test_coordinator_restart_mid_pull_recovers_results():
    """The acceptance restart: a client that pulled part of a FINISHED
    query's results from coordinator #1 keeps pulling the SAME rows
    from coordinator #2 — a fresh process that never ran the query —
    because the combine output + manifest live in the shared
    object-store spool, not in coordinator memory."""
    sql = ("SELECT * FROM (VALUES (1, 'a'), (2, 'b'), (3, 'c')) "
           "AS t(x, y) ORDER BY x")
    store = InMemoryObjectStore()          # the durable "bucket"
    co1 = Coordinator(device="cpu", spool=ObjectStoreSpool(store)).start()
    try:
        out = _get_json_post(co1.base_uri + "/v1/statement", sql)
        qid = out["id"]
        # drain coordinator #1's answer (the client's first pull)
        rows1 = list(out.get("data") or [])
        while "nextUri" in out:
            out = _get_json(out["nextUri"])
            rows1.extend(out.get("data") or [])
        assert out["stats"]["state"] == "FINISHED"
        slug = co1.tracker.get(qid).slug
        # the finished query's manifest must hit the bucket before the
        # process dies (persist runs on the query thread post-FINISH)
        deadline = time.time() + 5
        while not store.list(f"{qid}/") and time.time() < deadline:
            time.sleep(0.02)
        assert store.list(f"{qid}/"), "manifest never reached the spool"
    finally:
        co1.stop()                         # the restart

    recovered = _counter("trino_tpu_query_results_recovered_total")
    co2 = Coordinator(device="cpu", spool=ObjectStoreSpool(store)).start()
    try:
        assert co2.tracker.get(qid) is None     # co2 never ran it
        # a wrong slug must NOT recover: the per-query capability
        # token keeps its strength across restarts
        with pytest.raises(urllib.error.HTTPError) as err:
            _get_json(f"{co2.base_uri}/v1/statement/executing/"
                      f"{qid}/forged-slug/0")
        assert err.value.code == 404
        # the real slug resumes the pull from token 0
        out = _get_json(f"{co2.base_uri}/v1/statement/executing/"
                        f"{qid}/{slug}/0")
        rows2 = list(out.get("data") or [])
        while "nextUri" in out:
            out = _get_json(out["nextUri"])
            rows2.extend(out.get("data") or [])
        assert out["stats"]["state"] == "FINISHED"
        assert rows2 == rows1 == [[1, "a"], [2, "b"], [3, "c"]]
        assert [c["name"] for c in out["columns"]] == ["x", "y"]
        assert _counter("trino_tpu_query_results_recovered_total") \
            == recovered + 1
        # the recovered entry also serves the query-detail surface
        detail = _get_json(f"{co2.base_uri}/v1/query/{qid}")
        assert detail["state"] == "FINISHED" and detail["rows"] == 3
    finally:
        co2.stop()


def _get_json_post(uri, data):
    req = urllib.request.Request(uri, data=data.encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _delete(uri):
    req = urllib.request.Request(uri, method="DELETE")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def test_canceled_query_results_never_persisted():
    """A CANCELED query's results must not become recoverable-as-
    FINISHED after a restart: a cancel landing before the persist
    skips it, and a cancel racing INTO the persist window discards
    the just-spooled entry."""
    from trino_tpu_torch.server.coordinator import _Query

    class _Runner:
        def __init__(self, session):
            pass

        def execute(self, sql):
            from trino_tpu_torch.runner import LocalQueryRunner
            return LocalQueryRunner(
                session=Session(catalog="tpch", schema="tiny"),
                device="cpu").execute("SELECT 1 AS x")

    # cancel BEFORE the persist window: on_result never fires
    q1 = _Query("q-early", "s", "SELECT 1",
                Session(catalog="tpch", schema="tiny"))
    calls = []

    def persist_racing_cancel(query, result):
        # the race: the client cancel lands while persist is running
        query.do_cancel()
        calls.append(query.query_id)
        return True

    discarded = []
    q1.state = "QUEUED"
    q1.do_cancel()
    q1.run(_Runner, on_result=lambda q, r: calls.append("early"),
           on_discard=discarded.append)
    assert q1.state == "CANCELED" and "early" not in calls

    # cancel DURING the persist: the entry is released again
    q2 = _Query("q-race", "s", "SELECT 1",
                Session(catalog="tpch", schema="tiny"))
    q2.run(_Runner, on_result=persist_racing_cancel,
           on_discard=lambda q: discarded.append(q.query_id))
    assert q2.state == "CANCELED"
    assert calls == ["q-race"] and discarded == ["q-race"]


def test_delete_requires_slug_to_release_spooled_results():
    """DELETE /v1/statement must present the query's slug to destroy
    its spooled restart-recovery results — the capability token guards
    destruction exactly as it guards recovery, or any client that can
    enumerate query ids could revoke another client's restart
    recoverability."""
    store = InMemoryObjectStore()
    co = Coordinator(device="cpu", spool=ObjectStoreSpool(store)).start()
    try:
        out = _get_json_post(co.base_uri + "/v1/statement",
                             "SELECT 42 AS x")
        qid = out["id"]
        while "nextUri" in out:
            out = _get_json(out["nextUri"])
        assert out["stats"]["state"] == "FINISHED"
        slug = co.tracker.get(qid).slug
        deadline = time.time() + 5
        while not store.list(f"{qid}/") and time.time() < deadline:
            time.sleep(0.02)
        assert store.list(f"{qid}/"), "manifest never reached the spool"
        # a forged slug still cancels idempotently (204) but must NOT
        # reap the durable results
        assert _delete(f"{co.base_uri}/v1/statement/executing/"
                       f"{qid}/forged-slug/0") == 204
        assert store.list(f"{qid}/"), "forged slug destroyed results"
        # the owner's slug releases them immediately
        assert _delete(f"{co.base_uri}/v1/statement/executing/"
                       f"{qid}/{slug}/0") == 204
        assert not store.list(f"{qid}/")
    finally:
        co.stop()


# --------------------------------------------------------------------------
# combine (root) stage retry
# --------------------------------------------------------------------------

class _FlakyCombine:
    """Monkeypatch hook: fail the scheduler's combine Executor N times,
    then delegate — only exec.remote's Executor reference is patched,
    so worker-side execution is untouched."""

    def __init__(self, real, failures):
        self.real = real
        self.left = failures

    def make(self):
        flaky = self

        class FlakyExecutor(flaky.real):
            def execute(ex_self, plan):
                if flaky.left > 0:
                    flaky.left -= 1
                    raise RuntimeError("injected combine failure")
                return super().execute(plan)

        return FlakyExecutor


def test_combine_stage_failure_retried(workers, expected, monkeypatch):
    """The root stage was the one unretried single point of failure:
    under retry_policy=TASK an injected combine crash re-executes on
    the coordinator (its fragment inputs are already gathered), the
    query completes with the right answer, and the retry is visible in
    the counter and the span tree."""
    import trino_tpu_torch.exec.remote as remote
    flaky = _FlakyCombine(remote.Executor, failures=1)
    monkeypatch.setattr(remote, "Executor", flaky.make())
    before = _counter("trino_tpu_combine_retries_total")
    runner = _dist(
        workers, session=_task_session(),
        spool=ObjectStoreSpool(InMemoryObjectStore()),
        collect_node_stats=True)
    res = runner.execute(SQL)
    assert res.rows == expected.rows
    assert flaky.left == 0
    assert _counter("trino_tpu_combine_retries_total") == before + 1
    names = []

    def walk(spans):
        for sp in spans:
            names.append(sp["name"])
            walk(sp.get("children", []))

    walk(res.trace.to_dicts())
    assert "combine_retry" in names, names


def test_combine_failure_none_policy_fails_fast(workers, monkeypatch):
    """retry_policy=NONE keeps the old semantics: a combine crash is
    the query's answer, not a silent re-execution."""
    import trino_tpu_torch.exec.remote as remote
    flaky = _FlakyCombine(remote.Executor, failures=100)
    monkeypatch.setattr(remote, "Executor", flaky.make())
    before = _counter("trino_tpu_combine_retries_total")
    runner = _dist(
        workers, session=Session(catalog="tpch", schema="tiny"))
    with pytest.raises(Exception, match="injected combine failure"):
        runner.execute(SQL)
    assert _counter("trino_tpu_combine_retries_total") == before


# --------------------------------------------------------------------------
# live worker membership
# --------------------------------------------------------------------------

def test_worker_joining_mid_query_receives_retried_task(expected):
    """The acceptance join: the initial worker set is ONE wedged node
    that can never return data, so the only way this query completes
    is the scheduler's membership re-sync handing the retried tasks to
    the worker that joined after dispatch — with the object-store
    spool backend carrying the retried attempts' output."""
    hang = _HangWorker()
    joiner = TaskWorkerServer(device="cpu").start()
    members = [hang.base_uri]
    retries = _counter("trino_tpu_task_retries_total")
    try:
        # warm the joiner (JIT compile of this query's fragments) so
        # the short task timeout below measures the wedged node, not
        # first-run compile on the replacement
        warm = _dist(
            [joiner.base_uri], session=_task_session()).execute(SQL)
        assert warm.rows == expected.rows
        runner = _dist(
            [hang.base_uri],           # dispatch-time fan-out set
            session=_task_session(remote_task_timeout=2),
            spool=ObjectStoreSpool(InMemoryObjectStore()),
            worker_supplier=lambda: members)
        # the join lands after dispatch: the supplier is only
        # consulted when a replacement/speculative attempt is placed
        members.append(joiner.base_uri)
        res = runner.execute(SQL)
    finally:
        hang.stop()
        joiner.stop()
    assert res.rows == expected.rows
    assert _counter("trino_tpu_task_retries_total") > retries


def test_worker_announce_join_and_graceful_leave():
    """The membership endpoints end to end: a worker announces itself
    into an EMPTY coordinator (which also bootstraps detector + spool),
    re-announcement is idempotent, liveness shows in GET, and stop()
    sends the graceful leave."""
    co = Coordinator(device="cpu").start()
    w = TaskWorkerServer(device="cpu").start()
    joins = _counter("trino_tpu_worker_joins_total")
    leaves = _counter("trino_tpu_worker_leaves_total")
    try:
        assert co.live_workers() == []
        assert w.announce(co.base_uri)
        assert w.base_uri in co.live_workers()
        assert co.failure_detector is not None   # bootstrapped on join
        assert co.spool is not None
        assert _counter("trino_tpu_worker_joins_total") == joins + 1
        # idempotent: a re-announcement must not duplicate the entry
        assert announce_once(co.base_uri, w.base_uri, w.node_id)
        assert co.live_workers().count(w.base_uri) == 1
        assert _counter("trino_tpu_worker_joins_total") == joins + 1
        # calling announce() again retires the previous announcer
        # loop (fresh stop event, fresh thread) instead of leaking a
        # second beating loop
        first_loop = w._announce_thread
        first_stop = w._announce_stop
        assert w.announce(co.base_uri)
        assert first_stop.is_set()               # old loop retired
        assert w._announce_thread is not first_loop
        assert not w._announce_stop.is_set()     # new loop live
        listing = _get_json(co.base_uri + "/v1/announcement")
        mine = [e for e in listing["workers"]
                if e["uri"] == w.base_uri]
        # one entry, alive, carrying the pre-warm readiness flag
        assert len(mine) == 1 and mine[0]["alive"] is True
        assert "prewarmed" in mine[0]
        # graceful leave rides on worker stop()
        w.stop()
        deadline = time.time() + 5
        while w.base_uri in co.workers and time.time() < deadline:
            time.sleep(0.02)
        assert w.base_uri not in co.workers
        assert _counter("trino_tpu_worker_leaves_total") == leaves + 1
    finally:
        co.stop()


def test_session_spool_backend_override_reaches_runner(workers):
    """`SET SESSION spool_backend` must reach the scheduler: the
    coordinator's runner factory routes the query's fragment spool
    through the requested backend instead of the server default."""
    from trino_tpu_torch.fte.objectstore import ObjectStoreSpool
    co = Coordinator(device="cpu", worker_uris=list(workers)).start()
    try:
        s = Session(catalog="tpch", schema="tiny")
        s.set("spool_backend", "memory")
        runner = co.tracker._make_runner(s)
        assert isinstance(runner.spool, ObjectStoreSpool)
        # and the default stays on the server's spool
        default = co.tracker._make_runner(
            Session(catalog="tpch", schema="tiny"))
        assert default.spool is co.spool
    finally:
        co.stop()


def test_worker_announce_to_authenticated_coordinator():
    """An authenticated coordinator gates /v1/announcement like every
    other resource: a credential-less announce is rejected, one
    carrying the Bearer token joins (the --coordinator-token path)."""
    import time as _time

    from trino_tpu_torch.security import JwtAuthenticator
    auth = JwtAuthenticator(b"cluster-secret")
    co = Coordinator(device="cpu", authenticator=auth).start()
    w = TaskWorkerServer(device="cpu").start()
    try:
        assert not announce_once(co.base_uri, w.base_uri, w.node_id)
        assert co.live_workers() == []
        token = auth.sign({"sub": "worker",
                           "exp": _time.time() + 300})
        assert w.announce(co.base_uri, token=token)
        assert w.base_uri in co.live_workers()
    finally:
        w.stop()
        co.stop()


# --------------------------------------------------------------------------
# single-host double-spool-write coalescing
# --------------------------------------------------------------------------

def test_commit_linked_hard_links_single_write(tmp_path):
    """The coordinator-side coalesced commit hard-links the worker's
    already-committed frames: bytes are written (and metric-counted)
    ONCE, the linked attempt reads back verbatim, and first-commit-wins
    still holds across the linked path."""
    worker = LocalDirSpool(str(tmp_path / "w"))
    coord = LocalDirSpool(str(tmp_path / "c"))
    frames = [b"0123456789" * 100, b"tail"]
    written = _counter("trino_tpu_spool_bytes_written_total")
    coalesced = _counter("trino_tpu_spool_coalesced_commits_total")
    worker.commit("task-1", 0, 0, 0, frames)
    src = worker.attempt_dir("task-1", 0, 0)
    assert coord.commit_linked("q", 3, 1, 0, src) == 0
    assert coord.read("q", 3, 1) == frames
    # byte-counted once: only the worker's physical write moved it
    assert _counter("trino_tpu_spool_bytes_written_total") - written \
        == sum(len(f) for f in frames)
    assert _counter("trino_tpu_spool_coalesced_commits_total") \
        == coalesced + 1
    # same inodes — one physical copy on disk
    for name in os.listdir(src):
        assert os.stat(os.path.join(src, name)).st_nlink >= 2
    # a late duplicate through the linked path reports the winner
    assert coord.commit_linked("q", 3, 1, 7, src) == 0
    # the source dir is worker-supplied (X-TT-Spool-Dir): linked bytes
    # that do not match the pulled frames must be refused, unpublished
    with pytest.raises(ValueError):
        coord.commit_linked("q2", 0, 0, 0, src,
                            expect_frames=[b"forged", b"frames"])
    assert coord.read("q2", 0, 0) is None
    # matching frames pass verification and publish normally
    assert coord.commit_linked("q2", 0, 0, 0, src,
                               expect_frames=frames) == 0
    assert coord.read("q2", 0, 0) == frames


def _kill_server(worker) -> None:
    """shutdown + close on a background thread: connections REFUSE
    immediately (a dead process), not a zombie listening socket."""
    def stop():
        worker._httpd.shutdown()
        worker._httpd.server_close()
    threading.Thread(target=stop, daemon=True).start()


class _DiesOnMidDagTask(TaskWorkerServer):
    """Executes leaf tasks normally, then dies the first time it
    receives an exchange-fed task — mid-flight, while other queries'
    tasks are interleaving on the surviving workers."""

    def create_task(self, tid, payload):
        stage = payload.get("stage") or {}
        if stage.get("sources") and not getattr(self, "_killed",
                                                False):
            self._killed = True
            _kill_server(self)
            raise ConnectionResetError("killed mid-interleave")
        return super().create_task(tid, payload)


def test_worker_kill_during_shared_scheduler_interleaving():
    """Chaos: a worker dies while the shared split scheduler
    (exec/taskexec.py) is interleaving >= 2 concurrent queries on
    1-runner-slot survivors — both queries complete with exact
    results, and the victim's tasks are rescheduled through the
    normal per-stage retry machinery."""
    sql2 = ("SELECT r_name, count(*) FROM region "
            "GROUP BY r_name ORDER BY r_name")
    exp = {
        "q1": TpuRunner(session=TpuSession(
            catalog="tpch", schema="tiny")).execute(SQL).rows,
        "q2": TpuRunner(session=TpuSession(
            catalog="tpch", schema="tiny")).execute(sql2).rows,
    }
    bad = _DiesOnMidDagTask(device="cpu").start()
    # ONE runner slot each: concurrent queries' tasks genuinely
    # time-slice through the multilevel queue instead of running on
    # parallel threads
    w1 = TaskWorkerServer(device="cpu", task_runners=1).start()
    w2 = TaskWorkerServer(device="cpu", task_runners=1).start()
    retries_before = _counter("trino_tpu_task_retries_total")
    results, errs = {}, []

    def run(name, sql):
        try:
            results[name] = _dist(
                [bad.base_uri, w1.base_uri, w2.base_uri],
                session=_task_session()).execute(sql).rows
        except Exception as e:      # noqa: BLE001
            errs.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=run, args=("q1", SQL)),
               threading.Thread(target=run, args=("q2", sql2))]
    max_open = 0
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            max_open = max(max_open,
                           w1.task_executor.open_tasks(),
                           w2.task_executor.open_tasks())
            time.sleep(0.005)
        for t in threads:
            t.join(60)
    finally:
        w1.stop()
        w2.stop()
        try:
            bad.stop()
        except OSError:
            pass
    assert not errs, errs
    assert results["q1"] == exp["q1"]
    assert results["q2"] == exp["q2"]
    # the victim's tasks were rescheduled, not lost
    assert _counter("trino_tpu_task_retries_total") > retries_before
    # and the scheduler really had > 1 task registered at once on a
    # single-slot worker (the interleaving this chaos targets)
    assert max_open >= 2, max_open


def test_single_host_query_spools_bytes_once(tmp_path, expected):
    """End to end on one host: workers commit task output to their
    spool, the coordinator's commit coalesces into hard links — the
    byte-written counter moves by exactly the WORKER-side writes (the
    coordinator's copy costs zero bytes), asserted against the actual
    page files on disk."""
    wdir = tmp_path / "worker-spool"
    w1 = TaskWorkerServer(spool_dir=str(wdir), device="cpu").start()
    w2 = TaskWorkerServer(spool_dir=str(wdir), device="cpu").start()
    written = _counter("trino_tpu_spool_bytes_written_total")
    coalesced = _counter("trino_tpu_spool_coalesced_commits_total")
    try:
        # flat-path pin: commit coalescing (X-TT-Spool-Dir hard links)
        # is the leaf-fragment path's coordinator-side double-write
        # optimization; stage tasks never re-commit at the coordinator
        # (their frames stay on the worker spools), so the stage path
        # has nothing to coalesce by construction
        sess = _task_session()
        sess.set("multistage_execution", False)
        runner = _dist(
            [w1.base_uri, w2.base_uri], session=sess,
            spool=LocalDirSpool(str(tmp_path / "coord-spool")))
        res = runner.execute(SQL)
    finally:
        w1.stop()
        w2.stop()
    assert res.rows == expected.rows
    assert _counter("trino_tpu_spool_coalesced_commits_total") \
        > coalesced
    worker_bytes = sum(
        os.path.getsize(os.path.join(root, f))
        for root, _, files in os.walk(wdir)
        for f in files if f.startswith("page_"))
    assert worker_bytes > 0
    assert _counter("trino_tpu_spool_bytes_written_total") - written \
        == worker_bytes
