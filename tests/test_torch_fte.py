"""The port's fault-tolerant execution against the JAX package's: the
spooled exchange (local and object-store backends), task retries,
straggler speculation and fault injection, through port workers on the
CPU; every query result is held against the JAX engine's rows, and the
retry engine's pure functions against the JAX package's. Counterparts
of tests/test_fte.py.

The reference's own description:

Reference parity: Trino's retry-policy=TASK mode — spooling exchange
(trino-exchange-filesystem), task-attempt bookkeeping
(EventDrivenFaultTolerantQueryScheduler), and speculative execution —
exercised here with real HTTP worker servers plus fault-injection stubs
that kill / 500 / hang the results pull mid-query.
"""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from trino_tpu.fte import retry as tpu_retry
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession

from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
from trino_tpu_torch.fte.retry import (RetryController, RetryPolicy,
                                 backoff_delay, pick_worker)
from trino_tpu_torch.fte.speculate import StragglerDetector
from trino_tpu_torch.fte.spool import LocalDirSpool
from trino_tpu_torch.obs.metrics import METRICS
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.server.failure import HeartbeatFailureDetector
from trino_tpu_torch.server.task_worker import (RemoteTaskClient,
                                          TaskWorkerServer)
from trino_tpu_torch.session import Session

SQL = ("SELECT n_name, count(*) FROM nation "
       "JOIN region ON n_regionkey = r_regionkey "
       "WHERE r_name = 'ASIA' GROUP BY n_name ORDER BY n_name")


def _counter(name: str) -> float:
    return METRICS.counter(name).value()


def _dist(*args, **kwargs):
    """The port's distributed runner; its combine runs on the CPU."""
    return DistributedHostQueryRunner(*args, device="cpu", **kwargs)


# --------------------------------------------------------------------------
# spool: commit / read / first-commit-wins / TTL
# --------------------------------------------------------------------------

def test_spool_commit_and_read(tmp_path):
    spool = LocalDirSpool(str(tmp_path))
    frames = [b"page-zero", b"page-one"]
    assert spool.commit("q1", 0, 0, 0, frames) == 0
    assert spool.committed_attempt("q1", 0, 0) == 0
    assert spool.read("q1", 0, 0) == frames
    assert spool.read("q1", 0, 1) is None        # nothing committed
    spool.release("q1")
    assert spool.read("q1", 0, 0) is None


def test_spool_duplicate_attempt_discarded(tmp_path):
    """Idempotent writes: the second attempt's output is dropped, not
    double-counted — the winner's frames survive verbatim."""
    spool = LocalDirSpool(str(tmp_path))
    before = _counter("trino_tpu_spool_duplicate_attempts_total")
    assert spool.commit("q1", 2, 1, 0, [b"winner"]) == 0
    # a late duplicate (retry or speculative loser) reports the winner
    assert spool.commit("q1", 2, 1, 1, [b"loser"]) == 0
    assert spool.read("q1", 2, 1) == [b"winner"]
    assert _counter(
        "trino_tpu_spool_duplicate_attempts_total") == before + 1


def test_spool_corrupt_marker_usurped(tmp_path):
    """A crashed commit can no longer leave an empty marker (the claim
    hard-links a fully written file), but a legacy/corrupt one must be
    usurped by the next attempt — never poisoning the part, and never
    costing the new attempt its own frames."""
    import os
    spool = LocalDirSpool(str(tmp_path))
    tdir = spool._task_dir("q", 0, 0)
    os.makedirs(tdir)
    open(os.path.join(tdir, "COMMITTED"), "w").close()  # empty marker
    assert spool.committed_attempt("q", 0, 0) is None
    assert spool.commit("q", 0, 0, 1, [b"x"]) == 1
    assert spool.read("q", 0, 0) == [b"x"]


def test_spool_release_tombstone(tmp_path):
    """A late loser attempt completing after the query released its
    spool must not resurrect the query dir (disk leak until TTL)."""
    spool = LocalDirSpool(str(tmp_path))
    spool.commit("q", 0, 0, 0, [b"x"])
    spool.release("q")
    spool.commit("q", 0, 0, 1, [b"y"])
    assert spool.read("q", 0, 0) is None
    assert not (tmp_path / "q").exists()


def test_spool_ttl_cleanup(tmp_path):
    import os
    spool = LocalDirSpool(str(tmp_path), ttl_s=3600)
    spool.commit("old_query", 0, 0, 0, [b"x"])
    spool.commit("new_query", 0, 0, 0, [b"y"])
    stale = time.time() - 7200
    os.utime(tmp_path / "old_query", (stale, stale))
    assert spool.cleanup() == 1
    assert spool.read("old_query", 0, 0) is None
    assert spool.read("new_query", 0, 0) == [b"y"]


# --------------------------------------------------------------------------
# retry policy engine
# --------------------------------------------------------------------------

def test_retry_policy_from_session():
    s = Session()
    assert not RetryPolicy.from_session(s).enabled
    s.set("retry_policy", "TASK")
    s.set("task_retry_attempts", 3)
    s.set("retry_initial_delay_ms", 10)
    p = RetryPolicy.from_session(s)
    assert p.enabled and p.task_retry_attempts == 3
    assert p.backoff_initial_s == pytest.approx(0.01)


def test_retry_controller_budgets():
    p = RetryPolicy(policy="TASK", task_retry_attempts=3,
                    query_retry_attempts=3)
    c = RetryController(p)
    # task budget: 3 total attempts = 2 retries
    assert c.record_failure((0, 0))
    assert c.record_failure((0, 0))
    assert not c.record_failure((0, 0))
    # query budget: 3 extra attempts already spent (2 retries + 1 spec)
    assert c.grant_speculation((0, 1))
    assert not c.record_failure((0, 1))
    assert c.retries_granted == 3

    none = RetryController(RetryPolicy())
    assert not none.record_failure((0, 0))   # NONE: no retries, ever
    # speculation is orthogonal to the retry policy (budget-bounded)
    assert none.grant_speculation((0, 0))


def test_backoff_deterministic_and_bounded():
    p = RetryPolicy(policy="TASK", backoff_initial_s=0.1,
                    backoff_max_s=1.0)
    d1 = backoff_delay(p, 1, "q.0.0")
    assert d1 == backoff_delay(p, 1, "q.0.0")      # deterministic
    assert 0.05 <= d1 < 0.1                        # jitter in [0.5, 1)
    assert d1 != backoff_delay(p, 1, "q.0.1")      # de-correlated
    assert backoff_delay(p, 9, "q.0.0") < 1.0      # capped
    tp = tpu_retry.RetryPolicy(policy="TASK", backoff_initial_s=0.1,
                               backoff_max_s=1.0)
    for attempt in range(1, 10):
        for key in ("q.0.0", "q.0.1", "abc.3.7"):
            assert backoff_delay(p, attempt, key) == \
                tpu_retry.backoff_delay(tp, attempt, key)


def test_pick_worker_rotation_and_exclusions():
    # attempt 0 lands on the home worker
    assert pick_worker(3, home=1, attempt=0) == 1
    # a retry moves off the home worker deterministically
    assert pick_worker(3, home=1, attempt=1) == 2
    # excluded workers are skipped...
    assert pick_worker(3, 1, 1, excluded=frozenset({2})) == 0
    # ...the detector's dead nodes too...
    assert pick_worker(3, 1, 1, excluded=frozenset({2}),
                       is_alive=lambda wi: wi != 0) == 1
    # ...and with everything excluded the scheduler still gets a slot
    assert pick_worker(2, 0, 1, excluded=frozenset({0, 1})) == 1
    for n in (1, 2, 3, 5):
        for home in range(n):
            for attempt in range(4):
                for ex in (frozenset(), frozenset({0}),
                           frozenset({1, 2})):
                    assert pick_worker(n, home, attempt, ex) == \
                        tpu_retry.pick_worker(n, home, attempt, ex)


def test_straggler_detector():
    d = StragglerDetector(multiplier=2.0, min_samples=2,
                          min_runtime_s=0.1)
    assert not d.is_straggler(0, 60.0)     # no samples yet
    d.record(0, 0.2)
    assert not d.is_straggler(0, 60.0)     # below min_samples
    d.record(0, 0.3)
    assert d.median(0) == pytest.approx(0.3)
    assert not d.is_straggler(0, 0.05)     # under the absolute floor
    assert not d.is_straggler(0, 0.5)      # under 2x median
    assert d.is_straggler(0, 0.7)
    assert not d.is_straggler(1, 0.7)      # other fragments unaffected


def test_failure_detector_verdict_expires_when_stale():
    """A feedback-only detector (no probe loop) must not exclude a
    node forever on transient task failures: after four quiet decay
    windows the stale verdict expires and the node earns a fresh
    chance."""
    det = HeartbeatFailureDetector(warmup_probes=1)
    det.record_task_failure("http://w1", "boom")
    assert "http://w1" in det.failed()
    st = det._stats["http://w1"]
    st.last_update = time.time() - 4.1 * st.decay_seconds
    assert det.is_alive("http://w1")


# --------------------------------------------------------------------------
# fault injection: kill / 500 / hang a worker mid-query
# --------------------------------------------------------------------------

class _QuietServer(ThreadingHTTPServer):
    def handle_error(self, request, client_address):   # injected faults
        pass                                           # are not noise


class _FaultyWorker:
    """A fake worker that accepts task POSTs, then sabotages the
    results pull: mode 'kill' drops the connection and stops serving
    (a worker process dying mid-query), '500' answers every pull with
    an injected error, 'hang' answers 202 forever (a wedged task)."""

    def __init__(self, mode: str):
        faulty = self

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
                if faulty.mode == "hang":
                    self.send_response(202)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if faulty.mode == "500":
                    self.send_error(500, "injected worker failure")
                    return
                # kill: die mid-request, then refuse all connections.
                # SHUT_RDWR forces an immediate EOF/RST on the client
                # side — without it a half-closed socket can leave the
                # puller blocked until its per-request timeout
                import socket as _socket
                threading.Thread(target=faulty.httpd.shutdown,
                                 daemon=True).start()
                try:
                    self.connection.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                raise ConnectionResetError("killed mid-query")

            def do_DELETE(self):
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.mode = mode
        self.httpd = _QuietServer(("127.0.0.1", 0), Handler)
        self.base_uri = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except OSError:
            pass


@pytest.fixture(scope="module")
def workers():
    """Two REAL in-process worker servers (full HTTP + serde path)."""
    w1 = TaskWorkerServer(device="cpu").start()
    w2 = TaskWorkerServer(device="cpu").start()
    yield [w1.base_uri, w2.base_uri]
    w1.stop()
    w2.stop()


@pytest.fixture(scope="module")
def expected():
    return TpuRunner(
        session=TpuSession(catalog="tpch", schema="tiny")).execute(SQL)


def _task_session(**props) -> Session:
    s = Session(catalog="tpch", schema="tiny")
    s.set("retry_policy", "TASK")
    s.set("retry_initial_delay_ms", 10)
    # bound every attempt so a worst-case half-open socket on an
    # injected fault resolves in seconds, not the 600s default
    s.set("remote_task_timeout", 30)
    for k, v in props.items():
        s.set(k, v)
    return s


def test_worker_killed_mid_query_retries_and_completes(workers,
                                                       expected):
    """The acceptance scenario: one worker dies mid-execution; under
    retry_policy=TASK the query completes with the SAME result as the
    no-failure run, the retry shows in task_retries_total, and the
    query trace carries a retry span."""
    killed = _FaultyWorker("kill")
    detector = HeartbeatFailureDetector(warmup_probes=1)
    before = _counter("trino_tpu_task_retries_total")
    try:
        runner = _dist(
            [killed.base_uri] + workers,
            session=_task_session(),
            collect_node_stats=True, failure_detector=detector)
        res = runner.execute(SQL)
    finally:
        killed.stop()
    no_failure = _dist(
        workers, session=_task_session()).execute(SQL)
    assert res.rows == no_failure.rows == expected.rows
    assert _counter("trino_tpu_task_retries_total") > before
    # the failure fed the heartbeat detector (scheduler feedback path)
    assert killed.base_uri in detector.failed()
    # ...and the retry is visible in the span tree
    names = []

    def walk(spans):
        for sp in spans:
            names.append(sp["name"])
            walk(sp.get("children", []))

    walk(res.trace.to_dicts())
    assert any(n.endswith("_retry") for n in names), names
    assert any(n.endswith("_execute") for n in names), names


def test_retry_policy_none_fails_fast_with_worker_and_fragment(workers):
    flaky = _FaultyWorker("500")
    try:
        runner = _dist(
            [flaky.base_uri] + workers,
            session=Session(catalog="tpch", schema="tiny"))
        with pytest.raises(QueryError) as e:
            runner.execute(SQL)
        msg = str(e.value)
        assert flaky.base_uri in msg        # WHICH worker died...
        assert "fragment" in msg            # ...running WHAT
    finally:
        flaky.stop()


def test_wedged_worker_times_out_and_retries(workers, expected):
    """A hung results pull turns into a retriable failure via
    remote_task_timeout instead of wedging the query."""
    hung = _FaultyWorker("hang")
    try:
        runner = _dist(
            [hung.base_uri] + workers,
            session=_task_session(remote_task_timeout=1))
        res = runner.execute(SQL)
    finally:
        hung.stop()
    assert res.rows == expected.rows


def test_speculation_rescues_straggler(workers, expected):
    """First-completion-wins: the task stuck on the hung worker is
    speculatively re-dispatched once its elapsed time passes the
    fragment median multiple; the duplicate's result lands, the
    straggler's eventual output would be discarded."""
    hung = _FaultyWorker("hang")
    wins_before = _counter("trino_tpu_speculative_wins_total")
    try:
        # flat-path pin: this exercises the leaf-fragment scheduler's
        # speculation machinery (the explicit fallback; the stage-path twin
        # lives in test_torch_stage_mpp). Under the
        # stage scheduler a 202-forever status poll is a malformed
        # status, failing the attempt into a plain retry instead of a
        # page-pull wedge.
        runner = _dist(
            [hung.base_uri] + workers,
            session=_task_session(multistage_execution=False,
                                  speculation_enabled=True,
                                  speculation_multiplier=1.5,
                                  speculation_min_runtime_ms=100))
        res = runner.execute(SQL)
    finally:
        hung.stop()
    assert res.rows == expected.rows
    assert _counter("trino_tpu_speculative_wins_total") > wins_before


def test_retry_budget_exhaustion_fails_query(workers):
    """Every worker poisoned: TASK retries burn the budget and the
    query fails with the attempt history, not an infinite loop."""
    f1, f2 = _FaultyWorker("500"), _FaultyWorker("500")
    try:
        runner = _dist(
            [f1.base_uri, f2.base_uri],
            session=_task_session(task_retry_attempts=2))
        with pytest.raises(QueryError, match="remote task failed"):
            runner.execute(SQL)
    finally:
        f1.stop()
        f2.stop()


# --------------------------------------------------------------------------
# worker-side spool endpoint + attempt ids
# --------------------------------------------------------------------------

def test_worker_spool_endpoint_survives_task_eviction():
    srv = TaskWorkerServer(device="cpu").start()
    try:
        client = RemoteTaskClient(srv.base_uri)
        client._post("spooled-task", {
            "sql": "SELECT 1 AS x", "catalog": "tpch",
            "schema": "tiny", "spool": True, "attempt": 1})
        first = client.pages("spooled-task", device="cpu")
        assert srv.get_task("spooled-task").attempt == 1
        assert client.status("spooled-task")["attempt"] == 1
        client.abort("spooled-task")          # evict from memory
        assert srv.get_task("spooled-task") is None
        # pages_raw falls back to /v1/spool on the 404 transparently
        again = client.pages("spooled-task", device="cpu")
        assert [b.to_pylist() for b in again] \
            == [b.to_pylist() for b in first]
    finally:
        srv.stop()


# --------------------------------------------------------------------------
# pluggable spool backends: one idempotency/TTL contract, two backends
# --------------------------------------------------------------------------

@pytest.fixture(params=["local", "memory"])
def any_spool(request, tmp_path):
    """Each backend under the IDENTICAL suite: the local directory tree
    and the object-store code path must be interchangeable behind the
    SpoolManager contract. ``.age(query_id, seconds)`` backdates a
    query's spooled state for the TTL tests."""
    if request.param == "local":
        import os
        spool = LocalDirSpool(str(tmp_path), ttl_s=3600)

        def age(query_id, seconds):
            stale = time.time() - seconds
            os.utime(tmp_path / query_id, (stale, stale))
    else:
        from trino_tpu_torch.fte.objectstore import (InMemoryObjectStore,
                                               ObjectStoreSpool)
        store = InMemoryObjectStore()
        spool = ObjectStoreSpool(store, ttl_s=3600, max_attempts=3,
                                 backoff_initial_s=0.001)

        def age(query_id, seconds):
            with store._lock:
                for k, (data, mt) in list(store._objects.items()):
                    if k.startswith(f"{query_id}/"):
                        store._objects[k] = (data, mt - seconds)
    spool.age = age
    return spool


def test_spool_backend_commit_read_release(any_spool):
    frames = [b"page-zero", b"page-one"]
    assert any_spool.commit("q1", 0, 0, 0, frames) == 0
    assert any_spool.committed_attempt("q1", 0, 0) == 0
    assert any_spool.read("q1", 0, 0) == frames
    assert any_spool.read("q1", 0, 1) is None    # nothing committed
    any_spool.release("q1")
    assert any_spool.read("q1", 0, 0) is None


def test_spool_backend_first_commit_wins(any_spool):
    before = _counter("trino_tpu_spool_duplicate_attempts_total")
    assert any_spool.commit("q1", 2, 1, 0, [b"winner"]) == 0
    assert any_spool.commit("q1", 2, 1, 1, [b"loser"]) == 0
    assert any_spool.read("q1", 2, 1) == [b"winner"]
    assert _counter(
        "trino_tpu_spool_duplicate_attempts_total") == before + 1


def test_spool_backend_release_tombstone(any_spool):
    """A late loser completing after the query released its spool must
    not resurrect the query's state (leak until TTL)."""
    any_spool.commit("q", 0, 0, 0, [b"x"])
    any_spool.release("q")
    any_spool.commit("q", 0, 0, 1, [b"y"])
    assert any_spool.read("q", 0, 0) is None


def test_spool_backend_ttl(any_spool):
    any_spool.commit("old_query", 0, 0, 0, [b"x"])
    any_spool.commit("new_query", 0, 0, 0, [b"y"])
    any_spool.age("old_query", 7200)
    assert any_spool.cleanup() == 1
    assert any_spool.read("old_query", 0, 0) is None
    assert any_spool.read("new_query", 0, 0) == [b"y"]


def test_spool_backend_frame_at_a_time(any_spool):
    """The /v1/spool serving surface: per-frame reads agree with the
    whole-attempt read, and uncommitted parts answer None."""
    frames = [b"f0", b"f1", b"f2"]
    any_spool.commit("q", 1, 0, 0, frames)
    assert any_spool.frame_count("q", 1, 0) == 3
    assert [any_spool.read_frame("q", 1, 0, i)
            for i in range(3)] == frames
    assert any_spool.frame_count("q", 9, 0) is None


def test_make_spool_backend_selection():
    from trino_tpu_torch.fte.objectstore import ObjectStoreSpool
    from trino_tpu_torch.fte.spool import default_spool, make_spool
    assert isinstance(make_spool("local"), LocalDirSpool)
    assert isinstance(make_spool("memory"), ObjectStoreSpool)
    with pytest.raises(ValueError, match="unknown spool backend"):
        make_spool("s3://not-wired")
    # the process-wide default is a singleton PER backend name
    assert default_spool("memory") is default_spool("memory")
    assert default_spool("local") is not default_spool("memory")


# --------------------------------------------------------------------------
# object-store backend: injected transient faults vs the retry budget
# --------------------------------------------------------------------------

def _mem_spool(max_attempts=4):
    from trino_tpu_torch.fte.objectstore import (InMemoryObjectStore,
                                           ObjectStoreSpool)
    store = InMemoryObjectStore()
    return store, ObjectStoreSpool(store, max_attempts=max_attempts,
                                   backoff_initial_s=0.001)


def test_objectstore_survives_transient_put_get_failures():
    """The acceptance fault: 503-SlowDown-shaped failures on put and
    get resolve inside the bounded retry budget — the commit lands,
    the read returns the committed frames, and the retry counter
    records the recoveries."""
    store, spool = _mem_spool(max_attempts=4)
    retried = _counter("trino_tpu_objectstore_retries_total")
    store.inject_failures(3, ops=["put"])
    assert spool.commit("q", 0, 0, 0, [b"a", b"b"]) == 0
    store.inject_failures(2, ops=["get"])
    assert spool.read("q", 0, 0) == [b"a", b"b"]
    assert _counter("trino_tpu_objectstore_retries_total") >= retried + 5


def test_objectstore_retry_budget_exhausted_raises():
    """A dead bucket fails the attempt (for the task-retry engine to
    handle) instead of hanging the query in an infinite retry loop."""
    from trino_tpu_torch.fte.objectstore import TransientObjectStoreError
    store, spool = _mem_spool(max_attempts=2)
    store.inject_failures(50)
    with pytest.raises(TransientObjectStoreError):
        spool.commit("q", 0, 0, 0, [b"x"])
    # the store heals -> the next attempt goes through untouched
    store.inject_failures(0)
    assert spool.commit("q", 0, 0, 1, [b"x"]) == 1


@pytest.mark.slow      # ~31s: the kill acceptance re-run with the
# object-store spool backend; the primary kill path stays tier-1
def test_worker_killed_with_objectstore_spool_backend(expected):
    """The worker-kill case with the object-store-shaped spool
    active, on the default stage path: the
    workers themselves spool stage output through the bucket
    emulation (each worker's own in-memory store — consumers fall to
    the HTTP partition leg, the cross-host shape), one worker dies
    mid-query, and the query completes exactly with the bucket
    request counter moving."""
    def ops_total():
        return sum(v for _, v in METRICS.counter(
            "trino_tpu_objectstore_requests_total").samples())

    killed = _FaultyWorker("kill")
    w1 = TaskWorkerServer(spool_backend="memory",
                          device="cpu").start()
    w2 = TaskWorkerServer(spool_backend="memory",
                          device="cpu").start()
    ops_before = ops_total()
    retries_before = _counter("trino_tpu_task_retries_total")
    try:
        runner = _dist(
            [killed.base_uri, w1.base_uri, w2.base_uri],
            session=_task_session())
        res = runner.execute(SQL)
    finally:
        killed.stop()
        w1.stop()
        w2.stop()
    assert res.rows == expected.rows
    assert ops_total() > ops_before
    assert _counter("trino_tpu_task_retries_total") > retries_before


def test_fte_metrics_exposed(workers, expected):
    """The fault-tolerance families render in the Prometheus exposition
    under the JAX package's names."""
    from trino_tpu_torch.obs.metrics import parse_exposition
    res = _dist(
        workers, session=_task_session()).execute(SQL)
    assert res.rows == expected.rows
    families = parse_exposition(METRICS.render())
    for name in ("trino_tpu_task_retries_total",
                 "trino_tpu_spool_bytes_written_total",
                 "trino_tpu_spool_bytes_read_total",
                 "trino_tpu_speculative_wins_total",
                 "trino_tpu_query_peak_memory_bytes"):
        assert name in families, name
    # a TASK-policy query spools its fragment output through disk
    assert families["trino_tpu_spool_bytes_written_total"][()] > 0
    assert families["trino_tpu_spool_bytes_read_total"][()] > 0
