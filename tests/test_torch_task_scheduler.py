"""The port's worker runtime against the JAX package's: the shared split
scheduler (exec/taskexec.py), live worker memory beats into the
coordinator's pool, cache relief under pressure, BUSY load shedding and
the replicate fetch-once cache, with port workers on the CPU; every
query result is held against the JAX engine's rows. Counterparts of
tests/test_task_scheduler.py.

The reference's own description:
Worker-side multi-query runtime: the shared split
scheduler (exec/taskexec.py), live memory feedback into the cluster
pool, cross-query cache governance under pressure, and the BUSY load
shed.

The acceptance battery lives here: K >> runner-threads concurrent
queries all make progress (no starvation), weighted groups drain
proportional split quanta, and a memory-hog query running ON a worker
is killed with CLUSTER_OUT_OF_MEMORY from worker-streamed live
reservations — its worker task actually DELETEd — while a concurrent
small query completes.
"""

import sys
import threading
import time

import pytest

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession

from trino_tpu_torch.catalog import CatalogManager
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
from trino_tpu_torch.exec.taskexec import (LEVEL_THRESHOLDS_S,
                                     TaskCanceledError, TaskExecutor)
from trino_tpu_torch.obs.metrics import METRICS
from trino_tpu_torch.server.coordinator import QueryTracker
from trino_tpu_torch.server.memory import (ClusterMemoryManager,
                                     ClusterMemoryPool)
from trino_tpu_torch.server.task_worker import (RemoteTaskClient,
                                          TaskWorkerServer)
from trino_tpu_torch.session import Session


def _dist(*args, **kwargs):
    """The port's distributed runner; its combine runs on the CPU."""
    return DistributedHostQueryRunner(*args, device="cpu", **kwargs)


def _counter(name: str, **labels) -> float:
    return METRICS.counter(name).value(**labels)


def _wait_until(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# --------------------------------------------------------------------------
# TaskExecutor units: priority, decay, fair share, no starvation
# --------------------------------------------------------------------------

def test_priority_prefers_weighted_fair_share():
    """Among same-level waiters, the group with the smallest WEIGHTED
    virtual time runs next: after equal raw scheduled seconds, a
    weight-3 group's virtual clock advanced 3x slower, so its task
    outranks the weight-1 group's (the WeightedFairQueue contract
    applied at the worker)."""
    ex = TaskExecutor(1)
    a = ex.register("qa", "qa.t", group="ga", weight=1.0)
    b = ex.register("qb", "qb.t", group="gb", weight=3.0)
    with ex._lock:                      # equal RAW seconds charged
        ex._charge_locked(a, 0.9)       # vtime_ga = 0.9
        ex._charge_locked(b, 0.9)       # vtime_gb = 0.3
    with ex._lock:
        assert ex._key_locked(b) < ex._key_locked(a)
    # equal virtual time (same level): the least-served QUERY runs
    # first, then arrival order
    ex.set_group_vtime("ga", 0.5)
    ex.set_group_vtime("gb", 0.5)
    ex.set_query_seconds("qa", 0.2)
    ex.set_query_seconds("qb", 0.4)
    with ex._lock:
        ka, kb = ex._key_locked(a), ex._key_locked(b)
    assert ka[:2] == kb[:2] and ka < kb
    a.close()
    b.close()


def test_group_share_follows_weight_not_query_count():
    """The reviewer scenario: group A (weight 1) runs FOUR concurrent
    queries, group B (weight 3) runs one — B must still drain ~3x
    A's quanta (share follows WEIGHT, not query count; per-query fair
    share would hand A 4/5 of the worker)."""
    state = {"t": 0.0}
    ex = TaskExecutor(1, clock=lambda: state["t"])
    counts = {"ga": 0, "gb": 0}
    total = [0]
    target = 160
    errs = []

    def body(qid, group, weight):
        try:
            h = ex.register(qid, f"{qid}.t", group=group,
                            weight=weight)
            h.acquire()
            deadline = time.monotonic() + 10
            while len(ex._waiting) + len(ex._running) < 5 \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
            try:
                while total[0] < target:
                    state["t"] += 0.001
                    counts[group] += 1
                    total[0] += 1
                    h.checkpoint()
            finally:
                h.close()
        except Exception as e:      # noqa: BLE001
            errs.append(repr(e))

    threads = [threading.Thread(target=body,
                                args=(f"qa{i}", "ga", 1.0))
               for i in range(4)]
    threads.append(threading.Thread(target=body,
                                    args=("qb", "gb", 3.0)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errs, errs
    ratio = counts["gb"] / max(counts["ga"], 1)
    assert 2.0 <= ratio <= 4.5, (counts, ratio)


def test_multilevel_decay_outranks_weight():
    """A long-running query decays to a higher level and ANY younger
    query's task outranks it, regardless of weights — short queries
    finish fast even next to a heavyweight hog."""
    ex = TaskExecutor(1)
    hog = ex.register("hog", "hog.t", group="etl", weight=100.0)
    fresh = ex.register("fresh", "fresh.t", group="adhoc", weight=1.0)
    ex.set_query_seconds("hog", LEVEL_THRESHOLDS_S[1] + 5.0)
    ex.set_query_seconds("fresh", 0.0)
    with ex._lock:
        assert ex._key_locked(fresh) < ex._key_locked(hog)
        # and the level dominates: even huge weight cannot pull the
        # hog below a level boundary
        assert ex._key_locked(hog)[0] > ex._key_locked(fresh)[0]
    hog.close()
    fresh.close()


def test_weighted_groups_get_proportional_quanta():
    """Two queries contending for ONE runner slot under a
    deterministic clock: the weight-3 group drains ~3x the split
    quanta of the weight-1 group (fair-share drain weighted by
    resource group)."""
    state = {"t": 0.0}
    ex = TaskExecutor(1, clock=lambda: state["t"])
    counts = {"a": 0, "b": 0}
    total = [0]
    target = 120
    errs = []

    def body(name, weight):
        try:
            h = ex.register(f"q{name}", f"q{name}.t",
                            group=f"g{name}", weight=weight)
            h.acquire()
            # handshake: don't start consuming quanta until BOTH
            # tasks contend for the slot (one registered running +
            # one waiting), or the first thread races through its
            # whole budget before the second even spawns
            deadline = time.monotonic() + 10
            while len(ex._waiting) + len(ex._running) < 2 \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
            try:
                while total[0] < target:
                    state["t"] += 0.001   # one quantum of "work"
                    counts[name] += 1     # (only the slot holder runs)
                    total[0] += 1
                    h.checkpoint()
            finally:
                h.close()
        except Exception as e:      # noqa: BLE001
            errs.append(repr(e))

    ta = threading.Thread(target=body, args=("a", 1.0))
    tb = threading.Thread(target=body, args=("b", 3.0))
    ta.start()
    tb.start()
    ta.join(30)
    tb.join(30)
    assert not errs, errs
    assert counts["a"] + counts["b"] >= target
    ratio = counts["b"] / max(counts["a"], 1)
    assert 2.0 <= ratio <= 4.5, (counts, ratio)
    # the fairness observable: per-group quanta counters moved
    assert _counter("trino_tpu_task_scheduler_quanta_total",
                    group="gb") > 0


def test_no_starvation_k_over_runners():
    """K=8 tasks over 2 runner slots: every task completes its quanta
    (no starvation) and the concurrency bound holds throughout."""
    ex = TaskExecutor(2)
    done = []
    max_seen = [0]
    errs = []

    def body(i):
        try:
            h = ex.register(f"q{i}", f"q{i}.t")
            h.acquire()
            try:
                for _ in range(10):
                    max_seen[0] = max(max_seen[0], len(ex._running))
                    time.sleep(0.001)
                    h.checkpoint()
            finally:
                h.close()
            done.append(i)
        except Exception as e:      # noqa: BLE001
            errs.append(repr(e))

    threads = [threading.Thread(target=body, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errs, errs
    assert sorted(done) == list(range(8))
    assert max_seen[0] <= 2, f"concurrency bound violated: {max_seen}"


def test_blocked_scope_releases_slot():
    """A task blocked off-CPU (the exchange-pull shape) holds no
    runner slot: with ONE runner, a second task executes while the
    first waits — bounded runners cannot deadlock a producer behind
    its blocked consumer."""
    ex = TaskExecutor(1)
    release = threading.Event()
    producer_ran = threading.Event()

    def consumer():
        h = ex.register("qc", "qc.t")
        h.acquire()
        try:
            with h.blocked():
                release.wait(10)    # "waiting for upstream commit"
        finally:
            h.close()

    def producer():
        h = ex.register("qp", "qp.t")
        h.acquire()             # must be grantable while qc blocks
        try:
            producer_ran.set()
        finally:
            h.close()

    tc = threading.Thread(target=consumer)
    tc.start()
    _wait_until(lambda: ex.open_tasks() == 1, what="consumer blocked")
    tp = threading.Thread(target=producer)
    tp.start()
    assert producer_ran.wait(5), \
        "producer starved behind a blocked consumer"
    release.set()
    tc.join(10)
    tp.join(10)
    assert ex.open_tasks() == 0


def test_cancel_while_waiting_for_slot_raises():
    """An aborted task waiting for a runner slot unwinds with
    TaskCanceledError instead of waiting forever on a grant it can
    no longer use."""
    ex = TaskExecutor(1)
    hold = threading.Event()
    holder = ex.register("qh", "qh.t")
    holder.acquire()            # pins the only slot
    cancel = threading.Event()
    waiter = ex.register("qw", "qw.t", cancel=cancel)
    err = []

    def wait_for_slot():
        try:
            waiter.acquire()
        except TaskCanceledError as e:
            err.append(e)

    t = threading.Thread(target=wait_for_slot)
    t.start()
    time.sleep(0.1)
    cancel.set()
    t.join(5)
    assert err, "canceled waiter did not unwind"
    holder.close()
    hold.set()
    assert ex.open_tasks() == 0


# --------------------------------------------------------------------------
# live memory feedback: the e2e governance acceptance
# --------------------------------------------------------------------------

def _gated_tpch_catalogs(gate: threading.Event, block_table: str):
    class BlockingTpch(TpchConnector):
        remote_scan_ok = True

        def read_split(self, split, columns):
            if split.handle.table == block_table:
                gate.wait(30)
            return super().read_split(split, columns)

    cats = CatalogManager()
    cats.register("tpch", BlockingTpch(device="cpu"))
    return cats


def test_live_worker_memory_kills_hog_while_small_query_completes():
    """THE acceptance e2e: a memory-hog query running ON a
    worker is killed with CLUSTER_OUT_OF_MEMORY from worker-streamed
    live reservations — NOT coordinator-side estimates (the
    coordinator never executes the hog's scan, so every pool byte it
    holds arrived via status beats) — its worker task is actually
    DELETEd, and a concurrent small query completes."""
    gate = threading.Event()
    cats = _gated_tpch_catalogs(gate, "lineitem")
    worker = TaskWorkerServer(device="cpu", catalogs=cats).start()
    pool = ClusterMemoryPool(1 << 20)          # 1 MiB
    memory = ClusterMemoryManager(pool)
    aborted = METRICS.counter("trino_tpu_worker_tasks_aborted_total")
    beats = METRICS.counter("trino_tpu_worker_live_memory_beats_total")
    kills0 = METRICS.counter("trino_tpu_memory_kills_total").value()
    a0, b0 = aborted.value(), beats.value()
    tracker = QueryTracker(
        lambda s: _dist(
            [worker.base_uri], session=s, catalogs=cats),
        memory=memory)
    try:
        hog_sess = Session(catalog="tpch", schema="tiny")
        # a bare 5-lane scan chain: the worker task reserves its full
        # split share (~2.4MB) BEFORE the gated read blocks, so the
        # live figure is on the wire while the task runs
        hog = tracker.submit(
            "SELECT l_orderkey, l_quantity, l_extendedprice, "
            "l_discount, l_tax FROM lineitem", hog_sess)
        # the worker task reserves its ~2.4MB split share (5 lanes x
        # 60K rows) and blocks in the scan; status beats stream the
        # live reservation into the 1MiB pool -> the killer fires
        assert hog.wait_done(30), "hog never reached a terminal state"
        assert hog.state == "FAILED", hog.error
        assert hog.error["errorName"] == "CLUSTER_OUT_OF_MEMORY"
        assert "low-memory killer" in hog.error["message"]
        assert beats.value() > b0, "no live beats reached the pool"
        assert METRICS.counter(
            "trino_tpu_memory_kills_total").value() == kills0 + 1
        # the kill reached the WORKER: its in-flight task was DELETEd
        _wait_until(lambda: aborted.value() > a0,
                    what="worker-side abort")
        _wait_until(lambda: len(worker._tasks) == 0,
                    what="worker task registry drained")
        # a concurrent small query (same tracker, same pool) completes
        small = tracker.submit("SELECT count(*) FROM region",
                               Session(catalog="tpch", schema="tiny"))
        assert small.wait_done(30)
        assert small.state == "FINISHED", small.error
        assert small.result.rows == [[5]]
    finally:
        gate.set()
        worker.stop()


def test_live_memory_feedback_session_property_gates_beats():
    """live_memory_feedback=false pins the pre-PR-14 behavior: the
    pool sees NO worker-streamed reservations during execution."""
    calls = []

    class Recorder:
        def reserve(self, nbytes):
            pass

        def reserve_remote(self, source, nbytes):
            calls.append((source, nbytes))

    worker = TaskWorkerServer(device="cpu").start()
    try:
        for feedback, expect_calls in ((True, True), (False, False)):
            calls.clear()
            s = Session(catalog="tpch", schema="tiny")
            s.set("live_memory_feedback", feedback)
            s.memory = Recorder()
            # a stage-path join: worker tasks reserve join state, and
            # even a fast task's terminal status poll carries the
            # high-water figure (beats are not timing-dependent)
            res = _dist(
                [worker.base_uri], session=s).execute(
                "SELECT n_name, r_name FROM nation JOIN region "
                "ON n_regionkey = r_regionkey")
            assert len(res.rows) == 25
            assert bool(calls) == expect_calls, (feedback, calls)
    finally:
        worker.stop()


def test_pool_releases_terminal_attempt_sources():
    """Retried attempts and sequential stage tasks must not ACCUMULATE
    dead high-water marks: a terminal attempt's source is cleared, so
    a 600-byte task retried once charges 600 bytes, not 1200."""
    pool = ClusterMemoryPool(1 << 30)
    mine, total = pool.set_reservation("qr", 600, "global",
                                       source="qr.f0.p0.a0")
    assert (mine, total) == (600, 600)
    pool.clear_source("qr", "qr.f0.p0.a0")     # attempt died
    mine, total = pool.set_reservation("qr", 600, "global",
                                       source="qr.f0.p0.a1")
    assert (mine, total) == (600, 600)          # NOT 1200
    # the coordinator source coexists and stays monotonic
    mine, total = pool.set_reservation("qr", 100, "global")
    assert (mine, total) == (700, 700)
    pool.free("qr")
    assert pool.reserved_bytes() == 0


# --------------------------------------------------------------------------
# cross-query cache governance under pressure
# --------------------------------------------------------------------------

def test_pool_pressure_evicts_scan_cache_before_killing():
    """A cache full of one query's tables cannot OOM a neighbor: when
    reservations + cache residency exceed the pool, scan-cache
    entries are evicted FIRST and no query is killed (reservations
    alone stay under the pool)."""
    from trino_tpu_torch.exec.executor import cache_memory_bytes
    from trino_tpu_torch.runner import LocalQueryRunner
    lr = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"),
                          device="cpu")
    lr.execute("SELECT count(*) FROM lineitem")
    cached = cache_memory_bytes()
    assert cached > 0, "scan cache did not populate"
    pool = ClusterMemoryPool(cached + 10_000)
    mgr = ClusterMemoryManager(pool)
    killed = []
    evicted0 = _counter("trino_tpu_cache_pressure_evictions_total",
                        cache="scan")
    ctx = mgr.register("q_cachetest",
                       kill_fn=lambda m, n: killed.append(n))
    ctx.reserve(50_000)     # reservations + cache > pool
    assert cache_memory_bytes() < cached, "no cache relief happened"
    assert not killed and mgr.kills == 0
    assert _counter("trino_tpu_cache_pressure_evictions_total",
                    cache="scan") > evicted0
    mgr.unregister("q_cachetest")


# --------------------------------------------------------------------------
# graceful degradation: the BUSY shed
# --------------------------------------------------------------------------

def test_busy_shed_declines_then_retry_absorbs():
    """A worker past its shed threshold 503s NEW dispatches (known
    tasks are never shed); the scheduler absorbs the decline through
    rotation+backoff without a failure-detector demerit, and the
    query completes."""
    import urllib.error
    import urllib.request
    gate = threading.Event()
    cats = _gated_tpch_catalogs(gate, "lineitem")
    # one runner, shed at 1 open task: the first (blocked) task
    # saturates the worker. ema_s=0 pins the shed signal to the spot
    # open-task count — this test drives an instant saturation, which
    # the default EMA smoothing (deliberately) rides through; the EMA
    # behavior itself is unit-tested with a deterministic clock in
    # test_busy_shed_ema_smooths_bursts
    busy = TaskWorkerServer(device="cpu", catalogs=cats, task_runners=1,
                            busy_shed_factor=1,
                            busy_shed_ema_s=0).start()
    healthy = TaskWorkerServer(device="cpu", catalogs=cats).start()
    rejects = METRICS.counter("trino_tpu_worker_busy_rejections_total")
    r0 = rejects.value()
    try:
        blocker = RemoteTaskClient(busy.base_uri)
        blocker.submit("wedge-task",
                       "SELECT count(*) FROM lineitem")
        _wait_until(lambda: busy.task_executor.open_tasks() >= 1,
                    what="wedge task registered")
        # a NEW dispatch is declined with the retryable 503
        with pytest.raises(urllib.error.HTTPError) as exc:
            RemoteTaskClient(busy.base_uri).submit(
                "shed-me", "SELECT 1 AS x")
        assert exc.value.code == 503
        assert rejects.value() > r0
        # ...but a re-POST of the KNOWN task is idempotent, not shed
        blocker.submit("wedge-task", "SELECT count(*) FROM lineitem")
        # e2e: a query over [busy, healthy] completes — the busy
        # declines rotate to the healthy worker without burning the
        # retry budget or the busy worker's health record
        from trino_tpu_torch.server.failure import HeartbeatFailureDetector
        detector = HeartbeatFailureDetector()
        s = Session(catalog="tpch", schema="tiny")
        s.set("retry_policy", "TASK")
        s.set("retry_initial_delay_ms", 10)
        res = _dist(
            [busy.base_uri, healthy.base_uri], session=s,
            failure_detector=detector,
            catalogs=cats).execute("SELECT count(*) FROM region")
        assert res.rows == [[5]]
        assert busy.base_uri not in detector.failed()
    finally:
        gate.set()
        busy.stop()
        healthy.stop()


# --------------------------------------------------------------------------
# replicate exchange: per-worker fetch-once cache
# --------------------------------------------------------------------------

def test_replicate_fetch_once_cache_unit(tmp_path):
    """Two consumer tasks pulling the same replicate frame: the
    second is served from the per-worker cache (one fetch per worker,
    not one per task); first-commit-wins makes the bytes immutable so
    the cache can never serve stale frames."""
    from trino_tpu_torch.fte.spool import LocalDirSpool
    from trino_tpu_torch.stage.exchange import (ExchangePuller,
                                                evict_replicate_cache,
                                                replicate_cache_bytes)
    evict_replicate_cache(None)
    spool = LocalDirSpool(str(tmp_path))
    from trino_tpu_torch.serde import serialize_batch
    from trino_tpu_torch.columnar import batch_from_pylist
    from trino_tpu_torch.types import BIGINT
    frame = serialize_batch(batch_from_pylist(
        {"x": [1, 2, 3]}, {"x": BIGINT}, device="cpu"))
    spool.commit("qr.s0.p0", 0, 0, 0, [frame])
    sources = {"0": {"tasks": ["qr.s0.p0"], "uris": [None],
                     "kind": "replicate", "candidates": [],
                     "eager": False}}
    hits0 = _counter("trino_tpu_exchange_replicate_cache_total",
                     result="hit")
    out1 = ExchangePuller(sources, part=0, spool=spool,
                          device="cpu").read_fragment(0)
    assert replicate_cache_bytes() == len(frame)
    # the second consumer (different part) needs NO spool/HTTP at all
    out2 = ExchangePuller(sources, part=1, spool=None,
                          device="cpu").read_fragment(0)
    assert _counter("trino_tpu_exchange_replicate_cache_total",
                    result="hit") == hits0 + 1
    assert out1[0].to_pylist() == out2[0].to_pylist() \
        == [[1], [2], [3]]
    # pressure governance clears it
    assert evict_replicate_cache(None) == len(frame)
    assert replicate_cache_bytes() == 0


def test_replicate_cache_single_flight(monkeypatch):
    """Eight consumer tasks reading one replicate key at once: one pull,
    seven hits, the same bytes for all; a failed pull caches nothing and
    its waiters pull for themselves."""
    from trino_tpu_torch.columnar import batch_from_pylist
    from trino_tpu_torch.serde import serialize_batch
    from trino_tpu_torch.stage import exchange
    from trino_tpu_torch.types import BIGINT
    exchange.evict_replicate_cache(None)
    frame = serialize_batch(batch_from_pylist(
        {"x": [4, 5, 6]}, {"x": BIGINT}, device="cpu"))
    pulls = []
    fail = [False]

    def stub(self, key, uri, index=None, candidates=None, eager=False):
        pulls.append(key)
        time.sleep(0.2)
        if fail[0]:
            raise RuntimeError("producer lost")
        return frame

    monkeypatch.setattr(exchange.ExchangePuller, "pull_frame", stub)
    sources = {"0": {"tasks": ["sf.s0.p0"], "uris": [None],
                     "kind": "replicate", "candidates": [],
                     "eager": False}}
    n = 8
    barrier = threading.Barrier(n)
    out, errors = [None] * n, []

    def consumer(i):
        barrier.wait()
        try:
            out[i] = exchange.ExchangePuller(
                sources, part=i, device="cpu").read_fragment(0)
        except Exception as e:      # noqa: BLE001
            errors.append(e)

    def run_all():
        threads = [threading.Thread(target=consumer, args=(i,))
                   for i in range(n)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)

    hits0 = _counter("trino_tpu_exchange_replicate_cache_total",
                     result="hit")
    miss0 = _counter("trino_tpu_exchange_replicate_cache_total",
                     result="miss")
    run_all()
    assert not errors
    assert pulls == ["sf.s0.p0"]
    assert _counter("trino_tpu_exchange_replicate_cache_total",
                    result="hit") == hits0 + 7
    assert _counter("trino_tpu_exchange_replicate_cache_total",
                    result="miss") == miss0 + 1
    assert all(o[0].to_pylist() == [[4], [5], [6]] for o in out)
    assert exchange.replicate_cache_bytes() == len(frame)
    # a failing pull is never cached: every reader ends up pulling
    exchange.evict_replicate_cache(None)
    pulls.clear()
    fail[0] = True
    barrier = threading.Barrier(n)
    run_all()
    assert len(errors) == n and len(pulls) == n
    assert exchange.replicate_cache_bytes() == 0
    assert not exchange._REPL_INFLIGHT


def test_replicate_cache_e2e_semi_join():
    """A semi join's replicated filtering side over THREE consumer
    tasks (one per worker, all in this process sharing the fetch-once
    cache): the cache takes re-pulls off the exchange and the result
    is exact. Barrier mode, so the committed frames are pulled at
    consumer starts staggered by task dispatch."""
    from trino_tpu_torch.stage.exchange import (evict_replicate_cache,
                                          replicate_cache_bytes)
    evict_replicate_cache(None)
    workers = [TaskWorkerServer(device="cpu").start() for _ in range(3)]
    sql = ("SELECT n_name FROM nation WHERE n_regionkey IN "
           "(SELECT r_regionkey FROM region WHERE r_name = 'ASIA') "
           "ORDER BY n_name")
    try:
        expected = TpuRunner(session=TpuSession(
            catalog="tpch", schema="tiny")).execute(sql)
        hits0 = _counter("trino_tpu_exchange_replicate_cache_total",
                         result="hit")
        s = Session(catalog="tpch", schema="tiny")
        s.set("stage_pipelining", False)
        res = _dist(
            [w.base_uri for w in workers], session=s).execute(sql)
        assert res.rows == expected.rows
        # the broadcast frames were cached per worker PROCESS...
        assert replicate_cache_bytes() > 0
        # ...and sibling consumer tasks were served from the cache
        assert _counter("trino_tpu_exchange_replicate_cache_total",
                        result="hit") > hits0
    finally:
        for w in workers:
            w.stop()
