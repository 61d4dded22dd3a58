"""The port's streaming ingestion and continuous queries against the JAX
package's, on the CPU: the message log (streaming/log.py), the offset
store (streaming/offsets.py), the stream connector's SQL surface
(connectors/stream.py) and the continuous-query manager
(streaming/continuous.py), with the coordinator and worker HTTP routes.
Counterparts of tests/test_streaming.py: each case runs the same
messages, SQL and seeds through both packages, each over a stream
directory of its own, and holds the port's observations to the JAX
package's (integers and strings exact, doubles to rel 1e-9) and to the
reference test's own expectations. Then each package reads a topic and
loads offset epochs the other wrote.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("jax", "torch")


def _ns(which: str) -> SimpleNamespace:
    """One package's streaming surface under common names; the port's
    entry points on the CPU."""
    if which == "jax":
        from trino_tpu import config
        from trino_tpu.client import StatementClient
        from trino_tpu.connectors import stream
        from trino_tpu.fte import faultpoints, spool
        from trino_tpu.runner import LocalQueryRunner
        from trino_tpu.server.coordinator import Coordinator
        from trino_tpu.server.task_worker import TaskWorkerServer
        from trino_tpu.streaming import continuous, log, offsets
        return SimpleNamespace(
            name=which, CONFIG=config.CONFIG, stream=stream, log=log,
            offsets=offsets, spool=spool, faults=faultpoints,
            StatementClient=StatementClient,
            runner=lambda: LocalQueryRunner(with_tpch=False),
            manager=continuous.ContinuousQueryManager,
            coordinator=Coordinator, worker=TaskWorkerServer)
    from trino_tpu_torch import config
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.connectors import stream
    from trino_tpu_torch.fte import faultpoints, spool
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.server.coordinator import Coordinator
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    from trino_tpu_torch.streaming import continuous, log, offsets

    def manager(*a, **kw):
        return continuous.ContinuousQueryManager(*a, device="cpu", **kw)

    def coordinator(*a, **kw):
        return Coordinator(*a, device="cpu", **kw)

    def worker(*a, **kw):
        return TaskWorkerServer(*a, device="cpu", **kw)
    return SimpleNamespace(
        name=which, CONFIG=config.CONFIG, stream=stream, log=log,
        offsets=offsets, spool=spool, faults=faultpoints,
        StatementClient=StatementClient,
        runner=lambda: LocalQueryRunner(device="cpu"),
        manager=manager, coordinator=coordinator, worker=worker)


def both(scenario, tmp_path, monkeypatch, **kw):
    """``scenario(m, d, **kw)`` for each package (``m`` its namespace,
    ``d`` a directory of its own, CONFIG.stream_dir under it); asserts
    the two results equal and returns the port's."""
    out = {}
    for which in PKGS:
        m = _ns(which)
        d = tmp_path / which
        d.mkdir()
        monkeypatch.setattr(m.CONFIG, "stream_dir", str(d / "stream"))
        out[which] = scenario(m, d, **kw)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _wait_until(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _post(uri, body=b"", method="POST"):
    req = urllib.request.Request(uri, data=body or None, method=method)
    with urllib.request.urlopen(req, timeout=15) as resp:
        return json.load(resp)


def _doc(**kw) -> bytes:
    return json.dumps(kw).encode()


# --- message log (streaming/log.py) ----------------------------------------

def test_log_append_read_roundtrip(tmp_path, monkeypatch):
    def scenario(m, d):
        log = m.log.MessageLog(str(d / "stream"))
        log.create_topic("t", partitions=2)
        got = [log.append("t", [b"a", b"b"], partition=0),
               log.append("t", [b"c"], partition=0),
               log.append("t", [b"z"], partition=1),
               log.read("t", 0, 0, 3), log.read("t", 0, 1, 2),
               log.read("t", 0, 2, 99), log.read("t", 1, 0, 1),
               log.end_offsets("t"), log.data_version()]
        return got
    got = both(scenario, tmp_path, monkeypatch)
    assert got[:8] == [{0: (0, 2)}, {0: (2, 3)}, {1: (0, 1)},
                       [b"a", b"b", b"c"], [b"b"], [b"c"], [b"z"],
                       {0: 3, 1: 1}]
    assert got[8] > 0


def test_log_key_and_round_robin_routing(tmp_path, monkeypatch):
    def scenario(m, d):
        log = m.log.MessageLog(str(d / "stream"))
        log.create_topic("t", partitions=4)
        (p1,) = log.append("t", [b"x"], key="user-1")
        (p2,) = log.append("t", [b"y"], key="user-1")
        hit = [next(iter(log.append("t", [b"m"]))) for _ in range(8)]
        with pytest.raises(ValueError, match="out of range"):
            log.append("t", [b"m"], partition=9)
        return p1, p2, hit
    p1, p2, hit = both(scenario, tmp_path, monkeypatch)
    # the same key, the same partition (crc32, equal in both packages)
    assert p1 == p2
    assert len(set(hit)) == 4


def test_log_torn_tail_refused(tmp_path, monkeypatch):
    def scenario(m, d):
        base = str(d / "stream")
        log = m.log.MessageLog(base)
        log.create_topic("t", partitions=1)
        log.append("t", [b"complete-1", b"complete-2"], partition=0)
        with open(os.path.join(base, "t", "p0.log"), "ab") as f:
            f.write(b"\x00\x00\x00\x63only-partial")   # claims 99 bytes
        fresh = m.log.MessageLog(base)
        return fresh.end_offsets("t"), fresh.read("t", 0, 0, 10)
    assert both(scenario, tmp_path, monkeypatch) == (
        {0: 2}, [b"complete-1", b"complete-2"])


def test_log_cross_instance_visibility(tmp_path, monkeypatch):
    def scenario(m, d):
        base = str(d / "stream")
        a, b = m.log.MessageLog(base), m.log.MessageLog(base)
        a.create_topic("t", partitions=1)
        a.append("t", [b"from-a"], partition=0)
        first = b.read("t", 0, 0, 1)
        b.append("t", [b"from-b"], partition=0)
        return (first, a.read("t", 0, 0, 2),
                m.log.get_log(base) is m.log.get_log(base))
    assert both(scenario, tmp_path, monkeypatch) == (
        [b"from-a"], [b"from-a", b"from-b"], True)


def test_log_topic_validation_and_idempotent_create(tmp_path, monkeypatch):
    def scenario(m, d):
        log = m.log.MessageLog(str(d / "stream"))
        for bad in ("", "a/b", "a\\b", "a$b", ".hidden"):
            with pytest.raises(ValueError):
                log.create_topic(bad)
        cfg = log.create_topic("t", fields=[("k", "bigint", None)],
                               partitions=3)
        again = log.create_topic("t", fields=[("other", "double", None)],
                                 partitions=9)
        topics = log.topics()
        log.drop_topic("t")
        return cfg, again, topics, log.topics()
    cfg, again, topics, after = both(scenario, tmp_path, monkeypatch)
    assert again == cfg and again["partitions"] == 3
    assert topics == ["t"] and after == []


def test_ingest_http_helper_routes_and_counts(tmp_path, monkeypatch):
    def scenario(m, d):
        log = m.log.MessageLog(str(d / "stream"))
        log.create_topic("t", partitions=2)
        out = m.log.ingest_http(log, "t", b"one\ntwo\n\nthree",
                                {"partition": ["1"]})
        return out, m.log.ingest_http(log, "t", b"", {})["count"]
    out, empty = both(scenario, tmp_path, monkeypatch)
    assert out["count"] == 3 and out["ranges"] == {"1": [0, 3]}
    assert out["endOffsets"] == {"0": 0, "1": 3}
    assert empty == 0


# --- offset store (streaming/offsets.py) -----------------------------------

def _spool(m, d):
    return m.spool.make_spool("local", local_base_dir=str(d / "spool"))


def test_offsets_commit_load_and_cold_replay(tmp_path, monkeypatch):
    def scenario(m, d):
        spool = _spool(m, d)
        store = m.offsets.OffsetStore(spool)
        got = [store.load("job1"),
               store.commit("job1", 1, {"t": {0: 5, 1: 2}}),
               store.commit("job1", 2, {"t": {0: 9, 1: 2}}),
               store.load("job1")]
        cold = m.offsets.OffsetStore(spool)
        got += [cold.load("job1"), cold.load("job2")]
        store.release("job1")
        got.append(m.offsets.OffsetStore(spool).load("job1"))
        return got
    assert both(scenario, tmp_path, monkeypatch) == [
        (0, {}), True, True, (2, {"t": {0: 9, 1: 2}}),
        (2, {"t": {0: 9, 1: 2}}), (0, {}), (0, {})]


def test_offsets_first_commit_wins(tmp_path, monkeypatch):
    def scenario(m, d):
        spool = _spool(m, d)
        frame = json.dumps({"epoch": 1, "offsets": {"t": {0: 7}}}).encode()
        spool.commit("stream.job1", m.offsets.OFFSETS_FRAGMENT, 1,
                     os.getpid() + 1, [frame])
        store = m.offsets.OffsetStore(spool)
        return (store.commit("job1", 1, {"t": {0: 999}}),
                store.load("job1"))
    assert both(scenario, tmp_path, monkeypatch) == (False, (1, {"t": {0: 7}}))


def test_offsets_consumer_name_validation(tmp_path, monkeypatch):
    def scenario(m, d):
        store = m.offsets.OffsetStore(_spool(m, d))
        with pytest.raises(ValueError):
            store.commit("", 1, {})
        with pytest.raises(ValueError):
            store.load("a/b")
        return m.offsets.OFFSETS_FRAGMENT
    assert both(scenario, tmp_path, monkeypatch) == -3


# --- window refs -----------------------------------------------------------

def test_window_ref_roundtrip(tmp_path, monkeypatch):
    def scenario(m, d):
        w = {0: (10, 20), 1: (0, 15)}
        ref = m.stream.window_ref("events", w, "job1")
        return (ref, m.stream.parse_table_ref(ref),
                m.stream.parse_table_ref("events"),
                m.stream.parse_table_ref(m.stream.window_ref("e", {})))
    assert both(scenario, tmp_path, monkeypatch) == (
        "events$win.0:10:20,1:0:15#job1",
        ("events", {0: (10, 20), 1: (0, 15)}), ("events", None),
        ("e", {}))


# --- stream connector via SQL (connectors/stream.py) -----------------------

def _events_runner(m):
    r = m.runner()
    r.execute("CREATE TABLE stream.default.events "
              "(k BIGINT, v DOUBLE, ts DOUBLE)")
    return r


def test_stream_scan_window_and_ledger_columns(tmp_path, monkeypatch):
    def scenario(m, d):
        r = _events_runner(m)
        log = m.log.get_log(str(d / "stream"))
        for i in range(6):
            log.append("events", [_doc(k=i % 2, v=float(i), ts=i / 10.0)],
                       partition=i % 2)
        ref = m.stream.window_ref("events", {0: (1, 3), 1: (0, 1)})
        got = [r.execute("SELECT count(*) FROM stream.default.events").rows,
               r.execute(f'SELECT count(*) FROM stream.default."{ref}"').rows,
               r.execute("SELECT _partition, count(*) c, max(_offset) mx "
                         "FROM stream.default.events GROUP BY _partition "
                         "ORDER BY _partition").rows,
               r.execute("SELECT k, v, ts, _partition, _offset FROM "
                         "stream.default.events ORDER BY _partition, "
                         "_offset").rows]
        log.append("events", [b"not json at all"], partition=0)
        got.append(r.execute("SELECT count(*) FROM stream.default.events "
                             "WHERE k IS NULL").rows)
        return got
    got = both(scenario, tmp_path, monkeypatch)
    assert got[0] == [[6]] and got[1] == [[3]]
    assert got[2] == [[0, 3, 2], [1, 3, 2]]
    assert got[4] == [[1]]


def test_stream_sql_insert_and_schemaless_topic(tmp_path, monkeypatch):
    def scenario(m, d):
        r = _events_runner(m)
        r.execute("INSERT INTO stream.default.events "
                  "VALUES (1, 1.5, 0.1), (2, 2.5, 0.2)")
        got = [r.execute("SELECT sum(v) FROM stream.default.events").rows]
        m.log.get_log(str(d / "stream")).append("bare", [b"hello",
                                                        b"world"])
        rows = r.execute("SELECT _message FROM stream.default.bare "
                         "ORDER BY _offset, _partition").rows
        got.append(sorted(row[0] for row in rows))
        with pytest.raises(Exception, match="reserved"):
            r.execute("CREATE TABLE stream.default.bad (_offset BIGINT)")
        return got
    assert both(scenario, tmp_path, monkeypatch) == [[[4.0]],
                                                     ["hello", "world"]]


# --- continuous query manager (streaming/continuous.py) --------------------

def _mk_manager(m, runner, d, jobs_path=None):
    """A manager over a runner. The runner is not thread-safe (shared
    Session), so cycles and the test's own queries take one lock."""
    lock = threading.Lock()

    def run_sql(sql):
        with lock:
            return runner.execute(sql)
    mgr = m.manager(run_sql, runner.catalogs,
                    m.offsets.OffsetStore(_spool(m, d)),
                    jobs_path=jobs_path, log=m.log.get_log())
    return mgr, run_sql


def _count(run_sql, table: str) -> int:
    """count(*) of ``table``; 0 while it does not exist yet."""
    try:
        return run_sql(f"SELECT count(*) FROM {table}").rows[0][0]
    except Exception:           # noqa: BLE001 — not created yet
        return 0


def _rows(run_sql, sql: str):
    """The rows of ``sql``; None while its table does not exist yet."""
    try:
        return run_sql(sql).rows
    except Exception:           # noqa: BLE001 — not created yet
        return None


_SINK_SQL = ("INSERT INTO memory.default.sink SELECT _partition, _offset, v "
             "FROM stream.default.events")


def test_continuous_insert_exactly_once(tmp_path, monkeypatch):
    def scenario(m, d):
        r = _events_runner(m)
        r.execute("CREATE TABLE memory.default.sink "
                  "(p BIGINT, o BIGINT, v DOUBLE)")
        mgr, run_sql = _mk_manager(m, r, d)
        log = m.log.get_log(str(d / "stream"))
        try:
            job = mgr.create({"kind": "insert", "topic": "events",
                              "poll_interval_ms": 100, "sql": _SINK_SQL})
            total = 0
            for burst in range(3):
                for i in range(10):
                    log.append("events", [_doc(k=i, v=float(i),
                                               ts=i * 1.0)])
                total += 10
                want = total
                _wait_until(lambda: run_sql(
                    "SELECT count(*) FROM memory.default.sink"
                ).rows[0][0] >= want, what=f"burst {burst} drained")
            got = [run_sql("SELECT count(*), count(DISTINCT p * 1000000 "
                           "+ o), sum(v) FROM memory.default.sink").rows[0]]
            # rows_total moves a beat after the INSERT lands
            _wait_until(lambda: mgr.get(job["job_id"])["rows_total"] >= 30,
                        what="rows_total")
            info = mgr.get(job["job_id"])
            got += [info["rows_total"], info["last_epoch"] >= 3,
                    info["state"], mgr.cancel(job["job_id"])]
            _wait_until(lambda: not mgr._threads[job["job_id"]].is_alive(),
                        what="job thread exit")
            got += [mgr.get(job["job_id"])["state"], mgr.cancel("cq_nope")]
            return got
        finally:
            mgr.stop()
    assert both(scenario, tmp_path, monkeypatch) == [
        [30, 30, 135.0], 30, True, "RUNNING", True, "CANCELED", False]


def test_continuous_view_refresh(tmp_path, monkeypatch):
    def scenario(m, d):
        r = _events_runner(m)
        mgr, run_sql = _mk_manager(m, r, d)
        log = m.log.get_log(str(d / "stream"))
        try:
            mgr.create({"kind": "view", "target": "memory.default.mv",
                        "poll_interval_ms": 100,
                        "sql": "SELECT k, count(*) c FROM "
                               "stream.default.events GROUP BY k"})
            log.append("events", [_doc(k=1, v=0.0, ts=0.0)] * 4)
            # the first cycle creates the target: until it has, the
            # count is 0
            _wait_until(lambda: _count(run_sql, "memory.default.mv") > 0,
                        what="mv materialized")
            got = [run_sql("SELECT c FROM memory.default.mv "
                           "WHERE k = 1").rows]
            log.append("events", [_doc(k=2, v=0.0, ts=0.0)])
            _wait_until(lambda: run_sql(
                "SELECT count(*) FROM memory.default.mv").rows[0][0] == 2,
                what="mv re-rollup")
            got.append(run_sql("SELECT k, c FROM memory.default.mv "
                               "ORDER BY k").rows)
            return got
        finally:
            mgr.stop()
    assert both(scenario, tmp_path, monkeypatch) == [[[4]], [[1, 4], [2, 1]]]


def test_continuous_window_watermark(tmp_path, monkeypatch):
    def scenario(m, d):
        r = _events_runner(m)
        mgr, run_sql = _mk_manager(m, r, d)
        log = m.log.get_log(str(d / "stream"))
        try:
            job = mgr.create({
                "kind": "window", "topic": "events",
                "target": "memory.default.winmv", "ts_column": "ts",
                "lateness_ms": 1000, "poll_interval_ms": 100,
                "sql": "SELECT k, count(*) c, sum(v) s "
                       "FROM stream.default.events "
                       "WHERE ts <= {watermark} GROUP BY k"})
            for i in range(10):
                log.append("events", [_doc(k=i % 2, v=float(i),
                                           ts=float(i * 500))])
            # max ts 4500, lateness 1000: watermark 3500. A cycle's
            # window snapshots the partitions one after the other, so the
            # watermark can reach 3500 a cycle before the last rows of
            # the other partition are staged: wait for both, then for the
            # view of the cycle that staged them
            _wait_until(lambda: (mgr.get(job["job_id"]) or {}).get(
                "watermark") == 3500.0 and _count(
                    run_sql, "memory.default.winmv__cq_staging") == 10,
                what="watermark advance")
            # the view's table appears at the end of the cycle that
            # staged the rows: it may not exist yet when the staging does
            _wait_until(lambda: _rows(
                run_sql, "SELECT k, c FROM memory.default.winmv ORDER BY k"
            ) == [[0, 4], [1, 4]], what="the view at the watermark")
            staged = run_sql(
                "SELECT count(*), count(DISTINCT _partition * 1000000 "
                "+ _offset) FROM memory.default.winmv__cq_staging").rows[0]
            rows = run_sql("SELECT k, c, s FROM memory.default.winmv "
                           "ORDER BY k").rows
            return staged, rows
        finally:
            mgr.stop()
    staged, rows = both(scenario, tmp_path, monkeypatch)
    assert staged == [10, 10]
    # ts <= 3500 -> i in 0..7 -> 4 rows a key
    assert rows == [[0, 4, 12.0], [1, 4, 16.0]]


def test_continuous_restart_jobs_ledger(tmp_path, monkeypatch):
    def scenario(m, d):
        r = _events_runner(m)
        r.execute("CREATE TABLE memory.default.sink "
                  "(p BIGINT, o BIGINT, v DOUBLE)")
        jobs = str(d / "continuous.jsonl")
        mgr, run_sql = _mk_manager(m, r, d, jobs_path=jobs)
        log = m.log.get_log(str(d / "stream"))
        job = mgr.create({"kind": "insert", "topic": "events",
                          "poll_interval_ms": 100, "sql": _SINK_SQL})
        log.append("events", [_doc(k=1, v=1.0, ts=0.0)] * 5)
        _wait_until(lambda: run_sql(
            "SELECT count(*) FROM memory.default.sink").rows[0][0] == 5,
            what="first manager drain")
        mgr.stop()                     # failover: not a cancel
        log.append("events", [_doc(k=2, v=2.0, ts=0.0)] * 3)
        mgr2, run_sql2 = _mk_manager(m, r, d, jobs_path=jobs)
        try:
            got = [mgr2.restart_jobs(), mgr2.restart_jobs(),
                   mgr2.get(job["job_id"])["state"]]
            _wait_until(lambda: run_sql2(
                "SELECT count(*) FROM memory.default.sink"
            ).rows[0][0] == 8, what="resumed drain")
            got.append(run_sql2(
                "SELECT count(*), count(DISTINCT p * 1000000 + o) "
                "FROM memory.default.sink").rows[0])
        finally:
            mgr2.stop()
        mgr2.cancel(job["job_id"])
        mgr3, _ = _mk_manager(m, r, d, jobs_path=jobs)
        got.append(mgr3.restart_jobs())
        mgr3.stop()
        return got
    assert both(scenario, tmp_path, monkeypatch) == [1, 0, "RUNNING",
                                                     [8, 8], 0]


def test_continuous_create_validation(tmp_path, monkeypatch):
    def scenario(m, d):
        mgr, _ = _mk_manager(m, m.runner(), d)
        errors = []
        try:
            for bad in (
                    {"kind": "nope", "sql": "SELECT 1"},
                    {"kind": "insert", "sql": ""},
                    {"kind": "insert", "sql": "SELECT 1"},   # no topic
                    {"kind": "view", "sql": "SELECT 1",
                     "target": "not_fqn"},
                    {"kind": "window", "sql": "SELECT 1", "topic": "t",
                     "target": "a.b.c"}):                    # no ts_column
                with pytest.raises(ValueError) as e:
                    mgr.create(bad)
                errors.append(str(e.value))
        finally:
            mgr.stop()
        return errors
    assert len(both(scenario, tmp_path, monkeypatch)) == 5


def test_window_lateness_zero_is_honoured(tmp_path, monkeypatch):
    """An explicit ``lateness_ms`` of 0: the port keeps it, so the
    watermark is max(ts); the JAX package reads 0 as unset and applies
    its 1000 ms default (a fault of the reference, not copied)."""
    from trino_tpu.streaming.continuous import ContinuousJob as TpuJob
    from trino_tpu_torch.streaming.continuous import ContinuousJob
    spec = {"kind": "window", "sql": "x", "ts_column": "ts",
            "lateness_ms": 0}
    got = {"jax": TpuJob("j", spec).lateness_ms,
           "torch": ContinuousJob("j", spec).lateness_ms}
    # unset, both apply the default
    del spec["lateness_ms"]
    assert TpuJob("j", spec).lateness_ms == \
        ContinuousJob("j", spec).lateness_ms == 1000
    assert got == {"jax": 1000, "torch": 0}


# --- fault points ----------------------------------------------------------

def test_fault_point_pre_append_no_partial_write(tmp_path, monkeypatch):
    def scenario(m, d):
        log = m.log.MessageLog(str(d / "stream"))
        log.create_topic("t", partitions=1)
        log.append("t", [b"before"], partition=0)
        m.faults.reset()
        m.faults.install("stream.pre_append", "raise")
        try:
            with pytest.raises(m.faults.FaultInjected):
                log.append("t", [b"doomed-1", b"doomed-2"], partition=0)
            return (log.end_offsets("t"),
                    log.append("t", [b"retry"], partition=0),
                    log.read("t", 0, 0, 5))
        finally:
            m.faults.reset()
    assert both(scenario, tmp_path, monkeypatch) == (
        {0: 1}, {0: (1, 2)}, [b"before", b"retry"])


def test_fault_point_pre_offset_commit(tmp_path, monkeypatch):
    def scenario(m, d):
        store = m.offsets.OffsetStore(_spool(m, d))
        got = [store.commit("job1", 1, {"t": {0: 5}})]
        m.faults.reset()
        m.faults.install("stream.pre_offset_commit", "raise")
        try:
            with pytest.raises(m.faults.FaultInjected):
                store.commit("job1", 2, {"t": {0: 9}})
            got.append(store.load("job1"))
            got.append(store.commit("job1", 2, {"t": {0: 9}}))
            got.append(store.load("job1"))
        finally:
            m.faults.reset()
        return got
    assert both(scenario, tmp_path, monkeypatch) == [
        True, (1, {"t": {0: 5}}), True, (2, {"t": {0: 9}})]


@pytest.mark.slow
def test_chaos_offset_commit_crash_mid_job(tmp_path, monkeypatch):
    """The at-least-once boundary: a cycle dies between its INSERT and
    its offset commit, the next cycle re-covers the window, and the
    _partition/_offset ledger dedupes the duplicates."""
    def scenario(m, d):
        r = _events_runner(m)
        r.execute("CREATE TABLE memory.default.sink "
                  "(p BIGINT, o BIGINT, v DOUBLE)")
        mgr, run_sql = _mk_manager(m, r, d)
        log = m.log.get_log(str(d / "stream"))
        m.faults.reset()
        m.faults.install("stream.pre_offset_commit", "raise")
        try:
            mgr.create({"kind": "insert", "topic": "events",
                        "poll_interval_ms": 100, "sql": _SINK_SQL})
            log.append("events", [_doc(k=1, v=1.0, ts=0.0)] * 4)
            _wait_until(lambda: run_sql(
                "SELECT count(*) FROM memory.default.sink"
            ).rows[0][0] >= 8, what="re-covered window")
            return (run_sql("SELECT count(*), count(DISTINCT p * 1000000 "
                            "+ o) FROM memory.default.sink").rows[0],
                    run_sql("SELECT count(*) FROM (SELECT DISTINCT p, o "
                            "FROM memory.default.sink)").rows)
        finally:
            m.faults.reset()
            mgr.stop()
    assert both(scenario, tmp_path, monkeypatch) == ([8, 4], [[4]])


# --- HTTP and cluster ------------------------------------------------------

def test_coordinator_ingest_and_continuous_http(tmp_path, monkeypatch):
    """HTTP ingest through the coordinator, a continuous job created,
    listed, read and canceled at /v1/continuous, and its row in
    system.runtime.continuous_queries."""
    def scenario(m, d):
        co = m.coordinator(history_dir=str(d / "hist")).start()
        got = []
        try:
            c = m.StatementClient(co.base_uri)
            c.execute("CREATE TABLE stream.default.events "
                      "(k BIGINT, v DOUBLE, ts DOUBLE)")
            c.execute("CREATE TABLE memory.default.sink "
                      "(p BIGINT, o BIGINT, v DOUBLE)")
            body = b"\n".join(_doc(k=i, v=float(i), ts=i / 10.0)
                              for i in range(12))
            out = _post(co.base_uri + "/v1/ingest/events", body)
            got += [out["count"], sum(out["endOffsets"].values()),
                    c.execute("SELECT count(*) FROM stream.default.events"
                              ).rows]
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(co.base_uri + "/v1/ingest/events?partition=99", b"x")
            got.append(e.value.code)
            job = _post(co.base_uri + "/v1/continuous", json.dumps({
                "kind": "insert", "topic": "events",
                "poll_interval_ms": 150, "sql": _SINK_SQL}).encode())
            got.append(job["state"])
            _wait_until(lambda: c.execute(
                "SELECT count(*) FROM memory.default.sink"
            ).rows[0][0] == 12, what="continuous drain")
            got.append(c.execute(
                "SELECT count(*), count(DISTINCT p * 1000000 + o) "
                "FROM memory.default.sink").rows[0])
            # rows_total moves a beat after the INSERT lands
            _wait_until(lambda: c.execute(
                "SELECT job_id, kind, state, rows_total "
                "FROM system.runtime.continuous_queries").rows
                == [[job["job_id"], "insert", "RUNNING", 12]],
                what="the job's row")
            got.append(True)
            got.append(len(_post(co.base_uri + "/v1/continuous",
                                 method="GET")["jobs"]))
            got.append(_post(co.base_uri + "/v1/continuous/"
                             + job["job_id"], method="GET")["kind"])
            bad = json.dumps({"kind": "nope", "sql": "x"}).encode()
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(co.base_uri + "/v1/continuous", bad)
            got.append(e.value.code)
            _post(co.base_uri + "/v1/continuous/" + job["job_id"],
                  method="DELETE")
            got.append(_post(co.base_uri + "/v1/continuous/"
                             + job["job_id"], method="GET")["state"])
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(co.base_uri + "/v1/continuous/cq_missing",
                      method="DELETE")
            got.append(e.value.code)
        finally:
            co.stop()
        return got
    assert both(scenario, tmp_path, monkeypatch) == [
        12, 12, [[12]], 400, "RUNNING", [12, 12], True, 1, "insert", 400,
        "CANCELED", 404]


def test_worker_ingest_route(tmp_path, monkeypatch):
    """A worker takes producer appends at /v1/ingest/{topic} into the
    shared stream directory, as the JAX worker does."""
    def scenario(m, d):
        w = m.worker().start()
        try:
            out = _post(w.base_uri + "/v1/ingest/clicks?partition=0",
                        b"a\nb")
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(w.base_uri + "/v1/ingest/clicks?partition=99", b"x")
            return (out, e.value.code,
                    m.log.get_log().read("clicks", 0, 0, 5))
        finally:
            w.stop()
    out, code, msgs = both(scenario, tmp_path, monkeypatch)
    assert out["count"] == 2 and out["ranges"] == {"0": [0, 2]}
    assert code == 400 and msgs == [b"a", b"b"]


@pytest.mark.slow
def test_streaming_acceptance_e2e(tmp_path, monkeypatch):
    """Messages stream in through /v1/ingest on the coordinator and the
    workers while a continuous job drains them; a worker stops
    mid-ingest and the sink converges to zero duplicated and zero lost
    rows, proven from the offset ledger; then the coordinator fails over
    and the job resumes from its committed offsets."""
    def scenario(m, d):
        hist = str(d / "hist")
        cats = m.runner().catalogs
        workers = [m.worker().start() for _ in range(2)]
        co = m.coordinator(worker_uris=[w.base_uri for w in workers],
                           catalogs=cats, history_dir=hist).start()
        produced = []

        def produce():
            targets = [co.base_uri] + [w.base_uri for w in workers]
            for burst in range(20):
                base = burst * 10
                body = b"\n".join(_doc(k=(base + i) % 3, v=float(base + i),
                                       ts=float(base + i))
                                  for i in range(10))
                try:
                    _post(targets[burst % len(targets)]
                          + "/v1/ingest/clicks", body)
                except (urllib.error.URLError, OSError):
                    _post(co.base_uri + "/v1/ingest/clicks", body)
                produced.append(10)
                time.sleep(0.05)
        got = []
        try:
            c = m.StatementClient(co.base_uri)
            c.execute("CREATE TABLE stream.default.clicks "
                      "(k BIGINT, v DOUBLE, ts DOUBLE)")
            c.execute("CREATE TABLE memory.default.sink "
                      "(p BIGINT, o BIGINT, v DOUBLE)")
            job = _post(co.base_uri + "/v1/continuous", json.dumps({
                "kind": "insert", "topic": "clicks",
                "poll_interval_ms": 150,
                "sql": "INSERT INTO memory.default.sink SELECT _partition, "
                       "_offset, v FROM stream.default.clicks"}).encode())
            producer = threading.Thread(target=produce, daemon=True)
            producer.start()

            def count(client):
                try:
                    return client.execute("SELECT count(*) FROM "
                                          "memory.default.sink").rows[0][0]
                except Exception:       # noqa: BLE001 — mid-kill wobble
                    return 0
            _wait_until(lambda: count(c) >= 40, timeout=60,
                        what="first bursts drained")
            workers[0].stop()
            producer.join(timeout=60)
            total = sum(produced)
            _wait_until(lambda: count(c) >= total, timeout=90,
                        what="all bursts drained after the worker stop")
            got += [total, c.execute(
                "SELECT count(*), count(DISTINCT p * 1000000 + o), sum(v) "
                "FROM memory.default.sink").rows[0],
                c.execute("SELECT count(*) FROM stream.default.clicks"
                          ).rows[0][0]]
            epoch, committed = m.offsets.OffsetStore(
                m.spool.default_spool()).load(job["job_id"])
            got += [epoch >= 1, sum(committed["clicks"].values())]
            co.stop()
            co2 = m.coordinator(worker_uris=[workers[1].base_uri],
                                catalogs=cats, history_dir=hist).start()
            try:
                c2 = m.StatementClient(co2.base_uri)
                _wait_until(lambda: _post(co2.base_uri + "/v1/continuous",
                                          method="GET")["jobs"],
                            what="job restarted")
                _post(co2.base_uri + "/v1/ingest/clicks", b"\n".join(
                    _doc(k=0, v=-1.0, ts=999.0) for _ in range(10)))
                _wait_until(lambda: count(c2) >= total + 10, timeout=60,
                            what="post-failover drain")
                got.append(c2.execute(
                    "SELECT count(*), count(DISTINCT p * 1000000 + o) "
                    "FROM memory.default.sink").rows[0])
            finally:
                co2.stop()
        finally:
            for w in workers:
                try:
                    w.stop()
                except Exception:       # noqa: BLE001
                    pass
            try:
                co.stop()
            except Exception:           # noqa: BLE001
                pass
        return got
    got = both(scenario, tmp_path, monkeypatch)
    assert got[0] == 200 and got[1] == [200, 200, 19900.0]
    assert got[2] == 200 and got[3] is True and got[4] == 200
    assert got[5] == [210, 210]


# --- one topic directory, either package -----------------------------------

def test_each_package_reads_the_others_topic(tmp_path):
    """The segment format is shared: a topic one package wrote reads
    back, message for message and through SQL, in the other."""
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu.streaming.log import MessageLog as TpuLog
    from trino_tpu_torch.connectors.stream import StreamConnector
    from trino_tpu_torch.catalog import CatalogManager
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.streaming.log import MessageLog
    docs = [_doc(k=i, v=i / 4.0, ts=float(i)) for i in range(9)]
    for writer, reader in ((TpuLog, MessageLog), (MessageLog, TpuLog)):
        base = str(tmp_path / writer.__module__.split(".")[0])
        w = writer(base)
        w.create_topic("t", fields=[("k", "bigint", None),
                                    ("v", "double", None),
                                    ("ts", "double", None)], partitions=3)
        for i, m in enumerate(docs):
            w.append("t", [m], partition=i % 3)
        r = reader(base)
        assert r.topic_config("t") == w.topic_config("t")
        assert r.end_offsets("t") == {0: 3, 1: 3, 2: 3}
        assert [r.read("t", p, 0, 3) for p in range(3)] == \
            [docs[p::3] for p in range(3)]
        assert r.data_version() == w.data_version()
    # SQL over the JAX-written directory through the port's connector
    base = str(tmp_path / "trino_tpu")
    cats = CatalogManager()
    cats.register("stream", StreamConnector(base, device="cpu"))
    sql = ("SELECT _partition, count(*), sum(k), sum(v) FROM "
           "stream.default.t GROUP BY 1 ORDER BY 1")
    got = LocalQueryRunner(device="cpu", catalogs=cats).execute(sql).rows
    from trino_tpu.catalog import CatalogManager as TpuCatalogs
    from trino_tpu.connectors.stream import StreamConnector as TpuConn
    tcats = TpuCatalogs()
    tcats.register("stream", TpuConn(base))
    assert got == TpuRunner(catalogs=tcats).execute(sql).rows


def test_each_package_loads_the_others_epochs(tmp_path):
    """Offset epochs one package sealed on a spool load in the other,
    epoch after epoch."""
    from trino_tpu.fte.spool import make_spool as tpu_spool
    from trino_tpu.streaming.offsets import OffsetStore as TpuStore
    from trino_tpu_torch.fte.spool import make_spool
    from trino_tpu_torch.streaming.offsets import OffsetStore
    base = str(tmp_path / "spool")
    jax_store = TpuStore(tpu_spool("local", local_base_dir=base))
    port_store = OffsetStore(make_spool("local", local_base_dir=base))
    assert jax_store.commit("c1", 1, {"t": {0: 4, 1: 2}})
    assert port_store.load("c1") == (1, {"t": {0: 4, 1: 2}})
    assert port_store.commit("c1", 2, {"t": {0: 6, 1: 2}})
    assert TpuStore(tpu_spool("local", local_base_dir=base)).load("c1") \
        == (2, {"t": {0: 6, 1: 2}})
    # the next epoch continues from either side
    assert jax_store.commit("c1", 3, {"t": {0: 8, 1: 3}})
    assert OffsetStore(make_spool("local", local_base_dir=base)).load(
        "c1") == (3, {"t": {0: 8, 1: 3}})


# --- the stream's JSON decode ----------------------------------------------

_ODD_MESSAGES = [
    b'{"k": 1, "v": 2.5, "s": "x"}', b' {"k": 2}', b'{"k": 3} ',
    b'{"k": 4}}', b'{"k": 5', b'{}', b'{"k": [1, 2]}', b'[1, 2]', b'7',
    b'"str"', b'null', b'', b'{"k": 1}{"k": 2}', b'{"k": "\\ud800"}',
    b'{"s": "caf\xc3\xa9"}', b'{"s": "\xff"}', b'\xef\xbb\xbf{"k": 9}',
    '{"k": 10}'.encode("utf-16"), '{"k": 11}'.encode("utf-16-le"),
    b'{\x00}', b'{"k": NaN}', b'{"v": 1e400}', b'{"k": -0.0}',
    b'{"a": {"b": [1, {"c": 2}]}}', b'{"k": 1,}', b'{ }']


def test_json_decode_equals_json_loads_and_the_jax_decoder():
    """Every kind of message (one json.loads a message, NULLs where it
    raises) decodes to the JAX package's decoder's rows."""
    from trino_tpu.formats.record_decoder import (
        DecoderField as JaxField, create_decoder as jax_decoder)
    from trino_tpu_torch.formats import record_decoder as rd
    from trino_tpu_torch.types import BIGINT, DOUBLE, VARCHAR
    from trino_tpu.types import (BIGINT as JBIGINT, DOUBLE as JDOUBLE,
                                 VARCHAR as JVARCHAR)
    msgs = _ODD_MESSAGES * 3
    fields = [("k", BIGINT, JBIGINT), ("v", DOUBLE, JDOUBLE),
              ("s", VARCHAR, JVARCHAR), ("a.b", VARCHAR, JVARCHAR)]
    port = rd.create_decoder("json", [rd.DecoderField(n, t)
                                      for n, t, _ in fields], "cpu")
    jax = jax_decoder("json", [JaxField(n, j) for n, _, j in fields])
    assert port.decode(msgs).to_pylist() == jax.decode(msgs).to_pylist()
    # a batch of plain objects only takes the all-dicts path
    plain = [_doc(k=i, v=i / 2, s=str(i)) for i in range(50)]
    assert port.decode(plain).to_pylist() == jax.decode(plain).to_pylist()


_LANE_VALUES = [
    [1, 2, 3], [1, None, 3], [None, None], [], [True, False, None],
    [1.5, -0.0, None], [1, 2.5], [2.5, 7], [True, 2], [0, 1, 2],
    [np.int64(4), 5], [float("nan"), 1e300]]


@pytest.mark.parametrize("type_name", [
    "BIGINT", "INTEGER", "SMALLINT", "TINYINT", "DOUBLE", "REAL",
    "BOOLEAN"])
def test_numeric_lanes_equal_the_jax_package(type_name):
    """A numeric or boolean lane built from python values (numpy's one
    call where every value is of the lane's python type, the loop
    otherwise) holds the JAX package's values, NULLs and all."""
    import trino_tpu.types as jt
    from trino_tpu import batch_from_pylist as jax_batch
    import trino_tpu_torch.types as pt
    from trino_tpu_torch.columnar import batch_from_pylist

    def outcome(build):
        try:
            return repr(build().to_pylist())
        except (OverflowError, ValueError, TypeError) as e:
            return type(e).__name__
    for values in _LANE_VALUES:
        got = outcome(lambda: batch_from_pylist(
            {"x": values}, {"x": getattr(pt, type_name)}, "cpu"))
        want = outcome(lambda: jax_batch(
            {"x": values}, {"x": getattr(jt, type_name)}))
        assert got == want, values
