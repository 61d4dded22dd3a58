"""Ragged multi-query batching in the port (exec/taskexec.py
RaggedBatcher + exec/executor.py _try_ragged_chain) against the JAX
package, on the CPU: concurrent point lookups that co-batch into one run
of their chain must come back row for row identical to isolated runs and
to the JAX package's rows, both packages must serve the same fragments,
and a batch-mate's failure must degrade the whole group to solo
execution, failing no innocent query. The reference's four cases
(tests/test_ragged_batch.py) run here against the port.
"""

import os
import subprocess
import sys
import threading

import pytest

import trino_tpu.exec.taskexec as tpu_te
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
import trino_tpu_torch.exec.taskexec as te
from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.server.task_worker import TaskWorkerServer
from trino_tpu_torch.session import Session

# s_name rides a dictionary; the product is a computed lane
SQLS = [
    ("SELECT s_name, s_acctbal, s_acctbal * s_acctbal AS sq "
     f"FROM supplier WHERE s_suppkey = {k}")
    # 9999 matches nothing: the pushed-down scan yields ZERO rows, so
    # the n<=0 gate runs it solo beside a forming batch
    for k in (3, 17, 42, 58, 9999)
]
N_BATCHABLE = 4     # the non-empty point lookups above
# the same lookups through a Filter the scan does not take (LIKE): the
# chain is Project over Filter, and the demux reads a compacted lane
FILTER_SQLS = [
    ("SELECT s_name, s_acctbal * 2 AS d FROM supplier "
     f"WHERE s_suppkey = {k} AND s_comment LIKE '%e%'")
    for k in (3, 17, 42, 58, 9999)
]
# per-query cross-row semantics: the chain holds a TopN and never batches
TOPN_SQLS = [
    ("SELECT s_name, s_acctbal FROM supplier "
     f"WHERE s_nationkey = {k} ORDER BY s_acctbal DESC LIMIT 2")
    for k in (1, 5, 9, 13)
]
WINDOW_S = 0.5


@pytest.fixture
def ragged_env(monkeypatch):
    """A formation window wide enough for plain test threads to meet."""
    monkeypatch.setattr(te, "_RAGGED", te.RaggedBatcher(WINDOW_S, 1 << 20))


def _session(ragged: bool, cls=Session):
    s = cls(catalog="tpch", schema="tiny")
    if ragged:
        s.set("ragged_batching", True)
    return s


def _port(ragged: bool):
    return LocalQueryRunner(session=_session(ragged), device="cpu")


def _tpu(ragged: bool):
    return TpuRunner(session=_session(ragged, TpuSession))


def _solo_rows(sqls, make=_port):
    return [make(False).execute(sql).rows for sql in sqls]


def _storm(sqls, make=_port, ragged: bool = True):
    """Each query on its own thread through its own runner, released at
    once by a barrier: the process-wide batcher is where they meet."""
    rows = [None] * len(sqls)
    errs = [None] * len(sqls)
    batched = [0] * len(sqls)
    barrier = threading.Barrier(len(sqls))

    def run(i):
        r = make(ragged)
        barrier.wait()
        try:
            res = r.execute(sqls[i])
            rows[i] = res.rows
            batched[i] = getattr(res, "ragged_batched", 0)
        except Exception as e:  # noqa: BLE001 — surfaced in asserts
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(sqls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return rows, errs, batched


@pytest.mark.parametrize("sqls", [SQLS, FILTER_SQLS],
                         ids=["project", "filter_project"])
def test_cobatched_rows_identical_to_isolated(ragged_env, sqls):
    expected = _solo_rows(sqls)
    assert any(expected), "solo baseline returned nothing"
    # and the solo rows are the JAX package's
    assert expected == _solo_rows(sqls, _tpu)
    q0 = te.RAGGED_QUERIES.value()
    b0 = te.RAGGED_BATCHES.value()
    r0 = te.RAGGED_ROWS.value()
    rows, errs, batched = _storm(sqls)
    assert errs == [None] * len(sqls)
    # every non-empty member was served by a ragged batch (the window is
    # orders of magnitude wider than the skew after the barrier)
    assert te.RAGGED_QUERIES.value() - q0 == N_BATCHABLE
    assert te.RAGGED_BATCHES.value() - b0 >= 1
    assert te.RAGGED_ROWS.value() - r0 == N_BATCHABLE
    assert batched == [1] * N_BATCHABLE + [0]
    for got, want, sql in zip(rows, expected, sqls):
        assert got == want, sql


def test_batchmate_failure_leaves_innocents_exact(ragged_env, monkeypatch):
    """run_group blowing up mid-batch fails NO query: the group publishes
    no results and every member re-executes solo on its own thread,
    innocents exact, the fallback counted as an error."""
    from trino_tpu_torch.exec.executor import Executor
    expected = _solo_rows(SQLS)

    def boom(self, canon, items):
        raise RuntimeError("injected ragged group failure")

    monkeypatch.setattr(Executor, "_run_ragged_group", boom)
    e0 = te.RAGGED_FALLBACKS.value(reason="error")
    b0 = te.RAGGED_BATCHES.value()
    rows, errs, batched = _storm(SQLS)
    assert errs == [None] * len(SQLS)
    assert rows == expected
    assert batched == [0] * len(SQLS)
    assert te.RAGGED_BATCHES.value() == b0          # nothing "served"
    assert te.RAGGED_FALLBACKS.value(reason="error") - e0 >= 1


def test_batcher_isolates_offender_to_its_own_thread():
    """Contract-level isolation: an offender poisoning run_group makes
    EVERY submit return (False, None); each caller then runs solo, where
    only the offender's own retry raises."""
    batcher = te.RaggedBatcher(window_s=0.3, max_rows=1 << 16)
    outs = [None] * 3
    barrier = threading.Barrier(3)

    def run_group(items):
        if "poison" in items:
            raise ValueError("offender")
        return list(items)

    def submit(i, item):
        barrier.wait()
        outs[i] = batcher.submit(("sig",), 4, item, run_group)

    threads = [threading.Thread(target=submit, args=(i, item))
               for i, item in enumerate(["a", "poison", "b"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert outs == [(False, None)] * 3
    assert run_group(["a"]) == ["a"]
    with pytest.raises(ValueError):
        run_group(["poison"])


def test_oversized_fragment_falls_back_capacity():
    batcher = te.RaggedBatcher(window_s=0.0, max_rows=64)
    c0 = te.RAGGED_FALLBACKS.value(reason="capacity")
    ok, out = batcher.submit(("sig",), 65, "x", lambda items: items)
    assert (ok, out) == (False, None)
    assert te.RAGGED_FALLBACKS.value(reason="capacity") - c0 == 1


def test_both_packages_serve_the_same_fragments(ragged_env, monkeypatch):
    """The same storm at the same 0.5 s window through each package (the
    JAX package on its compiled-chain path, as its own test runs it):
    the same members are served, and the rows are equal."""
    monkeypatch.setenv("TRINO_TPU_FRAGMENT_JIT", "1")
    monkeypatch.setattr(tpu_te, "_RAGGED",
                        tpu_te.RaggedBatcher(WINDOW_S, 1 << 20))
    q0 = tpu_te.RAGGED_QUERIES.value()
    want, errs, want_batched = _storm(SQLS, _tpu)
    assert errs == [None] * len(SQLS)
    assert tpu_te.RAGGED_QUERIES.value() - q0 == N_BATCHABLE
    p0 = te.RAGGED_QUERIES.value()
    got, errs, got_batched = _storm(SQLS)
    assert errs == [None] * len(SQLS)
    assert te.RAGGED_QUERIES.value() - p0 == N_BATCHABLE
    assert got_batched == want_batched == [1] * N_BATCHABLE + [0]
    assert got == want


def test_served_query_analyze_shape_equals_the_reference(ragged_env,
                                                         monkeypatch):
    """EXPLAIN ANALYZE of a served lookup: the plan, the node lines (the
    chain one line under its top node, as the JAX package's compiled
    chain shows it) and a ragged_batch span, in both packages."""
    monkeypatch.setenv("TRINO_TPU_FRAGMENT_JIT", "1")
    monkeypatch.setattr(tpu_te, "_RAGGED",
                        tpu_te.RaggedBatcher(WINDOW_S, 1 << 20))
    sqls = ["EXPLAIN ANALYZE " + sql for sql in SQLS[:N_BATCHABLE]]

    def shape(rows):
        lines = [r[0] for r in rows]
        cut = lines.index("")
        plan = lines[:cut]
        nodes = [ln.split(":")[0] for ln in lines[cut + 1:]
                 if ln and ":" in ln and not ln.startswith(("Trace", " ",
                                                              "-"))]
        spans = [ln.strip().split(":")[0] for ln in lines
                 if "ragged_batch" in ln]
        return plan, nodes, spans

    want, errs, _ = _storm(sqls, _tpu)
    assert errs == [None] * len(sqls)
    got, errs, _ = _storm(sqls)
    assert errs == [None] * len(sqls)
    for g, w in zip(got, want):
        assert shape(g) == shape(w)
        assert shape(g)[1] == ["TableScan", "Project", "Output"]
        assert shape(g)[2] == ["- ragged_batch"]


def test_order_by_limit_chain_is_not_batched(ragged_env):
    """A chain that holds a TopN runs solo, with ragged batching on, and
    equals the JAX package."""
    q0 = te.RAGGED_QUERIES.value()
    f0 = sum(te.RAGGED_FALLBACKS.value(reason=r)
             for r in ("solo_window", "capacity", "error", "timeout"))
    rows, errs, batched = _storm(TOPN_SQLS)
    assert errs == [None] * len(TOPN_SQLS)
    assert batched == [0] * len(TOPN_SQLS)
    # never offered: no batch, no fallback
    assert te.RAGGED_QUERIES.value() == q0
    assert sum(te.RAGGED_FALLBACKS.value(reason=r)
               for r in ("solo_window", "capacity", "error",
                         "timeout")) == f0
    assert rows == _solo_rows(TOPN_SQLS, _tpu)


def test_off_by_default_offers_nothing(ragged_env):
    s0 = te.RAGGED_FALLBACKS.value(reason="solo_window")
    q0 = te.RAGGED_QUERIES.value()
    rows, errs, batched = _storm(SQLS, ragged=False)
    assert errs == [None] * len(SQLS)
    assert batched == [0] * len(SQLS)
    assert te.RAGGED_QUERIES.value() == q0
    assert te.RAGGED_FALLBACKS.value(reason="solo_window") == s0
    assert rows == _solo_rows(SQLS)


def test_lone_lookup_falls_back_solo_window(ragged_env):
    s0 = te.RAGGED_FALLBACKS.value(reason="solo_window")
    res = _port(True).execute(SQLS[0])
    assert res.ragged_batched == 0
    assert te.RAGGED_FALLBACKS.value(reason="solo_window") - s0 == 1
    assert res.rows == _solo_rows(SQLS[:1])[0]


def test_storm_through_two_workers_rolls_up_per_query(ragged_env):
    """The storm through two in-process port workers: each query's leaf
    task that read the row reports raggedBatched 1 in its status, the
    other task 0, and each query's result carries the sum."""
    workers = [TaskWorkerServer(device="cpu").start() for _ in range(2)]
    try:
        uris = [w.base_uri for w in workers]

        def make(ragged):
            return DistributedHostQueryRunner(
                uris, session=_session(ragged), device="cpu",
                collect_node_stats=True)

        rows, errs, batched = _storm(SQLS, make)
        assert errs == [None] * len(SQLS)
        assert rows == _solo_rows(SQLS, _tpu)
        assert batched == [1] * N_BATCHABLE + [0]
        per_query = {}
        for w in workers:
            for tid, task in w._tasks.items():
                per_query.setdefault(tid.split(".", 1)[0], []).append(
                    task.ragged_batched)
        assert len(per_query) == len(SQLS)
        assert sorted(sum(v) for v in per_query.values()) == \
            [0] + [1] * N_BATCHABLE
        assert all(len(v) == 2 and max(v) <= 1 for v in per_query.values())
    finally:
        for w in workers:
            w.stop()


def test_sixteen_clients_through_one_coordinator(ragged_env, tmp_path):
    """Sixteen clients at once through one port coordinator with
    ragged_batching=true in their session: every lookup answers with its
    solo rows, none of the sixteen connects is refused (the servers'
    listen backlog), and groups form."""
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.fte.recovery import json_value
    from trino_tpu_torch.server import Coordinator
    sqls = [SQLS[i % N_BATCHABLE] for i in range(16)]
    want = [[[json_value(v) for v in row] for row in rows]
            for rows in _solo_rows(sqls)]
    co = Coordinator(device="cpu", history_dir=str(tmp_path)).start()
    try:
        assert co._httpd.request_queue_size >= 64
        q0 = te.RAGGED_QUERIES.value()

        def make(ragged):
            return StatementClient(co.base_uri, session_properties={
                "ragged_batching": "true"})
        rows, errs, _ = _storm(sqls, make)
        assert errs == [None] * len(sqls)
        assert rows == want
        assert te.RAGGED_QUERIES.value() - q0 >= 2
    finally:
        co.stop()


def test_config_reads_the_reference_environment():
    """ragged_batch_rows and ragged_window_ms come from the reference's
    variables, with its defaults."""
    code = ("import json, sys; from {0}.config import CONFIG; "
            "json.dump([CONFIG.ragged_batch_rows, CONFIG.ragged_window_ms],"
            " sys.stdout)")
    outs = {}
    for env in ({}, {"TRINO_TPU_RAGGED_BATCH_ROWS": "4096",
                     "TRINO_TPU_RAGGED_WINDOW_MS": "12.5"}):
        for pkg in ("trino_tpu", "trino_tpu_torch"):
            e = {k: v for k, v in os.environ.items()
                 if not k.startswith("TRINO_TPU_RAGGED")}
            e.update(env)
            e["JAX_PLATFORMS"] = "cpu"
            out = subprocess.run(
                [sys.executable, "-c", code.format(pkg)], env=e,
                capture_output=True, text=True, timeout=120,
                cwd=os.path.dirname(os.path.dirname(__file__)))
            assert out.returncode == 0, out.stderr
            outs[(bool(env), pkg)] = out.stdout
    assert outs[(False, "trino_tpu")] == outs[(False, "trino_tpu_torch")] \
        == "[65536, 3.0]"
    assert outs[(True, "trino_tpu")] == outs[(True, "trino_tpu_torch")] \
        == "[4096, 12.5]"
