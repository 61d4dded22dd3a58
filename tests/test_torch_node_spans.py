"""The executor's spans and its node stats without a fence, on the CPU at
tpch.tiny: a ``node.<Name>`` span per NodeStats entry, nested as the plan
nests under ``execute``; a ``device_wait`` span at each host read of the
card on the benchmark templates' paths, inside the node that makes it;
no synchronisation and no host read of a row count while the nodes run,
and the resolved rows and bytes equal to reading each node's counts as
it ends (``Eager``, the stats as they were read before); worker and
mesh stats resolved when they reach their reader."""

import sys
import time

import pytest
import torch

from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
from trino_tpu_torch.columnar import Batch
from trino_tpu_torch.exec.executor import Executor, NodeStats, _node_name
from trino_tpu_torch.exec.scancache import col_bytes
from trino_tpu_torch.obs.trace import ACTIVE, QueryTrace, device_wait
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

UNION = ("SELECT o_orderkey AS k FROM orders WHERE o_totalprice > 300000 "
         "UNION ALL SELECT l_orderkey FROM lineitem WHERE l_quantity > 49")
QUERIES = {"q1": TPCH_QUERIES[1], "q3": TPCH_QUERIES[3],
           "q12": TPCH_QUERIES[12], "union": UNION}
# device_wait spans a query on each benchmark template's path at
# tpch.tiny, by call site: a filter's host row count copied to the card
# (``num_rows_device``: q1 2, q6 2, q3 6, q12 3, q14 3); a dictionary's
# sort ranks (q1 2, q12 1) or lookup table (``_codes_through``: q3 2,
# q12 12; ``_gather_table``: q14 1) copied to the card; each join's
# output size (q3 2, q12 1, q14 1) and the probe and build row counts it
# records (q3 6, q12 2, q14 2); q3's general GROUP BY (its first boundary
# set from the host, the segment lengths' ``bincount``) and its TopN
# limit copied to the card
WAITS = {1: 4, 6: 2, 3: 19, 12: 19, 14: 7}


def session() -> Session:
    s = Session(catalog="tpch", schema="tiny")
    s.set("pushdown_into_scan", "false")
    return s


@pytest.fixture(scope="module")
def runner():
    return LocalQueryRunner(session(), device="cpu",
                            collect_node_stats=True)


class Eager(Executor):
    """The node stats as they were read before: each node's output rows,
    and each connector read's, read to the host as the node ends."""

    def _stats_wrap(self, node, run):
        frame = {"rows": 0, "bytes": 0}
        self._frames.append(frame)
        try:
            out = run(node)
        finally:
            self._frames.pop()
        n = out.num_rows_host()
        nbytes = sum(col_bytes(c) for c in out.columns.values())
        self._stats.append(NodeStats(
            _node_name(node), output_rows=n, input_rows=frame["rows"],
            input_bytes=frame["bytes"], output_bytes=nbytes))
        if self._frames:
            self._frames[-1]["rows"] += n
            self._frames[-1]["bytes"] += nbytes
        return out

    def count_input(self, b):
        if self._frames:
            self._frames[-1]["rows"] += b.num_rows_host()
            self._frames[-1]["bytes"] += sum(
                col_bytes(c) for c in b.columns.values())


def node_spans(sp):
    """The node spans under ``sp``, in the order the nodes finished."""
    out = []
    for c in sp.children:
        out.extend(node_spans(c))
        if c.name.startswith("node."):
            out.append(c)
    return out


def node_tree(sp):
    return [(c.name[len("node."):], node_tree(c)) for c in sp.children
            if c.name.startswith("node.")]


def plan_tree(node):
    return [(_node_name(node), [t for s in node.sources
                                for t in plan_tree(s)])]


def execute_span(res):
    got = [sp for sp in res.trace.roots if sp.name == "execute"]
    assert len(got) == 1
    return got[0]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_a_node_span_per_node_stats_entry(runner, name):
    t0 = time.perf_counter()
    res = runner.execute(QUERIES[name])
    t1 = time.perf_counter()
    ex = execute_span(res)
    spans = node_spans(ex)
    assert [sp.name for sp in spans] == [f"node.{s.name}"
                                         for s in res.stats]
    for sp in spans:
        assert ex.start_s <= sp.start_s <= sp.end_s <= ex.end_s
        assert t0 <= sp.start_s and sp.end_s <= t1
        for c in sp.children:
            assert sp.start_s <= c.start_s <= c.end_s <= sp.end_s
    if name in ("q3", "union"):
        # no fused path swallows a node: the spans nest as the plan does
        assert node_tree(ex) == plan_tree(runner.plan_sql(QUERIES[name]))


def test_node_stats_neither_synchronise_nor_read_rows(runner,
                                                      monkeypatch):
    syncs, reads = [], []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    inner = Batch.num_rows_host

    def num_rows_host(self):
        reads.append(sys._getframe(1).f_code.co_name)
        return inner(self)
    monkeypatch.setattr(Batch, "num_rows_host", num_rows_host)
    for sql in QUERIES.values():
        plan = runner.plan_sql(sql)
        ex = Executor(runner.catalogs, session(), runner.device,
                      collect_stats=True)
        out = ex.execute(plan)
        assert not syncs
        assert not {"_stats_wrap", "count_input", "_value_rows_bytes"} \
            & set(reads), reads
        assert ex._unresolved and all(s.output_rows == -1
                                      for s in ex._stats)
        stats = ex.stats
        assert not ex._unresolved
        assert stats[-1].output_rows == out.num_rows_host()
        assert all(s.output_rows >= 0 and s.input_rows >= 0
                   for s in stats)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_resolved_stats_equal_eager_reads(runner, name, monkeypatch):
    def key(stats):
        return [(s.name, s.output_rows, s.input_rows, s.input_bytes,
                 s.output_bytes) for s in stats]
    got = runner.execute(QUERIES[name])
    monkeypatch.setattr(runner, "_make_executor",
                        lambda collect_stats=False: Eager(
                            runner.catalogs, runner.session, runner.device,
                            collect_stats))
    want = runner.execute(QUERIES[name])
    assert got.rows == want.rows
    assert key(got.stats) == key(want.stats)
    assert got.stats[-1].output_rows == len(got.rows)


@pytest.mark.parametrize("q", sorted(WAITS))
def test_device_waits_sit_inside_node_spans(runner, q):
    res = runner.execute(TPCH_QUERIES[q])
    waits = []

    def walk(sp):
        for c in sp.children:
            if c.name == "device_wait":
                assert sp.name.startswith("node."), sp.name
                waits.append(c)
            walk(c)
    walk(execute_span(res))
    assert len(waits) == WAITS[q]


def test_device_wait_needs_an_installed_trace():
    tr = QueryTrace()
    with device_wait():
        pass
    assert ACTIVE.trace is None and not tr.roots
    ACTIVE.trace = tr
    try:
        with tr.span("node.X"):
            with device_wait():
                pass
    finally:
        ACTIVE.trace = None
    assert [c.name for c in tr.roots[0].children] == ["device_wait"]


def test_mesh_stats_arrive_resolved():
    r = LocalQueryRunner(session(), device="cpu", distributed=True,
                         n_devices=2, collect_node_stats=True)
    res = r.execute(TPCH_QUERIES[3])
    assert res.stats and all(s.output_rows >= 0 and s.input_rows >= 0
                             for s in res.stats)
    assert res.stats[-1].output_rows == len(res.rows)
    assert [sp.name for sp in node_spans(execute_span(res))] == \
        [f"node.{s.name}" for s in res.stats]


def test_worker_stats_arrive_resolved():
    from trino_tpu_torch.plan.serde import to_jsonable
    from trino_tpu_torch.server.task_worker import (RemoteTaskClient,
                                                    TaskWorkerServer)
    plan = LocalQueryRunner(device="cpu").plan_sql(
        "SELECT o_orderkey FROM orders WHERE o_totalprice > 300000")
    w = TaskWorkerServer(device="cpu").start()
    try:
        client = RemoteTaskClient(w.base_uri)
        client.submit_fragment("node-spans-1", to_jsonable(plan),
                               catalog="tpch", schema="tiny", part=0,
                               nparts=1, collect_stats=True)
        status = client.wait_done("node-spans-1")
    finally:
        w.stop()
    assert status["state"] == "FINISHED"
    stats = status["nodeStats"]
    assert stats and all(s["output_rows"] >= 0 and s["input_rows"] >= 0
                         for s in stats)
    names = []

    def walk(d):
        for c in d.get("children") or []:
            walk(c)
            if c["name"].startswith("node."):
                names.append(c["name"])
    walk(status["spans"][0])
    assert names == [f"node.{s['name']}" for s in stats]
