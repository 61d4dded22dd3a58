"""The port's /metrics families against the JAX package's, on the CPU.

Every family the reference registers is registered by the port with the
same kind and labels, except the two that describe the JAX package's
compiled-program caches (``trino_tpu_jit_cache_total``,
``trino_tpu_jit_cache_evictions_total``): the port compiles no programs
(exec/progkey.py), so there is nothing for them to count. The families
this slice adds carry the reference's help text too. Each of the six
non-ragged ones moves on a query that should move it, and where both
packages count the same thing (splits read, streamed chunks, the bytes
and entries of the scan cache) the counts are equal. Also here: a plan
holding ExchangeNodes runs through the port (the exchange is the
identity in one process) and equals the reference.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

import trino_tpu.exec.executor as tpu_executor
import trino_tpu.obs.metrics as tpu_metrics
from trino_tpu.config import CONFIG as TPU_CONFIG
from trino_tpu.exec.executor import Executor as TpuExecutor
from trino_tpu.plan import nodes as tpu_nodes
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
import trino_tpu_torch.obs.metrics as port_metrics
from trino_tpu_torch.config import CONFIG
from trino_tpu_torch.exec import scancache
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.plan import nodes as port_nodes
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

# the reference's families that name a JAX-only mechanism
NO_COUNTERPART = {"trino_tpu_jit_cache_total",
                  "trino_tpu_jit_cache_evictions_total"}
# the families this slice brought to the port
SLICE_FAMILIES = {
    "trino_tpu_splits_read_total", "trino_tpu_spill_bytes_total",
    "trino_tpu_scan_cache_bytes", "trino_tpu_stream_chunks_total",
    "trino_tpu_stream_bytes_h2d_total",
    "trino_tpu_stream_transfers_overlapped_total",
    "trino_tpu_ragged_batch_batches_total",
    "trino_tpu_ragged_batch_queries_total",
    "trino_tpu_ragged_batch_rows_total",
    "trino_tpu_ragged_batch_fallbacks_total", "trino_tpu_ragged_batch_size",
}
ROOT = Path(__file__).resolve().parent.parent
MOVED = ["trino_tpu_splits_read_total", "trino_tpu_spill_bytes_total",
         "trino_tpu_scan_cache_bytes", "trino_tpu_stream_chunks_total",
         "trino_tpu_stream_bytes_h2d_total",
         "trino_tpu_stream_transfers_overlapped_total"]


# run in a fresh interpreter: the registry is process-wide, and what test
# files run earlier in the same worker registered must not count
_FAMILIES = """
import importlib, json, pkgutil, sys
pkg = sys.argv[1]
root = importlib.import_module(pkg)
for m in pkgutil.walk_packages(root.__path__, pkg + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
reg = importlib.import_module(pkg + ".obs.metrics").METRICS
print(json.dumps({n: [type(f).__name__, list(f.labelnames), f.help]
                  for n, f in reg._metrics.items()}))
"""


def _families(pkg: str) -> dict:
    """name -> (kind, labels, help) of every family the package registers
    once all its modules are imported (some register where they live),
    in an interpreter of its own."""
    out = subprocess.run([sys.executable, "-c", _FAMILIES, pkg],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT), check=True)
    return {n: (kind, tuple(labels), help_)
            for n, (kind, labels, help_)
            in json.loads(out.stdout.splitlines()[-1]).items()}


def test_port_registers_every_reference_family():
    ref, port = _families("trino_tpu"), _families("trino_tpu_torch")
    assert set(ref) - set(port) == NO_COUNTERPART
    assert set(port) <= set(ref)
    for name in set(ref) - NO_COUNTERPART:
        assert port[name][:2] == ref[name][:2], name
    for name in SLICE_FAMILIES:
        assert port[name] == ref[name], name


def _samples(registry) -> dict:
    return {n: dict(registry._metrics[n].samples()) for n in MOVED
            if n in registry._metrics}


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for name, samples in after.items():
        for labels, v in samples.items():
            d = v - before.get(name, {}).get(labels, 0.0)
            if d:
                out[(name, labels)] = d
    return out


def _run(runner, registry, sql):
    before = _samples(registry)
    res = runner.execute(sql)
    return _delta(before, _samples(registry)), res


def _pair(props=None):
    s, ts = Session(catalog="tpch", schema="tiny"), \
        TpuSession(catalog="tpch", schema="tiny")
    for k, v in (props or {}).items():
        s.set(k, v)
        ts.set(k, v)
    return LocalQueryRunner(session=s, device="cpu"), TpuRunner(session=ts)


@pytest.mark.parametrize("sql,props,moves", [
    # a split read through the scan cache (a miss: the cache grows)
    ("SELECT count(*) FROM orders", {},
     {"trino_tpu_splits_read_total", "trino_tpu_scan_cache_bytes"}),
    # a streamed chain under a tiny chunk budget
    ("SELECT o_orderkey, o_totalprice * 2 FROM orders "
     "WHERE o_orderkey < 600", {"stream_chunk_rows": 64},
     {"trino_tpu_splits_read_total", "trino_tpu_stream_chunks_total",
      "trino_tpu_stream_bytes_h2d_total"}),
    # a streamed aggregation
    ("SELECT o_orderstatus, sum(o_totalprice) FROM orders GROUP BY 1",
     {"stream_chunk_rows": 4096},
     {"trino_tpu_splits_read_total", "trino_tpu_stream_chunks_total",
      "trino_tpu_stream_bytes_h2d_total"}),
], ids=["split_read", "streamed_chain", "streamed_agg"])
def test_families_move_and_equal_the_reference(sql, props, moves):
    scancache.clear()
    port, tpu = _pair(props)
    tpu_executor._SCAN_CACHES.clear()
    got, res = _run(port, port_metrics.METRICS, sql)
    want, _ = _run(tpu, tpu_metrics.METRICS, sql)
    assert {name for name, _ in got} >= moves
    for key in ((n, ()) for n in ("trino_tpu_splits_read_total",)):
        assert got[key] == want[key]
    assert got.get(("trino_tpu_stream_chunks_total", ("chain",))) == \
        want.get(("trino_tpu_stream_chunks_total", ("chain",)))
    assert got.get(("trino_tpu_stream_chunks_total", ("agg",))) == \
        want.get(("trino_tpu_stream_chunks_total", ("agg",)))
    # the query's own counts are what the families moved by
    assert sum(v for (n, _), v in got.items()
               if n == "trino_tpu_stream_chunks_total") == res.stream_chunks
    assert got.get(("trino_tpu_stream_bytes_h2d_total", ()), 0) == \
        res.stream_h2d_bytes
    # the CPU times no copy: none is counted hidden
    assert ("trino_tpu_stream_transfers_overlapped_total", ()) not in got
    assert res.stream_overlapped == 0


def test_scan_cache_bytes_and_entries_equal_the_reference():
    """After the same scans on fresh caches, each package's gauge holds
    its cache's bytes, and the two caches hold the same entries."""
    scancache.clear()
    tpu_executor._SCAN_CACHES.clear()
    port, tpu = _pair()
    for sql in ("SELECT count(*) FROM lineitem WHERE l_quantity < 10",
                "SELECT sum(o_totalprice) FROM orders",
                "SELECT o_orderkey FROM orders WHERE o_orderkey = 7"):
        port.execute(sql)
        tpu.execute(sql)
    p_conn = port.catalogs.connector("tpch")
    t_conn = tpu.catalogs.connector("tpch")
    p_state = scancache._SCAN_CACHES[p_conn]
    t_state = tpu_executor._SCAN_CACHES[t_conn]
    assert sorted(map(repr, p_state["entries"])) == \
        sorted(map(repr, t_state["entries"]))
    assert port_metrics.METRICS._metrics[
        "trino_tpu_scan_cache_bytes"].value(connector="tpch") == \
        p_state["bytes"] > 0
    assert p_state["bytes"] == t_state["bytes"]
    scancache.clear()
    assert port_metrics.METRICS._metrics[
        "trino_tpu_scan_cache_bytes"].value(connector="tpch") == 0


def test_spill_bytes_move_with_the_query(monkeypatch):
    sql = ("SELECT o_orderpriority, count(*) c, sum(l_quantity) s "
           "FROM orders JOIN lineitem ON l_orderkey = o_orderkey "
           "GROUP BY o_orderpriority ORDER BY 1")
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    monkeypatch.setattr(TPU_CONFIG, "max_batch_rows", 4096)
    port, tpu = _pair()
    got, res = _run(port, port_metrics.METRICS, sql)
    want, tres = _run(tpu, tpu_metrics.METRICS, sql)
    assert res.spill_bytes > 0
    assert got[("trino_tpu_spill_bytes_total", ())] == res.spill_bytes
    assert want[("trino_tpu_spill_bytes_total", ())] > 0
    assert res.rows == tres.rows


def test_scrape_shows_every_slice_family():
    """The rendered exposition (what GET /metrics serves) carries each
    family this slice added, with its HELP and TYPE lines."""
    import trino_tpu_torch.exec.executor  # noqa: F401
    import trino_tpu_torch.exec.streamjoin  # noqa: F401
    import trino_tpu_torch.exec.taskexec  # noqa: F401
    text = port_metrics.METRICS.render()
    for name in SLICE_FAMILIES:
        assert f"# HELP {name} " in text, name
        assert f"# TYPE {name} " in text, name


def _with_exchanges(node, nodes_mod):
    """Each join's inputs and each aggregation's input behind an
    ExchangeNode, as a fragmented or decoded plan holds them."""
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, nodes_mod.PlanNode):
            v = _with_exchanges(v, nodes_mod)
            if isinstance(node, nodes_mod.JoinNode):
                v = nodes_mod.ExchangeNode(v, "repartition")
            elif isinstance(node, nodes_mod.AggregationNode):
                v = nodes_mod.ExchangeNode(v, "gather", "local")
            changes[f.name] = v
    return dataclasses.replace(node, **changes) if changes else node


@pytest.mark.parametrize("sql", [
    "SELECT o_orderpriority, count(*) FROM orders JOIN lineitem "
    "ON l_orderkey = o_orderkey WHERE l_quantity > 45 "
    "GROUP BY o_orderpriority ORDER BY 1",
    "SELECT n_name, r_name FROM nation JOIN region "
    "ON n_regionkey = r_regionkey ORDER BY n_name",
])
def test_exchange_node_plan_equals_the_reference(sql):
    port, tpu = LocalQueryRunner(device="cpu"), TpuRunner()

    def run(runner, nodes_mod, executor, device):
        plan = runner.plan_sql(sql)
        wrapped = _with_exchanges(plan, nodes_mod)
        assert "Exchange" in "\n".join(nodes_mod.plan_tree_lines(wrapped))
        ex = (executor(runner.catalogs, runner.session) if device is None
              else executor(runner.catalogs, runner.session, device))
        return ex.execute(wrapped).to_pylist()

    want = run(tpu, tpu_nodes, TpuExecutor, None)
    got = run(port, port_nodes, Executor, port.device)
    assert got == want
    assert got == port.execute(sql).rows
