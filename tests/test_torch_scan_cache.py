"""The scan cache of the PyTorch engine (exec/scancache.py), on the CPU:
the counterparts of tests/test_scan_cache_budget.py, held against the
JAX engine under the same cache budget.

Entries evict in insertion order under ``CONFIG.scan_cache_bytes``; a
table over the budget falls back to split-by-split reads, and rows never
change with the budget. Whole-table mode is on for a card and off on the
CPU; the tests flip it by monkeypatching ``_whole_table_mode``.
"""

import gc

import pytest

from trino_tpu.config import CONFIG as TPU_CONFIG
from trino_tpu.exec import executor as tpu_ex
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu_torch.config import CONFIG
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec import scancache
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

REL = 1e-9
Q1 = ("SELECT l_returnflag, l_linestatus, sum(l_quantity), count(*), "
      "avg(l_extendedprice) FROM lineitem "
      "WHERE l_shipdate <= DATE '1998-09-02' "
      "GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2")


def _port():
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                            device="cpu")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=REL)
            else:
                assert a == b


@pytest.fixture
def tiny_budget(monkeypatch):
    """A 1 MiB cache in both engines: of the tpch tables at tiny only
    nation and region fit whole."""
    monkeypatch.setattr(CONFIG, "scan_cache_bytes", 1 << 20)
    monkeypatch.setattr(TPU_CONFIG, "scan_cache_bytes", 1 << 20)
    scancache.clear()
    with tpu_ex._SCAN_CACHE_LOCK:
        tpu_ex._SCAN_CACHES.clear()
    yield
    scancache.clear()
    with tpu_ex._SCAN_CACHE_LOCK:
        tpu_ex._SCAN_CACHES.clear()


@pytest.mark.parametrize("whole_table", [False, True])
def test_results_identical_under_tiny_budget(tiny_budget, monkeypatch,
                                             whole_table):
    monkeypatch.setattr(scancache, "_whole_table_mode",
                        lambda device: whole_table)
    monkeypatch.setenv("TRINO_TPU_WHOLE_TABLE", "1" if whole_table else "0")
    got = _port().execute(Q1).rows
    assert scancache.cache_memory_bytes() <= CONFIG.scan_cache_bytes
    want = TpuRunner(session=TpuSession(catalog="tpch", schema="tiny")
                     ).execute(Q1).rows
    _same(got, want)
    # the same query at the default budget, from an empty cache
    scancache.clear()
    monkeypatch.setattr(CONFIG, "scan_cache_bytes", 4 << 30)
    _same(_port().execute(Q1).rows, got)


def test_whole_table_entry_is_read_once(tiny_budget, monkeypatch):
    """Whole-table mode caches a table of several splits that fits, under
    part -1, and drops its per-split entries; the next scan of it is one
    table hit and reads no split."""
    monkeypatch.setattr(scancache, "_whole_table_mode", lambda device: True)
    r = _port()
    r.catalogs.register("tpch", TpchConnector(512, device="cpu"))
    sql = "SELECT c_mktsegment, count(*), sum(c_acctbal) FROM customer " \
          "GROUP BY 1 ORDER BY 1"
    first = r.execute(sql).rows
    before = dict(scancache.STATS)
    assert r.execute(sql).rows == first
    assert scancache.STATS["table_hit"] == before["table_hit"] + 1
    assert scancache.STATS["split_miss"] == before["split_miss"]
    assert scancache.STATS["split_hit"] == before["split_hit"]
    _same(first, _port().execute(sql).rows)


def test_join_under_tiny_budget_equals_the_jax_engine(tiny_budget):
    sql = ("SELECT n_name, count(*) FROM orders "
           "JOIN customer ON o_custkey = c_custkey "
           "JOIN nation ON c_nationkey = n_nationkey "
           "GROUP BY n_name ORDER BY 2 DESC, 1 LIMIT 5")
    got = _port().execute(sql).rows
    assert len(got) == 5
    assert scancache.cache_memory_bytes() <= CONFIG.scan_cache_bytes
    assert got == TpuRunner(session=TpuSession(
        catalog="tpch", schema="tiny")).execute(sql).rows


def test_lru_eviction_under_budget(monkeypatch):
    """Two tables that each fit but not together: the cache keeps its
    budget while both scans succeed."""
    r = _port()
    monkeypatch.setattr(CONFIG, "scan_cache_bytes", 300_000)
    scancache.clear()
    a = r.execute("SELECT count(*) FROM customer").rows[0][0]
    b = r.execute("SELECT count(*), sum(s_acctbal) FROM supplier").rows[0][0]
    assert (a, b) == (1500, 100)
    assert 0 < scancache.cache_memory_bytes() <= 300_000
    scancache.clear()


def test_second_run_hits_the_cache_with_the_same_rows():
    scancache.clear()
    r = _port()
    sql = ("SELECT o_orderpriority, count(*), sum(o_totalprice) "
           "FROM orders GROUP BY 1 ORDER BY 1")
    first = r.execute(sql)
    hits = scancache.STATS["split_hit"]
    held = scancache.cache_memory_bytes()
    assert held > 0
    second = r.execute(sql)
    assert second.rows == first.rows
    assert scancache.STATS["split_hit"] > hits
    assert scancache.cache_memory_bytes() == held
    scancache.clear()


def test_a_dead_runners_cache_goes_with_it():
    """The cache is keyed weakly by connector: once a runner (and its
    connectors) is gone, its cached lanes are freed."""
    scancache.clear()
    r = _port()
    r.execute("SELECT count(*), sum(c_acctbal) FROM customer")
    assert scancache.cache_memory_bytes() > 0
    del r
    gc.collect()
    assert scancache.cache_memory_bytes() == 0


def test_evict_cache_pressure_frees_the_oldest_first():
    scancache.clear()
    r = _port()
    r.execute("SELECT count(*) FROM customer")
    r.execute("SELECT count(*) FROM supplier")
    held = scancache.cache_memory_bytes()
    freed = scancache.evict_cache_pressure(1)
    assert 0 < freed < held
    assert scancache.cache_memory_bytes() == held - freed
    hits = scancache.STATS["split_hit"]
    r.execute("SELECT count(*) FROM supplier")      # still cached
    assert scancache.STATS["split_hit"] == hits + 1
    scancache.clear()


def test_scan_reserves_against_memory_guard(monkeypatch):
    """A table over query_max_memory_per_node fails with the memory
    error, not a device OOM, when the cache cannot hold it."""
    r = _port()
    r.session.set("query_max_memory_per_node", 1 << 10)
    monkeypatch.setattr(CONFIG, "scan_cache_bytes", 0)
    with pytest.raises(QueryError, match="memory limit") as e:
        # ORDER BY keeps the aggregation paths out: the scan itself must
        # materialise
        r.execute("SELECT * FROM orders ORDER BY o_orderkey LIMIT 5")
    assert e.value.error_name == "EXCEEDED_LOCAL_MEMORY_LIMIT"


def test_a_scan_too_large_for_the_cache_bypasses_it(monkeypatch):
    """A scan whose table could never fit the cache reads its splits
    directly: nothing is inserted, so nothing of other tables is evicted
    for entries that could not be hit, and the rows do not change."""
    scancache.clear()
    r = _port()
    r.execute("SELECT count(*) FROM supplier")
    held = scancache.cache_memory_bytes()
    assert held > 0
    monkeypatch.setattr(CONFIG, "scan_cache_bytes", 1 << 20)
    before = dict(scancache.STATS)
    got = r.execute(Q1).rows
    assert scancache.STATS["split_bypass"] > before["split_bypass"]
    assert scancache.STATS["split_miss"] == before["split_miss"]
    assert scancache.cache_memory_bytes() == held
    monkeypatch.setattr(CONFIG, "scan_cache_bytes", 4 << 30)
    scancache.clear()
    _same(got, _port().execute(Q1).rows)
    scancache.clear()


def test_a_reservation_evicts_cached_lanes_past_the_budget(monkeypatch):
    """The cache yields to a query: a reservation the card cannot hold
    evicts cached lanes, oldest first, for the difference, and becomes
    the query's peak reservation. The card's free memory is set here; on
    the CPU nothing is evicted."""
    from trino_tpu_torch.exec.executor import Executor
    scancache.clear()
    r = _port()
    r.execute("SELECT count(*) FROM customer")
    r.execute("SELECT count(*) FROM supplier")
    held = scancache.cache_memory_bytes()
    ex = Executor(r.catalogs, r.session, r.device)
    ex._account(held)
    assert scancache.cache_memory_bytes() == held
    monkeypatch.setattr(Executor, "_free_device_bytes", lambda self: 0)
    ex._account(held // 2)
    assert ex.peak_reserved_bytes == held
    assert 0 < scancache.cache_memory_bytes() <= held - held // 2
    ex._account(held)
    assert scancache.cache_memory_bytes() == 0
    scancache.clear()
