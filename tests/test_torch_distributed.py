"""SQL over the port's device mesh (exec/distributed.py, 8 shards on the
CPU) against the JAX package: the distributed counterparts of the
reference's SQL cases (tests/test_tpch_suite.py, test_tpcds.py,
test_aggregates.py, test_hll.py, test_join_verify.py and
test_dynamic_filter.py). Integers, strings and dates match exactly,
doubles within rel 1e-9.

The tier-1 cases hold the port's mesh runner to the JAX engine on one
device (the reference's own tests hold its mesh runner to that engine),
plus q6 to the JAX package's 8-device mesh runner itself; the `slow`
cases hold all 22 TPC-H queries and TPC-DS q64 to the JAX mesh runner,
whose XLA compiles take minutes here. The reference marks the same
queries slow.
"""

import math

import pytest
import torch

from trino_tpu.benchmarks.tpcds_queries import TPCDS_QUERIES
from trino_tpu.benchmarks.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession

from trino_tpu_torch.exec.distributed import DistributedExecutor
from trino_tpu_torch.plan.nodes import JoinNode
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

REL = 1e-9
N_SHARDS = 8


def _key(row):
    return tuple((v is None, str(type(v)), v) for v in row)


def _same_rows(got, want, ordered: bool):
    assert len(got) == len(want)
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a)
            elif isinstance(b, float):
                assert a == pytest.approx(b, rel=REL)
            else:
                assert a == b


def _ordered(sql: str) -> bool:
    return "order by" in sql.lower()


@pytest.fixture(scope="module")
def tpu():
    return TpuRunner()


@pytest.fixture(scope="module")
def dist():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield LocalQueryRunner(device="cpu", distributed=True,
                           n_devices=N_SHARDS)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tpu_dist():
    return TpuRunner(distributed=True, n_devices=N_SHARDS)


# ---- TPC-H ------------------------------------------------------------------

@pytest.mark.parametrize("qn", [1, 3, 6, 12, 18])
def test_tpch_distributed_matches_jax(tpu, dist, qn):
    sql = TPCH_QUERIES[qn]
    _same_rows(dist.execute(sql).rows, tpu.execute(sql).rows,
               _ordered(sql))


def test_q6_distributed_matches_the_jax_mesh_runner(dist, tpu_dist):
    sql = TPCH_QUERIES[6]
    _same_rows(dist.execute(sql).rows, tpu_dist.execute(sql).rows, True)


# queries the JAX mesh runner cannot run (ROADMAP C8): q20's LEFT join
# with a residual reaches `_shard_join`'s null padding, whose
# `np.asarray(c.data).dtype` converts a traced lane inside shard_map
# (trino_tpu/exec/distributed.py:914); the port is held to the JAX
# engine on one device there instead
TPU_MESH_FAULTS = (20,)


@pytest.mark.slow
@pytest.mark.parametrize("qn", sorted(TPCH_QUERIES))
def test_tpch_distributed_matches_the_jax_mesh_runner(tpu, dist, tpu_dist,
                                                      qn):
    sql = TPCH_QUERIES[qn]
    if qn in TPU_MESH_FAULTS:
        import jax
        with pytest.raises(jax.errors.TracerArrayConversionError):
            tpu_dist.execute(sql)
        want = tpu.execute(sql).rows
    else:
        want = tpu_dist.execute(sql).rows
    _same_rows(dist.execute(sql).rows, want, _ordered(sql))


def test_distributed_runner_shards_and_stats(dist):
    """The mesh is 8 CPU shards; node stats ride the mesh path too."""
    assert dist.mesh.size == N_SHARDS
    r = LocalQueryRunner(device="cpu", mesh=dist.mesh,
                         collect_node_stats=True)
    res = r.execute("SELECT count(*) FROM lineitem WHERE l_quantity > 10")
    assert res.stats and any(s.name == "TableScan" and s.output_rows > 0
                             for s in res.stats)


# ---- PARTITIONED joins ------------------------------------------------------

def _partitioned(dist) -> LocalQueryRunner:
    s = Session(catalog="tpch", schema="tiny")
    s.set("join_distribution_type", "PARTITIONED")
    return LocalQueryRunner(s, device="cpu", mesh=dist.mesh)


def test_partitioned_join_matches_local(tpu, dist):
    """Forced PARTITIONED: both sides repartitioned by key hash, then a
    join per shard."""
    part = _partitioned(dist)
    q = ("SELECT n_name, count(*) AS c FROM nation JOIN customer "
         "ON c_nationkey = n_nationkey GROUP BY n_name ORDER BY 1")
    assert part.execute(q).rows == tpu.execute(q).rows
    plan = part.plan_sql("SELECT count(*) FROM orders JOIN lineitem "
                         "ON l_orderkey = o_orderkey")

    def find(n):
        if isinstance(n, JoinNode):
            return n
        for s in n.sources:
            j = find(s)
            if j is not None:
                return j
        return None
    assert str(find(plan).distribution).upper() == "PARTITIONED"


def test_partitioned_q3_matches_local(tpu, dist):
    sql = TPCH_QUERIES[3]
    _same_rows(_partitioned(dist).execute(sql).rows,
               tpu.execute(sql).rows, True)


def test_partitioned_left_join_with_residual(tpu, dist):
    q = ("SELECT c_custkey, count(o_orderkey) FROM customer LEFT JOIN "
         "orders ON o_custkey = c_custkey AND o_totalprice > 300000 "
         "GROUP BY c_custkey ORDER BY 2 DESC, 1 LIMIT 20")
    assert _partitioned(dist).execute(q).rows == tpu.execute(q).rows


# ---- dynamic filtering (tests/test_dynamic_filter.py) ------------------------

DF_SQL = ("SELECT count(*), sum(l_extendedprice) FROM tpch.tiny.lineitem "
          "JOIN (SELECT o_orderkey FROM tpch.tiny.orders "
          "      WHERE o_totalprice > 400000) t "
          "ON l_orderkey = o_orderkey")


def test_dynamic_filter_correct_and_effective(tpu, dist):
    _same_rows(dist.execute(DF_SQL).rows, tpu.execute(DF_SQL).rows, True)
    ex = DistributedExecutor(dist.catalogs,
                             Session(catalog="tpch", schema="tiny"),
                             dist.mesh, collect_stats=True)
    ex.execute(dist.plan_sql(DF_SQL))
    before, after = ex.dynamic_filter_rows
    # the exchange input drops by >99% on this shape (~22 hot orders)
    assert after < before * 0.01


def test_dynamic_filter_flag_disables(dist):
    s = Session(catalog="tpch", schema="tiny")
    s.set("enable_dynamic_filtering", "false")
    ex = DistributedExecutor(dist.catalogs, s, dist.mesh,
                             collect_stats=True)
    ex.execute(dist.plan_sql(DF_SQL))
    assert not hasattr(ex, "dynamic_filter_rows")


def test_dynamic_filter_left_join_untouched(tpu, dist):
    sql = ("SELECT count(*), count(t.o_orderkey) FROM "
           "tpch.tiny.lineitem LEFT JOIN "
           "(SELECT o_orderkey FROM tpch.tiny.orders "
           " WHERE o_totalprice > 400000) t "
           "ON l_orderkey = t.o_orderkey")
    assert dist.execute(sql).rows == tpu.execute(sql).rows


def test_dynamic_filter_empty_build(tpu, dist):
    sql = ("SELECT count(*) FROM tpch.tiny.lineitem JOIN "
           "(SELECT o_orderkey FROM tpch.tiny.orders "
           " WHERE o_totalprice > 99999999) t "
           "ON l_orderkey = t.o_orderkey")
    assert dist.execute(sql).rows == tpu.execute(sql).rows == [[0]]


# ---- aggregates (tests/test_aggregates.py, tests/test_hll.py) ----------------

def test_distributed_nondecomposable_grouped(tpu, dist):
    sql = ("SELECT l_partkey % 5, count(DISTINCT l_quantity), "
           "min_by(l_orderkey, l_extendedprice), "
           "approx_percentile(l_quantity, 0.5) "
           "FROM tpch.tiny.lineitem GROUP BY l_partkey % 5 ORDER BY 1")
    _same_rows(dist.execute(sql).rows, tpu.execute(sql).rows, True)


def test_distributed_nondecomposable_global(tpu, dist):
    sql = ("SELECT count(DISTINCT l_suppkey), "
           "max_by(l_orderkey, l_extendedprice) FROM tpch.tiny.lineitem")
    _same_rows(dist.execute(sql).rows, tpu.execute(sql).rows, True)


def test_distributed_decomposable_with_post_functions(tpu, dist):
    sql = ("SELECT l_returnflag, avg(l_quantity), stddev(l_discount), "
           "count_if(l_tax > 0.04), sum(l_extendedprice) "
           "FROM lineitem GROUP BY l_returnflag ORDER BY 1")
    _same_rows(dist.execute(sql).rows, tpu.execute(sql).rows, True)
    g = ("SELECT avg(l_quantity), variance(l_discount), count(*) "
         "FROM lineitem WHERE l_shipmode = 'AIR'")
    _same_rows(dist.execute(g).rows, tpu.execute(g).rows, True)


def test_hll_distributed_matches_local(tpu, dist):
    sql = ("SELECT l_returnflag, cardinality(approx_set(l_partkey)) "
           "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag")
    assert dist.execute(sql).rows == tpu.execute(sql).rows


# ---- join verification (tests/test_join_verify.py) ---------------------------

@pytest.fixture()
def weak_hash(monkeypatch):
    """Collapse combined join hashes to 4 values: multi-key joins then
    see constant collisions unless re-verification drops them."""
    from trino_tpu_torch.ops import join as join_ops

    def weak(hashes):
        acc = torch.zeros_like(hashes[0])
        for h in hashes:
            acc = acc + h
        return acc & 3

    monkeypatch.setattr(join_ops, "combine_hashes", weak)
    return weak


def test_distributed_partitioned_multikey(tpu, dist, weak_hash):
    q = ("SELECT count(*) FROM lineitem l JOIN lineitem r "
         "ON l.l_orderkey = r.l_orderkey "
         "AND l.l_linenumber = r.l_linenumber "
         "WHERE l.l_quantity > 49")
    assert _partitioned(dist).execute(q).rows == tpu.execute(q).rows


def test_distributed_replicated_multikey(tpu, dist, weak_hash):
    q = ("SELECT count(*), sum(ps_supplycost) FROM partsupp JOIN "
         "(SELECT l_partkey, l_suppkey FROM lineitem "
         " WHERE l_quantity > 48) t "
         "ON ps_partkey = l_partkey AND ps_suppkey = l_suppkey "
         "WHERE ps_partkey < 300")
    _same_rows(dist.execute(q).rows, tpu.execute(q).rows, True)


# ---- TPC-DS (tests/test_tpcds.py) --------------------------------------------

@pytest.mark.slow
def test_q64_distributed_matches_local():
    sql = TPCDS_QUERIES[64]
    port = LocalQueryRunner(Session(catalog="tpcds", schema="tiny"),
                            device="cpu", distributed=True,
                            n_devices=N_SHARDS)
    want = TpuRunner(session=TpuSession(catalog="tpcds", schema="tiny"),
                     distributed=True, n_devices=N_SHARDS)
    _same_rows(port.execute(sql).rows, want.execute(sql).rows, True)
