"""The collection aggregates and the quantile digests in the PyTorch
engine, against the JAX engine on the CPU at tpch.tiny.

The collection and digest tests of tests/test_aggregates.py are cases
here (map_union, multimap_agg, numeric_histogram, tdigest_agg,
qdigest_agg and merge, value_at_quantile, values_at_quantiles), then
array_agg, map_agg, histogram and approx_most_frequent grouped and
global, quantile_at_value, digests over groups, and ARRAY, MAP and ROW
columns through CTAS, INSERT and DELETE of the memory connector. A
digest is compared by its base64 text, so its centroids are exact. The
host code of ops/digest.py and ops/collections.py is also held
against the JAX package's on seeded numpy data.
"""

import numpy as np
import pytest

from _torch_nested import check, engines, same  # noqa: F401
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.runner import LocalQueryRunner

# the collection and digest SQL of tests/test_aggregates.py
REFERENCE_SQL = [
    "SELECT map_union(m) FROM (VALUES map(ARRAY[1, 2], ARRAY[10, 20]), "
    "map(ARRAY[2, 3], ARRAY[99, 30])) t(m)",
    "SELECT g, map_union(m) FROM (VALUES (1, map(ARRAY['a'], ARRAY[1])), "
    "(1, map(ARRAY['b'], ARRAY[2])), (2, map(ARRAY['c'], ARRAY[3])), "
    "(2, CAST(NULL AS map(varchar, integer)))) t(g, m) GROUP BY g ORDER BY g",
    "SELECT multimap_agg(k, v) FROM (VALUES ('a', 1), ('b', 2), ('a', 3)) "
    "t(k, v)",
    "SELECT g, multimap_agg(k, v) FROM (VALUES (1, 'x', 1), (1, 'x', 2), "
    "(2, 'y', 3)) t(g, k, v) GROUP BY g ORDER BY g",
    "SELECT numeric_histogram(4, x) FROM (VALUES 1.0, 1.0, 2.0, 50.0, 51.0, "
    "100.0) t(x)",
    "SELECT numeric_histogram(2, x) FROM (VALUES 1.0, 2.0, 100.0) t(x)",
    "SELECT value_at_quantile(tdigest_agg(x), 0.5e0), "
    "value_at_quantile(tdigest_agg(x), 0.0e0), "
    "value_at_quantile(tdigest_agg(x), 1.0e0) "
    "FROM (VALUES 1.0e0, 2.0e0, 3.0e0, 4.0e0, 5.0e0) t(x)",
    "SELECT value_at_quantile(merge(d), 0.5e0) FROM (SELECT qdigest_agg(x) "
    "AS d FROM (VALUES 1, 2, 3) t(x) UNION ALL SELECT qdigest_agg(x) "
    "FROM (VALUES 4, 5) t(x)) u",
    "SELECT value_at_quantile(tdigest_agg(l_extendedprice), 0.5e0) "
    "FROM tpch.tiny.lineitem",
    "SELECT values_at_quantiles(tdigest_agg(x), ARRAY[0.0e0, 0.5e0, 1.0e0]) "
    "FROM (VALUES 10.0e0, 20.0e0, 30.0e0) t(x)",
]

MORE_SQL = [
    # the digests themselves (their base64 text: exact centroids)
    "SELECT tdigest_agg(x) FROM (VALUES 1.0e0, 2.0e0) t(x)",
    "SELECT qdigest_agg(x), qdigest_agg(x, 2), qdigest_agg(x, 1, 0.5e0) "
    "FROM (VALUES 1, 2, 3) t(x)",
    "SELECT o_orderpriority, tdigest_agg(o_totalprice) FROM tpch.tiny.orders "
    "GROUP BY 1 ORDER BY 1",
    "SELECT value_at_quantile(tdigest_agg(o_totalprice), 0.5e0), "
    "values_at_quantiles(qdigest_agg(o_totalprice), ARRAY[0.1e0, 0.9e0]) "
    "FROM tpch.tiny.orders",
    # complex_sf10's (d), at tiny
    "SELECT o_orderpriority, value_at_quantile(tdigest_agg(o_totalprice), "
    "0.5e0), values_at_quantiles(qdigest_agg(o_totalprice), "
    "ARRAY[0.1e0, 0.9e0]) FROM tpch.tiny.orders GROUP BY 1 ORDER BY 1",
    "SELECT o_orderstatus, quantile_at_value(merge(d), 100000e0), "
    "value_at_quantile(merge(d), 0.5e0), merge(d) FROM "
    "(SELECT o_orderstatus, o_orderpriority, tdigest_agg(o_totalprice) d "
    "FROM tpch.tiny.orders GROUP BY 1, 2) GROUP BY 1 ORDER BY 1",
    "SELECT o_orderstatus, value_at_quantile(qdigest_agg(o_custkey), 0.5e0) "
    "FROM tpch.tiny.orders GROUP BY 1 ORDER BY 1",
    # the collection aggregates, grouped and global
    "SELECT numeric_histogram(3, l_quantity) FROM tpch.tiny.lineitem",
    "SELECT l_returnflag, numeric_histogram(3, l_extendedprice, l_quantity) "
    "FROM tpch.tiny.lineitem GROUP BY 1 ORDER BY 1",
    "SELECT k, map_union(m) FROM (SELECT n_regionkey k, map(ARRAY[n_name], "
    "ARRAY[n_nationkey]) m FROM tpch.tiny.nation) GROUP BY k ORDER BY k",
    "SELECT n_regionkey, multimap_agg(n_nationkey % 3, n_name) "
    "FROM tpch.tiny.nation GROUP BY 1 ORDER BY 1",
    "SELECT o_orderpriority, histogram(o_orderstatus) FROM tpch.tiny.orders "
    "GROUP BY 1 ORDER BY 1",
    "SELECT l_returnflag, map_agg(l_linestatus, l_quantity) "
    "FROM tpch.tiny.lineitem GROUP BY 1 ORDER BY 1",
    "SELECT histogram(x), map_agg(x, y) FILTER (WHERE y > 1) "
    "FROM (VALUES (1, 1), (2, 2), (1, 3), (NULL, 4)) t(x, y)",
    "SELECT o_orderstatus, approx_most_frequent(2, o_orderpriority) "
    "FROM tpch.tiny.orders GROUP BY 1 ORDER BY 1",
    "SELECT array_agg(x) FILTER (WHERE x IS NULL), array_agg(y) "
    "FROM (VALUES (1, 'a'), (NULL, NULL), (3, 'c')) t(x, y)",
    "SELECT o_orderstatus, array_agg(o_orderkey) FILTER "
    "(WHERE o_orderkey < 40) FROM tpch.tiny.orders GROUP BY 1 ORDER BY 1",
]

AGGREGATE_KINDS = {"array_agg", "map_agg", "histogram",
                   "approx_most_frequent", "map_union", "multimap_agg",
                   "numeric_histogram", "tdigest_agg", "qdigest_agg",
                   "merge"}


@pytest.mark.parametrize("i", range(len(REFERENCE_SQL)))
def test_reference_sql(engines, i):
    check(engines, REFERENCE_SQL[i])


@pytest.mark.parametrize("i", range(len(MORE_SQL)))
def test_more_sql(engines, i):
    check(engines, MORE_SQL[i])


def test_every_collection_and_digest_kind_has_a_case():
    import test_torch_arrays as arrays
    import test_torch_maps_rows_lambdas as maps
    sql = " ".join(REFERENCE_SQL + MORE_SQL + arrays.REFERENCE_SQL
                   + arrays.MORE_SQL + maps.REFERENCE_SQL
                   + maps.MORE_SQL).lower()
    for kind in AGGREGATE_KINDS:
        assert kind + "(" in sql, kind
    assert "merge(d)" in sql


def test_tdigest_quantile_within_its_rank_error(engines):
    """As tests/test_aggregates.py checks the JAX engine: the median of
    tiny's l_extendedprice within 5% of numpy's exact one."""
    rows = check(engines, "SELECT value_at_quantile(tdigest_agg("
                          "l_extendedprice), 0.5e0) FROM tpch.tiny.lineitem")
    prices = np.asarray([r[0] for r in engines[1].execute(
        "SELECT l_extendedprice FROM tpch.tiny.lineitem").rows])
    exact = float(np.quantile(prices, 0.5))
    assert abs(rows[0][0] - exact) / exact < 0.05


def test_digest_construction_matches_the_reference_on_seeded_data():
    """ops/digest.py and ops/collections.py against the JAX package's on
    the same seeded lanes: identical centroids, entries and groups."""
    import jax.numpy as jnp
    import torch
    from trino_tpu.columnar import Column as TpuColumn
    from trino_tpu.ops import collections as tpu_coll, digest as tpu_dg
    from trino_tpu.types import DOUBLE as TPU_DOUBLE, T_DIGEST as TPU_TD
    from trino_tpu_torch.columnar import Column
    from trino_tpu_torch.ops import collections as coll, digest as dg
    from trino_tpu_torch.types import DOUBLE, T_DIGEST
    rng = np.random.default_rng(10)
    n = 5000
    vals = rng.gamma(2.0, 1000.0, n)
    gid = rng.integers(0, 7, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    order = np.argsort(gid, kind="stable")
    want_groups = tpu_coll.rows_by_group(jnp.asarray(order),
                                         jnp.asarray(gid[order]),
                                         jnp.asarray(valid[order]), 7)
    groups = coll.rows_by_group(torch.from_numpy(order),
                                torch.from_numpy(gid[order]),
                                torch.from_numpy(valid[order]), 7)
    assert all((a == b).all() for a, b in zip(groups, want_groups))
    gv = np.ones(7, bool)
    want = tpu_dg.grouped_digest(TpuColumn(TPU_DOUBLE, jnp.asarray(vals)),
                                 want_groups, jnp.asarray(gv), TPU_TD, 100)
    got = dg.grouped_digest(Column(DOUBLE, torch.from_numpy(vals)), groups,
                            torch.from_numpy(gv), T_DIGEST, 100)
    for a, b in (("data", "data"), ("data2", "data2")):
        assert np.array_equal(getattr(got, a).numpy(),
                              np.asarray(getattr(want, b)))
    assert np.array_equal(got.elements.data.numpy(),
                          np.asarray(want.elements.data))
    assert np.array_equal(got.elements2.data.numpy(),
                          np.asarray(want.elements2.data))
    merged = dg.grouped_digest_merge(got, [np.arange(7)], torch.ones(1,
                                     dtype=torch.bool), 50)
    want_m = tpu_dg.grouped_digest_merge(want, [np.arange(7)],
                                         jnp.ones(1, bool), 50)
    assert np.array_equal(merged.elements.data.numpy(),
                          np.asarray(want_m.elements.data))
    hist = coll.grouped_numeric_histogram(
        Column(DOUBLE, torch.from_numpy(vals)), groups,
        torch.from_numpy(gv), 10)
    want_h = tpu_coll.grouped_numeric_histogram(
        TpuColumn(TPU_DOUBLE, jnp.asarray(vals)), want_groups,
        jnp.asarray(gv), 10)
    assert np.array_equal(hist.elements.data.numpy(),
                          np.asarray(want_h.elements.data))
    assert np.array_equal(hist.elements2.data.numpy(),
                          np.asarray(want_h.elements2.data))


STATEMENTS = [
    "CREATE TABLE memory.default.t AS SELECT n_regionkey k, "
    "array_agg(n_name) a, map_agg(n_nationkey, n_name) m, "
    "CAST(ROW(n_regionkey, 'x') AS ROW(p BIGINT, q VARCHAR)) r "
    "FROM tpch.tiny.nation GROUP BY n_regionkey",
    "SELECT k, a, m, r FROM memory.default.t ORDER BY k",
    "INSERT INTO memory.default.t SELECT 9, ARRAY['zz'], "
    "map(ARRAY[99], ARRAY['q']), CAST(ROW(9, 'y') AS ROW(p BIGINT, "
    "q VARCHAR))",
    "SELECT k, cardinality(a), a, r.q, m FROM memory.default.t ORDER BY k",
    "SELECT k, e FROM memory.default.t CROSS JOIN UNNEST(a) u(e) "
    "ORDER BY k, e",
    "DELETE FROM memory.default.t WHERE k = 9",
    "SELECT count(*), sum(cardinality(a)) FROM memory.default.t",
]


def test_nested_columns_through_the_memory_connector():
    """CTAS, INSERT (array(varchar(2)) into array(varchar(25)), an
    implicit coercion), UNNEST over a stored table and DELETE give the
    JAX runner's rows."""
    jax_runner, port = TpuRunner(), LocalQueryRunner(device="cpu")
    for sql in STATEMENTS:
        want = jax_runner.execute(sql).rows
        got = port.execute(sql).rows
        assert same(got, want), (sql, got, want)


def test_digest_through_the_memory_connector():
    """The port stores a digest column and reads it back (the JAX runner
    cannot: its memory chunks drop the weights): the quantiles equal
    those of the digests computed in the query."""
    port = LocalQueryRunner(device="cpu")
    port.execute("CREATE TABLE memory.default.d AS SELECT o_orderpriority p, "
                 "tdigest_agg(o_totalprice) d FROM tpch.tiny.orders "
                 "GROUP BY 1")
    got = port.execute("SELECT p, value_at_quantile(d, 0.5e0) "
                       "FROM memory.default.d ORDER BY 1").rows
    want = port.execute("SELECT o_orderpriority, value_at_quantile("
                        "tdigest_agg(o_totalprice), 0.5e0) "
                        "FROM tpch.tiny.orders GROUP BY 1 ORDER BY 1").rows
    assert got == want


@pytest.mark.parametrize("seed", range(6))
def test_c_merge_loop_equals_the_python_loop(seed):
    """csrc/digest_compress.c against the JAX package's python loop on
    seeded centroids (rounded, so with ties and equal gaps; unit and
    integer weights): the same centroids, bit for bit."""
    from trino_tpu.ops import digest as tpu_dg
    from trino_tpu_torch.ops import digest as dg
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 5000))
    means = np.round(rng.gamma(2.0, 100.0, n), seed % 3)
    weights = (rng.integers(1, 5, n).astype(np.float64) if seed % 2
               else np.ones(n))
    budget = int(rng.integers(5, 150))
    want = tpu_dg._compress(means, weights, budget)
    got = dg._compress(means, weights, budget)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_chip_smoke_digest_timer_restores_the_builders():
    """chip_smoke.py's ``record_digest_builds`` times the digest builders
    the engine calls while its block runs, and puts them back after."""
    import chip_smoke as cs
    from trino_tpu_torch.ops import groupby
    before = (groupby.grouped_digest, groupby.grouped_digest_merge)
    port = LocalQueryRunner(device="cpu")
    sql = ("SELECT value_at_quantile(merge(d), 0.5e0) FROM (SELECT "
           "o_orderpriority, tdigest_agg(o_totalprice) d "
           "FROM tpch.tiny.orders GROUP BY 1)")
    with cs.record_digest_builds(groupby) as spent:
        got = port.execute(sql).rows
    assert spent["calls"] == 2 and spent["s"] > 0
    assert (groupby.grouped_digest, groupby.grouped_digest_merge) == before
    assert got == port.execute(sql).rows
