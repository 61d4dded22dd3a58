"""The aggregate kinds with scalar results of the PyTorch engine
(trino_tpu_torch) against the JAX engine (trino_tpu) on the CPU.

Each SQL statement runs through ``trino_tpu.runner.LocalQueryRunner()``
and ``trino_tpu_torch.runner.LocalQueryRunner(device="cpu")`` at
tpch.tiny or over VALUES: the rows must be equal, integers, strings and
dates exactly, doubles within rel 1e-9. The cases are those of
tests/test_aggregates.py that need no MAP, ARRAY, digest or distributed
runner, plus ties on the min_by/max_by comparator, FILTER masks on each
kind, the multi-argument DISTINCT error, a hand-built MarkDistinct plan
and the bitwise kinds through the split-by-split aggregation.
"""

import math

import numpy as np
import pytest

from trino_tpu.connectors.tpch import TpchConnector as TpuTpch
from trino_tpu.exec.executor import Executor as TpuExecutor
from trino_tpu.plan import nodes as tpu_nodes
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu.types import BIGINT as TPU_BIGINT, VARCHAR as TPU_VARCHAR
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec import executor as port_executor
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.plan import nodes as port_nodes
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session
from trino_tpu_torch.types import BIGINT, VARCHAR

REL = 1e-9


@pytest.fixture(scope="module")
def engines():
    return TpuRunner(), LocalQueryRunner(device="cpu")


def same_rows(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a)
            elif isinstance(b, float):
                assert isinstance(a, float) and a == pytest.approx(
                    b, rel=REL), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


def parity(engines, sql):
    jax_runner, port = engines
    want = jax_runner.execute(sql).rows
    got = port.execute(sql).rows
    same_rows(got, want)
    return got


LI = "tpch.tiny.lineitem"

# the parity cases of tests/test_aggregates.py, by the name of the test
# they come from
PARITY_SQL = {
    "count_distinct_global":
        f"SELECT count(DISTINCT l_quantity), approx_distinct(l_quantity) "
        f"FROM {LI}",
    "count_distinct_grouped":
        f"SELECT l_partkey % 11, count(DISTINCT l_quantity), count(*) "
        f"FROM {LI} GROUP BY l_partkey % 11 ORDER BY 1",
    "count_distinct_strings_and_nulls":
        "SELECT count(DISTINCT x) FROM (VALUES 'a', 'b', 'a', NULL, 'c', "
        "NULL) t(x)",
    "count_distinct_with_filter":
        "SELECT count(DISTINCT x) FILTER (WHERE x > 1) "
        "FROM (VALUES 1, 2, 2, 3, NULL) t(x)",
    "min_max_by_global":
        f"SELECT min_by(l_partkey, l_extendedprice), "
        f"max_by(l_partkey, l_extendedprice) FROM {LI}",
    "min_by_grouped_strings":
        "SELECT n_regionkey, min_by(n_name, n_nationkey), "
        "max_by(n_name, n_nationkey) FROM tpch.tiny.nation "
        "GROUP BY n_regionkey ORDER BY n_regionkey",
    "min_by_null_comparators_ignored":
        "SELECT min_by(a, b) FROM (VALUES (1, NULL), (2, 10), (3, 5)) "
        "t(a, b)",
    "min_by_all_null":
        "SELECT min_by(a, b) FROM (VALUES (CAST(NULL AS bigint), NULL)) "
        "t(a, b)",
    "percentile_grouped":
        "SELECT x % 2, approx_percentile(x, 0.5) FROM "
        "(VALUES 1, 2, 3, 4, 5, 6, 7) t(x) GROUP BY x % 2 ORDER BY 1",
    "corr_covar_regr":
        f"SELECT corr(l_extendedprice, l_quantity), "
        f"covar_pop(l_extendedprice, l_quantity), "
        f"covar_samp(l_extendedprice, l_quantity), "
        f"regr_slope(l_extendedprice, l_quantity), "
        f"regr_intercept(l_extendedprice, l_quantity) FROM {LI}",
    "corr_pairwise_nulls":
        "SELECT covar_pop(y, x), count(*) FROM (VALUES (1.0, 2.0), "
        "(2.0, 4.0), (NULL, 9.0), (3.0, NULL)) t(y, x)",
    "skewness_kurtosis":
        f"SELECT skewness(l_extendedprice) FROM {LI}",
    "skewness_small_n_null":
        "SELECT skewness(x), kurtosis(x) FROM (VALUES 1.0, 2.0) t(x)",
    "checksum_grouped_strings":
        "SELECT n_regionkey, checksum(n_name) FROM tpch.tiny.nation "
        "GROUP BY n_regionkey ORDER BY n_regionkey",
    "mixed_same_arg_distinct":
        "SELECT sum(DISTINCT x), count(DISTINCT x), avg(DISTINCT x) "
        "FROM (VALUES 1, 2, 2, 3) t(x)",
    "bitwise_aggs_global":
        "SELECT bitwise_and_agg(x), bitwise_or_agg(x) "
        "FROM (VALUES 12, 10, NULL, 14) t(x)",
    "bitwise_aggs_empty_and_null":
        "SELECT bitwise_and_agg(x), bitwise_or_agg(x) "
        "FROM (VALUES CAST(NULL AS BIGINT)) t(x)",
    "bitwise_aggs_grouped":
        "SELECT g, bitwise_and_agg(x), bitwise_or_agg(x) FROM (VALUES "
        "(1, 7), (1, 5), (2, 8), (2, 2), (2, NULL)) t(g, x) "
        "GROUP BY g ORDER BY g",
    "bitwise_aggs_grouped_general_path":
        f"SELECT l_partkey, bitwise_and_agg(CAST(l_quantity AS INTEGER)), "
        f"bitwise_or_agg(CAST(l_quantity AS INTEGER)) FROM {LI} "
        f"GROUP BY l_partkey ORDER BY l_partkey LIMIT 20",
    "empty_approx_set_merges_with_approx_set":
        "SELECT cardinality(merge(d)) FROM (SELECT approx_set(x) AS d "
        "FROM (VALUES 1, 2, 3) t(x) UNION ALL SELECT empty_approx_set()) u",
}


@pytest.mark.parametrize("name", sorted(PARITY_SQL))
def test_parity_with_the_jax_engine(engines, name):
    parity(engines, PARITY_SQL[name])


@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_percentile_global(engines, frac):
    got = parity(engines, f"SELECT approx_percentile(l_quantity, {frac}) "
                          f"FROM {LI}")
    qty = np.sort(np.asarray(
        engines[1].execute(f"SELECT l_quantity FROM {LI}").rows,
        dtype=float)[:, 0])
    k = int(np.clip(math.floor(frac * (len(qty) - 1) + 0.5), 0,
                    len(qty) - 1))
    assert float(got[0][0]) == qty[k]


def test_checksum_order_independent(engines):
    def ck(values):
        return parity(engines, f"SELECT checksum(x) FROM (VALUES {values}) "
                               "t(x)")
    assert ck("1, 2, 3") == ck("3, 1, 2")
    assert ck("1, 2, 3") != ck("3, 1, 4")
    # NULLs count (a multiset hash)
    assert ck("1, NULL, 2") != ck("1, 2")


def test_checksum_wraps_without_an_overflow_check(engines):
    # row hashes are full 64-bit patterns: their sum wraps, on the
    # packed, general and global paths alike
    parity(engines, f"SELECT l_returnflag, checksum(l_orderkey), "
                    f"checksum(l_extendedprice) FROM {LI} GROUP BY 1 "
                    f"ORDER BY 1")
    parity(engines, f"SELECT l_suppkey % 5, checksum(l_comment) FROM {LI} "
                    f"GROUP BY 1 ORDER BY 1")
    parity(engines, f"SELECT checksum(l_orderkey), checksum(l_shipdate) "
                    f"FROM {LI}")


TIES_SQL = {
    # several rows share each extreme: the first row in the group-sorted
    # (stable) order wins
    "values_global":
        "SELECT min_by(a, b), max_by(a, b) FROM (VALUES (1, 5), (2, 9), "
        "(3, 5), (4, 9), (5, 7)) t(a, b)",
    "values_grouped":
        "SELECT g, min_by(a, b), max_by(a, b) FROM (VALUES (1, 10, 5), "
        "(2, 11, 5), (1, 12, 3), (2, 13, 8), (1, 14, 3), (2, 15, 8)) "
        "t(g, a, b) GROUP BY g ORDER BY g",
    "lineitem_packed_keys":
        f"SELECT l_returnflag, min_by(l_orderkey * 10 + l_linenumber, "
        f"l_quantity), max_by(l_orderkey * 10 + l_linenumber, l_quantity) "
        f"FROM {LI} GROUP BY 1 ORDER BY 1",
    "lineitem_general_keys":
        f"SELECT l_suppkey % 7, min_by(l_orderkey * 10 + l_linenumber, "
        f"l_discount), max_by(l_comment, l_tax) FROM {LI} "
        f"GROUP BY 1 ORDER BY 1",
    "lineitem_global":
        f"SELECT min_by(l_orderkey * 10 + l_linenumber, l_quantity), "
        f"max_by(l_orderkey * 10 + l_linenumber, l_quantity), "
        f"max_by(l_partkey, l_shipdate) FROM {LI}",
    "nan_comparators_ignored":
        "SELECT min_by(a, b), max_by(a, b) FROM (VALUES "
        "(1, CAST('NaN' AS double)), (2, 3.0E0), (3, 3.0E0), "
        "(4, CAST('NaN' AS double))) t(a, b)",
}


@pytest.mark.parametrize("name", sorted(TIES_SQL))
def test_min_max_by_ties_take_the_first_row(engines, name):
    parity(engines, TIES_SQL[name])


FILTER_AGGS = (
    "min_by(l_orderkey, l_extendedprice) FILTER (WHERE l_quantity > 20), "
    "max_by(l_partkey, l_extendedprice) FILTER (WHERE l_discount < 0.05), "
    "approx_percentile(l_extendedprice, 0.3) FILTER (WHERE l_tax > 0.02), "
    "corr(l_extendedprice, l_quantity) FILTER (WHERE l_linenumber > 2), "
    "covar_samp(l_extendedprice, l_quantity) FILTER (WHERE l_tax < 0.05), "
    "regr_slope(l_extendedprice, l_quantity) FILTER (WHERE l_partkey > 50), "
    "skewness(l_extendedprice) FILTER (WHERE l_quantity < 30), "
    "checksum(l_orderkey) FILTER (WHERE l_linenumber = 1), "
    "bitwise_and_agg(l_orderkey) FILTER (WHERE l_quantity < 3), "
    "bitwise_or_agg(l_suppkey) FILTER (WHERE l_quantity > 45), "
    "cardinality(approx_set(l_partkey) FILTER (WHERE l_quantity > 10))")


@pytest.mark.parametrize("keys", ["", "l_returnflag", "l_suppkey % 7"])
def test_each_kind_under_a_filter_mask(engines, keys):
    if keys:
        sql = (f"SELECT {keys}, {FILTER_AGGS} FROM {LI} GROUP BY 1 "
               f"ORDER BY 1")
    else:
        sql = f"SELECT {FILTER_AGGS} FROM {LI}"
    parity(engines, sql)


STATS_SQL = (
    "SELECT {keys} count(*), corr(l_extendedprice, l_quantity), "
    "covar_samp(l_extendedprice, l_quantity), "
    "covar_pop(l_extendedprice, l_quantity), "
    "regr_slope(l_extendedprice, l_quantity), "
    "regr_intercept(l_extendedprice, l_quantity), "
    "skewness(l_extendedprice), checksum(l_orderkey), "
    "bitwise_and_agg(l_orderkey), bitwise_or_agg(l_suppkey) "
    "FROM tpch.tiny.lineitem {group}")


def test_short_decimals_enter_the_statistical_lanes_unscaled(engines):
    # TPC-H's money columns are DOUBLE here: casts make them DECIMAL
    price = "CAST(l_extendedprice AS DECIMAL(15,2))"
    qty = "CAST(l_quantity AS DECIMAL(12,2))"
    parity(engines, f"SELECT l_returnflag, corr({price}, {qty}), "
                    f"regr_slope({price}, {qty}), covar_pop({qty}, "
                    f"l_tax), skewness({price}) "
                    f"FROM {LI} GROUP BY 1 ORDER BY 1")


@pytest.mark.parametrize("grouped", [False, True])
def test_statistical_family_as_the_card_runs_it(engines, grouped):
    keys = "l_returnflag, l_linestatus," if grouped else ""
    group = "GROUP BY 1, 2 ORDER BY 1, 2" if grouped else ""
    parity(engines, STATS_SQL.format(keys=keys, group=group))


# kurtosis: the JAX engine's finisher has n where Trino's unbiased excess
# kurtosis has (n-1)^2 (ROADMAP C), so the port is held to the formula
# (AggregationUtils.getKurtosis) over numpy's central sums instead
KURTOSIS_SQL = {
    "global": (f"SELECT kurtosis(l_extendedprice), kurtosis(l_quantity) "
               f"FROM {LI}", f"SELECT 0, l_extendedprice, l_quantity "
                             f"FROM {LI}"),
    "grouped": (f"SELECT l_returnflag, kurtosis(l_extendedprice), "
                f"kurtosis(l_tax) FROM {LI} GROUP BY 1 ORDER BY 1",
                f"SELECT l_returnflag, l_extendedprice, l_tax FROM {LI}"),
    "filter": (f"SELECT l_linestatus, kurtosis(l_quantity) FILTER (WHERE "
               f"l_discount > 0.02), kurtosis(CAST(l_extendedprice AS "
               f"DECIMAL(15,2))) FROM {LI} GROUP BY 1 ORDER BY 1",
               f"SELECT l_linestatus, CASE WHEN l_discount > 0.02 THEN "
               f"l_quantity END, l_extendedprice FROM {LI}"),
    "small_n": ("SELECT g, kurtosis(x), kurtosis(y) FROM (VALUES "
                "(1, 1.0, 2.0), (1, 2.0, NULL), (1, 4.0, 5.0), (1, 8.0, 1.0), "
                "(2, 1.0, 1.0), (2, 3.0, 3.0), (2, 3.0, 3.0)) t(g, x, y) "
                "GROUP BY g ORDER BY g",
                "SELECT g, x, y FROM (VALUES (1, 1.0, 2.0), (1, 2.0, NULL), "
                "(1, 4.0, 5.0), (1, 8.0, 1.0), (2, 1.0, 1.0), (2, 3.0, 3.0), "
                "(2, 3.0, 3.0)) t(g, x, y)"),
}


def _kurtosis(values):
    """Trino's unbiased excess kurtosis; None below 4 values or with no
    spread."""
    x = np.asarray([float(v) for v in values if v is not None])
    n = len(x)
    d = x - x.mean() if n else x
    m2, m4 = (d * d).sum(), (d ** 4).sum()
    if n < 4 or m2 <= 0:
        return None
    return (n * (n + 1.0) * (n - 1.0) * m4 / ((n - 2.0) * (n - 3.0) * m2 * m2)
            - 3.0 * (n - 1.0) ** 2 / ((n - 2.0) * (n - 3.0)))


@pytest.mark.parametrize("name", sorted(KURTOSIS_SQL))
def test_kurtosis_is_trinos_unbiased_estimate(engines, name):
    sql, raw = KURTOSIS_SQL[name]
    port = engines[1]
    got = port.execute(sql).rows
    groups = {}
    for key, a, b in port.execute(raw).rows:
        groups.setdefault(key, ([], []))
        groups[key][0].append(a)
        groups[key][1].append(b)
    want = [[k, _kurtosis(a), _kurtosis(b)]
            for k, (a, b) in sorted(groups.items())]
    if name == "global":
        got = [[0] + got[0]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if b is None:
                assert a is None
            else:
                assert a == pytest.approx(b, rel=1e-9)


def test_the_jax_kurtosis_is_the_fault_not_copied(engines):
    """The JAX engine gives about -3 for any large sample (its n where
    (n-1)^2 belongs); the port gives the unbiased estimate: about -1.2
    for the uniform l_quantity."""
    sql = f"SELECT kurtosis(l_quantity) FROM {LI}"
    [[jax_k]] = engines[0].execute(sql).rows
    [[port_k]] = engines[1].execute(sql).rows
    assert abs(jax_k + 3.0) < 0.01
    assert abs(port_k + 1.2) < 0.01


def test_multi_argument_distinct_raises_in_both(engines):
    sql = ("SELECT sum(DISTINCT x), count(DISTINCT y) "
           "FROM (VALUES (1, 2), (2, 3)) t(x, y)")
    jax_runner, port = engines
    with pytest.raises(Exception, match="DISTINCT"):
        jax_runner.execute(sql)
    with pytest.raises(Exception, match="DISTINCT"):
        port.execute(sql)


def test_digest_merge_is_not_yet_ported(engines):
    with pytest.raises(Exception, match="not yet ported"):
        engines[1].execute("SELECT merge(d) FROM (SELECT tdigest_agg(x) d "
                           "FROM (VALUES 1.0E0, 2.0E0) t(x))")


def _mark_distinct_plan(nodes, bigint, varchar):
    rows = ((3, "a"), (1, "b"), (3, "a"), (None, "c"), (1, "b"),
            (None, "c"), (2, "a"), (3, "b"))
    values = nodes.ValuesNode({"k": bigint, "s": varchar}, rows)
    marked = nodes.MarkDistinctNode(values, "m", ("k", "s"))
    return nodes.OutputNode(marked, ("k", "s", "m"), ("k", "s", "m"))


def test_mark_distinct_plan_by_hand(engines):
    """No planner builds a MarkDistinctNode: the plan is built by hand
    and run by both executors."""
    jax_runner, port = engines
    want = TpuExecutor(jax_runner.catalogs, jax_runner.session).execute(
        _mark_distinct_plan(tpu_nodes, TPU_BIGINT, TPU_VARCHAR)).to_pylist()
    got = Executor(port.catalogs, port.session, port.device).execute(
        _mark_distinct_plan(port_nodes, BIGINT, VARCHAR)).to_pylist()
    same_rows(got, want)
    assert [r[2] for r in got] == [True, True, False, True, False, False,
                                   True, True]


def test_bitwise_kinds_combine_split_by_split(monkeypatch):
    """bitwise_and_agg/bitwise_or_agg now combine: with many splits the
    port aggregates split by split and folds the partials."""
    s = Session(catalog="tpch", schema="tiny")
    port = LocalQueryRunner(s, device="cpu")
    port.catalogs.register("tpch", TpchConnector(4096, device="cpu"))
    jax_runner = TpuRunner(session=TpuSession(catalog="tpch",
                                              schema="tiny"))
    jax_runner.catalogs.register("tpch", TpuTpch(4096))
    combines = []
    inner = port_executor._combine

    def counted(*args):
        combines.append(1)
        return inner(*args)
    monkeypatch.setattr(port_executor, "_combine", counted)
    for sql in (
            f"SELECT l_returnflag, bitwise_or_agg(l_orderkey), "
            f"bitwise_and_agg(l_suppkey + 1024), count(*) FROM {LI} "
            f"GROUP BY 1 ORDER BY 1",
            f"SELECT l_suppkey % 5, bitwise_or_agg(l_partkey), "
            f"bitwise_and_agg(l_orderkey * 2 + 1) FROM {LI} "
            f"WHERE l_quantity > 5 GROUP BY 1 ORDER BY 1",
            f"SELECT bitwise_or_agg(l_orderkey), checksum(l_partkey), "
            f"bitwise_and_agg(l_suppkey + 4096) FROM {LI}"):
        before = len(combines)
        same_rows(port.execute(sql).rows, jax_runner.execute(sql).rows)
        assert len(combines) > before, sql


def test_order_kinds_do_not_stream(monkeypatch):
    """min_by, approx_percentile and approx_set need all rows at once:
    with many splits they still run whole and equal the JAX engine."""
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                            device="cpu")
    port.catalogs.register("tpch", TpchConnector(4096, device="cpu"))
    combines = []
    inner = port_executor._combine
    monkeypatch.setattr(port_executor, "_combine",
                        lambda *a: combines.append(1) or inner(*a))
    jax_runner = TpuRunner()
    sql = (f"SELECT l_returnflag, min_by(l_orderkey, l_extendedprice), "
           f"approx_percentile(l_quantity, 0.9), "
           f"cardinality(approx_set(l_partkey)) FROM {LI} GROUP BY 1 "
           f"ORDER BY 1")
    same_rows(port.execute(sql).rows, jax_runner.execute(sql).rows)
    assert not combines


# ---- ops/groupby.py directly: the packed, general and global paths ----------

N_OPS = 600


def _ops_batches(dead, seed=23):
    """The same seeded python values as a batch of each package: doubles
    with ties and NaN, a comparator with ties and NULLs, ints, strings,
    bools, a FILTER mask and keys of a small (packed) and a large
    (general) domain."""
    from trino_tpu import batch_from_pylist as tpu_batch
    from trino_tpu.columnar import Batch as TpuBatch
    from trino_tpu.types import parse_type as tpu_type
    from trino_tpu_torch.columnar import Batch, batch_from_pylist
    from trino_tpu_torch.types import parse_type as port_type
    rng = np.random.default_rng(seed)
    n = N_OPS
    pool = [1.5, -2.0, 0.0, 7.25, float("nan"), 1e300, -1e300]
    data = {
        "v": [pool[int(k)] for k in rng.integers(0, len(pool), n)],
        "c": [float(x) for x in rng.integers(0, 9, n)],
        "i": [int(x) for x in rng.integers(-(1 << 40), 1 << 40, n)],
        "s": [f"w{int(k):02d}" for k in rng.integers(0, 30, n)],
        "m": [bool(x) for x in rng.integers(0, 3, n) > 0],
        "kp": [f"p{int(k)}" for k in rng.integers(0, 4, n)],
        "kg": [int(x) for x in rng.integers(-25, 25, n)],
    }
    for col in ("c", "i", "s", "kg"):
        for k in rng.choice(n, n // 8, replace=False):
            data[col][int(k)] = None
    data["c"][5] = float("nan")
    types = {"v": "double", "c": "double", "i": "bigint", "s": "varchar",
             "m": "boolean", "kp": "varchar", "kg": "bigint"}
    tb = tpu_batch(data, {k: tpu_type(t) for k, t in types.items()})
    pb = batch_from_pylist(data, {k: port_type(t) for k, t in types.items()},
                           device="cpu")
    return TpuBatch(tb.columns, n - dead), Batch(pb.columns, n - dead)


# (kind, input, mask, param, input2)
ORDER_AGGS = [
    ("argmin", "i", None, None, "c"), ("argmax", "s", "m", None, "c"),
    ("argmin", "v", None, None, "i"), ("argmax", "i", None, None, "s"),
    ("argmax", "c", "m", None, "v"), ("percentile", "v", None, 0.3, None),
    ("percentile", "i", "m", 0.5, None), ("percentile", "s", None, 0.9, None),
    ("bit_and", "i", None, None, None), ("bit_or", "i", "m", None, None),
    ("hll", "i", None, 12.0, None), ("hll", "v", "m", 4.0, None),
    ("hll", "s", None, 16.0, None), ("count_star", None, None, None, None)]
BIT_AGGS = [
    ("bit_and", "i", None, None, None), ("bit_or", "i", "m", None, None),
    ("sum", "v", None, None, None), ("count", "i", "m", None, None)]


def _aggs(mod, spec):
    return [mod.AggInput(k, c, m, f"a{j}", p, c2)
            for j, (k, c, m, p, c2) in enumerate(spec)]


@pytest.mark.parametrize("dead", [0, 41])
@pytest.mark.parametrize("keys,spec", [
    (["kg"], "order"), (["kp", "kg"], "order"), (["kp"], "order"),
    (["kp"], "bits"), (["kg"], "bits"), ([], "order"), ([], "bits")],
    ids=["general", "general_two_keys", "small_domain_key", "packed_bits",
         "general_bits", "global", "global_bits"])
def test_group_aggregate_kinds_equal_the_jax_ops(keys, spec, dead):
    from trino_tpu.ops import groupby as tpu_groupby
    from trino_tpu_torch.ops import groupby as port_groupby
    tb, pb = _ops_batches(dead)
    aggs = ORDER_AGGS if spec == "order" else BIT_AGGS
    if keys:
        want = tpu_groupby.group_aggregate(tb, keys, _aggs(tpu_groupby, aggs))
        got = port_groupby.group_aggregate(pb, keys,
                                           _aggs(port_groupby, aggs))
    else:
        want = tpu_groupby.global_aggregate(tb, _aggs(tpu_groupby, aggs))
        got = port_groupby.global_aggregate(pb, _aggs(port_groupby, aggs))
    assert got.names == want.names
    same_rows(got.to_pylist(), want.to_pylist())
