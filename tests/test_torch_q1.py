"""SQL through the PyTorch engine (device="cpu") against the JAX engine
(grouped_sums in Pallas interpret mode) at tpch.tiny.

Keys, counts, integers, strings and dates must match exactly; doubles
within rel 1e-9 (both engines sum in f64, in different orders).
"""

import math

import numpy as np
import pytest
import torch

from trino_tpu.benchmarks.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch import columnar as port_columnar
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.ops import cuda_groupby
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.types import parse_type

REL = 1e-9

QUERIES = {
    "q1": TPCH_QUERIES[1],
    # the two q1-shaped queries of tests/test_pallas.py
    "q1_shape_date_literal":
        "SELECT l_returnflag, l_linestatus, sum(l_quantity), "
        "sum(l_extendedprice), "
        "sum(l_extendedprice * (1 - l_discount)), "
        "avg(l_quantity), count(*) "
        "FROM lineitem WHERE l_shipdate <= DATE '1998-09-02' "
        "GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag, l_linestatus",
    "filtered_counts":
        "SELECT l_linestatus, "
        "count(*) FILTER (WHERE l_quantity > 25), "
        "sum(l_extendedprice) FILTER (WHERE l_discount > 0.05), "
        "min(l_shipdate), max(l_quantity) "
        "FROM lineitem GROUP BY l_linestatus ORDER BY 1",
    "global_masked":
        "SELECT count(*), sum(l_quantity), avg(l_discount), "
        "min(l_tax), max(l_extendedprice) FROM lineitem "
        "WHERE l_quantity < 24 AND NOT (l_discount > 0.07)",
    "strings_topn":
        "SELECT n_name, n_regionkey FROM nation "
        "WHERE n_regionkey <> 1 AND n_name >= 'EGYPT' "
        "ORDER BY n_regionkey DESC, n_name LIMIT 7",
    "group_min_max_strings":
        "SELECT l_returnflag, min(l_shipmode), max(l_shipinstruct), "
        "count(l_tax), sum(l_linenumber) FROM lineitem "
        "WHERE l_shipdate > DATE '1995-01-01' - INTERVAL '30' DAY "
        "GROUP BY l_returnflag ORDER BY l_returnflag DESC",
    "filter_project_limit":
        "SELECT l_orderkey, l_linenumber, l_quantity * 2 + 1 "
        "FROM lineitem WHERE l_orderkey < 40 AND l_linenumber > 1 "
        "ORDER BY l_orderkey, l_linenumber DESC LIMIT 9",
    "limit_pushdown":
        "SELECT l_orderkey, l_quantity FROM lineitem "
        "WHERE l_quantity > 49 LIMIT 5",
    "values_sort":
        "SELECT x, y, x * 2 FROM (VALUES (1, 'a'), (2, 'b'), (3, NULL)) "
        "t(x, y) ORDER BY y NULLS FIRST",
    "global_unfiltered": "SELECT count(*), max(l_shipdate) FROM lineitem",
}


def _assert_rows_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and not math.isnan(b):
                assert a == pytest.approx(b, rel=REL)
            else:
                assert a == b


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_port_matches_jax_engine(name, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    want = TpuRunner().execute(QUERIES[name])
    got = LocalQueryRunner(device="cpu").execute(QUERIES[name])
    assert got.columns == want.columns
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    _assert_rows_match(got.rows, want.rows)


def test_q1_goes_through_grouped_sums(monkeypatch):
    calls = []
    real = cuda_groupby.grouped_sums

    def spy(gid, lanes, nseg):
        calls.append((len(lanes), nseg))
        return real(gid, lanes, nseg)
    monkeypatch.setattr(cuda_groupby, "grouped_sums", spy)
    LocalQueryRunner(device="cpu").execute(TPCH_QUERIES[1])
    # 1 live + count(*) + 7 sums x (value, mask) + 3 avg counts
    assert calls == [(19, 12)]


ROUND_TRIP_SQL = [
    "SELECT l_orderkey, l_quantity, l_shipdate, l_returnflag "
    "FROM lineitem WHERE l_orderkey < 200",
    "SELECT o_orderkey, o_orderpriority, o_totalprice, o_orderdate "
    "FROM orders WHERE o_orderkey < 300",
]


def test_batch_from_numpy_round_trip(monkeypatch):
    """A table made by the JAX engine enters the port through numpy and
    reads back the same rows (dictionary columns included)."""
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    for sql in ROUND_TRIP_SQL:
        _round_trip(sql)


def _round_trip(sql):
    tpu = TpuRunner()
    batch = tpu.execute_batch(sql)
    want = tpu.execute(sql).rows
    n = batch.num_rows_host()
    lanes, types, dicts = {}, {}, {}
    for name, col in batch.columns.items():
        lanes[name] = (np.asarray(col.data)[:n],
                       None if col.valid is None
                       else np.asarray(col.valid)[:n],
                       None if col.data2 is None
                       else np.asarray(col.data2)[:n])
        types[name] = parse_type(str(col.type))
        if col.dictionary is not None:
            dicts[name] = col.dictionary.values
    got = port_columnar.batch_from_numpy(lanes, types, dicts, n,
                                         device="cpu")
    assert got.capacity >= 8 and got.device == torch.device("cpu")
    assert got.to_pylist() == want


def test_batch_from_pylist_with_nulls_and_decimals():
    b = port_columnar.batch_from_pylist(
        {"s": ["x", None, "y"], "d": [1.5, None, -2.25],
         "m": [None, 12345678901234567890, -3]},
        {"s": parse_type("varchar"), "d": parse_type("double"),
         "m": parse_type("decimal(30,0)")}, device="cpu")
    assert b.capacity == 8
    assert b.to_pylist() == [["x", 1.5, None], [None, None,
                             12345678901234567890], ["y", -2.25, -3]]


@pytest.mark.parametrize("sql", [
    "SELECT x FROM UNNEST(ARRAY[1, 2]) AS t(x)",
    "SELECT CAST(o_orderdate AS TIMESTAMP) FROM orders",
    "SELECT n_name FROM nation ORDER BY n_name OFFSET 3",
    "SELECT try(greatest(n_name, 'B')) FROM nation",
    "SELECT greatest(n_name, 'B') FROM nation",
])
def test_outside_the_slice_raises_not_yet_ported(sql):
    with pytest.raises(QueryError, match="not yet ported"):
        LocalQueryRunner(device="cpu").execute(sql)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalQueryRunner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_columnar.batch_from_pylist({"a": [1]},
                                        {"a": parse_type("bigint")})
    assert LocalQueryRunner(device="cpu").device.type == "cpu"
