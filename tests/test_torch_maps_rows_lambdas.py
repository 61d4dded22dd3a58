"""MAP and ROW columns and the lambdas (higher-order functions) in the
PyTorch engine, against the JAX engine on the CPU at tpch.tiny.

Every SQL string of tests/test_maps_rows_lambdas.py is a case here, then
the map functions of the reference's ``exec/complex.py`` beyond it
(map_zip_with, map_from_entries, multimap_from_entries, split_to_map,
split_to_multimap, cosine_similarity), lambdas that capture outer
columns, reduce over strings and doubles, and the casts between ROW, MAP
and ARRAY types. Rows compare as in tests/_torch_nested.py.
"""

import pytest

from _torch_nested import check, engines  # noqa: F401
from trino_tpu_torch.exec import complex as port_complex

# every SQL string of tests/test_maps_rows_lambdas.py
REFERENCE_SQL = [
    "SELECT map(ARRAY[1, 2], ARRAY['a', 'b'])[2]",
    "SELECT element_at(map(ARRAY['x','y'], ARRAY[10,20]), 'y')",
    "SELECT element_at(map(ARRAY[1], ARRAY[5]), 9)",
    "SELECT map(ARRAY[1, 2], ARRAY[10, 20])",
    "SELECT map_keys(m), map_values(m), cardinality(m) "
    "FROM (SELECT map(ARRAY[3, 1], ARRAY['c', 'a']) AS m) t",
    "SELECT map_concat(map(ARRAY[1, 2], ARRAY[10, 20]),"
    " map(ARRAY[2, 3], ARRAY[99, 30]))",
    "SELECT map_entries(map(ARRAY[1], ARRAY['a']))",
    "SELECT map(ARRAY[n_nationkey], ARRAY[n_regionkey])[n_nationkey] "
    "FROM tpch.tiny.nation WHERE n_nationkey < 3 ORDER BY n_nationkey",
    "SELECT ROW(1, 'x')[1], ROW(1, 'x')[2]",
    "SELECT ROW(1, 2.5)",
    "SELECT CAST(ROW(1, 'a') AS ROW(x BIGINT, y VARCHAR)).x",
    "SELECT transform(ARRAY[1, 2, 3], x -> x * 10)",
    "SELECT transform(ARRAY[1, 2], x -> x + n_nationkey) "
    "FROM tpch.tiny.nation WHERE n_nationkey < 2 ORDER BY n_nationkey",
    "SELECT filter(ARRAY[5, -1, 3, -7], x -> x > 0)",
    "SELECT any_match(ARRAY[1, 2], x -> x > 1), "
    "all_match(ARRAY[1, 2], x -> x > 0), none_match(ARRAY[1, 2], x -> x > 5)",
    "SELECT reduce(ARRAY[1, 2, 3, 4], 0, (s, x) -> s + x, s -> s)",
    "SELECT reduce(ARRAY[2, 3], 1, (s, x) -> s * x, s -> s * 100)",
    "SELECT zip_with(ARRAY[1, 2], ARRAY[10, 20], (x, y) -> x + y)",
    "SELECT map_filter(map(ARRAY[1, 2, 3], ARRAY[10, 20, 30]), "
    "(k, v) -> k % 2 = 1)",
    "SELECT transform_values(map(ARRAY[1], ARRAY[5]), (k, v) -> v * k)",
    "SELECT transform_keys(map(ARRAY[1], ARRAY[5]), (k, v) -> k + 100)",
    "SELECT contains(ARRAY[1, 2, 3], 2), contains(ARRAY[1, 3], 2), "
    "array_position(ARRAY[7, 8, 9], 9)",
    "SELECT array_min(ARRAY[3, 1, 2]), array_max(ARRAY[3, 1, 2]), "
    "array_distinct(ARRAY[1, 2, 1, 3, 2]), array_sort(ARRAY[3, 1, 2])",
    "SELECT slice(ARRAY[1, 2, 3, 4], 2, 2), sequence(1, 4), repeat(7, 3), "
    "flatten(ARRAY[ARRAY[1, 2], ARRAY[3]])",
    "SELECT array_union(ARRAY[1, 2], ARRAY[2, 3]), "
    "array_intersect(ARRAY[1, 2, 3], ARRAY[2, 3, 4]), "
    "array_except(ARRAY[1, 2, 3], ARRAY[2]), "
    "arrays_overlap(ARRAY[1, 2], ARRAY[2, 9])",
    "SELECT map_agg(n_nationkey, n_name) FROM tpch.tiny.nation "
    "WHERE n_nationkey < 3",
    "SELECT n_regionkey, map_agg(n_nationkey, n_name) FROM tpch.tiny.nation "
    "WHERE n_nationkey < 5 GROUP BY n_regionkey ORDER BY n_regionkey",
    "SELECT histogram(n_regionkey) FROM tpch.tiny.nation",
    "SELECT n_regionkey, histogram(n_regionkey % 2) FROM tpch.tiny.nation "
    "GROUP BY n_regionkey ORDER BY n_regionkey",
    "SELECT approx_most_frequent(2, n_regionkey) FROM tpch.tiny.nation",
    "SELECT n_regionkey, approx_most_frequent(1, n_nationkey % 2) "
    "FROM tpch.tiny.nation GROUP BY n_regionkey ORDER BY n_regionkey",
    "SELECT n_name FROM tpch.tiny.nation "
    "WHERE any_match(ARRAY[n_nationkey], x -> x = 3)",
]

MORE_SQL = [
    "SELECT map_zip_with(map(ARRAY[1, 2], ARRAY[10, 20]), "
    "map(ARRAY[2, 3], ARRAY[200, 300]), "
    "(k, a, b) -> coalesce(a, 0) + coalesce(b, 0))",
    "SELECT map_from_entries(ARRAY[ROW(1, 'a'), ROW(2, 'b')])",
    "SELECT multimap_from_entries(ARRAY[ROW(1, 'a'), ROW(2, 'b'), "
    "ROW(1, 'c')])",
    "SELECT split_to_map('a=1,b=2', ',', '='), split_to_map(n_name, 'X', 'A') "
    "FROM tpch.tiny.nation WHERE n_nationkey < 3 ORDER BY n_nationkey",
    "SELECT split_to_multimap('a=1,b=2,a=3', ',', '=')",
    "SELECT cosine_similarity(map(ARRAY['a', 'b'], ARRAY[1.0e0, 2.0e0]), "
    "map(ARRAY['b', 'c'], ARRAY[3.0e0, 4.0e0]))",
    "SELECT map_keys(map_concat(map(ARRAY['b'], ARRAY[1]), "
    "map(ARRAY['a', 'b'], ARRAY[2, 3])))",
    "SELECT map(ARRAY['a'], ARRAY[ARRAY[1, 2]])['a'], "
    "element_at(map(ARRAY[1], ARRAY[ROW(1, 'x')]), 1)",
    "SELECT n_nationkey, filter(ARRAY[n_regionkey, n_nationkey], "
    "x -> x > n_regionkey) FROM tpch.tiny.nation WHERE n_nationkey < 5 "
    "ORDER BY 1",
    "SELECT n_regionkey, transform(array_agg(n_nationkey), "
    "x -> x * n_regionkey) FROM tpch.tiny.nation GROUP BY n_regionkey "
    "ORDER BY 1",
    "SELECT reduce(ARRAY['a', 'b', 'c'], '', (s, x) -> s || x, s -> s), "
    "reduce(ARRAY[1.5, 2.5], 0e0, (s, x) -> s + x, s -> s * 2)",
    "SELECT any_match(ARRAY[NULL, 1], x -> x > 0), "
    "all_match(ARRAY[NULL, 1], x -> x > 0), "
    "none_match(filter(ARRAY[1], x -> x > 5), x -> x > 0)",
    "SELECT zip_with(ARRAY['a', 'b'], ARRAY['c'], "
    "(x, y) -> concat(x, coalesce(y, '-')))",
    "SELECT CAST(ARRAY[1, 2] AS array(double)), "
    "CAST(map(ARRAY[1], ARRAY[2]) AS map(bigint, double))",
    "SELECT typeof(ARRAY[1]), typeof(map(ARRAY['a'], ARRAY[1.5e0])), "
    "typeof(ROW(1, 'a'))",
    # complex_sf10's (b) and (c), at tiny
    "SELECT o_orderpriority, count(*), sum(cardinality(items)), "
    "sum(reduce(items, 0e0, (s, x) -> s + x, s -> s)), "
    "sum(cardinality(filter(items, x -> x > 50000e0))), "
    "count_if(any_match(items, x -> x > 100000e0)), "
    "sum(element_at(array_sort(items), -1)), "
    "sum(array_max(transform(items, x -> x * 2e0))) FROM tpch.tiny.orders "
    "JOIN (SELECT l_orderkey AS k, array_agg(l_extendedprice) AS items "
    "FROM tpch.tiny.lineitem GROUP BY l_orderkey) li ON o_orderkey = k "
    "GROUP BY o_orderpriority ORDER BY 1",
    "SELECT l_returnflag, histogram(l_shipmode), "
    "element_at(histogram(l_shipinstruct), 'NONE') FROM tpch.tiny.lineitem "
    "GROUP BY 1 ORDER BY 1",
    "SELECT sum(cardinality(map_filter(MAP(ARRAY['q', 'p', 'd'], "
    "ARRAY[l_quantity, l_extendedprice, l_discount]), (k, v) -> v > 10e0))) "
    "FROM tpch.tiny.lineitem",
    "SELECT r.f, count(*), sum(r.p) FROM (SELECT CAST(ROW(l_returnflag, "
    "l_extendedprice) AS ROW(f VARCHAR(1), p DOUBLE)) AS r "
    "FROM tpch.tiny.lineitem) GROUP BY 1 ORDER BY 1",
]


@pytest.mark.parametrize("i", range(len(REFERENCE_SQL)))
def test_reference_sql(engines, i):
    check(engines, REFERENCE_SQL[i])


@pytest.mark.parametrize("i", range(len(MORE_SQL)))
def test_more_sql(engines, i):
    check(engines, MORE_SQL[i])


@pytest.mark.parametrize("sql,match", [
    ("SELECT map(ARRAY[1, 2], ARRAY[3])", "equal lengths"),
    ("SELECT map_from_entries(ARRAY[ROW(1, 'a'), ROW(1, 'b')])",
     "Duplicate map keys"),
    ("SELECT sequence(1, 5, 0)", "step"),
    ("SELECT split_to_map('a=1,a=2', ',', '=')", "duplicate key"),
])
def test_errors_as_the_reference_raises_them(engines, sql, match):
    jax_runner, port = engines
    with pytest.raises(Exception, match=match):
        jax_runner.execute(sql)
    with pytest.raises(Exception, match=match):
        port.execute(sql)


def test_every_reference_dispatch_name_has_a_case():
    """Each name of the reference's ``exec/complex.py`` DISPATCH appears
    in some parity case of the three files (and the port has it)."""
    import test_torch_arrays as arrays
    from trino_tpu.exec import complex as tpu_complex
    sql = " ".join(REFERENCE_SQL + MORE_SQL + arrays.REFERENCE_SQL
                   + arrays.MORE_SQL).lower()
    alias = {"$map": "map(", "$row": "row(", "$field": "r.f",
             "map": "map("}
    for name in tpu_complex.DISPATCH:
        assert name in port_complex.DISPATCH
        assert alias.get(name, name + "(") in sql, name


@pytest.mark.parametrize("name", ["unnest_li", "order_items", "histogram",
                                  "map_filter", "row_field"])
def test_complex_sf10_queries_at_tiny(name):
    """chip_smoke.py's complex_sf10 queries (a)-(c) through the port at
    tpch.tiny, against the phase's own numpy references over the same
    generators (those the card run holds its sf10 rows to)."""
    import chip_smoke as cs
    import torch
    from trino_tpu_torch.connectors import tpch, tpch_device
    from trino_tpu_torch.runner import LocalQueryRunner
    want, _ = cs.complex_references(tpch, tpch_device, "tiny",
                                    torch.device("cpu"))
    got = LocalQueryRunner(device="cpu").execute(
        cs.COMPLEX_SQL[name].format(schema="tiny")).rows
    assert len(got) > 0
    assert cs.nested_match(cs.by_key(got), cs.by_key(want[name])), \
        (got, want[name])


@pytest.mark.parametrize("seed", range(5))
def test_chip_smoke_exact_sum_equals_math_fsum(seed):
    """chip_smoke.py's ``fsum`` (exact splitting in numpy, used by its
    references) gives math.fsum's correctly rounded sum, bit for bit:
    prices and their powers, mixed signs and magnitudes, cancellation,
    subnormals."""
    import math
    import numpy as np
    import chip_smoke as cs
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 20000))
    lanes = [np.round(rng.uniform(900, 105000, n), 2) ** (seed % 4 + 1),
             rng.normal(0, 1, n) * 10.0 ** rng.integers(-30, 30, n),
             np.concatenate([[1e100, 1.0, -1e100],
                             rng.normal(0, 1e-310, n)]),
             rng.integers(-9, 9, n) * 2.0 ** rng.integers(-1070, 900, n)]
    for lane in lanes:
        assert cs.fsum(lane) == math.fsum(lane.tolist())
