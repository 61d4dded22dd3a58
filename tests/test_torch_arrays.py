"""ARRAY columns, UNNEST and array_agg in the PyTorch engine, against the
JAX engine on the CPU at tpch.tiny.

Every SQL string of tests/test_arrays.py is a case here, then the array
functions of the reference's ``exec/complex.py`` beyond it (the string
splitters, the set operations, zip, ngrams, combinations, array_first and
array_last, array_remove, array_join), NULL and empty arrays, nested
arrays, an ARRAY column through UNION ALL (two batches' dictionaries in
one pool), a join and a host spill. Rows compare as in
tests/_torch_nested.py.
"""

import pytest

from _torch_nested import check, engines, same  # noqa: F401
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.config import CONFIG
from trino_tpu_torch.runner import LocalQueryRunner

# every SQL string of tests/test_arrays.py
REFERENCE_SQL = [
    "SELECT ARRAY[1, 2, 3]",
    "SELECT ARRAY['a', 'b']",
    "SELECT ARRAY[1, NULL, 3]",
    "SELECT ARRAY[1.5, 2]",
    "SELECT ARRAY[10, 20, 30][2], element_at(ARRAY[10, 20], -1), "
    "element_at(ARRAY[10, 20], 7), cardinality(ARRAY[1, 2, 3, 4])",
    "SELECT ARRAY[n_nationkey, n_regionkey] FROM tpch.tiny.nation "
    "WHERE n_nationkey < 3 ORDER BY n_nationkey",
    "SELECT x FROM UNNEST(ARRAY[1, 2, 3]) t(x)",
    "SELECT x, o FROM UNNEST(ARRAY['a', 'b', 'c']) WITH ORDINALITY t(x, o)",
    "SELECT n_name, e FROM tpch.tiny.nation CROSS JOIN "
    "UNNEST(ARRAY[n_nationkey, n_regionkey]) t(e) WHERE n_nationkey < 2 "
    "ORDER BY n_name, e",
    "SELECT a, b FROM UNNEST(ARRAY[1, 2, 3], ARRAY['x']) t(a, b)",
    "SELECT array_agg(x) FROM (VALUES 3, 1, 2) t(x)",
    "SELECT n_regionkey, array_agg(n_name) FROM tpch.tiny.nation "
    "WHERE n_regionkey < 2 GROUP BY n_regionkey ORDER BY 1",
    "SELECT array_agg(x) FILTER (WHERE x > 1) "
    "FROM (VALUES 1, 2, NULL, 3) t(x)",
    "SELECT array_agg(x) FROM (VALUES 1, NULL) t(x)",
    """SELECT rk, sum(v) FROM (
          SELECT a.rk rk, e v FROM
            (SELECT n_regionkey rk, array_agg(n_nationkey) arr
             FROM tpch.tiny.nation GROUP BY n_regionkey) a
          CROSS JOIN UNNEST(a.arr) u(e)
        ) GROUP BY rk ORDER BY rk""",
    "SELECT n_regionkey, sum(n_nationkey) FROM tpch.tiny.nation "
    "GROUP BY n_regionkey ORDER BY 1",
    "SELECT e FROM (VALUES 2) t(x) CROSS JOIN UNNEST(ARRAY[x]) u(e) "
    "WHERE x < 0",
]

# the rest of the reference's array functions, and edge cases
MORE_SQL = [
    # string splitters, on the host once per dictionary value
    "SELECT split('a,b,,c', ','), split('a,b,c', ',', 2), split(n_name, 'A') "
    "FROM tpch.tiny.nation WHERE n_nationkey < 4 ORDER BY n_nationkey",
    "SELECT regexp_extract_all('a1b22c333', '[0-9]+'), "
    "regexp_split('a1b22c', '[0-9]+')",
    "SELECT regexp_extract_all(n_name, '([AEIOU])(.)', 2) "
    "FROM tpch.tiny.nation ORDER BY n_nationkey",
    "SELECT array_join(ARRAY[1, NULL, 3], '-'), "
    "array_join(ARRAY['x', NULL, 'z'], ',', 'N'), "
    "array_join(ARRAY[1.5, 2.0], ';'), array_join(ARRAY[true, false], '/')",
    "SELECT array_join(split(n_name, 'A'), '+') FROM tpch.tiny.nation "
    "ORDER BY n_nationkey",
    "SELECT n_name, x FROM tpch.tiny.nation "
    "CROSS JOIN UNNEST(split(n_comment, ' ')) t(x) WHERE n_nationkey = 1",
    # array_join over many rows, most of their arrays repeated; -0.0 and
    # 0.0, NULL arrays and elements, REAL, dates
    "SELECT l_orderkey, array_join(ARRAY[l_returnflag, l_linestatus, "
    "NULL], '|', '?'), array_join(ARRAY[l_quantity, -l_discount * 0e0], "
    "' '), array_join(ARRAY[l_linenumber, NULL], '-') "
    "FROM tpch.tiny.lineitem ORDER BY l_orderkey, l_linenumber",
    "SELECT o_orderpriority, array_join(array_sort(array_agg(o_orderstatus)), "
    "'') FROM tpch.tiny.orders WHERE o_orderkey < 200 GROUP BY o_custkey, "
    "o_orderpriority ORDER BY 1, 2",
    "SELECT o_orderstatus, count(DISTINCT array_join(ARRAY[o_orderpriority, "
    "o_clerk], '/')), min(array_join(ARRAY[o_shippriority, o_custkey % 7, "
    "NULL], '-', 'x')) FROM tpch.tiny.orders GROUP BY 1 ORDER BY 1",
    "SELECT array_join(a, ',') FROM (SELECT ARRAY[1, 2] a UNION ALL "
    "SELECT NULL UNION ALL SELECT ARRAY[1, 2] UNION ALL "
    "SELECT filter(ARRAY[1], x -> x > 5)) ORDER BY 1",
    "SELECT array_join(ARRAY[CAST(n_nationkey AS REAL) / 4, "
    "CAST(-0.0 AS REAL)], ','), array_join(ARRAY[DATE '1995-01-02'], ',') "
    "FROM tpch.tiny.nation ORDER BY n_nationkey",
    # structural functions
    "SELECT contains(ARRAY[1, 2, 3], 2), contains(ARRAY[1, 3], 2), "
    "array_position(ARRAY[7, 8, 9], 9)",
    "SELECT array_position(ARRAY['a', 'b'], 'b'), "
    "contains(ARRAY['a', 'b'], 'c'), contains(ARRAY[1, NULL], 2)",
    "SELECT array_min(ARRAY[3, 1, 2]), array_max(ARRAY[3, 1, 2]), "
    "array_distinct(ARRAY[1, 2, 1, 3, 2]), array_sort(ARRAY[3, 1, 2])",
    "SELECT array_sort(ARRAY[3, NULL, 1]), "
    "array_distinct(ARRAY['b', 'a', 'b']), "
    "array_sort(ARRAY['pear', 'apple', 'fig']), "
    "array_min(ARRAY['pear', 'apple']), array_max(ARRAY[1.5, 2.5])",
    "SELECT slice(ARRAY[1, 2, 3, 4], 2, 2), sequence(1, 4), repeat(7, 3), "
    "flatten(ARRAY[ARRAY[1, 2], ARRAY[3]])",
    "SELECT sequence(5, 1, -2), sequence(1, 10, 3), repeat('ab', 2), "
    "slice(ARRAY[1, 2, 3, 4, 5], -2, 5)",
    "SELECT array_union(ARRAY[1, 2], ARRAY[2, 3]), "
    "array_intersect(ARRAY[1, 2, 3], ARRAY[2, 3, 4]), "
    "array_except(ARRAY[1, 2, 3], ARRAY[2]), "
    "arrays_overlap(ARRAY[1, 2], ARRAY[2, 9])",
    "SELECT array_union(ARRAY['b', 'a'], ARRAY['c', 'a']), "
    "array_intersect(ARRAY[1, NULL], ARRAY[NULL, 2])",
    "SELECT array_remove(ARRAY[1, 2, 1, 3], 1), "
    "array_remove(ARRAY['a', 'b'], 'b'), array_remove(ARRAY[1, NULL, 2], NULL)",
    "SELECT zip(ARRAY[1, 2], ARRAY['a', 'b', 'c'])",
    "SELECT ngrams(ARRAY['a', 'b', 'c', 'd'], 2), ngrams(ARRAY[1, 2], 3)",
    "SELECT combinations(ARRAY[1, 2, 3, 4], 2), "
    "combinations(ARRAY['x', 'y', 'z'], 3), combinations(ARRAY[1], 2)",
    "SELECT array_first(ARRAY[5, 6, 7]), array_last(ARRAY[5, 6, 7]), "
    "array_first(filter(ARRAY[1], x -> x > 5))",
    # NULL and empty arrays
    "SELECT cardinality(filter(ARRAY[1], x -> x > 5)), "
    "cardinality(CAST(NULL AS array(bigint))), "
    "array_sort(CAST(NULL AS array(bigint)))",
    "SELECT transform(a, x -> x + 1), cardinality(a), array_max(a) "
    "FROM (SELECT ARRAY[1, 2] a UNION ALL SELECT filter(ARRAY[1], x -> x > 5) "
    "UNION ALL SELECT NULL UNION ALL SELECT ARRAY[3, NULL])",
    # nested arrays
    "SELECT ARRAY[ARRAY[1, 2], ARRAY[3]], "
    "flatten(ARRAY[ARRAY['x'], ARRAY['y', 'z']])",
    "SELECT transform(ARRAY[ARRAY[1, 2], ARRAY[3]], a -> cardinality(a)), "
    "transform(ARRAY[ARRAY[1, 2], ARRAY[3]], a -> transform(a, x -> x * 2))",
    "SELECT ARRAY[map(ARRAY[1], ARRAY['a']), map(ARRAY[2], ARRAY['b'])], "
    "ARRAY[ROW(1, 'x'), ROW(2, 'y')]",
    # array_agg: FILTER, grouped, then functions of the arrays
    "SELECT n_regionkey, array_agg(n_name) FILTER "
    "(WHERE n_nationkey % 2 = 0) FROM tpch.tiny.nation GROUP BY n_regionkey "
    "ORDER BY 1",
    "SELECT n_regionkey, array_sort(array_agg(n_name)) "
    "FROM tpch.tiny.nation GROUP BY n_regionkey ORDER BY 1",
    "SELECT count(*), sum(cardinality(a)) FROM (SELECT array_agg(l_quantity) "
    "a FROM tpch.tiny.lineitem GROUP BY l_orderkey)",
    # dictionary strings of two batches in one pool, a join
    "SELECT a FROM (SELECT ARRAY[n_name] a, n_nationkey k FROM "
    "tpch.tiny.nation WHERE n_nationkey < 2 UNION ALL SELECT "
    "ARRAY[r_name, 'zz'] a, r_regionkey + 100 k FROM tpch.tiny.region) "
    "ORDER BY k",
    "SELECT n_name, r.a FROM tpch.tiny.nation JOIN (SELECT r_regionkey k, "
    "ARRAY[r_name, r_comment] a FROM tpch.tiny.region) r "
    "ON n_regionkey = r.k ORDER BY n_name",
    "SELECT u.a, u.o FROM (VALUES ARRAY['p', 'q']) t(arr) "
    "CROSS JOIN UNNEST(arr) WITH ORDINALITY u(a, o)",
    # complex_sf10's (a), at tiny
    "SELECT l_returnflag, l_linestatus, count(*), sum(p), "
    "sum(CASE WHEN k = 2 THEN p END), max(k) FROM tpch.tiny.lineitem "
    "CROSS JOIN UNNEST(ARRAY[l_extendedprice, "
    "l_extendedprice * (1 - l_discount)]) WITH ORDINALITY AS t(p, k) "
    "GROUP BY 1, 2 ORDER BY 1, 2",
]


@pytest.mark.parametrize("i", range(len(REFERENCE_SQL)))
def test_reference_sql(engines, i):
    check(engines, REFERENCE_SQL[i])


@pytest.mark.parametrize("i", range(len(MORE_SQL)))
def test_more_sql(engines, i):
    check(engines, MORE_SQL[i])


def test_array_column_through_host_spill(monkeypatch):
    """A join carrying an ARRAY column, over max_batch_rows: the chunks
    go to host memory with their pools packed, come back as one batch,
    and the rows equal the unspilled run's and the JAX engine's."""
    sql = ("SELECT o_orderpriority, count(*), sum(cardinality(a)), "
           "sum(reduce(a, 0e0, (s, x) -> s + x, s -> s)) FROM tpch.tiny.orders "
           "JOIN (SELECT l_orderkey k, array_agg(l_extendedprice) a "
           "FROM tpch.tiny.lineitem GROUP BY l_orderkey) li "
           "ON o_orderkey = li.k GROUP BY 1 ORDER BY 1")
    runner = LocalQueryRunner(device="cpu")
    whole = runner.execute(sql)
    assert whole.spill_bytes == 0
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    spilled = runner.execute(sql)
    assert spilled.spill_bytes > 0
    assert same(spilled.rows, whole.rows)
    assert same(spilled.rows, TpuRunner().execute(sql).rows)


def test_array_join_of_colliding_hashes(monkeypatch):
    """array_join groups rows by two hashes of their elements, then
    compares each row with its group's first: with every hash made 0,
    the rows that differ are joined on their own and every row still
    equals the JAX engine's."""
    from trino_tpu_torch.exec import complex as cx
    sql = ("SELECT array_join(ARRAY[n_regionkey, n_nationkey % 3], '.'), "
           "array_join(split(n_name, 'A'), '+') FROM tpch.tiny.nation "
           "ORDER BY n_nationkey")
    want = TpuRunner().execute(sql).rows
    hashes = cx._row_hashes
    monkeypatch.setattr(cx, "_row_hashes",
                        lambda tok, owner, j, cap:
                        hashes(tok, owner, j, cap) * 0)
    got = LocalQueryRunner(device="cpu").execute(sql).rows
    assert got == want and len(set(r[0] for r in got)) > 1


def test_unnest_masks_the_dead_tail_of_a_filtered_batch():
    """The rows past num_rows of a filtered batch copy a live row; an
    expansion over the batch must not count their elements."""
    port = LocalQueryRunner(device="cpu")
    rows = port.execute(
        "SELECT count(*) FROM (SELECT ARRAY[1, 2, 3] a FROM tpch.tiny.orders "
        "WHERE o_orderkey = 1) CROSS JOIN UNNEST(a) t(x)").rows
    assert rows == [[3]]


def test_unnest_scans_only_the_columns_its_parents_read():
    """CROSS JOIN UNNEST replicates every column of its source; column
    pruning keeps only those a parent reads, so the scan below does not
    generate lineitem's text columns."""
    from trino_tpu_torch.plan.nodes import TableScanNode

    def scans(node):
        if isinstance(node, TableScanNode):
            yield node
        for child in node.sources:
            yield from scans(child)
    plan = LocalQueryRunner(device="cpu").plan_sql(
        "SELECT l_returnflag, count(*), sum(p) FROM tpch.tiny.lineitem "
        "CROSS JOIN UNNEST(ARRAY[l_extendedprice, l_tax]) AS t(p) "
        "GROUP BY 1")
    (scan,) = scans(plan)
    assert sorted(scan.assignments.values()) == [
        "l_extendedprice", "l_returnflag", "l_tax"]


# ---- faults of the reference that the port does not copy (ROADMAP C) -----

def test_array_distinct_and_set_operations_keep_doubles_apart():
    """The JAX engine truncates double elements to integers before it
    compares them, so 1.5 and 1.2 collapse; Trino (and the port) keep
    both."""
    sql = ("SELECT array_distinct(ARRAY[1.5e0, 1.2e0]), "
           "array_union(ARRAY[1.5e0], ARRAY[1.2e0])")
    assert TpuRunner().execute(sql).rows == [[[1.5], [1.5]]]
    assert LocalQueryRunner(device="cpu").execute(sql).rows == \
        [[[1.5, 1.2], [1.2, 1.5]]]


def test_subscript_of_a_nested_array():
    """The JAX engine's element_at over an array of arrays drops the
    inner pool and raises; Trino returns the inner array."""
    sql = "SELECT ARRAY[ARRAY['a'], ARRAY['b', 'c']][2]"
    with pytest.raises(Exception):
        TpuRunner().execute(sql)
    assert LocalQueryRunner(device="cpu").execute(sql).rows == \
        [[["b", "c"]]]


def test_array_min_of_booleans():
    """The JAX engine's array_min/array_max raise over BOOLEAN elements
    (no integer sentinel for a bool lane); Trino orders false < true."""
    sql = "SELECT array_min(ARRAY[true, false]), array_max(ARRAY[false])"
    with pytest.raises(Exception):
        TpuRunner().execute(sql)
    assert LocalQueryRunner(device="cpu").execute(sql).rows == \
        [[False, False]]


def test_unnest_of_an_empty_array():
    """The JAX engine's UNNEST gathers from the empty element pool and
    raises; Trino (and the port) return no rows."""
    sql = "SELECT x FROM UNNEST(filter(ARRAY[1], x -> x > 5)) t(x)"
    with pytest.raises(Exception):
        TpuRunner().execute(sql)
    assert LocalQueryRunner(device="cpu").execute(sql).rows == []
