"""Set operations and grouping sets in the PyTorch engine against the JAX
engine: UNION [ALL], INTERSECT and EXCEPT [ALL] with duplicate rows and
NULLs, string columns whose dictionaries differ between the sides, and
ROLLUP, CUBE and GROUPING SETS at tpch.tiny, through both runners on the
CPU. Rows are compared in order: integers and strings exact, doubles
within rel 1e-9.
"""

import pytest

from test_torch_tpch import _same
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.runner import LocalQueryRunner

L = ("(VALUES (1, 'x'), (1, 'x'), (1, 'x'), (2, 'y'), (NULL, 'z'), "
     "(NULL, 'z'), (3, NULL), (5, 'v')) AS l(a, b)")
R = ("(VALUES (1, 'x'), (2, 'y'), (2, 'y'), (NULL, 'z'), (3, NULL), "
     "(4, 'w')) AS r(a, b)")

SQL = {
    "union_all_keeps_duplicates":
        f"SELECT a, b FROM {L} UNION ALL SELECT a, b FROM {R} "
        "ORDER BY a, b",
    "union_distinct":
        f"SELECT a, b FROM {L} UNION SELECT a, b FROM {R} ORDER BY a, b",
    "intersect_distinct":
        f"SELECT a, b FROM {L} INTERSECT SELECT a, b FROM {R} "
        "ORDER BY a, b",
    "intersect_all":
        f"SELECT a, b FROM {L} INTERSECT ALL SELECT a, b FROM {R} "
        "ORDER BY a, b",
    "except_distinct":
        f"SELECT a, b FROM {L} EXCEPT SELECT a, b FROM {R} ORDER BY a, b",
    "except_all":
        f"SELECT a, b FROM {L} EXCEPT ALL SELECT a, b FROM {R} "
        "ORDER BY a, b",
    "union_of_tables_with_different_dictionaries":
        "SELECT n_name, n_regionkey FROM nation WHERE n_nationkey < 5 "
        "UNION ALL SELECT r_name, r_regionkey FROM region "
        "UNION ALL SELECT c_mktsegment, c_nationkey FROM customer "
        "WHERE c_custkey < 4 ORDER BY 1, 2",
    "intersect_of_tables":
        "SELECT o_custkey FROM orders WHERE o_orderpriority = '1-URGENT' "
        "INTERSECT SELECT c_custkey FROM customer WHERE c_acctbal > 9000 "
        "ORDER BY 1",
    "except_of_tables":
        "SELECT c_nationkey, c_mktsegment FROM customer EXCEPT SELECT "
        "s_nationkey, 'BUILDING' FROM supplier ORDER BY 1, 2",
    "rollup":
        "SELECT n_regionkey, n_name, count(*), sum(s_acctbal) FROM supplier "
        "JOIN nation ON s_nationkey = n_nationkey "
        "GROUP BY ROLLUP (n_regionkey, n_name) ORDER BY 1, 2",
    "cube":
        "SELECT o_orderstatus, o_orderpriority, count(*), "
        "avg(o_totalprice) FROM orders GROUP BY CUBE (o_orderstatus, "
        "o_orderpriority) ORDER BY 1, 2",
    "grouping_sets":
        "SELECT l_returnflag, l_linestatus, l_shipmode, sum(l_quantity), "
        "count(*) FROM lineitem GROUP BY GROUPING SETS ((l_returnflag), "
        "(l_linestatus, l_shipmode), ()) ORDER BY 1, 2, 3",
    "rollup_with_grouping_and_rank":
        "SELECT n_regionkey, n_name, sum(s_acctbal), grouping(n_regionkey, "
        "n_name), rank() OVER (PARTITION BY grouping(n_regionkey, n_name) "
        "ORDER BY sum(s_acctbal) DESC) FROM supplier JOIN nation "
        "ON s_nationkey = n_nationkey GROUP BY ROLLUP (n_regionkey, n_name) "
        "ORDER BY 4, 5, 1, 2",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_setop_matches_the_jax_engine(name, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    got = LocalQueryRunner(device="cpu").execute(SQL[name])
    assert got.rows
    _same(got, TpuRunner().execute(SQL[name]))


def test_setops_hand_oracle():
    """INTERSECT ALL keeps min(nl, nr) copies and EXCEPT ALL nl - nr, NULL
    equal to NULL (the SQL standard's set-operation rule)."""
    run = LocalQueryRunner(device="cpu").execute
    assert run(SQL["intersect_all"]).rows == [
        [1, "x"], [2, "y"], [3, None], [None, "z"]]
    assert run(SQL["except_all"]).rows == [
        [1, "x"], [1, "x"], [5, "v"], [None, "z"]]
    assert run(SQL["except_distinct"]).rows == [[5, "v"]]
