"""Window functions in the PyTorch engine against the JAX engine.

The SQL of tests/test_window_frames.py (its ten explicit-frame cases:
ROWS / RANGE / GROUPS bounds, empty frames, first/last/nth_value,
partitions, NULLs), then ranking with ties and NULL ordering, lag/lead
with offsets and defaults, and running and whole-partition aggregates over
tpch.tiny, through both runners on the CPU. Rows are compared in order:
integers and strings exact, doubles within rel 1e-9.
"""

import pytest

from test_torch_tpch import _same
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.runner import LocalQueryRunner

BASE = ("FROM (VALUES (1, 10), (2, 20), (3, 30), (4, 40), (5, 50)) "
        "AS t(k, v)")
TIES = ("FROM (VALUES ('a', 1, 10.5), ('a', 1, 2.0), ('a', 2, NULL), "
        "('a', NULL, 4.25), ('b', 3, 1.0), ('b', 3, 1.0), ('b', NULL, 7.0), "
        "(NULL, 1, 3.5)) AS t(p, o, v)")

SQL = {
    # tests/test_window_frames.py
    "rows_preceding_following":
        "SELECT k, sum(v) OVER (ORDER BY k ROWS BETWEEN 1 PRECEDING AND "
        f"1 FOLLOWING) {BASE} ORDER BY k",
    "rows_current_and_following":
        "SELECT k, sum(v) OVER (ORDER BY k ROWS BETWEEN CURRENT ROW AND "
        f"UNBOUNDED FOLLOWING) {BASE} ORDER BY k",
    "rows_moving_avg_min_max":
        "SELECT k, avg(v) OVER (ORDER BY k ROWS BETWEEN 2 PRECEDING AND "
        "CURRENT ROW), min(v) OVER (ORDER BY k ROWS BETWEEN 1 PRECEDING "
        "AND 1 FOLLOWING), max(v) OVER (ORDER BY k ROWS BETWEEN 1 "
        f"PRECEDING AND 1 FOLLOWING) {BASE} ORDER BY k",
    "rows_count_empty_frame":
        "SELECT k, count(v) OVER (ORDER BY k ROWS BETWEEN 3 FOLLOWING AND "
        "4 FOLLOWING), sum(v) OVER (ORDER BY k ROWS BETWEEN 3 FOLLOWING "
        f"AND 4 FOLLOWING) {BASE} ORDER BY k",
    "range_value_offsets":
        "SELECT k, sum(v) OVER (ORDER BY k RANGE BETWEEN 2 PRECEDING AND "
        f"CURRENT ROW) {BASE} ORDER BY k",
    "range_peers_included":
        "SELECT v, sum(v) OVER (ORDER BY g RANGE BETWEEN UNBOUNDED "
        "PRECEDING AND CURRENT ROW) FROM (VALUES (1, 10), (1, 20), "
        "(2, 30)) AS t(g, v) ORDER BY v",
    "groups_frames":
        "SELECT g, v, sum(v) OVER (ORDER BY g GROUPS BETWEEN 1 PRECEDING "
        "AND CURRENT ROW) FROM (VALUES (1, 10), (1, 20), (2, 30), "
        "(3, 40)) AS t(g, v) ORDER BY g, v",
    "first_last_nth_with_frames":
        "SELECT k, first_value(v) OVER (ORDER BY k ROWS BETWEEN 1 "
        "PRECEDING AND 1 FOLLOWING), last_value(v) OVER (ORDER BY k ROWS "
        "BETWEEN 1 PRECEDING AND 1 FOLLOWING), nth_value(v, 2) OVER "
        "(ORDER BY k ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) "
        f"{BASE} ORDER BY k",
    "frames_with_partitions":
        "SELECT p, k, sum(v) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN "
        "1 PRECEDING AND CURRENT ROW) FROM (VALUES ('a', 1, 10), "
        "('a', 2, 20), ('b', 1, 5), ('b', 2, 7)) AS t(p, k, v) "
        "ORDER BY p, k",
    "frames_with_nulls":
        "SELECT k, sum(v) OVER (ORDER BY k ROWS BETWEEN 1 PRECEDING AND "
        "CURRENT ROW) FROM (VALUES (1, 10), (2, CAST(NULL AS bigint)), "
        "(3, 30)) AS t(k, v) ORDER BY k",
    # ranking with ties and NULL ordering
    "ranking_with_ties_and_nulls":
        "SELECT p, o, v, rank() OVER (PARTITION BY p ORDER BY o), "
        "dense_rank() OVER (PARTITION BY p ORDER BY o), "
        "row_number() OVER (PARTITION BY p ORDER BY o, v), "
        "percent_rank() OVER (PARTITION BY p ORDER BY o), "
        "cume_dist() OVER (PARTITION BY p ORDER BY o) "
        f"{TIES} ORDER BY p, o, v",
    "ranking_desc_nulls_first":
        "SELECT p, o, v, rank() OVER (ORDER BY o DESC NULLS FIRST), "
        "rank() OVER (ORDER BY v ASC NULLS FIRST), ntile(3) OVER "
        f"(ORDER BY v DESC) {TIES} ORDER BY p, o, v",
    "lag_lead_with_defaults":
        "SELECT p, o, v, lag(v) OVER (PARTITION BY p ORDER BY o, v), "
        "lead(v, 2) OVER (PARTITION BY p ORDER BY o, v), "
        "lag(v, 1, -1.00) OVER (PARTITION BY p ORDER BY o, v), "
        "lead(p, 1, 'none') OVER (ORDER BY o, v, p) "
        f"{TIES} ORDER BY p, o, v",
    "value_functions_default_frame":
        "SELECT p, o, v, first_value(v) OVER (PARTITION BY p ORDER BY o), "
        "last_value(v) OVER (PARTITION BY p ORDER BY o), "
        "count(v) OVER (PARTITION BY p ORDER BY o), "
        "count(*) OVER (PARTITION BY p) "
        f"{TIES} ORDER BY p, o, v",
    # running and whole-partition aggregates over a table
    "running_and_partition_aggregates":
        "SELECT o_custkey, o_orderkey, sum(o_totalprice) OVER (PARTITION BY "
        "o_custkey ORDER BY o_orderdate, o_orderkey), avg(o_totalprice) "
        "OVER (PARTITION BY o_custkey), min(o_totalprice) OVER (PARTITION "
        "BY o_custkey ORDER BY o_orderdate, o_orderkey), max(o_shippriority)"
        " OVER (PARTITION BY o_orderstatus), sum(o_orderkey) OVER (ORDER BY "
        "o_orderkey ROWS UNBOUNDED PRECEDING) FROM orders "
        "WHERE o_custkey < 40 ORDER BY o_custkey, o_orderkey",
    "rank_over_a_group_by":
        "SELECT n_regionkey, n_name, sum(s_acctbal), rank() OVER "
        "(PARTITION BY n_regionkey ORDER BY sum(s_acctbal) DESC) FROM "
        "supplier JOIN nation ON s_nationkey = n_nationkey "
        "GROUP BY n_regionkey, n_name ORDER BY 1, 4",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_window_matches_the_jax_engine(name, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    got = LocalQueryRunner(device="cpu").execute(SQL[name])
    assert got.rows
    _same(got, TpuRunner().execute(SQL[name]))


def test_window_frames_hand_oracle():
    """The port's answers for two of the frame cases equal the hand-made
    oracles of tests/test_window_frames.py."""
    run = LocalQueryRunner(device="cpu").execute
    assert run(SQL["rows_count_empty_frame"]).rows == [
        [1, 2, 90], [2, 1, 50], [3, 0, None], [4, 0, None], [5, 0, None]]
    assert run(SQL["groups_frames"]).rows == [
        [1, 10, 30], [1, 20, 30], [2, 30, 60], [3, 40, 70]]


def test_lag_default_of_another_type_takes_the_value_type():
    """lag(x, n, -1.0) over a DOUBLE x: the default is a DECIMAL(2, 1)
    literal whose unscaled lane is -10. The port casts it to DOUBLE
    (-1.0). The JAX engine copies the unscaled lane into the double lane
    and returns -10.0, a fault logged in ROADMAP.md section C, so this
    case is held to the SQL answer, not to the JAX engine."""
    sql = ("SELECT o_orderkey, lag(o_totalprice, 2, -1.0) OVER (ORDER BY "
           "o_orderkey) FROM orders WHERE o_orderkey < 4 ORDER BY 1")
    got = LocalQueryRunner(device="cpu").execute(sql).rows
    assert [r[1] for r in got[:2]] == [-1.0, -1.0]
    assert [r[1] for r in TpuRunner().execute(sql).rows[:2]] == \
        [-10.0, -10.0]
