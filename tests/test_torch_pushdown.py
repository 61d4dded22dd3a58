"""TupleDomain pushdown in the port against the JAX package, on the CPU:
every case of tests/test_pushdown.py run against the port's predicate
model and runner, with each EXPLAIN text equal to the reference's. The
memory connector takes filter and limit pushdown and enforces them on
the device chunk by chunk; a table of several chunks (a monkeypatched
``CONFIG.max_batch_rows``) keeps the reference's plans and rows, with
and without LIMIT.
"""

import numpy as np
import pytest
import torch

import trino_tpu_torch.config as torch_config
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.connectors.tpch_device import device_filter
from trino_tpu_torch.columnar import batch_from_pylist
from trino_tpu_torch.predicate import (Domain, Range, TupleDomain,
                                       extract_tuple_domain)
from trino_tpu_torch.rex import Call, Const, InputRef
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.types import BIGINT, BOOLEAN, VARCHAR


@pytest.fixture(scope="module")
def runners():
    return LocalQueryRunner(device="cpu"), TpuRunner()


def _explain(r, sql):
    return [row[0] for row in r.execute("EXPLAIN " + sql).rows]


def _both(runners, sql):
    """The port's rows and EXPLAIN, each held to the reference's."""
    port, tpu = runners
    plan = _explain(port, sql)
    assert plan == _explain(tpu, sql), sql
    got = port.execute(sql).rows
    assert got == tpu.execute(sql).rows, sql
    return "\n".join(plan), got


def _run_both(runners, sql):
    for r in runners:
        r.execute(sql)


# --- domain algebra -------------------------------------------------------

def test_domain_intersect_union():
    d1 = Domain.range(BIGINT, 0, True, 10, True)
    d2 = Domain.range(BIGINT, 5, True, 20, True)
    inter = d1.intersect(d2)
    assert inter.ranges == (Range(5, True, 10, True),)
    uni = d1.union(d2)
    assert uni.ranges == (Range(0, True, 20, True),)
    assert Domain.single(BIGINT, 3).intersect(
        Domain.single(BIGINT, 4)).is_none()


def test_domain_in_values_and_mask():
    d = Domain.in_values(BIGINT, [3, 1, 3, 7])
    assert [r.low for r in d.ranges] == [1, 3, 7]
    mask = d.mask_for(np.asarray([0, 1, 2, 3, 7, 8]))
    assert list(mask) == [False, True, False, True, True, False]


def test_tuple_domain_intersect():
    td1 = TupleDomain.of({"a": Domain.single(BIGINT, 1)})
    td2 = TupleDomain.of({"a": Domain.single(BIGINT, 2)})
    assert td1.intersect(td2).is_none
    td3 = TupleDomain.of({"b": Domain.not_null(BIGINT)})
    merged = td1.intersect(td3)
    assert set(merged.as_dict()) == {"a", "b"}


def test_extract_tuple_domain():
    types = {"x": BIGINT, "y": VARCHAR}
    x = InputRef("x", BIGINT)
    pred = Call("and", (
        Call(">=", (x, Const(5, BIGINT)), BOOLEAN),
        Call("<", (x, Const(10, BIGINT)), BOOLEAN)), BOOLEAN)
    td, residual = extract_tuple_domain(pred, types)
    assert not residual
    assert td.domain("x").ranges == (Range(5, True, 10, False),)
    pred2 = Call("and", (
        Call("=", (x, Const(1, BIGINT)), BOOLEAN),
        Call("like", (InputRef("y", VARCHAR), Const("a%", VARCHAR)),
             BOOLEAN)), BOOLEAN)
    td2, res2 = extract_tuple_domain(pred2, types)
    assert td2.domain("x") is not None and len(res2) == 1


# --- engine integration ---------------------------------------------------

def test_pushdown_correctness_vs_no_pushdown(runners):
    queries = [
        "SELECT count(*) FROM tpch.tiny.lineitem WHERE l_quantity < 10",
        "SELECT count(*) FROM tpch.tiny.orders WHERE "
        "o_orderdate >= DATE '1995-01-01' AND "
        "o_orderdate < DATE '1996-01-01'",
        "SELECT count(*) FROM tpch.tiny.nation WHERE "
        "n_name IN ('CANADA', 'BRAZIL')",
        "SELECT count(*) FROM tpch.tiny.customer WHERE "
        "c_mktsegment = 'BUILDING' AND c_custkey > 100",
    ]
    with_pd = [_both(runners, q)[1] for q in queries]
    _run_both(runners, "SET SESSION pushdown_into_scan = false")
    try:
        without = [_both(runners, q)[1] for q in queries]
    finally:
        _run_both(runners, "SET SESSION pushdown_into_scan = true")
    assert with_pd == without


def test_pushdown_shows_in_plan(runners):
    txt, _ = _both(runners, "SELECT n_name FROM tpch.tiny.nation "
                            "WHERE n_nationkey = 3")
    assert "constraint=" in txt
    assert "Filter" not in txt      # fully enforced: the filter is gone


def test_residual_filter_stays(runners):
    txt, _ = _both(runners, "SELECT n_name FROM tpch.tiny.nation "
                            "WHERE n_nationkey = 3 AND n_comment LIKE '%a%'")
    assert "constraint=" in txt and "Filter" in txt


def test_limit_pushdown(runners):
    txt, got = _both(runners, "SELECT n_name FROM tpch.tiny.nation LIMIT 3")
    assert "limit=3" in txt
    assert len(got) == 3


def test_memory_connector_pushdown(runners):
    _run_both(runners, "CREATE TABLE memory.default.pd AS "
                       "SELECT * FROM tpch.tiny.region")
    try:
        txt, got = _both(runners, "SELECT r_name FROM memory.default.pd "
                                  "WHERE r_regionkey = 2")
        assert got == [['ASIA']]
        assert "TableScan[memory.default.pd constraint=(r_regionkey IN " \
               "[2])]" in txt
        assert "Filter" not in txt
        _, got = _both(runners, "SELECT r_name FROM memory.default.pd "
                                "WHERE r_name < 'ASIA' ORDER BY r_name")
        assert got == [['AFRICA'], ['AMERICA']]
    finally:
        _run_both(runners, "DROP TABLE memory.default.pd")


def test_contradiction_prunes_to_zero(runners):
    _, got = _both(runners, "SELECT count(*) FROM tpch.tiny.nation "
                            "WHERE n_nationkey = 1 AND n_nationkey = 2")
    assert got == [[0]]


def test_pushdown_with_nulls(runners):
    _run_both(runners, "CREATE TABLE memory.default.pn (x bigint)")
    try:
        _run_both(runners, "INSERT INTO memory.default.pn VALUES (1), "
                           "(NULL), (3)")
        for where, want in (("x > 0", 2), ("x IS NULL", 1),
                            ("x IS NOT NULL", 2)):
            txt, got = _both(runners, "SELECT count(*) FROM "
                                      f"memory.default.pn WHERE {where}")
            assert got == [[want]]
            assert "constraint=" in txt
    finally:
        _run_both(runners, "DROP TABLE memory.default.pn")


CHUNKED_SQL = [
    "SELECT n_name FROM memory.default.pc WHERE n_nationkey = 2",
    "SELECT n_name, n_regionkey FROM memory.default.pc "
    "WHERE n_nationkey > 15",
    "SELECT n_name FROM memory.default.pc LIMIT 3",
    "SELECT n_name FROM memory.default.pc LIMIT 10",
    "SELECT n_name FROM memory.default.pc WHERE n_regionkey = 1 LIMIT 3",
    "SELECT n_name FROM memory.default.pc WHERE n_nationkey > 3 "
    "AND n_comment LIKE '%a%' LIMIT 4",
    "SELECT count(*) FROM memory.default.pc WHERE n_regionkey IN (1, 3)",
    "SELECT n_regionkey, count(*) FROM memory.default.pc "
    "WHERE n_nationkey >= 6 GROUP BY n_regionkey ORDER BY n_regionkey",
]


@pytest.mark.parametrize("sql", CHUNKED_SQL)
def test_memory_table_of_several_chunks(runners, monkeypatch, sql):
    """25 rows stored as chunks of 7: each chunk is a split that enforces
    the constraint and its own limit, the LimitNode above the scan caps
    the table; plans and rows equal the reference's."""
    monkeypatch.setattr(torch_config.CONFIG, "max_batch_rows", 7)
    _run_both(runners, "CREATE TABLE memory.default.pc AS "
                       "SELECT * FROM tpch.tiny.nation")
    try:
        chunks = runners[0].catalogs.connector("memory").stored_chunks(
            "default", "pc")
        assert [c.num_rows_host() for c in chunks] == [7, 7, 7, 4]
        txt, _ = _both(runners, sql)
        assert "TableScan[memory.default.pc " in txt
        if "LIMIT" in sql:
            assert "Limit[" in txt
    finally:
        _run_both(runners, "DROP TABLE memory.default.pc")


def test_device_filter_keeps_nulls_where_the_domain_allows():
    """The enforcement on a chunk: NULL rows follow ``null_allowed``
    (numeric and dictionary lanes), as the host mask does."""
    b = batch_from_pylist({"x": [1, None, 3, 5], "s": ["a", None, "c", "a"]},
                          {"x": BIGINT, "s": VARCHAR}, device="cpu")
    cases = [("x", Domain.range(BIGINT, 2, True, None, False), [3, 5]),
             ("x", Domain.only_null(BIGINT), [None]),
             ("x", Domain.not_null(BIGINT), [1, 3, 5]),
             ("s", Domain.single(VARCHAR, "a"), [1, 5]),
             ("s", Domain.only_null(VARCHAR), [None])]
    for col, dom, want in cases:
        out = device_filter(b, TupleDomain.of({col: dom}), None)
        assert [r[0] for r in out.to_pylist()] == want, (col, dom)
        n = out.num_rows_host()
        host = dom.mask_for(
            np.asarray([1, 0, 3, 5]) if col == "x"
            else np.asarray(["a", "", "c", "a"]),
            np.asarray([True, False, True, True]))
        assert n == int(host.sum())
    out = device_filter(b, TupleDomain.of(
        {"x": Domain.not_null(BIGINT)}), 2)
    assert out.num_rows_host() == 2
    assert isinstance(out.num_rows, torch.Tensor)
