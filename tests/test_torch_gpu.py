"""The PyTorch engine on a CUDA card: the grouped_sums kernel against its
plain version, and SQL on the card against SQL on the CPU.

Imports torch and the port only (no jax), so it runs where the card is:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

Without a card every test skips with the reason.
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
from trino_tpu_torch.ops import cuda_groupby as cg
from trino_tpu_torch.runner import LocalQueryRunner

SUM_REL = 1e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(name, rng):
    """(gid, lanes, nseg, indices of 0/1 count lanes)"""
    cap = 1 << 16
    money = np.round(rng.uniform(900, 105000, cap), 2)
    if name == "all_dead":
        return np.full(cap, 12, np.int32), [money, np.ones(cap)], 12, {1}
    if name == "ids_past_domain":
        gid = rng.integers(-5, 300, cap).astype(np.int32)
        return gid, [money, np.ones(cap)], 12, {1}
    if name == "nseg_64":
        gid = rng.integers(0, 64, cap).astype(np.int32)
        return gid, [money, np.ones(cap)], 64, {1}
    # many lanes: more than one launch's worth (64 per launch)
    gid = rng.integers(0, 13, cap).astype(np.int32)
    lanes = [money * (k + 1) for k in range(40)] + [np.ones(cap)] * 40
    return gid, lanes, 12, set(range(40, 80))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["all_dead", "ids_past_domain", "nseg_64",
                                  "lanes_80"])
def test_kernel_matches_plain(name, cuda):
    gid, lanes, nseg, counts = _case(name, np.random.default_rng(5))
    g = torch.from_numpy(gid).to(cuda)
    ls = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in lanes]
    before = cg.LAUNCHES
    got = cg.grouped_sums(g, ls, nseg)
    again = cg.grouped_sums(g, ls, nseg)
    want = cg.grouped_sums_plain(g, ls, nseg)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 2 * -(-len(ls) // 64)
    for i, (a, b, w) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), i
        if i in counts:
            assert torch.equal(a, w), i
        else:
            torch.testing.assert_close(a, w, rtol=SUM_REL, atol=0)


@pytest.mark.gpu
def test_kernel_rejects_bad_input(cuda):
    gid = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        cg.grouped_sums(gid, [torch.ones(64, dtype=torch.float64,
                                         device=cuda)], 4)


@pytest.mark.gpu
def test_q1_on_card_matches_cpu(cuda):
    q1 = TPCH_QUERIES[1]
    before = cg.LAUNCHES
    got = LocalQueryRunner(device=cuda).execute(q1).rows
    assert cg.LAUNCHES == before + 1
    want = LocalQueryRunner(device="cpu").execute(q1).rows
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[-1] == w[-1]
        for a, b in zip(g[2:-1], w[2:-1]):
            assert a == pytest.approx(b, rel=SUM_REL)


@pytest.mark.gpu
def test_device_generator_bit_identical_on_card(cuda):
    # prices are x / 100 in f64: a python-scalar divisor makes CUDA
    # multiply by the reciprocal and round some values differently
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.connectors.tpch_device import (
        LINEITEM_DEVICE_COLS, lineitem_batch)
    cols = sorted(LINEITEM_DEVICE_COLS)
    lo, hi = 14_990_000, 15_000_000
    got = lineitem_batch(lo, hi, 10.0, cols, cuda)
    want = TpchConnector(device="cpu")._lineitem(
        np.arange(lo + 1, hi + 1, dtype=np.int64), 10.0, cols)
    n = want.num_rows_host()
    assert got.num_rows_host() == n
    for name in cols:
        assert torch.equal(got.column(name).data[:n].cpu(),
                           want.column(name).data[:n]), name


def _join_sides(rng, device):
    from trino_tpu_torch.columnar import batch_from_pylist
    from trino_tpu_torch.types import parse_type
    big = parse_type("bigint")
    pk = [int(x) for x in rng.integers(0, 3000, 20_000)]
    pk[::97] = [None] * len(pk[::97])
    bk = [int(x) for x in rng.integers(0, 3000, 5_000)]
    probe = batch_from_pylist({"pk": pk, "pv": list(range(len(pk)))},
                              {"pk": big, "pv": big}, device=device)
    build = batch_from_pylist({"bk": bk, "bv": list(range(len(bk)))},
                              {"bk": big, "bv": big}, device=device)
    return probe, build


@pytest.mark.gpu
@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_join_on_card_matches_cpu(cuda, join_type):
    from trino_tpu_torch.config import capacity_for
    from trino_tpu_torch.ops import join as jo
    out = []
    for dev in (cuda, torch.device("cpu")):
        probe, build = _join_sides(np.random.default_rng(7), dev)
        start, count, order = jo.match_counts(probe, build, ["pk"], ["bk"])
        eff = (torch.where(probe.row_valid(), count.clamp(min=1), 0)
               if join_type == "left" else count)
        total = int(eff.sum())
        res = jo.expand_join(probe, build, start, count, order,
                             capacity_for(total), join_type)
        out.append((start.cpu(), count.cpu(), order.cpu(),
                    res.to_pylist()))
    for a, b in zip(*out):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b and len(a) > 0


@pytest.mark.gpu
def test_general_group_by_bit_identical_on_card(cuda):
    from trino_tpu_torch.columnar import batch_from_pylist
    from trino_tpu_torch.ops.groupby import AggInput, group_aggregate
    from trino_tpu_torch.types import parse_type
    rng = np.random.default_rng(11)
    n = 200_000
    keys = [int(x) for x in rng.integers(0, 50_000, n)]
    vals = [float(x) for x in np.round(rng.uniform(-1e5, 1e5, n), 2)]
    aggs = [AggInput("sum", "v", output="s"), AggInput("count", "v",
                                                       output="c"),
            AggInput("min", "v", output="lo")]
    runs = []
    for dev in (cuda, cuda, torch.device("cpu")):
        b = batch_from_pylist({"k": keys, "v": vals},
                              {"k": parse_type("bigint"),
                               "v": parse_type("double")}, device=dev)
        runs.append(group_aggregate(b, ["k"], aggs).to_pylist())
    assert runs[0] == runs[1]
    assert len(runs[0]) == len(runs[2]) == len(set(keys))
    for g, w in zip(runs[0], runs[2]):
        assert g[0] == w[0] and g[2:] == w[2:]
        assert g[1] == pytest.approx(w[1], rel=SUM_REL, abs=1e-6)


@pytest.mark.gpu
def test_orders_generator_bit_identical_on_card(cuda):
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.connectors.tpch_device import (
        ORDERS_DEVICE_COLS, orders_batch)
    cols = sorted(ORDERS_DEVICE_COLS)
    lo, hi = 14_990_000, 15_000_000
    got = orders_batch(lo, hi, 10.0, cols, cuda)
    want = TpchConnector(device="cpu")._orders(
        np.arange(lo + 1, hi + 1, dtype=np.int64), 10.0, cols)
    n = want.num_rows_host()
    assert got.num_rows_host() == n
    for name in cols:
        assert torch.equal(got.column(name).data[:n].cpu(),
                           want.column(name).data[:n]), name


@pytest.mark.gpu
@pytest.mark.parametrize("q", [3, 4, 5, 6, 10, 18])
def test_join_queries_on_card_match_cpu(cuda, q):
    sql = TPCH_QUERIES[q]
    got = LocalQueryRunner(device=cuda).execute(sql).rows
    want = LocalQueryRunner(device="cpu").execute(sql).rows
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=SUM_REL)
            else:
                assert a == b


@pytest.mark.gpu
@pytest.mark.parametrize("q", [2, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, 19,
                               20, 21, 22])
def test_new_slice_queries_on_card_match_cpu(cuda, q):
    test_join_queries_on_card_match_cpu(cuda, q)


@pytest.mark.gpu
def test_spilled_join_returns_to_the_card(cuda, monkeypatch):
    from trino_tpu_torch.config import CONFIG
    from trino_tpu_torch.exec import executor as ex_mod
    sql = ("SELECT o_orderpriority, count(*), sum(l_quantity) "
           "FROM orders JOIN lineitem ON l_orderkey = o_orderkey "
           "GROUP BY o_orderpriority ORDER BY 1")
    runner = LocalQueryRunner(device=cuda)
    whole = runner.execute(sql)
    chunks = []
    to_host = ex_mod._to_host

    def spy(b, n):
        out = to_host(b, n)
        chunks.append(out)
        return out
    monkeypatch.setattr(ex_mod, "_to_host", spy)
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    spilled = runner.execute(sql)
    assert spilled.spill_bytes > 0 and len(chunks) > 1
    for c in chunks:
        for col in c.columns.values():
            assert col.data.device.type == "cpu" and col.data.is_pinned()
    assert spilled.rows == whole.rows
    # the join node's output, read by its parent, is back on the card
    join = runner.plan_sql(sql)
    while type(join).__name__ != "JoinNode":
        join = join.source
    ex = ex_mod.Executor(runner.catalogs, runner.session, runner.device)
    out = ex.execute(join)
    assert not out.spilled
    assert all(c.data.device.type == "cuda" for c in out.columns.values())


@pytest.mark.gpu
def test_dict_transform_clamps_code_minus_one_on_card(cuda):
    from trino_tpu_torch.columnar import Batch, Column, StringDictionary
    from trino_tpu_torch.exec.expr import eval_expr
    from trino_tpu_torch.rex import Call, Const, InputRef
    from trino_tpu_torch.types import BOOLEAN, VARCHAR
    values = np.asarray(["forest green", "red", "green tea"], dtype=object)
    codes = np.asarray([0, 1, -1, 2, -1, 1, 0, 2], dtype=np.int32)
    expr = Call("like", (InputRef("s", VARCHAR),
                         Const("%green%", VARCHAR)), BOOLEAN)
    rows = []
    for dev in (cuda, torch.device("cpu")):
        col = Column(VARCHAR, torch.from_numpy(codes).to(dev), None,
                     StringDictionary(values))
        got = eval_expr(expr, Batch({"s": col}, 8))
        assert got.data.device.type == dev.type
        rows.append(Batch({"r": got}, 8).to_pylist())
    assert rows[0] == rows[1]
    assert rows[0][2] == rows[0][0] == [True]


@pytest.mark.gpu
def test_count_distinct_on_card_matches_cpu(cuda):
    from trino_tpu_torch.columnar import batch_from_pylist
    from trino_tpu_torch.ops.groupby import (AggInput, global_aggregate,
                                             group_aggregate)
    from trino_tpu_torch.types import parse_type
    rng = np.random.default_rng(12)
    n = 200_000
    keys = [int(x) for x in rng.integers(0, 5_000, n)]
    vals = [None if x % 17 == 0 else float(x % 40) * 0.5
            for x in rng.integers(0, 1_000, n)]
    aggs = [AggInput("count_distinct", "v", output="d"),
            AggInput("count", "v", output="c")]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        b = batch_from_pylist({"k": keys, "v": vals},
                              {"k": parse_type("bigint"),
                               "v": parse_type("double")}, device=dev)
        runs.append((group_aggregate(b, ["k"], aggs).to_pylist(),
                     global_aggregate(b, aggs).to_pylist()))
    assert runs[0] == runs[1]
    assert runs[0][1][0][0] == 40


def _rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and b != b:
                assert a != a
            elif isinstance(b, float):
                assert a == pytest.approx(b, rel=SUM_REL)
            else:
                assert a == b


def _tpcds_runner(device, schema="tiny"):
    from trino_tpu_torch.session import Session
    return LocalQueryRunner(Session(catalog="tpcds", schema=schema),
                            device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [2, 5, 8, 12, 14, 36, 38, 47, 49, 51, 57,
                               64, 67, 70, 75, 78, 83, 86, 87, 98])
def test_tpcds_queries_on_card_match_cpu(cuda, q):
    """TPC-DS at tiny on the card against the CPU: UNION, INTERSECT and
    EXCEPT, ROLLUP through GroupId, windows, DECIMAL(38, 6) division."""
    from trino_tpu_torch.benchmarks.tpcds_queries import TPCDS_QUERIES
    sql = TPCDS_QUERIES[q]
    got = _tpcds_runner(cuda).execute(sql)
    again = _tpcds_runner(cuda).execute(sql)
    _rows_match(got.rows, _tpcds_runner("cpu").execute(sql).rows)
    assert again.rows == got.rows


WINDOW_SQL = [
    "SELECT o_custkey, o_orderkey, sum(o_totalprice) OVER (PARTITION BY "
    "o_custkey ORDER BY o_orderdate, o_orderkey), avg(o_totalprice) OVER "
    "(PARTITION BY o_custkey), rank() OVER (PARTITION BY o_orderstatus "
    "ORDER BY o_totalprice DESC), dense_rank() OVER (ORDER BY "
    "o_orderpriority), lag(o_totalprice, 2, -1.0) OVER (PARTITION BY "
    "o_custkey ORDER BY o_orderkey), min(o_totalprice) OVER (PARTITION BY "
    "o_custkey ORDER BY o_orderkey ROWS BETWEEN 2 PRECEDING AND 1 "
    "FOLLOWING), sum(o_totalprice) OVER (ORDER BY o_orderdate RANGE "
    "BETWEEN 30 PRECEDING AND CURRENT ROW), count(*) OVER (ORDER BY "
    "o_orderdate GROUPS BETWEEN 1 PRECEDING AND 1 FOLLOWING), ntile(7) "
    "OVER (ORDER BY o_orderkey), cume_dist() OVER (PARTITION BY "
    "o_orderstatus ORDER BY o_orderdate) FROM orders ORDER BY o_orderkey",
    "SELECT l_returnflag, l_linestatus, sum(l_quantity), grouping("
    "l_returnflag, l_linestatus), rank() OVER (PARTITION BY grouping("
    "l_returnflag, l_linestatus) ORDER BY sum(l_quantity)) FROM lineitem "
    "GROUP BY CUBE (l_returnflag, l_linestatus) ORDER BY 4, 1, 2",
    "SELECT o_custkey FROM orders WHERE o_orderpriority = '1-URGENT' "
    "INTERSECT ALL SELECT o_custkey FROM orders WHERE o_orderstatus = 'F' "
    "EXCEPT SELECT c_custkey FROM customer WHERE c_acctbal < 0 ORDER BY 1",
    "SELECT l_returnflag, sum(CAST(l_quantity AS DECIMAL(30,2))), "
    "avg(CAST(l_extendedprice AS DECIMAL(30,2))), min(l_quantity * 1.00 / "
    "l_linenumber), max(CAST(l_discount AS DECIMAL(25,4)) * l_quantity) "
    "FROM lineitem GROUP BY l_returnflag ORDER BY 1",
]


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(WINDOW_SQL)))
def test_window_setop_int128_sql_on_card_match_cpu(cuda, i):
    got = LocalQueryRunner(device=cuda).execute(WINDOW_SQL[i]).rows
    want = LocalQueryRunner(device="cpu").execute(WINDOW_SQL[i]).rows
    assert got
    _rows_match(got, want)


@pytest.mark.gpu
def test_int128_primitives_on_card_bit_identical_to_cpu(cuda):
    from trino_tpu_torch.ops import int128 as i128
    rng = np.random.default_rng(7)
    n = 4096
    vals = [int(x) * 10 ** int(e) * (1 if s else -1) for x, e, s in zip(
        rng.integers(0, 10 ** 15, n), rng.integers(0, 23, n),
        rng.integers(0, 2, n))]
    vals[:4] = [2 ** 127 - 1, -(2 ** 127), 5, -15]
    lo = np.array([i128.split_const(v)[0] for v in vals], np.int64)
    hi = np.array([i128.split_const(v)[1] for v in vals], np.int64)
    divs = np.array([int(x) or 7 for x in rng.integers(-10 ** 6, 10 ** 6,
                                                       n)], np.int64)
    out = []
    for dev in (cuda, torch.device("cpu")):
        a = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
        b = torch.from_numpy(divs).to(dev)
        bh = i128.sign_extend(b)
        res = [*i128.mul128(*a, b, bh), *i128.divmod128_trunc(*a, b, bh),
               *i128.div128_round_half_up_pair(*a, b, bh),
               *i128.rescale(*a, -4), i128.to_double(*a),
               i128.lt128(*a, b, bh), *i128.add128(*a, b, bh)]
        out.append([r.cpu() for r in res])
    for x, y in zip(*out):
        assert torch.equal(x, y)
