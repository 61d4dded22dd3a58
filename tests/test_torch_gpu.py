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
    if name == "odd_cap":
        gid = rng.integers(0, 14, cap + 3).astype(np.int32)
        money = np.round(rng.uniform(900, 105000, cap + 3), 2)
        return gid, [money, np.ones(cap + 3)], 12, {1}
    # many lanes: one launch takes them all
    gid = rng.integers(0, 13, cap).astype(np.int32)
    lanes = [money * (k + 1) for k in range(40)] + [np.ones(cap)] * 40
    return gid, lanes, 12, set(range(40, 80))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["all_dead", "ids_past_domain", "nseg_64",
                                  "lanes_80", "odd_cap"])
def test_kernel_matches_plain(name, cuda):
    gid, lanes, nseg, counts = _case(name, np.random.default_rng(5))
    g = torch.from_numpy(gid).to(cuda)
    ls = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in lanes]
    before = cg.LAUNCHES
    got = cg.grouped_sums(g, ls, nseg)
    again = cg.grouped_sums(g, ls, nseg)
    want = cg.grouped_sums_plain(g, ls, nseg)
    torch.cuda.synchronize()
    # one launch a call, whatever the number of lanes
    assert cg.LAUNCHES == before + 2
    for i, (a, b, w) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), i
        if i in counts:
            assert torch.equal(a, w), i
        else:
            torch.testing.assert_close(a, w, rtol=SUM_REL, atol=0)



_BIG, _SMALL = 2 ** 63 - 1, -(2 ** 63)
# ROADMAP C1's table with the reference's values: out-of-range doubles,
# NaN and infinities cast to integers and decimals saturate (NaN gives 0)
SATURATING_SQL = [
    ("SELECT CAST(x AS BIGINT) FROM (VALUES 1e19, -1e19) t(x)",
     [[_BIG], [_SMALL]]),
    ("SELECT CAST(x / y AS BIGINT) FROM (VALUES (0e0, 0e0), (1e0, 0e0), "
     "(-1e0, 0e0)) t(x, y)", [[0], [_BIG], [_SMALL]]),
    ("SELECT CAST(1.0E20 AS DECIMAL(18,0))", [[_BIG]]),
    ("SELECT CAST(1.0E300 AS DECIMAL(38,0)), CAST(-1.0E300 AS "
     "DECIMAL(38,0))", [[_BIG * 2 ** 64, -_BIG * 2 ** 64]]),
    ("SELECT CAST(x AS INTEGER) FROM (VALUES 1e19) t(x)", [[-1]]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(SATURATING_SQL)))
def test_out_of_range_double_casts_saturate_on_card(cuda, i):
    sql, want = SATURATING_SQL[i]
    assert LocalQueryRunner(device=cuda).execute(sql).rows == want
    assert LocalQueryRunner(device="cpu").execute(sql).rows == want

@pytest.mark.gpu
def test_kernel_rejects_bad_input(cuda):
    gid = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        cg.grouped_sums(gid, [torch.ones(64, dtype=torch.float64,
                                         device=cuda)], 4)
    gid = torch.zeros(64, dtype=torch.int32, device=cuda)
    flat = torch.ones(130, dtype=torch.float64, device=cuda)
    for vals in (flat[1:129].view(2, 64),             # not 16-byte aligned
                 flat[:130].view(2, 65)[:, :64],      # odd row stride
                 flat[:124].view(2, 62),              # rows too short
                 flat[:128].view(2, 64).float()):     # float32
        with pytest.raises(ValueError):
            cg.grouped_sums(gid, vals, 4)


def _q1_buffer(rng, cap, k=19, nseg=12):
    gid = rng.integers(0, nseg + 2, cap).astype(np.int32)
    buf = np.full((k, cap + cap % 2), np.nan)
    buf[:, :cap] = np.round(rng.uniform(900, 105000, (k, cap)), 2)
    buf[k - 1, :cap] = 1.0
    return torch.from_numpy(gid), torch.from_numpy(buf)


@pytest.mark.gpu
def test_back_to_back_and_graph_replay_bit_identical(cuda):
    """Calls of several caps (one block; one group of blocks; 17 groups of
    blocks, so both ticket levels) run back to back on one stream, inside
    a captured CUDA graph, and with that graph replayed on a second
    stream beside direct calls: each result is bit-identical to the same
    call run alone. Each agrees with the plain version (counts exact)."""
    rng = np.random.default_rng(9)
    caps = [32, 2048, 2049, 5000, 17 * 1024, 1 << 17, (1 << 18) + 3,
            1 << 20]
    inputs = []
    for cap in caps:
        g, b = _q1_buffer(rng, cap)
        inputs.append((g.to(cuda), b.to(cuda)))
    alone = []
    for g, b in inputs:
        alone.append(cg.grouped_sums(g, b, 12).clone())
        torch.cuda.synchronize()
        want = cg.grouped_sums_plain(g, b, 12)
        assert torch.equal(alone[-1][-1], want[-1])
        torch.testing.assert_close(alone[-1], want, rtol=SUM_REL, atol=0)
    before = cg.LAUNCHES
    again = [cg.grouped_sums(g, b, 12) for g, b in inputs]
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + len(caps)
    for a, b in zip(again, alone):
        assert torch.equal(a, b)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = [cg.grouped_sums(g, b, 12) for g, b in inputs]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, alone):
            assert torch.equal(a, b)
    # the graph replayed on another stream while direct calls run on the
    # stream it was captured on: each call zeroes tickets of its own
    other = torch.cuda.Stream()
    for _ in range(4):
        other.wait_stream(torch.cuda.current_stream())
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(other):
            graph.replay()
        with torch.cuda.stream(stream):
            direct = [cg.grouped_sums(g, b, 12) for g, b in inputs]
        torch.cuda.synchronize()
        for a, c, b in zip(captured, direct, alone):
            assert torch.equal(a, b)
            assert torch.equal(c, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 32, 2048, 2049, 4096, 1 << 17, 1 << 18,
                                 1 << 20, 1 << 26, 3 << 24])
def test_partition_covers_rows_in_block_multiples(cuda, cap):
    """The source's layout at each cap: one block (the result alone)
    while the rows fit its 1024-row tile, else the result, at most 264
    blocks' partials, their groups' sums and the tickets; and the launch
    counts every live row once."""
    rows = cg.scratch_rows(cap, 19, 12)
    assert (rows == 19) == (cap <= 1024)
    assert 19 <= rows <= (1 + 264 + 17) * 19 + 1
    gid = torch.arange(cap, dtype=torch.int32, device=cuda) % 14
    buf = torch.ones((2, cap + cap % 2), dtype=torch.float64, device=cuda)
    buf[1, :cap] = (torch.arange(cap, device=cuda) % 7).to(torch.float64)
    before = cg.LAUNCHES
    got = cg.grouped_sums(gid, buf, 12)
    want = cg.grouped_sums_plain(gid, buf, 12)
    assert cg.LAUNCHES == before + 1
    assert tuple(got.shape) == (2, 12)
    assert torch.equal(got, want)
    assert int(got[0].sum()) == int((gid < 12).sum())


@pytest.mark.gpu
def test_q1_on_card_matches_cpu(cuda):
    q1 = TPCH_QUERIES[1]
    before = cg.LAUNCHES
    got = LocalQueryRunner(device=cuda).execute(q1).rows
    # lineitem is one split at tiny: the streaming aggregation reads it
    # whole from the scan cache, aggregates it (one launch) and combines
    # the partial (one more)
    assert cg.LAUNCHES == before + 2
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


# ---- streamed operators and the scan cache on the card --------------------

class _LoopExecutor:
    """The counters run_streamed keeps, on a device."""

    def __init__(self, device):
        from trino_tpu_torch.session import Session
        self.device = device
        self.session = Session(catalog="tpch", schema="tiny")
        self.stream_chunks = self.stream_h2d_bytes = 0
        self.stream_overlapped = 0
        self.stream_copy_ms = self.stream_wait_ms = 0.0
        self.stream_ops = {}
        self.stream_s = 0.0


def _host_chunks(sizes, seed):
    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.types import DOUBLE
    rng = np.random.default_rng(seed)
    return [Batch({"v": Column(DOUBLE, torch.from_numpy(
        rng.uniform(-1e3, 1e3, n)).pin_memory())}, n) for n in sizes]


@pytest.mark.gpu
def test_copy_stream_loop_equals_a_synchronous_loop(cuda):
    """run_streamed's chunks (pinned sources, the copy stream, an event
    per chunk) give what a loop of plain synchronous copies gives, bit
    for bit: each chunk padded with zeros to its capacity bucket, and
    the compute over it (elementwise: a float64 cumsum on the card is
    not the same from one launch to the next)."""
    from trino_tpu_torch.config import capacity_for
    from trino_tpu_torch.exec import streamjoin as sj
    sizes = [1 << 20, 3, 1000, (1 << 18) + 5, 8]
    chunks = _host_chunks(sizes, 11)
    ex = _LoopExecutor(cuda)

    def dispatch(lane):
        return lane.clone(), lane * lane + lane

    got = []
    sj.run_streamed(ex, "agg", iter(chunks),
                    lambda chunk, i: dispatch(chunk.column("v").data),
                    lambda out, i: got.append(out))
    torch.cuda.synchronize()
    assert ex.stream_chunks == len(sizes)
    assert 0 <= ex.stream_overlapped <= len(sizes) - 1
    assert ex.stream_copy_ms > 0
    assert ex.stream_h2d_bytes == 8 * sum(sizes)
    for n, c, (lane, square) in zip(sizes, chunks, got):
        plain = torch.zeros(capacity_for(n, minimum=8), dtype=torch.float64,
                            device=cuda)
        plain[:n] = c.column("v").data.to(cuda)
        want_lane, want_square = dispatch(plain)
        assert torch.equal(lane, want_lane)
        assert not lane[n:].any()
        assert torch.equal(square, want_square)


@pytest.mark.gpu
def test_pinned_chunk_is_held_until_its_copy_completes(cuda):
    """The copier keeps each pinned source until its copy's event has
    completed: however much pinned memory is allocated and overwritten
    meanwhile, the device chunk holds the source's values."""
    from trino_tpu_torch.exec import streamjoin as sj
    n = 1 << 24
    (chunk,) = _host_chunks([n], 12)
    want = chunk.column("v").data.clone()
    copier = sj.ChunkCopier(cuda)
    assert copier.stream != torch.cuda.current_stream(cuda)
    pending = copier.h2d(chunk)
    del chunk
    assert len(copier.in_flight) == 1
    junk = [torch.full((n,), -1.0, dtype=torch.float64, pin_memory=True)
            for _ in range(3)]
    dev, _ = copier.ready(pending)
    torch.cuda.synchronize()
    assert torch.equal(dev.column("v").data[:n].cpu(), want)
    copier.release()
    assert copier.in_flight == []
    del junk


@pytest.mark.gpu
def test_overlap_is_measured_from_events(cuda):
    """stream_overlapped counts the copies that had completed when the
    compute stream arrived at their chunk, from the loop's events: when
    each chunk keeps the compute stream busy for longer than a copy,
    every copy after the first is hidden and the compute stream waits
    for the first alone; with no compute to hide behind, it waits for
    every copy."""
    from trino_tpu_torch.exec import streamjoin as sj
    (chunk,) = _host_chunks([1 << 26], 13)
    chunks = [chunk] * 4            # 512 MB a copy

    def busy(c, i):
        torch.cuda._sleep(100_000_000)  # 10^8 cycles: tens of ms

    def idle(c, i):
        return None

    for dispatch, hidden in ((busy, len(chunks) - 1), (idle, 0)):
        # a first loop fills the allocator's cache, so that no device
        # allocation stalls the host in the loop measured
        for _ in range(2):
            ex = _LoopExecutor(cuda)
            sj.run_streamed(ex, "agg", iter(chunks), dispatch,
                            lambda out, i: None)
        assert ex.stream_overlapped == hidden
        assert ex.stream_copy_ms > 0
        if hidden:
            assert ex.stream_wait_ms < ex.stream_copy_ms / 2
        else:
            assert ex.stream_wait_ms > ex.stream_copy_ms / len(chunks)


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=SUM_REL)
            else:
                assert a == b


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_rows", [4096, 1 << 20])
@pytest.mark.parametrize("q", [1, 3, 6, 18])
def test_streamed_queries_on_card_match_cpu(cuda, q, chunk_rows):
    """Every streamed operator forced on the card (chunk loop, copy
    stream, streamed join, chunked aggregation) against the CPU."""
    from trino_tpu_torch.session import Session

    def run(device):
        s = Session(catalog="tpch", schema="tiny")
        s.set("stream_chunk_rows", chunk_rows)
        return LocalQueryRunner(s, device=device).execute(TPCH_QUERIES[q])
    got = run(cuda)
    assert got.stream_chunks > 0 and got.stream_overlapped >= 0
    _rows_close(got.rows, run("cpu").rows)


@pytest.mark.gpu
def test_whole_table_scan_cache_on_card(cuda):
    """On a card the scan cache holds a table whole: the second run is a
    table hit with the same rows."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec import scancache
    runner = LocalQueryRunner(device=cuda)
    # lineitem in 15 splits at tiny, so that the table entry is a
    # concatenation (a one-split table is served by its split entry)
    runner.catalogs.register("tpch", TpchConnector(4096, device=cuda))
    sql = TPCH_QUERIES[6]
    first = runner.execute(sql).rows
    hits = scancache.STATS["table_hit"]
    assert runner.execute(sql).rows == first
    assert scancache.STATS["table_hit"] > hits
    _rows_close(first, LocalQueryRunner(device="cpu").execute(sql).rows)


# ---- the aggregates with scalar results and the HyperLogLog sketches ------

AGG_SQL = [
    # the statistical family, checksum and bitwise: the packed GROUP BY
    # (grouped_sums), the general path and the global path
    "SELECT l_returnflag, l_linestatus, count(*), "
    "corr(l_extendedprice, l_quantity), covar_samp(l_extendedprice, "
    "l_quantity), covar_pop(l_extendedprice, l_quantity), "
    "regr_slope(l_extendedprice, l_quantity), regr_intercept("
    "l_extendedprice, l_quantity), skewness(l_extendedprice), "
    "kurtosis(l_quantity), checksum(l_orderkey), "
    "bitwise_and_agg(l_orderkey), bitwise_or_agg(l_suppkey) "
    "FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2",
    "SELECT l_suppkey % 7, corr(l_tax, l_discount), skewness(l_tax), "
    "checksum(l_comment), bitwise_and_agg(l_partkey + 4096), "
    "bitwise_or_agg(l_orderkey) FROM lineitem GROUP BY 1 ORDER BY 1",
    "SELECT kurtosis(l_extendedprice), checksum(l_shipdate), "
    "bitwise_or_agg(l_partkey), regr_intercept(l_tax, l_discount) "
    "FROM lineitem WHERE l_quantity > 10",
    # the order kinds: general and global, ties, NULL comparators
    "SELECT l_returnflag, l_linestatus, min_by(l_orderkey, l_extendedprice), "
    "max_by(l_partkey, l_quantity), approx_percentile(l_extendedprice, "
    "0.5), approx_percentile(l_quantity, 0.9) FROM lineitem "
    "GROUP BY 1, 2 ORDER BY 1, 2",
    "SELECT min_by(l_orderkey, l_discount), max_by(l_comment, l_tax), "
    "approx_percentile(l_discount, 0.25) FROM lineitem "
    "WHERE l_shipdate >= DATE '1995-01-01'",
    "SELECT g, min_by(a, b), max_by(a, b) FROM (VALUES (1, 10, 5), "
    "(2, 11, NULL), (1, 12, 3), (2, 13, 8), (1, 14, 3), (2, 15, 8)) "
    "t(g, a, b) GROUP BY g ORDER BY g",
    # the sketches: grouped, global, merge, casts, FILTER
    "SELECT l_returnflag, cardinality(approx_set(l_partkey)), "
    "cardinality(approx_set(l_suppkey, 0.01)), "
    "cardinality(approx_set(l_comment) FILTER (WHERE l_tax > 0.03)) "
    "FROM lineitem GROUP BY 1 ORDER BY 1",
    "SELECT cardinality(merge(s)) FROM (SELECT l_returnflag, "
    "approx_set(l_partkey) s FROM lineitem GROUP BY 1) t",
    "SELECT cardinality(approx_set(l_partkey)), "
    "cardinality(approx_set(l_extendedprice)) FROM lineitem",
    "SELECT l_returnflag, CAST(approx_set(l_partkey) AS varbinary), "
    "cardinality(CAST(CAST(approx_set(l_suppkey) AS varbinary) AS "
    "hyperloglog)) FROM lineitem GROUP BY 1 ORDER BY 1",
    "SELECT TRY_CAST('garbage' AS hyperloglog) IS NULL, "
    "cardinality(empty_approx_set())",
]


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(AGG_SQL)))
def test_aggregate_kinds_on_card_match_cpu(cuda, i):
    """Each new kind at tpch.tiny: the card's rows against the port's
    CPU rows; the sketch and statistical rows of a warm run equal the
    cold run's bit for bit."""
    card = LocalQueryRunner(device=cuda)
    cold = card.execute(AGG_SQL[i]).rows
    _rows_match(cold, LocalQueryRunner(device="cpu").execute(
        AGG_SQL[i]).rows)
    assert card.execute(AGG_SQL[i]).rows == cold


@pytest.mark.gpu
def test_spilled_sketch_column_returns_to_the_card(cuda, monkeypatch):
    """A sketch column of a join output spilled to pinned host memory
    and brought back to the card gives the unspilled rows."""
    from trino_tpu_torch.config import CONFIG
    from trino_tpu_torch.exec import executor as ex_mod
    sql = ("SELECT o_orderpriority, sum(cardinality(s)), "
           "cardinality(merge(s)) FROM (SELECT l_orderkey k, "
           "approx_set(l_partkey) s FROM lineitem GROUP BY 1) t "
           "JOIN orders ON k = o_orderkey GROUP BY 1 ORDER BY 1")
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
    for b in chunks:
        for col in b.columns.values():
            if col.elements is not None:
                assert col.elements.data.device.type == "cpu"
                assert col.elements.data.is_pinned()
    assert spilled.rows == whole.rows
    assert whole.rows == LocalQueryRunner(device="cpu").execute(sql).rows
