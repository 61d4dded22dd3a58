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


# ---- the statement layer -----------------------------------------------------

DML_SCRIPT = [
    "CREATE TABLE memory.default.acct AS SELECT * FROM (VALUES "
    "(1, 'alice', 100.0), (2, 'bob', 250.0), (3, 'carol', 0.0), "
    "(4, 'dan', 75.0)) t(id, name, balance)",
    "CREATE TABLE memory.default.delta AS SELECT * FROM (VALUES "
    "(2, 40.0), (3, -1.0), (9, 500.0)) t(id, amount)",
    "INSERT INTO memory.default.acct VALUES (5, 'erin', 12.5)",
    "UPDATE memory.default.acct SET balance = balance + 10 "
    "WHERE balance < 100",
    "DELETE FROM memory.default.acct WHERE id = 1",
    "MERGE INTO memory.default.acct a USING memory.default.delta d "
    "ON a.id = d.id WHEN MATCHED AND d.amount < 0 THEN DELETE "
    "WHEN MATCHED THEN UPDATE SET balance = balance + d.amount "
    "WHEN NOT MATCHED THEN INSERT (id, name, balance) "
    "VALUES (d.id, 'new', d.amount)",
    "SELECT * FROM memory.default.acct ORDER BY id",
    "START TRANSACTION",
    "DELETE FROM memory.default.acct WHERE balance > 100",
    "INSERT INTO memory.default.acct VALUES (7, 'gus', 1.0)",
    "SELECT * FROM memory.default.acct ORDER BY id",
    "ROLLBACK",
    "SELECT * FROM memory.default.acct ORDER BY id",
    "CREATE TABLE memory.default.li AS SELECT l_orderkey, l_returnflag, "
    "l_quantity, l_shipdate FROM lineitem",
    "DELETE FROM memory.default.li WHERE l_returnflag = 'R'",
    "SELECT l_returnflag, count(*), sum(l_quantity), max(l_shipdate) "
    "FROM memory.default.li GROUP BY 1 ORDER BY 1",
]


def _outcomes(runner):
    out = []
    for sql in DML_SCRIPT:
        r = runner.execute(sql)
        out.append((r.update_type, r.update_count, r.rows))
    return out


@pytest.mark.gpu
def test_writes_on_card_match_cpu_and_stay_on_card(cuda):
    """CTAS, INSERT, UPDATE, DELETE, MERGE and a rolled-back transaction
    on the card give the CPU's counts and rows, and every stored lane is
    on the card."""
    card = LocalQueryRunner(device=cuda)
    assert _outcomes(card) == _outcomes(LocalQueryRunner(device="cpu"))
    conn = card.catalogs.connector("memory")
    for table in ("acct", "delta", "li"):
        for chunk in conn.stored_chunks("default", table):
            for col in chunk.columns.values():
                for t in (col.data, col.valid, col.data2):
                    assert t is None or t.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [
    "SELECT n_name FROM nation ORDER BY n_name DESC LIMIT 3 OFFSET 2",
    "SELECT DISTINCT l_orderkey FROM lineitem ORDER BY 1 DESC "
    "LIMIT 5 OFFSET 10",
    "SELECT o_orderkey FROM orders ORDER BY o_totalprice, o_orderkey "
    "OFFSET 14995",
])
def test_offset_on_card_matches_cpu(cuda, sql):
    assert LocalQueryRunner(device=cuda).execute(sql).rows \
        == LocalQueryRunner(device="cpu").execute(sql).rows


def _mix64_np(x):
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


@pytest.mark.gpu
@pytest.mark.parametrize("pct", [10, 50])
def test_tablesample_count_on_card_is_numpys(cuda, pct):
    """The sample keeps row i of the scan when (mix64(i) >>> 11) / 2^53
    is below the ratio: the count at tpch.tiny equals numpy's."""
    card = LocalQueryRunner(device=cuda)
    n = card.execute("SELECT count(*) FROM lineitem").rows[0][0]
    u = (_mix64_np(np.arange(n)) >> np.uint64(11)).astype(np.float64) \
        / float(1 << 53)
    got = card.execute("SELECT count(*) FROM lineitem "
                       f"TABLESAMPLE BERNOULLI ({pct})").rows
    assert got == [[int((u < pct / 100).sum())]]


# ---- the scalar functions and the time lanes on the card --------------------

@pytest.mark.gpu
@pytest.mark.parametrize("zone", ["America/Los_Angeles", "Europe/London",
                                  "Australia/Lord_Howe", "Asia/Kolkata"])
def test_zone_offsets_on_card_match_zoneinfo(cuda, zone):
    """The transition table and searchsorted on the card against zoneinfo
    per instant: random instants of 1900-2100 and both sides of every
    transition of 1990-2030, as instants and as wall-clock times."""
    import datetime
    from zoneinfo import ZoneInfo
    from trino_tpu_torch.ops import timezone as tz
    rng = np.random.default_rng(13)
    ms = rng.integers(-2_208_988_800_000, 4_102_444_800_000, 4000)
    starts, _ = tz.transitions(zone, 7305, 21915)
    ms = np.concatenate([ms, starts[1:] - 1, starts[1:], starts[1:] + 1,
                         starts[1:] + 1_800_000, starts[1:] - 1_800_000])
    lane = torch.from_numpy(ms).to(cuda)
    got = tz.offsets_at(zone, lane).cpu().numpy()
    got_local = tz.offsets_for_local(zone, lane).cpu().numpy()
    zi = ZoneInfo(zone)
    utc = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    naive = datetime.datetime(1970, 1, 1)

    def off(t):
        return int(t.utcoffset().total_seconds()) // 60
    assert got.tolist() == [
        off((utc + datetime.timedelta(milliseconds=int(v))).astimezone(zi))
        for v in ms]
    assert got_local.tolist() == [
        off((naive + datetime.timedelta(milliseconds=int(v)))
            .replace(tzinfo=zi)) for v in ms]


@pytest.mark.gpu
def test_logical_right_shift_on_card(cuda):
    """bitwise_right_shift on the card is >>> over negative values and
    every shift count, as Python's arithmetic on the u64 pattern; bit_count
    counts the low bits of a negative value's two's complement."""
    from trino_tpu_torch.exec.scalars import logical_shr, popcount64
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 4096,
                                     dtype=np.int64),
                        np.asarray([-1, -(1 << 63), (1 << 63) - 1, 0, -16],
                                   np.int64)])
    s = rng.integers(0, 64, x.shape[0])
    got = logical_shr(torch.from_numpy(x).to(cuda),
                      torch.from_numpy(s).to(cuda)).cpu().numpy()
    want = [((int(v) & ((1 << 64) - 1)) >> int(k)) for v, k in zip(x, s)]
    want = [w - (1 << 64) if w >= (1 << 63) else w for w in want]
    assert got.tolist() == want
    pc = popcount64(torch.from_numpy(x).to(cuda)).cpu().numpy()
    assert pc.tolist() == [bin(int(v) & ((1 << 64) - 1)).count("1")
                           for v in x]
    rows = LocalQueryRunner().execute(
        "SELECT bitwise_right_shift(x, 2), bitwise_right_shift(x, 63), "
        "bit_count(x, 8), bit_count(x, 64) FROM (VALUES CAST(-16 AS BIGINT),"
        " CAST(-1 AS BIGINT), CAST(37 AS BIGINT)) t(x)").rows
    assert rows == [[(1 << 62) - 4, 1, 4, 60], [(1 << 62) - 1, 1, 8, 64],
                    [9, 0, 3, 3]]


@pytest.mark.gpu
def test_width_bucket_edges_on_card(cuda):
    """width_bucket on the card at its edges (the bounds, just inside and
    outside them, reversed bounds, NULL) equals numpy's IEEE division: no
    reciprocal multiply."""
    edges = [900.0, 105000.0, 904.0, 6506.25 + 900.0, 104999.99,
             105000.01, 899.99, -1.0, 1e300, 52950.0]
    sql = ("SELECT x, width_bucket(x, 900, 105000, 16), width_bucket(x, "
           "105000, 900, 16), width_bucket(x, 0.5e0, 7.3e0, 7) FROM (VALUES "
           + ", ".join(f"{v!r}e0" if "e" not in repr(v) else repr(v)
                       for v in edges) + ", NULL) t(x) ORDER BY 1")
    got = LocalQueryRunner().execute(sql).rows
    assert got == LocalQueryRunner(device="cpu").execute(sql).rows

    def wb(x, lo, hi, n):
        if hi >= lo:
            b = np.floor((np.float64(x) - lo) / ((np.float64(hi) - lo) / n))
        else:
            b = np.floor((np.float64(lo) - x) / ((np.float64(lo) - hi) / n))
        return int(min(max(b + 1, 0), n + 1))
    for row in got[:-1]:
        x = row[0]
        assert row[1:] == [wb(x, 900, 105000, 16), wb(x, 105000, 900, 16),
                           wb(x, 0.5, 7.3, 7)], row
    assert got[-1] == [None, None, None, None]


@pytest.mark.gpu
def test_scalar_functions_on_card_match_cpu(cuda):
    """The lineitem query of chip_smoke.py's scalar_sf10 phase and the
    time lanes at tpch.sf1: the card's rows equal the CPU's."""
    import chip_smoke as cs
    from trino_tpu_torch.session import Session
    sqls = [cs.SCALAR_LINEITEM_SQL.format(schema="sf1"),
            cs.SCALAR_ORDERS_SQL.format(schema="sf1"),
            "SELECT date_format(o_orderdate, '%Y-%m-%d %W'), "
            "to_iso8601(CAST(o_orderdate AS TIMESTAMP) AT TIME ZONE "
            "'Europe/Berlin'), md5(o_comment), count(*) FROM orders "
            "WHERE o_orderkey < 20000 GROUP BY 1, 2, 3 ORDER BY 1, 2, 3"]
    for sql in sqls:
        card = LocalQueryRunner(Session(catalog="tpch", schema="sf1"))
        cpu = LocalQueryRunner(Session(catalog="tpch", schema="sf1"),
                               device="cpu")
        got, want = card.execute(sql).rows, cpu.execute(sql).rows
        assert cs.scalar_rows_errors(got, want) == []


NESTED_ON_CARD_SQL = [
    # UNNEST WITH ORDINALITY over a lineitem array, grouped through
    # grouped_sums
    "SELECT l_returnflag, l_linestatus, count(*), sum(p), "
    "sum(CASE WHEN k = 2 THEN p END), max(k) FROM lineitem "
    "CROSS JOIN UNNEST(ARRAY[l_extendedprice, "
    "l_extendedprice * (1 - l_discount)]) WITH ORDINALITY AS t(p, k) "
    "GROUP BY 1, 2 ORDER BY 1, 2",
    # array_agg per order, through a join, then reduce and other lambdas
    "SELECT o_orderpriority, count(*), sum(cardinality(items)), "
    "sum(reduce(items, 0e0, (s, x) -> s + x, s -> s)), "
    "count_if(any_match(items, x -> x > 100000e0)), "
    "sum(element_at(array_sort(items), -1)) FROM orders JOIN "
    "(SELECT l_orderkey AS k, array_agg(l_extendedprice) AS items "
    "FROM lineitem GROUP BY l_orderkey) li ON o_orderkey = k "
    "GROUP BY o_orderpriority ORDER BY 1",
    # map_filter over a MAP of three entries a row
    "SELECT sum(cardinality(map_filter(MAP(ARRAY['q', 'p', 'd'], "
    "ARRAY[l_quantity, l_extendedprice, l_discount]), (k, v) -> v > 10e0))) "
    "FROM lineitem",
    # array_agg with a FILTER, histogram and map_agg, grouped
    "SELECT o_orderstatus, array_agg(o_orderkey) FILTER "
    "(WHERE o_orderkey < 200), histogram(o_orderpriority), "
    "map_agg(o_orderpriority, o_orderkey) FROM orders GROUP BY 1 ORDER BY 1",
    # array_join, each distinct array joined once on the host
    "SELECT o_orderstatus, count(DISTINCT array_join(ARRAY[o_orderpriority, "
    "o_clerk], '/')), min(array_join(ARRAY[o_shippriority, o_custkey % 7, "
    "NULL], '-', 'x')) FROM orders GROUP BY 1 ORDER BY 1",
    # digests built per group in threads, then merged
    "SELECT o_orderstatus, value_at_quantile(merge(d), 0.5e0) FROM (SELECT "
    "o_orderstatus, o_orderpriority, tdigest_agg(o_totalprice) d FROM orders "
    "GROUP BY 1, 2) GROUP BY 1 ORDER BY 1",
]


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(NESTED_ON_CARD_SQL)))
def test_nested_columns_on_card_match_cpu(cuda, i):
    """UNNEST, array_agg, reduce, map_filter, array_join and a digest's
    merge at tpch.sf1 on the card: the rows equal the engine's on the CPU
    (doubles within rel 1e-9)."""
    import chip_smoke as cs
    from trino_tpu_torch.session import Session
    sql = NESTED_ON_CARD_SQL[i]
    got = LocalQueryRunner(Session(catalog="tpch", schema="sf1")) \
        .execute(sql).rows
    want = LocalQueryRunner(Session(catalog="tpch", schema="sf1"),
                            device="cpu").execute(sql).rows
    assert len(got) == len(want) > 0
    assert cs.nested_match(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_file_round_trip_from_card_lanes(cuda, tmp_path, fmt):
    """Card lanes to a file and back to card lanes: the same rows, the
    same bytes as the file written from the CPU engine's lanes, and every
    lane read back on the card."""
    from trino_tpu_torch.connectors.localfile import LocalFileConnector
    from trino_tpu_torch.formats.orc import read_orc
    from trino_tpu_torch.formats.parquet import read_parquet
    sql = ("CREATE TABLE files.default.li AS SELECT l_orderkey, "
           "l_quantity, l_returnflag, l_linestatus, l_shipdate, l_comment "
           "FROM tpch.tiny.lineitem")
    paths = []
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        root.mkdir()
        conn = LocalFileConnector(str(root), dev)
        conn.write_format = fmt
        r = LocalQueryRunner(device=dev)
        r.catalogs.register("files", conn)
        r.execute(sql)
        paths.append(root / f"li.{fmt}")
    assert paths[0].read_bytes() == paths[1].read_bytes()
    read = read_parquet if fmt == "parquet" else read_orc
    card = read(str(paths[0]), device="cuda")
    for col in card.columns.values():
        assert col.data.device.type == "cuda"
    assert card.to_pylist() == read(str(paths[0]), device="cpu").to_pylist()
    q = ("SELECT l_returnflag, count(*), sum(l_quantity), max(l_comment) "
         "FROM files.default.li GROUP BY 1 ORDER BY 1")
    rows = []
    for dev in ("cuda", "cpu"):
        conn = LocalFileConnector(str(tmp_path / dev), dev)
        r = LocalQueryRunner(device=dev)
        r.catalogs.register("files", conn)
        rows.append(r.execute(q).rows)
    assert rows[0] == rows[1]


_GEO_POLYS = [
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4))",
    "POLYGON ((0 0, 10 5, 4 12, -3 6, 0 0), (1 5, 3 5, 2 7, 1 5))",
    "POLYGON ((25 2, 30 18, 48 20, 34 30, 40 48, 25 37, 10 48, 16 30, "
    "2 20, 20 18, 25 2))"]


@pytest.mark.gpu
def test_geometry_on_card_matches_cpu(cuda):
    """ST_Contains on the card gives the CPU run's booleans exactly,
    points on edges and vertices included; the distances agree within
    rel 1e-9."""
    from trino_tpu_torch.testing import TestingConnector
    from trino_tpu_torch.types import BIGINT, DOUBLE
    rng = np.random.default_rng(9)
    n = 20_000
    xs = rng.uniform(-5, 50, n)
    ys = rng.uniform(-5, 50, n)
    t = rng.integers(0, 6, n // 2).astype(np.float64)
    xs[: n // 4], ys[: n // 4] = 2 * t[: n // 4], t[: n // 4]
    xs[n // 4: n // 2] = rng.integers(0, 11, n // 4)
    ys[n // 4: n // 2] = np.where(t[n // 4:] > 2, 10.0, 4.0)
    rows = [{"id": i, "x": float(x), "y": float(y)}
            for i, (x, y) in enumerate(zip(xs, ys))]
    case = " ".join(f"WHEN {k} THEN '{p}'" for k, p in enumerate(_GEO_POLYS))
    sql = ("SELECT id, ST_Contains(ST_GeometryFromText(CASE id % 3 "
           f"{case} END), ST_Point(x, y)), ST_Distance(ST_Point(x, y), "
           "ST_Point(3.5, 2.25)), great_circle_distance(y, x, 40.64, "
           "-73.78), ST_AsText(ST_Point(x, y)) FROM g.default.pts "
           "ORDER BY id")
    got = []
    for dev in ("cuda", "cpu"):
        conn = TestingConnector(device=dev)
        conn.add_table("pts", {"id": BIGINT, "x": DOUBLE, "y": DOUBLE},
                       rows)
        r = LocalQueryRunner(device=dev)
        r.catalogs.register("g", conn)
        got.append(r.execute(sql).rows)
    card, cpu = got
    assert [r[1] for r in card] == [r[1] for r in cpu]
    assert [r[4] for r in card] == [r[4] for r in cpu]
    for a, b in zip(card, cpu):
        assert a[2] == pytest.approx(b[2], rel=SUM_REL)
        assert a[3] == pytest.approx(b[3], rel=SUM_REL)


@pytest.mark.gpu
def test_plan_validation_on_card_q1(cuda):
    """q1 with the sanity checker after every optimizer pass: the rows
    of the run without it."""
    from trino_tpu_torch.obs.metrics import PLAN_VALIDATIONS
    r = LocalQueryRunner()
    want = r.execute(TPCH_QUERIES[1]).rows
    before = PLAN_VALIDATIONS.value()
    r.session.set("plan_validation", True)
    assert r.execute(TPCH_QUERIES[1]).rows == want
    assert PLAN_VALIDATIONS.value() > before


# ---- the coordinator on the card (concurrent queries, first use) ----------

SERVER_QUERIES = (1, 6, 3, 12)


@pytest.mark.gpu
def test_concurrent_coordinator_queries_equal_solo_runs(cuda, tmp_path):
    """Four threads send q1, q6, q3 and q12 at tpch.tiny to one
    Coordinator() at once: their rows equal solo runs, and
    grouped_sums.LAUNCHES rises by the sum of the solo runs' launches
    (each query runs on a thread of its own)."""
    import threading
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.server import Coordinator
    co = Coordinator(history_dir=str(tmp_path)).start()
    try:
        assert co.device.type == "cuda"

        def run(q):
            return StatementClient(co.base_uri).execute(
                TPCH_QUERIES[q]).rows

        for q in SERVER_QUERIES:                 # cold: build, cache
            run(q)
        solo, launches = {}, {}
        for q in SERVER_QUERIES:
            before = cg.LAUNCHES
            solo[q] = run(q)
            launches[q] = cg.LAUNCHES - before
        assert launches[1] > 0
        got, errors = {}, []
        barrier = threading.Barrier(len(SERVER_QUERIES))

        def worker(q):
            try:
                barrier.wait()
                got[q] = run(q)
            except Exception as e:               # noqa: BLE001
                errors.append(e)
        before = cg.LAUNCHES
        threads = [threading.Thread(target=worker, args=(q,))
                   for q in SERVER_QUERIES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errors
        assert got == solo
        assert cg.LAUNCHES - before == sum(launches.values())
    finally:
        co.stop()


@pytest.mark.gpu
def test_launch_count_holds_under_threads(cuda):
    """LAUNCHES moves under a lock: eight threads launching at once lose
    no count."""
    import threading
    g = torch.arange(1 << 12, device=cuda, dtype=torch.int32) % 12
    lanes = [torch.ones(1 << 12, device=cuda, dtype=torch.float64)]
    cg.grouped_sums(g, lanes, 12)
    before = cg.LAUNCHES

    def worker():
        for _ in range(200):
            cg.grouped_sums(g, lanes, 12)
    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    torch.cuda.synchronize()
    assert cg.LAUNCHES - before == 8 * 200


@pytest.mark.gpu
def test_cold_first_use_from_four_threads_builds_once(cuda, tmp_path,
                                                      monkeypatch):
    """Four threads reaching the first launch together: one nvcc build
    into a fresh directory, no temporary file left, every result right
    (ROADMAP C2)."""
    import threading
    monkeypatch.setattr(cg, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cg, "_launch", None)
    monkeypatch.setattr(cg, "_scratch_rows", None)
    cg.scratch_rows.cache_clear()
    builds = cg.BUILDS
    rng = np.random.default_rng(11)
    gid = torch.from_numpy(rng.integers(0, 12, 1 << 15)
                           .astype(np.int32)).to(cuda)
    vals = [torch.from_numpy(rng.uniform(0, 100, 1 << 15)).to(cuda)]
    want = cg.grouped_sums_plain(gid, vals, 12)
    barrier = threading.Barrier(4)
    got, errors = [], []

    def worker():
        try:
            barrier.wait()
            got.append(cg.grouped_sums(gid, vals, 12))
        except Exception as e:                  # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    cg.scratch_rows.cache_clear()
    assert not errors
    assert cg.BUILDS == builds + 1
    assert cg.BUILD_INFO["compiled"]
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
    for out in got:
        torch.testing.assert_close(out, want, rtol=SUM_REL, atol=0)


# ---- the worker slice: builds across processes, workers, frames ------------

_BUILD_RACE = """
import pathlib, sys, time
import torch
from trino_tpu_torch import serde
from trino_tpu_torch.columnar import batch_from_pylist
from trino_tpu_torch.ops import cuda_groupby as cg, native
from trino_tpu_torch.types import BIGINT
d = pathlib.Path(sys.argv[1])
cg.BUILD_DIR = d
native.BUILD_DIR = d
go = float(sys.argv[2])
while time.time() < go:
    time.sleep(0.001)
g = torch.arange(1 << 12, device="cuda", dtype=torch.int32) % 12
lanes = [torch.ones(1 << 12, device="cuda", dtype=torch.float64)]
out = cg.grouped_sums(g, lanes, 12)
want = cg.grouped_sums_plain(g.cpu(), [x.cpu() for x in lanes], 12)
torch.testing.assert_close(out.cpu(), want, rtol=0, atol=0)
b = batch_from_pylist({"k": list(range(100))}, {"k": BIGINT},
                      device="cuda")
back = serde.deserialize_batch(serde.serialize_batch(b), "cuda")
assert back.to_pylist() == b.to_pylist()
print(cg.LAUNCHES, cg.BUILDS)
"""


@pytest.mark.gpu
def test_builds_race_across_processes(cuda, tmp_path):
    """Two processes cold-build grouped_sums (nvcc) and the page codec
    (c++) into one fresh build directory at the same moment: one library
    of each, no temporary file left, and both processes launch the
    kernel and frame a batch."""
    import pathlib
    import subprocess
    import sys
    import time
    root = pathlib.Path(__file__).resolve().parent.parent
    go = time.time() + 8.0        # both interpreters up and importing
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RACE,
                               str(tmp_path), str(go)], cwd=str(root),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        launches, builds = map(int, out.split())
        assert launches >= 1 and builds == 1
    names = sorted(p.name for p in tmp_path.iterdir())
    assert [n.split("-")[0] for n in names] == ["libgrouped_sums",
                                                "libpageserde"], names
    assert all(n.endswith(".so") for n in names), names


@pytest.mark.gpu
def test_two_workers_run_q1_on_the_card(cuda):
    """q1 through two TaskWorkerServer(device="cuda") behind the stage
    DAG equals q1 on the CPU, and the workers' tasks launch
    grouped_sums."""
    from trino_tpu_torch.exec.remote import DistributedHostQueryRunner
    from trino_tpu_torch.server.task_worker import TaskWorkerServer
    workers = [TaskWorkerServer().start() for _ in range(2)]
    try:
        assert all(w.device.type == "cuda" for w in workers)
        dist = DistributedHostQueryRunner([w.base_uri for w in workers])
        assert dist.device.type == "cuda"
        before = cg.LAUNCHES
        got = dist.execute(TPCH_QUERIES[1]).rows
        assert cg.LAUNCHES > before
        want = LocalQueryRunner(device="cpu").execute(TPCH_QUERIES[1]).rows
        _rows_match(got, want)
    finally:
        for w in workers:
            w.stop()


@pytest.mark.gpu
def test_frames_round_trip_lanes_on_the_card(cuda):
    """A result Batch on the card (strings, dates, doubles, a long
    decimal, NULLs) framed and read back onto the card and onto the CPU:
    the same rows, the lanes on the device asked for."""
    from trino_tpu_torch import serde
    r = LocalQueryRunner()
    b = r.execute_batch(
        "SELECT o_orderkey, o_orderpriority, o_orderdate, o_totalprice, "
        "CAST(o_totalprice AS DECIMAL(30, 2)) AS big, "
        "nullif(o_custkey % 7, 0) AS maybe FROM orders "
        "WHERE o_orderkey < 2000")
    assert b.device.type == "cuda"
    frame = serde.serialize_batch(b)
    on_card = serde.deserialize_batch(frame, "cuda")
    on_cpu = serde.deserialize_batch(frame, "cpu")
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    assert on_card.to_pylist() == on_cpu.to_pylist() == b.to_pylist()


@pytest.mark.gpu
def test_stream_scan_batch_is_on_the_card(cuda, tmp_path):
    """A stream topic's split decodes into lanes on the card (the ledger
    lanes too), and a grouped scan of it equals the same scan on the
    CPU."""
    import json
    from trino_tpu_torch.catalog import Split, TableHandle
    from trino_tpu_torch.connectors.stream import StreamConnector
    conn = StreamConnector(str(tmp_path / "stream"))
    assert conn.device.type == "cuda"
    conn.log.create_topic("t", fields=[("k", "varchar", None),
                                       ("v", "double", None)],
                          partitions=1)
    conn.log.append("t", [json.dumps({"k": "ab"[i % 2], "v": i / 4}).encode()
                          for i in range(1000)], partition=0)
    batch = conn.read_split(Split(TableHandle("stream", "default", "t"),
                                  0, 1), ["k", "v", "_partition", "_offset"])
    assert batch.device.type == "cuda"
    assert all(c.data.is_cuda for c in batch.columns.values())
    assert batch.column("k").dictionary is not None
    sql = ("SELECT k, count(*), sum(v), max(_offset) FROM "
           "stream.default.t GROUP BY k ORDER BY k")
    from trino_tpu_torch.catalog import CatalogManager
    runs = []
    for device in ("cuda", "cpu"):
        cats = CatalogManager()
        cats.register("stream", StreamConnector(str(tmp_path / "stream"),
                                                device=device))
        runs.append(LocalQueryRunner(device=device,
                                     catalogs=cats).execute(sql).rows)
    _rows_match(runs[0], runs[1])
    assert runs[1] == [["a", 500, sum(i / 4 for i in range(0, 1000, 2)),
                        998],
                       ["b", 500, sum(i / 4 for i in range(1, 1000, 2)),
                        999]]


@pytest.mark.gpu
def test_window_job_recompute_launches_grouped_sums(cuda, tmp_path):
    """A window job's recompute over its staging table (dictionary-coded
    keys) goes through the packed GROUP BY and launches grouped_sums on
    the card; its view equals the rollup computed on the CPU."""
    import json
    import threading
    import time
    from trino_tpu_torch.catalog import CatalogManager
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.stream import StreamConnector
    from trino_tpu_torch.fte.spool import make_spool
    from trino_tpu_torch.streaming.continuous import ContinuousQueryManager
    from trino_tpu_torch.streaming.offsets import OffsetStore
    stream = StreamConnector(str(tmp_path / "stream"))
    cats = CatalogManager()
    cats.register("stream", stream)
    cats.register("memory", MemoryConnector())
    r = LocalQueryRunner(catalogs=cats)
    r.execute("CREATE TABLE stream.default.ev (f VARCHAR, s VARCHAR, "
              "v DOUBLE, ts BIGINT)")
    lock = threading.Lock()

    def run_sql(sql):
        with lock:
            return r.execute(sql)
    mgr = ContinuousQueryManager(
        run_sql, cats, OffsetStore(make_spool(
            "local", local_base_dir=str(tmp_path / "spool"))),
        log=stream.log)
    assert mgr.device.type == "cuda"
    docs = [json.dumps({"f": "ANR"[i % 3], "s": "FO"[i % 2],
                        "v": i * 0.25, "ts": i}).encode()
            for i in range(4000)]
    stream.log.append("ev", docs)
    before = cg.LAUNCHES
    job = mgr.create({
        "kind": "window", "topic": "ev", "target": "memory.default.roll",
        "ts_column": "ts", "lateness_ms": 0, "poll_interval_ms": 50,
        "sql": "SELECT f, s, count(*) AS c, sum(v) AS sv FROM "
               "stream.default.ev WHERE ts <= {watermark} GROUP BY f, s"})
    def rolled():
        try:
            return run_sql("SELECT f, s, c, sv FROM memory.default.roll "
                           "ORDER BY f, s").rows
        except Exception:           # noqa: BLE001 — not created yet
            return []
    try:
        deadline = time.monotonic() + 120
        while sum(row[2] for row in rolled()) < 4000:
            assert time.monotonic() < deadline, mgr.get(job["job_id"])
            time.sleep(0.05)
        got = rolled()
        assert mgr.get(job["job_id"])["watermark"] == 3999.0
    finally:
        mgr.stop()
    assert cg.LAUNCHES > before
    want = {}
    for i in range(4000):
        key = ("ANR"[i % 3], "FO"[i % 2])
        c, sv = want.get(key, (0, 0.0))
        want[key] = (c + 1, sv + i * 0.25)
    _rows_match(got, [[f, s, c, sv] for (f, s), (c, sv)
                      in sorted(want.items())])


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 3])
def test_two_shard_mesh_on_one_card_matches_one_device(cuda, q):
    """A mesh of 2 shards on the one card (exec/distributed.py, the
    stage DAG on the mesh) answers as the single-device runner."""
    sql = TPCH_QUERIES[q]
    mesh = LocalQueryRunner(device=cuda, distributed=True, n_devices=2)
    assert mesh.mesh.size == 2 and all(
        d.type == "cuda" for d in mesh.mesh.devices)
    got = mesh.execute(sql).rows
    want = LocalQueryRunner(device=cuda).execute(sql).rows
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=SUM_REL)
            else:
                assert a == b


@pytest.mark.gpu
def test_warmed_worker_first_query_builds_nothing(cuda, tmp_path):
    """A fresh process warms q1's recorded shapes (exec/aot.py); its
    first q1 then builds and loads no library: the warm-up did."""
    import json
    import pathlib
    import subprocess
    import sys
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    shapes = tmp_path / "shapes.json"
    record = (
        "import json, sys\n"
        "from trino_tpu_torch.runner import LocalQueryRunner\n"
        "from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES\n"
        "from trino_tpu_torch.exec.hotshapes import HOT_SHAPES\n"
        "LocalQueryRunner().execute(TPCH_QUERIES[1])\n"
        "json.dump(HOT_SHAPES.top(16), open(sys.argv[1], 'w'))\n")
    warm = (
        "import json, sys\n"
        "from trino_tpu_torch.runner import LocalQueryRunner\n"
        "from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES\n"
        "from trino_tpu_torch.exec import aot\n"
        "from trino_tpu_torch.ops import cuda_groupby as cg, native\n"
        "out = aot.compile_entries(json.load(open(sys.argv[1])), 'cuda')\n"
        "assert out['errors'] == 0 and out['compiled'] > 0, out\n"
        "before = (cg.BUILDS, sorted(native._LIBS))\n"
        "launches = cg.LAUNCHES\n"
        "LocalQueryRunner().execute(TPCH_QUERIES[1])\n"
        "print(json.dumps([before == (cg.BUILDS, sorted(native._LIBS)),\n"
        "                  cg.BUILDS, cg.LAUNCHES - launches]))\n")
    for code in (record, warm):
        out = subprocess.run([sys.executable, "-c", code, str(shapes)],
                             capture_output=True, text=True, cwd=root,
                             timeout=600)
        assert out.returncode == 0, out.stderr
    same, builds, launches = json.loads(out.stdout.strip().splitlines()[-1])
    assert same and builds == 1 and launches > 0
