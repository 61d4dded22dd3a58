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
