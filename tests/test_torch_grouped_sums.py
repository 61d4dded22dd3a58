"""grouped_sums in the PyTorch engine (trino_tpu_torch/ops/cuda_groupby.py)
against the JAX engine's Pallas kernel run in interpret mode.

Inputs are made with numpy from a seed and handed to both packages as
numpy. Counts (0/1 lanes) must agree exactly; sums within rel 1e-9 (both
sides sum in f64, only the order of summation differs). The lanes go in
as a list and as the kernel's [K, ld] buffer; the packed GROUP BY of
TPC-H q1 goes through ``_kernel_packed_aggs`` against the JAX engine's
``group_aggregate``. The kernel itself needs a card:
tests/test_torch_gpu.py holds it against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu import types as tpu_types
from trino_tpu.columnar import batch_from_pylist as tpu_batch
from trino_tpu.ops import groupby as tpu_groupby
from trino_tpu.ops.pallas_groupby import G_PAD, grouped_sums as tpu_sums
from trino_tpu_torch import types as port_types
from trino_tpu_torch.columnar import batch_from_pylist as port_batch
from trino_tpu_torch.ops import cuda_groupby as cg
from trino_tpu_torch.ops import groupby as port_groupby

SUM_REL = 1e-9


def _both(gid, lanes, nseg):
    want = tpu_sums(jnp.asarray(gid), [jnp.asarray(x) for x in lanes],
                    nseg, interpret=True)
    got = cg.grouped_sums(torch.from_numpy(gid),
                          [torch.from_numpy(x) for x in lanes], nseg)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_close(got, want, exact):
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_REL, atol=0)


def _money_case(rng):
    cap, n, nseg = 8192, 7000, 11
    gid = rng.integers(0, nseg, cap).astype(np.int32)
    gid[n:] = G_PAD
    live = np.arange(cap) < n
    money = np.round(rng.uniform(900, 105000, cap), 2)
    signed = rng.normal(scale=1e9, size=cap)
    lanes = [np.where(live, money, 0.0), np.where(live, signed, 0.0),
             live.astype(np.float64)]
    return gid, lanes, nseg, [False, False, True]


def _dead_case(rng):
    gid = np.full(512, G_PAD, np.int32)
    return gid, [rng.uniform(0, 1, 512), np.ones(512)], 4, [False, True]


def _excluded_ids_case(rng):
    # ids at and past G_PAD, and ids in [nseg, G_PAD), reach no output
    cap, nseg = 4096, 6
    gid = rng.integers(0, 300, cap).astype(np.int32)
    vals = np.round(rng.uniform(-50, 50, cap), 2)
    return gid, [vals, np.ones(cap)], nseg, [False, True]


def _wide_domain_case(rng):
    cap, nseg = 8192, 64
    gid = rng.integers(0, nseg, cap).astype(np.int32)
    qty = rng.integers(1, 51, cap).astype(np.float64)
    return gid, [qty, np.ones(cap)], nseg, [False, True]


def _filter_counts_case(rng):
    # count(*) FILTER (WHERE ...): a per-lane 0/1 mask on top of live
    cap, nseg = 8192, 6
    gid = rng.integers(0, nseg, cap).astype(np.int32)
    live = rng.uniform(size=cap) < 0.8
    gid = np.where(live, gid, G_PAD).astype(np.int32)
    filt = live & (rng.integers(1, 51, cap) > 25)
    price = np.round(rng.uniform(900, 105000, cap), 2)
    return gid, [live.astype(np.float64), filt.astype(np.float64),
                 np.where(filt, price, 0.0)], nseg, [True, True, False]


CASES = {"money": _money_case, "all_dead": _dead_case,
         "excluded_ids": _excluded_ids_case, "nseg_64": _wide_domain_case,
         "filter_counts": _filter_counts_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_matches_pallas_interpret(case):
    gid, lanes, nseg, exact = CASES[case](np.random.default_rng(7))
    want, got = _both(gid, lanes, nseg)
    assert len(got) == len(lanes)
    for g, w, ex in zip(got, want, exact):
        _assert_close(g, w, ex)


def test_plain_path_matches_numpy_bincount():
    rng = np.random.default_rng(3)
    gid = rng.integers(-3, 20, 5000).astype(np.int32)
    lane = rng.normal(size=5000)
    out = cg.grouped_sums(torch.from_numpy(gid), [torch.from_numpy(lane)],
                          16)[0].numpy()
    keep = (gid >= 0) & (gid < 16)
    want = np.bincount(gid[keep], weights=lane[keep], minlength=16)
    np.testing.assert_allclose(out, want, rtol=SUM_REL, atol=1e-12)


@pytest.mark.parametrize("cap", [8, 32, 1023, 1024, 1025, 2048, 2049, 4096,
                                 1 << 17, (1 << 17) + 3])
def test_plain_path_covers_every_row(cap):
    """Every row with an id in [0, nseg) counts once, at caps on either
    side of the kernel's one-block tile, from the buffer as from a list."""
    rng = np.random.default_rng(cap)
    gid = rng.integers(-2, 15, cap).astype(np.int32)
    lanes = [np.ones(cap), np.round(rng.uniform(900, 105000, cap), 2)]
    keep = (gid >= 0) & (gid < 12)
    g = torch.from_numpy(gid)
    for got in (cg.grouped_sums(g, _padded(lanes, cap), 12),
                cg.grouped_sums(g, [torch.from_numpy(x) for x in lanes], 12)):
        assert tuple(got.shape) == (2, 12)
        np.testing.assert_array_equal(
            got[0].numpy(), np.bincount(gid[keep], minlength=12))
        np.testing.assert_allclose(
            got[1].numpy(), np.bincount(gid[keep], weights=lanes[1][keep],
                                        minlength=12), rtol=SUM_REL, atol=0)


def test_cpu_tensors_take_the_plain_version():
    before = cg.LAUNCHES
    cg.grouped_sums(torch.zeros(64, dtype=torch.int32),
                    [torch.ones(64, dtype=torch.float64)], 3)
    assert cg.LAUNCHES == before


def _padded(lanes, cap):
    """The lanes as the kernel's [K, ld] buffer, the pad column NaN (the
    kernel must never sum it)."""
    buf = np.full((len(lanes), cap + cap % 2), np.nan)
    buf[:, :cap] = np.stack(lanes)
    return torch.from_numpy(buf)


@pytest.mark.parametrize("case", sorted(CASES))
def test_buffer_equals_list(case):
    gid, lanes, nseg, _ = CASES[case](np.random.default_rng(11))
    g = torch.from_numpy(gid)
    listed = cg.grouped_sums(g, [torch.from_numpy(x) for x in lanes], nseg)
    buffered = cg.grouped_sums(g, _padded(lanes, len(gid)), nseg)
    assert listed.shape == buffered.shape == (len(lanes), nseg)
    assert torch.equal(listed, buffered)


def _odd_cap_case(rng):
    cap, nseg = 4097, 12
    gid = rng.integers(0, nseg + 2, cap).astype(np.int32)
    money = np.round(rng.uniform(900, 105000, cap), 2)
    return gid, [money, np.ones(cap)], nseg, [False, True]


def _lanes_80_case(rng):
    cap, nseg = 2048, 12
    gid = rng.integers(0, 13, cap).astype(np.int32)
    money = np.round(rng.uniform(900, 105000, cap), 2)
    lanes = [money * (k + 1) for k in range(40)] + [np.ones(cap)] * 40
    return gid, lanes, nseg, [False] * 40 + [True] * 40


def _bincounts(gid, lanes, nseg):
    keep = (gid >= 0) & (gid < nseg)
    return [np.bincount(gid[keep], weights=x[keep], minlength=nseg)
            for x in lanes]


@pytest.mark.parametrize("case", ["odd_cap", "lanes_80"])
def test_buffer_matches_pallas_interpret(case):
    """80 lanes against the Pallas kernel; an odd cap (whose pad column
    holds NaN) against numpy, since the Pallas kernel takes whole blocks
    of 512 rows."""
    make = {"odd_cap": _odd_cap_case, "lanes_80": _lanes_80_case}[case]
    gid, lanes, nseg, exact = make(np.random.default_rng(5))
    if case == "odd_cap":
        want = _bincounts(gid, lanes, nseg)
    else:
        want = tpu_sums(jnp.asarray(gid), [jnp.asarray(x) for x in lanes],
                        nseg, interpret=True)
    vals = _padded(lanes, len(gid))
    cg._check(torch.from_numpy(gid), vals, nseg)
    got = cg.grouped_sums(torch.from_numpy(gid), vals, nseg)
    assert got.shape == (len(lanes), nseg)
    for g, w, ex in zip(got, want, exact):
        _assert_close(g.numpy(), np.asarray(w), ex)


def _q1_columns(rng, n, case):
    """q1's lineitem columns as python lists: flags, statuses, the four
    money lanes and a shipdate; ``nulls`` puts NULLs in keys and values."""
    flags = list(rng.choice(["A", "N", "R"], n))
    stats = list(rng.choice(["F", "O"], n))
    qty = rng.integers(1, 51, n).astype(float).tolist()
    price = np.round(rng.uniform(901, 104950, n), 2).tolist()
    disc = (rng.integers(0, 11, n) / 100.0).tolist()
    tax = (rng.integers(0, 9, n) / 100.0).tolist()
    ship = rng.integers(8000, 10600, n).tolist()
    if case == "nulls":
        for i in range(0, n, 7):
            price[i] = None
        for i in range(3, n, 11):
            flags[i] = None
    return {"l_returnflag": flags, "l_linestatus": stats, "l_quantity": qty,
            "l_extendedprice": price, "l_discount": disc, "l_tax": tax,
            "l_shipdate": ship}


Q1_SCHEMA = {"l_returnflag": "varchar", "l_linestatus": "varchar",
             "l_quantity": "double", "l_extendedprice": "double",
             "l_discount": "double", "l_tax": "double", "l_shipdate": "bigint"}
# q1's aggregates after planning: 4 sums, 3 more sums for the averages,
# their counts, count(*)
Q1_AGGS = [("sum", "l_quantity", "sum_qty"),
           ("sum", "l_extendedprice", "sum_base_price"),
           ("sum", "l_discount", "sum_disc"), ("sum", "l_tax", "sum_tax"),
           ("count", "l_quantity", "cnt_qty"),
           ("count", "l_extendedprice", "cnt_price"),
           ("count", "l_discount", "cnt_disc"),
           ("count_star", None, "count_order")]


@pytest.mark.parametrize("case,n", [("dense", 1000), ("dense", 4097),
                                    ("nulls", 3001), ("all_filtered", 600)])
def test_q1_packed_group_by_matches_pallas_interpret(case, n, monkeypatch):
    """The packed GROUP BY of TPC-H q1 (two dictionary keys, 12 packed
    groups, 19 lanes) through ``_kernel_packed_aggs``, which writes the
    kernel's [K, ld] buffer, against the JAX engine's ``group_aggregate``
    with its Pallas kernel in interpret mode."""
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    cols = _q1_columns(np.random.default_rng(n), n, case)
    cutoff = -1 if case == "all_filtered" else 10400
    live = np.asarray(cols["l_shipdate"]) <= cutoff
    seen = []
    real = cg.grouped_sums

    def spy(gid, lanes, nseg):
        seen.append((tuple(lanes.shape), lanes.stride(0) % 2, nseg))
        return real(gid, lanes, nseg)
    monkeypatch.setattr(cg, "grouped_sums", spy)
    port = port_batch(cols, {k: port_types.parse_type(t)
                             for k, t in Q1_SCHEMA.items()}, device="cpu")
    tpu = tpu_batch(cols, {k: tpu_types.parse_type(t)
                           for k, t in Q1_SCHEMA.items()})
    cap = port.capacity
    pad = np.zeros(cap, bool)
    pad[:n] = live
    keys = ["l_returnflag", "l_linestatus"]
    got = port_groupby.group_aggregate(
        port, keys, [port_groupby.AggInput(k, i, output=o) for k, i, o in Q1_AGGS],
        live=torch.from_numpy(pad))
    want = tpu_groupby.group_aggregate(
        tpu, keys, [tpu_groupby.AggInput(k, i, output=o) for k, i, o in Q1_AGGS],
        live=jnp.asarray(pad))
    # 1 live + count(*) + 4 sums x (value, mask) + 3 counts
    assert seen == [((13, cap + cap % 2), 0, 12)]
    rows, ref = got.to_pylist(), want.to_pylist()
    assert len(rows) == len(ref)
    assert (not rows) == (case == "all_filtered")
    for g, w in zip(rows, ref):
        assert g[:2] == w[:2] and g[-4:] == w[-4:]
        for a, b in zip(g[2:-4], w[2:-4]):
            assert (a is None and b is None) or \
                a == pytest.approx(b, rel=SUM_REL)


@pytest.mark.parametrize("bad", ["gid_int64", "lane_f32", "lane_strided",
                                 "nseg_65", "odd_row_stride", "rows_short",
                                 "misaligned", "odd_cap_unpadded"])
def test_kernel_input_checks(bad):
    gid = torch.zeros(64, dtype=torch.int32)
    vals = torch.ones((2, 64), dtype=torch.float64)
    nseg = 4
    if bad == "gid_int64":
        gid = gid.to(torch.int64)
    elif bad == "lane_f32":
        vals = vals.to(torch.float32)
    elif bad == "lane_strided":
        vals = torch.ones((2, 128), dtype=torch.float64)[:, ::2]
    elif bad == "nseg_65":
        nseg = 65
    elif bad == "odd_row_stride":
        vals = torch.ones((2, 65), dtype=torch.float64)[:, :64]
    elif bad == "rows_short":
        vals = torch.ones((2, 62), dtype=torch.float64)
    elif bad == "misaligned":
        vals = torch.ones(130, dtype=torch.float64)[1:129].view(2, 64)
    else:
        gid = torch.zeros(63, dtype=torch.int32)
        vals = torch.ones((2, 63), dtype=torch.float64)
    cg._check(torch.zeros(64, dtype=torch.int32),
              torch.ones((2, 64), dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        cg._check(gid, vals, nseg)
