"""grouped_sums in the PyTorch engine (trino_tpu_torch/ops/cuda_groupby.py)
against the JAX engine's Pallas kernel run in interpret mode.

Inputs are made with numpy from a seed and handed to both packages as
numpy. Counts (0/1 lanes) must agree exactly; sums within rel 1e-9 (both
sides sum in f64, only the order of summation differs). The kernel
itself needs a card: tests/test_torch_gpu.py holds it against the plain
version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops.pallas_groupby import G_PAD, grouped_sums as tpu_sums
from trino_tpu_torch.ops import cuda_groupby as cg

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


def test_cpu_tensors_take_the_plain_version():
    before = cg.LAUNCHES
    cg.grouped_sums(torch.zeros(64, dtype=torch.int32),
                    [torch.ones(64, dtype=torch.float64)], 3)
    assert cg.LAUNCHES == before


@pytest.mark.parametrize("bad", ["gid_int64", "lane_f32", "lane_strided",
                                 "nseg_65"])
def test_kernel_input_checks(bad):
    gid = torch.zeros(64, dtype=torch.int32)
    lane = torch.ones(64, dtype=torch.float64)
    nseg = 4
    if bad == "gid_int64":
        gid = gid.to(torch.int64)
    elif bad == "lane_f32":
        lane = lane.to(torch.float32)
    elif bad == "lane_strided":
        lane = torch.ones(128, dtype=torch.float64)[::2]
    else:
        nseg = 65
    with pytest.raises(ValueError):
        cg._check(gid, [lane], nseg)


@pytest.mark.parametrize("cap", [8, 4096, 1 << 20, 1 << 26, 3 << 24])
def test_partition_covers_rows_in_block_multiples(cap):
    chunk, nchunks = cg.partition(cap)
    assert chunk % 256 == 0
    assert (nchunks - 1) * chunk < cap <= nchunks * chunk
    assert 1 <= nchunks <= 65535
