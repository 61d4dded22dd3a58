"""Hashing and the sort + binary-search join of the PyTorch engine
(trino_tpu_torch/ops/hashing.py, ops/join.py) against the JAX engine's
(trino_tpu/ops/hashing.py, ops/join.py) on the CPU.

The same seeded python values build a batch in each package. Hashes must
be bit-identical (compared as uint64), match runs, permutations and
semi-join verdicts equal, and expanded join rows equal row for row.
"""

import math
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu import batch_from_pylist as tpu_batch
from trino_tpu.columnar import Batch as TpuBatch
from trino_tpu.ops import hashing as tpu_hash, join as tpu_join
from trino_tpu_torch.columnar import Batch, batch_from_pylist
from trino_tpu_torch.config import capacity_for
from trino_tpu_torch.ops import hashing, join
from trino_tpu_torch.types import parse_type as port_type
from trino_tpu.types import parse_type as tpu_type


def _u64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint64)
    return np.asarray(x).astype(np.uint64)


def test_mix64_and_combine_bit_identical():
    rng = np.random.default_rng(1)
    a = rng.integers(-2**63, 2**63 - 1, 4096, dtype=np.int64)
    b = rng.integers(-5, 5, 4096, dtype=np.int64)
    got = hashing.mix64(torch.from_numpy(a))
    want = tpu_hash.mix64(jnp.asarray(a))
    assert np.array_equal(_u64(got), _u64(want))
    got = hashing.combine_hashes([hashing.mix64(torch.from_numpy(a)),
                                  torch.from_numpy(b)])
    want = tpu_hash.combine_hashes([tpu_hash.mix64(jnp.asarray(a)),
                                    jnp.asarray(b).astype(jnp.uint64)])
    assert np.array_equal(_u64(got), _u64(want))


def test_float_lanes_and_hash_column_bit_identical():
    # no subnormals here: XLA on the CPU treats them as zero (the JAX
    # engine's equality lane of 1e-310 is that of 0.0), while torch keeps
    # them exact, as IEEE equality does; test_subnormal_keys_stay_distinct
    d = np.array([0.0, -0.0, 1.5, -1.5, np.nan, -np.nan, np.inf, -np.inf,
                  2.2250738585072014e-308, 3.0e300, 0.1, 0.1 + 2**-56],
                 np.float64)
    valid = np.ones(len(d), bool)
    valid[3] = False
    for g, w in zip(hashing.float_equality_lanes(torch.from_numpy(d)),
                    tpu_hash.float_equality_lanes(jnp.asarray(d))):
        assert np.array_equal(g.numpy(), np.asarray(w))
    got = hashing.hash_column(torch.from_numpy(d), torch.from_numpy(valid))
    want = tpu_hash.hash_column(jnp.asarray(d), jnp.asarray(valid))
    assert np.array_equal(_u64(got), _u64(want))
    assert _u64(got)[0] == _u64(got)[1]       # -0.0 == 0.0
    assert _u64(got)[4] == _u64(got)[5]       # NaN == NaN


def test_subnormal_keys_stay_distinct():
    d = torch.tensor([0.0, 1e-310, 2.5e-310, 1e-310], dtype=torch.float64)
    h = _u64(hashing.hash_column(d, None))
    assert len({h[0], h[1], h[2]}) == 3 and h[1] == h[3]


def _keys(kind, rng, n, domain):
    if kind == "int":
        v = [int(x) for x in rng.integers(-domain, domain, n)]
    elif kind == "float":
        pool = [0.0, -0.0, math.nan, 1.25, -7.5, 1e300, -3e-300]
        v = [pool[int(i)] for i in rng.integers(0, len(pool), n)]
    else:
        words = ["ash", "birch", "cedar", "elm", "fir", "oak", "yew"]
        v = [words[int(i)] for i in rng.integers(0, len(words), n)]
    for i in range(0, n, 11):
        v[i] = None                        # NULL keys never match
    return v


_TYPES = {"int": "bigint", "float": "double", "str": "varchar"}


def _pair(data, types, dead):
    """The same rows as a JAX batch and a port batch; the last ``dead``
    rows are past num_rows."""
    n = len(next(iter(data.values())))
    tb = tpu_batch(data, {k: tpu_type(t) for k, t in types.items()})
    pb = batch_from_pylist(data, {k: port_type(t) for k, t in types.items()},
                           device="cpu")
    return (TpuBatch(tb.columns, n - dead), Batch(pb.columns, n - dead))


CASES = {
    # name: (key kinds, probe rows, build rows, dead build rows)
    "int": (["int"], 300, 120, 5),
    "float": (["float"], 200, 90, 3),
    "string": (["str"], 250, 60, 2),
    "two_columns": (["int", "str"], 400, 150, 4),
    "empty_build": (["int"], 100, 8, 8),
}


def _sides(name):
    kinds, n_probe, n_build, dead = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    pdata, bdata, ptypes, btypes = {}, {}, {}, {}
    for i, kind in enumerate(kinds):
        pdata[f"p{i}"] = _keys(kind, rng, n_probe, 40)
        bdata[f"b{i}"] = _keys(kind, rng, n_build, 40)
        ptypes[f"p{i}"] = btypes[f"b{i}"] = _TYPES[kind]
    pdata["pv"] = list(range(n_probe))
    bdata["bv"] = [float(x) for x in rng.uniform(-1, 1, n_build)]
    ptypes["pv"], btypes["bv"] = "bigint", "double"
    pkeys = [k for k in pdata if k != "pv"]
    bkeys = [k for k in bdata if k != "bv"]
    return (_pair(pdata, ptypes, 0), _pair(bdata, btypes, dead), pkeys,
            bkeys)


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and math.isnan(b):
                assert math.isnan(a)
            else:
                assert a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_match_counts_equal(name):
    (tp, pp), (tb, pb), pkeys, bkeys = _sides(name)
    want = tpu_join.match_counts(tp, tb, pkeys, bkeys)
    got = join.match_counts(pp, pb, pkeys, bkeys)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if name != "empty_build":
        assert int(got[1].sum()) > 0


@pytest.mark.parametrize("join_type", ["inner", "left"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_expand_join_rows_equal(name, join_type):
    (tp, pp), (tb, pb), pkeys, bkeys = _sides(name)
    start, count, order = join.match_counts(pp, pb, pkeys, bkeys)
    ts, tc, to = tpu_join.match_counts(tp, tb, pkeys, bkeys)
    eff = (torch.where(pp.row_valid(), count.clamp(min=1), 0)
           if join_type == "left" else count)
    cap = capacity_for(int(eff.sum()))
    got = join.expand_join(pp, pb, start, count, order, cap, join_type)
    want = tpu_join.expand_join(tp, tb, ts, tc, to, cap, join_type)
    assert got.num_rows_host() == want.num_rows_host()
    _rows_equal(got.to_pylist(), want.to_pylist())


@pytest.mark.parametrize("name", sorted(CASES))
def test_semi_join_mask_equal(name):
    (tp, pp), (tb, pb), pkeys, bkeys = _sides(name)
    got = join.semi_join_mask(pp, pb, pkeys, bkeys)
    want = tpu_join.semi_join_mask(tp, tb, pkeys, bkeys)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) == (name != "empty_build")   # build has NULLs


def test_cross_counts_equal():
    (tp, pp), (tb, pb), _, _ = _sides("int")
    for g, w in zip(join.cross_counts(pp, pb),
                    tpu_join.cross_counts(tp, tb)):
        assert np.array_equal(g.numpy(), np.asarray(w))
