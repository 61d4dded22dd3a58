"""The general (lexsort + segment) GROUP BY path of the PyTorch engine
(trino_tpu_torch/ops/groupby.py) against the JAX engine's
(trino_tpu/ops/groupby.py) on the CPU.

The same seeded python values build a batch in each package; both group
by keys without a small static domain, so both take the general path.
Groups must come out in the same order (the lexsort order over u64 key
lanes), keys, counts, integers and strings exactly equal, doubles within
rel 1e-9.
"""

import math
import zlib

import numpy as np
import pytest

from trino_tpu import batch_from_pylist as tpu_batch
from trino_tpu.columnar import Batch as TpuBatch
from trino_tpu.ops.groupby import (AggInput as TpuAgg,
                                   group_aggregate as tpu_group)
from trino_tpu.types import parse_type as tpu_type
from trino_tpu_torch.columnar import Batch, batch_from_pylist
from trino_tpu_torch.ops.groupby import AggInput, group_aggregate
from trino_tpu_torch.types import parse_type as port_type

REL = 1e-9
N = 600

AGGS = [("count_star", None, None), ("count", "v", None),
        ("sum", "v", None), ("sum", "i", None), ("sum", "v", "m"),
        ("min", "v", None), ("max", "v", None), ("min", "i", "m"),
        ("max", "i", None), ("min", "s", None), ("max", "s", None),
        ("min", "b", None), ("max", "b", None), ("any_value", "s", None),
        ("any_value", "v", "m"), ("count_star", None, "m")]


def _values(rng):
    v = [float(x) for x in np.round(rng.uniform(-1e4, 1e4, N), 2)]
    i = [int(x) for x in rng.integers(-1000, 1000, N)]
    words = [f"w{k:03d}" for k in range(90)]
    s = [words[int(k)] for k in rng.integers(0, len(words), N)]
    b = [bool(x) for x in rng.integers(0, 2, N)]
    m = [bool(x) for x in rng.integers(0, 3, N) > 0]
    for col in (v, i, s, b):
        for k in rng.choice(N, N // 9, replace=False):
            col[int(k)] = None
    return {"v": v, "i": i, "s": s, "b": b, "m": m}


def _keys(kind, rng):
    if kind == "int":
        out = [int(x) for x in rng.integers(-30, 30, N)]
    elif kind == "float":
        pool = [0.0, -0.0, math.nan, 2.5, -2.5, 1e300, 7.25]
        out = [pool[int(k)] for k in rng.integers(0, len(pool), N)]
    elif kind == "bool":
        out = [bool(x) for x in rng.integers(0, 2, N)]
    else:
        out = [f"k{int(x)}" for x in rng.integers(0, 70, N)]
    for k in range(0, N, 13):
        out[k] = None
    return out


_TYPES = {"int": "bigint", "float": "double", "bool": "boolean",
          "str": "varchar", "v": "double", "i": "bigint", "s": "varchar",
          "b": "boolean", "m": "boolean"}

CASES = {
    "int": ["int"],
    "float": ["float"],
    "string_over_the_packed_domain": ["str"],
    "string_and_int": ["str", "int"],
    "bool_and_float": ["bool", "float"],
}


def _inputs(name, dead):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    data = _values(rng)
    types = {c: _TYPES[c] for c in data}
    keys = []
    for j, kind in enumerate(CASES[name]):
        data[f"k{j}"] = _keys(kind, rng)
        types[f"k{j}"] = _TYPES[kind]
        keys.append(f"k{j}")
    tb = tpu_batch(data, {k: tpu_type(t) for k, t in types.items()})
    pb = batch_from_pylist(data, {k: port_type(t) for k, t in types.items()},
                           device="cpu")
    return TpuBatch(tb.columns, N - dead), Batch(pb.columns, N - dead), keys


def _same(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and math.isnan(b):
                assert math.isnan(a)
            elif isinstance(b, float):
                assert a == pytest.approx(b, rel=REL, abs=1e-9)
            else:
                assert a == b


@pytest.mark.parametrize("dead", [0, 37])
@pytest.mark.parametrize("name", sorted(CASES))
def test_general_path_matches_jax(name, dead):
    tb, pb, keys = _inputs(name, dead)
    want = tpu_group(tb, keys, [TpuAgg(k, c, m, f"a{j}")
                                for j, (k, c, m) in enumerate(AGGS)])
    got = group_aggregate(pb, keys, [AggInput(k, c, m, f"a{j}")
                                     for j, (k, c, m) in enumerate(AGGS)])
    assert got.names == want.names
    _same(got.to_pylist(), want.to_pylist())


def test_live_mask_overrides_prefix():
    tb, pb, keys = _inputs("int", 0)
    live = np.arange(tb.capacity) % 3 != 0
    live[N:] = False
    import jax.numpy as jnp
    import torch
    want = tpu_group(tb, keys, [TpuAgg("sum", "v", None, "s")],
                     live=jnp.asarray(live))
    got = group_aggregate(pb, keys, [AggInput("sum", "v", None, "s")],
                          live=torch.from_numpy(live))
    _same(got.to_pylist(), want.to_pylist())


def test_unported_kind_raises():
    """array_agg, once unported here, now equals the JAX engine's per
    group (the arrays in the group-sorted row order), with and without a
    FILTER mask; a kind neither engine has still raises."""
    tb, pb, keys = _inputs("int", 0)
    for mask in (None, "m"):
        want = tpu_group(tb, keys, [TpuAgg("array_agg", "i", mask, "x")])
        got = group_aggregate(pb, keys, [AggInput("array_agg", "i", mask,
                                                  "x")])
        assert got.to_pylist() == want.to_pylist()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        group_aggregate(pb, keys, [AggInput("no_such_kind", "i", None,
                                            "x")])


DISTINCT_AGGS = [("count_distinct", "v", None), ("count_distinct", "i", "m"),
                 ("count_distinct", "s", None), ("count_distinct", "b", None),
                 ("count_distinct", "f", None), ("count_distinct", "f", "m"),
                 ("count", "f", None)]


def _distinct_inputs(name, dead):
    """The inputs of ``_inputs`` plus ``f``, a double with many repeats,
    -0.0 beside 0.0, NaNs and NULLs (count(DISTINCT) counts -0.0 and 0.0
    as one value, and all NaNs as one)."""
    rng = np.random.default_rng(zlib.crc32(("distinct" + name).encode()))
    data = _values(rng)
    data["f"] = _keys("float", rng)
    data["v"] = [None if x is None else round(x / 500.0) * 0.5
                 for x in data["v"]]
    types = {c: _TYPES.get(c, "double") for c in data}
    keys = []
    for j, kind in enumerate(CASES[name]):
        data[f"k{j}"] = _keys(kind, rng)
        types[f"k{j}"] = _TYPES[kind]
        keys.append(f"k{j}")
    tb = tpu_batch(data, {k: tpu_type(t) for k, t in types.items()})
    pb = batch_from_pylist(data, {k: port_type(t) for k, t in types.items()},
                           device="cpu")
    return TpuBatch(tb.columns, N - dead), Batch(pb.columns, N - dead), keys


@pytest.mark.parametrize("dead", [0, 37])
@pytest.mark.parametrize("name", sorted(CASES))
def test_count_distinct_general_path_matches_jax(name, dead):
    tb, pb, keys = _distinct_inputs(name, dead)
    want = tpu_group(tb, keys, [TpuAgg(k, c, m, f"a{j}")
                                for j, (k, c, m) in enumerate(DISTINCT_AGGS)])
    got = group_aggregate(pb, keys, [
        AggInput(k, c, m, f"a{j}")
        for j, (k, c, m) in enumerate(DISTINCT_AGGS)])
    assert got.names == want.names
    _same(got.to_pylist(), want.to_pylist())


@pytest.mark.parametrize("dead", [0, 37])
def test_count_distinct_global_path_matches_jax(dead):
    from trino_tpu.ops.groupby import global_aggregate as tpu_global
    from trino_tpu_torch.ops.groupby import global_aggregate
    tb, pb, _ = _distinct_inputs("int", dead)
    aggs = DISTINCT_AGGS + [("count_star", None, None)]
    want = tpu_global(tb, [TpuAgg(k, c, m, f"a{j}")
                           for j, (k, c, m) in enumerate(aggs)])
    got = global_aggregate(pb, [AggInput(k, c, m, f"a{j}")
                                for j, (k, c, m) in enumerate(aggs)])
    assert got.to_pylist() == want.to_pylist()
    # 0.0 (and -0.0), NaN, 2.5, -2.5, 1e300 and 7.25
    assert got.to_pylist()[0][4] == 6
