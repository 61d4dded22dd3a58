"""Shared by tests/test_torch_arrays.py, test_torch_maps_rows_lambdas.py and
test_torch_collections.py: one SQL string through the JAX engine and
through the PyTorch engine on the CPU (``LocalQueryRunner(device="cpu")``)
at ``tpch.tiny``, with the rows compared in order.

Integers, strings, booleans and dates compare exactly; doubles within rel
1e-9 (a sum over another grouping order may differ in its last bits). An
ARRAY compares element by element, a ROW field by field, a MAP entry by
entry after sorting both by key. A digest is its base64 text, so its
centroids compare exactly.
"""

import math

import pytest

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.runner import LocalQueryRunner

REL = 1e-9


@pytest.fixture(scope="module")
def engines():
    return TpuRunner(), LocalQueryRunner(device="cpu")


def same(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want):
            return math.isnan(got)
        return got == want or abs(got - want) <= REL * max(abs(got),
                                                           abs(want))
    if isinstance(want, dict) and isinstance(got, dict):
        if len(got) != len(want):
            return False
        return same(sorted(got.items(), key=_key),
                    sorted(want.items(), key=_key))
    if isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        return len(got) == len(want) and all(
            same(g, w) for g, w in zip(got, want))
    return type(got) is type(want) and got == want


def _key(item):
    k = item[0]
    return (k is None, str(type(k)), k if k is not None else 0)


def check(engines, sql: str):
    """The port's rows equal the JAX engine's; returns them."""
    jax_runner, port = engines
    want = jax_runner.execute(sql).rows
    got = port.execute(sql).rows
    assert same(got, want), (sql, got, want)
    return got
