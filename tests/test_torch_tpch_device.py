"""The PyTorch engine's device lineitem generator
(trino_tpu_torch/connectors/tpch_device.py), run on the CPU, must be
bit-identical to the JAX engine's numpy host generator
(trino_tpu.connectors.tpch.TpchConnector._lineitem).

The high sf10 order range puts order and row indices where the u64 hash
states use all 64 bits, so the int64 emulation of u64 shifts and
remainders gets exercised.
"""

import numpy as np
import pytest
import torch

from trino_tpu.catalog import Split as TpuSplit, TableHandle as TpuHandle
from trino_tpu.connectors.tpch import SCHEMAS, TpchConnector as TpuTpch
from trino_tpu_torch.catalog import Split, TableHandle
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.connectors.tpch_device import (
    LINEITEM_DEVICE_COLS, _umod, _u64, device_filter, lineitem_batch)
from trino_tpu_torch.predicate import filter_batch_host

COLS = sorted(LINEITEM_DEVICE_COLS)
CPU = torch.device("cpu")


def _values(col, n):
    data = col.data[:n].numpy() if isinstance(col.data, torch.Tensor) \
        else np.asarray(col.data)[:n]
    if col.dictionary is not None:
        return col.dictionary.values[data.astype(np.int64)]
    return data


@pytest.mark.parametrize("schema,lo,hi", [
    ("tiny", 0, 1500),
    ("tiny", 14_000, 15_000),
    ("sf10", 7_500_000, 7_501_000),
    ("sf10", 14_998_976, 15_000_000),
])
def test_lineitem_bit_identical_to_numpy(schema, lo, hi):
    sf = SCHEMAS[schema]
    want = TpuTpch()._lineitem(np.arange(lo + 1, hi + 1, dtype=np.int64),
                               sf, COLS)
    got = lineitem_batch(lo, hi, sf, COLS, CPU)
    n = want.num_rows_host()
    assert got.num_rows_host() == n
    assert got.capacity == want.capacity
    for name in COLS:
        w = _values(want.column(name), n)
        g = _values(got.column(name), n)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


def test_u64_emulation_matches_numpy():
    idx = np.array([0, 1, 2**31, 2**40 + 7, 2**62 - 1, 119_999_999],
                   dtype=np.int64)
    from trino_tpu.connectors import tpch as host
    want = host._u64(6005, idx)
    got = _u64(6005, torch.from_numpy(idx))
    assert np.array_equal(got.numpy().view(np.uint64), want)
    for m in (2, 7, 121, 200_000, 2**61 + 1):
        assert np.array_equal(_umod(got, m).numpy(),
                              (want % np.uint64(m)).astype(np.int64))


def test_device_filter_matches_host_filter():
    # a pushed-down constraint (date range, dictionary IN) enforced on
    # generated lanes must keep exactly the rows the host filter keeps
    from trino_tpu_torch.runner import LocalQueryRunner
    r = LocalQueryRunner(device="cpu")
    plan = r.plan_sql(
        "SELECT l_quantity FROM lineitem "
        "WHERE l_shipdate >= DATE '1994-01-01' "
        "AND l_shipdate < DATE '1995-01-01' "
        "AND l_shipmode IN ('MAIL', 'SHIP')")
    scan = plan
    while getattr(scan, "source", None) is not None:
        scan = scan.source
    handle = scan.handle
    assert handle.constraint is not None
    cols = ["l_quantity", "l_shipdate", "l_shipmode"]
    raw = lineitem_batch(0, 3000, 0.01, cols, CPU)
    want = filter_batch_host(raw, handle.constraint, None)
    got = device_filter(raw, handle.constraint, None)
    n = want.num_rows_host()
    assert got.num_rows_host() == n > 0
    for name in cols:
        assert np.array_equal(_values(got.column(name), n),
                              _values(want.column(name), n)), name


def test_cpu_connector_reads_host_generator():
    conn = TpchConnector(device="cpu")
    split = Split(TableHandle("tpch", "tiny", "lineitem"), 0, 1)
    batch = conn.read_split(split, COLS)
    ref = TpuTpch().read_split(
        TpuSplit(TpuHandle("tpch", "tiny", "lineitem"), 0, 1), COLS)
    n = ref.num_rows_host()
    assert batch.num_rows_host() == n
    assert batch.device == CPU
    for name in COLS:
        assert np.array_equal(_values(batch.column(name), n),
                              _values(ref.column(name), n)), name
