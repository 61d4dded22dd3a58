"""Host spill of oversized joins in the PyTorch engine, on the CPU: the
counterparts of tests/test_memory.py's chunked-join tests.

With ``max_batch_rows`` lowered, a join whose output exceeds it expands
probe chunks, filters each by the residual, and accumulates the chunks in
host memory; its rows must equal the unspilled run's and the JAX
engine's, and the query reports the bytes it spilled. With spill
disabled the memory guard raises instead. The spilled batch returns to
the executor's device where the next node reads it; a node output on the
wrong device without the spill mark raises.
"""

import pytest
import torch

from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.config import CONFIG
from trino_tpu_torch.exec import executor as executor_mod
from trino_tpu_torch.exec.executor import Executor, QueryError
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session
from trino_tpu_torch.types import BIGINT

SQL = {
    "inner": "SELECT o_orderpriority, count(*) c, sum(l_quantity) s "
             "FROM orders JOIN lineitem ON l_orderkey = o_orderkey "
             "GROUP BY o_orderpriority ORDER BY 1",
    "left": "SELECT count(*), count(o_orderkey) "
            "FROM customer LEFT JOIN orders ON o_custkey = c_custkey",
    "residual": "SELECT count(*) FROM orders o "
                "JOIN lineitem l ON l_orderkey = o_orderkey "
                "AND l_extendedprice > o_totalprice * 0.5",
    "full": "SELECT count(*), count(c_custkey), count(o_orderkey) "
            "FROM (SELECT c_custkey FROM customer WHERE c_custkey < 1400) c "
            "FULL JOIN orders ON o_custkey = c_custkey",
    # the spilled-join case that was outside the previous slice, over the
    # orders with o_orderkey < 2000 (2 x 250^2 output rows)
    "self_join_on_parity":
        "SELECT count(*) FROM (SELECT o_orderkey % 2 AS k FROM orders "
        "WHERE o_orderkey < 2000) a JOIN (SELECT o_orderkey % 2 AS k "
        "FROM orders WHERE o_orderkey < 2000) b ON a.k = b.k",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_chunked_join_matches_unchunked_and_the_jax_engine(name,
                                                           monkeypatch):
    runner = LocalQueryRunner(device="cpu")
    whole = runner.execute(SQL[name])
    assert whole.spill_bytes == 0
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    spilled = runner.execute(SQL[name])
    assert spilled.spill_bytes > 0
    assert spilled.rows == whole.rows
    assert spilled.rows == TpuRunner().execute(SQL[name]).rows


def test_spill_disabled_oversized_join_raises(monkeypatch):
    session = Session(catalog="tpch", schema="tiny")
    session.set("spill_enabled", False)
    session.set("query_max_memory_per_node", 100000)
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    with pytest.raises(QueryError, match="memory limit") as e:
        LocalQueryRunner(session, device="cpu").execute(
            "SELECT count(l_quantity) FROM orders "
            "JOIN lineitem ON l_orderkey = o_orderkey")
    assert e.value.error_name == "EXCEEDED_LOCAL_MEMORY_LIMIT"


def test_spill_chunks_hold_only_the_residual_survivors(monkeypatch):
    monkeypatch.setattr(CONFIG, "max_batch_rows", 4096)
    chunks = []
    to_host = executor_mod._to_host

    def spy(b, n):
        out = to_host(b, n)
        chunks.append(out)
        return out
    monkeypatch.setattr(executor_mod, "_to_host", spy)
    runner = LocalQueryRunner(device="cpu")
    got = runner.execute(SQL["residual"])
    assert len(chunks) > 1
    assert all(c.spilled for c in chunks)
    assert sum(c.num_rows for c in chunks) == got.rows[0][0]


def test_node_output_on_another_device_raises():
    ex = Executor(None, Session(catalog="tpch", schema="tiny"),
                  torch.device("cuda"))
    b = Batch({"x": Column(BIGINT, torch.zeros(8, dtype=torch.int64))}, 8)
    with pytest.raises(QueryError, match="without the spill mark"):
        ex._check_device(b, "ValuesNode")
    # the spill mark is what lets a host batch through, back to the device
    assert Batch(b.columns, 8, spilled=True).spilled
