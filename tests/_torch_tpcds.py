"""Shared by tests/test_torch_tpcds_{a,b,c,d}.py: one TPC-DS query at
tpcds.tiny through the PyTorch engine (device="cpu") and the JAX engine
(Pallas in interpret mode), compared with test_torch_tpch.py's ``_same``
(in order; integers, strings and dates exact, doubles within rel 1e-9).

The corpus is split by query number over four files so that
``--dist loadfile`` spreads it over workers. q14 and q16 carry the
``slow`` mark, as in tests/test_tpcds.py.
"""

import pytest
import torch

from test_torch_tpch import _same
from trino_tpu.benchmarks.tpcds_queries import TPCDS_QUERIES
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu.session import Session as TpuSession
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

SLOW = (14, 16)


def params(lo: int, hi: int):
    """The corpus's query numbers in [lo, hi], q14 and q16 marked slow."""
    return [pytest.param(q, marks=pytest.mark.slow) if q in SLOW else q
            for q in sorted(TPCDS_QUERIES) if lo <= q <= hi]


@pytest.fixture(scope="module")
def runners():
    """(port, JAX) runners on tpcds.tiny, one pair per file. The port runs
    on one CPU thread here: several test workers share the machine, and
    intra-op threads of every worker would fight over its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield (LocalQueryRunner(Session(catalog="tpcds", schema="tiny"),
                            device="cpu"),
           TpuRunner(session=TpuSession(catalog="tpcds", schema="tiny")))
    torch.set_num_threads(threads)


def check(sql: str, runners, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")
    port, jax_runner = runners
    got = port.execute(sql)
    _same(got, jax_runner.execute(sql))
    return got


def relaxed_q64() -> str:
    """The spec q64 can be empty at tiny scale; this variant (all colors,
    the full price range, no year pin on cs1/cs2) is not, so the 18-way
    join really runs (the edits of tests/test_tpcds.py)."""
    sql = TPCDS_QUERIES[64]
    sql = sql.replace("AND i_current_price BETWEEN 64 AND 74", "")
    sql = sql.replace("AND i_current_price BETWEEN 65 AND 79", "")
    sql = sql.replace(
        "AND i_color IN ('purple', 'burlywood', 'indian', 'spring',\n"
        "                    'floral', 'medium')", "")
    sql = sql.replace("AND cs1.syear = 1999", "")
    sql = sql.replace("AND cs2.syear = 2000", "")
    return sql
