"""All 22 TPC-H queries through two port workers (the stage DAG, the
default session) against the JAX engine's local rows at tpch.tiny.
Counterparts of tests/test_mpp_corpus.py's TPC-H cases; its TPC-DS
cases are tests/test_torch_mpp_corpus_ds.py."""

import pytest

from _torch_mpp import dist_check, tpu_local, workers  # noqa: F401
from trino_tpu.benchmarks.tpch_queries import TPCH_QUERIES


@pytest.fixture(scope="module")
def tpch_local():
    return tpu_local("tpch")


@pytest.mark.parametrize("qn", sorted(TPCH_QUERIES))
def test_tpch_mpp_default_on_matches_local(workers, tpch_local, qn):
    dist_check(workers, tpch_local, TPCH_QUERIES[qn], f"tpch q{qn}",
               "tpch")
