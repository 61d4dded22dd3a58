"""TPC-DS through two port workers (the stage DAG, the default session)
against the JAX engine's local rows at tpcds.tiny: the subset of
tests/test_mpp_corpus.py's tier 1 (grouping sets and ROLLUP, semi
joins, self joins, plain join and aggregation), and its full sweep
under the ``slow`` marker as there."""

import pytest

from _torch_mpp import dist_check, tpu_local, workers  # noqa: F401
from trino_tpu.benchmarks.tpcds_queries import TPCDS_QUERIES

_TPCDS_TIER1 = (1, 3, 5, 7, 10, 16, 18, 22, 27, 33, 42, 69, 77, 80)


@pytest.fixture(scope="module")
def tpcds_local():
    return tpu_local("tpcds")


@pytest.mark.parametrize("qn", _TPCDS_TIER1)
def test_tpcds_mpp_default_on_matches_local(workers, tpcds_local, qn):
    dist_check(workers, tpcds_local, TPCDS_QUERIES[qn],
               f"tpcds q{qn}", "tpcds")


@pytest.mark.slow
@pytest.mark.parametrize("qn", [q for q in sorted(TPCDS_QUERIES)
                                if q not in _TPCDS_TIER1])
def test_tpcds_mpp_full_sweep_matches_local(workers, tpcds_local, qn):
    dist_check(workers, tpcds_local, TPCDS_QUERIES[qn],
               f"tpcds q{qn}", "tpcds")
