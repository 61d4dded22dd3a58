"""TPC-DS q1-q25 at tpcds.tiny through the PyTorch engine against the
JAX engine (tests/_torch_tpcds.py)."""

import pytest

from _torch_tpcds import TPCDS_QUERIES, check, params, runners  # noqa: F401


@pytest.mark.parametrize("q", params(1, 25))
def test_tpcds_query(q, runners, monkeypatch):  # noqa: F811
    check(TPCDS_QUERIES[q], runners, monkeypatch)
