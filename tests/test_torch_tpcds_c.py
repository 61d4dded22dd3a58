"""TPC-DS q51-q75 at tpcds.tiny through the PyTorch engine against the
JAX engine (tests/_torch_tpcds.py)."""

import pytest

from _torch_tpcds import TPCDS_QUERIES, check, params, runners  # noqa: F401


@pytest.mark.parametrize("q", params(51, 75))
def test_tpcds_query(q, runners, monkeypatch):  # noqa: F811
    check(TPCDS_QUERIES[q], runners, monkeypatch)
