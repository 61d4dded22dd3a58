"""TPC-DS q76-q99 at tpcds.tiny through the PyTorch engine against the
JAX engine (tests/_torch_tpcds.py)."""

import pytest

from _torch_tpcds import (TPCDS_QUERIES, check, params, relaxed_q64,
                          runners)  # noqa: F401


@pytest.mark.parametrize("q", params(76, 99))
def test_tpcds_query(q, runners, monkeypatch):  # noqa: F811
    check(TPCDS_QUERIES[q], runners, monkeypatch)


def test_q64_relaxed_nonempty(runners, monkeypatch):  # noqa: F811
    got = check(relaxed_q64(), runners, monkeypatch)
    assert len(got.rows) > 0, "relaxed q64 returned no rows"
