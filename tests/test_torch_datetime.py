"""Civil-date arithmetic of the PyTorch engine
(trino_tpu_torch/ops/datetime.py) against the JAX engine's
(trino_tpu/ops/datetime.py) on the CPU, and SQL date expressions through
both engines. Dates are exact.
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import datetime as tpu_dt
from trino_tpu.runner import LocalQueryRunner as TpuRunner
from trino_tpu_torch.ops import datetime as dt
from trino_tpu_torch.runner import LocalQueryRunner


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


# month ends, leap days, century rules, dates before the epoch
EDGES = [_days(2000, 1, 31), _days(2000, 2, 29), _days(1900, 2, 28),
         _days(2100, 3, 31), _days(1999, 12, 31), _days(1969, 12, 31),
         _days(1600, 2, 29), _days(1, 1, 1), _days(1970, 1, 1),
         _days(2024, 8, 31), _days(1583, 10, 15), _days(9999, 12, 31)]


def _day_lane():
    rng = np.random.default_rng(3)
    return np.concatenate([np.asarray(EDGES, np.int64),
                           rng.integers(-800_000, 2_900_000, 4000)])


def test_civil_round_trip_matches_jax():
    days = _day_lane()
    got = dt.civil_from_days(torch.from_numpy(days))
    want = tpu_dt.civil_from_days(jnp.asarray(days))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    back = dt.days_from_civil(*got)
    assert np.array_equal(back.numpy(), days)


@pytest.mark.parametrize("field", ["year", "month", "day", "quarter",
                                   "day_of_week", "day_of_year", "week"])
def test_extract_field_matches_jax(field):
    days = _day_lane()
    got = dt.extract_field(torch.from_numpy(days), field)
    want = tpu_dt.extract_field(jnp.asarray(days), field)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_extract_field_matches_python():
    days = _day_lane()[:400]
    # python's dates span the years 1 to 9999
    days = days[(days >= EDGES[7]) & (days <= EDGES[-1])]
    got = {f: dt.extract_field(torch.from_numpy(days), f).numpy()
           for f in ("year", "month", "day", "quarter")}
    for k, d in enumerate(days):
        date = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
        assert (got["year"][k], got["month"][k], got["day"][k],
                got["quarter"][k]) == (date.year, date.month, date.day,
                                       (date.month - 1) // 3 + 1)


@pytest.mark.parametrize("months", [-25, -12, -1, 0, 1, 2, 3, 11, 12, 13,
                                    48, 1200])
def test_add_months_matches_jax(months):
    days = _day_lane()
    m = np.full(days.shape, months, np.int64)
    got = dt.add_months(torch.from_numpy(days), torch.from_numpy(m))
    want = tpu_dt.add_months(jnp.asarray(days), jnp.asarray(m))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_add_months_clamps_to_month_end():
    jan31 = torch.tensor([_days(2000, 1, 31), _days(2001, 1, 31)])
    one = torch.ones(2, dtype=torch.int64)
    assert dt.add_months(jan31, one).tolist() == [_days(2000, 2, 29),
                                                  _days(2001, 2, 28)]


SQL = [
    "SELECT o_orderdate, o_orderdate + INTERVAL '1' MONTH, "
    "o_orderdate - INTERVAL '2' YEAR, year(o_orderdate), "
    "month(o_orderdate), day(o_orderdate), quarter(o_orderdate), "
    "EXTRACT(YEAR FROM o_orderdate), day_of_week(o_orderdate) "
    "FROM orders WHERE o_orderkey < 200 ORDER BY o_orderkey",
    "SELECT count(*) FROM lineitem WHERE l_shipdate "
    ">= DATE '1996-01-31' + INTERVAL '1' MONTH "
    "AND l_shipdate < DATE '1996-02-29' + INTERVAL '1' YEAR",
]


@pytest.mark.parametrize("sql", SQL)
def test_date_sql_matches_jax(sql):
    want = TpuRunner().execute(sql)
    got = LocalQueryRunner(device="cpu").execute(sql)
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert got.rows == want.rows and len(got.rows) > 0
