"""Civil-date arithmetic over int lanes of days since 1970-01-01.

Counterpart of ``trino_tpu/ops/datetime.py``: the branch-free
civil-calendar algorithm (Howard Hinnant's days_from_civil /
civil_from_days), pure integer arithmetic over the whole column. Every
division of a value that can be negative floors, as ``jnp.floor_divide``
does; torch's ``div`` truncates unless asked.
"""

from __future__ import annotations

from typing import Tuple

import torch

_I64 = torch.int64


def _fdiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def civil_from_days(days: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """days since 1970-01-01 -> (year, month, day), proleptic Gregorian."""
    z = days.to(_I64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                   # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                              # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                      # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)                      # [1, 12]
    y = y + (m <= 2).to(_I64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    y = y.to(_I64) - (m <= 2).to(_I64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _day_of_year(days: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(y)
    return days.to(_I64) - days_from_civil(y, one, one) + 1


def extract_field(days: torch.Tensor, field: str) -> torch.Tensor:
    """EXTRACT(field FROM date-as-days) -> int64 lane."""
    y, m, d = civil_from_days(days)
    if field == "year":
        return y
    if field == "month":
        return m
    if field in ("day", "day_of_month"):
        return d
    if field == "quarter":
        return _fdiv(m - 1, 3) + 1
    dow = torch.remainder(days.to(_I64) + 3, 7) + 1  # ISO, Monday = 1
    if field in ("day_of_week", "dow"):
        return dow
    if field in ("day_of_year", "doy"):
        return _day_of_year(days, y)
    if field == "week":
        # ISO week number; weeks 0 and 53 of neighbouring years clamp
        wk = _fdiv(_day_of_year(days, y) - dow + 10, 7)
        return wk.clamp(1, 53)
    raise ValueError(f"unsupported extract field for date: {field}")


def add_months(days: torch.Tensor, months: torch.Tensor) -> torch.Tensor:
    """date + INTERVAL month with end-of-month clamping (SQL standard)."""
    y, m, d = civil_from_days(days)
    t = (y * 12 + (m - 1)) + months.to(_I64)
    ny = _fdiv(t, 12)
    nm = t - ny * 12 + 1
    one = torch.ones_like(nm)
    dec = nm == 12
    first_next = days_from_civil(ny + dec.to(_I64),
                                 torch.where(dec, one, nm + 1), one)
    month_len = first_next - days_from_civil(ny, nm, one)
    return days_from_civil(ny, nm, torch.minimum(d, month_len))
