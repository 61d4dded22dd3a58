"""UTC offsets of a time zone over lanes of instants, on the device.

A fixed zone ('UTC', 'Z', '+05:30') is one offset. An IANA zone
('America/Los_Angeles') is piecewise constant in time: the host builds
that zone's transition table over the lane's range (two scalars read
back) from ``zoneinfo``, and each row finds its period with one
``torch.searchsorted`` on the device, so the host work grows with the
range in days, not with the rows.

The table samples the zone's offset once a day over the range, then
pins each change between two samples to the second by bisection; it
assumes no zone changes its offset twice within one day, which holds
for the tz database. An unknown zone raises; there is no fallback to
UTC or to a fixed offset.
"""

from __future__ import annotations

import datetime
import functools
from typing import Tuple

import numpy as np
import torch

_I64 = torch.int64
_MS_DAY = 86_400_000
_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
# python's datetime spans the years 1 to 9999
_MIN_MS = (datetime.datetime(1, 1, 2, tzinfo=datetime.timezone.utc)
           - _EPOCH) // datetime.timedelta(milliseconds=1)
_MAX_MS = (datetime.datetime(9999, 12, 30, tzinfo=datetime.timezone.utc)
           - _EPOCH) // datetime.timedelta(milliseconds=1)


class UnknownZone(ValueError):
    pass


def fixed_offset(zone: str):
    """Offset minutes of a fixed zone, or None for a named zone."""
    z = zone.strip()
    if z.upper() in ("UTC", "Z", "GMT", "UT"):
        return 0
    if z and z[0] in "+-":
        sign = -1 if z[0] == "-" else 1
        hh, _, mm = z[1:].partition(":")
        try:
            return sign * (int(hh) * 60 + int(mm or 0))
        except ValueError:
            raise UnknownZone(f"invalid time zone offset: '{zone}'") \
                from None
    return None


def _zone(name: str):
    from zoneinfo import ZoneInfo, ZoneInfoNotFoundError
    try:
        return ZoneInfo(name)
    except (ZoneInfoNotFoundError, ValueError):
        raise UnknownZone(f"unknown time zone: '{name}'") from None


def _offset_at(zi, seconds: int) -> int:
    """Offset minutes of ``zi`` at the instant ``seconds`` after 1970."""
    t = _EPOCH + datetime.timedelta(seconds=seconds)
    return int(t.astimezone(zi).utcoffset().total_seconds()) // 60


@functools.lru_cache(maxsize=64)
def transitions(name: str, lo_day: int, hi_day: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, offsets) of zone ``name`` over the days [lo_day, hi_day]
    since 1970: ``offsets[k]`` holds from the instant ``starts[k]`` (ms,
    ascending) until the next start; ``starts[0]`` is int64 min."""
    zi = _zone(name)
    starts = [np.iinfo(np.int64).min]
    prev = _offset_at(zi, lo_day * 86400)
    offs = [prev]
    for day in range(lo_day + 1, hi_day + 2):
        cur = _offset_at(zi, day * 86400)
        if cur == prev:
            continue
        a, b = (day - 1) * 86400, day * 86400   # offset(a) != offset(b)
        while b - a > 1:
            mid = (a + b) // 2
            if _offset_at(zi, mid) == prev:
                a = mid
            else:
                b = mid
        starts.append(b * 1000)
        offs.append(cur)
        prev = cur
    return np.asarray(starts, np.int64), np.asarray(offs, np.int64)


def _table(name: str, lanes: torch.Tensor, valid):
    """The zone's transition table on the lane's device, over the day
    range of the lane's valid rows (padded a day each side)."""
    x = lanes if valid is None else lanes[valid]
    if x.numel() == 0:
        lo = hi = 0
    else:
        lo, hi = (int(v) for v in torch.stack([x.min(), x.max()]).cpu())
    lo = min(max(lo, _MIN_MS), _MAX_MS) // _MS_DAY - 1
    hi = min(max(hi, _MIN_MS), _MAX_MS) // _MS_DAY + 1
    starts, offs = transitions(name, lo, hi)
    dev = lanes.device
    return torch.from_numpy(starts).to(dev), torch.from_numpy(offs).to(dev)


def offsets_at(zone: str, instants: torch.Tensor,
               valid=None) -> torch.Tensor:
    """Offset minutes of ``zone`` at each UTC instant (ms)."""
    fixed = fixed_offset(zone)
    ms = instants.to(_I64).contiguous()
    if fixed is not None:
        return torch.full_like(ms, fixed)
    starts, offs = _table(zone.strip(), ms, valid)
    k = torch.searchsorted(starts, ms, right=True) - 1
    return offs[k.clamp(0, offs.shape[0] - 1)]


def offsets_for_local(zone: str, local: torch.Tensor,
                      valid=None) -> torch.Tensor:
    """Offset minutes that read the wall-clock time ``local`` (ms) in
    ``zone``, by java.time's rule: a time in a gap moves later by the
    gap (the offset before it), a time in an overlap keeps the earlier
    offset. Period k serves local times below
    ``starts[k + 1] + 60000 * max(offs[k], offs[k + 1])``."""
    fixed = fixed_offset(zone)
    ms = local.to(_I64).contiguous()
    if fixed is not None:
        return torch.full_like(ms, fixed)
    starts, offs = _table(zone.strip(), ms, valid)
    if offs.shape[0] == 1:
        return offs.expand(ms.shape[0]).clone()
    ends = starts[1:] + 60_000 * torch.maximum(offs[:-1], offs[1:])
    k = torch.searchsorted(ends, ms, right=True)
    return offs[k.clamp(0, offs.shape[0] - 1)]
