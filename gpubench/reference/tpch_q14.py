"""TPC-H q14 (promotion effect): the share of revenue from PROMO parts
shipped in one month.

A block's rows of the asked months are grouped once by month, in their
order; a parameter set's partial is its month's two sums."""

from __future__ import annotations

import datetime

import numpy as np

from . import Answer, group_sums
from .tpch_gen import TYPE_S1, days, part_type_s1

COLUMNS = ("l_partkey", "l_extendedprice", "l_discount", "l_shipdate")
PROMO = TYPE_S1.index("PROMO")


def month_bounds(first: str):
    d = datetime.date.fromisoformat(first)
    nxt = datetime.date(d.year + d.month // 12, d.month % 12 + 1, 1)
    return days(d.year, d.month, d.day), days(nxt.year, nxt.month, 1)


def partial(rows, orders, params_list, sf, dt):
    months = sorted({p["MONTH"] for p in params_list})
    bounds = [month_bounds(m) for m in months]
    ship = rows["l_shipdate"]
    group = np.full(len(ship), -1, dtype=np.int64)
    for i, (lo, hi) in enumerate(bounds):
        group[(ship >= lo) & (ship < hi)] = i
    keep = group >= 0
    rev = rows["l_extendedprice"][keep] * (1 - rows["l_discount"][keep])
    promo = part_type_s1(rows["l_partkey"][keep]) == PROMO
    sums = group_sums(group[keep], len(months),
                      (np.where(promo, rev, dt(0)), rev), dt)
    return [(sums[months.index(p["MONTH"]), 0],
             sums[months.index(p["MONTH"]), 1]) for p in params_list]


def finish(parts, params, dt):
    promo = np.sum(np.asarray([p[0] for p in parts], dtype=dt), dtype=dt)
    total = np.sum(np.asarray([p[1] for p in parts], dtype=dt), dtype=dt)
    return Answer([[float(dt(100.0) * promo / total)]], doubles=(0,))
