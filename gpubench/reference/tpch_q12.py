"""TPC-H q12 (shipping modes and order priority): two ship modes, a
receipt year; high and low priority line counts a mode.

A block's late lines are counted once by (receipt year, mode, high
priority); a parameter set's partial reads its two modes' counts."""

from __future__ import annotations

import numpy as np

from . import Answer
from .tpch_gen import MODES, PRIORITIES, days

COLUMNS = ("l_shipmode", "l_commitdate", "l_receiptdate", "l_shipdate",
           "o_orderpriority")
HIGH = (PRIORITIES.index("1-URGENT"), PRIORITIES.index("2-HIGH"))
YEARS = list(range(1992, 2000))
STARTS = np.array([days(y, 1, 1) for y in YEARS])


def partial(rows, orders, params_list, sf, dt):
    commit, receipt = rows["l_commitdate"], rows["l_receiptdate"]
    keep = (commit < receipt) & (rows["l_shipdate"] < commit)
    prio = np.repeat(orders["o_orderpriority"], orders["counts"])
    high = np.isin(prio[keep], HIGH).astype(np.int64)
    year = np.searchsorted(STARTS, receipt[keep], side="right") - 1
    key = (year * len(MODES) + rows["l_shipmode"][keep]) * 2 + high
    counts = np.bincount(key, minlength=len(YEARS) * len(MODES) * 2)
    counts = counts.reshape(len(YEARS), len(MODES), 2)
    out = []
    for p in params_list:
        y = YEARS.index(int(p["YEAR"]))
        modes = sorted((p["SHIPMODE1"], p["SHIPMODE2"]))
        out.append([(int(counts[y, MODES.index(m), 1]),
                     int(counts[y, MODES.index(m), 0])) for m in modes])
    return out


def finish(parts, params, dt):
    modes = sorted((params["SHIPMODE1"], params["SHIPMODE2"]))
    rows = []
    for i, mode in enumerate(modes):
        high = sum(p[i][0] for p in parts)
        low = sum(p[i][1] for p in parts)
        if high + low:
            rows.append([mode, high, low])
    return Answer(rows, key=(0,))
