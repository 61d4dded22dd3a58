"""TPC-H q3 (shipping priority): the ten unshipped orders of one market
segment with the largest revenue at a date.

A block's lines that any asked date could keep (shipped after the
earliest, of an order placed before the latest) are taken once; each
parameter set filters that share of the block."""

from __future__ import annotations

import datetime

import numpy as np

from . import Answer
from .tpch_gen import SEGMENTS, customer_segment, date_str, days, order_key

COLUMNS = ("l_extendedprice", "l_discount", "l_shipdate", "o_orderdate",
           "o_custkey")
LIMIT = 10
# rows kept past the limit, for a tie at the cut
SPARE = 6


def cutoff(params) -> int:
    d = datetime.date.fromisoformat(params["DATE"])
    return days(d.year, d.month, d.day)


def partial(rows, orders, params_list, sf, dt):
    cuts = [cutoff(p) for p in params_list]
    counts = orders["counts"]
    odate_o = orders["o_orderdate"]
    line_order = np.repeat(np.arange(len(counts)), counts)
    cand = np.nonzero((rows["l_shipdate"] > min(cuts))
                      & np.repeat(odate_o < max(cuts), counts))[0]
    lo = line_order[cand]
    ship = rows["l_shipdate"][cand]
    rev = rows["l_extendedprice"][cand] * (1 - rows["l_discount"][cand])
    odate = odate_o[lo]
    seg_o = customer_segment(orders["o_custkey"])
    seg = seg_o[lo]
    out = []
    for p, cut in zip(params_list, cuts):
        ok = (ship > cut) & (odate < cut) & (seg == SEGMENTS.index(
            p["SEGMENT"]))
        o = lo[ok]
        if len(o) == 0:
            out.append([])
            continue
        first = np.flatnonzero(np.diff(o, prepend=-1))
        hit = o[first]
        rv = np.add.reduceat(rev[ok], first, dtype=dt)
        keys = order_key(orders["o_idx"][hit])
        od = odate_o[hit]
        top = np.lexsort((keys, od, -rv))[:LIMIT + SPARE]
        out.append([(float(rv[i]), int(od[i]), int(keys[i])) for i in top])
    return out


def finish(parts, params, dt):
    cands = sorted((c for p in parts for c in p),
                   key=lambda c: (-c[0], c[1], c[2]))[:LIMIT + SPARE]
    rows = [[key, rv, date_str(od), 0] for rv, od, key in cands]
    return Answer(rows[:LIMIT], key=(0,), doubles=(1,),
                  candidates=rows[LIMIT:], tie=1)
