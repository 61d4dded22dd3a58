"""TPC-H q1 (pricing summary report): DELTA days before 1998-12-01.

A block's rows are bucketed by the smallest asked cut-off at or after
their ship date; a parameter set's partial is the sum of the buckets up
to its own cut-off, so every DELTA asked shares one pass over the block."""

from __future__ import annotations

import numpy as np

from . import Answer, group_sums
from .tpch_gen import LINESTATUS, RETURNFLAGS, days

COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
           "l_discount", "l_tax", "l_shipdate")
# group id = returnflag * 2 + linestatus
N_GROUPS = len(RETURNFLAGS) * len(LINESTATUS)


def cutoff(params) -> int:
    return days(1998, 12, 1) - int(params["DELTA"])


def partial(rows, orders, params_list, sf, dt):
    cuts = np.array(sorted({cutoff(p) for p in params_list}))
    # bucket b: cuts[b - 1] < ship date <= cuts[b]; len(cuts): past all
    bucket = np.searchsorted(cuts, rows["l_shipdate"], side="left")
    keep = bucket < len(cuts)
    g = rows["l_returnflag"][keep] * 2 + rows["l_linestatus"][keep]
    key = bucket[keep] * N_GROUPS + g
    n = len(cuts) * N_GROUPS
    price = rows["l_extendedprice"][keep]
    disc = rows["l_discount"][keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + rows["l_tax"][keep])
    sums = group_sums(key, n, (rows["l_quantity"][keep], price, disc_price,
                               charge, disc), dt)
    sums = np.cumsum(sums.reshape(len(cuts), N_GROUPS, 5), axis=0, dtype=dt)
    counts = np.cumsum(np.bincount(key, minlength=n).reshape(
        len(cuts), N_GROUPS), axis=0)
    at = {int(c): i for i, c in enumerate(cuts)}
    return [(sums[at[cutoff(p)]], counts[at[cutoff(p)]])
            for p in params_list]


def finish(parts, params, dt):
    sums = np.zeros((N_GROUPS, 5), dtype=dt)
    counts = np.zeros(N_GROUPS, dtype=np.int64)
    for s, c in parts:
        sums += s
        counts += c
    rows = []
    for g in range(N_GROUPS):
        if counts[g] == 0:
            continue
        qty, price, disc_price, charge, disc = (float(v) for v in sums[g])
        n = int(counts[g])
        rows.append([RETURNFLAGS[g // 2], LINESTATUS[g % 2], qty, price,
                     disc_price, charge, float(dt(qty) / dt(n)),
                     float(dt(price) / dt(n)), float(dt(disc) / dt(n)), n])
    rows.sort(key=lambda r: (r[0], r[1]))
    return Answer(rows, key=(0, 1), doubles=(2, 3, 4, 5, 6, 7, 8))
