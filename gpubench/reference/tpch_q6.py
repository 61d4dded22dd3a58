"""TPC-H q6 (forecasting revenue change): a ship year, a discount band
and a quantity cap. The bounds ``DISCOUNT -/+ 0.01`` are exact decimals
compared with the DOUBLE column as doubles, as SQL's decimal literals are.

A block's revenue is summed once by (ship year, discount, quantity); a
parameter set's partial is the sum of the cells its predicate keeps."""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from . import Answer, group_sums
from .tpch_gen import days

COLUMNS = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
YEARS = list(range(1992, 2000))
STARTS = np.array([days(y, 1, 1) for y in YEARS])
# discounts are k / 100 for k in 0..10; quantities 1..50
N_DISC, N_QTY = 11, 51


def partial(rows, orders, params_list, sf, dt):
    ship, disc = rows["l_shipdate"], rows["l_discount"]
    year = np.searchsorted(STARTS, ship, side="right") - 1
    k = np.rint(disc.astype(np.float64) * 100).astype(np.int64)
    qty = rows["l_quantity"].astype(np.int64)
    key = (year * N_DISC + k) * N_QTY + qty
    n = len(YEARS) * N_DISC * N_QTY
    cube = group_sums(key, n, (rows["l_extendedprice"] * disc,), dt)
    cube = cube.reshape(len(YEARS), N_DISC, N_QTY)
    values = np.arange(N_DISC) / 100.0
    out = []
    for p in params_list:
        y = YEARS.index(int(p["YEAR"]))
        d = Decimal(str(p["DISCOUNT"]))
        lo = dt(float(d - Decimal("0.01")))
        hi = dt(float(d + Decimal("0.01")))
        band = (values.astype(dt) >= lo) & (values.astype(dt) <= hi)
        out.append(np.sum(cube[y][band][:, :int(p["QUANTITY"])], dtype=dt))
    return out


def finish(parts, params, dt):
    return Answer([[float(np.sum(np.asarray(parts, dtype=dt), dtype=dt))]],
                  doubles=(0,))
