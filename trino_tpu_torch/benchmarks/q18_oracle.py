"""Independent numpy oracle for TPC-H q18 at any scale factor.

Counterpart of ``trino_tpu/benchmarks/q18_oracle.py`` (host numpy, over
the port's copy of the generator's field functions). Recomputes the q18 result straight from the generator's field functions
(no engine code in the loop) so engine runs at sf >= 1 — beyond what
the sqlite oracle tier can hold — still have an exact cross-check.
Reference measurement shape: BASELINE configs[3] (q18 large build-side
join + IN-subquery semi-join); validated the engine's q18@sf10 run
(100 rows, 2026-07-31) row-for-row.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..connectors.tpch import (_LineFields, _cust_key, _line_counts,
                               _order_date, _order_key, table_rows)


def q18_oracle(sf: float, limit: int = 100,
               qty_bar: float = 300.0) -> List[list]:
    """[[c_name, c_custkey, o_orderkey, o_orderdate(days), o_totalprice,
    sum_qty], ...] — q18's exact result, top ``limit`` by
    (totalprice DESC, orderdate ASC). Field values come from the
    connector's own _LineFields (one definition of the lineitem
    layout); only the per-order aggregation is local."""
    n_orders = table_rows("orders", sf)
    qty_sum = np.zeros(n_orders + 1, np.float64)
    total = np.zeros(n_orders + 1, np.float64)
    chunk = 1 << 21
    for lo in range(0, n_orders, chunk):
        hi = min(lo + chunk, n_orders)
        idx = np.arange(lo + 1, hi + 1, dtype=np.int64)
        counts = _line_counts(idx)
        order_rep = np.repeat(idx, counts)
        line_no = np.concatenate(
            [np.arange(1, c + 1) for c in counts]).astype(np.int64)
        lf = _LineFields(order_rep, line_no, sf)
        price = (lf.extendedprice * (1.0 + lf.tax)
                 * (1.0 - lf.discount))
        np.add.at(qty_sum, order_rep, lf.quantity)
        np.add.at(total, order_rep, price)
        total[lo + 1:hi + 1] = np.round(total[lo + 1:hi + 1], 2)
    sel = np.nonzero(qty_sum > qty_bar)[0]
    okey = _order_key(sel)
    ckey = _cust_key(sel, table_rows("customer", sf))
    odate = _order_date(sel)
    tp = total[sel]
    order = np.lexsort((odate, -tp))[:limit]
    return [[f"Customer#{ckey[i]:09d}", int(ckey[i]), int(okey[i]),
             int(odate[i]), float(tp[i]), float(qty_sum[sel[i]])]
            for i in order]
