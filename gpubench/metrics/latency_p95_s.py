"""latency_p95_s: the 95th percentile (nearest rank) of the client's wall
of every query sent in the window, from its POST to its last page; a query
that failed or returned wrong rows counts as missing every limit."""

import math


def read(ctx):
    walls = sorted(r["done"] - r["sent"] if r["ok"] else math.inf
                   for r in ctx.records)
    if not walls:
        return None
    p95 = walls[max(math.ceil(0.95 * len(walls)) - 1, 0)]
    return p95 if math.isfinite(p95) else 1e300
