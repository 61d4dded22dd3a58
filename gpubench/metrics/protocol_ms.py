"""protocol_ms: the server and protocol layer's share of a query, the
mean over the window's queries of the client's wall minus the
``elapsedTimeMillis`` of the query's last page (the coordinator's own
count from its creation, in whole ms)."""


def read(ctx):
    vals = [(r["done"] - r["sent"]) * 1e3 - r["elapsed_ms"]
            for r in ctx.records
            if r["error"] is None and r["elapsed_ms"] is not None]
    return sum(vals) / len(vals) if vals else None
