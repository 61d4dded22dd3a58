"""plan_ms: the front end's time a query, the mean over the window's
queries of the parse, plan and optimize spans that the coordinator's
runner records for each."""


def read(ctx):
    vals = []
    for r in ctx.records:
        spans = ctx.spans.get(r["qid"]) or ()
        got = [e - s for n, s, e in spans if n in ctx.plan_spans]
        if got:
            vals.append(sum(got) * 1e3)
    return sum(vals) / len(vals) if vals else None
