"""The spans a query's trace holds, as the harness reads them
(``harness.query_spans``: (name, start, end) on the host's perf_counter),
for the metrics that read the executor's spans."""


def traced(ctx):
    """The spans of each query of the window whose trace has the
    executor's ``node.<Name>`` spans; none where the program opens no
    such span."""
    for r in ctx.records:
        got = ctx.spans.get(r["qid"]) or ()
        if any(n.startswith("node.") for n, _, _ in got):
            yield got


def named(got, name):
    return [sp for sp in got if sp[0] == name]


def covered(got) -> float:
    """Seconds of the union of the spans' intervals."""
    total, end = 0.0, None
    for _, s, e in sorted(got, key=lambda sp: sp[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
