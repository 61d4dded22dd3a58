"""device_waits_per_query: the mean over the window's queries of their
``device_wait`` spans, each a place where the executor's thread blocked
on the card (a row count, a total or lanes read to the host). Read where
the program opens a span per plan node; None where it does not."""

from program_spans import named, traced


def read(ctx):
    vals = [len(named(got, "device_wait"))
            for got in traced(ctx)]
    return sum(vals) / len(vals) if vals else None
