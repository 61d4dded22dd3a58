"""device_wait_ms: the mean over the window's queries of the union of
their ``device_wait`` spans' intervals, the executor's time blocked on the
card. Read where the program opens a span per plan node; None where it
does not."""

from program_spans import covered, named, traced


def read(ctx):
    vals = [1e3 * covered(named(got, "device_wait"))
            for got in traced(ctx)]
    return sum(vals) / len(vals) if vals else None
