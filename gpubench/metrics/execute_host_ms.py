"""execute_host_ms: the mean over the window's queries of the ``execute``
span's wall less the part of it that their ``device_wait`` spans cover:
the executor's host time, the waits for the interpreter lock included.
Read where the program opens a span per plan node; None where it does
not."""

from program_spans import covered, named, traced


def read(ctx):
    vals = []
    for got in traced(ctx):
        host = 0.0
        for _, s, e in named(got, "execute"):
            waits = [("", max(a, s), min(b, e))
                     for _, a, b in named(got, "device_wait")
                     if a < e and b > s]
            host += (e - s) - covered(waits)
        vals.append(1e3 * host)
    return sum(vals) / len(vals) if vals else None
