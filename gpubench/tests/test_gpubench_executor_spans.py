"""The metrics that read the executor's spans (``node.<Name>``,
``device_wait``), in a traced whole run on the CPU at tpch.tiny: each is
reported, finite and non-negative, and the executor's host time is no
more than the ``execute`` span's mean wall."""

import json
import math
import time

import _paths

import harness

NEW = ("device_waits_per_query", "device_wait_ms", "execute_host_ms")


def test_a_traced_run_reads_the_executor_span_metrics(monkeypatch):
    seen = []
    inner = harness.reader

    def reader(name):
        read = inner(name)

        def keep(ctx):
            seen.append(ctx)
            return read(ctx)
        return keep
    monkeypatch.setattr(harness, "reader", reader)
    bench = json.loads((_paths.ROOT / "BENCHMARK.json").read_text())
    out = harness.run_cell(bench, "tpch_sf10_cached.joins", 2**31 + 11, 1.5,
                           True, time.perf_counter(), device="cpu",
                           schema="tiny", ref_threads=2)
    assert out["correct"], out
    got = {n: out["metrics"][n]["value"] for n in NEW}
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    # q3, q12 and q14 each read a join's output size to the host
    assert got["device_waits_per_query"] > 0
    ctx = seen[0]
    walls = [e - s for r in ctx.records
             for n, s, e in ctx.spans.get(r["qid"], ()) if n == "execute"]
    assert got["execute_host_ms"] <= 1e3 * sum(walls) / len(walls)
