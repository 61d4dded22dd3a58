"""A whole run on the CPU at tpch.tiny, with the harness's look for a card
skipped: sound runs come out correct, and runs with the timed path broken
underneath come out not correct (an answer altered where it is produced;
half of each scan's rows left out)."""

import json
import time

import pytest

import _paths

import harness

CELLS = ["tpch_sf10_cached.scan_agg", "tpch_sf10_cached.joins"]


def bench():
    return json.loads((_paths.ROOT / "BENCHMARK.json").read_text())


def run(cell, seed=2**31 + 7, trace=False, records_path=None):
    return harness.run_cell(bench(), cell, seed, 1.5, trace,
                            time.perf_counter(), device="cpu",
                            schema="tiny", ref_threads=2,
                            records_path=records_path)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tmp_path):
    records = tmp_path / "records.jsonl"
    out = run(cell, records_path=str(records))
    lines = [json.loads(line) for line in records.read_text().splitlines()]
    assert len(lines) == out["attempted"] and all(r["ok"] for r in lines)
    assert out["correct"], out
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"queries_per_s", "latency_p95_s",
                                   "setup_s"}
    assert list(out)[-1] == "compared"
    assert set(out) <= {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "compared"}


def test_a_traced_run_reads_the_per_layer_metrics():
    out = run(CELLS[0], trace=True)
    assert out["correct"], out
    assert {"protocol_ms", "plan_ms", "device_idle_share"} <= set(
        out["metrics"])
    assert "breakdown" in out and out["device"]["window_s"] > 0


def altered_answer(monkeypatch):
    from trino_tpu_torch.runner import LocalQueryRunner
    inner = LocalQueryRunner._run_query

    def run_query(self, stmt, collect_stats=None):
        res = inner(self, stmt, collect_stats)
        for row in res.rows:
            for i, v in enumerate(row):
                if isinstance(v, float):
                    row[i] = v * (1 + 1e-6)
                    return res
        return res
    monkeypatch.setattr(LocalQueryRunner, "_run_query", run_query)


def half_the_rows(monkeypatch):
    from trino_tpu_torch.columnar import slice_rows
    from trino_tpu_torch.exec.executor import Executor
    inner = Executor._read_split

    def read_split(self, conn, split, columns, device=None):
        b = inner(self, conn, split, columns, device)
        return slice_rows(b, 0, b.num_rows_host() // 2)
    monkeypatch.setattr(Executor, "_read_split", read_split)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [altered_answer, half_the_rows])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out


@pytest.mark.gpu
def test_a_run_on_the_card_at_tiny():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = harness.run_cell(bench(), CELLS[0], 11, 2.0, True,
                           time.perf_counter(), schema="tiny")
    assert out["correct"] and out["device"]["platform"] == "gpu", out
