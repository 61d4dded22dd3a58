"""Where TPC-H q1's time goes in the PyTorch engine, on one CUDA card.

    python3 -m trino_tpu_torch.profile_q1 [--schema sf10] [--reps 3]

Prints one JSON object: the card, warm q1 wall times, the table scan's
share (device generation + concat, timed alone), the device-busy share
from torch.profiler, and the kernels with the most device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _sync_wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    from .exec.executor import Executor
    from .plan.nodes import TableScanNode
    from .runner import LocalQueryRunner
    from .session import Session
    from .benchmarks.tpch_queries import TPCH_QUERIES

    q1 = TPCH_QUERIES[1]
    ap = argparse.ArgumentParser()
    ap.add_argument("--schema", default="sf10")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    runner = LocalQueryRunner(Session(catalog="tpch", schema=args.schema))
    cold = _sync_wall(lambda: runner.execute(q1))
    warm = [_sync_wall(lambda: runner.execute(q1))
            for _ in range(args.reps)]

    scan = runner.plan_sql(q1)
    while not isinstance(scan, TableScanNode):
        scan = scan.sources[0]
    ex = Executor(runner.catalogs, runner.session, runner.device)
    scan_s = [_sync_wall(lambda: ex.execute(scan))
              for _ in range(args.reps)]

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = _sync_wall(lambda: runner.execute(q1))
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # kernels are the device-side events; aten ops (host-side events)
    # carry the same time again as their kernels' total
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(ops, key=dev_us, reverse=True)[:12]
    warm_median = sorted(warm)[len(warm) // 2]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "schema": args.schema, "cold_s": cold,
        "warm_s": warm, "scan_s": scan_s, "profiled_wall_s": profiled,
        "device_busy_s": busy_s, "kernel_launches": sum(
            e.count for e in kernels),
        "busy_share_of_profiled_wall": busy_s / profiled,
        "busy_share_of_median_warm_wall": busy_s / warm_median,
        "top_device_ops": [
            {"name": e.key, "count": e.count, "device_ms": dev_us(e) / 1e3}
            for e in top]}))


if __name__ == "__main__":
    main()
