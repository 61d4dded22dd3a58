"""Where a TPC-H or TPC-DS query's time goes in the PyTorch engine, on one
CUDA card.

    python3 -m trino_tpu_torch.profile_q1 [--catalog tpch|tpcds]
                                          [--query 1] [--schema sf10]
                                          [--reps 3] [--max-batch-rows N]

Prints one JSON object: the card, cold and warm wall times of the query,
the per-layer split of ``--reps`` more runs (the scan of each table,
joins, aggregations, expressions, windows, set operations (UNION,
INTERSECT, EXCEPT), GroupId copies, sort/TopN: the card is synchronised
around every plan node, and each node's own time goes to its layer; a
spilled join's copies to host memory and back count to the join), the
running peak of device memory after each plan node of the first of those
runs, the bytes spilled, the device-busy share from torch.profiler, and
the operators with the most device time. ``--max-batch-rows`` sets the
largest join output kept on the card as one batch (beyond it the join
spills to host memory), to compare a query with and without the spill.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Tuple

import torch

from .config import CONFIG
from .exec.executor import Executor

# plan node -> layer; Filter and Project nodes are "expressions", and a
# filter folded into an aggregation counts toward the aggregation
_LAYERS = {"TableScanNode": "scan", "JoinNode": "join",
           "SemiJoinNode": "join", "SemiJoinMultiNode": "join",
           "AggregationNode": "aggregation", "SortNode": "sort_topn",
           "TopNNode": "sort_topn", "FilterNode": "expressions",
           "ProjectNode": "expressions", "WindowNode": "window",
           "UnionNode": "set_op", "SetOpNode": "set_op",
           "GroupIdNode": "group_id"}


def _sync_wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class TimedExecutor(Executor):
    """An executor that synchronises the card around every plan node and
    adds each node's own wall time (its time less its children's) to the
    node's layer in ``layers``."""

    def __init__(self, *args):
        super().__init__(*args)
        self.layers: Dict[str, float] = {}
        # (plan node, device memory peak in bytes so far) as nodes finish
        self.peaks: List[Tuple[str, int]] = []
        self._children_s = 0.0

    def execute(self, node):
        outer, self._children_s = self._children_s, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().execute(node)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        layer = _LAYERS.get(type(node).__name__, "other")
        if layer == "scan":
            layer = f"scan.{node.handle.table}"
        self.layers[layer] = (self.layers.get(layer, 0.0) + total
                              - self._children_s)
        self._children_s = outer + total
        self.peaks.append((type(node).__name__,
                           torch.cuda.max_memory_allocated()))
        return out


def main() -> None:
    from .runner import LocalQueryRunner
    from .session import Session
    from .benchmarks.tpcds_queries import TPCDS_QUERIES
    from .benchmarks.tpch_queries import TPCH_QUERIES

    ap = argparse.ArgumentParser()
    ap.add_argument("--catalog", choices=("tpch", "tpcds"), default="tpch")
    ap.add_argument("--query", type=int, default=1)
    ap.add_argument("--schema", default="sf10")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-batch-rows", type=int, default=None)
    args = ap.parse_args()
    if args.max_batch_rows is not None:
        CONFIG.max_batch_rows = args.max_batch_rows
    sql = (TPCH_QUERIES if args.catalog == "tpch"
           else TPCDS_QUERIES)[args.query]

    runner = LocalQueryRunner(Session(catalog=args.catalog,
                                      schema=args.schema))
    cold = _sync_wall(lambda: runner.execute(sql))
    warm = [_sync_wall(lambda: runner.execute(sql))
            for _ in range(args.reps)]
    plan = runner.plan_sql(sql)
    layers, peaks, spilled = [], None, []
    for _ in range(args.reps):
        ex = TimedExecutor(runner.catalogs, runner.session, runner.device)
        torch.cuda.reset_peak_memory_stats()
        ex.execute(plan)
        layers.append(ex.layers)
        peaks = peaks or ex.peaks
        spilled.append(ex.spilled_bytes)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = _sync_wall(lambda: runner.execute(sql))
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
        "card": card, "catalog": args.catalog, "query": args.query,
        "schema": args.schema,
        "max_batch_rows": CONFIG.max_batch_rows,
        "cold_s": cold, "warm_s": warm, "layers_s": layers,
        "node_peak_bytes": peaks, "spill_bytes": spilled,
        "profiled_wall_s": profiled,
        "device_busy_s": busy_s, "kernel_launches": sum(
            e.count for e in kernels),
        "busy_share_of_profiled_wall": busy_s / profiled,
        "busy_share_of_median_warm_wall": busy_s / warm_median,
        "top_device_ops": [
            {"name": e.key, "count": e.count, "device_ms": dev_us(e) / 1e3}
            for e in top]}))


if __name__ == "__main__":
    main()
