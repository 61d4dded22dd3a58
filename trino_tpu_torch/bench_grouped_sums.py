"""The grouped_sums kernel on one CUDA card: its result against its plain
version, and its time beside its bound and beside ``index_add_``.

    python3 -m trino_tpu_torch.bench_grouped_sums [--parent DIR]

Without arguments it measures this tree's wrapper at the shapes TPC-H q1
gives the kernel (``SHAPES``) and at one large shape no path gives it
(``STREAM_SHAPE``). ``--parent DIR`` names another checkout (for example
an unpacked ``git archive`` of the parent commit): its
``trino_tpu_torch/ops/cuda_groupby.py`` is loaded from its file and both
wrappers are measured on the same inputs in turns (parent, this, this,
parent), so that the two are compared within one call on one card. One
JSON line per measurement. ``chip_smoke.py`` uses ``measure`` for its
``kernel_split`` lines.

Times, per call:

- ``ms``: back-to-back Python calls between two CUDA events, what a
  caller sees (the host's enqueue time where it exceeds the card's);
- ``device_ms``: the card's own time, from a CUDA graph that holds one
  call per copy of the inputs, replayed between events; the copies are
  enough to exceed twice the 50 MB L2 cache, so each call reads its
  inputs from device memory (``device_warm_ms``: one copy, replayed, as
  a caller finds lanes it has just written);
- ``host_us``: the wrapper's enqueue time, ``time.perf_counter`` around
  calls with no synchronisation inside;
- ``plain_ms``, ``library_ms``, ``library_device_ms``: the plain PyTorch
  version and one ``index_add_`` over the same inputs laid out [cap, K]
  (the layout copy is not timed), the latter also by graph replay.

The bound is the larger of the bytes the function must move (every lane
and the id lane read once, the sums written once) over 3.35 TB/s and its
K * cap f64 additions over 67 TFLOP/s (NVIDIA's H100 SXM data sheet).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
FP64_OPS_PER_S = 67e12      # H100 SXM FP64 tensor-core peak (data sheet)
L2_BYTES = 50 << 20
# (rows, lanes, groups) that TPC-H q1 gives the kernel on the card: the
# folds of q1_sf100, the combine of q1 at sf10, the splits
SHAPES = [(32, 15, 12), (2048, 15, 12), (131072, 19, 12), (262144, 19, 12)]
# q1's whole-table shape at sf10 before its aggregation went split by
# split, which no path gives now: it shows the streaming rate (about
# 10.5 GB of lanes)
STREAM_SHAPE = (1 << 26, 19, 12)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fns, reps: int) -> float:
    """The card's time for one call: every call of ``fns`` captured once
    in a CUDA graph (warmed up first on the capture stream), the graph
    replayed ``reps`` times between events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


def host_us(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def q1_lanes(cap: int, nseg: int, seed: int, k: int = 19,
             device="cuda"):
    """q1-shaped kernel inputs from a numpy seed: (gid, lanes, indices of
    the 0/1 count lanes). ``gid`` holds packed ids, some rows dead (id
    nseg) or outside the domain (nseg + 1); ``lanes`` is one f64 [K, ld]
    buffer, ld = cap rounded up to even, as ops/groupby.py lays the lanes
    out: K = 19 (live, count(*), 7 sums x (value, mask), 3 avg counts), or
    for another ``k`` the combine's shape, a count lane and k - 1 partial
    sums."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    gid = torch.from_numpy(
        rng.integers(0, nseg + 2, cap).astype(np.int32)).to(dev)
    live = (gid < nseg).to(torch.float64)
    buf = torch.empty((k, cap + cap % 2), dtype=torch.float64, device=dev)
    rows = buf[:, :cap]
    if k != 19:
        rows[0] = live * torch.from_numpy(
            rng.integers(1, 1 << 20, cap).astype(np.float64)).to(dev)
        for i in range(1, k):
            rows[i] = live * torch.from_numpy(
                np.round(rng.uniform(0, 1e12, cap), 2)).to(dev)
        return gid, buf, [0]
    qty = torch.from_numpy(rng.integers(1, 51, cap).astype(np.float64)).to(
        dev)
    price = torch.from_numpy(
        np.round(rng.uniform(901, 104950, cap), 2)).to(dev)
    disc = torch.from_numpy(rng.integers(0, 11, cap) / 100.0).to(dev)
    values = [qty, price, price * (1 - disc), price * (1 - disc) * 1.04,
              qty, price, disc]
    rows[0] = live
    rows[1] = 1.0
    for i, v in enumerate(values):
        rows[2 + 2 * i] = v * live
        rows[3 + 2 * i] = live
    rows[16:19] = live
    counts = [0, 1] + [3 + 2 * i for i in range(7)] + [16, 17, 18]
    return gid, buf, counts


def compare(cg, gid, lanes, nseg: int, count_idx):
    """(max abs err, max rel err, bit-identical, launches a call) of the
    kernel against the plain version; raises on a count that is not
    exact."""
    before = cg.LAUNCHES
    got = cg.grouped_sums(gid, lanes, nseg)
    again = cg.grouped_sums(gid, lanes, nseg)
    launches = (cg.LAUNCHES - before) / 2
    want = cg.grouped_sums_plain(gid, lanes, nseg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    abs_err = rel_err = 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        if i in count_idx and not torch.equal(a, w):
            raise AssertionError(f"count lane {i} not exact")
        d = (a - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / w.abs().clamp(min=1e-300))
                                     .max()))
    return abs_err, rel_err, same, launches


def measure(cg, cap: int, k: int, nseg: int, seed: int) -> dict:
    """grouped_sums of the wrapper module ``cg`` at ``cap`` rows, ``k``
    lanes and ``nseg`` groups, against its plain version, timed (see the
    module's docstring) beside its bound and ``index_add_``."""
    gid, buf, counts = q1_lanes(cap, nseg, seed=seed, k=k)
    k = buf.shape[0]
    abs_err, rel_err, same, per_call = compare(cg, gid, buf, nseg,
                                               set(counts))
    nbytes = k * cap * 8 + cap * 4 + k * nseg * 8
    ops = k * cap
    reps = max(10, min(1000, (1 << 30) // (cap * k * 8)))

    def call(g=gid, b=buf):
        return cg.grouped_sums(g, b, nseg)
    ms = cuda_ms(call, reps)
    host = host_us(call, min(reps, 200))
    # copies of the inputs, so that a replayed call misses the L2 cache
    copies = [(gid, buf)]
    ncopies = 1 if nbytes >= 2 * L2_BYTES else \
        min(8, math.ceil(2 * L2_BYTES / nbytes))
    for _ in range(ncopies - 1):
        copies.append((gid.clone(), buf.clone()))
    greps = max(3, reps // ncopies)
    device_ms = graph_ms([lambda g=g, b=b: cg.grouped_sums(g, b, nseg)
                          for g, b in copies], greps)
    device_warm_ms = graph_ms([call], reps)
    del copies
    plain_ms = cuda_ms(lambda: cg.grouped_sums_plain(gid, buf, nseg),
                       max(3, reps // 10))
    # yardstick: one PyTorch call computing the same function on the same
    # inputs laid out as [cap, K]
    stacked = buf[:, :cap].T.contiguous()
    dest = torch.where((gid >= 0) & (gid < nseg), gid, nseg).to(
        torch.int64)
    acc = torch.zeros((nseg + 1, k), dtype=torch.float64,
                      device=gid.device)

    def library(a=acc, d=dest, s=stacked):
        a.zero_()
        a.index_add_(0, d, s)
    library_ms = cuda_ms(library, max(3, reps // 10))
    lib_err = float((acc[:nseg].T - torch.stack(list(
        cg.grouped_sums_plain(gid, buf, nseg)))).abs().max())
    lib_copies = [library]
    for _ in range(ncopies - 1):
        a = torch.zeros_like(acc)
        lib_copies.append(lambda a=a, d=dest.clone(), s=stacked.clone():
                          library(a, d, s))
    library_device_ms = graph_ms(lib_copies, max(3, reps // 10 // ncopies))
    del stacked, dest, acc, lib_copies, gid, buf
    torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP64_OPS_PER_S * 1e3
    return dict(cap=cap, lanes=k, nseg=nseg, max_abs_err=abs_err,
                max_rel_err=rel_err, bit_identical=same,
                launches_per_call=per_call, ms=ms, device_ms=device_ms,
                device_warm_ms=device_warm_ms, host_us=host,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms,
                library_max_abs_err=lib_err, bytes=nbytes, ops=ops,
                bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                reps=reps, input_copies=ncopies)


def load_wrapper(root: Path, name: str):
    """``trino_tpu_torch/ops/cuda_groupby.py`` of the checkout ``root``,
    loaded from its file under ``name`` (it builds from its own
    ``csrc``)."""
    path = Path(root) / "trino_tpu_torch" / "ops" / "cuda_groupby.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose wrapper is measured in "
                         "turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_grouped_sums: CUDA is not available")
        return 2
    from trino_tpu_torch.ops import cuda_groupby as this
    wrappers = {"this": this}
    if args.parent is not None:
        wrappers["parent"] = load_wrapper(args.parent, "parent_cuda_groupby")
    print(json.dumps({"card": card_line(),
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    for name, cg in wrappers.items():
        t0 = time.perf_counter()
        cg.build()
        print(json.dumps({"build": name, "seconds": time.perf_counter() - t0,
                          "ptxas": [ln.strip() for ln in str(
                              cg.BUILD_INFO.get("ptxas", "")).splitlines()
                              if "registers" in ln or "spill" in ln]}),
              flush=True)
    order = ["parent", "this", "this", "parent"] \
        if args.parent is not None else ["this"]
    for i, (cap, k, nseg) in enumerate(SHAPES + [STREAM_SHAPE]):
        for turn, name in enumerate(order):
            row = measure(wrappers[name], cap, k, nseg, seed=3 + i)
            print(json.dumps({"wrapper": name, "turn": turn,
                              "path": "none" if (cap, k, nseg)
                              == STREAM_SHAPE else "q1", **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
