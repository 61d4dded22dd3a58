"""Smoke run of the PyTorch engine (trino_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel from trino_tpu_torch/csrc, drives TPC-H q1 at
tpch.sf10 through ``trino_tpu_torch.runner.LocalQueryRunner().execute``,
holds each kernel against its plain PyTorch version, and checks q1's rows
against an independent numpy reference. Each phase prints one JSON line;
the line before the last lists the kernels, the last line is the result.
Any failed phase exits non-zero without printing a result, as does a
machine without CUDA.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import time

import numpy as np
import torch

SCHEMA = "sf10"
DEVICE = torch.device("cuda")
SUM_REL = 1e-9          # f64 on both sides; only the summation order differs
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
FP64_OPS_PER_S = 67e12      # H100 SXM FP64 tensor-core peak (data sheet)
Q1_COLS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate"]


class PhaseFailed(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


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


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return card


def phase_build(cuda_groupby):
    t0 = time.perf_counter()
    cuda_groupby.build()
    info = cuda_groupby.BUILD_INFO
    ptxas = [ln.strip() for ln in str(info.get("ptxas", "")).splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="grouped_sums", seconds=time.perf_counter() - t0,
         compiled=info.get("compiled"), ptxas=ptxas)


def q1_reference(batch, cutoff_days: int):
    """q1 with numpy alone: filter, then np.bincount with weights over the
    lanes the device generated, copied to the host."""
    n = batch.num_rows_host()
    lane = {c: batch.column(c).data[:n].cpu().numpy() for c in Q1_COLS}
    flags = batch.column("l_returnflag").dictionary.values
    stats = batch.column("l_linestatus").dictionary.values
    keep = lane["l_shipdate"] <= cutoff_days
    key = (lane["l_returnflag"].astype(np.int64) * len(stats)
           + lane["l_linestatus"])[keep]
    nkey = len(flags) * len(stats)
    qty = lane["l_quantity"][keep]
    price = lane["l_extendedprice"][keep]
    disc = lane["l_discount"][keep]
    tax = lane["l_tax"][keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)

    def s(w):
        return np.bincount(key, weights=w, minlength=nkey)
    cnt = np.bincount(key, minlength=nkey)
    sums = [s(qty), s(price), s(disc_price), s(charge)]
    avgs = [s(qty), s(price), s(disc)]
    rows = []
    for g in range(nkey):
        if cnt[g] == 0:
            continue
        rows.append([str(flags[g // len(stats)]), str(stats[g % len(stats)])]
                    + [float(x[g]) for x in sums]
                    + [float(x[g] / cnt[g]) for x in avgs] + [int(cnt[g])])
    rows.sort(key=lambda r: (r[0], r[1]))
    return rows, n


def rows_match(got, want) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                if abs(a - b) > SUM_REL * abs(b):
                    return False
            elif a != b:
                return False
    return True


def phase_q1(runner_mod, session_mod, cuda_groupby, q1):
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=SCHEMA))
    torch.cuda.reset_peak_memory_stats()
    cuda_groupby.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = runner.execute(q1)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = cuda_groupby.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    warm_result = runner.execute(q1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(launches >= 1, "q1 did not launch grouped_sums")
    check(warm_result.rows == result.rows, "q1 rows differ between runs")
    return result.rows, launches, cold, warm, peak


def phase_q1_check(rows, tpch_mod, device_mod, cold, warm, launches, peak):
    sf = tpch_mod.SCHEMAS[SCHEMA]
    orders = tpch_mod.table_rows("orders", sf)
    # the whole table in one generation call: the same pure function of
    # the row index as the engine's per-split scan
    lineitem = device_mod.lineitem_batch(0, orders, sf, Q1_COLS,
                                         DEVICE)
    cutoff = (datetime.date(1998, 12, 1) - datetime.timedelta(days=90)
              - datetime.date(1970, 1, 1)).days
    want, nrows = q1_reference(lineitem, cutoff)
    del lineitem
    torch.cuda.empty_cache()
    ok = rows_match(rows, want)
    emit("q1", schema=f"tpch.{SCHEMA}", rows=len(rows),
         lineitem_rows=nrows, grouped_sums_launches=launches,
         cold_s=cold, warm_s=warm, warm_rows_per_s=nrows / warm,
         max_memory_allocated=peak, matches_numpy_reference=ok,
         first_row=rows[0] if rows else None)
    check(ok, "q1 rows differ from the numpy reference")

    # the device generator against the port's numpy host generator on a
    # few sf10 order ranges (both ends and the middle)
    host = tpch_mod.TpchConnector(device="cpu")
    ranges = [(0, 20_000), (orders // 2, orders // 2 + 20_000),
              (orders - 20_000, orders)]
    for lo, hi in ranges:
        dev = device_mod.lineitem_batch(
            lo, hi, sf, sorted(device_mod.LINEITEM_DEVICE_COLS),
            DEVICE)
        ref = host._lineitem(np.arange(lo + 1, hi + 1, dtype=np.int64), sf,
                             sorted(device_mod.LINEITEM_DEVICE_COLS))
        n = ref.num_rows_host()
        check(dev.num_rows_host() == n, f"generator row count {lo}-{hi}")
        for name in ref.names:
            a = dev.column(name).data[:n].cpu().numpy()
            b = ref.column(name).data[:n].numpy()
            check(np.array_equal(a, b), f"generator lane {name} {lo}-{hi}")
    emit("generator", schema=f"tpch.{SCHEMA}", ranges=ranges,
         bit_identical_to_numpy=True)


def _q1_lanes(cap: int, nseg: int, seed: int):
    """q1-shaped kernel inputs: packed ids (some rows dead or outside the
    domain) and K = 19 f64 lanes (live, count(*), 7 sums x (value, mask),
    3 avg counts), from a numpy seed."""
    rng = np.random.default_rng(seed)
    dev = DEVICE
    gid = torch.from_numpy(
        rng.integers(0, nseg + 2, cap).astype(np.int32)).to(dev)
    qty = torch.from_numpy(rng.integers(1, 51, cap).astype(np.float64)).to(dev)
    price = torch.from_numpy(
        np.round(rng.uniform(901, 104950, cap), 2)).to(dev)
    disc = torch.from_numpy(rng.integers(0, 11, cap) / 100.0).to(dev)
    live = (gid < nseg).to(torch.float64)
    one = torch.ones_like(live)
    values = [qty, price, price * (1 - disc), price * (1 - disc) * 1.04,
              qty, price, disc]
    # every lane its own tensor, as in the engine: a lane read twice
    # would come from L2 and flatter the kernel
    lanes = [live, one]
    for v in values:
        lanes += [v * live, live.clone()]
    lanes += [live.clone() for _ in range(3)]
    counts = [0, 1] + [3 + 2 * i for i in range(7)] + [16, 17, 18]
    return gid, lanes, counts


def compare(cg, gid, lanes, nseg, count_idx):
    """(max abs err, max rel err, bit-identical) of the kernel against the
    plain version; raises on a count that is not exact."""
    got = cg.grouped_sums(gid, lanes, nseg)
    again = cg.grouped_sums(gid, lanes, nseg)
    want = cg.grouped_sums_plain(gid, lanes, nseg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    abs_err = rel_err = 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        if i in count_idx:
            check(torch.equal(a, w), f"count lane {i} not exact")
        d = (a - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / w.abs().clamp(min=1e-300))
                                     .max()))
    return abs_err, rel_err, same


def phase_kernel(cg):
    nseg, cap = 12, 1 << 26
    gid, lanes, counts = _q1_lanes(cap, nseg, seed=1)
    k = len(lanes)
    abs_err, rel_err, same = compare(cg, gid, lanes, nseg, set(counts))
    check(rel_err <= SUM_REL, f"grouped_sums rel err {rel_err}")
    check(same, "two grouped_sums launches differ")
    ms = cuda_ms(lambda: cg.grouped_sums(gid, lanes, nseg), 10)
    plain_ms = cuda_ms(lambda: cg.grouped_sums_plain(gid, lanes, nseg), 3)
    # yardstick: one PyTorch call computing the same function on the same
    # inputs laid out as [cap, K] (the layout copy is not timed)
    stacked = torch.stack(lanes, dim=1)
    dest = torch.where(gid < nseg, gid, nseg).to(torch.int64)
    acc = torch.zeros((nseg + 1, k), dtype=torch.float64, device=DEVICE)

    def library():
        acc.zero_()
        acc.index_add_(0, dest, stacked)
    library_ms = cuda_ms(library, 3)
    lib_err = float((acc[:nseg].T - torch.stack(
        cg.grouped_sums_plain(gid, lanes, nseg))).abs().max())
    del stacked, dest, acc
    nbytes = k * cap * 8 + cap * 4 + k * nseg * 8
    ops = k * cap
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP64_OPS_PER_S * 1e3
    emit("kernel", name="grouped_sums", cap=cap, lanes=k, nseg=nseg,
         max_abs_err=abs_err, max_rel_err=rel_err, bit_identical=same,
         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         library_max_abs_err=lib_err, bytes=nbytes, ops=ops,
         bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms)
    del gid, lanes
    torch.cuda.empty_cache()

    # edges: every row dead; ids past the domain; the widest domain
    rng = np.random.default_rng(2)
    edge_cap = 1 << 20
    dev = DEVICE
    vals = torch.from_numpy(np.round(rng.uniform(-1e4, 1e4, edge_cap), 2)
                            ).to(dev)
    ones = torch.ones(edge_cap, dtype=torch.float64, device=dev)
    edges = {
        "all_dead": (torch.full((edge_cap,), 12, dtype=torch.int32,
                                device=dev), 12),
        "ids_past_domain": (torch.from_numpy(rng.integers(
            -5, 200, edge_cap).astype(np.int32)).to(dev), 12),
        "nseg_64": (torch.from_numpy(rng.integers(
            0, 64, edge_cap).astype(np.int32)).to(dev), 64),
    }
    for name, (g, ns) in edges.items():
        e_abs, e_rel, e_same = compare(cg, g, [vals, ones], ns, {1})
        check(e_rel <= SUM_REL and e_same, f"edge {name}")
        emit("kernel_edge", case=name, nseg=ns, max_abs_err=e_abs,
             max_rel_err=e_rel, bit_identical=e_same)
    return dict(name="grouped_sums", route="cuda",
                source="trino_tpu_torch/csrc/grouped_sums.cu",
                replaces="trino_tpu/ops/pallas_groupby.py:102",
                max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from trino_tpu_torch import runner as runner_mod
        from trino_tpu_torch import session as session_mod
        from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
        from trino_tpu_torch.connectors import tpch as tpch_mod
        from trino_tpu_torch.connectors import tpch_device as device_mod
        from trino_tpu_torch.ops import cuda_groupby
    except ImportError as e:
        print(f"chip_smoke: the trino_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    try:
        card = phase_device()
        phase_build(cuda_groupby)
        rows, launches, cold, warm, peak = phase_q1(
            runner_mod, session_mod, cuda_groupby, TPCH_QUERIES[1])
        phase_q1_check(rows, tpch_mod, device_mod, cold, warm, launches,
                       peak)
        kernel = phase_kernel(cuda_groupby)
    except PhaseFailed as e:
        print(f"chip_smoke: phase failed: {e}", file=sys.stderr)
        return 1
    kernel["launches"] = launches
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
