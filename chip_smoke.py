"""Smoke run of the PyTorch engine (trino_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel from trino_tpu_torch/csrc, drives TPC-H q1, q3,
q6, q9, q12, q14 and q18 at tpch.sf10, q1, q6 and q3 at tpch.sf100 (600M
lineitem rows: beyond one card's memory budget, so the scans stream), q18
at tpch.sf10 under a memory budget that makes its join stream, and TPC-DS
q64, q47, q36, q38 and q78 at tpcds.sf10 through
``trino_tpu_torch.runner.LocalQueryRunner().execute``, holds each kernel
against its plain PyTorch version at every shape those runs gave it, and
checks each TPC-H query's rows
against an independent numpy reference over the lanes the card generates
(themselves held bit-identical to the numpy generators) and the tables the
host generates; at sf100 the references read the card's lanes range by
range, each sf100 query must peak under 20 GiB of device memory, and
q3's lineitem-orders join must stream there (the sf100 queries run once
each, with no warm repeat). q3 at sf10 runs four times; its rows must be
bit-identical every time. q18 must spill its join outputs to host
memory. Each TPC-DS query runs once (cold); at
tpcds.sf1 its rows on the card must equal the engine's own rows on the
CPU; q38 at sf10 must equal a numpy count over the connector's lanes, and
q64 must return rows (the relaxed variant of tests/test_tpcds.py where
the spec text is empty).
The aggregate phases run at tpch.sf10: the statistical family, checksum
and the bitwise kinds split by split through grouped_sums against numpy
over exact sums (``agg_stats``), min_by/max_by and approx_percentile over
all 60M rows at once against numpy with the first-row tie rule
(``agg_order``), approx_set/merge/cardinality against a numpy sketch and
within 3 standard errors of the exact distinct count (``agg_hll``); at
tpch.sf1 the card's rows of those queries equal the engine's on the CPU
(``agg_sf1_cpu``). ``scalar_sf10`` drives the scalar functions and the
time lanes at tpch.sf10, cold and warm, against numpy: lineitem's packed
GROUP BY through grouped_sums over bitwise, width_bucket, date_diff, a
named zone's hour across DST, date_trunc, year_of_week and crc32;
orders grouped on a TIMESTAMP WITH TIME ZONE key; the digests and
hashes of every customer name against hashlib, zlib and a numpy
xxHash64. ``complex_sf10`` drives ARRAY, MAP and ROW columns at
tpch.sf10, cold and warm, against numpy: an UNNEST WITH ORDINALITY
unpivot of lineitem and array_agg of each order's line items through
the orders join, each grouped through grouped_sums, lambdas over the
arrays, histograms, a map_filter and a ROW field; then t- and q-digests
at tpch.sf1, the card against the CPU and numpy's exact quantiles.
``files_sf10`` writes tpch.sf10 lineitem's q1 columns to a Parquet file
and an ORC file (CREATE TABLE AS into two localfile catalogs, each in a
temporary directory of its own, with plan validation on) and runs q1 and
q6 over each copy, cold and warm, against the q1 and q6 phases' rows,
with each read's wall, decode rate, peak and aggregation route; DROP
TABLE removes the files, which are gone when the phase ends, failed or
not (about 5 GB of the temporary directory while it runs). Then
``jdbc_sf1`` loads tpch.sf1 orders into sqlite behind the jdbc connector
and checks that a grouped query's domain reaches the remote SQL and its
rows equal tpch.sf1's. ``geo_sf10`` runs ST_Contains over three polygons
(one with a hole, one with ten edges), great_circle_distance and
ST_Distance over tpch.sf10 lineitem, grouped through grouped_sums, cold
and warm, against a numpy ray cast of separate IEEE steps (the count
exact) and fsum. ``server_sf10`` puts one port Coordinator() on the card
over the sf10 phases' catalogs and drives it only over loopback HTTP
(the port's StatementClient and DB-API): q1, q6, q3 and q12 from four
clients at once against the rows those phases held to numpy, a 24k-row
result paged through nextUri, a qmark parameter, EXPLAIN ANALYZE of q1,
q9 past a 1 s query_max_run_time, and /metrics and
system.runtime.queries.

    python3 chip_smoke.py --server-only

runs only the q1, q3, q6 and q12 phases, ``server_sf10`` at the
coordinator's default 4 GiB scan cache (``server_sf10_default_cache``)
and at the 16 GiB of the whole run, and the kernel phase over the
shapes they gave.

``cluster_sf10`` (after ``server_sf10``) drives the cluster on the one
card over loopback HTTP: two TaskWorkerServer(device="cuda") in this
process behind a port Coordinator(worker_uris=...) run q1, q6, q3 and
q12 at tpch.sf10 through the stage DAG (rows equal to those phases',
each client wall beside ``server_sf10``'s), q1 on the flat leaf path,
and EXPLAIN ANALYZE of q1 (its aggregations on worker stages), with
grouped_sums launched in the workers' tasks and their shapes in the
kernel phase; then two worker processes (``python -m
trino_tpu_torch.server.main --role worker``), each a CUDA context of its
own, announce themselves to a second coordinator: q1, then q1 under
retry_policy=TASK with one worker process killed (SIGKILL) after the
coordinator's first task reached it, the rows the same and the retry
counter moved. It prints the exchange's frames and bytes and each
device's peak.

    python3 chip_smoke.py --cluster-only

runs only the q1, q3, q6 and q12 phases, ``cluster_sf10`` and the
kernel phase.

``stream_sf1`` (after ``cluster_sf10``) puts one port Coordinator() on
the card with a stream directory of its own: two producers POST the first
2,000,000 rows of tpch.sf1 lineitem as JSON to /v1/ingest while an
``insert`` job drains the topic into a memory table and a ``window`` job
keeps q1's rollup at or under its watermark; the offset ledger (no gap,
no duplicate), the sink (exactly once), the view and a grouped scan of
one partition's window must equal numpy, grouped_sums must launch in
the window job, /metrics must count the rows, cycles and commits, and
one cycle's trace must be valid OTLP. It prints ingest and decode
rates, each cycle's wall and the catch-up lag.

    python3 chip_smoke.py --stream-only

runs only ``stream_sf1`` and the kernel phase.

``mesh_sf10`` (after ``server_sf10``) runs the device mesh with four
shards on the one card, ``LocalQueryRunner(distributed=True,
n_devices=4)`` at tpch.sf10: q1, q6, q3 and q12, cold and warm, through
the stage DAG on the mesh (the default) and through the node-at-a-time
mesh executor (``ici_exchange=false``), and q3 with
``join_distribution_type='PARTITIONED'``, each against the rows the q1,
q6, q3 and q12 phases held to numpy, with the walls, the ICI bytes and
edges, each sharded scan's rows per shard, the peak, and grouped_sums'
launches by shape (into the kernel phase). ``prewarm_sf10`` (after
``cluster_sf10``) fills a port coordinator's hot-shape registry with q1
and q6 through one worker process, then starts a worker process with
the pre-warm and one without: the first must warm every served entry
without an error and be listed ``prewarmed``; each then runs q1 alone,
its wall printed, its rows the q1 phase's.

    python3 chip_smoke.py --mesh-only

runs only the q1, q3, q6 and q12 phases, ``mesh_sf10``,
``prewarm_sf10`` and the kernel phase.
Every phase prints its wall (``wall``), and ``walls`` lists them.
The kernel's lines (trino_tpu_torch/bench_grouped_sums.py) time each
call four ways: ``ms`` back to back as a caller sees it, ``device_ms``
by CUDA-graph replay, ``host_us`` the wrapper's enqueue, and the
``index_add_`` yardstick as ``library_ms`` and ``library_device_ms``.
Each phase prints one JSON line; the line before the last lists the
kernels, the last line is the result. Any failed phase exits non-zero
without printing a result, as does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SCHEMA = "sf10"
BIG_SCHEMA = "sf100"
BIG_RANGE_ORDERS = 4_000_000    # orders per range of the sf100 references
BIG_PEAK_BYTES = 20 << 30       # the 16 GiB budget plus the 4 GiB scan cache
DEVICE = torch.device("cuda")
SUM_REL = 1e-9          # f64 on both sides; only the summation order differs
Q1_COLS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate"]
Q3_L_COLS = ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"]
Q3_O_COLS = ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]
Q6_COLS = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
Q9_L_COLS = ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
             "l_extendedprice", "l_discount"]
Q12_L_COLS = ["l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate",
              "l_shipdate"]
Q14_L_COLS = ["l_partkey", "l_extendedprice", "l_discount", "l_shipdate"]
Q18_O_COLS = ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"]
WARM_REPS = 3
DS_SCHEMA = "sf10"
DS_CHECK_SCHEMA = "sf1"     # card rows against the engine's CPU rows
DS_FACT_TABLES = {"store_sales", "store_returns", "catalog_sales",
                  "catalog_returns", "web_sales", "web_returns",
                  "inventory"}
# the relaxed q64 of tests/test_tpcds.py: its five edits, as text
Q64_RELAXED_EDITS = [
    ("AND i_current_price BETWEEN 64 AND 74", ""),
    ("AND i_current_price BETWEEN 65 AND 79", ""),
    ("AND i_color IN ('purple', 'burlywood', 'indian', 'spring',\n"
     "                    'floral', 'medium')", ""),
    ("AND cs1.syear = 1999", ""),
    ("AND cs2.syear = 2000", ""),
]


class PhaseFailed(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


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
    cache0 = cache_stats()
    torch.cuda.reset_peak_memory_stats()
    result, cold, launches = cold_run("q1", runner, q1, cuda_groupby)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    warm_result = runner.execute(q1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(launches >= 1, "q1 did not launch grouped_sums")
    check(warm_result.rows == result.rows, "q1 rows differ between runs")
    return result.rows, launches, cold, warm, peak, dict(
        stream_fields(result), **cache_delta(cache0))


def days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


# grouped_sums launches by (rows, lanes, groups) and by phase, counted in
# the cold run of every phase: each shape the main paths give the kernel
SHAPES: dict = {}
# the launches by shape of the cold run under way (None outside of one)
# and of the last cold run
_COLD: dict = {"now": None, "last": {}}


def record_kernel_shapes(cg) -> None:
    """Count grouped_sums launches by (rows, lanes, groups) through the
    module attribute the engine calls, in cold runs only: one launch a
    call on the card (the wrapper's own count, checked against these by
    each phase, also moves under concurrent calls of other threads)."""
    inner = cg.grouped_sums

    def recording(gid, lanes, nseg):
        out = inner(gid, lanes, nseg)
        now = _COLD["now"]
        if now is not None and gid.is_cuda:
            key = (int(gid.shape[0]), len(lanes), int(nseg))
            now[key] = now.get(key, 0) + 1
        return out
    cg.grouped_sums = recording


def cold_run(phase: str, runner, sql: str, cuda_groupby):
    """(result, wall s, grouped_sums launches) of a cold run, its
    launches added to SHAPES under ``phase``."""
    cuda_groupby.LAUNCHES = 0
    _COLD["now"] = shapes = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = runner.execute(sql)
        torch.cuda.synchronize()
    finally:
        _COLD["now"] = None
    wall = time.perf_counter() - t0
    launches = cuda_groupby.LAUNCHES
    check(sum(shapes.values()) == launches,
          f"{phase}: launches by shape do not add up to the count")
    for key, n in shapes.items():
        by_phase = SHAPES.setdefault(key, {})
        by_phase[phase] = by_phase.get(phase, 0) + n
    _COLD["last"] = shapes
    return result, wall, launches


def run_timed(phase: str, runner, sql: str, cuda_groupby,
              reps: int = WARM_REPS):
    """(cold result, warm results, cold s, median warm s, peak bytes,
    grouped_sums launches in the cold run)"""
    torch.cuda.reset_peak_memory_stats()
    cold, cold_s, launches = cold_run(phase, runner, sql, cuda_groupby)
    peak = torch.cuda.max_memory_allocated()
    warm, walls = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        warm.append(runner.execute(sql))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    warm_s = sorted(walls)[len(walls) // 2] if walls else None
    return cold, warm, cold_s, warm_s, peak, launches


def cache_stats() -> dict:
    from trino_tpu_torch.exec import scancache
    return dict(scancache.STATS)


def cache_delta(before: dict) -> dict:
    """The scan cache's bytes now and its lookups since ``before``."""
    from trino_tpu_torch.exec import scancache
    now = scancache.STATS
    return {"scan_cache_bytes": scancache.cache_memory_bytes(),
            **{f"scan_cache_{k}": now[k] - before[k] for k in now}}


def stream_fields(result) -> dict:
    return {"peak_reserved_bytes": result.peak_reserved_bytes,
            "stream_chunks": result.stream_chunks,
            "stream_h2d_bytes": result.stream_h2d_bytes,
            "stream_overlapped": result.stream_overlapped,
            "stream_copy_ms": result.stream_copy_ms,
            "stream_wait_ms": result.stream_wait_ms,
            "stream_ops": result.stream_ops,
            "spill_bytes": result.spill_bytes}


def free_device() -> None:
    """Collect dead runners (their connectors key the scan cache weakly,
    so their cached lanes go with them) and return the memory, the
    cached pinned host blocks (spill, staging) included."""
    gc.collect()
    torch.cuda.empty_cache()
    empty_host = (getattr(getattr(torch, "accelerator", None),
                          "empty_host_cache", None)
                  or getattr(torch._C, "_host_emptyCache", None))
    if empty_host is not None:
        empty_host()


def host_memory() -> dict:
    """This process's resident and peak resident bytes and the bytes the
    machine has available (/proc)."""
    out = {}
    for path, keys in (("/proc/self/status", ("VmRSS", "VmHWM")),
                       ("/proc/meminfo", ("MemAvailable", "MemTotal"))):
        with open(path) as f:
            for line in f:
                key = line.split(":")[0]
                if key in keys:
                    out[key] = int(line.split()[1]) * 1024
    return out


def host_lanes(batch, cols):
    n = batch.num_rows_host()
    return {c: batch.column(c).data[:n].cpu().numpy() for c in cols}, n


def phase_orders_gen(tpch_mod, device_mod):
    """orders_batch on the card against the numpy orders generator on
    three sf10 ranges: every column, o_totalprice bit-identical."""
    sf = tpch_mod.SCHEMAS[SCHEMA]
    orders = tpch_mod.table_rows("orders", sf)
    cols = sorted(device_mod.ORDERS_DEVICE_COLS)
    host = tpch_mod.TpchConnector(device="cpu")
    ranges = [(0, 100_000), (orders // 2, orders // 2 + 100_000),
              (orders - 100_000, orders)]
    for lo, hi in ranges:
        dev = device_mod.orders_batch(lo, hi, sf, cols, DEVICE)
        ref = host._orders(np.arange(lo + 1, hi + 1, dtype=np.int64), sf,
                           cols)
        n = ref.num_rows_host()
        check(dev.num_rows_host() == n, f"orders row count {lo}-{hi}")
        for name in cols:
            a = dev.column(name).data[:n].cpu().numpy()
            b = ref.column(name).data[:n].numpy()
            if ref.column(name).dictionary is not None:
                a = dev.column(name).dictionary.values[a]
                b = ref.column(name).dictionary.values[b]
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"orders lane {name} {lo}-{hi}")
    emit("orders_gen", schema=f"tpch.{SCHEMA}", ranges=ranges,
         columns=cols, bit_identical_to_numpy=True)


def q3_reference(tpch_mod, device_mod):
    """q3 with numpy alone over lanes the card generated: filters, the
    orders join by searchsorted on the unique o_orderkey, the customer
    join, revenue per order by bincount, the top 10. Returns (rows, join
    sizes, lineitem rows)."""
    sf = tpch_mod.SCHEMAS[SCHEMA]
    n_orders = tpch_mod.table_rows("orders", sf)
    n_cust = tpch_mod.table_rows("customer", sf)
    li, n_li = host_lanes(device_mod.lineitem_batch(
        0, n_orders, sf, Q3_L_COLS, DEVICE), Q3_L_COLS)
    od, _ = host_lanes(device_mod.orders_batch(
        0, n_orders, sf, Q3_O_COLS, DEVICE), Q3_O_COLS)
    torch.cuda.empty_cache()
    cust = tpch_mod.TpchConnector(device="cpu")._customer(
        np.arange(1, n_cust + 1, dtype=np.int64), sf,
        ["c_custkey", "c_mktsegment"])
    c_key = cust.column("c_custkey").data[:n_cust].numpy()
    seg = cust.column("c_mktsegment")
    c_ok = (seg.dictionary.values[seg.data[:n_cust].numpy()]
            == "BUILDING")
    cutoff = days(1995, 3, 15)
    o_key = od["o_orderkey"]
    check(bool(np.all(np.diff(o_key) > 0)), "o_orderkey not unique")
    o_ok = od["o_orderdate"] < cutoff
    l_ok = li["l_shipdate"] > cutoff
    lk = li["l_orderkey"][l_ok]
    opos = np.clip(np.searchsorted(o_key, lk), 0, n_orders - 1)
    hit = (o_key[opos] == lk) & o_ok[opos]
    opos = opos[hit]
    cpos = np.clip(np.searchsorted(c_key, od["o_custkey"][opos]), 0,
                   n_cust - 1)
    keep = (c_key[cpos] == od["o_custkey"][opos]) & c_ok[cpos]
    rev = (li["l_extendedprice"][l_ok][hit]
           * (1 - li["l_discount"][l_ok][hit]))[keep]
    grp = opos[keep]
    sums = np.bincount(grp, weights=rev, minlength=n_orders)
    cnt = np.bincount(grp, minlength=n_orders)
    g = np.nonzero(cnt)[0]
    top = g[np.lexsort((od["o_orderdate"][g], -sums[g]))[:10]]
    epoch = datetime.date(1970, 1, 1)
    rows = [[int(o_key[i]), float(sums[i]),
             epoch + datetime.timedelta(days=int(od["o_orderdate"][i])),
             int(od["o_shippriority"][i])] for i in top]
    sizes = [(int(l_ok.sum()), int(o_ok.sum()), int(hit.sum())),
             (int(hit.sum()), int(c_ok.sum()), int(keep.sum()))]
    return rows, sizes, n_li


def phase_q3(runner, cuda_groupby, tpch_mod, device_mod, q3):
    cache0 = cache_stats()
    cold, warm, cold_s, warm_s, peak, launches = run_timed(
        "q3", runner, q3, cuda_groupby)
    extra = dict(stream_fields(cold), **cache_delta(cache0))
    want, sizes, n_li = q3_reference(tpch_mod, device_mod)
    got = cold.rows
    ok = rows_match(got, want)
    same = all(w.rows == got for w in warm)
    emit("q3", schema=f"tpch.{SCHEMA}", rows=len(got), lineitem_rows=n_li,
         cold_s=cold_s, warm_s=warm_s, warm_rows_per_s=n_li / warm_s,
         max_memory_allocated=peak, grouped_sums_launches=launches,
         join_sizes=cold.join_sizes, reference_join_sizes=sizes,
         matches_numpy_reference=ok, bit_identical_runs=1 + len(warm),
         bit_identical=same, first_row=got[0] if got else None, **extra)
    check(len(got) == 10 and ok, "q3 rows differ from the numpy reference")
    check([tuple(x) for x in cold.join_sizes] == sizes,
          "q3 join sizes differ from the numpy reference")
    check(same, "q3 rows differ between runs")
    return got


def phase_q6(runner, cuda_groupby, tpch_mod, device_mod, q6):
    cache0 = cache_stats()
    cold, warm, cold_s, warm_s, peak, launches = run_timed(
        "q6", runner, q6, cuda_groupby)
    extra = dict(stream_fields(cold), **cache_delta(cache0))
    sf = tpch_mod.SCHEMAS[SCHEMA]
    li, n_li = host_lanes(device_mod.lineitem_batch(
        0, tpch_mod.table_rows("orders", sf), sf, Q6_COLS, DEVICE),
        Q6_COLS)
    torch.cuda.empty_cache()
    disc = li["l_discount"]
    keep = ((li["l_shipdate"] >= days(1994, 1, 1))
            & (li["l_shipdate"] < days(1995, 1, 1))
            & (disc >= 0.05) & (disc <= 0.07) & (li["l_quantity"] < 24))
    want = [[float(np.sum(li["l_extendedprice"][keep] * disc[keep]))]]
    ok = rows_match(cold.rows, want)
    same = all(w.rows == cold.rows for w in warm)
    emit("q6", schema=f"tpch.{SCHEMA}", lineitem_rows=n_li,
         rows_kept=int(keep.sum()), cold_s=cold_s, warm_s=warm_s,
         warm_rows_per_s=n_li / warm_s, max_memory_allocated=peak,
         grouped_sums_launches=launches, matches_numpy_reference=ok,
         bit_identical=same, result=cold.rows, reference=want, **extra)
    check(ok, "q6 differs from the numpy reference")
    check(same, "q6 differs between runs")
    return cold.rows


def card_lanes(device_mod, table: str, cols, sf: float, n_orders: int,
               device=DEVICE):
    """Whole-table lanes as the card generates them, copied to the host:
    (lanes, dictionaries, rows)."""
    gen = (device_mod.lineitem_batch if table == "lineitem"
           else device_mod.orders_batch)
    batch = gen(0, n_orders, sf, list(cols), device)
    lanes, n = host_lanes(batch, cols)
    dicts = {c: list(batch.column(c).dictionary.values) for c in cols
             if batch.column(c).dictionary is not None}
    del batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return lanes, dicts, n


def emit_query(name, cold, warm, cold_s, warm_s, peak, launches, n_li,
               **extra) -> bool:
    """Print a query phase; True when the warm runs equal the cold one."""
    same = all(w.rows == cold.rows for w in warm)
    extra = {**stream_fields(cold), **extra}
    emit(name, schema=f"tpch.{SCHEMA}", rows=len(cold.rows),
         lineitem_rows=n_li, cold_s=cold_s, warm_s=warm_s,
         warm_runs=len(warm),
         warm_rows_per_s=n_li / warm_s if warm_s else None,
         max_memory_allocated=peak,
         join_sizes=cold.join_sizes, grouped_sums_launches=launches,
         same_rows_every_run=same, **extra)
    return same


def q9_reference(tpch_mod, device_mod):
    """q9 with numpy alone: the green parts by a substring test over the
    host generator's p_name values, the partsupp cost by searchsorted on
    (partkey, suppkey), supplier nations and order years by index, then
    a bincount per (nation, year). Returns (rows, join sizes, lineitem
    rows)."""
    sf = tpch_mod.SCHEMAS[SCHEMA]
    n_orders = tpch_mod.table_rows("orders", sf)
    n_part = tpch_mod.table_rows("part", sf)
    n_supp = tpch_mod.table_rows("supplier", sf)
    host = tpch_mod.TpchConnector(device="cpu")
    li, _, n_li = card_lanes(device_mod, "lineitem", Q9_L_COLS, sf,
                             n_orders)
    od, _, _ = card_lanes(device_mod, "orders",
                          ["o_orderkey", "o_orderdate"], sf, n_orders)
    name = host._part(np.arange(1, n_part + 1, dtype=np.int64), sf,
                      ["p_name"]).column("p_name")
    green_value = np.asarray(["green" in str(v)
                              for v in name.dictionary.values])
    green = green_value[name.data[:n_part].numpy()]
    m = green[li["l_partkey"] - 1]
    lk, pk, sk = (li[c][m] for c in ("l_orderkey", "l_partkey",
                                     "l_suppkey"))
    ps = host._partsupp(np.arange(1, 4 * n_part + 1, dtype=np.int64), sf,
                        ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    ps_key = (ps.column("ps_partkey").data[:4 * n_part].numpy()
              * (n_supp + 1) + ps.column("ps_suppkey").data[:4 * n_part]
              .numpy())
    ps_order = np.argsort(ps_key, kind="stable")
    want_key = pk * (n_supp + 1) + sk
    pos = np.clip(np.searchsorted(ps_key[ps_order], want_key), 0,
                  4 * n_part - 1)
    check(bool(np.all(ps_key[ps_order][pos] == want_key)),
          "q9 reference: lineitem row without its partsupp row")
    cost = ps.column("ps_supplycost").data[:4 * n_part].numpy()[
        ps_order[pos]]
    nation = host._supplier(np.arange(1, n_supp + 1, dtype=np.int64), sf,
                            ["s_nationkey"]).column("s_nationkey").data[
        :n_supp].numpy()[sk - 1]
    opos = np.searchsorted(od["o_orderkey"], lk)
    check(bool(np.all(od["o_orderkey"][opos] == lk)),
          "q9 reference: lineitem row without its order")
    year = (od["o_orderdate"][opos].astype("datetime64[D]")
            .astype("datetime64[Y]").astype(np.int64) + 1970)
    amount = (li["l_extendedprice"][m] * (1 - li["l_discount"][m])
              - cost * li["l_quantity"][m])
    y0 = int(year.min())
    span = int(year.max()) - y0 + 1
    grp = nation * span + (year - y0)
    sums = np.bincount(grp, weights=amount, minlength=25 * span)
    cnt = np.bincount(grp, minlength=25 * span)
    rows = [[tpch_mod.NATIONS[g // span][0], y0 + g % span, float(sums[g])]
            for g in np.nonzero(cnt)[0]]
    rows.sort(key=lambda r: (r[0], -r[1]))
    n_green = int(green.sum())
    kept = int(m.sum())
    sizes = [(n_li, n_supp, n_li), (n_li, 25, n_li),
             (n_li, n_green, kept), (kept, 4 * n_part, kept),
             (n_orders, kept, kept)]
    return rows, sizes, n_li


def q12_reference(tpch_mod, device_mod):
    """q12 with numpy alone: the lineitem filters, the orders join by
    searchsorted on the unique o_orderkey, counts per l_shipmode and
    priority class."""
    sf = tpch_mod.SCHEMAS[SCHEMA]
    n_orders = tpch_mod.table_rows("orders", sf)
    li, ld, n_li = card_lanes(device_mod, "lineitem", Q12_L_COLS, sf,
                              n_orders)
    od, odict, _ = card_lanes(device_mod, "orders",
                              ["o_orderkey", "o_orderpriority"], sf,
                              n_orders)
    modes = ld["l_shipmode"]
    code = li["l_shipmode"]
    keep = (((code == modes.index("MAIL")) | (code == modes.index("SHIP")))
            & (li["l_commitdate"] < li["l_receiptdate"])
            & (li["l_shipdate"] < li["l_commitdate"])
            & (li["l_receiptdate"] >= days(1994, 1, 1))
            & (li["l_receiptdate"] < days(1995, 1, 1)))
    lk = li["l_orderkey"][keep]
    pos = np.searchsorted(od["o_orderkey"], lk)
    check(bool(np.all(od["o_orderkey"][pos] == lk)),
          "q12 reference: lineitem row without its order")
    prios = odict["o_orderpriority"]
    pc = od["o_orderpriority"][pos]
    high = (pc == prios.index("1-URGENT")) | (pc == prios.index("2-HIGH"))
    mode = code[keep]
    rows = []
    for name in sorted(["MAIL", "SHIP"]):
        mm = mode == modes.index(name)
        rows.append([name, int((mm & high).sum()), int((mm & ~high).sum())])
    kept = int(keep.sum())
    return rows, [(n_orders, kept, kept)], n_li


def q14_reference(tpch_mod, device_mod):
    """q14 with numpy alone: one month of lineitem and a gather of
    p_type by partkey from the host generator."""
    sf = tpch_mod.SCHEMAS[SCHEMA]
    n_orders = tpch_mod.table_rows("orders", sf)
    n_part = tpch_mod.table_rows("part", sf)
    li, _, n_li = card_lanes(device_mod, "lineitem", Q14_L_COLS, sf,
                             n_orders)
    keep = ((li["l_shipdate"] >= days(1995, 9, 1))
            & (li["l_shipdate"] < days(1995, 10, 1)))
    ptype = tpch_mod.TpchConnector(device="cpu")._part(
        np.arange(1, n_part + 1, dtype=np.int64), sf,
        ["p_type"]).column("p_type")
    promo_value = np.asarray([str(v).startswith("PROMO")
                              for v in ptype.dictionary.values])
    promo = promo_value[ptype.data[:n_part].numpy()][
        li["l_partkey"][keep] - 1]
    rev = li["l_extendedprice"][keep] * (1 - li["l_discount"][keep])
    want = 100.0 * float(np.sum(np.where(promo, rev, 0.0))) \
        / float(np.sum(rev))
    kept = int(keep.sum())
    return [[want]], [(kept, n_part, kept)], n_li


def q18_reference(tpch_mod, device_mod):
    """q18 with numpy alone over the card's lineitem and orders lanes:
    the quantity per order by searchsorted and bincount, the orders over
    300, the top 100 by (o_totalprice desc, o_orderdate). The port's copy
    of the JAX package's q18 oracle, fed the card's lanes."""
    sf = tpch_mod.SCHEMAS[SCHEMA]
    n_orders = tpch_mod.table_rows("orders", sf)
    n_cust = tpch_mod.table_rows("customer", sf)
    li, _, n_li = card_lanes(device_mod, "lineitem",
                             ["l_orderkey", "l_quantity"], sf, n_orders)
    od, _, _ = card_lanes(device_mod, "orders", Q18_O_COLS, sf, n_orders)
    pos = np.searchsorted(od["o_orderkey"], li["l_orderkey"])
    check(bool(np.all(od["o_orderkey"][pos] == li["l_orderkey"])),
          "q18 reference: lineitem row without its order")
    qty = np.bincount(pos, weights=li["l_quantity"], minlength=n_orders)
    sel = np.nonzero(qty > 300.0)[0]
    tp = od["o_totalprice"][sel]
    top = sel[np.lexsort((od["o_orderdate"][sel], -tp))[:100]]
    epoch = datetime.date(1970, 1, 1)
    rows = [[f"Customer#{int(od['o_custkey'][i]):09d}",
             int(od["o_custkey"][i]), int(od["o_orderkey"][i]),
             epoch + datetime.timedelta(days=int(od["o_orderdate"][i])),
             float(od["o_totalprice"][i]), float(qty[i])] for i in top]
    return rows, [(n_li, n_orders, n_li), (n_li, n_cust, n_li)], n_li


def phase_query(name, runner, cuda_groupby, tpch_mod, device_mod, sql,
                reference, reps, expr_mod=None):
    """One new-slice query at sf10: cold and warm walls, rows/s, peak
    memory, spill bytes, join sizes and grouped_sums launches, its rows
    and join sizes against the numpy reference. For q9 (cold only) the
    runs also time the host dictionary transforms (LIKE over p_name)."""
    extra = {}
    cache0 = cache_stats()
    if expr_mod is not None:
        spent = [0.0]
        inner = expr_mod._dict_transform

        def timed(*args):
            t0 = time.perf_counter()
            out = inner(*args)
            spent[0] += time.perf_counter() - t0
            return out
        expr_mod._dict_transform = timed
    try:
        cold, warm, cold_s, warm_s, peak, launches = run_timed(
            name, runner, sql, cuda_groupby, reps)
    finally:
        if expr_mod is not None:
            expr_mod._dict_transform = inner
    if expr_mod is not None:
        extra["dict_transform_s_per_run"] = spent[0] / (1 + reps)
    extra.update(cache_delta(cache0))
    torch.cuda.empty_cache()
    want, sizes, n_li = reference(tpch_mod, device_mod)
    ok = rows_match(cold.rows, want)
    sizes_ok = [tuple(x) for x in cold.join_sizes] == sizes
    same = emit_query(name, cold, warm, cold_s, warm_s, peak, launches,
                      n_li, reference_join_sizes=sizes,
                      matches_numpy_reference=ok, first_row=cold.rows[0]
                      if cold.rows else None, reference_rows=len(want),
                      **extra)
    check(len(cold.rows) == len(want) and ok,
          f"{name} rows differ from the numpy reference")
    check(sizes_ok, f"{name} join sizes differ from the numpy reference")
    check(same, f"{name} rows differ between runs")
    return cold


def phase_q1_check(rows, tpch_mod, device_mod, cold, warm, launches, peak,
                   extra):
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
         first_row=rows[0] if rows else None, **extra)
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


def time_kernel(bench, cg, phase: str, cap: int, k: int, nseg: int,
                seed: int, **extra) -> dict:
    """grouped_sums at ``cap`` rows, ``k`` lanes and ``nseg`` groups held
    against its plain version (rel 1e-9, counts exact, two launches
    bit-identical, one launch a call) and timed beside its bound and
    ``index_add_`` (trino_tpu_torch/bench_grouped_sums.py: ``ms``,
    ``device_ms``, ``host_us``, ``library_ms``, ``library_device_ms``)."""
    row = bench.measure(cg, cap, k, nseg, seed)
    emit(phase, name="grouped_sums", **extra, **row)
    check(row["max_rel_err"] <= SUM_REL,
          f"grouped_sums rel err {row['max_rel_err']} at {cap} rows")
    check(row["bit_identical"], f"two grouped_sums launches differ at "
          f"{cap} rows")
    check(row["launches_per_call"] == 1, f"grouped_sums launched "
          f"{row['launches_per_call']} kernels a call at {cap} rows")
    keep = ("max_abs_err", "max_rel_err", "ms", "device_ms", "host_us",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "cap", "lanes", "nseg")
    return dict(name="grouped_sums", route="cuda",
                source="trino_tpu_torch/csrc/grouped_sums.cu",
                replaces="trino_tpu/ops/pallas_groupby.py:102",
                **{key: row[key] for key in keep})


def phase_kernel(cg):
    """The kernel at every shape the main paths gave it in their cold
    runs (SHAPES), each held against its plain version and timed with
    its launches; at the 2^26-row shape no path gives it (its streaming
    rate, ``path: none``, not in the kernels line); then its edges.
    Returns the kernels line's entries."""
    from trino_tpu_torch import bench_grouped_sums as bench
    check(bool(SHAPES), "no phase launched grouped_sums")
    kernels = []
    for i, (cap, k, nseg) in enumerate(sorted(SHAPES)):
        by_phase = SHAPES[(cap, k, nseg)]
        entry = time_kernel(bench, cg, "kernel_split", cap, k, nseg,
                            seed=3 + i, path="+".join(sorted(by_phase)),
                            launches=sum(by_phase.values()),
                            launches_by_phase=by_phase)
        entry["launches"] = sum(by_phase.values())
        entry["launches_by_phase"] = by_phase
        kernels.append(entry)
    time_kernel(bench, cg, "kernel_split", *bench.STREAM_SHAPE, seed=2,
                path="none", launches=0)
    torch.cuda.empty_cache()

    # edges: every row dead; ids past the domain; the widest domain; an
    # odd number of rows, the pad column of the buffer NaN (never summed)
    rng = np.random.default_rng(2)
    edge_cap = 1 << 20
    dev = DEVICE
    vals = torch.from_numpy(np.round(rng.uniform(-1e4, 1e4, edge_cap + 3),
                                     2)).to(dev)
    ones = torch.ones(edge_cap + 3, dtype=torch.float64, device=dev)
    odd = torch.full((2, edge_cap + 4), float("nan"), dtype=torch.float64,
                     device=dev)
    odd[0, :edge_cap + 3] = vals
    odd[1, :edge_cap + 3] = 1.0
    edges = {
        "all_dead": (torch.full((edge_cap,), 12, dtype=torch.int32,
                                device=dev), 12),
        "ids_past_domain": (torch.from_numpy(rng.integers(
            -5, 200, edge_cap).astype(np.int32)).to(dev), 12),
        "nseg_64": (torch.from_numpy(rng.integers(
            0, 64, edge_cap).astype(np.int32)).to(dev), 64),
        "odd_cap": (torch.from_numpy(rng.integers(
            0, 14, edge_cap + 3).astype(np.int32)).to(dev), 12),
    }
    for name, (g, ns) in edges.items():
        cap = int(g.shape[0])
        lanes = odd if name == "odd_cap" else [vals[:cap], ones[:cap]]
        e_abs, e_rel, e_same, per_call = bench.compare(cg, g, lanes, ns,
                                                       {1})
        check(e_rel <= SUM_REL and e_same and per_call == 1,
              f"edge {name}")
        emit("kernel_edge", case=name, cap=cap, nseg=ns, max_abs_err=e_abs,
             max_rel_err=e_rel, bit_identical=e_same,
             launches_per_call=per_call)
    return kernels


def big_ranges(n_orders: int):
    return [(lo, min(lo + BIG_RANGE_ORDERS, n_orders))
            for lo in range(0, n_orders, BIG_RANGE_ORDERS)]


class Q3Partial:
    """q3 at sf100 with numpy alone, one range of orders at a time with
    the lineitem rows the card generates for the same orders (never more
    than one range of lineitem on the host): the orders join by
    searchsorted within the range's unique o_orderkey (a lineitem row
    whose order lies elsewhere would find no match, and the join sizes
    would disagree), the customer join by index into the dense
    c_custkey, revenue per order by bincount, the top 10 of every
    range's orders."""

    def __init__(self, tpch_mod, sf):
        n_cust = tpch_mod.table_rows("customer", sf)
        cust = tpch_mod.TpchConnector(device="cpu")._customer(
            np.arange(1, n_cust + 1, dtype=np.int64), sf,
            ["c_custkey", "c_mktsegment"])
        check(bool(np.array_equal(
            cust.column("c_custkey").data[:n_cust].numpy(),
            np.arange(1, n_cust + 1))), "q3 reference: c_custkey not dense")
        seg = cust.column("c_mktsegment")
        self.c_ok = (seg.dictionary.values[seg.data[:n_cust].numpy()]
                     == "BUILDING")
        self.n_cust = n_cust
        self.cutoff = days(1995, 3, 15)
        self.l_kept = self.o_kept = self.hits = self.keeps = 0
        self.cands = []

    def part(self, od, li):
        """One range's partial from the orders' and the lineitem rows'
        host lanes (reads only this object's customer lane, so ranges
        may run in threads); ``add`` folds it in."""
        o_key = od["o_orderkey"]
        check(bool(np.all(np.diff(o_key) > 0)), "o_orderkey not unique")
        oc = od["o_custkey"]
        check(bool(np.all((oc >= 1) & (oc <= self.n_cust))),
              "q3 reference: o_custkey outside customer")
        o_ok = od["o_orderdate"] < self.cutoff
        l_ok = li["l_shipdate"] > self.cutoff
        lk = li["l_orderkey"][l_ok]
        opos = np.clip(np.searchsorted(o_key, lk), 0, len(o_key) - 1)
        hit = (o_key[opos] == lk) & o_ok[opos]
        keep = self.c_ok[oc[opos[hit]] - 1]
        grp = opos[hit][keep]
        rev = (li["l_extendedprice"][l_ok][hit]
               * (1 - li["l_discount"][l_ok][hit]))[keep]
        sums = np.bincount(grp, weights=rev, minlength=len(o_key))
        g = np.nonzero(np.bincount(grp, minlength=len(o_key)))[0]
        return (int(l_ok.sum()), int(o_ok.sum()), int(hit.sum()),
                int(keep.sum()), (o_key[g], sums[g], od["o_orderdate"][g],
                                  od["o_shippriority"][g]))

    def add(self, part):
        l_kept, o_kept, hits, keeps, cands = part
        self.l_kept += l_kept
        self.o_kept += o_kept
        self.hits += hits
        self.keeps += keeps
        self.cands.append(cands)

    def result(self):
        """(rows, join sizes)"""
        key, rev, date, prio = (np.concatenate(x) for x in zip(*self.cands))
        top = np.lexsort((date, -rev))[:10]
        epoch = datetime.date(1970, 1, 1)
        rows = [[int(key[i]), float(rev[i]),
                 epoch + datetime.timedelta(days=int(date[i])),
                 int(prio[i])] for i in top]
        sizes = [(self.l_kept, self.o_kept, self.hits),
                 (self.hits, int(self.c_ok.sum()), self.keeps)]
        return rows, sizes


def big_range(tpch_mod, device_mod, sf, lo: int, hi: int, q3: "Q3Partial"):
    """One range of orders at sf100: q1's counts and sums per (flag,
    status) key, q6's sum and q3's partial, from the lineitem and orders
    lanes the card generates for it, on the host."""
    cols = Q1_COLS + ["l_orderkey"]
    cutoff = days(1998, 12, 1) - 90
    b = device_mod.lineitem_batch(lo, hi, sf, cols, DEVICE)
    lane, n = host_lanes(b, cols)
    flags = b.column("l_returnflag").dictionary.values
    stats = b.column("l_linestatus").dictionary.values
    del b
    nkey = len(flags) * len(stats)
    # rows past the cutoff go to an extra bin, nkey
    key = np.where(lane["l_shipdate"] <= cutoff,
                   lane["l_returnflag"].astype(np.int64) * len(stats)
                   + lane["l_linestatus"], nkey)
    price = lane["l_extendedprice"]
    disc = lane["l_discount"]
    disc_price = price * (1 - disc)
    weights = [lane["l_quantity"], price, disc_price,
               disc_price * (1 + lane["l_tax"]), disc]
    cnt = np.bincount(key, minlength=nkey + 1)[:nkey]
    part = [np.bincount(key, weights=w, minlength=nkey + 1)[:nkey]
            for w in weights]
    keep = ((lane["l_shipdate"] >= days(1994, 1, 1))
            & (lane["l_shipdate"] < days(1995, 1, 1))
            & (disc >= 0.05) & (disc <= 0.07) & (lane["l_quantity"] < 24))
    q6 = float(np.sum(price[keep] * disc[keep]))
    od, _ = host_lanes(device_mod.orders_batch(lo, hi, sf, Q3_O_COLS,
                                               DEVICE), Q3_O_COLS)
    return n, flags, stats, cnt, part, q6, q3.part(od, lane)


@functools.lru_cache(maxsize=1)
def big_lineitem_references(tpch_mod, device_mod):
    """q1's, q6's and q3's rows at sf100 with numpy alone, in one pass
    range by range over the lineitem lanes the card generates (q6's and
    q3's columns are among q1's and l_orderkey) and the orders of the
    same range (``big_range``, four ranges at a time in threads: numpy
    releases the interpreter in most of its work). The ranges' partials
    fold in range order, so the sums are those of one thread: q1's
    counts per (flag, status) as integers and its sums as doubles added
    range after range, q6's sum the same way, q3 by ``Q3Partial``.
    Returns (q1 rows, q6 rows, (q3 rows, q3 join sizes), lineitem
    rows)."""
    from concurrent.futures import ThreadPoolExecutor
    sf = tpch_mod.SCHEMAS[BIG_SCHEMA]
    q3 = Q3Partial(tpch_mod, sf)
    counts, sums, n_li, q6 = {}, {}, 0, 0.0
    with ThreadPoolExecutor(4) as pool:
        parts = pool.map(
            lambda r: big_range(tpch_mod, device_mod, sf, *r, q3),
            big_ranges(tpch_mod.table_rows("orders", sf)))
        for n, flags, stats, cnt, part, q6_part, q3_part in parts:
            n_li += n
            for g in np.nonzero(cnt)[0]:
                k = (str(flags[g // len(stats)]), str(stats[g % len(stats)]))
                counts[k] = counts.get(k, 0) + int(cnt[g])
                sums[k] = sums.get(k, np.zeros(5)) + np.array(
                    [float(x[g]) for x in part])
            q6 += q6_part
            q3.add(q3_part)
    rows = []
    for k in sorted(counts):
        c, v = counts[k], sums[k]
        rows.append([k[0], k[1], *map(float, v[:4]), float(v[0] / c),
                     float(v[1] / c), float(v[4] / c), c])
    return rows, [[q6]], q3.result(), n_li


def q1_big_reference(tpch_mod, device_mod):
    rows, _, _, n_li = big_lineitem_references(tpch_mod, device_mod)
    return rows, None, n_li


def q6_big_reference(tpch_mod, device_mod):
    _, rows, _, n_li = big_lineitem_references(tpch_mod, device_mod)
    return rows, None, n_li


def q3_big_reference(tpch_mod, device_mod):
    """q3's rows and join sizes from the shared pass."""
    _, _, (rows, sizes), n_li = big_lineitem_references(tpch_mod,
                                                        device_mod)
    return rows, sizes, n_li


def phase_big(name, runner, sql, cuda_groupby, tpch_mod, device_mod,
              reference, schema=BIG_SCHEMA, **want):
    """One query streamed beyond the card's memory budget: one cold run
    (no warm repeat, to keep the script inside its time limit), its rows
    (and join sizes, where the reference gives them) against the numpy
    reference, and what the chunk loop and the scan cache did."""
    cache0 = cache_stats()
    torch.cuda.reset_peak_memory_stats()
    cold, cold_s, launches = cold_run(name, runner, sql, cuda_groupby)
    peak = torch.cuda.max_memory_allocated()
    shapes = _COLD["last"]
    extra = dict(stream_fields(cold), **cache_delta(cache0))
    free_device()
    t0 = time.perf_counter()
    rows, sizes, n_li = reference(tpch_mod, device_mod)
    ref_s = time.perf_counter() - t0
    free_device()
    ok = len(cold.rows) == len(rows) and rows_match(cold.rows, rows)
    sizes_ok = sizes is None or [tuple(x) for x in cold.join_sizes] == sizes
    emit(name, schema=f"tpch.{schema}", rows=len(cold.rows),
         lineitem_rows=n_li, cold_s=cold_s, cold_rows_per_s=n_li / cold_s,
         max_memory_allocated=peak,
         grouped_sums_launches=launches,
         grouped_sums_shapes=[[*k, v] for k, v in sorted(shapes.items())],
         join_sizes=cold.join_sizes, reference_join_sizes=sizes,
         matches_numpy_reference=ok,
         reference_s=ref_s, first_row=cold.rows[0] if cold.rows else None,
         **extra)
    check(ok, f"{name} rows differ from the numpy reference")
    check(sizes_ok, f"{name} join sizes differ from the numpy reference")
    if want.get("streams"):
        check(cold.stream_chunks > 0, f"{name} did not stream")
    if want.get("join_streams"):
        check(cold.stream_ops.get("join", 0) > 0,
              f"{name}: the join did not stream")
    check(peak < BIG_PEAK_BYTES,
          f"{name} peaked at {peak} bytes of device memory")
    if want.get("launches"):
        check(launches >= 1, f"{name} did not launch grouped_sums")


def phases_big(runner_mod, session_mod, cuda_groupby, tpch_mod, device_mod,
               queries):
    """q1, q6 and q3 at tpch.sf100 on one runner; then q18 at sf10 under
    the JAX bench's streaming budget (the orders build state plus 64
    MB). Each sf100 query must peak under BIG_PEAK_BYTES."""
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=BIG_SCHEMA))
    phase_big("q1_sf100", runner, queries[1], cuda_groupby, tpch_mod,
              device_mod, q1_big_reference, streams=True, launches=True)
    phase_big("q6_sf100", runner, queries[6], cuda_groupby, tpch_mod,
              device_mod, q6_big_reference)
    phase_big("q3_sf100", runner, queries[3], cuda_groupby, tpch_mod,
              device_mod, q3_big_reference, streams=True, join_streams=True)
    del runner
    free_device()
    sf = tpch_mod.SCHEMAS[SCHEMA]
    from trino_tpu_torch.config import capacity_for
    budget = capacity_for(tpch_mod.table_rows("orders", sf)) * 48 \
        + (64 << 20)
    session = session_mod.Session(catalog="tpch", schema=SCHEMA)
    session.set("query_max_memory_per_node", budget)
    runner = runner_mod.LocalQueryRunner(session)
    cache0 = cache_stats()
    cold, warm, cold_s, warm_s, peak, q18_launches = run_timed(
        "q18_stream", runner, queries[18], cuda_groupby, 1)
    extra = dict(stream_fields(cold), **cache_delta(cache0))
    del runner
    free_device()
    want, sizes, n_li = q18_reference(tpch_mod, device_mod)
    ok = len(cold.rows) == len(want) and rows_match(cold.rows, want)
    same = warm[0].rows == cold.rows
    emit("q18_stream", schema=f"tpch.{SCHEMA}", budget=budget,
         rows=len(cold.rows), lineitem_rows=n_li, cold_s=cold_s,
         warm_s=warm_s, warm_rows_per_s=n_li / warm_s,
         max_memory_allocated=peak, grouped_sums_launches=q18_launches,
         join_sizes=cold.join_sizes, reference_join_sizes=sizes,
         streamed_join_chunks=cold.stream_ops.get("join", 0),
         streamed_agg_chunks=cold.stream_ops.get("agg", 0),
         matches_numpy_reference=ok, same_rows_warm=same, **extra)
    check(ok, "q18_stream rows differ from the numpy reference")
    check([tuple(x) for x in cold.join_sizes] == sizes,
          "q18_stream join sizes differ from the numpy reference")
    check(same, "q18_stream warm rows differ from the cold rows")
    check(cold.stream_chunks > 0, "q18_stream did not stream")
    check(cold.stream_ops.get("join", 0) > 0,
          "q18_stream: the join did not stream")


def ds_rows_match(got, want) -> bool:
    """Integers, strings, dates and decimals exact; doubles within rel
    1e-9; NaN equals NaN."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and b != b:
                if not (isinstance(a, float) and a != a):
                    return False
            elif isinstance(b, float):
                if not isinstance(a, float) or abs(a - b) > SUM_REL * abs(b):
                    return False
            elif a != b:
                return False
    return True


def ds_fact_rows(runner, sql, tpcds_mod) -> int:
    """Fact-table rows the query's scans generate (each scan counts)."""
    sf = tpcds_mod.SCHEMAS[DS_SCHEMA]
    total, stack = 0, [runner.plan_sql(sql)]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "TableScanNode" and \
                node.handle.table in DS_FACT_TABLES:
            total += tpcds_mod.table_rows(node.handle.table, sf)
        src = node.sources
        stack.extend(src() if callable(src) else src)
    return total


def ds_lanes(conn, schema: str, table: str, cols):
    """A whole table as the connector generates it, split by split, on
    the host: {column: (values, validity)}; strings decoded to objects."""
    from trino_tpu_torch.catalog import TableHandle
    parts = {c: ([], []) for c in cols}
    for split in conn.get_splits(TableHandle("tpcds", schema, table), 1):
        b = conn.read_split(split, cols)
        n = b.num_rows_host()
        for c in cols:
            col = b.column(c)
            data = col.data[:n].numpy()
            if col.dictionary is not None:
                data = col.dictionary.values[data]
            parts[c][0].append(data)
            parts[c][1].append(np.ones(n, bool) if col.valid is None
                               else col.valid[:n].numpy())
    return {c: (np.concatenate(v), np.concatenate(m))
            for c, (v, m) in parts.items()}


def q38_reference(tpcds_mod, schema: str) -> int:
    """q38 with numpy alone over the connector's lanes: each channel's
    distinct (c_last_name, c_first_name, d_date) triples sold in months
    1200-1211 of d_month_seq, intersected across the three channels."""
    conn = tpcds_mod.TpcdsConnector(device="cpu")
    dd = ds_lanes(conn, schema, "date_dim",
                  ["d_date_sk", "d_date", "d_month_seq"])
    cu = ds_lanes(conn, schema, "customer",
                  ["c_customer_sk", "c_last_name", "c_first_name"])
    sk0 = int(dd["d_date_sk"][0][0])
    check(bool(np.all(np.diff(dd["d_date_sk"][0]) == 1)),
          "q38 reference: d_date_sk not dense")
    check(bool(np.all(cu["c_customer_sk"][0]
                      == np.arange(1, len(cu["c_customer_sk"][0]) + 1))),
          "q38 reference: c_customer_sk not dense")
    in_months = (dd["d_month_seq"][0] >= 1200) & (dd["d_month_seq"][0]
                                                  <= 1211)
    last = np.unique(cu["c_last_name"][0], return_inverse=True)[1]
    first_vals, first = np.unique(cu["c_first_name"][0],
                                  return_inverse=True)
    date = dd["d_date"][0].astype(np.int64)
    span = int(date.max() - date.min()) + 1
    keys = []
    for table, dcol, ccol in (
            ("store_sales", "ss_sold_date_sk", "ss_customer_sk"),
            ("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk"),
            ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")):
        lanes = ds_lanes(conn, schema, table, [dcol, ccol])
        (dsk, dok), (csk, cok) = lanes[dcol], lanes[ccol]
        di = np.clip(dsk - sk0, 0, len(date) - 1)
        ci = np.clip(csk - 1, 0, len(last) - 1)
        ok = dok & cok & in_months[di]
        key = ((last[ci] * len(first_vals) + first[ci]) * span
               + (date[di] - date.min()))
        keys.append(np.unique(key[ok]))
    return int(len(np.intersect1d(np.intersect1d(keys[0], keys[1]),
                                  keys[2])))


def phase_ds(name, sql, runners, cuda_groupby, tpcds_mod, int128_mod,
             reference=None, relaxed=None):
    """One TPC-DS query at tpcds.sf10, cold only (its warm run is left
    out for the script's time limit): the wall, rows/s over the fact
    rows its scans generate, peak memory, spill bytes, join sizes,
    grouped_sums launches and Int128 divisions. Returns the card's rows
    at tpcds.sf1 and their seconds, which ``phases_ds`` holds to the
    engine's on the CPU."""
    card, card_check = runners
    int128_mod.DIVMOD_CALLS = 0
    cache0 = cache_stats()
    torch.cuda.reset_peak_memory_stats()
    cold, cold_s, launches = cold_run(name, card, sql, cuda_groupby)
    peak = torch.cuda.max_memory_allocated()
    extra = cache_delta(cache0)
    divmods = int128_mod.DIVMOD_CALLS
    torch.cuda.empty_cache()
    fact = ds_fact_rows(card, sql, tpcds_mod)
    t0 = time.perf_counter()
    on_card = card_check.execute(sql).rows
    torch.cuda.synchronize()
    check_card_s = time.perf_counter() - t0
    if reference is not None:
        want = reference(tpcds_mod, DS_SCHEMA)
        extra.update(reference=want,
                     matches_numpy_reference=cold.rows == [[want]])
    if relaxed is not None and not cold.rows:
        t0 = time.perf_counter()
        rel = card.execute(relaxed)
        torch.cuda.synchronize()
        extra.update(relaxed_rows=len(rel.rows),
                     relaxed_s=time.perf_counter() - t0,
                     relaxed_join_sizes=rel.join_sizes,
                     relaxed_spill_bytes=rel.spill_bytes)
    emit(name, schema=f"tpcds.{DS_SCHEMA}", rows=len(cold.rows),
         fact_rows=fact, cold_s=cold_s, cold_rows_per_s=fact / cold_s,
         max_memory_allocated=peak,
         spill_bytes=cold.spill_bytes, join_sizes=cold.join_sizes,
         grouped_sums_launches=launches, int128_divisions_per_run=divmods,
         check_schema=f"tpcds.{DS_CHECK_SCHEMA}",
         check_rows=len(on_card), check_card_s=check_card_s,
         first_row=cold.rows[0] if cold.rows else None, **extra)
    if reference is not None:
        check(extra["matches_numpy_reference"],
              f"{name} differs from the numpy reference")
    if relaxed is not None:
        check(len(cold.rows) > 0 or extra["relaxed_rows"] > 0,
              f"{name} returned no rows, relaxed variant included")
    return on_card, check_card_s


def phases_ds(runner_mod, session_mod, cuda_groupby, int128_mod):
    from trino_tpu_torch.benchmarks.tpcds_queries import TPCDS_QUERIES
    from trino_tpu_torch.connectors import tpcds as tpcds_mod

    def runner(schema, device=None):
        return runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpcds", schema=schema),
            device=device)
    runners = (runner(DS_SCHEMA), runner(DS_CHECK_SCHEMA))
    relaxed = TPCDS_QUERIES[64]
    for old, new in Q64_RELAXED_EDITS:
        check(old in relaxed, "q64 relaxed edit does not apply")
        relaxed = relaxed.replace(old, new)
    queries = [("ds_q64", 64, dict(relaxed=relaxed)), ("ds_q47", 47, {}),
               ("ds_q36", 36, {}), ("ds_q38", 38,
                                   dict(reference=q38_reference)),
               ("ds_q78", 78, {})]
    on_card = [phase_ds(name, TPCDS_QUERIES[q], runners, cuda_groupby,
                        tpcds_mod, int128_mod, **kw)
               for name, q, kw in queries]
    del runners
    free_device()
    # the card's rows at tpcds.sf1 against the engine's on the CPU, the
    # five queries side by side once the card's work is done
    t0 = time.perf_counter()
    on_cpu = cpu_rows_in_threads(lambda: runner(DS_CHECK_SCHEMA, "cpu"),
                                 [TPCDS_QUERIES[q] for _, q, _ in queries])
    cpu_wall_s = time.perf_counter() - t0
    report = [{"query": name, "rows": len(cpu_rows),
               "equal": ds_rows_match(card_rows, cpu_rows),
               "card_s": card_s, "cpu_s": cpu_s}
              for (name, _, _), (card_rows, card_s), (cpu_rows, cpu_s)
              in zip(queries, on_card, on_cpu)]
    emit("ds_sf1_cpu", schema=f"tpcds.{DS_CHECK_SCHEMA}", queries=report,
         cpu_wall_s=cpu_wall_s,
         card_equals_cpu=all(r["equal"] for r in report))
    for r in report:
        check(r["equal"], f"{r['query']} rows on the card differ from the "
              f"CPU at tpcds.{DS_CHECK_SCHEMA}")


# ---- the aggregates with scalar results and the HyperLogLog sketches -----

AGG_SCHEMA = "sf10"         # the three aggregate phases
AGG_CHECK_SCHEMA = "sf1"    # the card against the engine on the CPU
AGG_WARM_REPS = 1
AGG_STATS_SQL = (
    "SELECT l_returnflag, l_linestatus, count(*), "
    "corr(l_extendedprice, l_quantity), "
    "covar_samp(l_extendedprice, l_quantity), "
    "covar_pop(l_extendedprice, l_quantity), "
    "regr_slope(l_extendedprice, l_quantity), "
    "regr_intercept(l_extendedprice, l_quantity), "
    "skewness(l_extendedprice), kurtosis(l_quantity), "
    "checksum(l_orderkey), bitwise_and_agg(l_orderkey), "
    "bitwise_or_agg(l_suppkey) "
    "FROM tpch.{schema}.lineitem GROUP BY 1, 2 ORDER BY 1, 2")
AGG_STATS_COLS = ["l_returnflag", "l_linestatus", "l_extendedprice",
                  "l_quantity", "l_orderkey", "l_suppkey"]
# the doubles of an agg_stats row, by column
AGG_STATS_DOUBLES = ["corr", "covar_samp", "covar_pop", "regr_slope",
                     "regr_intercept", "skewness", "kurtosis"]
AGG_ORDER_SQL = [
    "SELECT l_returnflag, l_linestatus, "
    "min_by(l_orderkey, l_extendedprice), "
    "max_by(l_partkey, l_extendedprice), "
    "approx_percentile(l_extendedprice, 0.5), "
    "approx_percentile(l_quantity, 0.9) "
    "FROM tpch.{schema}.lineitem GROUP BY 1, 2 ORDER BY 1, 2",
    "SELECT min_by(l_orderkey, l_discount), "
    "max_by(l_orderkey, l_extendedprice), "
    "approx_percentile(l_discount, 0.25) "
    "FROM tpch.{schema}.lineitem WHERE l_shipdate >= DATE '1995-01-01'"]
AGG_ORDER_COLS = ["l_returnflag", "l_linestatus", "l_orderkey", "l_partkey",
                  "l_extendedprice", "l_quantity", "l_discount",
                  "l_shipdate"]
AGG_HLL_SQL = [
    "SELECT l_returnflag, cardinality(approx_set(l_partkey)), "
    "cardinality(approx_set(l_suppkey, 0.01)) "
    "FROM tpch.{schema}.lineitem GROUP BY 1 ORDER BY 1",
    "SELECT cardinality(merge(s)) FROM (SELECT l_returnflag, "
    "approx_set(l_partkey) s FROM tpch.{schema}.lineitem GROUP BY 1) t",
    "SELECT cardinality(approx_set(l_partkey)) FROM tpch.{schema}.lineitem"]
AGG_HLL_COLS = ["l_returnflag", "l_partkey", "l_suppkey"]
AGG_WIRE_SQL = ("SELECT l_returnflag, CAST(approx_set(l_partkey) AS "
                "varbinary) FROM tpch.{schema}.lineitem GROUP BY 1 "
                "ORDER BY 1")
# approx_set's bucket bits: the default, and those of a 0.01 error
HLL_BITS_DEFAULT, HLL_BITS_001 = 12, 14


def agg_lanes(tpch_mod, device_mod, cols):
    """Whole-table lineitem lanes of AGG_SCHEMA as the card generates
    them, on the host: (lanes, dictionaries, rows)."""
    sf = tpch_mod.SCHEMAS[AGG_SCHEMA]
    return card_lanes(device_mod, "lineitem", cols, sf,
                      tpch_mod.table_rows("orders", sf))


def groups_of(lanes, dicts, keys):
    """[(key strings, row mask)] of the distinct values of the
    dictionary columns ``keys``, in the order of their strings."""
    code = np.zeros(len(lanes[keys[0]]), np.int64)
    for k in keys:
        code = code * len(dicts[k]) + lanes[k]
    out = []
    # the codes are small and >= 0: their distinct values in order by a
    # count, not a sort
    for u in np.flatnonzero(np.bincount(code)):
        names, rest = [], int(u)
        for k in reversed(keys):
            names.insert(0, str(dicts[k][rest % len(dicts[k])]))
            rest //= len(dicts[k])
        out.append((names, code == u))
    return sorted(out, key=lambda g: g[0])


def mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over uint64 (the engine's row hash)."""
    x = x.astype(np.int64).view(np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def fsum(lane: np.ndarray) -> float:
    """``math.fsum`` of the lane (its exact sum, correctly rounded), at
    numpy's speed: with sigma a power of two above len(lane) * max|x|,
    ``(x + sigma) - sigma`` splits each x exactly into a part on the grid
    of sigma's last bit, whose sum no double rounds, and a remainder;
    the remainders split again on a grid 2^(52 - log2 n) times finer
    until none is left, and math.fsum adds the exact partial sums."""
    x = np.array(lane, dtype=np.float64)
    if x.size == 0 or not np.isfinite(x.sum()):
        return math.fsum(x.tolist())
    m = math.ceil(math.log2(x.size)) + 1
    hi = np.empty_like(x)
    parts = []
    while True:
        top = max(float(x.max()), -float(x.min()))
        if top == 0.0:
            return math.fsum(parts)
        sigma = math.ldexp(1.0, math.frexp(top)[1] + m)
        np.add(x, sigma, out=hi)
        np.subtract(hi, sigma, out=hi)
        parts.append(float(hi.sum()))
        np.subtract(x, hi, out=x)


def stats_reference(s, n):
    """The doubles of an agg_stats row from exact sums ``s`` (math.fsum)
    and the count, by the formulas of the reference's accumulator states,
    each with the condition number of its last cancelling step."""
    def cond(*terms):
        total = sum(terms)
        return sum(abs(t) for t in terms) / abs(total) if total else \
            float("inf")
    nn = float(max(n, 1))
    co = s["xy"] - s["x"] * s["y"] / nn
    mxx = s["xx"] - s["x"] * s["x"] / nn
    myy = s["yy"] - s["y"] * s["y"] / nn
    c_co = cond(s["xy"], -s["x"] * s["y"] / nn)
    c_xx = cond(s["xx"], -s["x"] * s["x"] / nn)
    c_yy = cond(s["yy"], -s["y"] * s["y"] / nn)
    slope = co / mxx
    out = {"corr": (co / math.sqrt(mxx * myy), max(c_co, c_xx, c_yy)),
           "covar_samp": (co / max(nn - 1.0, 1.0), c_co),
           "covar_pop": (co / nn, c_co),
           "regr_slope": (slope, max(c_co, c_xx)),
           "regr_intercept": ((s["y"] - slope * s["x"]) / nn,
                              max(c_co, c_xx)
                              * cond(s["y"], -slope * s["x"]))}
    y1, y2, y3 = s["y"], s["yy"], s["y3"]
    m2 = y2 - y1 * y1 / nn
    t3 = (y3, -3.0 * y1 * y2 / nn, 2.0 * (y1 * (y1 * y1)) / (nn * nn))
    m3 = t3[0] + t3[1] + t3[2]
    out["skewness"] = (math.sqrt(nn) * m3 / m2 ** 1.5,
                       max(cond(*t3), cond(y2, -y1 * y1 / nn)))
    x1, x2, x3, x4 = s["x"], s["xx"], s["x3"], s["x4"]
    m2 = x2 - x1 * x1 / nn
    t4 = (x4, -4.0 * x1 * x3 / nn, 6.0 * x1 * x1 * x2 / (nn * nn),
          -3.0 * ((x1 * x1) * (x1 * x1)) / (nn * (nn * nn)))
    m4 = t4[0] + t4[1] + t4[2] + t4[3]
    # Trino's unbiased excess kurtosis over the central sums m2, m4
    a = nn * (nn + 1.0) * (nn - 1.0) * m4 / ((nn - 2.0) * (nn - 3.0)
                                             * m2 * m2)
    b = 3.0 * (nn - 1.0) * (nn - 1.0) / ((nn - 2.0) * (nn - 3.0))
    out["kurtosis"] = (a - b, max(cond(*t4), cond(x2, -x1 * x1 / nn))
                       * cond(a, -b))
    return out


def agg_stats_reference(tpch_mod, device_mod):
    """agg_stats with numpy alone over the card's lanes: exact sums
    (math.fsum per group and lane) of the lanes the engine forms, the
    finishers' formulas, checksum and the bitwise kinds in uint64."""
    lanes, dicts, n_li = agg_lanes(tpch_mod, device_mod, AGG_STATS_COLS)
    y, x = lanes["l_extendedprice"], lanes["l_quantity"]
    h = mix64_np(lanes["l_orderkey"])
    rows, conds = [], []
    for (flag, status), mask in groups_of(
            lanes, dicts, ["l_returnflag", "l_linestatus"]):
        gy, gx = y[mask], x[mask]
        yy, xx = gy * gy, gx * gx
        sums = {"y": fsum(gy), "x": fsum(gx), "xy": fsum(gx * gy),
                "xx": fsum(xx), "yy": fsum(yy), "y3": fsum(gy * yy),
                "x3": fsum(gx * xx), "x4": fsum(xx * xx)}
        n = int(mask.sum())
        ref = stats_reference(sums, n)
        ck = int(h[mask].sum(dtype=np.uint64).view(np.int64))
        band = int(np.bitwise_and.reduce(lanes["l_orderkey"][mask]))
        bor = int(np.bitwise_or.reduce(lanes["l_suppkey"][mask]))
        rows.append([flag, status, n] + [ref[k][0] for k in AGG_STATS_DOUBLES]
                    + [ck, band, bor])
        conds.append({k: ref[k][1] for k in AGG_STATS_DOUBLES})
    return rows, conds, n_li


def stats_errors(got, want, conds):
    """(every double's rel error and condition number, the exact columns
    equal, every double within its bound)."""
    report, exact_ok, close_ok = [], len(got) == len(want), True
    for g, w, c in zip(got, want, conds):
        exact_ok &= g[:3] == w[:3] and g[10:] == w[10:]
        for i, name in enumerate(AGG_STATS_DOUBLES):
            a, b = g[3 + i], w[3 + i]
            err = abs(a - b) / abs(b) if b else abs(a - b)
            close_ok &= isinstance(a, float) and err <= SUM_REL
            report.append({"group": g[:2], "value": name, "rel_err": err,
                           "cond": c[name]})
    return report, exact_ok, close_ok


def agg_cold_warm(name, runner, sql, cuda_groupby):
    """run_timed over ``sql``: (cold result, fields of the phase line,
    warm rows equal to the cold rows)."""
    cold, warm, cold_s, warm_s, peak, launches = run_timed(
        name, runner, sql, cuda_groupby, AGG_WARM_REPS)
    same = all(w.rows == cold.rows for w in warm)
    return cold, dict(cold_s=cold_s, warm_s=warm_s, warm_runs=len(warm),
                      max_memory_allocated=peak,
                      grouped_sums_launches=launches,
                      same_rows_every_run=same), same


def phase_agg_stats(runner, cuda_groupby, tpch_mod, device_mod):
    """The statistical family, checksum and the bitwise kinds at
    tpch.sf10 on the packed GROUP BY, split by split (grouped_sums)."""
    cache0 = cache_stats()
    sql = AGG_STATS_SQL.format(schema=AGG_SCHEMA)
    cold, fields, same = agg_cold_warm("agg_stats", runner, sql,
                                       cuda_groupby)
    shapes = sorted(f"{k[0]}x{k[1]}x{k[2]}" for k in _COLD["last"])
    torch.cuda.empty_cache()
    want, conds, n_li = agg_stats_reference(tpch_mod, device_mod)
    report, exact_ok, close_ok = stats_errors(cold.rows, want, conds)
    emit("agg_stats", schema=f"tpch.{AGG_SCHEMA}", rows=len(cold.rows),
         lineitem_rows=n_li, warm_rows_per_s=n_li / fields["warm_s"],
         kernel_shapes=shapes, exact_columns_equal=exact_ok,
         doubles_within_bound=close_ok, errors=report, result=cold.rows,
         host=host_memory(), **fields, **cache_delta(cache0))
    check(fields["grouped_sums_launches"] > 0,
          "agg_stats did not launch grouped_sums")
    check(exact_ok, "agg_stats counts, checksums or bitwise results differ "
          "from numpy")
    check(close_ok, "agg_stats doubles differ from the exact-sum reference")
    check(same, "agg_stats rows differ between runs")


def first_extreme(values: np.ndarray, idx: np.ndarray, lo: bool):
    """(row of the first extreme of ``values`` over rows ``idx`` in row
    order, number of rows at that extreme)."""
    v = values[idx]
    ext = v.min() if lo else v.max()
    at = v == ext
    return idx[int(np.argmax(at))], int(at.sum())


def nearest_rank(values: np.ndarray, q: float) -> float:
    v = np.sort(values)
    k = int(np.clip(math.floor(q * (len(v) - 1) + 0.5), 0, len(v) - 1))
    return float(v[k])


def agg_order_reference(tpch_mod, device_mod):
    """agg_order with numpy alone: the first row (in row order) at each
    group's extreme, the nearest rank of np.sort per group; the rows that
    tie at each extreme."""
    lanes, dicts, n_li = agg_lanes(tpch_mod, device_mod, AGG_ORDER_COLS)
    price, ties = lanes["l_extendedprice"], []
    grouped = []
    for (flag, status), mask in groups_of(
            lanes, dicts, ["l_returnflag", "l_linestatus"]):
        idx = np.flatnonzero(mask)
        lo, t_lo = first_extreme(price, idx, True)
        hi, t_hi = first_extreme(price, idx, False)
        ties.append({"group": [flag, status], "min_ties": t_lo,
                     "max_ties": t_hi})
        grouped.append([flag, status, int(lanes["l_orderkey"][lo]),
                        int(lanes["l_partkey"][hi]),
                        nearest_rank(price[idx], 0.5),
                        nearest_rank(lanes["l_quantity"][idx], 0.9)])
    idx = np.flatnonzero(lanes["l_shipdate"] >= days(1995, 1, 1))
    lo, t_lo = first_extreme(lanes["l_discount"], idx, True)
    hi, t_hi = first_extreme(price, idx, False)
    ties.append({"group": "global", "min_ties": t_lo, "max_ties": t_hi})
    glob = [[int(lanes["l_orderkey"][lo]), int(lanes["l_orderkey"][hi]),
             nearest_rank(lanes["l_discount"][idx], 0.25)]]
    return [grouped, glob], ties, n_li


def phase_agg_order(runner, cuda_groupby, tpch_mod, device_mod):
    """min_by/max_by and approx_percentile at tpch.sf10 over all
    60,007,494 lineitem rows at once: the general GROUP BY and the global
    path."""
    results = []
    for i, template in enumerate(AGG_ORDER_SQL):
        cache0 = cache_stats()
        cold, fields, same = agg_cold_warm(
            "agg_order", runner, template.format(schema=AGG_SCHEMA),
            cuda_groupby)
        results.append((cold, dict(fields, **cache_delta(cache0)), same))
        torch.cuda.empty_cache()
    want, ties, n_li = agg_order_reference(tpch_mod, device_mod)
    for i, ((cold, fields, same), w) in enumerate(zip(results, want)):
        ok = cold.rows == w
        emit("agg_order", query=i, schema=f"tpch.{AGG_SCHEMA}",
             rows=len(cold.rows), lineitem_rows=n_li,
             warm_rows_per_s=n_li / fields["warm_s"],
             matches_numpy_reference=ok, result=cold.rows, reference=w,
             ties=ties, host=host_memory(), **fields)
        check(ok, f"agg_order query {i} differs from numpy")
        check(same, f"agg_order query {i} rows differ between runs")


def clz64_np(w: np.ndarray) -> np.ndarray:
    """Leading zeros of uint64 values (64 for 0)."""
    n = np.zeros(w.shape, np.int64)
    x = w.copy()
    for k in (32, 16, 8, 4, 2, 1):
        clear = (x >> np.uint64(64 - k)) == 0
        n += np.where(clear, k, 0)
        x = np.where(clear, x << np.uint64(k), x)
    return np.where(w == 0, 64, n)


def hll_reference(values: np.ndarray, gid: np.ndarray, ngroups: int,
                  b: int):
    """Dense HLL registers per group in numpy (hash, bucket = top b
    bits, rank = leading zeros of the rest + 1, per-bucket max), and the
    estimator with linear counting: (unrounded estimates, registers)."""
    m = 1 << b
    h = mix64_np(values)
    bucket = (h >> np.uint64(64 - b)).astype(np.int64)
    w = h << np.uint64(b)
    rank = np.where(w == 0, 64 - b + 1,
                    np.minimum(clz64_np(w), 64 - b) + 1)
    regs = np.zeros(ngroups * m, np.int64)
    np.maximum.at(regs, gid.astype(np.int64) * m + bucket, rank)
    regs = regs.reshape(ngroups, m)
    return [hll_estimate(r, b) for r in regs], regs


def hll_estimate(regs: np.ndarray, b: int) -> float:
    m = 1 << b
    alpha = (0.673 if m == 16 else 0.697 if m == 32
             else 0.709 if m == 64 else 0.7213 / (1.0 + 1.079 / m))
    z = math.fsum((2.0 ** -regs.astype(np.float64)).tolist())
    zeros = int((regs == 0).sum())
    raw = alpha * m * m / z
    if raw <= 2.5 * m and zeros > 0:
        return m * math.log(m / zeros)
    return raw


def hll_matches(got: int, est: float) -> bool:
    """Equal to the rounded estimate; 1 off only when the estimate lies
    within 1e-9 (relative) of a .5 rounding edge."""
    if got == round(est):
        return True
    edge = abs(est - math.floor(est) - 0.5) <= 1e-9 * abs(est)
    return edge and abs(got - est) <= 0.5 + 1e-9 * abs(est)


def phase_agg_hll(runner, cuda_groupby, tpch_mod, device_mod):
    """approx_set and cardinality at tpch.sf10 on the card, grouped and
    global, and merge of the grouped sketches on the host."""
    results = []
    for template in AGG_HLL_SQL:
        cache0 = cache_stats()
        cold, fields, same = agg_cold_warm(
            "agg_hll", runner, template.format(schema=AGG_SCHEMA),
            cuda_groupby)
        results.append((cold, dict(fields, **cache_delta(cache0)), same))
        torch.cuda.empty_cache()
    lanes, dicts, n_li = agg_lanes(tpch_mod, device_mod, AGG_HLL_COLS)
    flags, gid = [], np.zeros(n_li, np.int64)
    for i, ((flag,), mask) in enumerate(groups_of(lanes, dicts,
                                                  ["l_returnflag"])):
        flags.append(flag)
        gid[mask] = i
    part, supp = lanes["l_partkey"], lanes["l_suppkey"]
    est_p, regs_p = hll_reference(part, gid, len(flags), HLL_BITS_DEFAULT)
    est_s, _ = hll_reference(supp, gid, len(flags), HLL_BITS_001)
    est_all = hll_estimate(regs_p.max(axis=0), HLL_BITS_DEFAULT)

    def exact(values):
        seen = np.zeros((len(flags), int(values.max()) + 1), bool)
        seen[gid, values] = True
        return seen.sum(axis=1), int(seen.any(axis=0).sum())
    ex_p, ex_all = exact(part)
    ex_s, _ = exact(supp)
    (g_cold, g_f, g_same), (m_cold, m_f, m_same), (a_cold, a_f, a_same) = \
        results
    checks = []
    for i, flag in enumerate(flags):
        row = g_cold.rows[i] if i < len(g_cold.rows) else [None] * 3
        for got, est, ex, b in ((row[1], est_p[i], ex_p[i],
                                 HLL_BITS_DEFAULT),
                                (row[2], est_s[i], ex_s[i], HLL_BITS_001)):
            checks.append((flag, b, got, est, int(ex)))
    for got in (m_cold.rows[0][0], a_cold.rows[0][0]):
        checks.append(("global", HLL_BITS_DEFAULT, got, est_all, ex_all))
    report, ok_err = [], True
    ok_est = [r[0] for r in g_cold.rows] == flags
    for group, b, got, est, ex in checks:
        sigma = 1.04 / math.sqrt(1 << b)
        match = got is not None and hll_matches(got, est)
        within = got is not None and abs(got - ex) <= 3 * sigma * ex
        ok_est &= match
        ok_err &= within
        report.append({"group": group, "bucket_bits": b, "cardinality": got,
                       "numpy_estimate": est, "exact_distinct": ex,
                       "rel_err_vs_exact": (got - ex) / ex if got else None,
                       "three_sigma": 3 * sigma, "equal": match})
    merge_ok = m_cold.rows == a_cold.rows
    for name, (cold, fields, same) in zip(("grouped", "merge", "global"),
                                          results):
        emit("agg_hll", query=name, schema=f"tpch.{AGG_SCHEMA}",
             rows=len(cold.rows), lineitem_rows=n_li,
             warm_rows_per_s=n_li / fields["warm_s"], result=cold.rows,
             **fields)
    emit("agg_hll_check", estimates=report, equal_numpy_sketch=ok_est,
         within_three_sigma=ok_err, merge_equals_global=merge_ok,
         host=host_memory())
    check(ok_est, "agg_hll cardinalities differ from the numpy sketch")
    check(ok_err, "agg_hll cardinalities beyond 3 standard errors")
    check(merge_ok, "agg_hll merge differs from the global sketch")
    check(g_same and m_same and a_same, "agg_hll rows differ between runs")


def cpu_rows_in_threads(make_runner, sqls, workers: int = 4):
    """[(rows, seconds)] of each SQL through the engine on the CPU,
    ``workers`` queries side by side, each thread with a runner of its
    own from ``make_runner`` (the CPU's sorts and the host generators
    run one core each, so queries side by side use the host's cores)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    local = threading.local()

    def run(sql):
        if not hasattr(local, "runner"):
            local.runner = make_runner()
        t0 = time.perf_counter()
        rows = local.runner.execute(sql).rows
        return rows, time.perf_counter() - t0
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(run, sqls))


def phase_agg_sf1_cpu(runner_mod, session_mod):
    """The aggregate phases' queries and a sketch cast to varbinary at
    tpch.sf1 on the card and through the engine on the CPU: integers,
    sketches and varbinary exact, doubles within rel 1e-9."""
    def runner(device=None):
        return runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpch", schema=AGG_CHECK_SCHEMA),
            device=device)
    card = runner()
    sqls = [t.format(schema=AGG_CHECK_SCHEMA) for t in
            [AGG_STATS_SQL] + AGG_ORDER_SQL + AGG_HLL_SQL + [AGG_WIRE_SQL]]
    on_card = []
    for sql in sqls:
        t0 = time.perf_counter()
        rows = card.execute(sql).rows
        torch.cuda.synchronize()
        on_card.append((rows, time.perf_counter() - t0))
    del card
    t0 = time.perf_counter()
    on_cpu = cpu_rows_in_threads(lambda: runner("cpu"), sqls)
    cpu_wall_s = time.perf_counter() - t0
    report, ok = [], True
    for i, ((card_rows, card_s), (cpu_rows, cpu_s)) in enumerate(
            zip(on_card, on_cpu)):
        if i == 0:
            errs, exact_ok, close_ok = stats_errors(
                card_rows, cpu_rows, [{k: None for k in AGG_STATS_DOUBLES}]
                * len(cpu_rows))
            same = exact_ok and close_ok
            worst = max((e["rel_err"] for e in errs), default=0.0)
        else:
            same = ds_rows_match(card_rows, cpu_rows)
            worst = None
        ok &= same
        report.append({"query": i, "rows": len(cpu_rows), "equal": same,
                       "worst_double_rel_err": worst, "card_s": card_s,
                       "cpu_s": cpu_s})
    emit("agg_sf1_cpu", schema=f"tpch.{AGG_CHECK_SCHEMA}", queries=report,
         cpu_wall_s=cpu_wall_s, card_equals_cpu=ok, host=host_memory())
    check(ok, "aggregate rows on the card differ from the CPU at "
          f"tpch.{AGG_CHECK_SCHEMA}")


def phases_agg(runner_mod, session_mod, cuda_groupby, tpch_mod,
               device_mod):
    emit("host_memory", before="aggregate phases", **host_memory())
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=AGG_SCHEMA))
    phase_agg_stats(runner, cuda_groupby, tpch_mod, device_mod)
    phase_agg_order(runner, cuda_groupby, tpch_mod, device_mod)
    phase_agg_hll(runner, cuda_groupby, tpch_mod, device_mod)
    del runner
    free_device()
    phase_agg_sf1_cpu(runner_mod, session_mod)

# ---- scalar_sf10: the scalar functions and the time lanes at tpch.sf10 ----
# (a) lineitem's packed GROUP BY through grouped_sums, over bitwise,
# width_bucket, date_diff, a named zone's hour across DST, date_trunc,
# year_of_week and crc32; (b) orders grouped on a TIMESTAMP WITH TIME
# ZONE key; (c) the digests and hashes of every customer name
SCALAR_SCHEMA = "sf10"
SCALAR_ZONE = "America/Los_Angeles"
SCALAR_LI_COLS = ["l_orderkey", "l_extendedprice", "l_shipdate",
                  "l_commitdate", "l_receiptdate", "l_shipmode",
                  "l_returnflag", "l_linestatus"]
SCALAR_LINEITEM_SQL = (
    "SELECT l_returnflag, l_linestatus, count(*), "
    "count_if(bitwise_and(l_orderkey, 7) = 3), "
    "sum(CAST(bitwise_right_shift(l_orderkey, 3) % 1000 AS DOUBLE)), "
    "sum(CAST(width_bucket(l_extendedprice, 900, 105000, 16) AS DOUBLE)), "
    "sum(CAST(date_diff('day', l_shipdate, l_receiptdate) AS DOUBLE)), "
    "count_if(hour(at_timezone(CAST(l_shipdate AS TIMESTAMP) "
    f"+ INTERVAL '13' HOUR, '{SCALAR_ZONE}')) = 6), "
    "sum(CAST(day_of_week(date_trunc('month', l_commitdate)) AS DOUBLE)), "
    "count_if(year_of_week(l_receiptdate) <> year(l_receiptdate)), "
    "count_if(crc32(to_utf8(l_shipmode)) % 2 = 1), "
    "sum(l_extendedprice / (1 + bitwise_and(l_orderkey, 3))) "
    "FROM tpch.{schema}.lineitem GROUP BY 1, 2 ORDER BY 1, 2")
SCALAR_ORDERS_ZONE = "Asia/Kolkata"     # +05:30 since 1945
SCALAR_ORDERS_SQL = (
    "SELECT date_trunc('quarter', CAST(o_orderdate AS TIMESTAMP) "
    f"AT TIME ZONE '{SCALAR_ORDERS_ZONE}'), count(*), sum(o_totalprice), "
    "count(DISTINCT date_format(o_orderdate, '%Y-%m')) "
    "FROM tpch.{schema}.orders GROUP BY 1 ORDER BY 1")
SCALAR_CUSTOMER_SQL = (
    "SELECT count(*), count(DISTINCT md5(to_utf8(c_name))), "
    "count(DISTINCT sha256(to_utf8(c_name))), sum(crc32(to_utf8(c_name))), "
    "sum(xxhash64(to_utf8(c_name)) % 1000003), "
    "sum(from_base(substr(md5(to_utf8(c_name)), 1, 8), 16)), "
    "sum(from_base(substr(sha256(to_utf8(c_name)), 1, 8), 16)) "
    "FROM tpch.{schema}.customer")


def day_table(lo: int, hi: int, fn) -> np.ndarray:
    """``fn(date)`` for each day lo..hi since 1970, by python's calendar:
    a row's value is then ``table[day - lo]``."""
    epoch = datetime.date(1970, 1, 1)
    return np.asarray([fn(epoch + datetime.timedelta(days=d))
                       for d in range(lo, hi + 1)], np.int64)


def day_range(*lanes):
    return (min(int(x.min()) for x in lanes),
            max(int(x.max()) for x in lanes))


def scalar_lineitem_reference(lanes, dicts):
    """scalar_sf10's lineitem query with numpy and python's calendar and
    zoneinfo (once a day of the range): per (flag, status) group the
    counts and the integer-valued sums exactly, the double sum by numpy's
    pairwise sum."""
    from zoneinfo import ZoneInfo
    import zlib
    ok = lanes["l_orderkey"].astype(np.int64)
    price = lanes["l_extendedprice"].astype(np.float64)
    ship, commit, receipt = (lanes[c].astype(np.int64) for c in
                             ("l_shipdate", "l_commitdate",
                              "l_receiptdate"))
    lo, hi = day_range(ship, commit, receipt)
    zi, utc = ZoneInfo(SCALAR_ZONE), datetime.timezone.utc
    hour = day_table(lo, hi, lambda d: datetime.datetime(
        d.year, d.month, d.day, 13, tzinfo=utc).astimezone(zi).hour)
    dow_of_month = day_table(lo, hi, lambda d: d.replace(day=1)
                             .isoweekday())
    iso_year_differs = day_table(lo, hi, lambda d: d.isocalendar()[0]
                                 != d.year)
    bucket = np.clip(np.floor((price - 900.0) / ((105000.0 - 900.0) / 16.0))
                     .astype(np.int64) + 1, 0, 17)
    crc = np.asarray([zlib.crc32(str(m).encode()) % 2
                      for m in dicts["l_shipmode"]])[lanes["l_shipmode"]]
    terms = [np.ones_like(ok), (ok & 7) == 3, (ok >> 3) % 1000, bucket,
             receipt - ship, hour[ship - lo] == 6,
             dow_of_month[commit - lo], iso_year_differs[receipt - lo],
             crc == 1]
    flags, stats = dicts["l_returnflag"], dicts["l_linestatus"]
    key = lanes["l_returnflag"].astype(np.int64) * len(stats) \
        + lanes["l_linestatus"]
    nkey = len(flags) * len(stats)
    # integer terms: bincount's float64 sums are exact below 2^53
    sums = [np.bincount(key, weights=t.astype(np.float64), minlength=nkey)
            for t in terms]
    rows = []
    for g in range(nkey):
        if sums[0][g] == 0:
            continue
        m = key == g
        vals = [int(x[g]) for x in sums]
        rows.append([str(flags[g // len(stats)]), str(stats[g % len(stats)])]
                    + vals[:2] + [float(v) for v in vals[2:5]]
                    + [vals[5], float(vals[6]), vals[7], vals[8],
                       float(np.sum(price[m] / (1 + (ok[m] & 3))))])
    return sorted(rows, key=lambda r: (r[0], r[1]))


def scalar_orders_reference(odate: np.ndarray, price: np.ndarray):
    """scalar_sf10's orders query with numpy and python's calendar:
    midnight UTC of a date is 05:30 of the same date in Kolkata, so each
    order falls in its own date's quarter, whose start is an instant 05:30
    before that day's UTC midnight."""
    d = odate.astype(np.int64)
    lo, hi = day_range(d)
    qstart = day_table(lo, hi, lambda t: (datetime.date(
        t.year, (t.month - 1) // 3 * 3 + 1, 1) - datetime.date(1970, 1, 1))
        .days)
    month = day_table(lo, hi, lambda t: t.year * 12 + t.month)
    present = np.bincount(d - lo, minlength=hi - lo + 1) > 0
    keys, gid_of_day = np.unique(qstart, return_inverse=True)
    gid = gid_of_day[d - lo]
    count = np.bincount(gid, minlength=len(keys))
    ist = datetime.timezone(datetime.timedelta(hours=5, minutes=30))
    rows = []
    for k, key in enumerate(keys):
        start = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(key))
        months = np.unique(month[present & (gid_of_day == k)])
        rows.append([datetime.datetime(start.year, start.month, start.day,
                                       tzinfo=ist), int(count[k]),
                     float(np.sum(price[gid == k].astype(np.float64))),
                     int(months.shape[0])])
    return rows


def xxh64_short_np(values) -> np.ndarray:
    """xxHash64 (seed 0) of byte strings shorter than 32 bytes, all of one
    length, in uint64 numpy lanes, as int64."""
    n = len(values[0])
    if n >= 32 or any(len(v) != n for v in values):
        raise ValueError("xxh64_short_np takes strings of one length < 32")
    u = np.uint64
    p1, p2, p3, p4, p5 = (u(0x9E3779B185EBCA87), u(0xC2B2AE3D27D4EB4F),
                          u(0x165667B19E3779F9), u(0x85EBCA77C2B2AE63),
                          u(0x27D4EB2F165667C5))
    buf = np.frombuffer(b"".join(values), np.uint8).reshape(len(values), n)

    def word(at, size):
        w = np.zeros(len(values), np.uint64)
        for b in range(size):
            w |= buf[:, at + b].astype(np.uint64) << u(8 * b)
        return w

    def rotl(x, r):
        return (x << u(r)) | (x >> u(64 - r))
    with np.errstate(over="ignore"):
        h = np.full(len(values), p5, np.uint64) + u(n)
        i = 0
        while i + 8 <= n:
            k = rotl(word(i, 8) * p2, 31) * p1
            h = rotl(h ^ k, 27) * p1 + p4
            i += 8
        if i + 4 <= n:
            h = rotl(h ^ (word(i, 4) * p1), 23) * p2 + p3
            i += 4
        while i < n:
            h = rotl(h ^ (buf[:, i].astype(np.uint64) * p5), 11) * p1
            i += 1
        h ^= h >> u(33)
        h *= p2
        h ^= h >> u(29)
        h *= p3
        h ^= h >> u(32)
    return h.view(np.int64)


def scalar_customer_reference(names):
    """scalar_sf10's customer query with hashlib, zlib and a numpy
    xxHash64, in python integers."""
    import hashlib
    import zlib
    raw = [str(s).encode() for s in names]
    md5 = [hashlib.md5(b).hexdigest() for b in raw]
    sha = [hashlib.sha256(b).hexdigest() for b in raw]
    xx = xxh64_short_np(raw)
    return [[len(raw), len(set(md5)), len(set(sha)),
             sum(zlib.crc32(b) for b in raw),
             int(np.fmod(xx, 1000003).sum()),
             sum(int(h[:8], 16) for h in md5),
             sum(int(h[:8], 16) for h in sha)]]


def scalar_rows_errors(got, want):
    """The cells where ``got`` differs from ``want``: integers, strings
    and timestamps (and their offsets) exact, doubles within SUM_REL."""
    if len(got) != len(want):
        return [{"rows": len(got), "want_rows": len(want)}]
    errors = []
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if isinstance(b, float):
                bad = not (isinstance(a, float)
                           and abs(a - b) <= SUM_REL * abs(b))
            else:
                bad = a != b or (isinstance(b, datetime.datetime)
                                 and a.utcoffset() != b.utcoffset())
            if bad:
                errors.append({"row": i, "column": j, "got": a, "want": b})
    return errors


def customer_names(tpch_mod, sf: float):
    """c_name of every customer, from the host generator."""
    n = tpch_mod.table_rows("customer", sf)
    batch = tpch_mod.TpchConnector(device="cpu")._customer(
        np.arange(1, n + 1, dtype=np.int64), sf, ["c_name"])
    col = batch.column("c_name")
    return col.dictionary.values[col.data[:n].numpy()]


def scalar_references(tpch_mod, device_mod, schema: str, device=DEVICE):
    """The numpy rows of scalar_sf10's three queries at ``schema``, over
    the lanes the device generates and the host's customer names."""
    sf = tpch_mod.SCHEMAS[schema]
    n_orders = tpch_mod.table_rows("orders", sf)
    lanes, dicts, n_li = card_lanes(device_mod, "lineitem", SCALAR_LI_COLS,
                                    sf, n_orders, device)
    li = scalar_lineitem_reference(lanes, dicts)
    del lanes
    olanes, _, _ = card_lanes(device_mod, "orders",
                              ["o_orderdate", "o_totalprice"], sf,
                              n_orders, device)
    orders = scalar_orders_reference(olanes["o_orderdate"],
                                     olanes["o_totalprice"])
    cust = scalar_customer_reference(customer_names(tpch_mod, sf))
    return {"lineitem": li, "orders": orders, "customer": cust}, n_li


def phase_scalar(runner_mod, session_mod, cuda_groupby, tpch_mod,
                 device_mod):
    """scalar_sf10: the three queries at tpch.sf10 through
    LocalQueryRunner().execute, cold and warm, against numpy."""
    t_phase = time.perf_counter()
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=SCALAR_SCHEMA))
    runs = {}
    for name, sql, reps in (("lineitem", SCALAR_LINEITEM_SQL, 1),
                            ("orders", SCALAR_ORDERS_SQL, 2),
                            ("customer", SCALAR_CUSTOMER_SQL, 1)):
        cache0 = cache_stats()
        cold, warm, cold_s, warm_s, peak, launches = run_timed(
            "scalar_sf10", runner, sql.format(schema=SCALAR_SCHEMA),
            cuda_groupby, reps)
        runs[name] = (cold, dict(
            cold_s=cold_s, warm_s=warm_s, warm_runs=len(warm),
            max_memory_allocated=peak, grouped_sums_launches=launches,
            kernel_shapes=sorted(f"{k[0]}x{k[1]}x{k[2]}"
                                 for k in _COLD["last"]),
            same_rows_every_run=all(w.rows == cold.rows for w in warm),
            **cache_delta(cache0)))
        torch.cuda.empty_cache()
    del runner
    free_device()
    t_ref = time.perf_counter()
    want, n_li = scalar_references(tpch_mod, device_mod, SCALAR_SCHEMA)
    ref_s = time.perf_counter() - t_ref
    ok = True
    for name, (cold, fields) in runs.items():
        errors = scalar_rows_errors(cold.rows, want[name])
        emit("scalar_sf10", query=name, schema=f"tpch.{SCALAR_SCHEMA}",
             rows=len(cold.rows), result=cold.rows, equal_numpy=not errors,
             errors=errors[:10], **fields)
        ok &= not errors and fields["same_rows_every_run"]
        check(not errors, f"scalar_sf10 {name} differs from numpy")
        check(fields["same_rows_every_run"],
              f"scalar_sf10 {name} rows differ between runs")
    check(runs["lineitem"][1]["grouped_sums_launches"] > 0,
          "scalar_sf10 did not launch grouped_sums")
    emit("scalar_sf10_total", lineitem_rows=n_li, reference_s=ref_s,
         phase_s=time.perf_counter() - t_phase, host=host_memory())


# ---- complex_sf10: ARRAY, MAP and ROW lanes, lambdas, UNNEST and the ----
# collection aggregates at tpch.sf10; the quantile digests at tpch.sf1
COMPLEX_SCHEMA = "sf10"
COMPLEX_DIGEST_SCHEMA = "sf1"
COMPLEX_PEAK_BYTES = 40 << 30       # (a)'s bound
DIGEST_RANK_ERR = 0.01              # a digest's rank error (1/compression)
COMPLEX_SQL = {
    # (a) an unpivot: each line item becomes two rows
    "unnest_li": (
        "SELECT l_returnflag, l_linestatus, count(*), sum(p), "
        "sum(CASE WHEN k = 2 THEN p END), max(k) FROM tpch.{schema}.lineitem "
        "CROSS JOIN UNNEST(ARRAY[l_extendedprice, "
        "l_extendedprice * (1 - l_discount)]) WITH ORDINALITY AS t(p, k) "
        "GROUP BY 1, 2"),
    # (b) one array of line items per order, then lambdas over it
    "order_items": (
        "SELECT o_orderpriority, count(*), sum(cardinality(items)), "
        "sum(reduce(items, 0e0, (s, x) -> s + x, s -> s)), "
        "sum(cardinality(filter(items, x -> x > 50000e0))), "
        "count_if(any_match(items, x -> x > 100000e0)), "
        "sum(element_at(array_sort(items), -1)), "
        "sum(array_max(transform(items, x -> x * 2e0))) "
        "FROM tpch.{schema}.orders JOIN (SELECT l_orderkey AS k, "
        "array_agg(l_extendedprice) AS items FROM tpch.{schema}.lineitem "
        "GROUP BY l_orderkey) li ON o_orderkey = k GROUP BY o_orderpriority"),
    # (c) maps and rows
    "histogram": (
        "SELECT l_returnflag, histogram(l_shipmode), "
        "element_at(histogram(l_shipinstruct), 'NONE') "
        "FROM tpch.{schema}.lineitem GROUP BY 1"),
    "map_filter": (
        "SELECT sum(cardinality(map_filter(MAP(ARRAY['q', 'p', 'd'], "
        "ARRAY[l_quantity, l_extendedprice, l_discount]), "
        "(k, v) -> v > 10e0))) FROM tpch.{schema}.lineitem"),
    "row_field": (
        "SELECT r.f, count(*), sum(r.p) FROM (SELECT CAST(ROW(l_returnflag, "
        "l_extendedprice) AS ROW(f VARCHAR(1), p DOUBLE)) AS r "
        "FROM tpch.{schema}.lineitem) GROUP BY 1"),
}
COMPLEX_DIGEST_SQL = (
    "SELECT o_orderpriority, value_at_quantile(tdigest_agg(o_totalprice), "
    "0.5e0), values_at_quantiles(qdigest_agg(o_totalprice), "
    "ARRAY[0.1e0, 0.9e0]) FROM tpch.{schema}.orders GROUP BY 1")
COMPLEX_LI_COLS = ["l_orderkey", "l_returnflag", "l_linestatus",
                   "l_quantity", "l_extendedprice", "l_discount",
                   "l_shipmode", "l_shipinstruct"]


def nested_match(got, want) -> bool:
    """Rows equal in order: doubles within SUM_REL, lists element by
    element, dicts entry by entry, everything else exactly."""
    if isinstance(want, float) and isinstance(got, float):
        return abs(got - want) <= SUM_REL * abs(want)
    if isinstance(want, dict) and isinstance(got, dict):
        return got.keys() == want.keys() and all(
            nested_match(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        return len(got) == len(want) and all(
            nested_match(g, w) for g, w in zip(got, want))
    return type(got) is type(want) and got == want


def by_key(rows):
    return sorted(rows, key=lambda r: [str(x) for x in r[:2]])


def per_group(fn, groups):
    """[fn(names, mask) for each of ``groups_of``'s groups], four groups at
    a time in threads (numpy releases the interpreter in its work; each
    group's result is that of one thread)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(lambda g: fn(*g), groups))


def complex_references(tpch_mod, device_mod, schema: str, device=DEVICE):
    """The numpy rows of complex_sf10's queries (a)-(c) at ``schema``
    over the lanes the device generates, each query's rows sorted by its
    keys; and the lineitem row count."""
    sf = tpch_mod.SCHEMAS[schema]
    n_orders = tpch_mod.table_rows("orders", sf)
    li, dicts, n_li = card_lanes(device_mod, "lineitem", COMPLEX_LI_COLS,
                                 sf, n_orders, device)
    od, odicts, _ = card_lanes(device_mod, "orders",
                               ["o_orderkey", "o_orderpriority"], sf,
                               n_orders, device)
    price, disc = li["l_extendedprice"], li["l_discount"]
    p2 = price * (1 - disc)
    out = {}
    # (a): per (flag, status), both elements of each line
    out["unnest_li"] = per_group(
        lambda names, m: [*names, 2 * int(m.sum()),
                          fsum(np.concatenate([price[m], p2[m]])),
                          fsum(p2[m]), 2],
        groups_of(li, dicts, ["l_returnflag", "l_linestatus"]))
    # (b): per order (lineitem comes in l_orderkey order), then per
    # priority over the orders that have items
    key = li["l_orderkey"]
    check(bool(np.all(np.diff(key) >= 0)), "lineitem not in order-key order")
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    cnt = np.diff(np.r_[first, len(key)])
    total = np.add.reduceat(price, first)
    over = np.add.reduceat((price > 50000.0).astype(np.int64), first)
    top = np.maximum.reduceat(price, first)
    pos = np.searchsorted(od["o_orderkey"], key[first])
    check(bool(np.all(od["o_orderkey"][pos] == key[first])),
          "a lineitem order is missing from orders")
    prio = od["o_orderpriority"][pos]
    rows = []
    for code in np.flatnonzero(np.bincount(prio)):
        m = prio == code
        rows.append([str(odicts["o_orderpriority"][code]), int(m.sum()),
                     int(cnt[m].sum()), fsum(total[m]), int(over[m].sum()),
                     int((top[m] > 100000.0).sum()), fsum(top[m]),
                     fsum(2.0 * top[m])])
    out["order_items"] = rows
    # (c): histograms per flag, map_filter's surviving entries, row fields
    rows = []
    modes, instr = dicts["l_shipmode"], dicts["l_shipinstruct"]
    for names, m in groups_of(li, dicts, ["l_returnflag"]):
        hist = np.bincount(li["l_shipmode"][m], minlength=len(modes))
        inst = np.bincount(li["l_shipinstruct"][m], minlength=len(instr))
        none = [int(inst[i]) for i, v in enumerate(instr) if v == "NONE"
                and inst[i] > 0]
        rows.append([names[0], {str(modes[i]): int(c)
                                for i, c in enumerate(hist) if c},
                     none[0] if none else None])
    out["histogram"] = rows
    out["map_filter"] = [[int((li["l_quantity"] > 10.0).sum()
                              + (price > 10.0).sum() + (disc > 10.0).sum())]]
    out["row_field"] = per_group(
        lambda names, m: [names[0], int(m.sum()), fsum(price[m])],
        groups_of(li, dicts, ["l_returnflag"]))
    return out, n_li


@contextlib.contextmanager
def record_digest_builds(groupby_mod):
    """Seconds the host spends building digests (ops/groupby.py's
    grouped_digest and grouped_digest_merge), through the names the
    engine calls, while the block runs; the names are put back after."""
    spent = {"s": 0.0, "calls": 0}
    saved = {name: getattr(groupby_mod, name)
             for name in ("grouped_digest", "grouped_digest_merge")}

    def timed(inner):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
        return run
    for name, inner in saved.items():
        setattr(groupby_mod, name, timed(inner))
    try:
        yield spent
    finally:
        for name, inner in saved.items():
            setattr(groupby_mod, name, inner)


def phase_complex(runner_mod, session_mod, cuda_groupby, tpch_mod,
                  device_mod):
    """complex_sf10: (a)-(c) at tpch.sf10 through
    LocalQueryRunner().execute, cold and warm, against numpy over the
    card's lanes; (d) the digests at tpch.sf1, the card's rows against
    the engine's on the CPU and each quantile within the digest's rank
    error of numpy's exact one."""
    from trino_tpu_torch.ops import groupby as groupby_mod
    t_phase = time.perf_counter()
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=COMPLEX_SCHEMA))
    runs = {}
    for name, sql in COMPLEX_SQL.items():
        cold, warm, cold_s, warm_s, peak, launches = run_timed(
            f"complex_{name}", runner, sql.format(schema=COMPLEX_SCHEMA),
            cuda_groupby, 1)
        runs[name] = (cold, dict(
            cold_s=cold_s, warm_s=warm_s, max_memory_allocated=peak,
            grouped_sums_launches=launches,
            grouped_sums_shapes=[[*k, v] for k, v
                                 in sorted(_COLD["last"].items())],
            same_rows_warm=warm[0].rows == cold.rows,
            join_sizes=cold.join_sizes, spill_bytes=cold.spill_bytes))
        emit("complex_run", query=name, **runs[name][1])
        torch.cuda.empty_cache()
    del runner
    free_device()
    t_ref = time.perf_counter()
    want, n_li = complex_references(tpch_mod, device_mod, COMPLEX_SCHEMA)
    ref_s = time.perf_counter() - t_ref
    free_device()
    for name, (cold, fields) in runs.items():
        got = by_key(cold.rows)
        ok = nested_match(got, by_key(want[name]))
        emit("complex_sf10", query=name, schema=f"tpch.{COMPLEX_SCHEMA}",
             rows=len(got), result=got if name != "order_items" else
             got[:2], equal_numpy=ok, lineitem_rows=n_li,
             warm_rows_per_s=n_li / fields["warm_s"], **fields)
        check(ok, f"complex_sf10 {name} differs from numpy")
        check(fields["same_rows_warm"],
              f"complex_sf10 {name} warm rows differ from the cold rows")
    for name in ("unnest_li", "order_items"):
        check(runs[name][1]["grouped_sums_launches"] > 0,
              f"complex_sf10 {name} did not launch grouped_sums")
    check(runs["unnest_li"][1]["max_memory_allocated"] < COMPLEX_PEAK_BYTES,
          "complex_sf10 unnest_li peaked over its bound")

    # (d) the digests at sf1, built on the host
    sql = COMPLEX_DIGEST_SQL.format(schema=COMPLEX_DIGEST_SCHEMA)
    with record_digest_builds(groupby_mod) as spent:
        card = runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpch",
                                schema=COMPLEX_DIGEST_SCHEMA))
        cold, warm, cold_s, warm_s, peak, launches = run_timed(
            "complex_digests", card, sql, cuda_groupby, 1)
        card_build_s = spent["s"]
        del card
        t0 = time.perf_counter()
        cpu = runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpch",
                                schema=COMPLEX_DIGEST_SCHEMA),
            device="cpu")
        on_cpu = cpu.execute(sql).rows
        cpu_s = time.perf_counter() - t0
        del cpu
    sf = tpch_mod.SCHEMAS[COMPLEX_DIGEST_SCHEMA]
    od, odicts, n_o = card_lanes(device_mod, "orders",
                                 ["o_orderpriority", "o_totalprice"], sf,
                                 tpch_mod.table_rows("orders", sf))
    rank_err = 0.0
    for row in cold.rows:
        code = odicts["o_orderpriority"].index(row[0])
        vals = np.sort(od["o_totalprice"][od["o_orderpriority"] == code])
        for q, v in ((0.5, row[1]), (0.1, row[2][0]), (0.9, row[2][1])):
            lo = np.searchsorted(vals, v, "left") / len(vals)
            hi = np.searchsorted(vals, v, "right") / len(vals)
            rank_err = max(rank_err, 0.0 if lo <= q <= hi
                           else min(abs(lo - q), abs(hi - q)))
    same_cpu = nested_match(by_key(cold.rows), by_key(on_cpu))
    emit("complex_sf10", query="digests_sf1",
         schema=f"tpch.{COMPLEX_DIGEST_SCHEMA}", rows=len(cold.rows),
         result=by_key(cold.rows), orders_rows=n_o, cold_s=cold_s,
         warm_s=warm_s, warm_rows_per_s=n_o / warm_s,
         max_memory_allocated=peak, grouped_sums_launches=launches,
         digest_build_s_card=card_build_s,
         digest_build_s_all=spent["s"], digest_builds=spent["calls"],
         cpu_s=cpu_s, card_equals_cpu=same_cpu,
         same_rows_warm=warm[0].rows == cold.rows,
         max_rank_err=rank_err, rank_err_bound=DIGEST_RANK_ERR)
    check(same_cpu, "complex_sf10 digests on the card differ from the CPU")
    check(warm[0].rows == cold.rows,
          "complex_sf10 digests warm rows differ from the cold rows")
    check(rank_err <= DIGEST_RANK_ERR,
          f"complex_sf10 digest quantile off by rank {rank_err}")
    emit("complex_sf10_total", lineitem_rows=n_li, reference_s=ref_s,
         phase_s=time.perf_counter() - t_phase, host=host_memory())


# the statement layer at tpch.sf10: a copy of lineitem's q1 columns (and
# l_orderkey) in the memory catalog, written, queried, deleted from,
# updated and rolled back on the card
DML_SCHEMA = "sf10"
DML_TABLE = "memory.default.li"
DML_COLS = ["l_orderkey", "l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]


def dml_step(step: str, runner, sql: str, cuda_groupby=None, **extra):
    """One statement of the dml_sf10 phase, timed, with its peak device
    memory; a query given ``cuda_groupby`` runs as a cold run (its
    grouped_sums launches counted from 0 and recorded by shape)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if cuda_groupby is not None:
        result, wall, launches = cold_run(f"dml_sf10_{step}", runner, sql,
                                          cuda_groupby)
        extra["grouped_sums_launches"] = launches
    else:
        t0 = time.perf_counter()
        result = runner.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit("dml_sf10", step=step, wall_s=wall,
         rows=(result.update_count if result.update_type
               else len(result.rows)),
         update_type=result.update_type,
         peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         **extra)
    return result


def stored_table(runner, n: int):
    """The memory table, checked: n rows, every lane on the card, each
    chunk in lanes of capacity_for(its rows), their capacities summing to
    no more than capacity_for(n). Returns a line's fields."""
    from trino_tpu_torch.config import capacity_for
    from trino_tpu_torch.exec.scancache import col_bytes
    chunks = runner.catalogs.connector("memory").stored_chunks(
        "default", "li")
    rows = [c.num_rows_host() for c in chunks]
    check(sum(rows) == n, f"dml_sf10: {sum(rows)} rows stored, not {n}")
    for c, r in zip(chunks, rows):
        check(c.capacity == capacity_for(r, minimum=8),
              f"dml_sf10: a chunk of {r} rows has capacity {c.capacity}")
        for col in c.columns.values():
            for t in (col.data, col.valid, col.data2):
                check(t is None or t.device.type == DEVICE.type,
                      "dml_sf10: a stored lane is not on the card")
    capacity = sum(c.capacity for c in chunks)
    check(capacity <= capacity_for(n), f"dml_sf10: the chunks hold "
          f"{capacity} rows, more than capacity_for({n})")
    return {"chunks": len(chunks), "chunk_rows_max": max(rows),
            "stored_capacity": capacity, "capacity_for_n": capacity_for(n),
            "stored_bytes": sum(col_bytes(col) for c in chunks
                                for col in c.columns.values())}


def q1_rows_except(rows, drop_flag=None):
    return [r for r in rows if r[0] != drop_flag]


def phase_dml(runner_mod, session_mod, cuda_groupby, tpch_mod, device_mod,
              q1_sql, q1_rows):
    """CREATE TABLE AS, q1, DELETE, UPDATE, INSERT, a rolled-back DELETE,
    OFFSET, TABLESAMPLE and DROP TABLE at tpch.sf10 through the runner,
    against the q1 phase's rows and numpy over the card's lanes."""
    sf = tpch_mod.SCHEMAS[DML_SCHEMA]
    lanes, dicts, n = card_lanes(device_mod, "lineitem",
                                 ["l_orderkey", "l_returnflag",
                                  "l_linestatus"], sf,
                                 tpch_mod.table_rows("orders", sf))
    is_r = lanes["l_returnflag"] == dicts["l_returnflag"].index("R")
    is_o = lanes["l_linestatus"] == dicts["l_linestatus"].index("O")
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=DML_SCHEMA), DEVICE)
    cols = ", ".join(DML_COLS)
    q1_mem = q1_sql.replace("lineitem", DML_TABLE)
    check(q1_mem != q1_sql, "dml_sf10: q1's text names no lineitem")
    before = torch.cuda.memory_allocated()

    res = dml_step("ctas", runner, f"CREATE TABLE {DML_TABLE} AS SELECT "
                   f"{cols} FROM tpch.{DML_SCHEMA}.lineitem")
    check(res.update_count == n, f"dml_sf10: CTAS wrote {res.update_count} "
          f"rows, not {n}")
    emit("dml_sf10", step="stored", rows=n, **stored_table(runner, n),
         allocated_over_before=torch.cuda.memory_allocated() - before)

    def q1(step, want, **extra):
        res = dml_step(step, runner, q1_mem, cuda_groupby, **extra)
        check(res.rows and cuda_groupby.LAUNCHES > 0,
              f"dml_sf10: q1 ({step}) did not launch grouped_sums")
        if want is not None:
            check(rows_match(res.rows, want), f"dml_sf10: q1 ({step}) "
                  f"rows differ: {res.rows} against {want}")
        return res.rows

    q1("q1", q1_rows)
    res = dml_step("delete", runner,
                   f"DELETE FROM {DML_TABLE} WHERE l_returnflag = 'R'")
    check(res.update_count == int(is_r.sum()), "dml_sf10: DELETE count")
    q1("q1_after_delete", q1_rows_except(q1_rows, "R"))
    res = dml_step("update", runner, f"UPDATE {DML_TABLE} SET "
                   "l_discount = 0 WHERE l_linestatus = 'O'")
    check(res.update_count == int((is_o & ~is_r).sum()),
          "dml_sf10: UPDATE count")
    got = q1("q1_after_update", None)
    want_f = [r for r in q1_rows_except(q1_rows, "R") if r[1] == "F"]
    check(rows_match([r for r in got if r[1] == "F"], want_f),
          "dml_sf10: UPDATE changed the F groups")
    updated = [r for r in got if r[1] == "O"]
    before_o = [r for r in q1_rows if r[1] == "O"]
    check(len(updated) == len(before_o) >= 1, "dml_sf10: the O groups")
    for new, old in zip(updated, before_o):
        check(new[8] == 0.0, "dml_sf10: avg_disc of an O group is not 0")
        check(abs(new[4] - new[3]) <= SUM_REL * abs(new[3]),
              "dml_sf10: sum_disc_price != sum_base_price in an O group")
        check(rows_match([new[:4] + new[6:8] + new[9:]],
                         [old[:4] + old[6:8] + old[9:]]),
              "dml_sf10: UPDATE changed an O group's other sums")
    res = dml_step("insert", runner, f"INSERT INTO {DML_TABLE} SELECT "
                   f"{cols} FROM tpch.{DML_SCHEMA}.lineitem "
                   "WHERE l_returnflag = 'R'")
    check(res.update_count == int(is_r.sum()), "dml_sf10: INSERT count")
    got = q1("q1_after_insert", None)
    check(rows_match([r for r in got if r[1] == "F"],
                     [r for r in q1_rows if r[1] == "F"]),
          "dml_sf10: after INSERT the F groups differ from tpch.sf10")
    check(rows_match([r for r in got if r[1] == "O"], updated),
          "dml_sf10: after INSERT the O groups differ from the update")
    emit("dml_sf10", step="stored_after_insert", rows=n,
         **stored_table(runner, n))

    dml_step("start", runner, "START TRANSACTION")
    res = dml_step("delete_all", runner, f"DELETE FROM {DML_TABLE}")
    check(res.update_count == n, "dml_sf10: DELETE in the transaction")
    check(runner.execute(f"SELECT count(*) FROM {DML_TABLE}").rows
          == [[0]], "dml_sf10: the table is not empty in the transaction")
    dml_step("rollback", runner, "ROLLBACK")
    res = dml_step("count", runner, f"SELECT count(*) FROM {DML_TABLE}")
    check(res.rows == [[n]], "dml_sf10: ROLLBACK lost rows")

    res = dml_step("offset", runner, f"SELECT DISTINCT l_orderkey FROM "
                   f"{DML_TABLE} ORDER BY 1 DESC LIMIT 5 OFFSET 10")
    keys = np.unique(lanes["l_orderkey"])[::-1][10:15]
    check(res.rows == [[int(k)] for k in keys],
          f"dml_sf10: OFFSET rows {res.rows}, numpy {keys.tolist()}")

    sample = (f"SELECT count(*) FROM tpch.{DML_SCHEMA}.lineitem "
              "TABLESAMPLE BERNOULLI (10)")
    plan = runner.plan_sql(sample)
    node = plan
    while not type(node).__name__ == "SampleNode":
        node = node.source
    check(type(node.source).__name__ == "TableScanNode",
          "dml_sf10: the sample's source is not the scan")
    res = dml_step("tablesample", runner, sample)
    u = (mix64_np(np.arange(n, dtype=np.int64)) >> np.uint64(11)).astype(
        np.float64) / float(1 << 53)
    want = int((u < 0.1).sum())
    check(not res.stream_ops, "dml_sf10: the sample's scan streamed")
    check(res.rows == [[want]], f"dml_sf10: TABLESAMPLE counted "
          f"{res.rows}, numpy {want}")
    del lanes, is_r, is_o, u

    stored = stored_table(runner, n)["stored_bytes"]
    gc.collect()
    held = torch.cuda.memory_allocated()
    dml_step("drop", runner, f"DROP TABLE {DML_TABLE}")
    gc.collect()
    freed = held - torch.cuda.memory_allocated()
    emit("dml_sf10", step="freed", stored_bytes=stored, freed_bytes=freed)
    check(freed >= 0.9 * stored, f"dml_sf10: DROP TABLE freed {freed} "
          f"of {stored} bytes")
    del runner


# ---- files_sf10: lineitem through Parquet and ORC files ----------------

FILES_SCHEMA = "sf10"
FILES_ROWS = 60_007_494         # tpch.sf10 lineitem
FILES_WARM_REPS = 2
FILES_CATALOGS = (("pq", "parquet"), ("orc", "orc"))
# the two copies of Q1_COLS at sf10 take about 46 and 39 B a row
FILES_ROOM_BYTES = 6 << 30
JDBC_SCHEMA = "sf1"
JDBC_COLS = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderpriority"]
JDBC_SQL = ("SELECT o_orderpriority, count(*), sum(o_totalprice) FROM {t} "
            "WHERE o_custkey BETWEEN 1000 AND 60000 GROUP BY 1 ORDER BY 1")


class ReadClock:
    """Times a connector's read_split (file to lanes on the card): the
    seconds and the splits since ``reset``."""

    def __init__(self, conn):
        self.inner = conn.read_split
        conn.read_split = self.read
        self.reset()

    def reset(self):
        self.s = 0.0
        self.splits = 0
        self.rows = 0

    def read(self, split, columns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = self.inner(split, columns)
        torch.cuda.synchronize()
        self.s += time.perf_counter() - t0
        self.splits += 1
        self.rows += batch.num_rows_host()
        return batch


def route_of(result, shapes) -> dict:
    """How an aggregation ran: streamed (chunks by operator) or not, and
    grouped_sums' launches by (rows, lanes, groups)."""
    return {"streamed_ops": dict(result.stream_ops),
            "stream_chunks": result.stream_chunks,
            "grouped_sums_shapes": [[*k, v] for k, v in sorted(
                shapes.items())]}


def files_query(step: str, runner, sql: str, cuda_groupby, clock, want,
                n_file: int, must_launch: bool):
    """A query over a file table, cold then FILES_WARM_REPS warm: each
    run's wall, read wall, decode rate over the file's rows, peak and
    route; its rows against ``want`` (integers and strings exact,
    doubles within SUM_REL)."""
    runs = []
    result = None
    for rep in range(1 + FILES_WARM_REPS):
        clock.reset()
        torch.cuda.reset_peak_memory_stats()
        if rep == 0:
            res, wall, launches = cold_run(f"files_sf10_{step}", runner,
                                           sql, cuda_groupby)
            shapes = dict(_COLD["last"])
            result = res
        else:
            cuda_groupby.LAUNCHES = 0
            t0 = time.perf_counter()
            res = runner.execute(sql)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cuda_groupby.LAUNCHES
            shapes = {}
            check(res.rows == result.rows,
                  f"files_sf10: {step} warm rows differ from cold")
        runs.append({"run": "cold" if rep == 0 else "warm", "wall_s": wall,
                     "read_s": clock.s, "splits": clock.splits,
                     "rows_after_pushdown": clock.rows,
                     "decode_rows_per_s": n_file / clock.s if clock.s
                     else None,
                     "peak_allocated_gb": torch.cuda.max_memory_allocated()
                     / 1e9,
                     "grouped_sums_launches": launches,
                     **route_of(res, shapes)})
    ok = rows_match(result.rows, want)
    emit("files_sf10", step=step, file_rows=n_file, runs=runs,
         rows=len(result.rows), matches_tpch_sf10=ok)
    check(ok, f"files_sf10: {step} rows differ from the tpch.sf10 phase: "
          f"{result.rows} against {want}")
    if must_launch:
        check(runs[0]["grouped_sums_launches"] >= 1,
              f"files_sf10: {step} did not launch grouped_sums")
    return runs


def phase_files(runner_mod, session_mod, cuda_groupby, q1_sql, q1_rows,
                q6_sql, q6_rows):
    """files_sf10: CREATE TABLE AS of tpch.sf10 lineitem's q1 columns into
    a Parquet file and an ORC file (two localfile catalogs, each in a
    temporary directory of its own), q1 and q6 over each copy against
    the tpch.sf10 phases' rows, then DROP TABLE; the files are gone when
    the phase ends, failed or not. Then jdbc_sf1."""
    import os
    import shutil
    import tempfile
    from trino_tpu_torch.connectors.localfile import LocalFileConnector
    free = shutil.disk_usage(tempfile.gettempdir()).free
    emit("files_sf10", step="room", tmp=tempfile.gettempdir(),
         free_bytes=free, needed_bytes=FILES_ROOM_BYTES)
    check(free >= FILES_ROOM_BYTES, f"files_sf10: {free} bytes free in "
          f"{tempfile.gettempdir()}, {FILES_ROOM_BYTES} needed")
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=FILES_SCHEMA), DEVICE)
    runner.session.set("plan_validation", True)
    roots, clocks = {}, {}
    try:
        for cat, fmt in FILES_CATALOGS:
            roots[cat] = tempfile.mkdtemp(prefix=f"files_sf10_{cat}_")
            conn = LocalFileConnector(roots[cat], DEVICE)
            conn.write_format = fmt
            runner.catalogs.register(cat, conn)
            clocks[cat] = ReadClock(conn)
        cols = ", ".join(Q1_COLS)
        for cat, fmt in FILES_CATALOGS:
            conn = runner.catalogs.connector(cat)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = runner.execute(f"CREATE TABLE {cat}.default.li AS SELECT "
                                 f"{cols} FROM tpch.{FILES_SCHEMA}.lineitem")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            path = conn._path_of("li")
            n = res.update_count
            emit("files_sf10", step=f"{cat}_ctas", format=fmt, wall_s=wall,
                 rows=n, file_bytes=os.path.getsize(path),
                 bytes_per_row=os.path.getsize(path) / max(n, 1),
                 write_rows_per_s=n / wall,
                 peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
            check(n == FILES_ROWS, f"files_sf10: {cat} CTAS wrote {n} rows")
        for cat, fmt in FILES_CATALOGS:
            table = f"{cat}.default.li"
            q1 = q1_sql.replace("lineitem", table)
            q6 = q6_sql.replace("lineitem", table)
            check(q1 != q1_sql and q6 != q6_sql,
                  "files_sf10: a query's text names no lineitem")
            files_query(f"{cat}_q1", runner, q1, cuda_groupby, clocks[cat],
                        q1_rows, FILES_ROWS, True)
            files_query(f"{cat}_q6", runner, q6, cuda_groupby, clocks[cat],
                        q6_rows, FILES_ROWS, False)
        for cat, _ in FILES_CATALOGS:
            runner.execute(f"DROP TABLE {cat}.default.li")
            check(not os.listdir(roots[cat]),
                  f"files_sf10: DROP TABLE left files in {cat}")
        emit("files_sf10", step="dropped", plan_validation=True)
    finally:
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)
    del runner
    free_device()
    phase_jdbc(runner_mod, session_mod, cuda_groupby)


def phase_jdbc(runner_mod, session_mod, cuda_groupby):
    """jdbc_sf1: tpch.sf1 orders' four columns loaded into an in-memory
    sqlite database behind the jdbc connector; a grouped query with a
    range on o_custkey, whose domain must reach the remote SQL, equals
    the same query over tpch.sf1.orders."""
    from trino_tpu_torch.connectors.jdbc import SqliteConnector
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=JDBC_SCHEMA), DEVICE)
    t0 = time.perf_counter()
    rows = runner.execute(f"SELECT {', '.join(JDBC_COLS)} FROM "
                          f"tpch.{JDBC_SCHEMA}.orders").rows
    conn = SqliteConnector(":memory:", "public", DEVICE)
    conn.execute_remote("CREATE TABLE orders (o_orderkey BIGINT, o_custkey "
                        "BIGINT, o_totalprice DOUBLE, o_orderpriority TEXT)")
    conn.load_rows("INSERT INTO orders VALUES (?, ?, ?, ?)", rows)
    load_s = time.perf_counter() - t0
    runner.catalogs.register("lite", conn)
    res, wall, launches = cold_run("jdbc_sf1", runner,
                                   JDBC_SQL.format(t="lite.public.orders"),
                                   cuda_groupby)
    remote, params = conn.last_remote
    want = runner.execute(
        JDBC_SQL.format(t=f"tpch.{JDBC_SCHEMA}.orders")).rows
    ok = rows_match(res.rows, want)
    pushed = ('"o_custkey" >= ?' in remote and '"o_custkey" <= ?' in remote
              and params[:2] == [1000, 60000])
    emit("jdbc_sf1", orders_rows=len(rows), load_s=load_s, wall_s=wall,
         remote_sql=remote, remote_params=params, domain_pushed=pushed,
         grouped_sums_launches=launches, rows=res.rows,
         matches_tpch_sf1=ok)
    check(pushed, f"jdbc_sf1: the domain did not reach the remote SQL: "
          f"{remote} {params}")
    check(ok, f"jdbc_sf1: rows {res.rows} differ from tpch.sf1's {want}")
    del runner, conn, rows


# ---- geo_sf10: the geometry functions over lineitem -----------------------

GEO_SCHEMA = "sf10"
GEO_WARM_REPS = 1
GEO_POLYGONS = {
    "AIR": "POLYGON ((25 2, 30 18, 48 20, 34 30, 40 48, 25 37, 10 48, "
           "16 30, 2 20, 20 18, 25 2))",
    "MAIL": "POLYGON ((5 5, 45 5, 45 45, 5 45, 5 5), (15 15, 35 15, "
            "35 35, 15 35, 15 15))",
}
GEO_ELSE = "POLYGON ((0 0, 30 0, 30 30, 0 30, 0 0))"
GEO_SQL = (
    "SELECT l_returnflag, l_linestatus, count(*) AS n, "
    "sum(great_circle_distance(l_discount * 800, l_tax * 2000 - 80, "
    "40.64, -73.78)) AS km, "
    "sum(ST_Distance(ST_Point(l_quantity, l_discount * 500), "
    "ST_Point(25.0, 25.0))) AS d "
    "FROM lineitem "
    "WHERE ST_Contains(ST_GeometryFromText(CASE l_shipmode "
    + " ".join(f"WHEN '{m}' THEN '{p}'" for m, p in GEO_POLYGONS.items())
    + f" ELSE '{GEO_ELSE}' END), "
    "ST_Point(l_quantity, l_discount * 500)) "
    "GROUP BY l_returnflag, l_linestatus")
GEO_COLS = ["l_returnflag", "l_linestatus", "l_quantity", "l_discount",
            "l_tax", "l_shipmode"]


def geo_lanes(tpch_mod, device_mod, schema: str, device=DEVICE):
    """lineitem's GEO_COLS at ``schema`` as the device generates them, on
    the host: (lanes, dictionaries, rows)."""
    sf = tpch_mod.SCHEMAS[schema]
    return card_lanes(device_mod, "lineitem", GEO_COLS, sf,
                      tpch_mod.table_rows("orders", sf), device)


def rings_of(wkt: str):
    """A POLYGON's rings as (xs, ys) float64 arrays."""
    import re
    body = wkt[wkt.index("(") + 1:wkt.rindex(")")]
    out = []
    for ring in re.findall(r"\(([^()]*)\)", body):
        pts = np.asarray([[float(v) for v in p.split()]
                          for p in ring.split(",")], np.float64)
        out.append((pts[:, 0], pts[:, 1]))
    return out


def ray_cast_np(px, py, wkt: str) -> np.ndarray:
    """The even-odd rule over every ring, each step one IEEE operation:
    px < (xj - xi) * (py - yi) / (yj - yi) + xi."""
    inside = np.zeros(len(px), bool)
    for xs, ys in rings_of(wkt):
        for i in range(len(xs) - 1):
            xi, yi, xj, yj = xs[i], ys[i], xs[i + 1], ys[i + 1]
            if yi == yj:
                continue
            t = np.multiply(py - yi, xj - xi)
            np.divide(t, yj - yi, out=t)
            np.add(t, xi, out=t)
            inside ^= ((yi > py) != (yj > py)) & (px < t)
    return inside


def geo_reference(lanes, dicts):
    """GEO_SQL's rows with numpy alone: the count exact, the sums by
    fsum. The per-row lanes are computed a range of rows a thread."""
    from concurrent.futures import ThreadPoolExecutor
    n = len(lanes["l_quantity"])
    inside = np.zeros(n, bool)
    km = np.empty(n)
    d = np.empty(n)
    polygons = [GEO_POLYGONS.get(name, GEO_ELSE)
                for name in dicts["l_shipmode"]]
    rad = math.pi / 180
    p2, l2 = 40.64 * rad, -73.78 * rad

    def rows(lo: int, hi: int) -> None:
        qty = lanes["l_quantity"][lo:hi]
        py = lanes["l_discount"][lo:hi] * 500.0
        mode = lanes["l_shipmode"][lo:hi]
        for code, wkt in enumerate(polygons):
            sel = mode == code
            if sel.any():
                inside[lo:hi][sel] = ray_cast_np(qty[sel], py[sel], wkt)
        p1 = lanes["l_discount"][lo:hi] * 800.0 * rad
        l1 = (lanes["l_tax"][lo:hi] * 2000.0 - 80.0) * rad
        h = (np.sin((p2 - p1) / 2) ** 2
             + np.cos(p1) * np.cos(p2) * np.sin((l2 - l1) / 2) ** 2)
        km[lo:hi] = 2 * 6371.01 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))
        d[lo:hi] = np.sqrt((qty - 25.0) ** 2 + (py - 25.0) ** 2)

    step = 1 << 22
    with ThreadPoolExecutor(8) as ex:
        for f in [ex.submit(rows, lo, min(lo + step, n))
                  for lo in range(0, n, step)]:
            f.result()
    out = []
    for names, m in groups_of(lanes, dicts, ["l_returnflag",
                                             "l_linestatus"]):
        m = m & inside
        if m.any():
            out.append(names + [int(m.sum()), fsum(km[m]), fsum(d[m])])
    return out


def geo_rows_errors(got, want) -> list:
    """What differs between GEO_SQL's rows and the reference's: keys and
    counts exactly, the sums beyond SUM_REL."""
    if len(got) != len(want):
        return [f"{len(got)} rows, reference {len(want)}"]
    errs = []
    for g, w in zip(got, want):
        if g[:3] != w[:3]:
            errs.append(f"{g[:3]} against {w[:3]}")
        for a, b in zip(g[3:], w[3:]):
            if abs(a - b) > SUM_REL * abs(b):
                errs.append(f"{g[:2]}: {a} against {b}")
    return errs


def phase_geo(runner_mod, session_mod, cuda_groupby, tpch_mod, device_mod):
    """geo_sf10: GEO_SQL over tpch.sf10 lineitem, cold and warm, against
    numpy over the card's lanes: the count exact, the sums within
    SUM_REL of fsum."""
    runner = runner_mod.LocalQueryRunner(
        session_mod.Session(catalog="tpch", schema=GEO_SCHEMA), DEVICE)
    sql = GEO_SQL + " ORDER BY 1, 2"
    cold, warm, cold_s, warm_s, peak, launches = run_timed(
        "geo_sf10", runner, sql, cuda_groupby, GEO_WARM_REPS)
    del runner
    free_device()
    t0 = time.perf_counter()
    lanes, dicts, n = geo_lanes(tpch_mod, device_mod, GEO_SCHEMA, DEVICE)
    want = geo_reference(lanes, dicts)
    ref_s = time.perf_counter() - t0
    errs = geo_rows_errors(cold.rows, want)
    same = all(w.rows == cold.rows for w in warm)
    emit("geo_sf10", schema=f"tpch.{GEO_SCHEMA}", lineitem_rows=n,
         inside=sum(r[2] for r in want), cold_s=cold_s, warm_s=warm_s,
         warm_rows_per_s=n / warm_s, max_memory_allocated=peak,
         grouped_sums_launches=launches, reference_s=ref_s,
         matches_numpy_reference=not errs, errors=errs[:5],
         same_rows_every_run=same, rows=cold.rows,
         **route_of(cold, dict(_COLD["last"])))
    check(launches >= 1, "geo_sf10 did not launch grouped_sums")
    check(not errs, f"geo_sf10 differs from numpy: {errs[:5]}")
    check(same, "geo_sf10 rows differ between runs")


T0 = time.perf_counter()
WALLS: dict = {}


SERVER_QUERIES = (1, 6, 3, 12)
# the phase coordinator's scan cache (Coordinator(scan_cache_bytes=...),
# scan-cache.max-size in etc/config.properties): the four queries'
# lineitem and orders columns together (about 6 GB whole) outgrow the
# default 4 GiB, and there the queries evict one another's columns and
# regenerate them on every run
SERVER_SCAN_CACHE_BYTES = 16 << 30
SERVER_PAGING_SQL = ("SELECT l_orderkey, l_extendedprice FROM lineitem "
                     "WHERE l_shipdate = DATE '1995-03-15'")


def wire_rows(rows):
    """Rows as the statement protocol carries them (dates as strings)."""
    from trino_tpu_torch.fte.recovery import json_value
    return [[json_value(v) for v in row] for row in rows]


def protocol_pages(base_uri: str, sql: str):
    """Each QueryResults page of one statement, through nextUri."""
    import urllib.request
    hdrs = {"X-Trino-User": "smoke", "X-Trino-Catalog": "tpch",
            "X-Trino-Schema": SCHEMA}
    req = urllib.request.Request(f"{base_uri}/v1/statement",
                                 data=sql.encode(), headers=hdrs)
    pages = []
    while req is not None:
        with urllib.request.urlopen(req, timeout=600) as r:
            pages.append(json.loads(r.read()))
        nxt = pages[-1].get("nextUri")
        req = urllib.request.Request(nxt, headers=hdrs) if nxt else None
    return pages


def join_query_threads(timeout: float) -> int:
    """Wait for the coordinator's query threads (a killed query's thread
    runs on to its next plan node or split); how many outlived
    ``timeout``."""
    import threading
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name.startswith("query-"):
            t.join(max(deadline - time.monotonic(), 0.0))
    return sum(1 for t in threading.enumerate()
               if t.name.startswith("query-") and t.is_alive())


def phase_server(runner, cuda_groupby, queries, want,
                 scan_cache_bytes=SERVER_SCAN_CACHE_BYTES,
                 phase="server_sf10"):
    """One port Coordinator() on the card over the sf10 runner's catalogs
    (warm scans) with a 16 GiB scan cache (``scan_cache_bytes``; None for
    the coordinator's default), driven only over loopback
    HTTP: four clients at once on q1, q6, q3 and q12 (rows equal to the
    sf10 phases' numpy-checked rows), a 24k-row result paged through
    nextUri, a DB-API query with a qmark parameter, EXPLAIN ANALYZE of
    q1 (the node reading lineitem sees 60,007,494 rows), q9 past
    query_max_run_time = 1 (EXCEEDED_TIME_LIMIT, then q6 still answers),
    and /metrics and system.runtime.queries listing the phase's queries.
    The grouped_sums launches are counted over the coordinator's queries
    alone, and the first run of each query through it adds its launch
    shapes to SHAPES. Then q1 and q6 straight through a runner, with and
    without node stats, outside that count."""
    import shutil
    import tempfile
    import threading
    import urllib.request
    from trino_tpu_torch.client import ClientError, StatementClient
    from trino_tpu_torch.config import CONFIG
    from trino_tpu_torch.dbapi import connect
    from trino_tpu_torch.obs.metrics import parse_exposition
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.server import Coordinator
    from trino_tpu_torch.session import Session
    # the runner's counts the paged query and EXPLAIN ANALYZE are held
    # against, before the coordinator's launches are counted
    count = runner.execute(SERVER_PAGING_SQL.replace(
        "l_orderkey, l_extendedprice", "count(*)")).rows[0][0]
    n_li = runner.execute("SELECT count(*) FROM lineitem").rows[0][0]
    history = tempfile.mkdtemp(prefix="chip_smoke_history_")
    torch.cuda.reset_peak_memory_stats()
    co = Coordinator(catalogs=runner.catalogs, history_dir=history,
                     scan_cache_bytes=scan_cache_bytes).start()
    walls, fields = {}, {}
    try:
        check(co.device.type == "cuda", "the coordinator is not on cuda")

        def client(**kw):
            return StatementClient(co.base_uri, schema=SCHEMA, **kw)

        def timed(name, sql, **kw):
            t0 = time.perf_counter()
            res = client(**kw).execute(sql)
            walls[name] = time.perf_counter() - t0
            return res
        cuda_groupby.LAUNCHES = 0
        # the first run of each query through the coordinator brings its
        # columns into the cache; its launches by shape join SHAPES
        _COLD["now"] = shapes = {}
        t0 = time.perf_counter()
        try:
            for q in SERVER_QUERIES:
                client().execute(queries[q])
        finally:
            _COLD["now"] = None
        walls["warm_up"] = time.perf_counter() - t0
        check(sum(shapes.values()) == cuda_groupby.LAUNCHES,
              f"{phase}: launches by shape do not add up to the count")
        for key, n in shapes.items():
            by_phase = SHAPES.setdefault(key, {})
            by_phase[phase] = by_phase.get(phase, 0) + n
        fields["cold_shapes"] = {f"{k[0]}x{k[1]}x{k[2]}": n
                                 for k, n in sorted(shapes.items())}
        solo_launches = {}
        for q in SERVER_QUERIES:
            before = cuda_groupby.LAUNCHES
            res = timed(f"q{q}_solo", queries[q])
            solo_launches[q] = cuda_groupby.LAUNCHES - before
            check(rows_match(res.rows, wire_rows(want[q])),
                  f"server q{q} rows differ from the q{q} phase's")
        fields["solo_launches"] = solo_launches
        check(solo_launches[1] > 0,
              "q1 through the coordinator launched no grouped_sums")
        got, errors = {}, []
        barrier = threading.Barrier(len(SERVER_QUERIES))

        def one(q):
            try:
                barrier.wait()
                t0 = time.perf_counter()
                got[q] = client().execute(queries[q]).rows
                walls[f"q{q}_concurrent"] = time.perf_counter() - t0
            except Exception as e:          # noqa: BLE001
                errors.append(f"q{q}: {e}")
        before = cuda_groupby.LAUNCHES
        threads = [threading.Thread(target=one, args=(q,))
                   for q in SERVER_QUERIES]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        walls["concurrent_all"] = time.perf_counter() - t0
        fields["concurrent_launches"] = cuda_groupby.LAUNCHES - before
        check(not errors, f"concurrent server queries failed: {errors}")
        for q in SERVER_QUERIES:
            check(rows_match(got[q], wire_rows(want[q])),
                  f"concurrent server q{q} rows differ from the q{q} "
                  "phase's")
        check(fields["concurrent_launches"] == sum(solo_launches.values()),
              "concurrent launches differ from the solo runs' sum")
        # paging through nextUri
        t0 = time.perf_counter()
        pages = protocol_pages(co.base_uri, SERVER_PAGING_SQL)
        walls["paging"] = time.perf_counter() - t0
        paged = [r for p in pages for r in p.get("data", [])]
        fields["paging"] = {"rows": len(paged), "count": count,
                            "pages": sum(1 for p in pages if "data" in p)}
        check(pages[-1]["stats"]["state"] == "FINISHED"
              and len(paged) == count > 4096
              and fields["paging"]["pages"] == -(-count // 4096),
              "the paged query's rows differ from the runner's count")
        # one DB-API query with a qmark parameter
        cur = connect(co.base_uri, schema=SCHEMA).cursor()
        t0 = time.perf_counter()
        cur.execute("SELECT count(*) FROM lineitem WHERE l_shipdate = "
                    "DATE '1995-03-15' AND l_quantity <= ?", (50,))
        walls["dbapi"] = time.perf_counter() - t0
        check(cur.fetchall() == [[count]], "the DB-API count differs")
        # EXPLAIN ANALYZE of q1
        lines = [r[0] for r in timed("explain_analyze_q1",
                                     "EXPLAIN ANALYZE " + queries[1]).rows]
        stats = [ln for ln in lines if ", out " in ln]
        fields["explain_analyze"] = stats
        fields["lineitem_rows"] = n_li
        check(any(f", in {n_li} rows" in ln
                  and ln.startswith(("TableScan", "Aggregation"))
                  for ln in stats),
              f"no lineitem node of EXPLAIN ANALYZE q1 saw {n_li} rows")
        check(any(ln.startswith("Output") and ", out 4 rows" in ln
                  for ln in stats), "EXPLAIN ANALYZE q1 gave not 4 rows")
        # q9 past its deadline, then q6 still answers
        t0 = time.perf_counter()
        try:
            client(session_properties={"query_max_run_time": "1"}) \
                .execute(queries[9])
            deadline_error = None
        except ClientError as e:
            deadline_error = str(e)
        walls["q9_deadline"] = time.perf_counter() - t0
        fields["q9_error"] = deadline_error
        check(deadline_error is not None
              and deadline_error.startswith("EXCEEDED_TIME_LIMIT"),
              f"q9 under query_max_run_time=1 gave {deadline_error}")
        res = timed("q6_after_deadline", queries[6])
        check(rows_match(res.rows, wire_rows(want[6])),
              "q6 after the deadline differs from the q6 phase's")
        # the killed q9's thread runs on to its next plan node, split or
        # chunk; its terminal state is counted when it ends
        t0 = time.perf_counter()
        check(join_query_threads(120.0) == 0, "q9's thread did not end")
        walls["q9_thread_tail"] = time.perf_counter() - t0
        # /metrics and system.runtime.queries
        with urllib.request.urlopen(co.base_uri + "/metrics") as r:
            fams = parse_exposition(r.read().decode())
        states = fams.get("trino_tpu_query_states_total", {})
        fields["metrics_states"] = {k[0]: v for k, v in states.items()}
        rt = client().execute("SELECT state, count(*) FROM "
                              "system.runtime.queries GROUP BY state "
                              "ORDER BY state").rows
        fields["runtime_queries"] = rt
        by_state = dict(map(tuple, rt))
        check(states.get(("state=FINISHED",), 0) >= 12
              and states.get(("state=FAILED",), 0) >= 1,
              "/metrics does not count the phase's queries")
        check(by_state.get("FINISHED", 0) >= 12
              and by_state.get("FAILED", 0) >= 1,
              "system.runtime.queries lacks the phase's queries")
        launches = cuda_groupby.LAUNCHES
        check(launches > 0, "grouped_sums did not launch in the phase")
        fields["queued_s_max"] = max(
            (q.started or q.ended or q.created) - q.created
            for q in co.tracker.all())
        # the same queries straight through a runner, with and without
        # node stats (the coordinator's runners collect them: a device
        # synchronisation ends each plan node); not counted above
        stats_runner = LocalQueryRunner(
            Session(catalog="tpch", schema=SCHEMA),
            catalogs=runner.catalogs, collect_node_stats=True)
        for q in (1, 6):
            for name, r in (("runner", runner),
                            ("runner_stats", stats_runner)):
                t0 = time.perf_counter()
                r.execute(queries[q])
                torch.cuda.synchronize()
                walls[f"q{q}_{name}"] = time.perf_counter() - t0
    finally:
        co.stop()
        stragglers = join_query_threads(120.0)
        shutil.rmtree(history, ignore_errors=True)
    check(stragglers == 0, "a query thread outlived the phase")
    peak = torch.cuda.max_memory_allocated()
    emit(phase, schema=f"tpch.{SCHEMA}", walls_s=walls,
         concurrent_vs_solo_sum=walls["concurrent_all"] / sum(
             walls[f"q{q}_solo"] for q in SERVER_QUERIES),
         max_memory_allocated=peak, grouped_sums_launches=launches,
         scan_cache_budget=scan_cache_bytes or CONFIG.scan_cache_bytes,
         **fields)
    return walls


CLUSTER_QUERIES = (1, 6, 3, 12)
CLUSTER_START_S = 120.0      # a worker process's banner and announcement
CLUSTER_TASK_PROPS = {"retry_policy": "TASK", "retry_initial_delay_ms": "10",
                      "remote_task_timeout": "120"}


def counter_total(name: str, **labels) -> float:
    """A counter family of this process's registry, summed over the
    series whose labels include ``labels``."""
    from trino_tpu_torch.obs.metrics import METRICS
    want = {f"{k}={v}" for k, v in labels.items()}
    fam = METRICS.counter(name)
    return sum(v for key, v in fam.samples()
               if want <= {f"{k}={v}" for k, v in zip(fam.labelnames,
                                                       key)})


def exchange_counters() -> dict:
    """The exchange's frames and bytes: partition frames written and read
    by stage tasks, pages sent and received on the flat path."""
    return {
        "partition_frames_written": counter_total(
            "trino_tpu_exchange_partitions_total", direction="written"),
        "partition_bytes_written": counter_total(
            "trino_tpu_exchange_partition_bytes_total", direction="written"),
        "partition_frames_read": counter_total(
            "trino_tpu_exchange_partitions_total", direction="read"),
        "partition_bytes_read": counter_total(
            "trino_tpu_exchange_partition_bytes_total", direction="read"),
        "pages_sent": counter_total("trino_tpu_exchange_pages_total",
                                    direction="sent"),
        "page_bytes_sent": counter_total("trino_tpu_exchange_bytes_total",
                                         direction="sent"),
    }


def start_worker_process(coordinator_uri: str, log, prewarm=False):
    """``python -m trino_tpu_torch.server.main --role worker`` from this
    checkout, announcing itself to ``coordinator_uri``: its own process
    and CUDA context on the card, its scan cache at the default budget;
    with ``prewarm`` it warms the coordinator's hot shapes first
    (``--prewarm-top-k``), else its pre-warm is off. Returns the
    process; ``worker_uri`` reads its banner."""
    import os
    args = [sys.executable, "-m", "trino_tpu_torch.server.main", "--role",
            "worker", "--port", "0", "--coordinator-uri", coordinator_uri]
    if prewarm:
        args += ["--prewarm-top-k", str(PREWARM_TOP_K)]
    return subprocess.Popen(
        args, cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "TRINO_TPU_PREWARM": "1" if prewarm else "0"},
        stdout=subprocess.PIPE, stderr=log, text=True)


def worker_uri(proc) -> str:
    """A started worker process's base URI, from its banner."""
    import re
    banner = proc.stdout.readline()
    found = re.search(r"listening on (http://\S+)", banner)
    if not found:
        raise PhaseFailed(f"a worker process did not start: {banner!r}")
    return found.group(1)


def phase_cluster(cuda_groupby, queries, want, server_walls=None,
                  phase="cluster_sf10"):
    """The cluster on one card, driven only over loopback HTTP with the
    port's StatementClient. First two TaskWorkerServer(device="cuda") in
    this process (sharing its split scheduler, one runner slot) and a
    port Coordinator(worker_uris=...): q1, q6, q3 and
    q12 at tpch.sf10 through the stage DAG, each client wall beside the
    single-node server_sf10 wall, rows equal to the sf10 phases'; q1 on
    the flat leaf path (multistage_execution=false) with the same rows;
    EXPLAIN ANALYZE of q1 with its aggregations on worker stages. The
    grouped_sums launches of the workers' tasks are counted (more than
    0) and their shapes join SHAPES. Then two worker processes
    (``--role worker``) that announce themselves to a second
    coordinator: q1 with the same rows, then q1 under retry_policy=TASK
    with one worker process killed (SIGKILL) once the coordinator's
    first task POST to it was accepted: the rows are the same, off the
    survivor, and the coordinator's task retry counter moves. The
    exchange's frames and bytes and each device's peak are printed;
    every process started here is stopped, failed or not."""
    import os
    import signal
    import shutil
    import tempfile
    import urllib.request
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.server import Coordinator
    from trino_tpu_torch.server import task_worker
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    walls, fields = {}, {}
    workers, procs, coordinators, logs = [], [], [], []
    try:
        torch.cuda.reset_peak_memory_stats()
        # the two workers share this interpreter, so they share its
        # split scheduler: one runner slot, their tasks taking turns at
        # split and chunk boundaries (two threads of torch calls
        # contending for the interpreter lock run 2-3x slower than one)
        from trino_tpu_torch.exec.taskexec import TaskExecutor
        shared = TaskExecutor(1)
        workers = [task_worker.TaskWorkerServer(
            device="cuda", task_executor=shared).start()
            for _ in range(2)]
        co = Coordinator(worker_uris=[w.base_uri for w in workers],
                         history_dir=os.path.join(tmp, "history1"))
        coordinators.append(co)
        co.start()
        check(co.device.type == "cuda" and all(
            w.device.type == "cuda" for w in workers),
            "the cluster is not on cuda")

        def client(base_uri, **kw):
            return StatementClient(base_uri, schema=SCHEMA, **kw)

        ex0 = exchange_counters()
        cuda_groupby.LAUNCHES = 0
        _COLD["now"] = shapes = {}
        try:
            for q in CLUSTER_QUERIES:
                before = exchange_counters()
                t0 = time.perf_counter()
                res = client(co.base_uri).execute(queries[q])
                walls[f"q{q}"] = time.perf_counter() - t0
                after = exchange_counters()
                emit(f"{phase}_query", query=f"q{q}", wall_s=walls[f"q{q}"],
                     server_sf10_solo_s=(server_walls or {}).get(
                         f"q{q}_solo"),
                     exchange={k: after[k] - before[k] for k in after})
                check(rows_match(res.rows, wire_rows(want[q])),
                      f"{phase}: q{q} rows differ from the q{q} phase's")
            launches = cuda_groupby.LAUNCHES
            t0 = time.perf_counter()
            res = client(co.base_uri, session_properties={
                "multistage_execution": "false"}).execute(queries[1])
            walls["q1_flat"] = time.perf_counter() - t0
            check(rows_match(res.rows, wire_rows(want[1])),
                  f"{phase}: q1 on the flat path differs")
            fields["launches_flat_q1"] = cuda_groupby.LAUNCHES - launches
        finally:
            _COLD["now"] = None
        launches = cuda_groupby.LAUNCHES
        check(launches > 0, f"{phase}: the workers launched no grouped_sums")
        check(sum(shapes.values()) == launches,
              f"{phase}: launches by shape do not add up to the count")
        for key, n in shapes.items():
            by_phase = SHAPES.setdefault(key, {})
            by_phase[phase] = by_phase.get(phase, 0) + n
        fields["shapes"] = {f"{k[0]}x{k[1]}x{k[2]}": n
                            for k, n in sorted(shapes.items())}
        ex1 = exchange_counters()
        fields["exchange"] = {k: ex1[k] - ex0[k] for k in ex1}
        check(fields["exchange"]["partition_frames_written"] > 0,
              f"{phase}: the stage DAG wrote no partition frames")
        t0 = time.perf_counter()
        lines = [r[0] for r in client(co.base_uri).execute(
            "EXPLAIN ANALYZE " + queries[1]).rows]
        walls["explain_analyze_q1"] = time.perf_counter() - t0
        aggs = [ln for ln in lines if ln.startswith("Aggregation:")]
        fields["explain_analyze_aggregations"] = aggs
        check(aggs and all("stage " in ln and "coordinator" not in ln
                           for ln in aggs),
              f"{phase}: q1's aggregations did not run on worker stages")
        fields["peak_in_process"] = torch.cuda.max_memory_allocated()
        if server_walls:
            fields["server_sf10_solo"] = {
                f"q{q}": server_walls.get(f"q{q}_solo")
                for q in CLUSTER_QUERIES}
        co.stop()
        for w in workers:
            w.stop()
        workers = []

        # worker processes on the one card
        co2 = Coordinator(history_dir=os.path.join(tmp, "history2"))
        coordinators.append(co2)
        co2.start()
        t0 = time.perf_counter()
        started = []
        for i in range(2):
            logs.append(open(os.path.join(tmp, f"worker{i}.log"), "w"))
            started.append(start_worker_process(co2.base_uri, logs[-1]))
            procs.append((started[-1], None))
        procs = [(p, worker_uri(p)) for p in started]
        deadline = time.monotonic() + CLUSTER_START_S
        while len(co2.live_workers()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        with urllib.request.urlopen(co2.base_uri + "/v1/announcement",
                                    timeout=30) as r:
            listed = [e["uri"] for e in json.loads(r.read())["workers"]
                      if e["alive"]]
        check(sorted(listed) == sorted(u for _, u in procs),
              f"{phase}: /v1/announcement lists {listed}")
        walls["processes_up"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = client(co2.base_uri).execute(queries[1])
        walls["q1_processes"] = time.perf_counter() - t0
        check(rows_match(res.rows, wire_rows(want[1])),
              f"{phase}: q1 through the worker processes differs")
        victim_proc, victim = procs[0]
        submit = task_worker.RemoteTaskClient.submit_fragment
        killed = {}

        def submit_then_kill(self, *a, **kw):
            out = submit(self, *a, **kw)
            if self.base_uri == victim and not killed:
                killed["at"] = time.perf_counter()
                os.kill(victim_proc.pid, signal.SIGKILL)
            return out
        retries0 = counter_total("trino_tpu_task_retries_total")
        task_worker.RemoteTaskClient.submit_fragment = submit_then_kill
        t0 = time.perf_counter()
        try:
            res = client(co2.base_uri, session_properties=dict(
                CLUSTER_TASK_PROPS)).execute(queries[1])
        finally:
            task_worker.RemoteTaskClient.submit_fragment = submit
        walls["q1_killed_worker"] = time.perf_counter() - t0
        fields["retries"] = counter_total(
            "trino_tpu_task_retries_total") - retries0
        check(bool(killed), f"{phase}: no task reached the victim")
        check(victim_proc.wait(30) == -signal.SIGKILL,
              f"{phase}: the victim did not die of SIGKILL")
        check(rows_match(res.rows, wire_rows(want[1])),
              f"{phase}: q1 with a killed worker differs")
        check(fields["retries"] > 0,
              f"{phase}: the coordinator's retry counter did not move")
        peaks = {}
        for _, uri in procs[1:]:
            with urllib.request.urlopen(uri + "/v1/info", timeout=30) as r:
                info = json.loads(r.read())
            peaks[uri] = info.get("memoryPeakBytes")
        fields["peak_worker_processes"] = peaks
    finally:
        for w in workers:
            w.stop()
        for c in coordinators:
            with contextlib.suppress(Exception):
                c.stop()
        for p, _ in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(30)
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase, schema=f"tpch.{SCHEMA}", walls_s=walls,
         grouped_sums_launches=launches, **fields)


STREAM_SCHEMA = "sf1"
STREAM_ROWS = 2_000_000         # the first rows of tpch.sf1 lineitem
STREAM_ORDERS = 600_000         # orders generated to cover them
STREAM_BODY_ROWS = 50_000       # documents a POST /v1/ingest body
STREAM_PRODUCERS = 2
# the first bodies go out at a steady rate, one every STREAM_PACE_S in
# all (33,333 rows/s), the rest as fast as the producers can post them
STREAM_PACED_BODIES = 20
STREAM_PACE_S = 1.5
STREAM_PARTITIONS = 4
STREAM_POLL_MS = 200
STREAM_TOPIC = "li_events"
# the grouped scan's window: the first offsets of one partition
STREAM_SCAN_PARTITION = 0
STREAM_SCAN_ROWS = 200_000
STREAM_FIELDS = [("l_orderkey", "BIGINT"), ("l_linenumber", "INTEGER"),
                 ("l_returnflag", "VARCHAR"), ("l_linestatus", "VARCHAR"),
                 ("l_quantity", "DOUBLE"), ("l_extendedprice", "DOUBLE"),
                 ("l_discount", "DOUBLE"), ("l_tax", "DOUBLE"),
                 ("ts", "BIGINT")]
STREAM_Q1_SELECT = (
    "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty, "
    "sum(l_extendedprice) AS sum_base_price, "
    "sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
    "count(*) AS count_order FROM {table}")
STREAM_Q1_VIEW = (STREAM_Q1_SELECT.format(
    table=f"stream.default.{STREAM_TOPIC}")
    + " WHERE ts <= {watermark} GROUP BY l_returnflag, l_linestatus")
DAY_MS = 86_400_000


def stream_rows(device_mod, tpch_mod):
    """The first STREAM_ROWS rows of tpch.sf1 lineitem in orderkey order,
    as the card generates them, on the host: lanes with ``ts`` (the ship
    date in epoch ms) and the flag strings."""
    cols = ["l_orderkey", "l_linenumber", "l_returnflag", "l_linestatus",
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_shipdate"]
    lanes, dicts, n = card_lanes(device_mod, "lineitem", cols,
                                 tpch_mod.SCHEMAS[STREAM_SCHEMA],
                                 STREAM_ORDERS, DEVICE)
    check(n >= STREAM_ROWS, f"{STREAM_ORDERS} orders gave only {n} rows")
    out = {c: lanes[c][:STREAM_ROWS] for c in cols if c != "l_shipdate"}
    out["ts"] = lanes["l_shipdate"][:STREAM_ROWS].astype(np.int64) * DAY_MS
    for c in ("l_returnflag", "l_linestatus"):
        out[c] = np.asarray(dicts[c], dtype=object)[out[c]]
    check(bool(np.all(np.diff(out["l_orderkey"]) >= 0)),
          "the stream's rows are not in orderkey order")
    return out


def stream_bodies(rows) -> list:
    """Newline-delimited JSON bodies of STREAM_BODY_ROWS documents each,
    the doubles written by repr (exact round trip)."""
    keys = [k for k, _ in STREAM_FIELDS]
    cols = [rows[k].tolist() for k in keys]
    docs = [
        f'{{"l_orderkey":{a},"l_linenumber":{b},"l_returnflag":"{c}",'
        f'"l_linestatus":"{d}","l_quantity":{e!r},'
        f'"l_extendedprice":{f!r},"l_discount":{g!r},"l_tax":{h!r},'
        f'"ts":{i}}}'
        for a, b, c, d, e, f, g, h, i in zip(*cols)]
    return ["\n".join(docs[lo:lo + STREAM_BODY_ROWS]).encode()
            for lo in range(0, len(docs), STREAM_BODY_ROWS)]


def stream_q1_reference(rows, mask) -> dict:
    """{(flag, status): [sums..., count]} of STREAM_Q1_SELECT over the
    rows under ``mask``, the sums exact (fsum)."""
    out = {}
    flag, status = rows["l_returnflag"], rows["l_linestatus"]
    price, disc = rows["l_extendedprice"], rows["l_discount"]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + rows["l_tax"])
    for f in sorted(set(flag[mask].tolist())):
        for s in sorted(set(status[mask].tolist())):
            m = mask & (flag == f) & (status == s)
            if m.any():
                out[(f, s)] = [fsum(rows["l_quantity"][m]), fsum(price[m]),
                               fsum(disc_price[m]), fsum(charge[m]),
                               int(m.sum())]
    return out


def stream_q1_errors(got_rows, want: dict) -> list:
    errs = []
    got = {(r[0], r[1]): r[2:] for r in got_rows}
    if set(got) != set(want):
        return [f"groups {sorted(got)} != {sorted(want)}"]
    for key, w in want.items():
        g = got[key]
        if g[4] != w[4]:
            errs.append(f"{key} count {g[4]} != {w[4]}")
        for j in range(4):
            if abs(g[j] - w[j]) > SUM_REL * abs(w[j]):
                errs.append(f"{key} sum {j}: {g[j]} != {w[j]}")
    return errs


def stream_lags(acks, cycles, kind: str) -> dict:
    """{body index: s from its ingest acknowledgement to the end of the
    first of the ``kind`` job's cycles whose committed offsets cover its
    rows}; each cycle of that job gets ``lag_s``, the largest lag of the
    bodies it was the first to cover (None where it covered none)."""
    mine = sorted((c for c in cycles if c["kind"] == kind
                   and c["advanced"]), key=lambda c: c["end"])
    lags = {}
    for c in mine:
        c["lag_s"] = None
    for t_ack, i, out in acks:
        need = {int(p): hi for p, (lo, hi) in out["ranges"].items()
                if hi > lo}
        for c in mine:
            if all(c["committed"].get(p, 0) >= hi for p, hi in need.items()):
                lags[i] = c["end"] - t_ack
                c["lag_s"] = (lags[i] if c["lag_s"] is None
                              else max(c["lag_s"], lags[i]))
                break
    return lags


def stream_window_mask(acks, part: int, end: int) -> np.ndarray:
    """The rows the log appended to partition ``part`` at offsets under
    ``end`` (a body lands whole on one partition, in its order)."""
    mask = np.zeros(STREAM_ROWS, dtype=bool)
    for _, i, out in acks:
        lo, hi = out["ranges"].get(str(part), (0, 0))
        take = max(min(hi, end) - lo, 0)
        mask[i * STREAM_BODY_ROWS:i * STREAM_BODY_ROWS + take] = True
    return mask


def phase_stream(cuda_groupby, device_mod, tpch_mod):
    """Streaming ingestion and continuous queries on the card: one port
    Coordinator() with a stream directory, spool and history of its own.
    Two producer threads POST the first 2,000,000 rows of tpch.sf1
    lineitem as JSON documents to /v1/ingest/li_events (4 partitions) in
    bodies of 50,000, the first STREAM_PACED_BODIES at a steady rate and
    the rest in a burst, while an ``insert`` job drains the topic into
    memory.default.li_sink and a ``window`` job (ts_column ts, lateness 0)
    keeps memory.default.li_q1 as q1's rollup at or under its watermark,
    both at a 200 ms poll. Then the ledger (no gap, no duplicate), the
    sink (exactly once), the view and a grouped scan of a window of one
    partition (its first 200,000 offsets) against numpy, the launches,
    /metrics and one cycle's OTLP trace. Each body's lag, from its
    acknowledgement to the end of the cycle that first covers it, is
    reported a job, over the steady part and the burst, and each cycle
    carries the largest lag it delivered."""
    import shutil
    import tempfile
    import threading
    import urllib.request
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.config import CONFIG
    from trino_tpu_torch.connectors.stream import window_ref
    from trino_tpu_torch.fte.spool import make_spool
    from trino_tpu_torch.obs.metrics import parse_exposition
    from trino_tpu_torch.obs.otlp import (spans_from_otlp,
                                          validate_resource_spans)
    from trino_tpu_torch.server import Coordinator
    fields, walls = {}, {}
    t_phase = t0 = time.perf_counter()
    rows = stream_rows(device_mod, tpch_mod)
    bodies = stream_bodies(rows)
    walls["data"] = time.perf_counter() - t0
    fields["body_bytes"] = sum(len(b) for b in bodies)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    saved = (CONFIG.stream_dir, CONFIG.stream_partitions)
    CONFIG.stream_dir = f"{tmp}/stream"
    CONFIG.stream_partitions = STREAM_PARTITIONS
    torch.cuda.reset_peak_memory_stats()
    co = Coordinator(spool=make_spool("local", local_base_dir=f"{tmp}/spool"),
                     history_dir=f"{tmp}/history").start()
    try:
        check(co.device.type == "cuda", "the coordinator is not on cuda")
        client = StatementClient(co.base_uri, catalog="stream",
                                 schema="default")
        cols = ", ".join(f"{k} {t}" for k, t in STREAM_FIELDS)
        client.execute(f"CREATE TABLE stream.default.{STREAM_TOPIC} "
                       f"({cols})")
        client.execute(f"CREATE TABLE memory.default.li_sink ({cols})")
        # decode time at read_split, summed over the jobs' threads
        conn = co._catalogs.connector("stream")
        decode = {"s": 0.0, "rows": 0}
        lock = threading.Lock()
        read_split = conn.read_split

        def timed_read(split, columns):
            start = time.perf_counter()
            batch = read_split(split, columns)
            if set(columns) - {"_partition", "_offset"}:
                # a read of the ledger columns alone decodes nothing
                with lock:
                    decode["s"] += time.perf_counter() - start
                    decode["rows"] += batch.num_rows_host()
            return batch
        conn.read_split = timed_read
        # each cycle's wall, and when each job first held every row
        cycles, caught_up = [], {}
        cycle = co.continuous._cycle

        def timed_cycle(job):
            start = time.perf_counter()
            advanced = cycle(job)
            end = time.perf_counter()
            committed = co.continuous.offsets.load(job.job_id)[1]
            cycles.append({"kind": job.kind, "s": end - start, "end": end,
                           "advanced": advanced,
                           "rows_total": job.rows_total,
                           "committed": {int(p): e for p, e in committed.get(
                               STREAM_TOPIC, {}).items()}})
            if job.rows_total >= STREAM_ROWS:
                caught_up.setdefault(job.kind, end)
            return advanced
        co.continuous._cycle = timed_cycle
        metrics0 = parse_exposition(urllib.request.urlopen(
            co.base_uri + "/metrics", timeout=60).read().decode())

        def post(path, body):
            req = urllib.request.Request(co.base_uri + path, data=body)
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())
        cuda_groupby.LAUNCHES = 0
        _COLD["now"] = shapes = {}
        try:
            jobs = {
                "insert": post("/v1/continuous", json.dumps({
                    "kind": "insert", "topic": STREAM_TOPIC,
                    "poll_interval_ms": STREAM_POLL_MS,
                    "sql": "INSERT INTO memory.default.li_sink SELECT "
                           + ", ".join(k for k, _ in STREAM_FIELDS)
                           + f" FROM stream.default.{STREAM_TOPIC}"}
                ).encode()),
                "window": post("/v1/continuous", json.dumps({
                    "kind": "window", "topic": STREAM_TOPIC,
                    "target": "memory.default.li_q1", "ts_column": "ts",
                    "lateness_ms": 0, "poll_interval_ms": STREAM_POLL_MS,
                    "sql": STREAM_Q1_VIEW}).encode())}
            acks, errors = [], []

            def produce(k):
                try:
                    for i in range(k, len(bodies), STREAM_PRODUCERS):
                        due = t_ingest + STREAM_PACE_S * min(
                            i, STREAM_PACED_BODIES)
                        time.sleep(max(due - time.perf_counter(), 0.0))
                        out = post(f"/v1/ingest/{STREAM_TOPIC}", bodies[i])
                        acks.append((time.perf_counter(), i, out))
                except Exception as e:          # noqa: BLE001
                    errors.append(repr(e))
            producers = [threading.Thread(target=produce, args=(k,))
                         for k in range(STREAM_PRODUCERS)]
            t_ingest = time.perf_counter()
            for t in producers:
                t.start()
            for t in producers:
                t.join(600)
            check(not errors, f"ingest failed: {errors}")
            last_ack = max(a for a, _, _ in acks)
            walls["ingest"] = last_ack - t_ingest
            t_burst = t_ingest + STREAM_PACE_S * STREAM_PACED_BODIES
            walls["ingest_burst"] = last_ack - t_burst
            deadline = time.monotonic() + 600
            while len(caught_up) < 2 and time.monotonic() < deadline:
                failed = [j for j in co.continuous.infos()
                          if j["state"] != "RUNNING"]
                check(not failed, f"a continuous job stopped: {failed}")
                time.sleep(0.02)
            check(len(caught_up) == 2,
                  f"the jobs did not catch up: {sorted(caught_up)}")
            walls["catch_up_insert"] = caught_up["insert"] - last_ack
            walls["catch_up_window"] = caught_up["window"] - last_ack
            for job in jobs.values():
                urllib.request.urlopen(urllib.request.Request(
                    f"{co.base_uri}/v1/continuous/{job['job_id']}",
                    method="DELETE"), timeout=60).read()
            for t in list(co.continuous._threads.values()):
                t.join(600)
            launches = cuda_groupby.LAUNCHES
            jobs_decode = dict(decode)
        finally:
            _COLD["now"] = None
        check(sum(shapes.values()) == launches,
              "stream_sf1: launches by shape do not add up to the count")
        check(launches >= 1, "the window job launched no grouped_sums")
        fields["job_launches"] = launches
        fields["job_shapes"] = {f"{k[0]}x{k[1]}x{k[2]}": n
                                for k, n in sorted(shapes.items())}
        lags = {kind: stream_lags(acks, cycles, kind) for kind in jobs}
        check(all(len(v) == len(bodies) for v in lags.values()),
              "a job's cycles do not cover every body")
        fields["cycles"] = {}
        for kind in jobs:
            mine = [c for c in cycles if c["kind"] == kind]
            done = [c for c in mine if c["advanced"]]
            before = [0] + [c["rows_total"] for c in done[:-1]]
            fields["cycles"][kind] = {
                "advanced": len(done), "idle": len(mine) - len(done),
                # an advanced cycle's wall, its rows and the largest lag
                # of the bodies it delivered
                "wall_rows_lag": [[c["s"], c["rows_total"] - n, c["lag_s"]]
                                  for c, n in zip(done, before)]}
        for kind, by_body in lags.items():
            for part, idx in (("steady", range(STREAM_PACED_BODIES)),
                              ("burst", range(STREAM_PACED_BODIES,
                                              len(bodies)))):
                v = sorted(by_body[i] for i in idx)
                fields[f"lag_{kind}_{part}_s"] = {
                    "p50": v[len(v) // 2], "max": v[-1], "min": v[0]}
        infos = {j["kind"]: j for j in co.continuous.infos()}
        fields["jobs"] = {k: {key: infos[k][key] for key in (
            "state", "cycles", "rows_total", "last_epoch", "watermark")}
            for k in infos}
        # the ledger: every partition's offsets 0..n-1, once each
        ends = co.stream_log.end_offsets(STREAM_TOPIC)
        t0 = time.perf_counter()
        ledger = client.execute(
            "SELECT _partition, count(*), count(DISTINCT _offset), "
            f"min(_offset), max(_offset) FROM stream.default.{STREAM_TOPIC}"
            " GROUP BY 1 ORDER BY 1").rows
        walls["ledger_query"] = time.perf_counter() - t0
        fields["ledger"] = ledger
        check(sum(r[1] for r in ledger) == STREAM_ROWS
              and all(r[1] == r[2] == r[4] + 1 == ends[r[0]] and r[3] == 0
                      for r in ledger) and len(ledger) == STREAM_PARTITIONS,
              f"the ledger has a gap or a duplicate: {ledger} {ends}")
        # the sink: exactly once
        want_key = int(np.sum(rows["l_orderkey"] * 8
                              + rows["l_linenumber"].astype(np.int64)))
        sink = client.execute(
            "SELECT count(*), sum(l_orderkey * 8 + l_linenumber) "
            "FROM memory.default.li_sink").rows
        fields["sink"] = sink[0]
        check(sink == [[STREAM_ROWS, want_key]],
              f"the sink is not exactly once: {sink} != "
              f"{[[STREAM_ROWS, want_key]]}")
        # the view at the final watermark
        watermark = infos["window"]["watermark"]
        want = stream_q1_reference(rows, rows["ts"] <= watermark)
        view = client.execute("SELECT * FROM memory.default.li_q1").rows
        errs = stream_q1_errors(view, want)
        fields["view_rows"] = sorted(view)
        check(not errs, f"li_q1 differs from numpy: {errs[:5]}")
        # a grouped scan of one partition's window straight off the topic
        part = STREAM_SCAN_PARTITION
        scan_end = min(STREAM_SCAN_ROWS, ends[part])
        ref = window_ref(STREAM_TOPIC, {part: (0, scan_end)})
        fields["scan_window"] = [part, 0, scan_end]
        cuda_groupby.LAUNCHES = 0
        _COLD["now"] = scan_shapes = {}
        t0 = time.perf_counter()
        try:
            scan = client.execute(STREAM_Q1_SELECT.format(
                table=f'stream.default."{ref}"')
                + " GROUP BY l_returnflag, l_linestatus").rows
        finally:
            _COLD["now"] = None
        walls["grouped_scan"] = time.perf_counter() - t0
        scan_launches = cuda_groupby.LAUNCHES
        for key, n in list(shapes.items()) + list(scan_shapes.items()):
            by_phase = SHAPES.setdefault(key, {})
            by_phase["stream_sf1"] = by_phase.get("stream_sf1", 0) + n
        check(scan_launches >= 1 and sum(scan_shapes.values())
              == scan_launches, "the grouped scan launched no grouped_sums")
        fields["scan_launches"] = scan_launches
        mask = stream_window_mask(acks, part, scan_end)
        check(int(mask.sum()) == scan_end, "the scan's window is not "
              "covered by the ingest acknowledgements")
        errs = stream_q1_errors(scan, stream_q1_reference(rows, mask))
        check(not errs, f"the grouped scan differs from numpy: {errs[:5]}")
        # /metrics
        metrics = parse_exposition(urllib.request.urlopen(
            co.base_uri + "/metrics", timeout=60).read().decode())

        def moved(name, **labels):
            key = tuple(f"{k}={v}" for k, v in labels.items())
            return (metrics.get(name, {}).get(key, 0.0)
                    - metrics0.get(name, {}).get(key, 0.0))
        ingested = moved("trino_tpu_ingest_rows_total", topic=STREAM_TOPIC)
        advanced = moved("trino_tpu_continuous_cycles_total",
                         outcome="advanced")
        commits = moved("trino_tpu_stream_offset_commits_total",
                        outcome="committed")
        fields["metrics"] = {"ingest_rows": ingested,
                             "cycles_advanced": advanced,
                             "offset_commits": commits}
        check(ingested == STREAM_ROWS,
              f"ingest_rows_total moved {ingested}")
        check(advanced >= 1 and commits >= advanced,
              f"cycles {advanced}, commits {commits}")
        # one cycle's trace, as OTLP
        cyc = [q for q in co.tracker.all() if q.source == "continuous"
               and q.state == "FINISHED"]
        check(bool(cyc), "no continuous cycle is tracked")
        with urllib.request.urlopen(
                f"{co.base_uri}/v1/trace/{cyc[-1].query_id}",
                timeout=60) as r:
            doc = json.loads(r.read())
        validate_resource_spans(doc)
        spans = spans_from_otlp(doc)
        check(len({s["traceId"] for s in spans}) == 1,
              "a cycle's trace has more than one trace id")
        fields["trace"] = {"query_id": cyc[-1].query_id,
                           "spans": len(spans)}
        peak = torch.cuda.max_memory_allocated()
    finally:
        co.stop()
        CONFIG.stream_dir, CONFIG.stream_partitions = saved
        shutil.rmtree(tmp, ignore_errors=True)
    walls["phase"] = time.perf_counter() - t_phase
    # the jobs decode in two threads at once: the rate a thread sees (its
    # reads' time, waits for the interpreter included) and the rate the
    # two reach together over the time from the first ingest to the
    # last job's catch-up
    scan_rows = decode["rows"] - jobs_decode["rows"]
    scan_s = decode["s"] - jobs_decode["s"]
    emit("stream_sf1", schema=f"tpch.{STREAM_SCHEMA}", rows=STREAM_ROWS,
         partitions=STREAM_PARTITIONS, producers=STREAM_PRODUCERS,
         paced_bodies=STREAM_PACED_BODIES, pace_s=STREAM_PACE_S,
         steady_rows_per_s=STREAM_BODY_ROWS / STREAM_PACE_S,
         ingest_rows_per_s=(STREAM_ROWS - STREAM_PACED_BODIES
                            * STREAM_BODY_ROWS) / walls["ingest_burst"],
         decode_rows_per_s=jobs_decode["rows"] / max(jobs_decode["s"],
                                                     1e-9),
         decode_rows=jobs_decode["rows"], decode_s=jobs_decode["s"],
         decode_rows_per_s_together=jobs_decode["rows"] / (
             walls["ingest"] + max(walls["catch_up_insert"],
                                   walls["catch_up_window"])),
         scan_decode_rows_per_s=scan_rows / max(scan_s, 1e-9),
         max_memory_allocated=peak, walls=walls, **fields)


MESH_SHARDS = 4
MESH_QUERIES = (1, 6, 3, 12)
MESH_WARM_REPS = 1
PREWARM_QUERIES = (1, 6)
PREWARM_TOP_K = 16


def ici_counters() -> dict:
    return {"ici_bytes": counter_total("trino_tpu_exchange_ici_bytes_total"),
            "ici_edges": counter_total("trino_tpu_exchange_ici_edges_total")}


def phase_mesh(runner_mod, session_mod, cuda_groupby, queries, want,
               catalogs):
    """The device mesh at tpch.sf10: LocalQueryRunner(distributed=True,
    n_devices=4) puts four shards on the one card (exec/distributed.py).
    q1, q6, q3 and q12, cold and warm, through the stage DAG on the mesh
    (stage/ici.py, the default), again with ici_exchange=false (the
    node-at-a-time mesh executor), and q3 with
    join_distribution_type='PARTITIONED'; every run's rows against the
    q1, q6, q3 and q12 phases' rows (held to their numpy references
    there). Per query: the walls, the ICI bytes and edges of a run, each
    sharded scan's rows per shard, the peak, and the cold run's
    grouped_sums launches by shape (into the kernel phase)."""
    from trino_tpu_torch.parallel.mesh import get_mesh
    mesh = get_mesh(MESH_SHARDS)
    check(mesh.size == MESH_SHARDS and all(
        d.type == "cuda" for d in mesh.devices),
        "mesh_sf10: the shards are not on the card")
    variants = [("ici", {}, MESH_QUERIES),
                ("node", {"ici_exchange": False}, MESH_QUERIES),
                ("partitioned", {"join_distribution_type": "PARTITIONED"},
                 (3,))]
    summary = {}
    for variant, props, qs in variants:
        session = session_mod.Session(catalog="tpch", schema=SCHEMA)
        for k, v in props.items():
            session.set(k, v)
        runner = runner_mod.LocalQueryRunner(session, catalogs=catalogs,
                                             mesh=mesh)
        for q in qs:
            name = f"mesh_sf10_{variant}_q{q}"
            c0 = ici_counters()
            cold, warm, cold_s, warm_s, peak, launches = run_timed(
                "mesh_sf10", runner, queries[q], cuda_groupby,
                MESH_WARM_REPS)
            c1 = ici_counters()
            runs = 1 + MESH_WARM_REPS
            ok = rows_match(cold.rows, want[q])
            same = all(rows_match(w.rows, cold.rows) for w in warm)
            shapes = _COLD["last"] or {}
            emit(name, schema=f"tpch.{SCHEMA}", shards=MESH_SHARDS,
                 cold_s=cold_s, warm_s=warm_s, rows=len(cold.rows),
                 ici_bytes_per_run=(c1["ici_bytes"] - c0["ici_bytes"])
                 / runs,
                 ici_edges_per_run=(c1["ici_edges"] - c0["ici_edges"])
                 / runs,
                 shard_rows=cold.shard_rows, join_sizes=cold.join_sizes,
                 max_memory_allocated=peak, grouped_sums_launches=launches,
                 shapes={f"{a}x{b}x{c}": n
                         for (a, b, c), n in sorted(shapes.items())},
                 matches_phase_rows=ok, same_rows_every_run=same)
            check(ok, f"{name}: rows differ from the q{q} phase's")
            check(same, f"{name}: warm rows differ from the cold run's")
            check(cold.shard_rows and all(len(r) == MESH_SHARDS
                                          for r in cold.shard_rows),
                  f"{name}: no scan was sharded {MESH_SHARDS} ways")
            if variant == "ici" and q != 6:
                # q6's global aggregation over one scan is a single stage:
                # the fragmenter declines it and the node path runs it
                check(c1["ici_edges"] > c0["ici_edges"],
                      f"{name}: no stage boundary ran as a collective")
            if variant == "node":
                check(c1["ici_edges"] == c0["ici_edges"],
                      f"{name}: ici_exchange=false moved an ICI edge")
            if q == 1:
                # q6 sums without GROUP BY: no packed aggregation
                check(launches > 0, f"{name}: no grouped_sums launch")
            summary[name] = {"cold_s": cold_s, "warm_s": warm_s}
        del runner
        free_device()
    return summary


def metrics_samples(uri: str, family: str) -> dict:
    """A process's /metrics samples of one family: {labels: value}."""
    import urllib.request
    out = {}
    with urllib.request.urlopen(uri + "/metrics", timeout=30) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(family) and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            out[head[len(family):]] = float(value)
    return out


def phase_prewarm(queries, want):
    """The hot-shape pre-warm on the card (exec/hotshapes.py,
    exec/aot.py). A port Coordinator() with an empty registry runs q1
    and q6 at tpch.sf10 through one worker process, whose task statuses
    fill the registry; then a fresh worker process joins with the
    pre-warm (--prewarm-top-k) and another without it. The first must
    warm every entry of /v1/hotshapes without an error (its /metrics:
    trino_tpu_aot_compiles_total by kind and result, and the seconds)
    and the coordinator must list it ``prewarmed``; then each fresh
    worker alone runs q1, its first task's wall printed and its rows
    equal to the q1 phase's. Every process started here is stopped,
    failed or not."""
    import os
    import shutil
    import tempfile
    import urllib.request
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.exec.hotshapes import HOT_SHAPES
    from trino_tpu_torch.server import Coordinator
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prewarm_")
    procs, coordinators, logs = [], [], []
    fields, walls = {}, {}

    def start(co_uri, prewarm: bool, i: int):
        logs.append(open(os.path.join(tmp, f"worker{i}.log"), "w"))
        p = start_worker_process(co_uri, logs[-1], prewarm=prewarm)
        procs.append(p)
        return p

    def announced(co):
        with urllib.request.urlopen(co.base_uri + "/v1/announcement",
                                    timeout=30) as r:
            return {e["uri"]: e for e in json.loads(r.read())["workers"]}

    def run_q1(uri: str, i: int) -> float:
        co = Coordinator(worker_uris=[uri],
                         history_dir=os.path.join(tmp, f"history_q1_{i}"))
        coordinators.append(co)
        co.start()
        t0 = time.perf_counter()
        res = StatementClient(co.base_uri, schema=SCHEMA).execute(
            queries[1])
        wall = time.perf_counter() - t0
        check(rows_match(res.rows, wire_rows(want[1])),
              "prewarm_sf10: a fresh worker's q1 rows differ")
        co.stop()
        return wall

    try:
        HOT_SHAPES.clear()
        co = Coordinator(history_dir=os.path.join(tmp, "history"))
        coordinators.append(co)
        co.start()
        # the filler's pre-warm pulls an empty registry; its recording
        # (on with the pre-warm, TRINO_TPU_PREWARM) is what fills it
        filler = start(co.base_uri, True, 0)
        fill_uri = worker_uri(filler)
        deadline = time.monotonic() + CLUSTER_START_S
        while not co.live_workers() and time.monotonic() < deadline:
            time.sleep(0.05)
        check(co.live_workers() == [fill_uri],
              "prewarm_sf10: the first worker did not join")
        for q in PREWARM_QUERIES:
            t0 = time.perf_counter()
            res = StatementClient(co.base_uri, schema=SCHEMA).execute(
                queries[q])
            walls[f"fill_q{q}"] = time.perf_counter() - t0
            check(rows_match(res.rows, wire_rows(want[q])),
                  f"prewarm_sf10: q{q} through the worker differs")
        with urllib.request.urlopen(
                co.base_uri + f"/v1/hotshapes?k={PREWARM_TOP_K}",
                timeout=30) as r:
            hot = json.loads(r.read())
        kinds = {}
        for e in hot["shapes"]:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        fields["hot_shapes"] = {"tracked": hot["tracked"], "kinds": kinds,
                                "served": len(hot["shapes"])}
        check(hot["shapes"], "prewarm_sf10: the registry stayed empty")
        filler.terminate()
        filler.wait(60)
        t0 = time.perf_counter()
        warm_p = start(co.base_uri, True, 1)
        cold_p = start(co.base_uri, False, 2)
        warm_uri, cold_uri = worker_uri(warm_p), worker_uri(cold_p)
        deadline = time.monotonic() + CLUSTER_START_S
        while time.monotonic() < deadline and not announced(co).get(
                warm_uri, {}).get("prewarmed"):
            time.sleep(0.1)
        walls["join_to_prewarmed"] = time.perf_counter() - t0
        ann = announced(co)
        check(ann.get(warm_uri, {}).get("prewarmed") is True,
              "prewarm_sf10: the coordinator does not see the pre-warmed "
              "worker prewarmed")
        check(ann.get(cold_uri, {}).get("prewarmed") is False,
              "prewarm_sf10: the worker without pre-warm is seen warm")
        compiles = metrics_samples(warm_uri, "trino_tpu_aot_compiles_total")
        seconds = metrics_samples(warm_uri,
                                  "trino_tpu_aot_compile_seconds_sum")
        fields["aot_compiles"] = compiles
        fields["aot_seconds_by_kind"] = seconds
        fields["aot_seconds"] = sum(seconds.values())
        check(sum(compiles.values()) == len(hot["shapes"]),
              "prewarm_sf10: the warm-up did not take every entry")
        check(not any('result="error"' in k for k, v in compiles.items()
                      if v), "prewarm_sf10: a warm-up entry errored")
        walls["q1_prewarmed_worker"] = run_q1(warm_uri, 1)
        walls["q1_cold_worker"] = run_q1(cold_uri, 2)
    finally:
        for c in coordinators:
            with contextlib.suppress(Exception):
                c.stop()
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(30)
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("prewarm_sf10", schema=f"tpch.{SCHEMA}", walls_s=walls, **fields)


def walled(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall time kept under ``name`` and
    printed."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        WALLS[name] = time.perf_counter() - t0
        emit("wall", of=name, s=WALLS[name])


def main(argv) -> int:
    if argv not in ([], ["--server-only"], ["--cluster-only"],
                    ["--stream-only"], ["--mesh-only"]):
        print("usage: python3 chip_smoke.py [--server-only | "
              "--cluster-only | --stream-only | --mesh-only]",
              file=sys.stderr)
        return 2
    server_only = argv == ["--server-only"]
    cluster_only = argv == ["--cluster-only"]
    stream_only = argv == ["--stream-only"]
    mesh_only = argv == ["--mesh-only"]
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from trino_tpu_torch import runner as runner_mod
        from trino_tpu_torch import session as session_mod
        from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
        from trino_tpu_torch.connectors import tpch as tpch_mod
        from trino_tpu_torch.connectors import tpch_device as device_mod
        from trino_tpu_torch.exec import expr as expr_mod
        from trino_tpu_torch.ops import cuda_groupby
        from trino_tpu_torch.ops import int128 as int128_mod
    except ImportError as e:
        print(f"chip_smoke: the trino_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    try:
        card = walled("device", phase_device)
        walled("build", phase_build, cuda_groupby)
        record_kernel_shapes(cuda_groupby)
        if stream_only:
            walled("stream_sf1", phase_stream, cuda_groupby, device_mod,
                   tpch_mod)
            kernels = walled("kernel", phase_kernel, cuda_groupby)
            emit("walls", seconds=WALLS, total_s=time.perf_counter() - T0)
            return report(card, kernels)
        rows, sf10_launches, cold, warm, peak, extra = walled(
            "q1", phase_q1, runner_mod, session_mod, cuda_groupby,
            TPCH_QUERIES[1])
        walled("q1_check", phase_q1_check, rows, tpch_mod, device_mod, cold,
               warm, sf10_launches, peak, extra)
        walled("orders_gen", phase_orders_gen, tpch_mod, device_mod)
        runner = runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpch", schema=SCHEMA))
        q3_rows = walled("q3", phase_q3, runner, cuda_groupby, tpch_mod,
                         device_mod, TPCH_QUERIES[3])
        q6_rows = walled("q6", phase_q6, runner, cuda_groupby, tpch_mod,
                         device_mod, TPCH_QUERIES[6])
        q12 = walled("q12", phase_query, "q12", runner, cuda_groupby,
                     tpch_mod, device_mod, TPCH_QUERIES[12], q12_reference,
                     3)
        server_want = {1: rows, 6: q6_rows, 3: q3_rows, 12: q12.rows}
        if mesh_only:
            walled("mesh_sf10", phase_mesh, runner_mod, session_mod,
                   cuda_groupby, TPCH_QUERIES, server_want, runner.catalogs)
            del runner
            free_device()
            walled("prewarm_sf10", phase_prewarm, TPCH_QUERIES, server_want)
            kernels = walled("kernel", phase_kernel, cuda_groupby)
            emit("walls", seconds=WALLS, total_s=time.perf_counter() - T0)
            return report(card, kernels)
        if server_only:
            walled("server_sf10_default_cache", phase_server, runner,
                   cuda_groupby, TPCH_QUERIES, server_want,
                   scan_cache_bytes=None,
                   phase="server_sf10_default_cache")
        elif not cluster_only:
            walled("q14", phase_query, "q14", runner, cuda_groupby,
                   tpch_mod, device_mod, TPCH_QUERIES[14], q14_reference, 3)
            # q9 runs cold only: its warm run (about 15 s) is left out
            # for the script's time limit
            walled("q9", phase_query, "q9", runner, cuda_groupby, tpch_mod,
                   device_mod, TPCH_QUERIES[9], q9_reference, 0, expr_mod)
            q18 = walled("q18", phase_query, "q18", runner, cuda_groupby,
                         tpch_mod, device_mod, TPCH_QUERIES[18],
                         q18_reference, 2)
            check(q18.spill_bytes > 0, "q18 did not spill to host memory")
        server_walls = None
        if not cluster_only:
            server_walls = walled("server_sf10", phase_server, runner,
                                  cuda_groupby, TPCH_QUERIES, server_want)
        if not server_only and not cluster_only:
            walled("mesh_sf10", phase_mesh, runner_mod, session_mod,
                   cuda_groupby, TPCH_QUERIES, server_want, runner.catalogs)
        del runner
        free_device()
        if not server_only:
            walled("cluster_sf10", phase_cluster, cuda_groupby,
                   TPCH_QUERIES, server_want, server_walls)
            free_device()
        if not server_only and not cluster_only:
            walled("prewarm_sf10", phase_prewarm, TPCH_QUERIES, server_want)
            free_device()
        if not server_only and not cluster_only:
            walled("stream_sf1", phase_stream, cuda_groupby, device_mod,
                   tpch_mod)
            free_device()
        if not server_only and not cluster_only:
            walled("big", phases_big, runner_mod, session_mod, cuda_groupby,
                   tpch_mod, device_mod, TPCH_QUERIES)
            free_device()
            walled("ds", phases_ds, runner_mod, session_mod, cuda_groupby,
                   int128_mod)
            free_device()
            walled("agg", phases_agg, runner_mod, session_mod, cuda_groupby,
                   tpch_mod, device_mod)
            free_device()
            walled("scalar_sf10", phase_scalar, runner_mod, session_mod,
                   cuda_groupby, tpch_mod, device_mod)
            free_device()
            walled("dml_sf10", phase_dml, runner_mod, session_mod,
                   cuda_groupby, tpch_mod, device_mod, TPCH_QUERIES[1], rows)
            free_device()
            walled("files_sf10", phase_files, runner_mod, session_mod,
                   cuda_groupby, TPCH_QUERIES[1], rows, TPCH_QUERIES[6],
                   q6_rows)
            free_device()
            walled("geo_sf10", phase_geo, runner_mod, session_mod,
                   cuda_groupby, tpch_mod, device_mod)
            free_device()
            walled("complex_sf10", phase_complex, runner_mod, session_mod,
                   cuda_groupby, tpch_mod, device_mod)
            free_device()
        kernels = walled("kernel", phase_kernel, cuda_groupby)
        emit("walls", seconds=WALLS, total_s=time.perf_counter() - T0)
    except PhaseFailed as e:
        print(f"chip_smoke: phase failed: {e}", file=sys.stderr)
        return 1
    return report(card, kernels)


def report(card: str, kernels: list) -> int:
    """The last three lines: the card, the kernels, the result."""
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
