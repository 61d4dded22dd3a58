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
q3's lineitem-orders join must stream there. q3 at sf10 runs four times; its rows must be bit-identical every
time. q18 must spill its join outputs to host memory. Each TPC-DS query's
warm runs must return its cold run's rows; at tpcds.sf1 its rows on the
card must equal the engine's own rows on the CPU; q38 at sf10 must equal
a numpy count over the connector's lanes, and q64 must return rows (the
relaxed variant of tests/test_tpcds.py where the spec text is empty).
The aggregate phases run at tpch.sf10: the statistical family, checksum
and the bitwise kinds split by split through grouped_sums against numpy
over exact sums (``agg_stats``), min_by/max_by and approx_percentile over
all 60M rows at once against numpy with the first-row tie rule
(``agg_order``), approx_set/merge/cardinality against a numpy sketch and
within 3 standard errors of the exact distinct count (``agg_hll``); at
tpch.sf1 the card's rows of those queries equal the engine's on the CPU
(``agg_sf1_cpu``).
The kernel's lines (trino_tpu_torch/bench_grouped_sums.py) time each
call four ways: ``ms`` back to back as a caller sees it, ``device_ms``
by CUDA-graph replay, ``host_us`` the wrapper's enqueue, and the
``index_add_`` yardstick as ``library_ms`` and ``library_device_ms``.
Each phase prints one JSON line; the line before the last lists the
kernels, the last line is the result. Any failed phase exits non-zero
without printing a result, as does a machine without CUDA.
"""

from __future__ import annotations

import datetime
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
    module attribute the engine calls, from the wrapper's own count, in
    cold runs only."""
    inner = cg.grouped_sums

    def recording(gid, lanes, nseg):
        before = cg.LAUNCHES
        out = inner(gid, lanes, nseg)
        now = _COLD["now"]
        if now is not None and cg.LAUNCHES > before:
            key = (int(gid.shape[0]), len(lanes), int(nseg))
            now[key] = now.get(key, 0) + cg.LAUNCHES - before
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
    return cold, warm, cold_s, sorted(walls)[len(walls) // 2], peak, launches


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


def card_lanes(device_mod, table: str, cols, sf: float, n_orders: int):
    """Whole-table lanes as the card generates them, copied to the host:
    (lanes, dictionaries, rows)."""
    gen = (device_mod.lineitem_batch if table == "lineitem"
           else device_mod.orders_batch)
    batch = gen(0, n_orders, sf, list(cols), DEVICE)
    lanes, n = host_lanes(batch, cols)
    dicts = {c: list(batch.column(c).dictionary.values) for c in cols
             if batch.column(c).dictionary is not None}
    del batch
    torch.cuda.empty_cache()
    return lanes, dicts, n


def emit_query(name, cold, warm, cold_s, warm_s, peak, launches, n_li,
               **extra) -> bool:
    """Print a query phase; True when the warm runs equal the cold one."""
    same = all(w.rows == cold.rows for w in warm)
    extra = {**stream_fields(cold), **extra}
    emit(name, schema=f"tpch.{SCHEMA}", rows=len(cold.rows),
         lineitem_rows=n_li, cold_s=cold_s, warm_s=warm_s,
         warm_runs=len(warm), warm_rows_per_s=n_li / warm_s,
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
    and join sizes against the numpy reference. For q9 the warm runs
    also time the host dictionary transforms (LIKE over p_name)."""
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


def q1_big_reference(tpch_mod, device_mod):
    """q1 at sf100 with numpy alone, range by range over the lineitem
    lanes the card generates: counts per (flag, status) as integers, the
    sums as doubles added range after range."""
    sf = tpch_mod.SCHEMAS[BIG_SCHEMA]
    n_orders = tpch_mod.table_rows("orders", sf)
    cutoff = days(1998, 12, 1) - 90
    counts, sums, n_li = {}, {}, 0
    for lo, hi in big_ranges(n_orders):
        b = device_mod.lineitem_batch(lo, hi, sf, Q1_COLS, DEVICE)
        lane, n = host_lanes(b, Q1_COLS)
        flags = b.column("l_returnflag").dictionary.values
        stats = b.column("l_linestatus").dictionary.values
        del b
        n_li += n
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
        for g in np.nonzero(cnt)[0]:
            k = (str(flags[g // len(stats)]), str(stats[g % len(stats)]))
            counts[k] = counts.get(k, 0) + int(cnt[g])
            sums[k] = sums.get(k, np.zeros(5)) + np.array(
                [float(x[g]) for x in part])
    rows = []
    for k in sorted(counts):
        c, v = counts[k], sums[k]
        rows.append([k[0], k[1], *map(float, v[:4]), float(v[0] / c),
                     float(v[1] / c), float(v[4] / c), c])
    return rows, None, n_li


def q6_big_reference(tpch_mod, device_mod):
    """q6 at sf100 with numpy alone, range by range."""
    sf = tpch_mod.SCHEMAS[BIG_SCHEMA]
    total, n_li = 0.0, 0
    for lo, hi in big_ranges(tpch_mod.table_rows("orders", sf)):
        li, n = host_lanes(device_mod.lineitem_batch(
            lo, hi, sf, Q6_COLS, DEVICE), Q6_COLS)
        n_li += n
        disc = li["l_discount"]
        keep = ((li["l_shipdate"] >= days(1994, 1, 1))
                & (li["l_shipdate"] < days(1995, 1, 1))
                & (disc >= 0.05) & (disc <= 0.07) & (li["l_quantity"] < 24))
        total += float(np.sum(li["l_extendedprice"][keep] * disc[keep]))
    return [[total]], None, n_li


def q3_big_reference(tpch_mod, device_mod):
    """q3 at sf100 with numpy alone, one range of orders at a time with
    the lineitem rows the card generates for the same orders (never more
    than one range of lineitem on the host): the orders join by
    searchsorted within the range's unique o_orderkey (a lineitem row
    whose order lies elsewhere would find no match, and the join sizes
    would disagree), the customer join by index into the dense
    c_custkey, revenue per order by bincount, the top 10 of every
    range's orders. Returns (rows, join sizes, lineitem rows)."""
    sf = tpch_mod.SCHEMAS[BIG_SCHEMA]
    n_orders = tpch_mod.table_rows("orders", sf)
    n_cust = tpch_mod.table_rows("customer", sf)
    cust = tpch_mod.TpchConnector(device="cpu")._customer(
        np.arange(1, n_cust + 1, dtype=np.int64), sf,
        ["c_custkey", "c_mktsegment"])
    check(bool(np.array_equal(cust.column("c_custkey").data[:n_cust].numpy(),
                              np.arange(1, n_cust + 1))),
          "q3 reference: c_custkey not dense")
    seg = cust.column("c_mktsegment")
    c_ok = (seg.dictionary.values[seg.data[:n_cust].numpy()]
            == "BUILDING")
    del cust
    cutoff = days(1995, 3, 15)
    l_kept = o_kept = hits = keeps = n_li = 0
    cands = []
    for lo, hi in big_ranges(n_orders):
        od, _ = host_lanes(device_mod.orders_batch(lo, hi, sf, Q3_O_COLS,
                                                   DEVICE), Q3_O_COLS)
        li, n = host_lanes(device_mod.lineitem_batch(
            lo, hi, sf, Q3_L_COLS, DEVICE), Q3_L_COLS)
        n_li += n
        o_key = od["o_orderkey"]
        check(bool(np.all(np.diff(o_key) > 0)), "o_orderkey not unique")
        oc = od["o_custkey"]
        check(bool(np.all((oc >= 1) & (oc <= n_cust))),
              "q3 reference: o_custkey outside customer")
        o_ok = od["o_orderdate"] < cutoff
        l_ok = li["l_shipdate"] > cutoff
        lk = li["l_orderkey"][l_ok]
        opos = np.clip(np.searchsorted(o_key, lk), 0, len(o_key) - 1)
        hit = (o_key[opos] == lk) & o_ok[opos]
        keep = c_ok[oc[opos[hit]] - 1]
        l_kept += int(l_ok.sum())
        o_kept += int(o_ok.sum())
        hits += int(hit.sum())
        keeps += int(keep.sum())
        grp = opos[hit][keep]
        rev = (li["l_extendedprice"][l_ok][hit]
               * (1 - li["l_discount"][l_ok][hit]))[keep]
        sums = np.bincount(grp, weights=rev, minlength=len(o_key))
        g = np.nonzero(np.bincount(grp, minlength=len(o_key)))[0]
        cands.append((o_key[g], sums[g], od["o_orderdate"][g],
                      od["o_shippriority"][g]))
        del od, li
    key, rev, date, prio = (np.concatenate(x) for x in zip(*cands))
    top = np.lexsort((date, -rev))[:10]
    epoch = datetime.date(1970, 1, 1)
    rows = [[int(key[i]), float(rev[i]),
             epoch + datetime.timedelta(days=int(date[i])), int(prio[i])]
            for i in top]
    sizes = [(l_kept, o_kept, hits), (hits, int(c_ok.sum()), keeps)]
    return rows, sizes, n_li


def phase_big(name, runner, sql, cuda_groupby, tpch_mod, device_mod,
              reference, schema=BIG_SCHEMA, **want):
    """One query streamed beyond the card's memory budget: a cold and a
    warm run (warm rows must equal cold rows), its rows (and join sizes,
    where the reference gives them) against the numpy reference, and
    what the chunk loop and the scan cache did in the cold run."""
    cache0 = cache_stats()
    cold, warm, cold_s, warm_s, peak, launches = run_timed(
        name, runner, sql, cuda_groupby, 1)
    shapes = _COLD["last"]
    extra = dict(stream_fields(cold), **cache_delta(cache0))
    free_device()
    t0 = time.perf_counter()
    rows, sizes, n_li = reference(tpch_mod, device_mod)
    ref_s = time.perf_counter() - t0
    free_device()
    ok = len(cold.rows) == len(rows) and rows_match(cold.rows, rows)
    sizes_ok = sizes is None or [tuple(x) for x in cold.join_sizes] == sizes
    same = warm[0].rows == cold.rows
    emit(name, schema=f"tpch.{schema}", rows=len(cold.rows),
         lineitem_rows=n_li, cold_s=cold_s, warm_s=warm_s,
         warm_rows_per_s=n_li / warm_s, max_memory_allocated=peak,
         grouped_sums_launches=launches,
         grouped_sums_shapes=[[*k, v] for k, v in sorted(shapes.items())],
         join_sizes=cold.join_sizes, reference_join_sizes=sizes,
         matches_numpy_reference=ok, same_rows_warm=same,
         reference_s=ref_s, first_row=cold.rows[0] if cold.rows else None,
         **extra)
    check(ok, f"{name} rows differ from the numpy reference")
    check(sizes_ok, f"{name} join sizes differ from the numpy reference")
    check(same, f"{name} warm rows differ from the cold rows")
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
    """One TPC-DS query at tpcds.sf10: cold and warm walls (median of 2),
    rows/s over the fact rows its scans generate, peak memory, spill
    bytes, join sizes, grouped_sums launches and Int128 divisions; warm
    rows equal cold rows, and at tpcds.sf1 the card's rows equal the
    engine's rows on the CPU."""
    card, card_check, cpu_check = runners
    int128_mod.DIVMOD_CALLS = 0
    cache0 = cache_stats()
    cold, warm, cold_s, warm_s, peak, launches = run_timed(
        name, card, sql, cuda_groupby, 2)
    extra = cache_delta(cache0)
    divmods = int128_mod.DIVMOD_CALLS // 3
    torch.cuda.empty_cache()
    fact = ds_fact_rows(card, sql, tpcds_mod)
    same = all(w.rows == cold.rows for w in warm)
    t0 = time.perf_counter()
    on_card = card_check.execute(sql).rows
    torch.cuda.synchronize()
    check_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = cpu_check.execute(sql).rows
    check_cpu_s = time.perf_counter() - t0
    sf1_ok = ds_rows_match(on_card, on_cpu)
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
         fact_rows=fact, cold_s=cold_s, warm_s=warm_s, warm_runs=len(warm),
         warm_rows_per_s=fact / warm_s, max_memory_allocated=peak,
         spill_bytes=cold.spill_bytes, join_sizes=cold.join_sizes,
         grouped_sums_launches=launches, int128_divisions_per_run=divmods,
         same_rows_every_run=same, check_schema=f"tpcds.{DS_CHECK_SCHEMA}",
         check_rows=len(on_cpu), card_equals_cpu=sf1_ok,
         check_card_s=check_card_s, check_cpu_s=check_cpu_s,
         first_row=cold.rows[0] if cold.rows else None, **extra)
    check(same, f"{name} rows differ between runs")
    check(sf1_ok, f"{name} rows on the card differ from the CPU at "
          f"tpcds.{DS_CHECK_SCHEMA}")
    if reference is not None:
        check(extra["matches_numpy_reference"],
              f"{name} differs from the numpy reference")
    if relaxed is not None:
        check(len(cold.rows) > 0 or extra["relaxed_rows"] > 0,
              f"{name} returned no rows, relaxed variant included")


def phases_ds(runner_mod, session_mod, cuda_groupby, int128_mod):
    from trino_tpu_torch.benchmarks.tpcds_queries import TPCDS_QUERIES
    from trino_tpu_torch.connectors import tpcds as tpcds_mod

    def runner(schema, device=None):
        return runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpcds", schema=schema),
            device=device)
    runners = (runner(DS_SCHEMA), runner(DS_CHECK_SCHEMA),
               runner(DS_CHECK_SCHEMA, "cpu"))
    relaxed = TPCDS_QUERIES[64]
    for old, new in Q64_RELAXED_EDITS:
        check(old in relaxed, "q64 relaxed edit does not apply")
        relaxed = relaxed.replace(old, new)
    phase_ds("ds_q64", TPCDS_QUERIES[64], runners, cuda_groupby, tpcds_mod,
             int128_mod, relaxed=relaxed)
    phase_ds("ds_q47", TPCDS_QUERIES[47], runners, cuda_groupby, tpcds_mod,
             int128_mod)
    phase_ds("ds_q36", TPCDS_QUERIES[36], runners, cuda_groupby, tpcds_mod,
             int128_mod)
    phase_ds("ds_q38", TPCDS_QUERIES[38], runners, cuda_groupby, tpcds_mod,
             int128_mod, reference=q38_reference)
    phase_ds("ds_q78", TPCDS_QUERIES[78], runners, cuda_groupby, tpcds_mod,
             int128_mod)


# ---- the aggregates with scalar results and the HyperLogLog sketches -----

AGG_SCHEMA = "sf10"         # the three aggregate phases
AGG_CHECK_SCHEMA = "sf1"    # the card against the engine on the CPU
AGG_WARM_REPS = 2
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
    for u in np.unique(code):
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
    return math.fsum(lane.tolist())


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


def phase_agg_sf1_cpu(runner_mod, session_mod):
    """The aggregate phases' queries and a sketch cast to varbinary at
    tpch.sf1 on the card and through the engine on the CPU: integers,
    sketches and varbinary exact, doubles within rel 1e-9."""
    def runner(device=None):
        return runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpch", schema=AGG_CHECK_SCHEMA),
            device=device)
    card, cpu = runner(), runner("cpu")
    sqls = ([AGG_STATS_SQL] + AGG_ORDER_SQL + AGG_HLL_SQL + [AGG_WIRE_SQL])
    report, ok = [], True
    for i, template in enumerate(sqls):
        sql = template.format(schema=AGG_CHECK_SCHEMA)
        t0 = time.perf_counter()
        on_card = card.execute(sql).rows
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = cpu.execute(sql).rows
        cpu_s = time.perf_counter() - t0
        if i == 0:
            errs, exact_ok, close_ok = stats_errors(
                on_card, on_cpu, [{k: None for k in AGG_STATS_DOUBLES}]
                * len(on_cpu))
            same = exact_ok and close_ok
            worst = max((e["rel_err"] for e in errs), default=0.0)
        else:
            same = ds_rows_match(on_card, on_cpu)
            worst = None
        ok &= same
        report.append({"query": i, "rows": len(on_cpu), "equal": same,
                       "worst_double_rel_err": worst, "card_s": card_s,
                       "cpu_s": cpu_s})
    emit("agg_sf1_cpu", schema=f"tpch.{AGG_CHECK_SCHEMA}", queries=report,
         card_equals_cpu=ok, host=host_memory())
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
        from trino_tpu_torch.exec import expr as expr_mod
        from trino_tpu_torch.ops import cuda_groupby
        from trino_tpu_torch.ops import int128 as int128_mod
    except ImportError as e:
        print(f"chip_smoke: the trino_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    try:
        card = phase_device()
        phase_build(cuda_groupby)
        record_kernel_shapes(cuda_groupby)
        rows, sf10_launches, cold, warm, peak, extra = phase_q1(
            runner_mod, session_mod, cuda_groupby, TPCH_QUERIES[1])
        phase_q1_check(rows, tpch_mod, device_mod, cold, warm,
                       sf10_launches, peak, extra)
        phase_orders_gen(tpch_mod, device_mod)
        runner = runner_mod.LocalQueryRunner(
            session_mod.Session(catalog="tpch", schema=SCHEMA))
        phase_q3(runner, cuda_groupby, tpch_mod, device_mod,
                 TPCH_QUERIES[3])
        phase_q6(runner, cuda_groupby, tpch_mod, device_mod,
                 TPCH_QUERIES[6])
        phase_query("q12", runner, cuda_groupby, tpch_mod, device_mod,
                    TPCH_QUERIES[12], q12_reference, 3)
        phase_query("q14", runner, cuda_groupby, tpch_mod, device_mod,
                    TPCH_QUERIES[14], q14_reference, 3)
        phase_query("q9", runner, cuda_groupby, tpch_mod, device_mod,
                    TPCH_QUERIES[9], q9_reference, 2, expr_mod)
        q18 = phase_query("q18", runner, cuda_groupby, tpch_mod,
                          device_mod, TPCH_QUERIES[18], q18_reference, 2)
        check(q18.spill_bytes > 0, "q18 did not spill to host memory")
        del runner
        free_device()
        phases_big(runner_mod, session_mod, cuda_groupby, tpch_mod,
                   device_mod, TPCH_QUERIES)
        free_device()
        phases_ds(runner_mod, session_mod, cuda_groupby, int128_mod)
        free_device()
        phases_agg(runner_mod, session_mod, cuda_groupby, tpch_mod,
                   device_mod)
        free_device()
        kernels = phase_kernel(cuda_groupby)
    except PhaseFailed as e:
        print(f"chip_smoke: phase failed: {e}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
