"""One run of one cell: set-up, the measured window, the check, the line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the deployment, its coordinator settings, the
session properties every client sends, the statements that build its
tables and the names its queries read) and a
traffic mix (``traffic/<mix>.json``). A run:

1. starts one ``trino_tpu_torch`` coordinator on the card, in this
   process, on a loopback port, its spool, stream and history directories
   in a directory of its own under ``TMPDIR``;
2. runs the configuration's set-up statements, then each template of the
   mix once and then from every stream at once, through the statement
   protocol, with parameter sets that the window reaches last
   (``traffic.Mix.setup_params``): the tables are built, the kernel is
   loaded and each template's path, cold and concurrent, has run;
3. measures ``seconds`` of the mix's client streams in a closed loop, each
   stream sending its next query once the last page of the previous one
   has come back, every query with the parameters the seed dealt it;
   with ``trace`` a steady slice in the middle of the window is traced
   by ``torch.profiler``;
4. reads the device's peak, stops the coordinator and frees its state,
   then computes the answer of every parameter set the window sent with
   the plain reference and holds each query of the window against it;
5. prints the compared numbers with their limits and, last, the result
   line with the cell's metrics, each read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

import compare as cmp
import devtrace
import traffic
from client import StatementClient
from reference import answers, tpch_gen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "trino_tpu")
# where the program's build and kernel caches live: fixed paths inside
# the checkout, so that only a checkout's first run builds
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
# queries of the window still running at its close get this long
DRAIN_S = 60.0
# the traced slice of a --trace 1 run, in the middle of the window
SLICE_S = 5.0
# clock annotations that place the trace's clock on the host's
CLOCK_READS = 50


class NoDevice(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, name: str):
    """(workload, configuration entry) of the cell ``name``."""
    for wl in bench["workloads"]:
        if wl["name"] == name:
            for cfg in bench["configs"]:
                if cfg["name"] == wl["config"]:
                    return wl, cfg
            raise KeyError(f"cell {name}: no configuration {wl['config']}")
    raise KeyError(f"no cell named {name!r}")


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones, each where its ``workloads`` (if any)
    name the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_limits(cell: str) -> Dict[str, float]:
    """The limits of the compared numbers: ``checks/<cell>.json`` where a
    cell has its own (a later cell whose readings differ adds one), else
    ``checks/default.json``."""
    own = HERE / "checks" / f"{cell}.json"
    return load_json(own if own.exists() else HERE / "checks" /
                     "default.json")


def program_env(state: Path) -> None:
    """Point the program's directories into the run's own state directory
    and its build caches into the checkout; before it is imported."""
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(ROOT / ".gpubench_cache" / sub)
    os.environ["TRINO_TPU_SPOOL_DIR"] = str(state / "spool")
    os.environ["TRINO_TPU_STREAM_DIR"] = str(state / "stream")
    if str(ROOT) not in sys.path:
        sys.path.append(str(ROOT))


class Client(StatementClient):
    """The frozen client, keeping the stats of the last page it read."""

    last_stats: dict = {}

    def _request(self, method, uri, body=None):
        payload = StatementClient._request(self, method, uri, body)
        self.last_stats = payload.get("stats") or {}
        return payload


class KernelCalls:
    """Records each ``grouped_sums`` call's thread, host times, live rows
    and shape while ``on``, through the module attributes the program
    calls: the packed aggregation (``groupby._kernel_packed_aggs``) gives
    its batch's row count, the rows the answer needs, to the kernel call
    it makes on the same thread; the call's ids and lanes are padded to
    the batch's capacity."""

    def __init__(self):
        self.on = False
        self.calls: List[tuple] = []
        self._rows = threading.local()

    def install(self, groupby, cg) -> None:
        aggs, inner = groupby._kernel_packed_aggs, cg.grouped_sums

        def packed_aggs(batch, *args, **kwargs):
            self._rows.n = batch.num_rows
            try:
                return aggs(batch, *args, **kwargs)
            finally:
                self._rows.n = None

        def recorded(gid, lanes, nseg):
            if not self.on or not gid.is_cuda:
                return inner(gid, lanes, nseg)
            t0 = time.perf_counter()
            out = inner(gid, lanes, nseg)
            t1 = time.perf_counter()
            cap = int(gid.shape[0])
            live = getattr(self._rows, "n", None)
            live = cap if live is None else min(int(live), cap)
            k = lanes.shape[0] if hasattr(lanes, "shape") else len(lanes)
            self.calls.append((thread_ids(), t0, t1, live, cap, int(k),
                               int(nseg)))
            return out
        groupby._kernel_packed_aggs = packed_aggs
        cg.grouped_sums = recorded


def thread_ids() -> frozenset:
    """The ids a trace may give this thread: the kernel's thread id, the
    pthread id, and the pthread id's low 32 bits."""
    ident = threading.get_ident()
    return frozenset((threading.get_native_id(), ident, ident & 0xFFFFFFFF))


def query_spans(co, qid: str) -> List[tuple]:
    """(name, start, end) of every closed span of a query's trace, on
    the host's perf_counter."""
    q = co.tracker.get(qid) if qid else None
    trace = getattr(getattr(q, "result", None), "trace", None)
    out: List[tuple] = []
    stack = list(getattr(trace, "roots", None) or [])
    while stack:
        sp = stack.pop()
        if sp.end_s is not None:
            out.append((sp.name, sp.start_s, sp.end_s))
        stack.extend(sp.children)
    return out


def run_window(base_uri: str, session: dict, mix, tables: Dict[str, str],
               seconds: float, during=None):
    """Each stream of the mix in a thread of its own, in a closed loop
    for ``seconds``; ``during(t0, seconds)`` runs on this thread. Returns
    (records, t0)."""
    records: List[dict] = []
    gate = threading.Barrier(mix.streams + 1)
    box: Dict[str, float] = {}

    def stream(s: int) -> None:
        client = Client(base_uri, **session)
        queries = mix.stream(s)
        gate.wait()
        end = box["t0"] + seconds
        while time.perf_counter() < end:
            t, p = next(queries)
            rec = {"stream": s, "t": t, "p": p, "qid": "", "rows": None,
                   "error": None, "elapsed_ms": None}
            sql = mix.sql(t, p, tables)
            rec["sent"] = time.perf_counter()
            try:
                res = client.execute(sql)
                rec["rows"] = res.rows
                rec["qid"] = res.query_id
                rec["elapsed_ms"] = client.last_stats.get(
                    "elapsedTimeMillis")
            except Exception as e:      # noqa: BLE001 — counted as failed
                rec["error"] = f"{type(e).__name__}: {e}"[:300]
            rec["done"] = time.perf_counter()
            records.append(rec)

    threads = [threading.Thread(target=stream, args=(s,), daemon=True,
                                name=f"gpubench-stream-{s}")
               for s in range(mix.streams)]
    for th in threads:
        th.start()
    box["t0"] = time.perf_counter()
    gate.wait()
    try:
        if during is not None:
            during(box["t0"], seconds)
    finally:
        deadline = box["t0"] + seconds + DRAIN_S
        for th in threads:
            th.join(max(deadline - time.perf_counter(), 0.0))
    if any(th.is_alive() for th in threads):
        raise RuntimeError(f"a stream was still waiting {DRAIN_S} s past "
                           "the window's close")
    return records, box["t0"]


def all_streams_at_once(base_uri: str, session: dict, mix, tables,
                        t: int) -> None:
    """Every stream sends template ``t`` at the same moment, each with a
    set-up parameter set of its own: set-up runs the template's
    concurrent path, its largest buffers meeting as they may in the
    window."""
    gate = threading.Barrier(mix.streams)
    errors: List[str] = []

    def one(s: int) -> None:
        client = Client(base_uri, **session)
        sql = mix.sql(t, mix.setup_params(t, 1 + s), tables)
        gate.wait()
        try:
            client.execute(sql)
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(s,), daemon=True)
               for s in range(mix.streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(DRAIN_S)
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"set-up: {mix.templates[t].name} from every "
                           f"stream at once failed: {errors[:1]}")


class Profiled:
    """Traces the middle of the window with ``torch.profiler``: a slice of
    ``SLICE_S`` (a third of a shorter window), marked by an annotation,
    is what the per-layer metrics read; the profiler starts a second
    before it."""

    def __init__(self, torch, state: Path, calls: KernelCalls):
        self.torch = torch
        self.path = state / "trace.json"
        self.calls = calls
        # (perf_counter before, after) each clock annotation opened
        self.clock: List[tuple] = []

    def __call__(self, t0: float, seconds: float) -> None:
        prof_mod = self.torch.profiler
        acts = [prof_mod.ProfilerActivity.CPU, prof_mod.ProfilerActivity.CUDA]
        length = min(SLICE_S, seconds / 3)
        at = t0 + (seconds - length) / 2
        time.sleep(max(at - 1.0 - time.perf_counter(), 0.0))
        with prof_mod.profile(activities=acts) as prof:
            for _ in range(CLOCK_READS):
                before = time.perf_counter()
                with prof_mod.record_function(devtrace.CLOCK):
                    self.clock.append((before, time.perf_counter()))
            time.sleep(max(at - time.perf_counter(), 0.0))
            self.calls.on = True
            with prof_mod.record_function(devtrace.MARK):
                time.sleep(length)
            self.calls.on = False
        prof.export_chrome_trace(str(self.path))

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        loads and initialises the tracer, which takes seconds."""
        prof_mod = self.torch.profiler
        acts = [prof_mod.ProfilerActivity.CPU, prof_mod.ProfilerActivity.CUDA]
        with prof_mod.profile(activities=acts):
            self.torch.ones(8).sum()

    def load(self) -> devtrace.Slice:
        try:
            return devtrace.load(str(self.path), self.clock)
        finally:
            self.path.unlink(missing_ok=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def idle_by_host(sl: devtrace.Slice, records: List[dict],
                 spans: Dict[str, List[tuple]], top: int = 10) -> List[list]:
    """Idle seconds of the device in the slice, by what the host was
    doing: the spans open in the queries then under way, else the
    protocol (between a query's spans), else no query at all."""
    by: Dict[str, float] = {}
    for a, b in sl.gaps():
        mid = sl.to_perf((a + b) / 2)
        names = set()
        live = False
        for r in records:
            if r["sent"] <= mid <= r["done"]:
                live = True
                names.update(n for n, s, e in spans.get(r["qid"], ())
                             if s <= mid <= e and n != "query")
        label = ("+".join(sorted(names)) if names
                 else "protocol" if live else "no query")
        by[label] = by.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def cache_summary(scancache) -> dict:
    """Bytes and entries the scan caches hold, by table."""
    out: Dict[str, list] = {}
    with scancache._SCAN_CACHE_LOCK:
        for state in list(scancache._SCAN_CACHES.values()):
            for key, entry in state["entries"].items():
                size = sum(scancache.col_bytes(c)
                           for c in entry["cols"].values())
                got = out.setdefault(f"{key[0]}.{key[1]}", [0, 0])
                got[0] += size
                got[1] += 1
    return out


def finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def run_cell(bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, t_process: float, device: Optional[str] = None,
             schema: Optional[str] = None, ref_threads: int = 8,
             log=sys.stderr, records_path: Optional[str] = None) -> dict:
    """One run; returns the result line's object. ``device`` and
    ``schema`` are for the tests, which drive the run on the CPU at a
    small scale; the benchmark's own runs take the card and the
    configuration's schema."""
    wl, cfg_entry = find_cell(bench, cell)
    cfg = load_json(ROOT / cfg_entry["file"])
    mix = traffic.load_mix(HERE / "traffic" / f"{wl['traffic']}.json", seed)
    schema = schema or cfg["schema"]
    limits = check_limits(cell)
    state = Path(tempfile.mkdtemp(prefix="gpubench-"))
    try:
        return _run(bench, cell, wl, cfg, mix, schema, limits, state, seed,
                    seconds, trace, t_process, device, ref_threads, log,
                    records_path)
    finally:
        shutil.rmtree(state, ignore_errors=True)


def _run(bench, cell, wl, cfg, mix, schema, limits, state, seed, seconds,
         trace, t_process, device, ref_threads, log, records_path) -> dict:
    program_env(state)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("CUDA is not available")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise NoDevice(f"the cell needs {wl['chips']} cards, "
                           f"{torch.cuda.device_count()} found")
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    on_card = device == "cuda"
    from trino_tpu_torch.exec import scancache
    from trino_tpu_torch.ops import cuda_groupby, groupby
    from trino_tpu_torch.server import Coordinator
    calls = KernelCalls()
    if trace:
        calls.install(groupby, cuda_groupby)
    tables = {k: v.format(schema=schema) for k, v in cfg["tables"].items()}
    session = {"user": "gpubench", "catalog": cfg["catalog"],
               "schema": schema,
               "session_properties": cfg.get("session", {})}
    co = Coordinator(device=device, history_dir=str(state / "history"),
                     **cfg.get("coordinator", {})).start()
    t_co = time.perf_counter()
    try:
        client = Client(co.base_uri, **session)
        for sql in cfg.get("setup_sql", []):
            client.execute(sql.format(schema=schema))
        t_tables = time.perf_counter()
        for t in range(len(mix.templates)):
            client.execute(mix.sql(t, mix.setup_params(t, 0), tables))
        for t in range(len(mix.templates)):
            all_streams_at_once(co.base_uri, session, mix, tables, t)
        if on_card:
            torch.cuda.synchronize()
        gc.collect()
        peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
        prof = Profiled(torch, state, calls) if trace else None
        if prof is not None:
            prof.warm()
        t_warm = time.perf_counter()
        print(f"gpubench: scan cache after warm-up {cache_summary(scancache)}",
              file=log)
        cache0 = dict(scancache.STATS)
        records, t0 = run_window(co.base_uri, session, mix, tables,
                                 seconds, prof)
        setup_s = t0 - t_process
        if on_card:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        cache = {k: v - cache0[k] for k, v in scancache.STATS.items()}
        spans = {r["qid"]: query_spans(co, r["qid"]) for r in records}
        sl = prof.load() if prof is not None else None
    finally:
        co.stop()
    del co, client
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    print(f"gpubench: set-up {setup_s:.3f} s: coordinator up at "
          f"{t_co - t_process:.3f}, tables built {t_tables - t_co:.3f}, "
          f"each template once and from every stream at once "
          f"{t_warm - t_tables:.3f}; {len(records)} queries sent in the "
          f"{seconds} s window; scan cache lookups in the window {cache}; "
          f"device peak {peak_setup / 2**30:.3f} GiB after set-up, "
          f"{peak / 2**30:.3f} GiB after the window", file=log)
    if sl is not None:
        gs = [k for k in sl.kernels() if "grouped_sums" in k["name"]]
        print(f"gpubench: traced slice {sl.window_s:.3f} s, "
              f"{len(sl.device)} device events, {len(sl.kernels())} "
              f"kernels, {len(gs)} grouped_sums, {len(sl.runtime)} runtime "
              f"calls, {len(calls.calls)} recorded calls, live rows "
              f"{sum(c[3] for c in calls.calls)} of "
              f"{sum(c[4] for c in calls.calls)} padded", file=log)

    # the reference, after the window and with the program's state freed
    t_ref = time.perf_counter()
    asked = {}
    for r in records:
        asked.setdefault((r["t"], traffic.params_key(r["p"])), r["p"])
    refs = answers(tpch_gen.SCHEMAS[schema],
                   [(mix.templates[t].reference, p)
                    for (t, _), p in asked.items()], threads=ref_threads)
    ref_of = dict(zip(asked, refs))
    wrong_rows, failed, gap = 0, 0, 0.0
    first_wrong: List[str] = []
    for r in records:
        if r["error"] is not None:
            failed += 1
            r["ok"] = False
            first_wrong.append(f"{mix.templates[r['t']].name}: {r['error']}")
            continue
        wrong, g = cmp.compare(r["rows"],
                               ref_of[(r["t"], traffic.params_key(r["p"]))],
                               limits["max_rel_gap"])
        gap = max(gap, g)
        r["ok"] = not wrong and g <= limits["max_rel_gap"]
        if wrong:
            wrong_rows += 1
            first_wrong.extend(f"{mix.templates[r['t']].name} "
                               f"{r['p']}: {w}"
                               for w in wrong[:2])
    print(f"gpubench: reference {time.perf_counter() - t_ref:.3f} s for "
          f"{len(asked)} parameter sets", file=log)
    for line in first_wrong[:10]:
        print(f"gpubench: differs: {line}", file=log)

    window_end = t0 + seconds
    ctx = SimpleNamespace(
        window_s=float(seconds), window_start=t0, window_end=window_end,
        setup_s=setup_s, records=records, peak_bytes=peak, slice=sl,
        kernel_calls=calls.calls, spans=spans,
        plan_spans=("parse", "plan", "optimize"))
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = len(records)
    compared = {
        "failed_queries": {"value": failed, "limit": 0},
        "queries_with_wrong_rows": {"value": wrong_rows, "limit": 0},
        "max_rel_gap": {"value": finite(gap),
                        "limit": limits["max_rel_gap"]},
    }
    correct = (attempted > 0 and failed == 0 and wrong_rows == 0
               and gap <= limits["max_rel_gap"])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(wl["chips"]) if on_card else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if sl is not None:
        dev["busy_s"] = sl.busy_s()
        dev["window_s"] = sl.window_s
        out["breakdown"] = {"device_ops": sl.device_ops(),
                            "idle_gaps": idle_by_host(sl, records, spans)}
    if on_card:
        print(f"gpubench: card {card_line()}", file=log)
    lat = sorted(r["done"] - r["sent"] for r in records if r["ok"])
    print(f"gpubench: latency samples {len(records)} ({len(lat)} correct), "
          f"p50 {np.median(lat) if lat else float('nan'):.4f} s", file=log)
    for name, c in compared.items():
        print(f"gpubench: compared {name} {c['value']!r} limit "
              f"{c['limit']!r}", file=log)
    out["compared"] = compared
    if records_path:
        with open(records_path, "w") as f:
            for r in records:
                f.write(json.dumps({
                    "stream": r["stream"], "query": mix.templates[r["t"]].name,
                    "params": r["p"],
                    "sent": r["sent"] - t0, "wall": r["done"] - r["sent"],
                    "elapsed_ms": r["elapsed_ms"], "ok": r["ok"],
                    "plan_ms": 1e3 * sum(e - s for n, s, e in
                                         spans.get(r["qid"], ())
                                         if n in ctx.plan_spans)}) + "\n")
    return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not load,
    compared whole: ``trino_tpu_torch`` is not ``trino_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
