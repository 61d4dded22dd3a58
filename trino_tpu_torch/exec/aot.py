"""The worker pre-warm: each hot program shape's code path, run once.

Counterpart of ``trino_tpu/exec/aot.py``, with the port's own meaning
of "ahead of time". The JAX package lowers and compiles each hot shape
into its jit caches without data. The port has no traced programs to
compile; what a fresh worker pays on its first query is the CUDA
modules of the torch ops its path uses (loaded on first launch),
``grouped_sums`` and the host codecs (built or loaded on first call),
and the caching allocator's pools (sized by the first allocations).
``compile_entry(payload)`` pays those before a query arrives: it
rebuilds the program's plan fragment from the payload's wire form
(plan/serde.py, exec/progkey.py), fabricates a batch at the recorded
capacity and lane spec on the worker's device (the real small
dictionaries, no real data) and runs that kind's code path once.

The fabricated batch takes the path a real batch of that capacity
takes: the same operators at the same capacities, so the same kernels
launch (``grouped_sums`` counts in ``LAUNCHES``) and no more memory is
allocated than a real batch would take. Per kind:

- ``chain``: every row live, every value one (dictionary codes zero), so
  filters keep every row and divisions do not divide by zero; the nodes
  run through an Executor over the batch as their input.
- ``stream`` / ``stream_full``: the same batch (one key value, so one
  group) through the streaming aggregation's partial program, or the
  whole-table program (partial, combine and post functions), which
  launches ``grouped_sums`` where the aggregation's keys pack.
- ``window``: the same batch (one partition) through execute_window.
- ``join`` / ``streamjoin``: the probe side as above at its recorded
  capacity; the build side at its recorded capacity with NO live rows,
  so the counts are zero and the expansion runs at the recorded output
  capacity without ever forming a product of the two sides.
- ``repartition``: one-valued key lanes through the bucketing.

Outcomes count in ``trino_tpu_aot_compiles_total{kind, result}``:
``compiled`` (the path ran), ``cached`` (this process warmed the shape
before) or ``error``; the wall of each run in
``trino_tpu_aot_compile_seconds{kind}``."""

from __future__ import annotations

import threading
import time
from dataclasses import replace as dc_replace
from typing import List, Optional

import numpy as np
import torch

from ..catalog import CatalogManager
from ..columnar import Batch, Column, StringDictionary
from ..config import DeviceLike, resolve_device
from ..obs.metrics import METRICS
from ..session import Session

_M_AOT = METRICS.counter(
    "trino_tpu_aot_compiles_total",
    "Pre-warm runs of hot program shapes by outcome",
    ("kind", "result"))     # result: compiled | cached | error
_M_AOT_WALL = METRICS.histogram(
    "trino_tpu_aot_compile_seconds",
    "Per-shape pre-warm wall (one run of the shape's code path)",
    ("kind",))

# the shapes this process has warmed (their registry keys)
_WARMED: set = set()
_WARMED_LOCK = threading.Lock()


def _dtype(name: str) -> torch.dtype:
    """The torch dtype of a payload's numpy dtype name."""
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def _fabricate(cols: List[dict], schema, capacity: int, live: bool,
               device: torch.device) -> Batch:
    """A batch of ``capacity`` rows with the recorded lanes: every value
    one (a dictionary code zero, a boolean true), validity all true; all
    rows live, or none."""
    out = {}
    for ent in cols:
        name = ent["name"]
        typ = schema[name]
        dictionary = None
        if ent.get("dict") is not None:
            dictionary = StringDictionary(
                np.asarray(ent["dict"], dtype=object))
        dtype = _dtype(ent["dtype"])
        data = (torch.zeros(capacity, dtype=dtype, device=device)
                if dictionary is not None
                else torch.ones(capacity, dtype=dtype, device=device))
        valid = (torch.ones(capacity, dtype=torch.bool, device=device)
                 if ent.get("valid") else None)
        data2 = (torch.zeros(capacity, dtype=_dtype(ent["data2"]),
                             device=device)
                 if ent.get("data2") else None)
        out[name] = Column(typ, data, valid, dictionary, data2)
    return Batch(out, capacity if live else 0)


def _helper(device: torch.device):
    """A detached Executor for the warm-up runs: its session records
    nothing into the hot-shape registry."""
    from .executor import Executor
    session = Session()
    session.set("prewarm_enabled", False)
    return Executor(CatalogManager(), session, device)


def _run_fragment(payload: dict, kind: str, device: torch.device):
    from ..plan.serde import from_jsonable
    from .executor import _Pre, make_stream_runners
    from .progkey import peel_wire_fragment
    from .window import execute_window
    nodes, schema = peel_wire_fragment(from_jsonable(payload["fragment"]))
    b = _fabricate(payload["cols"], schema, int(payload["capacity"]),
                   True, device)
    helper = _helper(device)
    if kind == "chain":
        body = _Pre(b)
        for nd in reversed(nodes):
            body = dc_replace(nd, source=body)
        return helper.execute(body)
    if kind in ("stream", "stream_full"):
        # stream stacks lead with the AggregationNode
        partial, run_full = make_stream_runners(helper, nodes[1:], nodes[0])
        return partial(b)[0] if kind == "stream" else run_full(b)
    if kind == "window":
        return execute_window(b, nodes[0])
    raise ValueError(f"unknown hot-shape kind {kind!r}")


def _run_join(payload: dict, kind: str, device: torch.device):
    from ..ops import join as join_ops
    from ..plan.nodes import JoinNode
    from ..plan.serde import from_jsonable
    from .streamjoin import make_probe_program
    frag = from_jsonable(payload["fragment"])
    if not isinstance(frag, JoinNode):
        raise ValueError("join payload fragment is not a join")
    pkeys = [c.left for c in frag.criteria]
    bkeys = [c.right for c in frag.criteria]
    out_cap = int(payload["out_capacity"])
    probe = _fabricate(payload["probe_cols"], dict(frag.left.schema),
                       int(payload["chunk_capacity"]), True, device)
    build = _fabricate(payload["build_cols"], dict(frag.right.schema),
                       int(payload["build_capacity"]), False, device)
    if kind == "streamjoin":
        sorted_key, order, m = join_ops.build_side(build, bkeys)
        return make_probe_program(frag.join_type, pkeys, frag.filter,
                                  out_cap)(probe, build, sorted_key, order,
                                           m)[0]
    start, count, order = join_ops.match_counts(probe, build, pkeys, bkeys)
    return join_ops.expand_join(probe, build, start, count, order, out_cap,
                                frag.join_type)


def _run_repartition(payload: dict, device: torch.device):
    from ..stage.repartition import partition_buckets
    from ..types import BIGINT
    cap = int(payload["capacity"])
    cols = {f"k{i}": Column(BIGINT, torch.ones(cap, dtype=torch.int64,
                                               device=device))
            for i in range(int(payload["nkeys"]))}
    session = Session()
    session.set("prewarm_enabled", False)
    return partition_buckets(Batch(cols, cap), list(cols),
                             int(payload["nparts"]), session=session)


def compile_entry(entry: dict, device: DeviceLike = None
                  ) -> Optional[float]:
    """Warm one hot-shape registry entry on ``device``: run its kind's
    code path once on a fabricated batch. Returns the wall in seconds,
    or None when this process warmed the shape before. Raises on a
    broken payload or a failed run (counted as ``error``)."""
    dev = resolve_device(device)
    payload = entry["payload"] if "payload" in entry else entry
    kind = str(payload["kind"])
    key = str(entry.get("key") or repr(payload))
    with _WARMED_LOCK:
        if key in _WARMED:
            _M_AOT.inc(kind=kind, result="cached")
            return None
    t0 = time.perf_counter()
    try:
        if kind in ("join", "streamjoin"):
            out = _run_join(payload, kind, dev)
        elif kind == "repartition":
            out = _run_repartition(payload, dev)
        else:
            out = _run_fragment(payload, kind, dev)
        if isinstance(out, Batch):
            out.num_rows_host()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    except Exception:
        _M_AOT.inc(kind=kind, result="error")
        raise
    wall = time.perf_counter() - t0
    with _WARMED_LOCK:
        _WARMED.add(key)
    _M_AOT.inc(kind=kind, result="compiled")
    _M_AOT_WALL.observe(wall, kind=kind)
    return wall


def compile_entries(entries: List[dict], device: DeviceLike = None) -> dict:
    """Warm a hot-shape list, one entry at a time (a failed entry does
    not stop the others): {"compiled", "cached", "errors", "wall_s",
    "by_kind": {kind: {result: n}}}, the pre-warm's summary
    (server/task_worker.py)."""
    out = {"compiled": 0, "cached": 0, "errors": 0, "wall_s": 0.0,
           "by_kind": {}}
    for e in entries or ():
        payload = e.get("payload", e) if isinstance(e, dict) else {}
        kind = str(payload.get("kind", "?"))
        try:
            wall = compile_entry(e, device)
            result = "cached" if wall is None else "compiled"
        except Exception:       # noqa: BLE001 — one bad shape must not
            # abort the warm-up of the rest
            result = "errors"
            wall = None
        out[result] += 1
        if wall is not None:
            out["wall_s"] += wall
        per = out["by_kind"].setdefault(kind, {})
        per[result] = per.get(result, 0) + 1
    return out
