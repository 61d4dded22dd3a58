"""Beyond device memory: operators that stream their scan in chunks.

Counterpart of ``trino_tpu/exec/streamjoin.py``, eager. The executor
materialises an operator's whole input on the device, which caps a
query at one card's memory. When a scan's full materialisation would
not fit the memory budget, a streamed operator reads it chunk by chunk
instead:

- **hash join**: the build side is materialised and sorted once (the
  sorted key lane and permutation of ops/join.py); probe chunks then
  run match counts and the expansion against it, and each chunk's
  output goes to host memory (counted as spill);
- **scan -> filter -> project chains**: each chunk runs the chain, its
  output goes to host memory;
- **aggregation** (exec/executor.py ``_try_streaming_aggregation``):
  each chunk gives a partial aggregate; the partials fold every 8.

The chunk loop (``run_streamed``) is double-buffered: the next chunk's
host-to-device copy is issued, from pinned host memory on a dedicated
copy stream, before the current chunk's compute is dispatched, so the
copy can run under the compute; timed events tell whether the compute
stream still had to wait for it. The
compute stream waits on the copy's event, each device lane is marked
used by the compute stream (``record_stream``), and the pinned source
is held until its event has completed. Each split is staged in host memory once, even when the
connector made it on the card (the JAX package's design; slicing on the
device is a later item).

Two departures from the JAX module, both because eager PyTorch compiles
nothing per shape: a chunk is padded only to the capacity bucket of its
own rows (the JAX engine pads every chunk to one canonical capacity,
which at tpch.sf100 would move 32 times q1's rows), so a probe
chunk's output starts at the chunk's own capacity; and the probe
program is a plain function per output capacity.

Limits (these joins take the materialised path): FULL joins, semi
joins, string columns created by the probe chain, nested column types.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..columnar import (Batch, Column, StringDictionary, batch_from_pylist,
                        map_row_lanes)
from ..config import CONFIG, capacity_for
from ..plan.nodes import (FilterNode, JoinNode, PlanNode, ProjectNode,
                          TableScanNode)
from ..rex import Call, InputRef, and_all
from ..types import BOOLEAN, DecimalType, is_string
from .scancache import col_bytes


# --------------------------------------------------------------------------
# engagement: when does an operator stream?
# --------------------------------------------------------------------------

def chunk_rows_setting(session) -> int:
    """``stream_chunk_rows``: > 0 forces streaming at that chunk size,
    0 engages on a budget breach, < 0 disables streaming."""
    try:
        return int(session.get("stream_chunk_rows"))
    except KeyError:
        return 0


def memory_budget(ex) -> int:
    """The per-node limit, tightened by whatever cluster memory
    governance binds this query."""
    limit = int(ex.session.get("query_max_memory_per_node"))
    fn = getattr(getattr(ex.session, "memory", None), "budget_bytes", None)
    if callable(fn):
        b = fn()
        if b:
            limit = min(limit, int(b))
    return limit


def scan_chain(node: PlanNode):
    """(chain, scan) when ``node`` heads a Filter/Project-only chain over
    a TableScanNode, else None."""
    chain: List[PlanNode] = []
    cur = node
    while isinstance(cur, (FilterNode, ProjectNode)):
        chain.append(cur)
        cur = cur.source
    if not isinstance(cur, TableScanNode):
        return None
    return chain, cur


def _col_streamable(t) -> bool:
    name = str(t.name)
    return not name.startswith(("array(", "map(", "row("))


def stream_gate(ex, scan: TableScanNode, bound: bool = False):
    """None when streaming is impossible for this scan (no split-capable
    connector, unstreamable column types, streaming disabled); else
    (forced chunk rows, memory budget, scan estimate; ``bound`` as in
    ``scan_estimate``)."""
    conn = ex.catalogs.connector(scan.handle.catalog)
    if not hasattr(conn, "get_splits") or not hasattr(conn, "read_split"):
        return None
    if not all(_col_streamable(t) for t in scan.schema.values()):
        return None
    forced = chunk_rows_setting(ex.session)
    if forced < 0:
        return None
    return forced, memory_budget(ex), scan_estimate(ex, scan, bound)


def scan_estimate(ex, scan: TableScanNode,
                  bound: bool = False) -> Optional[int]:
    """Bytes of the whole scan materialised (rows x lanes x 8, the figure
    the scan would reserve); None when the connector has no row count.
    A pushed-down constraint or limit drops rows by a factor nobody
    knows before the scan: the table's figure is then an upper bound,
    returned only with ``bound`` (else None, the JAX engine's rule). The
    join and the scan chain decide on the bound, since the alternative
    to streaming them is the whole scan on the device; the aggregation
    decides on the exact figure, since its alternative, the per-split
    path, never holds the whole scan either."""
    conn = ex.catalogs.connector(scan.handle.catalog)
    if not bound and (scan.handle.constraint is not None
                      or scan.handle.limit is not None):
        return None
    if not hasattr(conn, "table_row_count"):
        return None
    rows = conn.table_row_count(scan.handle)
    if not rows:
        return None
    return int(rows) * max(len(set(scan.assignments.values())), 1) * 8


def _row_bytes(schema: Dict[str, object]) -> int:
    """Device bytes per row of a chunk of this schema: 8 of data and 1 of
    validity per column, 8 more for a high lane."""
    total = 0
    for t in schema.values():
        total += 9
        if (isinstance(t, DecimalType) and not t.is_short) \
                or str(t.name).endswith("with time zone"):
            total += 8
    return max(total, 9)


def _pick_chunk_capacity(forced: int, avail_bytes: int,
                         per_row: int) -> Optional[int]:
    """Chunk capacity: the forced setting, or the largest power of two
    whose streamed footprint fits ``avail_bytes``; None when not even the
    minimum chunk fits."""
    if forced > 0:
        return capacity_for(min(forced, CONFIG.max_batch_rows), minimum=8)
    cap = 8
    while cap * 2 * per_row <= avail_bytes \
            and cap * 2 <= CONFIG.max_batch_rows:
        cap *= 2
    if cap * per_row > avail_bytes:
        return None
    return cap


# --------------------------------------------------------------------------
# the chunk source: host chunks off the scan
# --------------------------------------------------------------------------

def _stage(raw: Batch, n: int) -> Batch:
    """The split's live rows in host memory, once: pinned when they come
    from a card (the only copy that makes the way back asynchronous), a
    view when they are already on the host."""
    def host(t):
        if t.device.type == "cpu":
            return t[:n]
        out = torch.empty(n, dtype=t.dtype, pin_memory=True)
        return out.copy_(t[:n])
    return Batch({name: map_row_lanes(c, host)
                  for name, c in raw.columns.items()}, n)


def _slice_chunk(raw: Batch, assignments: Dict[str, str], lo: int,
                 hi: int) -> Batch:
    """Rows [lo, hi) of a staged split, renamed to the scan's output
    symbols. The lanes hold exactly these rows: the copy to the device
    pads them to their capacity bucket there."""
    return Batch({sym: map_row_lanes(raw.column(col),
                                     lambda t: t[lo:hi])
                  for sym, col in assignments.items()}, hi - lo)


def host_scan_chunks(ex, scan: TableScanNode, chunk_cap: int
                     ) -> Iterator[Batch]:
    """Host chunks of at most ``chunk_cap`` rows of the scan, split by
    split (a worker task's share of them), each split read through the
    scan cache and staged once."""
    conn = ex.catalogs.connector(scan.handle.catalog)
    columns = sorted(set(scan.assignments.values()))
    par = int(ex.session.get("task_concurrency")) or 1
    for sp in ex.split_share(conn.get_splits(scan.handle, par)):
        raw = ex._read_split(conn, sp, columns)
        n = raw.num_rows_host()
        raw = _stage(raw, n)
        for lo in range(0, n, chunk_cap):
            yield _slice_chunk(raw, scan.assignments, lo,
                               min(lo + chunk_cap, n))


def _batch_nbytes(b: Batch) -> int:
    return sum(col_bytes(c) for c in b.columns.values())


class ChunkCopier:
    """Host-to-device chunk copies. On a card: one dedicated copy stream,
    timed events around each chunk's copy (the compute stream waits on
    the second), ``record_stream`` on every device lane, and each pinned
    source held until its copy has completed. On the CPU a copy is the
    padding alone."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        # (host chunk, its copy's end event) until the event completes
        self.in_flight: List[Tuple[Batch, object]] = []

    def h2d(self, host: Batch):
        """Issue the copy of ``host`` padded to its capacity bucket;
        returns the pending chunk for ``ready``."""
        n = host.num_rows_host()
        cap = capacity_for(max(n, 1), minimum=8)

        def lane(t):
            if t is None:
                return None
            out = torch.empty(cap, dtype=t.dtype, device=self.device)
            out[:n].copy_(t, non_blocking=self.cuda)
            out[n:].zero_()
            return out

        if not self.cuda:
            return _map_lanes(host, lane), None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            dev = _map_lanes(host, lane)
            end.record(self.stream)
        self.in_flight.append((host, end))
        return dev, (start, end)

    def ready(self, pending) -> Tuple[Batch, object]:
        """The chunk, usable on the current stream once its copy ends,
        and a timed event recorded there just before the stream waits
        for the copy (None on the CPU)."""
        dev, copy = pending
        if copy is None:
            return dev, None
        compute = torch.cuda.current_stream(self.device)
        arrive = torch.cuda.Event(enable_timing=True)
        arrive.record(compute)
        compute.wait_event(copy[1])
        for c in dev.columns.values():
            for t in (c.data, c.valid, c.data2):
                if t is not None:
                    t.record_stream(compute)
        return dev, arrive

    def release(self) -> None:
        """Drop the pinned sources whose copies have completed."""
        self.in_flight = [(h, e) for h, e in self.in_flight  # tt-lint: ignore[race-attr-write] a staging instance belongs to one chunk loop on one thread; the thread edge is a name match of other release() methods
                          if not e.query()]


def overlap(windows) -> Tuple[int, float, float]:
    """From each chunk's (copy start, copy end, compute arrival) events:
    the copies after the first that had completed when the compute
    stream arrived at their chunk (hidden under earlier work), the
    copies' device ms, and the ms the compute stream waited for copies
    still running."""
    if not windows:
        return 0, 0.0, 0.0
    torch.cuda.synchronize()
    base = windows[0][0]
    hidden, copy_ms, wait_ms = 0, 0.0, 0.0
    for j, (start, end, arrive) in enumerate(windows):
        cs, ce, ar = (base.elapsed_time(e) for e in (start, end, arrive))
        copy_ms += ce - cs
        wait_ms += max(ce - ar, 0.0)
        hidden += int(j > 0 and ce <= ar)
    return hidden, copy_ms, wait_ms


def _map_lanes(b: Batch, fn) -> Batch:
    return Batch({s: map_row_lanes(c, fn) for s, c in b.columns.items()},
                 b.num_rows)


def check_interrupt(session) -> None:
    """Raise when the query was cancelled or passed its deadline; on a
    worker task, also the split scheduler's yield point."""
    from .executor import QueryError
    cancel = getattr(session, "cancel", None)
    if cancel is not None and cancel.is_set():
        raise QueryError("Query was canceled")
    deadline = getattr(session, "deadline", None)
    if deadline is not None and time.monotonic() > deadline:
        raise QueryError(
            "Query exceeded the maximum run time (query_max_run_time)",
            error_name="EXCEEDED_TIME_LIMIT")
    yld = getattr(session, "split_yield", None)
    if yld is not None:
        # a worker task's shared split scheduler (exec/taskexec.py):
        # plan nodes, splits and chunks are where a task hands its
        # runner slot to a task of higher priority
        yld()


def run_streamed(ex, op: str, host_iter: Iterable[Batch],
                 dispatch, collect) -> None:
    """The double-buffered chunk loop of every streamed operator. Per
    chunk i: the copy of chunk i+1 is issued first (after its host
    staging), then ``dispatch(chunk_i, i)`` queues the compute and
    ``collect(result, i)`` reads it back, with whatever host syncs that
    takes. Cancel and deadline are checked at every chunk. The chunks,
    the bytes copied to the device, the copies hidden under earlier
    work, the copies' device time and the compute stream's wait for
    them (all three from CUDA events, see ``overlap``) and the loop's
    wall time go to the executor's counters."""
    t0 = time.perf_counter()
    copier = ChunkCopier(ex.device)
    it = iter(host_iter)
    nchunks = h2d = 0
    windows = []
    host = next(it, None)
    cur = None
    if host is not None:
        h2d += _batch_nbytes(host)
        cur = copier.h2d(host)
    while cur is not None:
        check_interrupt(ex.session)
        nxt_host = next(it, None)
        nxt = None
        if nxt_host is not None:
            h2d += _batch_nbytes(nxt_host)
            nxt = copier.h2d(nxt_host)
        chunk, arrive = copier.ready(cur)
        if arrive is not None:
            windows.append((*cur[1], arrive))
        collect(dispatch(chunk, nchunks), nchunks)
        copier.release()
        cur = nxt
        nchunks += 1
    hidden, copy_ms, wait_ms = overlap(windows)
    ex.stream_chunks += nchunks
    ex.stream_h2d_bytes += h2d
    ex.stream_overlapped += hidden
    ex.stream_copy_ms += copy_ms
    ex.stream_wait_ms += wait_ms
    ex.stream_ops[op] = ex.stream_ops.get(op, 0) + nchunks
    ex.stream_s += time.perf_counter() - t0


def agg_chunk_capacity(ex, scan: TableScanNode) -> Optional[int]:
    """Chunk capacity of the streaming aggregation, or None when chunking
    should not engage (the scan fits the budget, or its estimate is
    unknown, or not even a minimal chunk fits)."""
    gate = stream_gate(ex, scan)
    if gate is None:
        return None
    forced, budget, est = gate
    if forced <= 0 and (est is None or est <= budget):
        return None
    # 2 chunks in flight + at most 8 chunk-sized partials before a fold
    per_row = 10 * _row_bytes(scan.schema)
    return _pick_chunk_capacity(forced, budget, per_row)


# --------------------------------------------------------------------------
# streamed scan -> filter -> project chains
# --------------------------------------------------------------------------

def make_chain_runner(ex, chain: Sequence[PlanNode]):
    """callable(Batch) -> Batch applying the Filter/Project chain bottom
    up to one chunk."""
    nodes = list(reversed(chain))

    def run(b: Batch) -> Batch:
        for nd in nodes:
            b = ex._apply_node(nd, b)
        return b
    return run


def _spill(ex, out: Batch, outs: List[Batch]) -> int:
    """Copy a chunk's output rows to host memory (counted as spill);
    returns the rows."""
    from .executor import _to_host
    n = out.num_rows_host()
    if n:
        host = _to_host(out, n)
        ex.spilled_bytes += _batch_nbytes(host)
        outs.append(host)
    return n


def _empty_batch(schema, device) -> Batch:
    return batch_from_pylist({s: [] for s in schema}, dict(schema),
                             device=device)


def _empty_host(b: Batch) -> Batch:
    """A zero-row spilled batch of ``b``'s columns (capacity 8, as every
    batch keeps)."""
    from .executor import _to_host
    return Batch(_to_host(b, 8).columns, 0, spilled=True)


def maybe_stream_chain(ex, node: PlanNode) -> Optional[Batch]:
    """Stream a Filter/Project chain whose scan does not fit the budget
    (or when ``stream_chunk_rows`` forces it). Returns the chain's output
    in host memory (a spilled batch), or None when streaming does not
    engage."""
    sc = scan_chain(node)
    if sc is None:
        return None
    chain, scan = sc
    if not chain:
        return None
    gate = stream_gate(ex, scan, bound=True)
    if gate is None:
        return None
    forced, budget, est = gate
    if forced <= 0 and (est is None or est <= budget):
        return None
    # 2 input chunks in flight + 1 output chunk, of the chain's schema
    per_row = 2 * _row_bytes(scan.schema) \
        + _row_bytes(chain[0].output_schema())
    chunk_cap = _pick_chunk_capacity(forced, budget, per_row)
    if chunk_cap is None:
        return None
    ex._reserve_streamed(
        chunk_cap * per_row,
        f"streamed scan chain over {scan.handle.table} "
        f"(chunk capacity {chunk_cap})")
    run = make_chain_runner(ex, chain)
    from .executor import device_concat
    from .progkey import canonicalize_nodes
    canon = canonicalize_nodes(chain)

    def dispatch(chunk: Batch, i: int) -> Batch:
        if i == 0 and canon is not None:
            # the chunk program's shape (exec/hotshapes.py)
            from .hotshapes import record_canonical
            record_canonical("chain", canon, chunk, ex.session)
        return run(chunk)

    outs: List[Batch] = []
    run_streamed(ex, "chain", host_scan_chunks(ex, scan, chunk_cap),
                 dispatch, lambda out, i: _spill(ex, out, outs))
    if not outs:
        return _empty_host(_empty_batch(chain[0].output_schema(),
                                        ex.device))
    return device_concat(outs)


# --------------------------------------------------------------------------
# streamed hash join
# --------------------------------------------------------------------------

def _type_inexact(t) -> bool:
    """Type-level twin of executor._keys_inexact: True when the u64
    equality lane is not bijective for a key of this type (float, Int128
    decimal, time zone high lane)."""
    if isinstance(t, DecimalType):
        return not t.is_short
    if str(t.name).endswith("with time zone"):
        return True
    try:
        return np.dtype(t.np_dtype).kind == "f"
    except TypeError:
        return True


def _verify_filter_types(pschema, bschema, pkeys, bkeys, filt):
    """join_verify_filter from plan types (no batches yet): append
    key-equality conjuncts when the hash lane is inexact."""
    inexact = len(pkeys) > 1 or any(
        _type_inexact(pschema[k]) for k in pkeys) or any(
        _type_inexact(bschema[k]) for k in bkeys)
    if not inexact:
        return filt
    eqs = [Call("=", (InputRef(pk, pschema[pk]), InputRef(bk, bschema[bk])),
                BOOLEAN)
           for pk, bk in zip(pkeys, bkeys)]
    return and_all(([filt] if filt is not None else []) + eqs)


_PPOS = "__probe_pos$"


def make_probe_program(jt: str, pkeys: Sequence[str], residual,
                       out_cap: int):
    """The per-chunk probe at one output capacity: match counts by
    binary search in the prebuilt sorted build lane, then the expansion
    into ``out_cap`` rows (and the residual filter). Returns (output,
    total matches): a total above ``out_cap`` means the output overflowed
    and the chunk must run again at a larger capacity."""
    from ..ops import compact, join as join_ops
    from ..ops.hashing import to_signed_order
    from .executor import _with_pos
    from .expr import eval_predicate
    pkeys = list(pkeys)
    outer = jt == "left"

    def fn(chunk: Batch, build: Batch, sorted_key, order, m):
        lane_p, usable_p = join_ops.equality_lane(chunk, pkeys)
        key_p = to_signed_order(lane_p)
        left = torch.minimum(torch.searchsorted(sorted_key, key_p), m)
        right = torch.minimum(
            torch.searchsorted(sorted_key, key_p, side="right"), m)
        count = torch.where(usable_p, right - left, 0)
        if residual is None:
            eff = (torch.where(chunk.row_valid(), count.clamp(min=1), 0)
                   if outer else count)
            out = join_ops.expand_join(chunk, build, left, count, order,
                                       out_cap,
                                       "left" if outer else "inner")
            return out, eff.sum()
        probe = _with_pos(chunk, _PPOS) if outer else chunk
        cand = join_ops.expand_join(probe, build, left, count, order,
                                    out_cap, "inner")
        out = compact.filter_batch(cand, eval_predicate(residual, cand))
        return out, count.sum()

    return fn


class _StreamDictEncoder:
    """One dictionary per probe string column for the whole stream.

    Each split carries its own StringDictionary. The encoder fixes one
    stream dictionary per column and rewrites each chunk's codes into it
    on the device. Join-key columns are seeded with the build side's
    dictionary, so probe codes compare directly with the sorted build
    lane computed once (the materialised join instead merges both
    sides' dictionaries, ``ops/join.py:align_string_keys``, which would
    move the build codes every chunk). A value the stream dictionary
    lacks is appended (codes never move); a key value absent from the
    build dictionary gets a code past its end, which matches nothing,
    as string equality requires. Sharing one dictionary also spares the
    final concatenation a merge per chunk. The rewrite table of the last
    source dictionary is kept, so the chunks of one split reuse it."""

    def __init__(self, seeds: Dict[str, StringDictionary]):
        self._dicts: Dict[str, StringDictionary] = dict(seeds)
        self._last: Dict[str, Tuple[StringDictionary, torch.Tensor]] = {}

    def encode(self, chunk: Batch) -> Batch:
        from ..columnar import take_clamped
        cols = dict(chunk.columns)
        for name, c in chunk.columns.items():
            if c.dictionary is None:
                continue
            d = self._dicts.get(name)
            if d is None:
                self._dicts[name] = c.dictionary
                continue
            if c.dictionary is d:
                continue
            last = self._last.get(name)
            if last is not None and last[0] is c.dictionary:
                table = last[1]
            else:
                idx = d.index
                vals = c.dictionary.values
                remap = np.empty(len(vals), dtype=np.int32)
                fresh = []
                for i, s in enumerate(vals):
                    code = idx.get(s)
                    if code is None:
                        fresh.append((i, s))
                    else:
                        remap[i] = code
                if fresh:
                    ext = list(d.values)
                    nidx = dict(idx)
                    for i, s in fresh:
                        remap[i] = len(ext)
                        nidx[s] = len(ext)
                        ext.append(s)
                    self._dicts[name] = StringDictionary(
                        np.asarray(ext, dtype=object), nidx)
                table = torch.from_numpy(remap).to(c.data.device)
                self._last[name] = (c.dictionary, table)
            cols[name] = Column(c.type, take_clamped(table, c.data),
                                c.valid, self._dicts[name], c.data2)
        return Batch(cols, chunk.num_rows)


def maybe_stream_join(ex, node: JoinNode
                      ) -> Tuple[Optional[Batch], Optional[Batch]]:
    """Stream the probe side of a hash join whose probe scan does not fit
    the budget left after the build side: build once, stream the probe
    chunks, and collect the output in host memory. Returns (streamed
    result, None) when it engages; on decline (None, build batch) when
    the decision had to materialise the build side (the caller reuses
    it), else (None, None)."""
    jt = node.join_type
    if jt not in ("inner", "left") or not node.criteria:
        return None, None
    sc = scan_chain(node.left)
    if sc is None:
        return None, None
    chain, scan = sc
    gate = stream_gate(ex, scan, bound=True)
    if gate is None:
        return None, None
    pschema = (chain[0] if chain else scan).output_schema()
    bschema = node.right.output_schema()
    if not all(_col_streamable(t) for t in pschema.values()):
        return None, None
    # a string column the chain creates has no stream dictionary
    if any(is_string(t) and s not in scan.schema
           for s, t in pschema.items()):
        return None, None
    pkeys = [c.left for c in node.criteria]
    bkeys = [c.right for c in node.criteria]
    if any(k not in pschema for k in pkeys) \
            or any(k not in bschema for k in bkeys):
        return None, None
    forced, budget, est = gate
    if forced <= 0 and (est is None or 4 * est <= budget):
        # a probe under a quarter of the budget skips the exact rule
        # below, which needs the build side materialised first
        return None, None
    residual = _verify_filter_types(pschema, bschema, pkeys, bkeys,
                                    node.filter)

    from ..ops import join as join_ops
    build = ex.execute(node.right)
    build_bytes = sum(col_bytes(c) for c in build.columns.values()) \
        + 2 * build.capacity * 8
    # stream iff the probe does not fit what the budget leaves after the
    # build state: the materialised join holds both at once
    if forced <= 0 and (est is None
                        or est <= max(budget - build_bytes, 0)):
        return None, build
    probe_row = _row_bytes(pschema) + _row_bytes(scan.schema)
    out_row = _row_bytes(pschema) + _row_bytes(bschema) + 8
    per_row = 2 * probe_row + out_row
    chunk_cap = _pick_chunk_capacity(forced, max(budget - build_bytes, 0),
                                     per_row)
    if chunk_cap is None:
        return None, build          # the build alone exhausts the budget
    ex._reserve_streamed(
        build_bytes + chunk_cap * per_row,
        f"streamed join (build {build_bytes}B + chunk capacity "
        f"{chunk_cap})")
    sorted_key, order, m = join_ops.build_side(build, bkeys)
    enc = _StreamDictEncoder(
        {pk: build.column(bk).dictionary for pk, bk in zip(pkeys, bkeys)
         if build.column(bk).dictionary is not None})
    chain_run = make_chain_runner(ex, chain)
    # a chunk's output starts at the chunk's own capacity (chunks are
    # padded to their own bucket, not to ``chunk_cap``); a regrow raises
    # the floor for the chunks after it
    state = {"floor": 8}
    progs: Dict[int, object] = {}
    outs: List[Batch] = []
    rows = {"probe": 0, "out": 0}

    def run_chunk(b: Batch, out_cap: int):
        prog = progs.get(out_cap)
        if prog is None:
            prog = progs[out_cap] = make_probe_program(jt, pkeys, residual,
                                                       out_cap)
        return prog(b, build, sorted_key, order, m)

    def dispatch(chunk: Batch, i: int):
        b = enc.encode(chain_run(chunk))
        out_cap = max(b.capacity, state["floor"])
        if i == 0:
            # the probe chunk program's shape (exec/hotshapes.py)
            from .hotshapes import join_key, join_payload, record_program
            record_program(
                "streamjoin", join_key("streamjoin", jt, node.criteria,
                                       residual, b, build, out_cap),
                None, None, ex.session,
                payload_fn=lambda: join_payload(jt, node.criteria,
                                                residual, b, build, out_cap,
                                                "streamjoin"))
        out, total = run_chunk(b, out_cap)
        return b, out, total, out_cap

    def collect(res, i: int):
        b, out, total, out_cap = res
        total = int(total)
        if total > out_cap:
            # a probe chunk matched more rows than the output holds: grow
            # the capacity (later chunks keep it as their floor) and run
            # the chunk again; a buffer past the reserved chunk output is
            # reserved like the first
            grown = capacity_for(total)
            if grown > chunk_cap:
                ex._reserve_streamed(
                    build_bytes + 2 * chunk_cap * probe_row
                    + grown * out_row,
                    f"streamed join output growth to {grown} rows (one "
                    "probe chunk matched more build rows than the output "
                    "holds; lower stream_chunk_rows)")
            state["floor"] = max(state["floor"], grown)
            out, total = run_chunk(b, grown)
        if residual is not None:
            out = ex._repair_outer(out, b, build, jt)
        rows["probe"] += b.num_rows_host()
        rows["out"] += _spill(ex, out, outs)

    run_streamed(ex, "join", host_scan_chunks(ex, scan, chunk_cap),
                 dispatch, collect)
    ex.join_sizes.append((rows["probe"], build.num_rows_host(),
                          rows["out"]))
    from .executor import device_concat
    if not outs:
        # no match or an empty probe: an honest zero-row expansion gives
        # the joined schema
        chunk0 = chain_run(_empty_batch(
            {s: scan.schema[s] for s in scan.assignments}, ex.device))
        z = torch.zeros(chunk0.capacity, dtype=torch.int64,
                        device=ex.device)
        out = join_ops.expand_join(chunk0, build, z, z, order, 8, "inner")
        return _empty_host(out), None
    return device_concat(outs), None
