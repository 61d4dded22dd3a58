"""Single-process plan executor over torch tensors.

Counterpart of ``trino_tpu/exec/executor.py``, eager: the executor walks
the plan bottom-up and evaluates each node as whole-column tensor
operations over capacity-padded Batches on one device. There are no jit
caches. An aggregation over a Filter/Project chain evaluates the filter
into a live mask that the aggregation consumes directly, with no
compaction (``_try_masked_filter_aggregation``). Joins and semi-joins
are the sort + binary-search joins of ops/join.py, materialised whole
(the JAX engine's eager ``join_ops`` path).

Host spill: a join whose output exceeds ``max_batch_rows`` expands its
probe rows in chunks on the device, filters each chunk by the residual
there, and copies each chunk's live rows to host memory (pinned on a
card), as the JAX engine's ``_oversized_join`` does. The spilled batch
moves back to the device in one place, ``Executor.execute``, where a node
reads its child's output; a node that returns a batch on another device
without the spill mark is an error. Operators never compute on host
lanes (the one exception is ``device_concat``, which keeps a merge that
includes a spilled part on the host, as the JAX engine does).

Set operations: UNION [ALL] concatenates its children's renamed columns
(``device_concat``, merging string dictionaries); INTERSECT and EXCEPT
[ALL] tag each side, count rows per distinct tuple with the general
GROUP BY and keep (or, for ALL, replicate) the rows the counts allow
(``setop_batches``); GroupId (ROLLUP, CUBE, GROUPING SETS) makes one copy
of its input per grouping set. Windows are exec/window.py.

Beyond device memory (exec/streamjoin.py): a scan that would not fit
the memory budget streams in chunks through a Filter/Project chain, a
hash join's probe, or an aggregation. An aggregation over a scan of
several splits aggregates split by split and combines the partials
(``_try_streaming_aggregation``); on a card, a table that fits the scan
cache (exec/scancache.py) is read whole from it instead.

Query controls: the session's cancel event and deadline are checked
before every plan node, split read, streamed chunk and spill chunk
(EXCEEDED_TIME_LIMIT past the deadline). With ``collect_stats`` every
node records a ``NodeStats`` (EXPLAIN ANALYZE, /v1/query), and each
reservation also feeds the coordinator's cluster memory pool when the
session carries one.

Worker tasks (server/task_worker.py): ``scan_partition`` restricts every
scan to the task's share of the splits, generated on this device; a
stage task's RemoteSource leaves read its partition of the upstream
stages through ``exchange_reader``; ``_Pre`` wraps the gathered output
of a leaf fragment (exec/remote.py).

Plan nodes, expressions and aggregates outside the ported slice raise
``QueryError("not yet ported: ...")``; nothing runs through another
engine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..catalog import CatalogManager
from ..columnar import (Batch, Column, StringDictionary, batch_from_pylist,
                        empty_batch,
                        hi_lane_or_fill, is_nested, key_hi_lane, null_column,
                        pad_batch, take_clamped)
from ..config import (CONFIG, MemoryLimitExceeded, capacity_for,
                      reserve_bytes)
from ..ops import compact, geo, int128 as i128, join as join_ops, \
    sort as sort_ops
from ..ops.groupby import (COMBINABLE_KINDS, AggInput, _changes, _key_lanes,
                           global_aggregate, group_aggregate)
from ..ops.hashing import GOLDEN, hash_column, mix64, shr, to_signed_order
from ..ops.hll import APPROX_SET_BUCKET_BITS, bucket_bits_for_error
from ..plan.nodes import (Aggregate, AggregationNode, AssignUniqueIdNode,
                          EnforceSingleRowNode, FilterNode, GroupIdNode,
                          JoinClause, JoinNode, LimitNode, MarkDistinctNode,
                          OffsetNode, OutputNode, PartitionedOutputNode,
                          PlanNode, ProjectNode, RemoteSourceNode,
                          SampleNode, SemiJoinNode, SetOpNode, SortNode,
                          TableScanNode, TopNNode, UnionNode, UnnestNode,
                          ValuesNode, WindowNode)
from ..planner.logical import SemiJoinMultiNode
from ..rex import Call, InputRef, and_all
from ..session import Session
from ..types import (BIGINT, BOOLEAN, DOUBLE, DecimalType, GeometryType,
                     QDigestType, REAL, TDigestType)
from .complex import concat_rows, packed_rows, top_k_map_entries
from .expr import EvalError, eval_expr, eval_predicate
from .scancache import (cache_memory_bytes, col_bytes, evict_cache_pressure,
                        read_split_cached, read_table_cached)
from .streamjoin import (_row_bytes, agg_chunk_capacity, check_interrupt,
                         host_scan_chunks, maybe_stream_chain,
                         maybe_stream_join, run_streamed)
from .window import execute_window, window_recordable

# position lanes that carry probe / build row numbers through a residual
# filter, so outer rows whose matches all failed can be null-extended
_PPOS, _BPOS = "__probe_pos$", "__build_pos$"


class QueryError(Exception):
    """Engine/user-facing failure. ``error_name``, when set, pins the
    Trino error name that errors.classify reports (memory kills and
    deadline breaches reach the client under their own name)."""

    def __init__(self, message: str, error_name: Optional[str] = None):
        super().__init__(message)
        if error_name is not None:
            self.error_name = error_name


class _Pre(PlanNode):
    """An already computed Batch as a plan node, so that handlers recurse
    through ``execute`` unchanged: the remote scheduler substitutes the
    gathered output of its leaf fragments (exec/remote.py)."""

    __slots__ = ("batch",)

    def __init__(self, batch: Batch):
        self.batch = batch

    @property
    def sources(self):
        return ()

    def output_schema(self):
        return self.batch.schema()


@dataclass
class NodeStats:
    """One plan node's execution: wall time (children included), rows and
    bytes in and out, thread-CPU time, and a detail note (the streamed
    chunks). Counterpart of the JAX engine's NodeStats; its compile and
    cache fields stay at their defaults here (the port compiles no
    programs), and ``device_s`` is not measured (0)."""
    name: str
    detail: str = ""
    wall_s: float = 0.0
    output_rows: int = -1
    input_rows: int = -1
    input_bytes: int = -1
    output_bytes: int = -1
    compile_s: float = 0.0
    cache_hit: Optional[bool] = None
    device_s: float = 0.0
    cpu_s: float = 0.0

    def to_dict(self) -> dict:
        return {"name": self.name, "detail": self.detail,
                "wall_s": self.wall_s, "output_rows": self.output_rows,
                "input_rows": self.input_rows,
                "input_bytes": self.input_bytes,
                "output_bytes": self.output_bytes,
                "compile_s": self.compile_s,
                "cache_hit": self.cache_hit,
                "device_s": self.device_s,
                "cpu_s": self.cpu_s}

    @staticmethod
    def from_dict(d: dict) -> "NodeStats":
        return NodeStats(
            d.get("name", "?"), d.get("detail", ""),
            float(d.get("wall_s", 0.0)), int(d.get("output_rows", -1)),
            int(d.get("input_rows", -1)), int(d.get("input_bytes", -1)),
            int(d.get("output_bytes", -1)),
            float(d.get("compile_s", 0.0)), d.get("cache_hit"),
            float(d.get("device_s", 0.0)), float(d.get("cpu_s", 0.0)))


def _sum_counts(vals: Sequence[int]) -> int:
    known = [v for v in vals if v is not None and v >= 0]
    return sum(known) if known else -1


def merge_node_stats(
        per_worker: Sequence[Sequence[NodeStats]]) -> List[NodeStats]:
    """Roll several executions' node stats of one plan into one list.
    The lists need not align position by position (a fused fast path
    gives fewer entries), so entries merge by (node name, occurrence),
    in the order of the longest list. Rows and bytes sum (the
    executions split the input); wall and compile take the max (they
    run at once); device and CPU seconds sum; cache_hit ANDs."""
    lists = [list(l) for l in per_worker if l]
    if not lists:
        return []

    def keyed(l: Sequence[NodeStats]):
        seen: Dict[str, int] = {}
        out = []
        for st in l:
            i = seen.get(st.name, 0)
            seen[st.name] = i + 1
            out.append(((st.name, i), st))
        return out

    base = max(lists, key=len)
    by_key: Dict[tuple, List[NodeStats]] = {}
    extras: List[tuple] = []
    for l in sorted(lists, key=len, reverse=True):
        for k, st in keyed(l):
            if k not in by_key:
                by_key[k] = []
                if l is not base:
                    extras.append(k)
            by_key[k].append(st)
    merged: List[NodeStats] = []
    for k in [k for k, _ in keyed(base)] + extras:
        same = by_key[k]
        hits = [st.cache_hit for st in same if st.cache_hit is not None]
        merged.append(NodeStats(
            same[0].name, same[0].detail,
            max(st.wall_s for st in same),
            _sum_counts([st.output_rows for st in same]),
            _sum_counts([st.input_rows for st in same]),
            _sum_counts([st.input_bytes for st in same]),
            _sum_counts([st.output_bytes for st in same]),
            max(st.compile_s for st in same),
            all(hits) if hits else None,
            sum(st.device_s for st in same),
            sum(st.cpu_s for st in same)))
    return merged


def render_analyze_lines(plan_lines, stats, trace) -> List[str]:
    """The EXPLAIN ANALYZE text: the plan tree, a line of stats per
    executed node, and the span tree."""
    lines = list(plan_lines or [])
    lines.append("")
    lines.extend(stats_lines(stats or []))
    if trace is not None and trace.roots:
        lines.append("")
        lines.append("Trace:")
        lines.extend(trace.lines())
    return lines


def stats_lines(stats: Sequence[NodeStats]) -> List[str]:
    """EXPLAIN ANALYZE's rendering of a NodeStats list (the JAX engine's
    format)."""
    out = []
    for st in stats:
        parts = [f"{st.name}: {st.wall_s * 1000:.2f}ms"]
        if st.input_rows >= 0:
            parts.append(f"in {st.input_rows} rows"
                         + (f"/{st.input_bytes}B"
                            if st.input_bytes >= 0 else ""))
        parts.append(f"out {st.output_rows} rows"
                     + (f"/{st.output_bytes}B"
                        if st.output_bytes >= 0 else ""))
        if st.compile_s > 0:
            parts.append(f"compile {st.compile_s * 1000:.2f}ms")
        if st.device_s > 0:
            parts.append(f"device {st.device_s * 1000:.2f}ms")
        if st.cpu_s > 0:
            parts.append(f"cpu {st.cpu_s * 1000:.2f}ms")
        if st.cache_hit is not None:
            parts.append("cache hit" if st.cache_hit else "cache miss")
        if st.detail:
            parts.append(st.detail)
        out.append(", ".join(parts))
    return out


def _keys_inexact(cols: Dict[str, Column], keys: Sequence[str]) -> bool:
    """True when the u64 equality lane of ops/join.py is not bijective
    for these keys: several columns (hash-combined), a float (hashed) or
    an Int128 decimal (only the low lane is hashed). A TIMESTAMP WITH
    TIME ZONE joins on its instant lane alone, which is exact."""
    if len(keys) > 1:
        return True
    c = cols[keys[0]]
    return key_hi_lane(c) is not None or c.data.is_floating_point()


def join_verify_filter(left_cols, right_cols, pkeys, bkeys, filt):
    """Hash-collision re-verification: when the key lane is inexact,
    append key-equality conjuncts to the residual filter, so the residual
    path drops collision rows and repairs outer rows from the surviving
    matches."""
    if not (_keys_inexact(left_cols, pkeys)
            or _keys_inexact(right_cols, bkeys)):
        return filt
    eqs = [Call("=", (InputRef(pk, left_cols[pk].type),
                      InputRef(bk, right_cols[bk].type)), BOOLEAN)
           for pk, bk in zip(pkeys, bkeys)]
    return and_all(([filt] if filt is not None else []) + eqs)


class Executor:
    def __init__(self, catalogs: CatalogManager, session: Session,
                 device: torch.device, collect_stats: bool = False):
        self.catalogs = catalogs
        self.session = session
        self.device = device
        # per-node stats (EXPLAIN ANALYZE, /v1/query): a frame per open
        # node gathers its input (children's output, split reads); on a
        # card each node ends with a device synchronisation, so its wall
        # covers its work
        self.collect_stats = collect_stats
        self.stats: List[NodeStats] = []
        self._frames: List[dict] = []
        # (probe rows, build rows, output rows) of each join, in the
        # order the joins finish
        self.join_sizes: List[Tuple[int, int, int]] = []
        # bytes of join output written to host memory (host spill)
        self.spilled_bytes: int = 0
        # largest single memory reservation of the query
        self.peak_reserved_bytes: int = 0
        # streamed operators (exec/streamjoin.py): chunks, bytes copied
        # to the device, copies complete before the compute stream needed
        # them, the copies' device ms and the compute stream's ms waiting
        # for them, chunks by operator, and the chunk loops' wall time
        self.stream_chunks: int = 0
        self.stream_h2d_bytes: int = 0
        self.stream_overlapped: int = 0
        self.stream_copy_ms: float = 0.0
        self.stream_wait_ms: float = 0.0
        self.stream_ops: Dict[str, int] = {}
        self.stream_s: float = 0.0
        # the hot-shape registry's chain hook (exec/hotshapes.py): the
        # source node of a chain of row-local nodes -> the chain's
        # canonical program, recorded once the source's output is known;
        # the chain's lower members are not chain tops of their own
        self._chain_bases: Dict[int, object] = {}
        self._chain_members: set = set()
        # a worker task's split share: (part, nparts) makes every scan
        # read only the splits whose index % nparts == part, generated
        # on this device (server/task_worker.py)
        self.scan_partition: Optional[Tuple[int, int]] = None
        # the stage-DAG exchange: fid -> this task's partition of stage
        # ``fid``'s output, as Batches on this device (stage/exchange.py;
        # wired by the worker for stage tasks and by exec/remote.py for
        # the coordinator's root stage)
        self.exchange_reader = None

    def split_share(self, splits: list) -> list:
        """This task's share of a scan's splits (all of them outside a
        worker task)."""
        if self.scan_partition is None:
            return splits
        part, nparts = self.scan_partition
        return [s for i, s in enumerate(splits) if i % nparts == part]

    def execute(self, node: PlanNode) -> Batch:
        check_interrupt(self.session)
        if not self.collect_stats:
            return self._execute_inner(node)
        return self._stats_wrap(node, lambda: self._execute_inner(node))

    def _value_rows_bytes(self, out) -> Tuple[int, int]:
        """(live rows, lane bytes) of a node's output."""
        return (out.num_rows_host(),
                sum(col_bytes(c) for c in out.columns.values()))

    def _stats_wrap(self, node: PlanNode, fn):
        """``fn()`` (the node's execution) with its NodeStats recorded."""
        # the streamed chunks and bytes of the node's children, which the
        # node's own count leaves out
        frame = {"rows": 0, "bytes": 0, "child_chunks": 0, "child_h2d": 0}
        self._frames.append(frame)
        chunks0, h2d0 = self.stream_chunks, self.stream_h2d_bytes
        t0 = time.perf_counter()
        cpu0 = time.thread_time()
        try:
            out = fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self._frames.pop()
        wall = time.perf_counter() - t0
        cpu_s = max(time.thread_time() - cpu0, 0.0)
        n, obytes = self._value_rows_bytes(out)
        chunks = self.stream_chunks - chunks0
        h2d = self.stream_h2d_bytes - h2d0
        own = chunks - frame["child_chunks"]
        detail = (f"streamed {own} chunks, {h2d - frame['child_h2d']}B h2d"
                  if own else "")
        self.stats.append(NodeStats(
            type(node).__name__.replace("Node", ""), detail, wall_s=wall,
            output_rows=n, input_rows=frame["rows"],
            input_bytes=frame["bytes"], output_bytes=obytes, cpu_s=cpu_s))
        if self._frames:
            parent = self._frames[-1]
            parent["rows"] += n
            parent["bytes"] += obytes
            parent["child_chunks"] += chunks
            parent["child_h2d"] += h2d
        return out

    def count_input(self, b: Batch) -> None:
        """Charge a batch read from a connector (a split, a cached table)
        to the current node's input."""
        if self.collect_stats and self._frames:
            self._frames[-1]["rows"] += b.num_rows_host()
            self._frames[-1]["bytes"] += sum(
                col_bytes(c) for c in b.columns.values())

    def _execute_inner(self, node: PlanNode) -> Batch:
        try:
            out = None
            if isinstance(node, (FilterNode, ProjectNode)):
                out = maybe_stream_chain(self, node)
            if isinstance(node, AggregationNode):
                out = self._try_streaming_aggregation(node)
                if out is None:
                    out = self._try_masked_filter_aggregation(node)
            if out is None:
                method = getattr(self, "_exec_" + type(node).__name__,
                                 None)
                if method is None:
                    raise QueryError(
                        f"not yet ported: {type(node).__name__}")
                self._note_chain(node)
                out = method(node)
        except (EvalError, NotImplementedError) as e:
            raise QueryError(str(e)) from e
        if out.spilled:
            # the one place a spilled batch returns to the device: the
            # parent reads its child's output here, from pinned memory
            out = out.to(self.device, non_blocking=True)
        else:
            self._check_device(out, type(node).__name__)
        canon = self._chain_bases.pop(id(node), None)
        if canon is not None:
            from .hotshapes import record_canonical
            record_canonical("chain", canon, out, self.session)
        return out

    def _note_chain(self, node: PlanNode) -> None:
        """At the top of a chain of row-local nodes (the JAX package's
        traceable chain, an aggregation being a barrier), remember its
        canonical program under the chain's source node, whose output is
        the program's input (hot-shape recording, exec/hotshapes.py)."""
        if not isinstance(node, _CHAIN_NODES):
            return
        if id(node) in self._chain_members:
            self._chain_members.discard(id(node))
            return
        chain: List[PlanNode] = []
        cur = node
        while isinstance(cur, _CHAIN_NODES):
            chain.append(cur)
            cur = cur.source
        from .progkey import canonicalize_nodes
        canon = canonicalize_nodes(chain)
        if canon is not None:
            self._chain_bases[id(cur)] = canon
            self._chain_members.update(id(n) for n in chain[1:])

    def _check_device(self, b: Batch, what: str) -> None:
        dev = self.device

        def lanes(c: Column):
            yield from (c.data, c.valid, c.data2)
            for k in (c.elements, c.elements2, *(c.children or ())):
                if k is not None:
                    yield from lanes(k)
        for name, c in b.columns.items():
            for t in lanes(c):
                if t is not None and (t.device.type != dev.type or (
                        dev.index is not None
                        and t.device.index != dev.index)):
                    raise QueryError(
                        f"internal error: {what} returned column {name} "
                        f"on {t.device}, not on {dev}, without the spill "
                        "mark")

    # ------------------------------------------------------------------
    # masked (selection-vector) filter -> aggregation fusion: filters
    # below an aggregation become a live mask consumed by the
    # aggregation, with no compaction gather
    # ------------------------------------------------------------------
    def _masked_chain_eval(self, chain, b: Batch):
        """Evaluate a Filter/Project/Sample chain over ``b`` without
        compacting: returns (columns, live mask). Dead rows compute
        garbage values that the mask consumer ignores; a sample draws on
        the positions of ``b``."""
        live = b.row_valid()
        cols = dict(b.columns)
        cap = b.capacity
        for nd in reversed(chain):
            # num_rows=cap: every row is live inside expression eval;
            # the real liveness is tracked in `live`
            bb = Batch(cols, cap)
            if isinstance(nd, FilterNode):
                live = live & eval_predicate(nd.predicate, bb)
            elif isinstance(nd, SampleNode):
                live = live & sample_mask(cap, nd.ratio, live.device)
            else:
                cols = {s: eval_expr(e, bb)
                        for s, e in nd.assignments.items()}
        return cols, live

    def _apply_node(self, nd: PlanNode, b: Batch) -> Batch:
        """One Filter or Project node over an already computed input."""
        if isinstance(nd, FilterNode):
            return compact.filter_batch(b, eval_predicate(nd.predicate, b))
        return Batch({s: eval_expr(e, b) for s, e in nd.assignments.items()},
                     b.num_rows)

    def _read_split(self, conn, split, columns,
                    device: Optional[torch.device] = None) -> Batch:
        """A split read through the scan cache, on this device (or a mesh
        shard's). A split is also where a cancel or a passed deadline
        stops a scan."""
        check_interrupt(self.session)
        t0 = time.perf_counter()
        b = read_split_cached(conn, split, columns).to(device or self.device)
        self.count_input(b)
        on_split = getattr(self.session, "on_split", None)
        if on_split is not None:
            # the coordinator's listeners see each split's read
            h = split.handle
            on_split(f"{h.catalog}.{h.schema}.{h.table}"
                     f"[{split.part}/{split.part_count}]",
                     time.perf_counter() - t0)
        return b

    # ------------------------------------------------------------------
    # streaming aggregation over scan splits: aggregate split by split
    # (or chunk by chunk) and combine the partials, so the scan is never
    # materialised whole
    # ------------------------------------------------------------------
    # kinds whose partials do not combine with a single-lane segment op:
    # they need all rows at once (the JAX engine's set)
    _NONSTREAMABLE = {"min_by", "max_by", "approx_distinct",
                      "approx_percentile", "array_agg", "map_agg",
                      "histogram", "approx_most_frequent",
                      "approx_set", "merge", "map_union", "multimap_agg",
                      "numeric_histogram", "tdigest_agg", "qdigest_agg"}

    def _try_streaming_aggregation(self, node: AggregationNode):
        if any(a.distinct or a.kind in self._NONSTREAMABLE
               for a in node.aggregates.values()):
            return None
        if not node.group_keys and not node.aggregates:
            return None
        chain: List[PlanNode] = []
        cur = node.source
        while isinstance(cur, (FilterNode, ProjectNode)):
            chain.append(cur)
            cur = cur.source
        if not isinstance(cur, TableScanNode):
            return None
        conn = self.catalogs.connector(cur.handle.catalog)
        par = int(self.session.get("task_concurrency")) or 1
        columns = sorted(set(cur.assignments.values()))
        # beyond the budget the splits are cut further into chunks that
        # stream through the double-buffered loop, and the partials fold
        # every 8 so that they stay bounded too
        stream_cap = agg_chunk_capacity(self, cur)
        # a table the scan cache holds whole is aggregated in one pass;
        # a worker task reads its own share of the splits
        whole = (None if stream_cap is not None
                 or self.scan_partition is not None
                 else read_table_cached(conn, cur.handle, columns, par,
                                        self.device))
        partial, run_full = make_stream_runners(self, chain, node)
        from .progkey import canonicalize_nodes
        canon = canonicalize_nodes([node] + chain)
        recorded = [False]

        def renamed(raw: Batch) -> Batch:
            return Batch({sym: raw.column(col)
                          for sym, col in cur.assignments.items()},
                         raw.num_rows)

        def record(kind: str, b: Batch) -> None:
            # the program shape, once per query (exec/hotshapes.py)
            if canon is None or recorded[0]:
                return
            recorded[0] = True
            from .hotshapes import record_canonical
            record_canonical(kind, canon, b, self.session,
                             None if kind == "stream"
                             else (canon.key, "full"))

        if whole is not None:
            self.count_input(whole)
            b = renamed(whole.to(self.device))
            record("stream_full", b)
            return run_full(b)
        splits = None
        if stream_cap is None:
            splits = self.split_share(conn.get_splits(cur.handle, par))
            if self.scan_partition is not None and not splits:
                return None     # an empty share: the generic path
            if len(splits) < 2 and self.scan_partition is None:
                return None
        partials: List[Batch] = []
        finals: List[AggInput] = []
        post: dict = {}

        def consume(batch: Batch) -> Batch:
            record("stream", batch)
            out, fins, fns = partial(batch)
            if not finals:
                finals.extend(fins)
                post.update(fns)
            return out

        def combine(parts: List[Batch]) -> Batch:
            return _combine(node, device_concat(parts), finals)

        if stream_cap is not None:
            # the streamed footprint: 2 chunks in flight and at most 8
            # chunk-sized partials before a fold
            self._reserve_streamed(
                10 * stream_cap * _row_bytes(cur.schema),
                f"chunk-streamed aggregation over {cur.handle.table} "
                f"(chunk capacity {stream_cap})")

            def collect(out: Batch, i: int) -> None:
                partials.append(out)
                if len(partials) >= 8:
                    partials[:] = [combine(partials)]

            run_streamed(self, "agg", host_scan_chunks(self, cur,
                                                        stream_cap),
                         lambda chunk, i: consume(chunk), collect)
            if not partials:
                return None         # an empty scan: the generic path
        else:
            for sp in splits:
                partials.append(consume(renamed(
                    self._read_split(conn, sp, columns))))
        return _apply_post(node, combine(partials), post)

    def _try_masked_filter_aggregation(self, node: AggregationNode):
        chain: List[PlanNode] = []
        cur = node.source
        while isinstance(cur, (FilterNode, ProjectNode, SampleNode)):
            chain.append(cur)
            cur = cur.source
        if not any(isinstance(n, (FilterNode, SampleNode)) for n in chain):
            return None
        cols, live = self._masked_chain_eval(chain, self.execute(cur))
        return _aggregate(node, Batch(cols, live.sum(dtype=torch.int64)),
                          live)

    # ------------------------------------------------------------------
    def _exec_TableScanNode(self, node: TableScanNode) -> Batch:
        conn = self.catalogs.connector(node.handle.catalog)
        columns = sorted(set(node.assignments.values()))
        par = int(self.session.get("task_concurrency")) or 1
        whole = (None if self.scan_partition is not None
                 else read_table_cached(conn, node.handle, columns, par,
                                        self.device))
        if whole is not None:
            self.count_input(whole)
        else:
            # check the memory guard before materialising the table; a
            # pushed-down constraint or limit shrinks the result by a
            # factor known only once the splits are read, so such a scan
            # reserves the rows it has read after every split
            what = f"table scan of {node.handle.table}"
            exact = node.handle.constraint is None \
                and node.handle.limit is None
            all_splits = conn.get_splits(node.handle, par)
            splits = self.split_share(all_splits)
            if not splits:
                # a worker whose share is empty returns no rows of the
                # scan's schema
                return empty_batch(dict(node.schema), self.device)
            if exact and hasattr(conn, "table_row_count"):
                est = conn.table_row_count(node.handle)
                if est:
                    share = -(-int(est) * len(splits) // len(all_splits))
                    self._reserve(share, len(columns), what)
            parts, rows = [], 0
            for sp in splits:
                parts.append(self._read_split(conn, sp, columns))
                if not exact:
                    rows += parts[-1].num_rows_host()
                    self._reserve(rows, len(columns), what)
            whole = device_concat(parts) if len(parts) > 1 else parts[0]
        whole = whole.to(self.device)
        return Batch({sym: whole.column(col)
                      for sym, col in node.assignments.items()},
                     whole.num_rows)

    def _exec_PartitionedOutputNode(self, node: PartitionedOutputNode
                                    ) -> Batch:
        # the partitioning happens at the page boundary (the worker cuts
        # the result into partition frames, stage/repartition.py);
        # executed here the node is the identity
        return self.execute(node.source)

    def _exec_RemoteSourceNode(self, node: RemoteSourceNode) -> Batch:
        """This task's partition of every upstream stage's output,
        through the exchange reader, in the fixed order the reader gives
        (stage, then task). A failed pull fails the attempt, which the
        stage scheduler retries."""
        reader = self.exchange_reader
        if reader is None:
            raise QueryError(
                "RemoteSourceNode executed outside a stage exchange "
                "context (no exchange reader wired)")
        batches: List[Batch] = []
        for fid in node.fragment_ids:
            batches.extend(b.to(self.device) for b in reader(int(fid)))
        if not batches:
            return empty_batch(dict(node.schema), self.device)
        return device_concat(batches) if len(batches) > 1 else batches[0]

    def _exec__Pre(self, node: _Pre) -> Batch:
        return node.batch.to(self.device)

    def _exec_ValuesNode(self, node: ValuesNode) -> Batch:
        data = {s: [row[i] for row in node.rows]
                for i, s in enumerate(node.schema)}
        return batch_from_pylist(data, dict(node.schema),
                                 device=self.device)

    def _exec_FilterNode(self, node: FilterNode) -> Batch:
        src = self.execute(node.source)
        return compact.filter_batch(src, eval_predicate(node.predicate,
                                                        src))

    def _exec_ProjectNode(self, node: ProjectNode) -> Batch:
        src = self.execute(node.source)
        return Batch({s: eval_expr(e, src)
                      for s, e in node.assignments.items()}, src.num_rows)

    def _exec_OutputNode(self, node: OutputNode) -> Batch:
        src = self.execute(node.source)
        return Batch({s: src.column(s) for s in node.symbols},
                     src.num_rows)

    def _exec_LimitNode(self, node: LimitNode) -> Batch:
        return compact.limit_batch(self.execute(node.source), node.count)

    def _exec_OffsetNode(self, node: OffsetNode) -> Batch:
        return compact.offset_batch(self.execute(node.source), node.count)

    def _exec_SampleNode(self, node: SampleNode) -> Batch:
        """BERNOULLI and SYSTEM alike: row i of the input is kept when
        the splitmix64 hash of i, as a fraction in [0, 1), falls below
        the ratio (the JAX engine's draw, bit for bit)."""
        src = self.execute(node.source)
        return compact.filter_batch(src, sample_mask(
            src.capacity, node.ratio, src.device))

    def _exec_AssignUniqueIdNode(self, node: AssignUniqueIdNode) -> Batch:
        src = self.execute(node.source)
        cols = dict(src.columns)
        cols[node.symbol] = Column(BIGINT, torch.arange(
            src.capacity, dtype=torch.int64, device=src.device), None)
        return Batch(cols, src.num_rows)

    def _exec_SortNode(self, node: SortNode) -> Batch:
        return sort_ops.sort_batch(self.execute(node.source),
                                   _sort_keys(node.keys))

    def _exec_TopNNode(self, node: TopNNode) -> Batch:
        return sort_ops.topn_batch(self.execute(node.source),
                                   _sort_keys(node.keys), node.count)

    def _exec_AggregationNode(self, node: AggregationNode) -> Batch:
        return _aggregate(node, self.execute(node.source), None)

    def _exec_MarkDistinctNode(self, node: MarkDistinctNode) -> Batch:
        """The input plus a marker lane, true on the first row (in the
        stable key order) of each distinct key."""
        src = self.execute(node.source)
        live = src.row_valid()
        lanes = _key_lanes(src, list(node.keys), live)
        order = sort_ops.lexsort([to_signed_order(x) for x in lanes])
        cap = src.capacity
        first = torch.arange(cap, device=live.device) == 0
        boundary = _changes(lanes[1:], order, first) & live[order]
        marker = torch.zeros(cap, dtype=torch.bool,
                             device=live.device).index_copy_(0, order,
                                                             boundary)
        cols = dict(src.columns)
        cols[node.marker] = Column(BOOLEAN, marker, None)
        return Batch(cols, src.num_rows)

    def _exec_EnforceSingleRowNode(self, node: EnforceSingleRowNode
                                   ) -> Batch:
        src = self.execute(node.source)
        n = src.num_rows_host()
        if n > 1:
            raise QueryError("Scalar sub-query has returned multiple rows")
        if n == 0:
            # one all-NULL row
            return Batch({s: dc_replace(c, valid=torch.zeros(
                c.capacity, dtype=torch.bool, device=c.device))
                for s, c in src.columns.items()}, 1)
        return src

    def _exec_GroupIdNode(self, node: GroupIdNode) -> Batch:
        """One copy of the input per grouping set; keys absent from a set
        become NULL; an int64 id lane tags the set."""
        src = self.execute(node.source)
        copies = []
        for i, keys in enumerate(node.grouping_sets):
            keep = set(keys)
            cols = {s: (dc_replace(c, valid=torch.zeros(
                c.capacity, dtype=torch.bool, device=c.device))
                if s in node.all_keys and s not in keep else c)
                for s, c in src.columns.items()}
            cols[node.id_symbol] = Column(BIGINT, torch.full(
                (src.capacity,), i, dtype=torch.int64, device=src.device))
            copies.append(Batch(cols, src.num_rows))
        return device_concat(copies)

    def _exec_WindowNode(self, node: WindowNode) -> Batch:
        src = self.execute(node.source)
        if window_recordable(node):
            from .progkey import canonicalize_nodes
            canon = canonicalize_nodes([node])
            if canon is not None:
                from .hotshapes import record_canonical
                record_canonical("window", canon, src, self.session)
        return execute_window(src, node)

    def _exec_UnnestNode(self, node: UnnestNode) -> Batch:
        """UNNEST: each input row becomes as many rows as its longest
        array (shorter arrays pad with NULL), by the searchsorted
        expansion of a join's output; WITH ORDINALITY adds the 1-based
        position."""
        src = self.execute(node.source)
        cap = src.capacity
        live = src.row_valid()
        arrs = {o: src.column(i) for o, i in node.unnest.items()}
        lens = {}
        count = None
        for o, c in arrs.items():
            ln = c.data2.to(torch.int64)
            if c.valid is not None:
                ln = torch.where(c.valid, ln, 0)
            lens[o] = ln
            count = ln if count is None else torch.maximum(count, ln)
        count = torch.where(live, count, 0)
        total = int(count.sum())
        out_cap = capacity_for(max(total, 1))
        self._reserve(out_cap, len(node.replicate) + len(arrs) + 1,
                      "unnest output")
        incl = torch.cumsum(count, 0)
        i = torch.arange(out_cap, dtype=torch.int64, device=src.device)
        p = torch.searchsorted(incl, i, right=True).clamp(0, cap - 1)
        j = i - (incl - count)[p]
        cols: Dict[str, Column] = {s: src.column(s).gather(p)
                                   for s in node.replicate}
        for o, c in arrs.items():
            el = c.elements.gather(c.data.to(torch.int64)[p] + j)
            cols[o] = dc_replace(el, valid=j < lens[o][p] if el.valid is None
                                 else el.valid & (j < lens[o][p]))
        if node.ordinality:
            cols[node.ordinality] = Column(BIGINT, j + 1, None)
        return Batch(cols, total)

    # ------------------------------------------------------------------
    # set operations
    # ------------------------------------------------------------------
    def _exec_UnionNode(self, node: UnionNode) -> Batch:
        parts = []
        for child, smap in zip(node.children, node.symbol_maps):
            b = self.execute(child)
            parts.append(Batch({out: b.column(inner)
                                for out, inner in smap.items()},
                               b.num_rows))
        return device_concat(parts)

    def _exec_SetOpNode(self, node: SetOpNode) -> Batch:
        left = self.execute(node.left)
        right = self.execute(node.right)
        lb = Batch({o: left.column(i) for o, i in node.left_map.items()},
                   left.num_rows)
        rb = Batch({o: right.column(i)
                    for o, i in node.right_map.items()}, right.num_rows)
        return setop_batches(lb, rb, node.op, node.distinct,
                             list(node.schema))

    # ------------------------------------------------------------------
    # joins
    # ------------------------------------------------------------------
    def _exec_JoinNode(self, node: JoinNode) -> Batch:
        jt = node.join_type
        if jt == "right":
            return self._exec_JoinNode(JoinNode(
                node.right, node.left, "left",
                tuple(JoinClause(c.right, c.left) for c in node.criteria),
                node.filter))
        streamed, pre_built = maybe_stream_join(self, node)
        if streamed is not None:
            return streamed
        left = self.execute(node.left)
        right = (pre_built if pre_built is not None
                 else self.execute(node.right))
        out = self._join(node, left, right)
        self.join_sizes.append((left.num_rows_host(), right.num_rows_host(),
                                out.num_rows_host()))
        return out

    def _join(self, node: JoinNode, left: Batch, right: Batch) -> Batch:
        jt = node.join_type
        if jt == "cross" or not node.criteria:
            return self._cross_join(left, right, node.filter, jt)

        pkeys = [c.left for c in node.criteria]
        bkeys = [c.right for c in node.criteria]
        filt = join_verify_filter(left.columns, right.columns, pkeys,
                                  bkeys, node.filter)
        width = len(left.columns) + len(right.columns)
        if filt is None:
            outer = jt in ("left", "full")
            start, count, order = join_ops.match_counts(left, right, pkeys,
                                                        bkeys)
            eff = (torch.where(left.row_valid(), count.clamp(min=1), 0)
                   if outer else count)
            total = int(eff.sum())
            if total > CONFIG.max_batch_rows:
                out = self._oversized_join(left, right, start, count, eff,
                                           order, total, width,
                                           "left" if outer else "inner")
            else:
                self._reserve(total, width, "join output")
                out_cap = capacity_for(total)
                out = join_ops.expand_join(left, right, start, count,
                                           order, out_cap,
                                           "left" if outer else "inner")
                self._record_join(node, left, right, out_cap)
            if jt == "full":
                out = self._append_right_unmatched(out, left, right, pkeys,
                                                   bkeys)
            return out
        # residual filter: expand as inner candidates carrying probe and
        # build positions, filter, then null-extend the outer rows from
        # the surviving matches (a key match the filter rejects must
        # still null-extend)
        probe = (_with_pos(left, _PPOS) if jt in ("left", "full")
                 else left)
        build = _with_pos(right, _BPOS) if jt == "full" else right
        start, count, order = join_ops.match_counts(probe, build, pkeys,
                                                    bkeys)
        total = int(count.sum())
        if total > CONFIG.max_batch_rows and jt == "inner":
            return self._oversized_join(probe, build, start, count, count,
                                        order, total, width, "inner",
                                        residual=filt)
        self._reserve(total, width, "join candidates")
        cand = join_ops.expand_join(probe, build, start, count, order,
                                    capacity_for(total), "inner")
        out = compact.filter_batch(cand, eval_predicate(filt, cand))
        return self._repair_outer(out, left, right, jt)

    def _record_join(self, node: JoinNode, left: Batch, right: Batch,
                     out_cap: int) -> None:
        """The materialised join's shape into the hot-shape registry."""
        if any(c.elements is not None or c.children is not None
               for b in (left, right) for c in b.columns.values()):
            return
        from .hotshapes import join_key, join_payload, record_program
        jt = "left" if node.join_type in ("left", "full") else "inner"
        record_program(
            "join", join_key("join", jt, node.criteria, None, left, right,
                             out_cap), None, None, self.session,
            payload_fn=lambda: join_payload(jt, node.criteria, None, left,
                                            right, out_cap, "join"))

    def _reserve(self, rows: int, n_lanes: int, what: str) -> None:
        """Check an allocation against query_max_memory_per_node before
        making it, so an oversized result fails with the memory-limit
        error instead of a device OOM."""
        limit = int(self.session.get("query_max_memory_per_node"))
        try:
            est = reserve_bytes(rows, n_lanes, limit, what)
        except MemoryLimitExceeded as e:
            raise QueryError(str(e), error_name="EXCEEDED_LOCAL_MEMORY_LIMIT"
                             ) from e
        self._account(est)

    def _reserve_streamed(self, nbytes: int, what: str) -> None:
        """Reserve a streamed operator's own footprint (build state, the
        chunks in flight, an output chunk), not the full materialisation
        that streaming avoids."""
        limit = int(self.session.get("query_max_memory_per_node"))
        if nbytes > limit:
            raise QueryError(
                f"Query exceeded per-node memory limit of {limit} bytes "
                f"({what} needs ~{nbytes} bytes even streamed); raise "
                "query_max_memory_per_node or lower stream_chunk_rows",
                error_name="EXCEEDED_LOCAL_MEMORY_LIMIT")
        self._account(int(nbytes))

    def _account(self, est: int) -> None:
        """Keep the query's peak reservation (its largest single one), let
        the caches yield to it (where the card cannot hold the
        reservation, cached lanes are evicted, oldest first, for the
        difference), and feed the coordinator's cluster memory pool
        (server/memory.py) when the session carries one: a breach of the
        query's cap, or a low-memory kill of this query, raises here a
        QueryError with its Trino error name."""
        self.peak_reserved_bytes = max(self.peak_reserved_bytes, est)
        free = self._free_device_bytes()
        if free is not None and est > free:
            evict_cache_pressure(est - free)
        mem = getattr(self.session, "memory", None)
        if mem is not None:
            mem.reserve(est)

    def _free_device_bytes(self) -> Optional[int]:
        """Bytes the card can still allocate (its free memory as CUDA
        reports it, and the blocks PyTorch holds unused); None off a
        card."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        return free + torch.cuda.memory_reserved(self.device) \
            - torch.cuda.memory_allocated(self.device)

    def _oversized_join(self, probe: Batch, build: Batch, start, count,
                        eff, order, total: int, width: int, jt: str,
                        residual=None) -> Batch:
        """Join whose output exceeds the per-batch device budget: expand
        probe-row chunks of at most ``max_batch_rows`` output rows on the
        device, filter each by the residual there, and copy each chunk's
        live rows to host memory (the spiller role of the reference's
        HashBuilderOperator; host RAM is the first rung of the
        device -> host -> disk ladder). With spill disabled the memory
        guard decides first."""
        if not bool(self.session.get("spill_enabled")):
            self._reserve(total, width, "join output (spill disabled)")
        cum = np.cumsum(eff.cpu().numpy())
        budget = CONFIG.max_batch_rows
        n_live = probe.num_rows_host()
        dev = probe.device
        chunks: List[Batch] = []
        lo = consumed = 0
        while lo < probe.capacity and consumed < total:
            check_interrupt(self.session)
            hi = max(int(np.searchsorted(cum, consumed + budget, "right")),
                     lo + 1)
            chunk_rows = int(cum[hi - 1] - consumed)
            if chunk_rows == 0:
                lo = hi
                continue
            sel = torch.arange(lo, hi, dtype=torch.int64, device=dev)
            # gathered rows are live iff their position was in the live
            # prefix, so the chunk's liveness is again a prefix
            sub = probe.gather(sel, max(min(n_live, hi) - lo, 0))
            out = join_ops.expand_join(sub, build, start[sel], count[sel],
                                       order, capacity_for(chunk_rows), jt)
            consumed += chunk_rows
            lo = hi
            if residual is not None:
                # only the survivors leave the device
                out = compact.filter_batch(out,
                                           eval_predicate(residual, out))
                chunk_rows = out.num_rows_host()
                if chunk_rows == 0:
                    continue
            spilled = _to_host(out, chunk_rows)
            self.spilled_bytes += sum(col_bytes(c)
                                      for c in spilled.columns.values())
            chunks.append(spilled)
        if not chunks:
            empty = _to_host(join_ops.expand_join(
                probe, build, start, torch.zeros_like(count), order, 8, jt),
                8)
            return Batch(empty.columns, 0, spilled=True)
        return device_concat(chunks)

    def _cross_join(self, left: Batch, right: Batch, filt,
                    jt: str = "inner") -> Batch:
        """Cross or non-equi join (no equi criteria); for left/full outer
        variants the positions ride through the filter, as in the
        residual path."""
        total = left.num_rows_host() * right.num_rows_host()
        self._reserve(total, len(left.columns) + len(right.columns),
                      "cross join output")
        probe = (_with_pos(left, _PPOS) if jt in ("left", "full")
                 else left)
        build = _with_pos(right, _BPOS) if jt == "full" else right
        start, count, order = join_ops.cross_counts(probe, build)
        out = join_ops.expand_join(probe, build, start, count, order,
                                   capacity_for(max(total, 1)), "inner")
        if filt is not None:
            out = compact.filter_batch(out, eval_predicate(filt, out))
        return self._repair_outer(out, left, right, jt)

    def _repair_outer(self, out: Batch, left: Batch, right: Batch,
                      jt: str) -> Batch:
        """Strip the position lanes; null-extend outer rows whose matches
        all died in the filter."""
        live_out = out.row_valid()
        pp = out.column(_PPOS).data if jt in ("left", "full") else None
        bb = out.column(_BPOS).data if jt == "full" else None
        if pp is None and bb is None:
            return out
        out = Batch({s: c for s, c in out.columns.items()
                     if s not in (_PPOS, _BPOS)}, out.num_rows)
        if pp is not None:
            unmatched = left.row_valid() & ~_hit(pp, live_out,
                                                 left.capacity)
            out = device_concat([out, _null_extend(left, right,
                                                   unmatched)])
        if bb is not None:
            unmatched_b = right.row_valid() & ~_hit(bb, live_out,
                                                    right.capacity)
            out = device_concat([out, _null_extend_right(left, right,
                                                         unmatched_b)])
        return out

    def _append_right_unmatched(self, out: Batch, left: Batch,
                                right: Batch, pkeys, bkeys) -> Batch:
        """FULL JOIN tail (no residual filter): right rows with no key
        match, null-extended."""
        _, count, _ = join_ops.match_counts(right, left, bkeys, pkeys)
        unmatched = right.row_valid() & (count == 0)
        return device_concat([out, _null_extend_right(left, right,
                                                      unmatched)])

    # ------------------------------------------------------------------
    # semi-joins
    # ------------------------------------------------------------------
    def _exec_SemiJoinNode(self, node: SemiJoinNode) -> Batch:
        src = self.execute(node.source)
        filt = self.execute(node.filtering_source)
        matched, key_null, build_null, nonempty = join_ops.semi_join_mask(
            src, filt, [node.source_key], [node.filtering_key])
        # x IN (...): TRUE if matched; FALSE if the build side is empty;
        # NULL if the probe key is NULL or the build side holds a NULL
        valid = matched | ~nonempty | (~key_null & ~build_null)
        cols = dict(src.columns)
        cols[node.output] = Column(BOOLEAN, matched, valid)
        return Batch(cols, src.num_rows)

    def _exec_SemiJoinMultiNode(self, node: SemiJoinMultiNode) -> Batch:
        src = self.execute(node.source)
        filt = self.execute(node.filtering_source)
        skeys = list(node.source_keys)
        fkeys = list(node.filtering_keys)
        residual = (join_verify_filter(src.columns, filt.columns, skeys,
                                       fkeys, node.filter)
                    if skeys else node.filter)
        cols = dict(src.columns)
        if residual is None and skeys:
            matched, _, _, _ = join_ops.semi_join_mask(src, filt, skeys,
                                                       fkeys)
            cols[node.output] = Column(BOOLEAN, matched, None)
            return Batch(cols, src.num_rows)
        # residual filter: expand the candidate matches, filter, then
        # mark the probe rows with a surviving match
        probe = _with_pos(src, _PPOS)
        if skeys:
            start, count, order = join_ops.match_counts(probe, filt, skeys,
                                                        fkeys)
        else:
            start, count, order = join_ops.cross_counts(probe, filt)
        total = int(count.sum())
        self._reserve(total, len(probe.columns) + len(filt.columns),
                      "semi-join candidates")
        cand = join_ops.expand_join(probe, filt, start, count, order,
                                    capacity_for(total), "inner")
        live = cand.row_valid()
        if residual is not None:
            live = live & eval_predicate(residual, cand)
        cols[node.output] = Column(
            BOOLEAN, _hit(cand.column(_PPOS).data, live, src.capacity),
            None)
        return Batch(cols, src.num_rows)


# row-local nodes that form one chain program above their source (the JAX
# package's traceable chain; an aggregation is a barrier)
_CHAIN_NODES = (FilterNode, ProjectNode, LimitNode, OffsetNode, SortNode,
                TopNNode, SampleNode, AssignUniqueIdNode, MarkDistinctNode)


def setop_tag(lb: Batch, rb: Batch) -> List[Batch]:
    """Tag each side with per-side counters (1, 0) and (0, 1) for the
    counting group-by (the reference's ImplementIntersectDistinctAsUnion
    and ImplementExceptAll rules)."""
    tagged = []
    for b, (lc, rc) in ((lb, (1, 0)), (rb, (0, 1))):
        cols = dict(b.columns)
        for sym, v in (("__l$", lc), ("__r$", rc)):
            cols[sym] = Column(BIGINT, torch.full(
                (b.capacity,), v, dtype=torch.int64, device=b.device))
        tagged.append(Batch(cols, b.num_rows))
    return tagged


SETOP_AGGS = (AggInput("sum", "__l$", output="__nl$"),
              AggInput("sum", "__r$", output="__nr$"))


def setop_keep_times(nl, nr, op: str, distinct: bool):
    """(keep mask, replication times or None) from the per-side counts:
    INTERSECT keeps tuples on both sides, EXCEPT those only on the left;
    INTERSECT ALL replicates min(nl, nr) times, EXCEPT ALL nl - nr."""
    if op == "intersect":
        keep = (nl > 0) & (nr > 0)
    elif distinct:
        keep = (nl > 0) & (nr == 0)
    else:
        keep = nl > nr
    if distinct:
        return keep, None
    times = (torch.minimum(nl, nr) if op == "intersect"
             else torch.clamp(nl - nr, min=0))
    return keep, times


def setop_batches(lb: Batch, rb: Batch, op: str, distinct: bool,
                  out_syms) -> Batch:
    """INTERSECT/EXCEPT [ALL] over two schema-aligned batches: count each
    distinct tuple's rows per side with the general GROUP BY, keep the
    tuples the counts allow, and for ALL replicate each kept tuple by
    searchsorted over the cumulative counts (int64)."""
    both = device_concat(setop_tag(lb, rb))
    g = group_aggregate(both, out_syms, list(SETOP_AGGS))
    nl = g.column("__nl$").data
    nr = g.column("__nr$").data
    keep, times = setop_keep_times(nl, nr, op, distinct)
    out = compact.filter_batch(g, keep)
    if times is not None:
        times = times[compact.mask_to_gather(keep & g.row_valid())[0]]
        times = torch.where(out.row_valid(), times, 0).to(torch.int64)
        incl = torch.cumsum(times, 0)
        total = int(incl[-1])
        cap = capacity_for(max(total, 1))
        i = torch.arange(cap, dtype=torch.int64, device=incl.device)
        p = torch.searchsorted(incl, i, right=True)
        out = out.gather(p.clamp(0, out.capacity - 1), total)
    return Batch({s: out.column(s) for s in out_syms}, out.num_rows)


def _with_pos(b: Batch, name: str) -> Batch:
    cols = dict(b.columns)
    cols[name] = Column(BIGINT, torch.arange(b.capacity, dtype=torch.int64,
                                             device=b.device))
    return Batch(cols, b.num_rows)


def _hit(pos: torch.Tensor, live: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] mask of the positions that some live row carries. Every
    write stores True (dead rows write to a spare slot), so duplicate
    positions cannot race."""
    out = torch.zeros(cap + 1, dtype=torch.bool, device=pos.device)
    idx = torch.where(live, pos.clamp(0, cap - 1), cap)
    return out.index_fill_(0, idx, True)[:cap]


def _null_columns(cols: Dict[str, Column], cap: int,
                  device: torch.device) -> Dict[str, Column]:
    """All-NULL columns of the given types, ``cap`` rows each."""
    def zeros(dtype):
        return torch.zeros(cap, dtype=dtype, device=device)
    return {s: null_column(c.type, cap, device) if is_nested(c.type)
            else Column(c.type, zeros(c.data.dtype), zeros(torch.bool),
                        c.dictionary,
                        None if c.data2 is None else zeros(torch.int64),
                        c.elements)
            for s, c in cols.items()}


def _null_extend(left: Batch, right: Batch, row_mask) -> Batch:
    """Rows of ``left`` where mask, with all-NULL right columns."""
    sub = compact.filter_batch(left, row_mask)
    cols = dict(sub.columns)
    cols.update(_null_columns(right.columns, sub.capacity, sub.device))
    return Batch(cols, sub.num_rows)


def _null_extend_right(left: Batch, right: Batch, row_mask) -> Batch:
    """Rows of ``right`` where mask, with all-NULL left columns."""
    sub = compact.filter_batch(right, row_mask)
    cols = _null_columns(left.columns, sub.capacity, sub.device)
    cols.update(sub.columns)
    return Batch(cols, sub.num_rows)


def sample_mask(cap: int, ratio: float, device: torch.device
                ) -> torch.Tensor:
    """Positions 0..cap-1 whose hash draw ``(mix64(i) >>> 11) / 2^53``
    is below ``ratio``. The u64 hash is carried in int64 (ops/hashing.py);
    its top 53 bits convert to float64 exactly, and the division by a
    power of two is exact on either device."""
    h = mix64(torch.arange(cap, dtype=torch.int64, device=device))
    return shr(h, 11).to(torch.float64) / float(1 << 53) < ratio


def _sort_keys(keys) -> List[sort_ops.SortKey]:
    return [sort_ops.SortKey(k.symbol, k.ascending, k.nulls_first)
            for k in keys]


def _aggregate(node: AggregationNode, src: Batch,
               live: Optional[torch.Tensor]) -> Batch:
    """Lower the logical aggregates, aggregate (grouped or global), then
    apply the post functions (avg = sum / count, variance, ...)."""
    phys, post, extra = _lower_aggregates(node.aggregates, src)
    if extra:
        src = Batch({**src.columns, **extra}, src.num_rows)
    if node.group_keys:
        out = group_aggregate(src, list(node.group_keys), phys, live=live)
    elif phys:
        out = global_aggregate(src, phys, live=live)
    else:
        return _single_row(src.device)
    return _apply_post(node, out, post)


def _apply_post(node: AggregationNode, out: Batch, post) -> Batch:
    if post:
        cols = dict(out.columns)
        for sym, fn in post.items():
            cols[sym] = fn(out)
        keep = set(node.group_keys) | set(node.aggregates)
        out = Batch({s: c for s, c in cols.items() if s in keep},
                    out.num_rows)
    return out


def make_stream_runners(ex: Executor, chain, node: AggregationNode):
    """The streaming aggregation's two programs over a Filter/Project
    chain and an AggregationNode: ``partial`` (one split's partial
    aggregate, with the aggregates that combine it and the post functions
    of its lowering) and ``run_full`` (a whole table: partial, combine and
    post functions in one pass). The filters become a live mask the
    aggregation consumes (no compaction)."""
    def partial(b: Batch):
        cols, live = ex._masked_chain_eval(chain, b)
        src = Batch(cols, live.sum(dtype=torch.int64))
        phys, post, extra = _lower_aggregates(node.aggregates, src)
        if extra:
            src = Batch({**src.columns, **extra}, src.num_rows)
        if node.group_keys:
            out = group_aggregate(src, list(node.group_keys), phys,
                                  live=live)
        else:
            out = _pad_partial(global_aggregate(src, phys, live=live))
        finals = [AggInput(COMBINABLE_KINDS[a.kind], a.output, None,
                           a.output) for a in phys]
        return out, finals, post

    def run_full(b: Batch) -> Batch:
        out, finals, post = partial(b)
        return _apply_post(node, _combine(node, out, finals), post)

    return partial, run_full


def _combine(node: AggregationNode, parts: Batch,
             finals: List[AggInput]) -> Batch:
    """Partials (concatenated) combined into one partial of their
    groups."""
    if node.group_keys:
        return group_aggregate(parts, list(node.group_keys), finals)
    return _pad_partial(global_aggregate(parts, finals))


def _pad_partial(b: Batch) -> Batch:
    """A one-row global partial padded to capacity 8, so that the
    partials of every split concatenate alike."""
    return pad_batch(b, 8)


def _single_row(device: torch.device) -> Batch:
    return Batch({"__one$": Column(
        BIGINT, torch.zeros(8, dtype=torch.int64, device=device))}, 1)


def _lower_aggregates(aggregates: Dict[str, Aggregate], src: Batch):
    """Map logical aggregates onto the kinds ops/groupby.py computes,
    returning (phys_aggs, post_fns, extra_columns). The decomposition
    mirrors the reference's accumulator states: avg = LongAndDoubleState,
    variance and the moments = CentralMomentsState, corr/covar/regr =
    the Covariance, Correlation and Regression states over pairwise sums,
    checksum = a wrapping int64 sum of row hashes."""
    phys: List[AggInput] = []
    post = {}
    extra: Dict[str, Column] = {}
    for sym, a in aggregates.items():
        kind = a.kind
        if kind == "count" and a.distinct or kind == "approx_distinct":
            # exact, as the JAX engine computes approx_distinct
            phys.append(AggInput("count_distinct", a.argument, a.mask,
                                 sym))
        elif a.distinct:
            raise NotImplementedError(f"not yet ported: {kind}(DISTINCT)")
        elif kind in ("sum", "min", "max", "count", "count_star"):
            phys.append(AggInput(kind, a.argument, a.mask, sym))
        elif kind in ("any_value", "arbitrary"):
            phys.append(AggInput("any_value", a.argument, a.mask, sym))
        elif kind == "avg":
            ssym, csym = sym + "$sum", sym + "$cnt"
            phys.append(AggInput("sum", a.argument, a.mask, ssym))
            phys.append(AggInput("count", a.argument, a.mask, csym))
            post[sym] = _avg_post(ssym, csym, a.type)
        elif kind == "count_if":
            msym = sym + "$mask"
            m = _true(src.column(a.argument))
            if a.mask is not None:
                m = m & _true(src.column(a.mask))
            extra[msym] = Column(BOOLEAN, m, None)
            phys.append(AggInput("count_star", None, msym, sym))
        elif kind in ("bool_and", "every", "bool_or"):
            op = "min" if kind in ("bool_and", "every") else "max"
            phys.append(AggInput(op, a.argument, a.mask, sym))
        elif kind in ("stddev", "stddev_samp", "stddev_pop", "variance",
                      "var_samp", "var_pop"):
            bsym, d, bvalid = _stat_lane(src, a.argument, extra, sym + "$f")
            sqsym = sym + "$sq"
            extra[sqsym] = Column(DOUBLE, d * d, bvalid)
            ssym, csym, s2sym = sym + "$s", sym + "$c", sym + "$s2"
            phys.append(AggInput("sum", bsym, a.mask, ssym))
            phys.append(AggInput("count", bsym, a.mask, csym))
            phys.append(AggInput("sum", sqsym, a.mask, s2sym))
            post[sym] = _variance_post(ssym, csym, s2sym,
                                       kind.endswith("_pop"),
                                       kind.startswith("stddev"))
        elif kind == "geometric_mean":
            lsym = sym + "$ln"
            _, d, bvalid = _stat_lane(src, a.argument, extra, sym + "$f")
            extra[lsym] = Column(DOUBLE, torch.log(d), bvalid)
            ssym, csym = sym + "$s", sym + "$c"
            phys.append(AggInput("sum", lsym, a.mask, ssym))
            phys.append(AggInput("count", lsym, a.mask, csym))
            post[sym] = _geomean_post(ssym, csym)
        elif kind in ("bitwise_and_agg", "bitwise_or_agg"):
            phys.append(AggInput(
                "bit_and" if kind == "bitwise_and_agg" else "bit_or",
                a.argument, a.mask, sym))
        elif kind in ("min_by", "max_by"):
            phys.append(AggInput(
                "argmin" if kind == "min_by" else "argmax",
                a.argument, a.mask, sym, input2=a.argument2))
        elif kind == "approx_set":
            # the parameter is the requested standard error: a bucket
            # count exponent, fixed at plan time
            b = (bucket_bits_for_error(float(a.param))
                 if a.param is not None else APPROX_SET_BUCKET_BITS)
            phys.append(AggInput("hll", a.argument, a.mask, sym,
                                 param=float(b)))
        elif kind == "merge":
            argt = src.column(a.argument).type
            phys.append(AggInput(
                "digest_merge" if isinstance(argt, (TDigestType, QDigestType))
                else "hll_merge", a.argument, a.mask, sym))
        elif kind in ("tdigest_agg", "qdigest_agg"):
            phys.append(AggInput(
                "tdigest" if kind == "tdigest_agg" else "qdigest",
                a.argument, a.mask, sym, input2=a.argument2, param=a.param))
        elif kind in ("array_agg", "histogram", "map_union"):
            phys.append(AggInput(kind, a.argument, a.mask, sym))
        elif kind in ("map_agg", "multimap_agg"):
            phys.append(AggInput(kind, a.argument, a.mask, sym,
                                 input2=a.argument2))
        elif kind == "numeric_histogram":
            phys.append(AggInput(kind, a.argument, a.mask, sym,
                                 input2=a.argument2, param=a.param))
        elif kind == "approx_most_frequent":
            # the exact histogram, then each group's k most frequent
            # entries (the reference approximates with a stream summary;
            # exact is a correct superset)
            phys.append(AggInput("histogram", a.argument, a.mask, sym))
            post[sym] = _amf_post(sym, int(a.param) if a.param is not None
                                  else 3)
        elif kind == "approx_percentile":
            phys.append(AggInput("percentile", a.argument, a.mask, sym,
                                 param=a.param))
        elif kind == "checksum":
            # an order-independent multiset hash: the wrapping int64 sum
            # of row hashes (ops/hashing.py), NULL a fixed odd constant
            arg = src.column(a.argument)
            h = hash_column(arg.data, arg.valid)
            if key_hi_lane(arg) is not None:
                h = h * 31 + hash_column(arg.data2, arg.valid)
            if arg.valid is not None:
                h = torch.where(arg.valid, h, GOLDEN)
            hsym = sym + "$h"
            extra[hsym] = Column(BIGINT, h, None)
            phys.append(AggInput("sum", hsym, a.mask, sym))
        elif kind in ("corr", "covar_samp", "covar_pop", "regr_slope",
                      "regr_intercept"):
            # sums of products over the rows where both sides are valid
            _, yd, yv = _stat_lane(src, a.argument, extra, sym + "$fy")
            _, xd, xv = _stat_lane(src, a.argument2, extra, sym + "$fx")
            pv = yv if xv is None else xv if yv is None else yv & xv
            lanes = {"y": yd, "x": xd, "xy": xd * yd, "xx": xd * xd}
            if kind == "corr":
                lanes["yy"] = yd * yd
            names = {}
            for tag, d in lanes.items():
                extra[f"{sym}${tag}"] = Column(DOUBLE, d, pv)
                names[tag] = f"{sym}$s{tag}"
                phys.append(AggInput("sum", f"{sym}${tag}", a.mask,
                                     names[tag]))
            csym = sym + "$n"
            phys.append(AggInput("count", f"{sym}$x", a.mask, csym))
            post[sym] = _bivariate_post(kind, names, csym)
        elif kind in ("skewness", "kurtosis"):
            bsym, d, bvalid = _stat_lane(src, a.argument, extra, sym + "$f")
            # the powers as the reference's XLA integer_pow forms them
            p2 = d * d
            powers = {"2": p2, "3": d * p2}
            if kind == "kurtosis":
                powers["4"] = p2 * p2
            names = {}
            for tag, pw in powers.items():
                extra[f"{sym}$p{tag}"] = Column(DOUBLE, pw, bvalid)
                names[tag] = f"{sym}$s{tag}"
                phys.append(AggInput("sum", f"{sym}$p{tag}", a.mask,
                                     names[tag]))
            ssym, csym = sym + "$s1", sym + "$n"
            phys.append(AggInput("sum", bsym, a.mask, ssym))
            phys.append(AggInput("count", bsym, a.mask, csym))
            post[sym] = _moments_post(kind, ssym, names, csym)
        else:
            raise NotImplementedError(f"not yet ported: aggregate {kind}")
    return phys, post, extra


def _amf_post(sym: str, k: int):
    def fn(out: Batch) -> Column:
        return top_k_map_entries(out.column(sym), k)
    return fn


def _true(c: Column) -> torch.Tensor:
    m = c.data.to(torch.bool)
    return m if c.valid is None else m & c.valid


def _stat_lane(src: Batch, name: str, extra: Dict[str, Column], tag: str):
    """(symbol, f64 lane, validity) of a numeric input of the statistical
    aggregates; a short decimal is unscaled into a new f64 lane."""
    col = src.column(name)
    d = col.data.to(torch.float64)
    if isinstance(col.type, DecimalType):
        if col.data2 is not None:
            raise NotImplementedError(
                f"not yet ported: statistical aggregates over {col.type}")
        d = d / torch.full((), 10.0 ** col.type.scale,
                           dtype=torch.float64, device=d.device)
        extra[tag] = Column(DOUBLE, d, col.valid)
        return tag, d, col.valid
    return name, d, col.valid


def _f64(out: Batch, sym: str) -> torch.Tensor:
    return out.column(sym).data.to(torch.float64)


def _variance_post(ssym, csym, s2sym, pop: bool, sqrt: bool):
    def fn(out: Batch) -> Column:
        s, n, s2 = _f64(out, ssym), _f64(out, csym), _f64(out, s2sym)
        m2 = s2 - s * s / torch.clamp(n, min=1.0)
        v = torch.clamp(m2 / torch.clamp(n if pop else n - 1.0, min=1.0),
                        min=0.0)
        return Column(DOUBLE, torch.sqrt(v) if sqrt else v,
                      n > (0.0 if pop else 1.0))
    return fn


def _bivariate_post(kind: str, s: Dict[str, str], csym: str):
    """corr/covar/regr from the pairwise sums, with the formulas of the
    reference's accumulator states (CovarianceState and others)."""
    def fn(out: Batch) -> Column:
        n = _f64(out, csym)
        sy, sx = _f64(out, s["y"]), _f64(out, s["x"])
        sxy, sxx = _f64(out, s["xy"]), _f64(out, s["xx"])
        one = torch.ones_like(n)
        nn = torch.clamp(n, min=1.0)
        co = sxy - sx * sy / nn          # n * cov_pop
        mxx = sxx - sx * sx / nn         # n * var_pop(x)
        if kind == "covar_pop":
            data, valid = co / nn, n > 0
        elif kind == "covar_samp":
            data, valid = co / torch.clamp(n - 1.0, min=1.0), n > 1
        elif kind == "corr":
            syy = _f64(out, s["yy"])
            myy = syy - sy * sy / nn
            denom = torch.sqrt(mxx * myy)
            data = co / torch.where(denom > 0.0, denom, one)
            valid = (n > 1) & (denom > 0.0)
        else:
            slope = co / torch.where(mxx > 0.0, mxx, one)
            data = slope if kind == "regr_slope" else \
                (sy - slope * sx) / nn
            valid = (n > 0) & (mxx > 0.0)
        return Column(DOUBLE, data, valid)
    return fn


def _moments_post(kind: str, ssym: str, s: Dict[str, str], csym: str):
    """skewness/kurtosis from raw power sums through the central moments
    m_k = sum((x - mean)^k) (the reference's CentralMomentsState); x ** k
    is written as the products the JAX engine's integer powers form.
    skewness = sqrt(n) m3 / m2^1.5; kurtosis = n (n+1) (n-1) m4 /
    ((n-2) (n-3) m2^2) - 3 (n-1)^2 / ((n-2) (n-3)), Trino's unbiased
    excess kurtosis (AggregationUtils.getKurtosis; the JAX engine has n
    where (n-1)^2 belongs, ROADMAP C)."""
    def fn(out: Batch) -> Column:
        n = _f64(out, csym)
        s1, s2, s3 = _f64(out, ssym), _f64(out, s["2"]), _f64(out, s["3"])
        one = torch.ones_like(n)
        nn = torch.clamp(n, min=1.0)
        nn2 = nn * nn
        s1p2 = s1 * s1
        m2 = s2 - s1p2 / nn
        m3 = s3 - 3.0 * s1 * s2 / nn + 2.0 * (s1 * s1p2) / nn2
        m2s = torch.where(m2 > 0.0, m2, one)
        if kind == "skewness":
            data = torch.sqrt(nn) * m3 / m2s ** 1.5
            valid = (n > 2) & (m2 > 0.0)
        else:
            s4 = _f64(out, s["4"])
            m4 = (s4 - 4.0 * s1 * s3 / nn + 6.0 * s1 * s1 * s2 / nn2
                  - 3.0 * (s1p2 * s1p2) / (nn * nn2))
            n1 = nn - 1.0
            d23 = torch.clamp((nn - 2.0) * (nn - 3.0), min=1.0)
            data = (nn * (nn + 1.0) * n1 * m4 / (d23 * m2s * m2s)
                    - 3.0 * (n1 * n1) / d23)
            valid = (n > 3) & (m2 > 0.0)
        return Column(DOUBLE, data, valid)
    return fn


def _geomean_post(ssym, csym):
    def fn(out: Batch) -> Column:
        s, n = _f64(out, ssym), _f64(out, csym)
        return Column(DOUBLE, torch.exp(s / torch.clamp(n, min=1.0)),
                      n > 0)
    return fn


def _avg_post(ssym, csym, rtype):
    """avg = sum / count. An Int128 decimal sum rescales to the result
    scale and divides by the count exactly, HALF_UP; a result scale
    below the sum's folds the 10^k into the divisor, so the value rounds
    once (the reference's DecimalAverageAggregation)."""
    def fn(out: Batch) -> Column:
        s = out.column(ssym)
        c = out.column(csym)
        cnt = c.data.to(torch.float64)
        valid = cnt > 0
        if isinstance(rtype, DecimalType) and s.data2 is not None:
            shift = rtype.scale - s.type.scale
            lo, hi = i128.rescale(s.data.to(torch.int64), s.data2,
                                  max(shift, 0))
            cn = torch.clamp(c.data.to(torch.int64), min=1)
            if shift < 0:
                lo, hi = i128.div128_round_half_up_scaled(lo, hi, cn,
                                                          -shift)
            else:
                lo, hi = i128.div128_round_half_up_pair(
                    lo, hi, cn, torch.zeros_like(cn))
            return Column(rtype, lo, valid,
                          data2=None if rtype.is_short else hi)
        num = s.data.to(torch.float64)
        if isinstance(s.type, DecimalType):
            num = num / torch.full((), 10.0 ** s.type.scale,
                                   dtype=torch.float64, device=num.device)
        data = num / torch.clamp(cnt, min=1.0)
        if isinstance(rtype, DecimalType):
            q = torch.sign(data) * torch.floor(
                torch.abs(data) * 10.0 ** rtype.scale + 0.5)
            return Column(rtype, i128.f64_to_i64_saturating(q), valid)
        if rtype is REAL:
            data = data.to(torch.float32)
        return Column(rtype, data, valid)
    return fn


def device_concat(parts: Sequence[Batch]) -> Batch:
    """Concatenate the live rows of batches on one device, merging string
    dictionaries, into the capacity bucket of the total. When a part was
    spilled to host memory and the total is over ``max_batch_rows``, the
    merge stays in host memory (the result is spilled, pinned when its
    parts are); a spilled part of a smaller merge moves to the device of
    the others first."""
    counts = [p.num_rows_host() for p in parts]
    total = sum(counts)
    spilled = pin = False
    if any(p.spilled for p in parts):
        on_device = [p.device for p in parts if not p.spilled]
        if total > CONFIG.max_batch_rows or not on_device:
            parts = [p if p.spilled else _to_host(p, n)
                     for p, n in zip(parts, counts)]
            spilled = True
            pin = any(next(iter(p.columns.values())).data.is_pinned()
                      for p in parts)
        else:
            parts = [p.to(on_device[0]) if p.spilled else p for p in parts]
    cap = capacity_for(max(total, 1), minimum=8)
    cols: Dict[str, Column] = {}
    for name in parts[0].names:
        cs = [p.column(name) for p in parts]
        first = cs[0]
        if is_nested(first.type):
            # ARRAY, MAP, ROW and digests: each part's pools packed to
            # its live rows, then one after another, offsets moved
            out = concat_rows(cs, counts, cap)
            cols[name] = _pin_column(out) if pin else out
            continue
        if isinstance(first.type, GeometryType) and \
                len({c.dictionary is None for c in cs}) > 1:
            # POINT parts among WKT-backed ones: all in the WKT form
            cs = [geo.as_wkt(c) for c in cs]
            first = cs[0]
        datas = [c.data[:n] for c, n in zip(cs, counts)]
        dic: Optional[StringDictionary] = first.dictionary
        if dic is not None and any(c.dictionary is not dic for c in cs):
            remapped = []
            for c, d in zip(cs, datas):
                dic, _, ro = dic.merge(c.dictionary)
                table = torch.from_numpy(np.asarray(ro, np.int32))
                remapped.append(take_clamped(table.to(d.device), d))
            datas = remapped
        valid = None
        if any(c.valid is not None for c in cs):
            valid = _cat_into([c.valid_mask()[:n]
                               for c, n in zip(cs, counts)], cap, pin)
        data2 = None
        if any(c.data2 is not None for c in cs):
            data2 = _cat_into([hi_lane_or_fill(c)[:n]
                               for c, n in zip(cs, counts)], cap, pin)
        elements = None
        if first.elements is not None:
            # sketch columns: the parts' entry lanes one after another,
            # each part's offsets moved past the lanes before it
            lanes = [c.elements.data for c in cs]
            base = np.cumsum([0] + [x.shape[0] for x in lanes[:-1]])
            datas = [d + int(o) for d, o in zip(datas, base)]
            elements = dc_replace(first.elements, data=torch.cat(lanes))
        cols[name] = Column(first.type, _cat_into(datas, cap, pin), valid,
                            dic, data2, elements)
    return Batch(cols, total, spilled=spilled)


def _cat_into(pieces: Sequence[torch.Tensor], cap: int,
              pin: bool = False) -> torch.Tensor:
    """Pieces copied one after another into a zeroed lane of ``cap``
    rows (one allocation, however many pieces)."""
    out = torch.zeros(cap, dtype=pieces[0].dtype, device=pieces[0].device,
                      pin_memory=pin)
    off = 0
    for p in pieces:
        out[off:off + p.shape[0]].copy_(p)
        off += p.shape[0]
    return out


# ---- host spill -----------------------------------------------------------

def _to_host(b: Batch, n: int) -> Batch:
    """The live prefix of ``b`` copied to host memory (the spill write),
    into pinned tensors when it comes from a card so that the way back is
    an asynchronous copy. A sketch column's entries are shared by its
    rows and copied whole; the pools of an ARRAY, MAP, ROW or digest
    column are packed to the live rows first."""
    pin = b.device.type == "cuda"

    def host(t, rows):
        if t is None:
            return None
        out = torch.empty(rows, dtype=t.dtype, pin_memory=pin)
        return out.copy_(t[:rows])

    def col(c: Column, rows: int) -> Column:
        return dc_replace(
            c, data=host(c.data, rows), valid=host(c.valid, rows),
            data2=host(c.data2, rows),
            elements=None if c.elements is None
            else col(c.elements, c.elements.capacity),
            elements2=None if c.elements2 is None
            else col(c.elements2, c.elements2.capacity),
            children=None if c.children is None
            else tuple(col(k, rows) for k in c.children))
    cols = {s: col(packed_rows(c, n) if is_nested(c.type) else c, n)
            for s, c in b.columns.items()}
    return Batch(cols, n, spilled=True)


def _pin_column(c: Column) -> Column:
    """A host column's lanes in pinned memory."""
    def pin(t):
        return None if t is None else t.pin_memory()
    return dc_replace(c, data=pin(c.data), valid=pin(c.valid),
                      data2=pin(c.data2),
                      elements=None if c.elements is None
                      else _pin_column(c.elements),
                      elements2=None if c.elements2 is None
                      else _pin_column(c.elements2),
                      children=None if c.children is None
                      else tuple(_pin_column(k) for k in c.children))
