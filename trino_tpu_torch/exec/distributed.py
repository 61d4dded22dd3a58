"""Distributed plan executor: SQL over the device mesh.

Counterpart of ``trino_tpu/exec/distributed.py``. A stage's tasks are
the shards of one process's mesh (parallel/mesh.py); exchanges are the
copies of parallel/spmd.py:

- table scans: splits round-robin onto shards (``shard_parts``)
- Filter / Project: per shard
- grouped aggregation: partial per shard, exchange by key hash, final
  (the PushPartialAggregationThroughExchange shape); a global one
  gathers the per-shard partials and combines them
- joins: REPLICATED (the build side copied to every shard, two-phase:
  per-shard output counts, then the expansion at the largest count's
  capacity) below ``BROADCAST_LIMIT`` or unless the plan forces
  PARTITIONED (both sides repartitioned on the join keys, then joined
  shard by shard); dynamic filtering prunes the probe first
- semi joins: the filtering source replicated, a mask per shard
- TopN / Limit: per shard, gather, final; Sort: a sampled range
  exchange and a sort per shard (``distributed_sort``); Window: hash
  repartition on the PARTITION BY keys; INTERSECT / EXCEPT: both sides
  repartitioned on every output column, dictionaries aligned first
- any other node gathers its sharded inputs to the home device and runs
  the single-device operator (``_exec_local``, the COORDINATOR_ONLY
  fallback), as the JAX package does.

At the root, a plan the stage fragmenter cuts runs stage by stage with
the collectives of stage/ici.py between stages (``_try_ici_stages``).
A shard's failure fails the query: nothing falls back to another path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..catalog import CatalogManager
from ..columnar import Batch, Column, empty_batch
from ..config import capacity_for
from ..ops import compact, join as join_ops, sort as sort_ops
from ..ops.groupby import COMBINABLE_KINDS, AggInput, global_aggregate
from ..parallel.mesh import (Mesh, ShardedBatch, fit_capacity, get_mesh,
                             normalize, shard_parts, unshard_batch)
from ..parallel.spmd import (distributed_group_aggregate, exchangeable,
                             range_dest_counts, repartition_by_hash,
                             repartition_by_range, repartition_dest_counts,
                             sample_range_splitters, shard_apply,
                             shard_apply2, shard_apply2s, shard_totals2,
                             shard_totals2s)
from ..plan.nodes import (AggregationNode, FilterNode, JoinClause, JoinNode,
                          LimitNode, OutputNode, PlanNode, ProjectNode,
                          SemiJoinNode, TableScanNode, TopNNode)
from ..planner.logical import SemiJoinMultiNode
from ..session import Session
from ..types import BOOLEAN
from .executor import (_PPOS, Executor, QueryError, _Pre, _hit,
                       _lower_aggregates, _null_extend, _pad_partial,
                       _single_row, _with_pos, device_concat,
                       join_verify_filter, setop_batches)
from .expr import EvalError, eval_expr, eval_predicate
from .scancache import col_bytes
from .streamjoin import check_interrupt
from .window import execute_window

Value = Union[Batch, ShardedBatch]

# below this estimated build-side row count a join build is broadcast
# (DetermineJoinDistributionType's size heuristic)
BROADCAST_LIMIT = 1 << 20
# a relation smaller than this is not worth sharding at all
MIN_SHARD_ROWS = 1 << 12

# aggregates whose ARRAY/MAP/sketch lanes the exchange does not move
_GATHERED_AGGS = ("array_agg", "map_agg", "histogram",
                  "approx_most_frequent", "map_union", "multimap_agg",
                  "numeric_histogram", "tdigest_agg", "qdigest_agg",
                  "approx_set", "merge")


class DistributedExecutor(Executor):
    """Executor whose intermediate values may be row-sharded across the
    mesh. Nodes without a distributed strategy gather to the home device
    and run the single-device implementation."""

    def __init__(self, catalogs: CatalogManager, session: Session,
                 mesh: Optional[Mesh] = None, collect_stats: bool = False,
                 device=None):
        mesh = mesh or get_mesh(device=device)
        super().__init__(catalogs, session, mesh.home, collect_stats)
        self.mesh = mesh
        # the stage DAG on the mesh (stage/ici.py): the ROOT execute
        # call tries it once; stage bodies then recurse through this
        # executor with RemoteSource leaves resolving in _ici_values
        self._ici_tried = False
        self._ici_values: Optional[Dict[int, Value]] = None
        # each sharded scan's live rows per shard, in scan order
        self.scan_shard_rows: List[List[int]] = []

    # -- helpers ---------------------------------------------------------
    def _host(self, v: Value) -> Batch:
        return unshard_batch(v) if isinstance(v, ShardedBatch) else v

    def execute_host(self, node: PlanNode) -> Batch:
        return self._host(self.execute(node))

    def execute(self, node: PlanNode):  # type: ignore[override]
        check_interrupt(self.session)
        if not self._ici_tried:
            # one attempt, at the root plan only: recursive execute
            # calls (stage bodies included) take the node path below
            self._ici_tried = True  # tt-lint: ignore[race-attr-write] an executor instance is owned by one query thread for its lifetime
            out = self._try_ici_stages(node)
            if out is not None:
                return out
        return self._run_node(node, self._dexec)

    def _value_rows_bytes(self, out) -> Tuple[list, int]:
        if isinstance(out, ShardedBatch):
            return ([s.num_rows for s in out.shards],
                    sum(col_bytes(c) for s in out.shards
                        for c in s.columns.values()))
        return super()._value_rows_bytes(out)

    def _dexec(self, node: PlanNode) -> Value:
        method = getattr(self, "_dexec_" + type(node).__name__, None)
        if method is None:
            return self._exec_local(node)
        try:
            out = method(node)
        except (EvalError, NotImplementedError) as e:
            raise QueryError(str(e)) from e
        if isinstance(out, Batch):
            if out.spilled:
                return out.to(self.device, non_blocking=True)
            self._check_device(out, type(node).__name__)
        return out

    def _try_ici_stages(self, plan: PlanNode) -> Optional[Batch]:
        """Route the plan through the stage DAG with collective
        exchanges (stage/ici.py) when the fragmenter admits it and the
        mesh has two shards or more; declined plans (None) keep the
        node-at-a-time path."""
        try:
            if not (bool(self.session.get("multistage_execution"))
                    and bool(self.session.get("ici_exchange"))):
                return None
        except KeyError:        # a foreign session without the knobs
            return None
        if self.mesh.size < 2:
            return None
        from ..stage.fragmenter import StageFragmenter
        dag = StageFragmenter(self.catalogs, self.session).fragment(plan)
        if dag is None:
            return None
        from ..stage.ici import IciStageExecution
        return IciStageExecution(self, dag).run()

    def _dexec_RemoteSourceNode(self, node) -> Value:
        """In-slice exchange: a stage body's RemoteSource resolves to
        the producer stage's value on the mesh. Outside an ICI stage run
        the node reads the exchange as on one device."""
        if self._ici_values is None:
            return self._exec_local(node)
        vals = [self._ici_values[int(fid)] for fid in node.fragment_ids]
        if len(vals) == 1:
            return vals[0]
        return device_concat([self._host(v) for v in vals])

    def _exec_local(self, node: PlanNode) -> Batch:
        """The single-device operator over gathered inputs: every plan
        child is executed here and handed over as a ``_Pre``, so sharded
        values never reach a single-device operator."""
        if node.sources and dataclasses.is_dataclass(node):
            updates = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, PlanNode):
                    updates[f.name] = _Pre(self.execute_host(v))
                elif isinstance(v, tuple) and v and all(
                        isinstance(x, PlanNode) for x in v):
                    updates[f.name] = tuple(
                        _Pre(self.execute_host(x)) for x in v)
            if updates:
                node = dc_replace(node, **updates)
        return Executor._execute_inner(self, node)

    def _local(self, node: PlanNode, **sources: Value) -> Batch:
        """``node`` on one device with the given (already executed)
        children."""
        return Executor._execute_inner(self, dc_replace(node, **{
            k: _Pre(self._host(v)) for k, v in sources.items()}))

    # -- leaves ----------------------------------------------------------
    def _dexec_TableScanNode(self, node: TableScanNode) -> Value:
        conn = self.catalogs.connector(node.handle.catalog)
        columns = sorted(set(node.assignments.values()))
        n = self.mesh.size
        splits = conn.get_splits(node.handle, n)
        est = (conn.table_row_count(node.handle)
               if hasattr(conn, "table_row_count") else 0) or 0
        if len(splits) == 1 and est < MIN_SHARD_ROWS:
            return self._exec_local(node)
        per_dev: List[list] = [[] for _ in range(n)]
        for i, s in enumerate(splits):
            per_dev[i % n].append(s)
        schema = {col: node.schema[sym]
                  for sym, col in node.assignments.items()}
        parts = []
        for d, dev in enumerate(self.mesh.devices):
            batches = [self._read_split(conn, s, columns, dev)
                       for s in per_dev[d]]
            if not batches:
                batches = [empty_batch(schema, dev)]
            parts.append(device_concat(batches) if len(batches) > 1
                         else batches[0])
        sb = shard_parts(parts, self.mesh)
        self.scan_shard_rows.append(sb.num_rows)
        # connector columns renamed to plan symbols
        return sb.map(lambda b: Batch(
            {sym: b.column(col) for sym, col in node.assignments.items()},
            b.num_rows))

    # -- per-shard pipeline segments ------------------------------------
    def _dexec_FilterNode(self, node: FilterNode) -> Value:
        src = self.execute(node.source)
        if not isinstance(src, ShardedBatch):
            return self._local(node, source=src)
        return shard_apply(src, lambda b: compact.filter_batch(
            b, eval_predicate(node.predicate, b)))

    def _dexec_ProjectNode(self, node: ProjectNode) -> Value:
        src = self.execute(node.source)
        if not isinstance(src, ShardedBatch):
            return self._local(node, source=src)
        return shard_apply(src, lambda b: Batch(
            {s: eval_expr(e, b) for s, e in node.assignments.items()},
            b.num_rows))

    def _dexec_OutputNode(self, node: OutputNode) -> Batch:
        src = self._host(self.execute(node.source))
        return Batch({s: src.column(s) for s in node.symbols},
                     src.num_rows)

    def _dexec_LimitNode(self, node: LimitNode) -> Batch:
        src = self.execute(node.source)
        if isinstance(src, ShardedBatch):
            # a per-shard pre-limit bounds the gather to n * count rows
            src = unshard_batch(shard_apply(
                src, lambda b: compact.limit_batch(b, node.count)))
        return compact.limit_batch(src, node.count)

    def _dexec_TopNNode(self, node: TopNNode) -> Batch:
        src = self.execute(node.source)
        keys = _sort_keys(node.keys)
        if isinstance(src, ShardedBatch):
            # per-shard partial TopN, gather, final TopN
            src = unshard_batch(shard_apply(
                src, lambda b: sort_ops.topn_batch(b, keys, node.count)))
        return sort_ops.topn_batch(src, keys, node.count)

    def _dexec_SortNode(self, node) -> Value:
        """Distributed sort (the distributed_sort session property): a
        sampled range exchange and a sort per shard; shard-major order is
        the global order."""
        src = self.execute(node.source)
        if not isinstance(src, ShardedBatch):
            return self._local(node, source=src)
        keys = _sort_keys(node.keys)
        distributable = (bool(self.session.get("distributed_sort"))
                         and src.n_shards > 1
                         and exchangeable(src)
                         and all(src.columns[k.column].data2 is None
                                 for k in keys)
                         and src.total_rows_host() >= MIN_SHARD_ROWS)
        if not distributable:
            return self._local(node, source=src)
        splitters = sample_range_splitters(src, keys)
        if splitters is None:  # an empty relation
            return self._local(node, source=src)
        counts = range_dest_counts(src, keys, splitters)
        cap = capacity_for(max(int(counts.max()), 1))
        rp = repartition_by_range(src, keys, splitters, out_cap=cap)
        return shard_apply(rp, lambda b: sort_ops.sort_batch(b, keys), cap)

    # -- window ----------------------------------------------------------
    def _dexec_WindowNode(self, node) -> Value:
        """Distributed window: hash repartition on the PARTITION BY keys,
        then the window per shard; every partition is wholly on one
        shard."""
        src = self.execute(node.source)
        if not isinstance(src, ShardedBatch):
            return self._local(node, source=src)
        pkeys = list(node.partition_by)
        distributable = (bool(pkeys) and src.n_shards > 1
                         and exchangeable(src, pkeys)
                         and src.total_rows_host() >= MIN_SHARD_ROWS)
        if not distributable:
            return self._local(node, source=src)
        counts = repartition_dest_counts(src, pkeys)
        cap = capacity_for(max(int(counts.max()), 1))
        rp = repartition_by_hash(src, pkeys, out_cap=cap)
        return shard_apply(rp, lambda b: fit_capacity(execute_window(b, node), cap),
                           cap)

    # -- set operations --------------------------------------------------
    def _dexec_SetOpNode(self, node) -> Value:
        """Distributed INTERSECT / EXCEPT: both sides on one dictionary
        per column, repartitioned on all output columns (equal rows
        co-locate), then the tag + group + filter per shard."""
        left = self.execute(node.left)
        right = self.execute(node.right)
        out_syms = list(node.schema)
        lb = _rename(left, node.left_map)
        rb = _rename(right, node.right_map)
        distributable = (
            isinstance(lb, ShardedBatch) and isinstance(rb, ShardedBatch)
            and lb.n_shards > 1 and exchangeable(lb)
            and exchangeable(rb)
            and all(c.data2 is None for v in (lb, rb)
                    for c in v.columns.values())
            and (lb.total_rows_host() + rb.total_rows_host()
                 >= MIN_SHARD_ROWS))
        if not distributable:
            return setop_batches(self._host(lb), self._host(rb), node.op,
                                 node.distinct, out_syms)
        lb, rb = _align_sharded_dicts(lb, rb, out_syms, out_syms)
        lcap = capacity_for(max(int(repartition_dest_counts(
            lb, out_syms).max()), 1))
        rcap = capacity_for(max(int(repartition_dest_counts(
            rb, out_syms).max()), 1))
        lrp = repartition_by_hash(lb, out_syms, out_cap=lcap)
        rrp = repartition_by_hash(rb, out_syms, out_cap=rcap)
        out_cap = capacity_for(lcap + rcap)
        return shard_apply2s(lrp, rrp, lambda a, b: fit_capacity(setop_batches(
            a, b, node.op, node.distinct, out_syms), out_cap), out_cap)

    # -- aggregation -----------------------------------------------------
    def _dexec_AggregationNode(self, node: AggregationNode) -> Value:
        src = self.execute(node.source)
        if not isinstance(src, ShardedBatch):
            return self._local(node, source=src)
        if any(a.kind in _GATHERED_AGGS for a in node.aggregates.values()):
            # ARRAY/MAP/sketch states do not cross the exchange: gather
            # to the home device and aggregate there
            return self._local(node, source=src)
        # lower avg and friends on every shard (the extra lanes are
        # elementwise, so they stay sharded)
        lowered = [_lower_aggregates(node.aggregates, b)
                   for b in src.shards]
        phys, post, _ = lowered[0]
        if any(extra for _, _, extra in lowered):
            src = ShardedBatch(normalize([
                Batch({**b.columns, **extra}, b.num_rows)
                for b, (_, _, extra) in zip(src.shards, lowered)]),
                src.mesh, src.per_shard_cap)
        if node.group_keys:
            if not exchangeable(src):
                return self._local(node, source=src)
            out = distributed_group_aggregate(src, list(node.group_keys),
                                              phys)
            if post:
                keep = set(node.group_keys) | set(node.aggregates)
                out = shard_apply(out, lambda b: _with_post(b, post, keep))
            return out
        # global aggregation: per-shard partials -> gather -> combine
        if not phys:
            return _single_row(self.device)
        if any(a.kind not in COMBINABLE_KINDS for a in phys):
            # non-decomposable kinds: gather the rows, aggregate exactly
            return self._local(node, source=src)
        partial = shard_apply(
            src, lambda b: _pad_partial(global_aggregate(b, phys)),
            out_cap=8)
        gathered = unshard_batch(partial)
        finals = [AggInput(COMBINABLE_KINDS[a.kind], a.output, None,
                           a.output) for a in phys]
        out = global_aggregate(gathered, finals)
        if post:
            out = _with_post(out, post, set(node.aggregates))
        return out

    # -- joins -----------------------------------------------------------
    def _dexec_JoinNode(self, node: JoinNode) -> Value:
        jt = node.join_type
        if jt == "right":
            # swap before executing the children, so each runs once
            return self._dexec_JoinNode(JoinNode(
                node.right, node.left, "left",
                tuple(JoinClause(c.right, c.left) for c in node.criteria),
                node.filter, node.distribution))
        left = self.execute(node.left)
        right = self.execute(node.right)
        if not isinstance(left, ShardedBatch) or jt == "full" \
                or not node.criteria or jt == "cross":
            # a probe on one device, or a rare shape: the local join
            return self._local(node, left=left, right=right)
        pkeys = [c.left for c in node.criteria]
        bkeys = [c.right for c in node.criteria]
        # hash-collision re-verification for inexact key lanes
        node = dc_replace(node, filter=join_verify_filter(
            left.columns, right.columns, pkeys, bkeys, node.filter))
        # dynamic filtering: the build side's keys prune probe rows
        # before any exchange
        probe = self._dynamic_filter_probe(left, right, pkeys, bkeys, jt)
        if (str(node.distribution or "").lower() == "partitioned"
                and isinstance(right, ShardedBatch)
                and jt in ("inner", "left")
                and exchangeable(probe) and exchangeable(right)):
            return self._partitioned_join(node, probe, right, pkeys, bkeys,
                                          jt)
        # REPLICATED distribution: the build side on every shard
        build = self._host(right)
        out_cap, pad_cap = self._join_caps(
            shard_totals2(probe, build, _phase1(pkeys, bkeys, jt,
                                                node.filter)),
            probe, jt, node.filter, len(probe.columns) + len(build.columns))
        out = shard_apply2(probe, build, lambda pb, bb: _shard_join(
            pb, bb, pkeys, bkeys, jt, node.filter, out_cap, pad_cap),
            out_cap + pad_cap)
        self.join_sizes.append((probe.total_rows_host(),
                                build.num_rows_host(),
                                out.total_rows_host()))
        return out

    def _join_caps(self, totals: List[int], probe: ShardedBatch, jt: str,
                   filt, width: int) -> Tuple[int, int]:
        """Per-shard output capacity from the phase-1 counts (and the
        outer padding of a residual LEFT join), reserved before the
        expansion."""
        out_cap = capacity_for(max(max(totals), 1))
        pad_cap = probe.per_shard_cap if (jt == "left"
                                          and filt is not None) else 0
        self._reserve((out_cap + pad_cap) * probe.n_shards, width,
                      "join output")
        return out_cap, pad_cap

    def _dynamic_filter_probe(self, probe: ShardedBatch, build: Value,
                              pkeys, bkeys, jt: str) -> ShardedBatch:
        """Prune the probe before the exchange with the build side's key
        domain (enable_dynamic_filtering): the exact set of up to 100,000
        integer keys, else the [min, max] range. INNER joins only (outer
        probe rows must survive); dictionary keys are skipped. With
        collect_stats the rows in and kept land in
        ``dynamic_filter_rows``."""
        if jt != "inner" or not bool(
                self.session.get("enable_dynamic_filtering")):
            return probe
        bounds = []
        for pk, bk in zip(pkeys, bkeys):
            pc = probe.columns[pk]
            bc = build.columns[bk]
            if pc.dictionary is not None or bc.dictionary is not None \
                    or bc.data2 is not None:
                continue
            vals = _live_key_values(build, bk)
            if vals.numel() == 0:
                bounds.append((pk, None, None, None, False))  # drop all
                continue
            exact = None
            if not vals.is_floating_point() and vals.dtype != torch.bool:
                uniq = torch.unique(vals)
                if uniq.numel() <= 100_000:
                    exact = uniq
            has_nan = bool(vals.is_floating_point()
                           and torch.isnan(vals).any())
            finite = vals[~torch.isnan(vals)] if has_nan else vals
            if finite.numel():
                mn, mx = finite.min(), finite.max()
            else:
                mn = mx = None
            bounds.append((pk, mn, mx, exact, has_nan))
        if not bounds:
            return probe

        def f(b: Batch) -> Batch:
            mask = b.row_valid()
            for pk, mn, mx, exact, has_nan in bounds:
                c = b.column(pk)
                d = c.data
                if exact is not None:
                    ex = exact.to(d.device)
                    pos = torch.searchsorted(ex, d.to(ex.dtype))
                    hit = ex[pos.clamp(0, ex.shape[0] - 1)] == d
                    m = hit & (pos < ex.shape[0])
                elif mn is None:
                    m = torch.zeros_like(mask)
                    if has_nan:
                        m = torch.isnan(d)
                else:
                    m = (d >= mn.to(d.device)) & (d <= mx.to(d.device))
                    if has_nan:
                        # engine equality treats all NaNs as equal, so a
                        # NaN probe can match a NaN build key
                        m = m | torch.isnan(d)
                if c.valid is not None:
                    m = m & c.valid     # NULL keys never match
                mask = mask & m
            return compact.filter_batch(b, mask)

        kept = shard_apply(probe, f, probe.per_shard_cap)
        if self.collect_stats:
            self.dynamic_filter_rows = (probe.total_rows_host(),
                                        kept.total_rows_host())
        return kept

    def _partitioned_join(self, node: JoinNode, probe: ShardedBatch,
                          build: ShardedBatch, pkeys, bkeys,
                          jt: str) -> Value:
        """Both inputs repartitioned by join-key hash (FIXED_HASH on both
        children), then joined shard by shard; exchange capacities come
        from the real per-destination counts."""
        build = _align_sharded_dicts(probe, build, pkeys, bkeys)[1]
        pcap = capacity_for(max(int(repartition_dest_counts(
            probe, pkeys).max()), 1))
        bcap = capacity_for(max(int(repartition_dest_counts(
            build, bkeys).max()), 1))
        probe = repartition_by_hash(probe, pkeys, out_cap=pcap)
        build = repartition_by_hash(build, bkeys, out_cap=bcap)
        out_cap, pad_cap = self._join_caps(
            shard_totals2s(probe, build, _phase1(pkeys, bkeys, jt,
                                                 node.filter)),
            probe, jt, node.filter, len(probe.columns) + len(build.columns))
        out = shard_apply2s(probe, build, lambda pb, bb: _shard_join(
            pb, bb, pkeys, bkeys, jt, node.filter, out_cap, pad_cap),
            out_cap + pad_cap)
        self.join_sizes.append((probe.total_rows_host(),
                                build.total_rows_host(),
                                out.total_rows_host()))
        return out

    def _dexec_SemiJoinNode(self, node: SemiJoinNode) -> Value:
        src = self.execute(node.source)
        filt = self.execute_host(node.filtering_source)
        if not isinstance(src, ShardedBatch):
            return self._local(node, source=src, filtering_source=filt)

        def f(b: Batch, fb: Batch) -> Batch:
            matched, key_null, build_null, nonempty = \
                join_ops.semi_join_mask(b, fb, [node.source_key],
                                        [node.filtering_key])
            valid = matched | ~nonempty | (~key_null & ~build_null)
            cols = dict(b.columns)
            cols[node.output] = Column(BOOLEAN, matched, valid)
            return Batch(cols, b.num_rows)

        return shard_apply2(src, filt, f, src.per_shard_cap)

    def _dexec_SemiJoinMultiNode(self, node: SemiJoinMultiNode) -> Value:
        src = self.execute(node.source)
        filt = self.execute_host(node.filtering_source)
        if not isinstance(src, ShardedBatch):
            return self._local(node, source=src, filtering_source=filt)
        skeys = list(node.source_keys)
        fkeys = list(node.filtering_keys)
        residual = (join_verify_filter(src.columns, filt.columns, skeys,
                                       fkeys, node.filter)
                    if skeys else node.filter)
        if residual is None and skeys:
            def f(b: Batch, fb: Batch) -> Batch:
                matched, _, _, _ = join_ops.semi_join_mask(b, fb, skeys,
                                                           fkeys)
                cols = dict(b.columns)
                cols[node.output] = Column(BOOLEAN, matched, None)
                return Batch(cols, b.num_rows)
            return shard_apply2(src, filt, f, src.per_shard_cap)

        def counts(pb: Batch, fb: Batch):
            if skeys:
                return join_ops.match_counts(pb, fb, skeys, fkeys)
            return join_ops.cross_counts(pb, fb)

        totals = shard_totals2(src, filt,
                               lambda pb, fb: counts(pb, fb)[1].sum())
        cand_cap = capacity_for(max(max(totals), 1))
        self._reserve(cand_cap * src.n_shards,
                      len(src.columns) + len(filt.columns) + 1,
                      "semi-join candidates")

        def phase2(pb: Batch, fb: Batch) -> Batch:
            probe2 = _with_pos(pb, _PPOS)
            start, count, order = counts(probe2, fb)
            cand = join_ops.expand_join(probe2, fb, start, count, order,
                                        cand_cap, "inner")
            live = cand.row_valid()
            if residual is not None:
                live = live & eval_predicate(residual, cand)
            cols = dict(pb.columns)
            cols[node.output] = Column(
                BOOLEAN, _hit(cand.column(_PPOS).data, live, pb.capacity),
                None)
            return Batch(cols, pb.num_rows)

        return shard_apply2(src, filt, phase2, src.per_shard_cap)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _sort_keys(keys) -> List[sort_ops.SortKey]:
    return [sort_ops.SortKey(k.symbol, k.ascending, k.nulls_first)
            for k in keys]


def _rename(v: Value, m: Dict[str, str]) -> Value:
    """A pure rename / subset of the columns (no device pass)."""
    if isinstance(v, ShardedBatch):
        return v.map(lambda b: Batch({o: b.column(i) for o, i in m.items()},
                                     b.num_rows))
    return Batch({o: v.column(i) for o, i in m.items()}, v.num_rows)


def _with_post(b: Batch, post, keep) -> Batch:
    cols = dict(b.columns)
    for sym, fn in post.items():
        cols[sym] = fn(b)
    return Batch({s: c for s, c in cols.items() if s in keep}, b.num_rows)


def _live_key_values(v: Value, key: str) -> torch.Tensor:
    """The non-NULL values of ``key`` over the live rows, on one device."""
    parts = v.shards if isinstance(v, ShardedBatch) else (v,)
    out = []
    for b in parts:
        c = b.column(key)
        m = b.row_valid()
        if c.valid is not None:
            m = m & c.valid
        out.append(c.data[m].to(parts[0].device))
    return torch.cat(out)


def _align_sharded_dicts(a: ShardedBatch, b: ShardedBatch, akeys, bkeys
                         ) -> Tuple[ShardedBatch, ShardedBatch]:
    """Put each key pair's string columns on ONE merged dictionary (the
    merge keeps ``a``'s codes; ``b``'s are remapped), so that a hash of
    codes co-locates equal strings."""
    remaps = {}
    adicts = {}
    for ak, bk in zip(akeys, bkeys):
        ac, bc = a.columns.get(ak), b.columns.get(bk)
        if ac is None or bc is None or ac.dictionary is None \
                or bc.dictionary is None or ac.dictionary is bc.dictionary:
            continue
        merged, _, ro = ac.dictionary.merge(bc.dictionary)
        remaps[bk] = (merged, ro)
        adicts[ak] = merged
    if not remaps:
        return a, b
    a = a.map(lambda s: Batch({k: (dc_replace(c, dictionary=adicts[k])
                                   if k in adicts else c)
                               for k, c in s.columns.items()}, s.num_rows))
    b = b.map(lambda s: Batch({k: (c.with_dictionary(*remaps[k])
                                   if k in remaps else c)
                               for k, c in s.columns.items()}, s.num_rows))
    return a, b


def _phase1(pkeys, bkeys, jt: str, filt):
    """Phase 1 of the two-phase join: one shard's output row count."""
    outer = jt == "left"

    def fn(pb: Batch, bb: Batch):
        _, count, _ = join_ops.match_counts(pb, bb, pkeys, bkeys)
        if outer and filt is None:
            count = torch.where(pb.row_valid(), count.clamp(min=1), 0)
        return count.sum()
    return fn


def _shard_join(pb: Batch, bb: Batch, pkeys, bkeys, jt: str, filt,
                out_cap: int, pad_cap: int) -> Batch:
    """One shard's join against its build side at the mesh-wide output
    capacity (phase 2): without a residual the expansion itself; with
    one, inner candidates carrying probe positions, the residual, and
    for LEFT the null-extended probe rows whose matches all failed."""
    outer = jt == "left"
    if filt is None:
        start, count, order = join_ops.match_counts(pb, bb, pkeys, bkeys)
        return join_ops.expand_join(pb, bb, start, count, order, out_cap,
                                    "left" if outer else "inner")
    probe2 = _with_pos(pb, _PPOS)
    start, count, order = join_ops.match_counts(probe2, bb, pkeys, bkeys)
    cand = join_ops.expand_join(probe2, bb, start, count, order, out_cap,
                                "inner")
    out = compact.filter_batch(cand, eval_predicate(filt, cand))
    body = Batch({s: c for s, c in out.columns.items() if s != _PPOS},
                 out.num_rows)
    if not outer:
        return body
    unmatched = pb.row_valid() & ~_hit(out.column(_PPOS).data,
                                       out.row_valid(), pb.capacity)
    pad = _null_extend(pb, bb, unmatched)
    return fit_capacity(device_concat([body, pad]), out_cap + pad_cap)
