"""Grouped aggregation over torch tensors.

Counterpart of ``trino_tpu/ops/groupby.py``, with its two paths:

- packed: when every GROUP BY key has a small static domain (dictionary
  codes, booleans) the keys pack into one int32 group id per row. Float
  sums and counts then go through the ``grouped_sums`` CUDA kernel
  (ops/cuda_groupby.py) in one pass over the lanes; other kinds (min,
  max, any_value, integer sums) are per-group masked reductions.
- general: a stable lexsort over exact equality lanes of the keys (u64
  patterns, sorted in their unsigned order by the sign flip of
  ops/hashing.py), group ids from key-change boundaries, then segment
  reductions. The groups come out in lexsort order, as in the JAX
  engine. Float sums reduce each group's run of sorted rows in a fixed
  order (``torch.segment_reduce``), never by floating-point atomics, so
  two runs give bit-identical sums; integer sums, counts, min and max
  may use any scatter. count(DISTINCT) re-sorts the rows by (keys,
  value) and counts the value changes inside each group (``_resort``);
  both sorts lead with the key lanes, so group ids stay aligned.

Aggregate null semantics as in SQL: sum/min/max over zero non-null
inputs are NULL; count is 0.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import Batch, Column, take_clamped
from ..config import capacity_for
from ..types import BIGINT, DOUBLE, REAL, DecimalType, Type, is_string
from . import cuda_groupby
from .compact import mask_to_gather
from .hashing import equality_lanes, to_signed_order
from .sort import lexsort

_F64 = torch.float64
_I64 = torch.int64


@dataclass(frozen=True)
class AggInput:
    """One aggregate over one input lane (or none, for count(*))."""
    kind: str          # sum | count | count_star | min | max | any_value
    #                    | count_distinct
    input: Optional[str] = None   # column name; None for count_star
    mask: Optional[str] = None    # FILTER / mask column (boolean), optional
    output: str = "agg"


# largest packed key domain the packed path takes on (as in the JAX engine)
FAST_DOMAIN_LIMIT = 64

_FAST_KINDS = {"sum", "count", "count_star", "min", "max", "any_value"}
# kinds of the general (lexsort) path and of global_aggregate
_GENERAL_KINDS = _FAST_KINDS | {"count_distinct"}


def _sum_type(t: Type) -> Type:
    if t.name in ("tinyint", "smallint", "integer", "bigint"):
        return BIGINT
    if isinstance(t, DecimalType):
        return DecimalType(38, t.scale)
    if t.name == "real":
        return REAL
    return DOUBLE


def _static_domain(col: Column) -> Optional[int]:
    """Statically known value domain [0, d): dictionary code range or
    bool. None when unknown."""
    if col.dictionary is not None:
        return len(col.dictionary)
    if col.data.dtype == torch.bool:
        return 2
    return None


def _agg_row_mask(batch: Batch, agg: AggInput,
                  live: torch.Tensor) -> torch.Tensor:
    m = live
    if agg.mask is not None:
        mcol = batch.column(agg.mask)
        m = m & mcol.data.to(torch.bool)
        if mcol.valid is not None:
            m = m & mcol.valid
    return m


def group_aggregate(batch: Batch, key_names: Sequence[str],
                    aggs: Sequence[AggInput],
                    groups_capacity: Optional[int] = None,
                    live: Optional[torch.Tensor] = None) -> Batch:
    """GROUP BY key_names with the given aggregates. ``live`` overrides
    the batch's prefix liveness with an explicit row mask (a fused
    upstream filter passes its mask instead of compacting). The output is
    capacity-padded with a device group count."""
    gcap = groups_capacity or batch.capacity
    out = _packed_group_aggregate(batch, key_names, aggs, gcap, live,
                                  clamp=groups_capacity is None)
    if out is not None:
        return out
    for agg in aggs:
        if agg.kind not in _GENERAL_KINDS:
            raise NotImplementedError(
                f"not yet ported: aggregate {agg.kind} in the general "
                "GROUP BY path")
    cap = batch.capacity
    dev = batch.device
    live = batch.row_valid() if live is None else live

    lanes = _key_lanes(batch, key_names, live)
    order = lexsort([to_signed_order(x) for x in lanes])
    live_s = live[order]
    # key-change boundaries over the sorted live prefix
    changed = _changes(lanes[1:], order,
                       torch.zeros(cap, dtype=torch.bool, device=dev))
    changed[0] = True
    boundary = changed & live_s
    gid = (torch.cumsum(boundary, 0) - 1).clamp(0, gcap - 1)
    num_groups = boundary.sum(dtype=_I64)
    # first sorted position of each group (the fixed-size nonzero)
    firsts, _ = mask_to_gather(boundary)
    if gcap <= cap:
        firsts = firsts[:gcap]
    else:
        firsts = torch.cat([firsts, torch.zeros(gcap - cap, dtype=_I64,
                                                device=dev)])
    grp_rows = take_clamped(order, firsts)
    seg = _Segments(order, gid, live_s, gcap, lanes, live)

    out_cols: Dict[str, Column] = {
        name: batch.column(name).gather(grp_rows) for name in key_names}
    for agg in aggs:
        out_cols[agg.output] = _segment_agg(batch, agg, seg)
    return Batch(out_cols, num_groups)


# u64 max as an int64 pattern: the key value of dead rows
_U64MAX = -1


def _key_lanes(batch: Batch, key_names: Sequence[str],
               live: torch.Tensor) -> List[torch.Tensor]:
    """Exact equality lanes (u64 patterns in int64), most significant
    first: liveness, then per key a NULL lane (when the column has one)
    and its value lanes. NULL is its own group value."""
    lanes: List[torch.Tensor] = [(~live).to(_I64)]
    for name in key_names:
        col = batch.column(name)
        col_lanes = equality_lanes(col.data)
        if col.data2 is not None:
            raise NotImplementedError(
                f"not yet ported: GROUP BY over {col.type}")
        if col.valid is not None:
            lanes.append((~col.valid).to(_I64))
            col_lanes = [torch.where(col.valid, u, 0) for u in col_lanes]
        lanes.extend(torch.where(live, u, _U64MAX) for u in col_lanes)
    return lanes


@dataclass
class _Segments:
    """The sorted row order and each sorted row's group id (nondecreasing,
    clamped into [0, gcap)); the key lanes and the unsorted liveness, for
    the aggregates that re-sort."""
    order: torch.Tensor
    gid: torch.Tensor
    live_s: torch.Tensor
    gcap: int
    key_lanes: List[torch.Tensor]
    live: torch.Tensor

    def count(self, mask: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.gcap, dtype=_I64, device=mask.device)
        return out.index_add_(0, self.gid, mask.to(_I64))

    def sum_float(self, vals: torch.Tensor) -> torch.Tensor:
        # each group's rows are one run of the sorted order: reduce the
        # runs in a fixed order, with no floating-point atomics
        lengths = torch.bincount(self.gid, minlength=self.gcap)
        return torch.segment_reduce(vals, "sum", lengths=lengths,
                                    unsafe=True)

    def reduce(self, vals: torch.Tensor, how: str, ident) -> torch.Tensor:
        out = torch.full((self.gcap,), ident, dtype=vals.dtype,
                         device=vals.device)
        return out.scatter_reduce_(0, self.gid, vals, how)


def _segment_agg(batch: Batch, agg: AggInput, seg: _Segments) -> Column:
    order = seg.order
    mask = seg.live_s
    if agg.mask is not None:
        mcol = batch.column(agg.mask)
        m = mcol.data.to(torch.bool)
        if mcol.valid is not None:
            m = m & mcol.valid
        mask = mask & m[order]
    if agg.kind == "count_star":
        return Column(BIGINT, seg.count(mask), None)

    col = batch.column(agg.input)
    if agg.kind == "count_distinct":
        return _count_distinct(batch, agg, col, seg)
    valid = mask if col.valid is None else mask & col.valid[order]
    nvalid = seg.count(valid)
    if agg.kind == "count":
        return Column(BIGINT, nvalid, None)
    group_valid = nvalid > 0
    if col.data2 is not None or (
            isinstance(col.type, DecimalType) and agg.kind == "sum"
            and col.capacity * 10 ** col.type.precision >= 2 ** 63):
        raise NotImplementedError(
            f"not yet ported: {agg.kind} over {col.type} (Int128)")
    vals = col.data[order]

    if agg.kind == "sum":
        if vals.is_floating_point():
            data = seg.sum_float(torch.where(valid, vals, 0.0))
        else:
            work = torch.where(valid, vals.to(_I64), 0)
            data = torch.zeros(seg.gcap, dtype=_I64,
                               device=vals.device).index_add_(
                0, seg.gid, work)
        return Column(_sum_type(col.type), data, group_valid)

    if agg.kind in ("min", "max"):
        how = "amin" if agg.kind == "min" else "amax"
        return _min_max(col, vals, agg.kind, group_valid,
                        lambda work, ident: seg.reduce(
                            torch.where(valid, work, ident), how, ident))

    # any_value: the first valid row of each group
    cap = order.shape[0]
    pos = torch.arange(cap, dtype=_I64, device=order.device)
    first = seg.reduce(torch.where(valid, pos, cap), "amin", cap)
    return replace(col.gather(take_clamped(order, first)),
                   valid=group_valid)


def _distinct_lanes(batch: Batch, agg: AggInput, col: Column,
                    live: torch.Tensor):
    """(valid, tie lanes) of count(DISTINCT): the rows that count (live,
    non-NULL, passing the mask), then a lane pushing the others last and
    the value's equality lanes (zero where not counted)."""
    if col.data2 is not None:
        raise NotImplementedError(
            f"not yet ported: count(DISTINCT) over {col.type} (Int128)")
    valid = _agg_row_mask(batch, agg, live)
    if col.valid is not None:
        valid = valid & col.valid
    vlanes = [torch.where(valid, u, 0) for u in equality_lanes(col.data)]
    return valid, [(~valid).to(_I64)] + vlanes


def _changes(lanes: Sequence[torch.Tensor], order: torch.Tensor,
             init: torch.Tensor) -> torch.Tensor:
    """``init`` or-ed with, per sorted row, whether any lane differs from
    the row before it."""
    changed = init
    for lane in lanes:
        s = lane[order]
        changed = changed | (s != torch.roll(s, 1))
    return changed


def _resort(key_lanes, tie_lanes, live: torch.Tensor, gcap: int):
    """Re-sort rows by (key lanes, tie lanes) and recompute group ids.
    Group ids stay aligned with the primary sort of group_aggregate
    because both orders sort by the key lanes first. Returns (order2,
    gid2, key_changed, is_first)."""
    cap = live.shape[0]
    full = list(key_lanes) + list(tie_lanes)
    order2 = lexsort([to_signed_order(x) for x in full])
    first = torch.arange(cap, device=live.device) == 0
    changed = _changes(key_lanes[1:], order2,
                       torch.zeros(cap, dtype=torch.bool,
                                   device=live.device))
    boundary2 = (changed | first) & live[order2]
    gid2 = (torch.cumsum(boundary2, 0) - 1).clamp(0, gcap - 1)
    return order2, gid2, changed, first


def _count_distinct(batch: Batch, agg: AggInput, col: Column,
                    seg: _Segments) -> Column:
    """Exact count(DISTINCT) per group: re-sort by (keys, value), then
    count the rows that start a new value inside their group."""
    valid_u, tie = _distinct_lanes(batch, agg, col, seg.live)
    order2, gid2, changed_k, first = _resort(seg.key_lanes, tie, seg.live,
                                             seg.gcap)
    newval = _changes(tie, order2, changed_k | first) & valid_u[order2]
    data = torch.zeros(seg.gcap, dtype=_I64, device=newval.device)
    return Column(BIGINT, data.index_add_(0, gid2, newval.to(_I64)), None)


def _packed_group_aggregate(batch: Batch, key_names: Sequence[str],
                            aggs: Sequence[AggInput], gcap: int,
                            live: Optional[torch.Tensor] = None,
                            clamp: bool = False) -> Optional[Batch]:
    """Small static domain GROUP BY: one packed int32 group id per row."""
    if not key_names:
        return None
    doms: List[int] = []
    kcols: List[Column] = []
    for name in key_names:
        c = batch.column(name)
        d = _static_domain(c)
        if d is None or c.data2 is not None:
            return None
        doms.append(d)
        kcols.append(c)
    nseg = 1
    for d in doms:
        nseg *= d + 1          # one extra slot per key for NULL
    if nseg > FAST_DOMAIN_LIMIT or nseg > gcap:
        return None
    if any(a.kind not in _FAST_KINDS for a in aggs):
        return None
    if clamp:
        # the packed domain bounds the group count: the output needs
        # nseg slots, not the input capacity
        gcap = min(gcap, capacity_for(nseg, minimum=1))

    dev = batch.device
    if live is None:
        live = batch.row_valid()
    packed = torch.zeros(batch.capacity, dtype=torch.int32, device=dev)
    for c, d in zip(kcols, doms):
        code = c.data.to(torch.int32).clamp(0, d - 1)
        if c.valid is not None:
            code = torch.where(c.valid, code, d)
        packed = packed * (d + 1) + code

    kernel_res, rest, counts = _kernel_packed_aggs(batch, aggs, packed,
                                                   live, nseg)
    gmasks = ([live & (packed == g) for g in range(nseg)]
              if (rest or counts is None) else [])
    if counts is None:
        counts = torch.stack([m.sum(dtype=_I64) for m in gmasks])

    exists = counts > 0
    num_groups = exists.sum(dtype=_I64)
    # group slots in order, padded by hand to gcap with nseg (the JAX
    # engine's fixed-size nonzero)
    order = torch.sort((~exists).to(torch.int8), stable=True).indices
    gidx = torch.full((gcap,), nseg, dtype=_I64, device=dev)
    take = min(gcap, nseg)
    slot = torch.arange(take, device=dev)
    gidx[:take] = torch.where(slot < num_groups, order[:take],
                              torch.full_like(order[:take], nseg))

    out_cols: Dict[str, Column] = {}
    rem = gidx
    for name, c, d in zip(reversed(key_names), reversed(kcols),
                          reversed(doms)):
        code = (rem % (d + 1)).to(torch.int32)
        rem = rem // (d + 1)
        is_null = code >= d
        data = code.clamp(0, d - 1)
        if c.data.dtype == torch.bool:
            data = data.to(torch.bool)
        valid = ~is_null if c.valid is not None else None
        out_cols[name] = Column(c.type, data, valid, c.dictionary)
    out_cols = {k: out_cols[k] for k in key_names}

    gidx_c = gidx.clamp(0, nseg - 1)
    rest_ids = {id(a) for a in rest}
    for agg in aggs:
        res = (_masked_agg(batch, agg, gmasks, nseg)
               if id(agg) in rest_ids else kernel_res[agg.output])
        out_cols[agg.output] = res.gather(gidx_c)
    return Batch(out_cols, num_groups)


def _kernel_packed_aggs(batch: Batch, aggs: Sequence[AggInput],
                        packed: torch.Tensor, live: torch.Tensor,
                        nseg: int):
    """Route float sums and counts through ``grouped_sums``. Returns
    (results by output name as [nseg] Columns, remaining aggs, per-group
    live counts or None)."""
    lanes: List[torch.Tensor] = [live.to(_F64)]
    plans = []          # (agg, kind, value_idx, count_idx, col)
    rest: List[AggInput] = []
    for agg in aggs:
        if agg.kind in ("count_star", "count"):
            m = _agg_row_mask(batch, agg, live)
            col = None
            if agg.kind == "count":
                col = batch.column(agg.input)
                if col.valid is not None:
                    m = m & col.valid
            plans.append((agg, "count", len(lanes), None, col))
            lanes.append(m.to(_F64))
            continue
        if agg.kind == "sum":
            col = batch.column(agg.input)
            if col.data2 is None and col.data.is_floating_point():
                m = _agg_row_mask(batch, agg, live)
                if col.valid is not None:
                    m = m & col.valid
                plans.append((agg, "sum", len(lanes), len(lanes) + 1,
                              col))
                lanes.append(torch.where(m, col.data.to(_F64), 0.0))
                lanes.append(m.to(_F64))
                continue
        rest.append(agg)
    if not plans:
        return {}, list(aggs), None

    gid = torch.where(live, packed, nseg).to(torch.int32)
    outs = cuda_groupby.grouped_sums(gid, lanes, nseg)
    counts = torch.round(outs[0]).to(_I64)
    results: Dict[str, Column] = {}
    for agg, kind, vi, ci, col in plans:
        if kind == "count":
            results[agg.output] = Column(
                BIGINT, torch.round(outs[vi]).to(_I64), None)
        else:
            nvalid = torch.round(outs[ci]).to(_I64)
            data = outs[vi]
            if col.data.dtype == torch.float32:
                data = data.to(torch.float32)
            results[agg.output] = Column(_sum_type(col.type), data,
                                         nvalid > 0)
    return results, rest, counts


def _identity(kind: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _min_max(col: Column, vals: torch.Tensor, kind: str,
             group_valid: torch.Tensor, reduce) -> Column:
    """MIN/MAX of ``vals`` by ``reduce(work, identity)`` per group. A
    dictionary column reduces its collation ranks (codes follow insertion
    order) and decodes the winning rank back to a code; a bool lane
    reduces as int32."""
    if is_string(col.type):
        ranks = col.dictionary.rank_codes()
        code_by_rank = np.argsort(ranks).astype(np.int32)
        rvals = take_clamped(torch.from_numpy(ranks).to(vals.device), vals)
        best = reduce(rvals, len(ranks) if kind == "min" else -1)
        data = take_clamped(torch.from_numpy(code_by_rank).to(vals.device),
                            best)
        return Column(col.type, data, group_valid, col.dictionary)
    as_bool = vals.dtype == torch.bool
    work = vals.to(torch.int32) if as_bool else vals
    data = reduce(work, _identity(kind, work.dtype))
    if as_bool:
        data = data.to(torch.bool)
    return Column(col.type, data, group_valid)


def _masked_agg(batch: Batch, agg: AggInput, gmasks: List[torch.Tensor],
                nseg: int) -> Column:
    """One aggregate as nseg masked reductions -> [nseg] lanes."""
    if agg.mask is not None:
        mcol = batch.column(agg.mask)
        m = mcol.data.to(torch.bool)
        if mcol.valid is not None:
            m = m & mcol.valid
        gmasks = [g & m for g in gmasks]
    if agg.kind == "count_star":
        return Column(BIGINT, torch.stack(
            [g.sum(dtype=_I64) for g in gmasks]), None)
    col = batch.column(agg.input)
    vals = col.data
    if col.valid is not None:
        gmasks = [g & col.valid for g in gmasks]
    nvalid = torch.stack([g.sum(dtype=_I64) for g in gmasks])
    if agg.kind == "count":
        return Column(BIGINT, nvalid, None)
    group_valid = nvalid > 0
    if isinstance(col.type, DecimalType) and (
            col.data2 is not None or agg.kind == "sum"):
        raise NotImplementedError(
            f"not yet ported: {agg.kind} over {col.type}")
    if agg.kind == "sum":
        acc = vals.to(_F64 if vals.is_floating_point() else _I64)
        data = torch.stack([torch.where(g, acc, torch.zeros_like(acc)).sum()
                            for g in gmasks])
        if vals.dtype == torch.float32:
            data = data.to(torch.float32)
        return Column(_sum_type(col.type), data, group_valid)
    if agg.kind in ("min", "max"):
        red = torch.amin if agg.kind == "min" else torch.amax
        return _min_max(col, vals, agg.kind, group_valid,
                        lambda work, ident: torch.stack(
                            [red(torch.where(g, work, ident))
                             for g in gmasks]))
    # any_value: first valid row per group
    cap = vals.shape[0]
    pos = torch.arange(cap, dtype=_I64, device=vals.device)
    firsts = torch.stack([torch.where(g, pos, cap).amin() for g in gmasks])
    return replace(col.gather(firsts), valid=group_valid)


def global_aggregate(batch: Batch, aggs: Sequence[AggInput],
                     live: Optional[torch.Tensor] = None) -> Batch:
    """Aggregation without GROUP BY: masked full reductions, one row.
    ``live`` as in group_aggregate."""
    live = batch.row_valid() if live is None else live
    out: Dict[str, Column] = {}
    for agg in aggs:
        if agg.kind not in _GENERAL_KINDS:
            raise NotImplementedError(f"not yet ported: {agg.kind}")
        if agg.kind == "count_distinct":
            out[agg.output] = _global_count_distinct(batch, agg, live)
        else:
            out[agg.output] = _masked_agg(batch, agg, [live], 1)
    return Batch(out, 1)


def _global_count_distinct(batch: Batch, agg: AggInput,
                           live: torch.Tensor) -> Column:
    """count(DISTINCT) without GROUP BY: sort by value, count the
    changes among the counted rows."""
    valid, tie = _distinct_lanes(batch, agg, batch.column(agg.input), live)
    order = lexsort([to_signed_order(x) for x in tie])
    first = torch.arange(batch.capacity, device=live.device) == 0
    newval = _changes(tie[1:], order, first) & valid[order]
    return Column(BIGINT, newval.sum(dtype=_I64).reshape(1), None)
