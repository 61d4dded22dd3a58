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
  both sorts lead with the key lanes, so group ids stay aligned. So does
  approx_percentile, which takes the nearest-rank row of each group's
  sorted non-NULL values. min_by/max_by (argmin/argmax) take two passes:
  the extreme comparator, then the first row in the group-sorted order
  that attains it. The bitwise aggregates are a segmented scan by
  doubling over group-sorted rows (``_bit_reduce``). approx_set (hll)
  builds sparse sketches with one more sort (ops/hll.py); merge(hll)
  unions them on the host, as the JAX engine does.

Decimals over 18 digits carry a high lane; they group by both lanes,
and sum/min/max over them (or a sum of short decimals that could pass
2^63) run on Int128 lanes (``_int128_agg``): a sum splits each value into
three exact int64 addend lanes, min/max order by (high signed, low
unsigned).

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
from ..types import (BIGINT, DOUBLE, INTEGER, REAL, DecimalType,
                     HyperLogLogType, Type, is_string)
from . import cuda_groupby
from . import int128 as i128
from .compact import mask_to_gather
from .hashing import equality_lanes, to_signed_order
from .hll import (DEFAULT_BUCKET_BITS, entries_prefix, grouped_sparse_hll,
                  merge_sparse_host)
from .sort import lexsort

_F64 = torch.float64
_I64 = torch.int64


@dataclass(frozen=True)
class AggInput:
    """One aggregate over one input lane (or none, for count(*))."""
    kind: str          # sum | count | count_star | min | max | any_value
    #                    | bit_and | bit_or | count_distinct | argmin
    #                    | argmax | percentile | hll | hll_merge
    input: Optional[str] = None   # column name; None for count_star
    mask: Optional[str] = None    # FILTER / mask column (boolean), optional
    output: str = "agg"
    param: Optional[float] = None  # percentile fraction; hll bucket bits
    input2: Optional[str] = None   # comparator lane of argmin/argmax


# the kind that combines partial results of each kind (streaming
# aggregation: per-split partials, then one combine over them); the
# other kinds need all rows of a group at once
COMBINABLE_KINDS = {"sum": "sum", "count": "sum", "count_star": "sum",
                    "min": "min", "max": "max", "any_value": "any_value",
                    "bit_and": "bit_and", "bit_or": "bit_or"}

# largest packed key domain the packed path takes on (as in the JAX engine)
FAST_DOMAIN_LIMIT = 64

_BIT_KINDS = {"bit_and", "bit_or"}
_FAST_KINDS = {"sum", "count", "count_star", "min", "max",
               "any_value"} | _BIT_KINDS
# kinds of the general (lexsort) path and of global_aggregate
_GENERAL_KINDS = _FAST_KINDS | {"count_distinct", "argmin", "argmax",
                                "percentile", "hll", "hll_merge"}


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
            # the Int128 high lane takes part in key equality
            col_lanes = col_lanes + equality_lanes(col.data2)
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
    if agg.kind == "percentile":
        return _percentile(batch, agg, col, seg)
    if agg.kind in ("argmin", "argmax"):
        return _arg_extreme(batch, agg, col, mask, seg)
    valid = mask if col.valid is None else mask & col.valid[order]
    nvalid = seg.count(valid)
    if agg.kind == "count":
        return Column(BIGINT, nvalid, None)
    group_valid = nvalid > 0
    if agg.kind == "hll":
        return _hll(col.data[order], valid, seg.gid, seg.gcap, agg,
                    group_valid)
    if agg.kind == "hll_merge":
        return _hll_merge(col, col.data[order], col.data2[order], valid,
                          seg.gid, seg.gcap, group_valid)
    if _wide_decimal_agg(col, agg.kind):
        lo, hi = _int128_lanes(col, order)
        return _int128_agg(col, agg.kind, lo, hi, group_valid,
                           _segment_reducer(valid, seg))
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

    if agg.kind in _BIT_KINDS:
        work = torch.where(valid, vals.to(_I64), _bit_ident(agg.kind))
        return Column(BIGINT, _bit_reduce(work, seg.gid, seg.gcap, agg.kind,
                                          sorted_ids=True), group_valid)

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
    valid = _agg_row_mask(batch, agg, live)
    if col.valid is not None:
        valid = valid & col.valid
    eq = equality_lanes(col.data)
    if col.data2 is not None:
        eq = eq + equality_lanes(col.data2)
    vlanes = [torch.where(valid, u, 0) for u in eq]
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
    The key lanes are u64 patterns; the tie lanes sort in their own
    (signed or float) order. Group ids stay aligned with the primary
    sort of group_aggregate because both orders sort by the key lanes
    first. Returns (order2, gid2, key_changed, is_first)."""
    cap = live.shape[0]
    order2 = lexsort([to_signed_order(x) for x in key_lanes]
                     + list(tie_lanes))
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
    order2, gid2, changed_k, first = _resort(
        seg.key_lanes, [to_signed_order(x) for x in tie], seg.live,
        seg.gcap)
    newval = _changes(tie, order2, changed_k | first) & valid_u[order2]
    data = torch.zeros(seg.gcap, dtype=_I64, device=newval.device)
    return Column(BIGINT, data.index_add_(0, gid2, newval.to(_I64)), None)


def _order_lane(col: Column) -> torch.Tensor:
    """One lane whose order is the column's SQL order: collation ranks
    of a dictionary column, int32 of a bool lane, else the values."""
    d = col.data
    if is_string(col.type):
        ranks = torch.from_numpy(col.dictionary.rank_codes()).to(d.device)
        return take_clamped(ranks, d)
    if d.dtype == torch.bool:
        return d.to(torch.int32)
    return d


def _no_hi_lane(col: Column, kind: str) -> None:
    if col.data2 is not None:
        raise NotImplementedError(
            f"{kind} over DECIMAL(p>18) is not supported yet")


def _nearest_rank(q: Optional[float], n: torch.Tensor) -> torch.Tensor:
    """The nearest rank k = clip(floor(q (n - 1) + 0.5), 0, n - 1) of the
    q-th percentile among n sorted values (q defaults to 0.5)."""
    q = float(q if q is not None else 0.5)
    k = torch.floor(q * (n - 1).to(_F64) + 0.5).to(_I64)
    return torch.minimum(k.clamp(min=0), (n - 1).clamp(min=0))


def _percentile(batch: Batch, agg: AggInput, col: Column,
                seg: _Segments) -> Column:
    """approx_percentile, exact per group: re-sort by (keys, NULL last,
    value); each group's non-NULL values are then an ascending run at
    its start, and the nearest-rank row of the run is the result."""
    _no_hi_lane(col, "percentile")
    valid_u = _agg_row_mask(batch, agg, seg.live)
    if col.valid is not None:
        valid_u = valid_u & col.valid
    order2, gid2, _, _ = _resort(
        seg.key_lanes, [(~valid_u).to(_I64), _order_lane(col)], seg.live,
        seg.gcap)
    cap = order2.shape[0]
    pos = torch.arange(cap, dtype=_I64, device=order2.device)
    start = torch.full((seg.gcap,), cap, dtype=_I64,
                       device=pos.device).scatter_reduce_(
        0, gid2, torch.where(seg.live[order2], pos, cap), "amin")
    nvalid = torch.zeros(seg.gcap, dtype=_I64,
                         device=pos.device).index_add_(
        0, gid2, valid_u[order2].to(_I64))
    rows = take_clamped(order2, start + _nearest_rank(agg.param, nvalid))
    return replace(col.gather(rows), valid=nvalid > 0)


def _arg_extreme(batch: Batch, agg: AggInput, col: Column,
                 mask: torch.Tensor, seg: _Segments) -> Column:
    """min_by/max_by: the value at the first row, in the group-sorted
    order, whose comparator is the group's extreme; NULL and NaN
    comparators take no part. NULL when the group has no comparator."""
    order = seg.order
    comp = batch.column(agg.input2)
    _no_hi_lane(comp, agg.kind)
    cvalid = mask if comp.valid is None else mask & comp.valid[order]
    work, how, ident = _extreme_lane(comp, agg.kind)
    work = work[order]
    work = torch.where(cvalid & ~_isnan(work), work, ident)
    ext = seg.reduce(work, how, ident)
    cand = cvalid & (work == ext[seg.gid])
    cap = order.shape[0]
    pos = torch.arange(cap, dtype=_I64, device=order.device)
    first = seg.reduce(torch.where(cand, pos, cap), "amin", cap)
    out = col.gather(take_clamped(order, first))
    has = seg.count(cvalid) > 0
    return replace(out, valid=has if out.valid is None else has & out.valid)


def _extreme_lane(comp: Column, kind: str):
    """(order lane, reduction, identity) of an argmin/argmax comparator."""
    work = _order_lane(comp)
    lo = kind == "argmin"
    return (work, "amin" if lo else "amax",
            _identity("min" if lo else "max", work.dtype))


def _isnan(x: torch.Tensor) -> torch.Tensor:
    return torch.isnan(x) if x.is_floating_point() else \
        torch.zeros(x.shape, dtype=torch.bool, device=x.device)


def _hll(vals: torch.Tensor, valid: torch.Tensor, gid: torch.Tensor,
         gcap: int, agg: AggInput, group_valid: torch.Tensor) -> Column:
    """approx_set: one sparse sketch per group (ops/hll.py)."""
    b = int(agg.param) if agg.param else DEFAULT_BUCKET_BITS
    start, length, entries = grouped_sparse_hll(vals, valid, gid, gcap, b)
    return Column(HyperLogLogType(b), start, group_valid, None, length,
                  Column(INTEGER, entries))


def _hll_merge(col: Column, starts: torch.Tensor, lens: torch.Tensor,
               valid: torch.Tensor, gid: torch.Tensor, gcap: int,
               group_valid: torch.Tensor) -> Column:
    """merge(hll): the per-group max-union of sketch rows, on the host
    (ops/hll.py merge_sparse_host, as the JAX engine merges), put back
    on the query's device. Only the rows that take part, and the
    entries their spans reach, cross to the host."""
    b = col.type.bucket_bits
    dev = starts.device
    keep = torch.nonzero(valid).flatten()
    starts, lens = starts[keep], lens[keep]
    start, length, ent = merge_sparse_host(
        starts.cpu().numpy(), lens.cpu().numpy(),
        entries_prefix(starts, lens, col.elements.data, b),
        np.ones(keep.shape[0], dtype=bool), gid[keep].cpu().numpy(),
        gcap, b)
    ent = np.pad(ent, (0, capacity_for(max(ent.shape[0], 1))
                       - ent.shape[0]))
    return Column(HyperLogLogType(b), torch.from_numpy(start).to(dev),
                  group_valid, None, torch.from_numpy(length).to(dev),
                  Column(INTEGER, torch.from_numpy(ent).to(dev)))


def _bit_ident(kind: str) -> int:
    return -1 if kind == "bit_and" else 0


def _bit_reduce(work: torch.Tensor, gid: torch.Tensor, nseg: int,
                kind: str, sorted_ids: bool = False) -> torch.Tensor:
    """Per-group AND/OR of an int64 lane (the identity where a row does
    not count) over group ids in [0, nseg): a stable sort by group unless
    the ids are sorted already, then an inclusive segmented scan by
    doubling (log2(rows) steps of integer operations; a step combines a
    row with the one ``d`` before it when both lie in one group), read
    at each group's last row. Torch has no bitwise reduction."""
    op = torch.bitwise_and if kind == "bit_and" else torch.bitwise_or
    g = gid.to(_I64)
    if not sorted_ids:
        order = torch.sort(g, stable=True).indices
        g, work = g[order], work[order]
    n = work.shape[0]
    x = work
    d = 1
    while d < n:
        y = x.clone()
        y[d:] = torch.where(g[d:] == g[:-d], op(x[d:], x[:-d]), x[d:])
        x = y
        d *= 2
    pos = torch.arange(n, dtype=_I64, device=work.device)
    last = torch.full((nseg,), -1, dtype=_I64,
                      device=work.device).scatter_reduce_(
        0, g.clamp(0, nseg - 1), pos, "amax")
    return torch.where(last >= 0, x[last.clamp(min=0)], _bit_ident(kind))


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
        res = (_masked_agg(batch, agg, gmasks, nseg, packed)
               if id(agg) in rest_ids else kernel_res[agg.output])
        out_cols[agg.output] = res.gather(gidx_c)
    return Batch(out_cols, num_groups)


def _kernel_packed_aggs(batch: Batch, aggs: Sequence[AggInput],
                        packed: torch.Tensor, live: torch.Tensor,
                        nseg: int):
    """Route float sums and counts through ``grouped_sums``. Returns
    (results by output name as [nseg] Columns, remaining aggs, per-group
    live counts or None). The lanes are written straight into the
    kernel's one f64 [K, ld] buffer, a row each: a count lane from its 0/1
    mask, a sum lane from its values where its mask holds, else 0."""
    lanes: List = [live]    # a mask, or (mask, values) for a sum
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
            lanes.append(m)
            continue
        if agg.kind == "sum":
            col = batch.column(agg.input)
            if col.data2 is None and col.data.is_floating_point():
                m = _agg_row_mask(batch, agg, live)
                if col.valid is not None:
                    m = m & col.valid
                plans.append((agg, "sum", len(lanes), len(lanes) + 1,
                              col))
                lanes.append((m, col.data))
                lanes.append(m)
                continue
        rest.append(agg)
    if not plans:
        return {}, list(aggs), None

    cap = packed.shape[0]
    buf = torch.empty((len(lanes), cap + cap % 2), dtype=_F64,
                      device=packed.device)
    zero = torch.zeros((), dtype=_F64, device=packed.device)
    for row, lane in zip(buf[:, :cap], lanes):
        if isinstance(lane, tuple):
            torch.where(lane[0], lane[1].to(_F64), zero, out=row)
        else:
            row.copy_(lane)
    gid = torch.where(live, packed, nseg).to(torch.int32)
    outs = cuda_groupby.grouped_sums(gid, buf, nseg)
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
                nseg: int, packed: Optional[torch.Tensor] = None) -> Column:
    """One aggregate as nseg masked reductions -> [nseg] lanes;
    ``packed`` holds each row's group (None: one group)."""
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
    if _wide_decimal_agg(col, agg.kind):
        lo, hi = _int128_lanes(col)
        return _int128_agg(col, agg.kind, lo, hi, group_valid,
                           _masked_reducer(gmasks))
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
    if agg.kind in _BIT_KINDS:
        counted = gmasks[0]
        for g in gmasks[1:]:
            counted = counted | g
        gid = torch.zeros_like(vals, dtype=_I64) if packed is None \
            else packed
        work = torch.where(counted, vals.to(_I64), _bit_ident(agg.kind))
        return Column(BIGINT, _bit_reduce(work, gid, nseg, agg.kind,
                                          sorted_ids=packed is None),
                      group_valid)
    # any_value: first valid row per group
    cap = vals.shape[0]
    pos = torch.arange(cap, dtype=_I64, device=vals.device)
    firsts = torch.stack([torch.where(g, pos, cap).amin() for g in gmasks])
    return replace(col.gather(firsts), valid=group_valid)


def _wide_decimal_agg(col: Column, kind: str) -> bool:
    """True when the aggregate runs on Int128 lanes: sum/min/max of a
    long decimal, and a short-decimal sum that could pass 2^63 (the
    capacity is static, so capacity * 10^precision < 2^63 proves the
    int64 sum exact)."""
    if not isinstance(col.type, DecimalType):
        return False
    if col.data2 is not None:
        return kind in ("sum", "min", "max")
    return kind == "sum" and col.capacity * 10 ** col.type.precision \
        >= 2 ** 63


def _int128_lanes(col: Column, order: Optional[torch.Tensor] = None):
    """(lo, hi) of a decimal column; a short decimal sign-extends."""
    lo = col.data.to(_I64)
    hi = col.data2 if col.data2 is not None else i128.sign_extend(lo)
    if order is not None:
        lo, hi = lo[order], hi[order]
    return lo, hi


def _segment_reducer(valid: torch.Tensor, seg: "_Segments"):
    """reduce(lane, how, ident, match) over the sorted groups, over the
    rows where valid and, given match = (hi, per-group hi), where the
    row's hi equals its group's."""
    def reduce(lane, how, ident, match=None):
        m = valid
        if match is not None:
            m = m & (match[0] == match[1][seg.gid])
        if how == "sum":
            return torch.zeros(seg.gcap, dtype=_I64,
                               device=lane.device).index_add_(
                0, seg.gid, torch.where(m, lane, 0))
        return seg.reduce(torch.where(m, lane, ident), how, ident)
    return reduce


def _masked_reducer(gmasks: List[torch.Tensor]):
    """The same over one row mask per group."""
    def reduce(lane, how, ident, match=None):
        red = {"sum": torch.sum, "amin": torch.amin, "amax": torch.amax}[how]
        fill = 0 if how == "sum" else ident
        out = []
        for k, g in enumerate(gmasks):
            if match is not None:
                g = g & (match[0] == match[1][k])
            out.append(red(torch.where(g, lane, fill)))
        return torch.stack(out)
    return reduce


def _int128_agg(col: Column, kind: str, lo: torch.Tensor, hi: torch.Tensor,
                group_valid: torch.Tensor, reduce) -> Column:
    """sum/min/max over Int128 lanes. sum: value = w0 + w1*2^32 + hi*2^64
    with 0 <= w0, w1 < 2^32, three exact int64 sums (up to 2^31 rows a
    group), recombined with carries. min/max: the extreme high lane
    (signed), then the extreme low lane (unsigned, by the sign flip)
    among the rows holding it."""
    if kind == "sum":
        s0, s1, s2 = (reduce(w, "sum", 0) for w in i128.sum_lanes(lo, hi))
        slo, shi = i128.combine_sums(s0, s1, s2)
        return Column(_sum_type(col.type), slo, group_valid, data2=shi)
    how = "amin" if kind == "min" else "amax"
    ident = _identity(kind, _I64)
    mhi = reduce(hi, how, ident)
    mlo = to_signed_order(reduce(to_signed_order(lo), how, ident,
                                 (hi, mhi)))
    return Column(col.type, mlo, group_valid, data2=mhi)


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
        elif agg.kind in _ORDER_KINDS:
            out[agg.output] = _global_ordered(batch, agg, live)
        else:
            out[agg.output] = _masked_agg(batch, agg, [live], 1)
    return Batch(out, 1)


# the kinds global_aggregate computes from a whole-lane order or sketch
_ORDER_KINDS = {"argmin", "argmax", "percentile", "hll", "hll_merge"}


def _global_ordered(batch: Batch, agg: AggInput,
                    live: torch.Tensor) -> Column:
    """argmin/argmax, percentile, hll and hll_merge without GROUP BY."""
    valid = _agg_row_mask(batch, agg, live)
    col = batch.column(agg.input)
    if agg.kind in ("argmin", "argmax"):
        # the first row of the extreme comparator (torch.argmin/argmax
        # return the first of equal extremes, as jnp.argmin/argmax do)
        comp = batch.column(agg.input2)
        _no_hi_lane(comp, agg.kind)
        cvalid = valid if comp.valid is None else valid & comp.valid
        work, how, ident = _extreme_lane(comp, agg.kind)
        work = torch.where(cvalid & ~_isnan(work), work, ident)
        idx = torch.argmin(work) if how == "amin" else torch.argmax(work)
        out = col.gather(idx.reshape(1))
        has = cvalid.any().reshape(1)
        return replace(out, valid=has if out.valid is None
                       else has & out.valid)
    if col.valid is not None:
        valid = valid & col.valid
    n = valid.sum(dtype=_I64)
    has = (n > 0).reshape(1)
    if agg.kind == "percentile":
        _no_hi_lane(col, "percentile")
        order = lexsort([(~valid).to(_I64), _order_lane(col)])
        rows = take_clamped(order, _nearest_rank(agg.param, n).reshape(1))
        return replace(col.gather(rows), valid=has)
    gid = torch.zeros(batch.capacity, dtype=_I64, device=live.device)
    if agg.kind == "hll":
        return _hll(col.data, valid, gid, 1, agg, has)
    return _hll_merge(col, col.data, col.data2, valid, gid, 1, has)


def _global_count_distinct(batch: Batch, agg: AggInput,
                           live: torch.Tensor) -> Column:
    """count(DISTINCT) without GROUP BY: sort by value, count the
    changes among the counted rows."""
    valid, tie = _distinct_lanes(batch, agg, batch.column(agg.input), live)
    order = lexsort([to_signed_order(x) for x in tie])
    first = torch.arange(batch.capacity, device=live.device) == 0
    newval = _changes(tie[1:], order, first) & valid[order]
    return Column(BIGINT, newval.sum(dtype=_I64).reshape(1), None)
