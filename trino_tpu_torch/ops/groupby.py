"""Grouped aggregation over torch tensors — the packed small-domain path.

Counterpart of ``trino_tpu/ops/groupby.py``. When every GROUP BY key has a
small static domain (dictionary codes, booleans) the keys pack into one
int32 group id per row. Float sums and counts then go through the
``grouped_sums`` CUDA kernel (ops/cuda_groupby.py) in one pass over the
lanes; other kinds (min, max, any_value, integer sums) are per-group
masked reductions. The general lexsort/segment path is not ported yet.

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

_F64 = torch.float64
_I64 = torch.int64


@dataclass(frozen=True)
class AggInput:
    """One aggregate over one input lane (or none, for count(*))."""
    kind: str          # sum | count | count_star | min | max | any_value
    input: Optional[str] = None   # column name; None for count_star
    mask: Optional[str] = None    # FILTER / mask column (boolean), optional
    output: str = "agg"


# largest packed key domain the packed path takes on (as in the JAX engine)
FAST_DOMAIN_LIMIT = 64

_FAST_KINDS = {"sum", "count", "count_star", "min", "max", "any_value"}


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
    if out is None:
        raise NotImplementedError(
            "not yet ported: general GROUP BY path (keys without a small "
            f"static domain, or aggregates {[a.kind for a in aggs]})")
    return out


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
        if is_string(col.type):
            ranks = col.dictionary.rank_codes()
            code_by_rank = np.argsort(ranks).astype(np.int32)
            rvals = take_clamped(torch.from_numpy(ranks).to(vals.device),
                                 vals)
            ident = len(ranks) if agg.kind == "min" else -1
            best = torch.stack([red(torch.where(g, rvals, ident))
                                for g in gmasks])
            data = take_clamped(torch.from_numpy(code_by_rank)
                                .to(vals.device), best)
            return Column(col.type, data, group_valid, col.dictionary)
        as_bool = vals.dtype == torch.bool
        work = vals.to(torch.int32) if as_bool else vals
        ident = _identity(agg.kind, work.dtype)
        data = torch.stack([red(torch.where(g, work, ident))
                            for g in gmasks])
        if as_bool:
            data = data.to(torch.bool)
        return Column(col.type, data, group_valid)
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
        if agg.kind not in _FAST_KINDS:
            raise NotImplementedError(f"not yet ported: {agg.kind}")
        out[agg.output] = _masked_agg(batch, agg, [live], 1)
    return Batch(out, 1)
