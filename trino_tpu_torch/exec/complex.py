"""ARRAY, MAP and ROW values, lambdas, and the quantile digests' accessors.

Counterpart of ``trino_tpu/exec/complex.py`` over torch tensors, on the
batch's device. The JAX engine evaluates these functions on the host in
numpy; here the structural work stays on the device:

- An ARRAY or MAP column is an offsets lane (``data``), a lengths lane
  (``data2``) and flat pools (``elements``, ``elements2``), as in
  columnar.py. Gathered or sliced columns share (and may overlap) their
  pools, so most functions first pack the live rows' elements in row
  order (``canonicalize``): offsets become the cumsum of the lengths, and
  ``owner[k]`` (the row of flat element k) is one ``repeat_interleave``
  with its ``output_size`` known. The only values a function reads back
  are a few scalars: an element count, a longest length, whether a
  raising condition holds.
- Per-row work is segment work over owners (``index_add_``,
  ``scatter_reduce_``), stable sorts over (owner, value) lanes and
  clamped gathers; no python loop runs over rows. ``reduce`` loops over
  element positions, vectorised across rows, as the reference does.
- A lambda (``rex.Lambda``) is evaluated by the ordinary ``eval_expr``
  over a Batch whose rows are the flat elements; a captured outer column
  is gathered by owner.
- The functions that make or split strings (``split``, ``regexp_split``,
  ``regexp_extract_all``, ``split_to_map``, ``split_to_multimap``,
  ``array_join``) run on the host once per dictionary value (once per
  distinct array for ``array_join``), as the port treats strings; their
  pools are uploaded to the batch's device.

Rows past ``num_rows`` are masked out of every expansion, so the dead
tail of a filtered batch costs no elements.
"""

from __future__ import annotations

import itertools
import re
from dataclasses import replace as dc_replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import (Batch, Column, StringDictionary, _pad,
                        hi_lane_or_fill, take_clamped, torch_dtype)
from ..ops import digest as dg
from ..ops.hashing import mix64
from ..ops.sort import lexsort
from ..rex import Call, Const, Lambda, input_names
from ..types import (BIGINT, BOOLEAN, DOUBLE, VARCHAR, MapType, QDigestType,
                     Type, is_integral, is_string)
from .expr import (EvalError, _DISPATCH, _codes_through, _table_column,
                   const_column, eval_expr)

_I64 = torch.int64


# ---- lanes and packing ----------------------------------------------------

def _valid(col: Column, n: int) -> torch.Tensor:
    if col.valid is None:
        return torch.ones(n, dtype=torch.bool, device=col.device)
    return col.valid[:n]


def _and_valid(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for m in masks:
        if m is not None:
            out = m if out is None else out & m
    return out


def _offsets(lens: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(lens, 0) - lens


def _expand(lens: torch.Tensor, total: int):
    """(owner, j) of ``total`` flat slots: the row of each slot and its
    position inside the row."""
    cap = lens.shape[0]
    dev = lens.device
    owner = torch.repeat_interleave(torch.arange(cap, device=dev), lens,
                                    output_size=total)
    j = torch.arange(total, device=dev) - _offsets(lens)[owner]
    return owner, j


def _total(lens: torch.Tensor) -> int:
    return int(lens.sum())


def _canon(col: Column, batch: Optional[Batch] = None,
           override: Optional[torch.Tensor] = None,
           cap: Optional[int] = None):
    """(canonical column, owner): the elements of the live, non-NULL rows
    packed in row order. ``override`` also zeroes rows an enclosing
    function has decided are NULL (two columns packed with the same
    override stay entry-aligned)."""
    cap = col.capacity if cap is None else cap
    valid = col.valid[:cap] if col.valid is not None else None
    keep = _and_valid(valid, override,
                      None if batch is None else batch.row_valid())
    lens = col.data2[:cap].to(_I64)
    if keep is not None:
        lens = torch.where(keep, lens, 0)
    total = _total(lens)
    owner, j = _expand(lens, total)
    src = col.data[:cap].to(_I64)[owner] + j
    out = Column(col.type, _offsets(lens), _and_valid(valid, override), None,
                 lens, col.elements.gather(src),
                 None if col.elements2 is None else col.elements2.gather(src))
    return out, owner


def canonicalize(col: Column, cap: Optional[int] = None) -> Column:
    return _canon(col, cap=cap)[0]


def _from_kept(typ: Type, pool: Column, keep: torch.Tensor,
               owner: torch.Tensor, cap: int, valid,
               pool2: Optional[Column] = None) -> Column:
    """An ARRAY/MAP column of the flat elements ``keep`` (ascending, so
    grouped by owner) of a canonical pool."""
    lens = torch.bincount(owner[keep], minlength=cap)[:cap].to(_I64)
    return Column(typ, _offsets(lens), valid, None, lens, pool.gather(keep),
                  None if pool2 is None else pool2.gather(keep))


def _any_by(mask: torch.Tensor, owner: torch.Tensor, cap: int
            ) -> torch.Tensor:
    out = torch.zeros(cap, dtype=_I64, device=owner.device)
    return out.index_add_(0, owner, mask.to(_I64)) > 0


def _pos(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I64, device=device)


def _rank_table(d: StringDictionary) -> np.ndarray:
    return d.derived("rank_codes", d.rank_codes)


def _order_lane(el: Column, n: int, probe: Optional[Column] = None):
    """A lane where == is value equality and < is SQL order (collation
    ranks for strings, int32 for booleans), and the probe column in the
    same space. Returns (lane, probe lane or None)."""
    data = el.data[:n]
    if is_string(el.type):
        if probe is not None and probe.dictionary is not None:
            merged, rk, rp = el.dictionary.merge(probe.dictionary)
            ranks = _rank_table(merged)
            return (_codes_through(Column(el.type, data, None, el.dictionary),
                                   ranks[rk]),
                    _codes_through(probe, ranks[rp]))
        lane = _codes_through(Column(el.type, data, None, el.dictionary),
                              _rank_table(el.dictionary))
        return lane, None if probe is None else probe.data
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    pl = None
    if probe is not None:
        pl = probe.data.to(torch.int32) if probe.data.dtype == torch.bool \
            else probe.data
    return data, pl


# ---- concatenation of flat pools -------------------------------------------

def concat_flat(cols: Sequence[Column]) -> Column:
    """Columns of one type one after another: string dictionaries merged,
    a nested pool's offsets moved past the pools before it, a ROW's
    fields concatenated field by field."""
    if len(cols) == 1:
        return cols[0]
    first = cols[0]
    datas = [c.data for c in cols]
    dic = first.dictionary
    if dic is not None and any(c.dictionary is not dic for c in cols):
        merged = dic
        remaps = []
        for c in cols:
            merged, _, ro = merged.merge(c.dictionary)
            remaps.append(ro)
        datas = [_codes_through(c, r) for c, r in zip(cols, remaps)]
        dic = merged
    elements = elements2 = None
    if first.elements is not None:
        base = 0
        moved = []
        for c, d in zip(cols, datas):
            moved.append(d.to(_I64) + base)
            base += c.elements.capacity
        datas = moved
        elements = concat_flat([c.elements for c in cols])
        if first.elements2 is not None:
            elements2 = concat_flat([c.elements2 for c in cols])
    valid = None
    if any(c.valid is not None for c in cols):
        valid = torch.cat([c.valid_mask() for c in cols])
    data2 = None
    if any(c.data2 is not None for c in cols):
        data2 = torch.cat([hi_lane_or_fill(c) for c in cols])
    children = None
    if first.children is not None:
        children = tuple(concat_flat([c.children[i] for c in cols])
                         for i in range(len(first.children)))
    dt = datas[0].dtype
    return Column(first.type, torch.cat([d.to(dt) for d in datas]), valid,
                  dic, data2, elements, elements2, children)


def prefix(c: Column, n: int) -> Column:
    """The first ``n`` rows of a column (pools shared)."""
    def cut(t):
        return None if t is None else t[:n]
    return dc_replace(c, data=cut(c.data), valid=cut(c.valid),
                      data2=cut(c.data2),
                      children=None if c.children is None
                      else tuple(prefix(k, n) for k in c.children))


def packed_rows(c: Column, n: int) -> Column:
    """The first ``n`` rows with their pools packed to what those rows
    reach (for a concatenation or a copy to the host)."""
    if c.elements is not None and c.data2 is not None \
            and not c.type.name == "hyperloglog":
        return canonicalize(c, n)
    out = prefix(c, n)
    if c.children is not None:
        out = dc_replace(out, children=tuple(packed_rows(k, n)
                                             for k in c.children))
    return out


def concat_rows(cols: Sequence[Column], counts: Sequence[int],
                cap: int) -> Column:
    """The live prefixes of nested columns, one after another, padded to
    ``cap`` rows: each part's pools packed, then concatenated with the
    offsets moved (the reference's ``concat_columns_host``, on the
    device)."""
    return _pad(concat_flat([packed_rows(c, n)
                             for c, n in zip(cols, counts)]), cap)


def _gather_multi(pools: Sequence[Column], src: torch.Tensor,
                  within: torch.Tensor) -> Column:
    """pools[src[i]][within[i]] for each output position i."""
    base = torch.tensor(np.cumsum([0] + [p.capacity for p in pools[:-1]]),
                        dtype=_I64, device=src.device)
    return concat_flat(list(pools)).gather(base[src] + within)


# ---- constructors and accessors ---------------------------------------------

def _eval(e, batch):
    return eval_expr(e, batch)


def _array_ctor(e: Call, batch: Batch) -> Column:
    """ARRAY[a, b, ...]: row r's elements at flat positions r*k .. r*k+k-1.
    Flat lanes interleave by a stack; nested elements (ARRAY, MAP, ROW)
    concatenate their pools and gather in the same order."""
    items = [_eval(a, batch) for a in e.args]
    cap = batch.capacity
    dev = batch.device
    k = len(items)
    first = items[0]
    if first.elements is not None or first.children is not None \
            or is_string(first.type):
        flat = concat_flat([prefix(it, cap) for it in items])
        pos = _pos(cap * k, dev)
        flat = flat.gather((pos % k) * cap + pos // k)
    else:
        dt = torch_dtype(e.type.element)
        data = torch.stack([it.data[:cap].to(dt) for it in items],
                           1).reshape(-1)
        valid = None
        if any(it.valid is not None for it in items):
            valid = torch.stack([_valid(it, cap) for it in items],
                                1).reshape(-1)
        d2 = None
        if any(it.data2 is not None for it in items):
            d2 = torch.stack([hi_lane_or_fill(it)[:cap] for it in items],
                             1).reshape(-1)
        flat = Column(e.type.element, data, valid, None, d2)
    return Column(e.type, _pos(cap, dev) * k, None, None,
                  torch.full((cap,), k, dtype=_I64, device=dev), flat)


def _map_ctor(e: Call, batch: Batch) -> Column:
    keys = _eval(e.args[0], batch)
    vals = _eval(e.args[1], batch)
    cap = batch.capacity
    # a row where either side is NULL is a NULL map; packing both pools
    # with the combined validity keeps them entry-aligned
    both = _and_valid(keys.valid, vals.valid)
    k, _ = _canon(keys, batch, both)
    v, _ = _canon(vals, batch, both)
    if bool((k.data2 != v.data2).any()):
        raise EvalError("map(): key and value arrays must have equal "
                        "lengths")
    return Column(e.type, k.data, both, None, k.data2, k.elements,
                  v.elements)


def _row_ctor(e: Call, batch: Batch) -> Column:
    items = tuple(_eval(a, batch) for a in e.args)
    return Column(e.type, torch.zeros(batch.capacity, dtype=torch.int8,
                                      device=batch.device), None,
                  children=items)


def _row_field(e: Call, batch: Batch) -> Column:
    row = _eval(e.args[0], batch)
    child = row.children[int(e.args[1].value)]
    if row.valid is not None:
        child = dc_replace(child, valid=_and_valid(child.valid, row.valid))
    return child


def _array_element_at(e: Call, batch: Batch) -> Column:
    """element_at(array, i) / a[i]: 1-based, negative from the end, NULL
    out of range."""
    a = _eval(e.args[0], batch)
    i = _eval(e.args[1], batch)
    if a.elements is None:
        raise EvalError("element_at requires an array")
    idx = i.data.to(_I64)
    length = a.data2.to(_I64)
    pos = torch.where(idx < 0, length + idx, idx - 1)
    inrange = (pos >= 0) & (pos < length)
    flat = a.data.to(_I64) + torch.minimum(
        pos.clamp(min=0), (length - 1).clamp(min=0))
    out = a.elements.gather(flat)
    return dc_replace(out, valid=_and_valid(inrange, a.valid, i.valid,
                                            out.valid))


def _element_at(e: Call, batch: Batch) -> Column:
    if isinstance(e.args[0].type, MapType):
        return _map_element_at(e, batch)
    return _array_element_at(e, batch)


def _map_element_at(e: Call, batch: Batch) -> Column:
    """element_at(map, key) / m[key]: NULL when absent; the last match
    wins (duplicate keys keep the later entry)."""
    m = _eval(e.args[0], batch)
    probe = _eval(e.args[1], batch)
    cap = batch.capacity
    canon, owner = _canon(m, batch)
    keys = canon.elements
    total = owner.shape[0]
    if is_string(keys.type):
        merged, rk, rp = keys.dictionary.merge(probe.dictionary)
        kl = _codes_through(keys, rk)
        pl = _codes_through(probe, rp)
    else:
        kl, pl = keys.data, probe.data
    match = (kl == pl[owner]) & _valid(keys, total)
    found = torch.full((cap,), -1, dtype=_I64, device=batch.device)
    found = found.scatter_reduce_(0, owner,
                                  torch.where(match, _pos(total, owner.device),
                                              -1), "amax")
    ok = found >= 0
    out = canon.elements2.gather(found.clamp(min=0))
    return dc_replace(out, valid=_and_valid(ok, m.valid, probe.valid,
                                            out.valid))


def _map_keys(e: Call, batch: Batch) -> Column:
    m = _eval(e.args[0], batch)
    return Column(e.type, m.data, m.valid, None, m.data2, m.elements)


def _map_values(e: Call, batch: Batch) -> Column:
    m = _eval(e.args[0], batch)
    return Column(e.type, m.data, m.valid, None, m.data2, m.elements2)


def _map_entries(e: Call, batch: Batch) -> Column:
    canon, owner = _canon(_eval(e.args[0], batch), batch)
    total = owner.shape[0]
    row_el = Column(e.type.element,
                    torch.zeros(total, dtype=torch.int8, device=owner.device),
                    None, children=(canon.elements, canon.elements2))
    return Column(e.type, canon.data, canon.valid, None, canon.data2, row_el)


def _key_codes(cols: Sequence[Column], totals: Sequence[int]):
    """One comparable key lane per pool: merged dictionary codes for
    strings, the values otherwise."""
    if any(is_string(k.type) for k in cols):
        merged = cols[0].dictionary
        remaps = []
        for k in cols:
            merged, _, ro = merged.merge(k.dictionary)
            remaps.append(ro)
        return [_codes_through(k, r)[:t].to(_I64)
                for k, r, t in zip(cols, remaps, totals)]
    return [k.data[:t] for k, t in zip(cols, totals)]


def _map_concat(e: Call, batch: Batch) -> Column:
    """map_concat(m1, m2, ...): the union; a later map wins on a
    duplicate key. Entries come out key-ordered per row."""
    cap = batch.capacity
    packed = [_canon(_eval(a, batch), batch) for a in e.args]
    maps = [p[0] for p in packed]
    owners = [p[1] for p in packed]
    totals = [o.shape[0] for o in owners]
    dev = batch.device
    owner = torch.cat(owners)
    src = torch.cat([torch.full((t,), i, dtype=_I64, device=dev)
                     for i, t in enumerate(totals)])
    within = torch.cat([_pos(t, dev) for t in totals])
    klanes = _key_codes([m.elements for m in maps], totals)
    dt = torch.promote_types(klanes[0].dtype, klanes[-1].dtype)
    key = torch.cat([k.to(dt) for k in klanes])
    order = lexsort([owner, key, src, within])
    so, sk = owner[order], key[order]
    is_last = torch.ones_like(so, dtype=torch.bool)
    if so.shape[0] > 1:
        is_last[:-1] = (so[1:] != so[:-1]) | (sk[1:] != sk[:-1])
    keep = order[is_last]
    lens = torch.bincount(owner[keep], minlength=cap)[:cap].to(_I64)
    out_k = _gather_multi([m.elements for m in maps], src[keep],
                          within[keep])
    out_v = _gather_multi([m.elements2 for m in maps], src[keep],
                          within[keep])
    return Column(e.type, _offsets(lens),
                  _and_valid(*[m.valid for m in maps]), None, lens, out_k,
                  out_v)


# ---- array scalar functions --------------------------------------------------

def _probe_match(e: Call, batch: Batch):
    arr = _eval(e.args[0], batch)
    probe = _eval(e.args[1], batch)
    canon, owner = _canon(arr, batch)
    total = owner.shape[0]
    lane, pl = _order_lane(canon.elements, total, probe)
    match = (lane == pl[owner]) & _valid(canon.elements, total)
    return arr, probe, canon, owner, match


def _contains(e: Call, batch: Batch) -> Column:
    arr, probe, _, owner, match = _probe_match(e, batch)
    return Column(BOOLEAN, _any_by(match, owner, batch.capacity),
                  _and_valid(arr.valid, probe.valid))


def _array_position(e: Call, batch: Batch) -> Column:
    arr, probe, canon, owner, match = _probe_match(e, batch)
    cap = batch.capacity
    total = owner.shape[0]
    big = torch.iinfo(_I64).max
    first = torch.full((cap,), big, dtype=_I64, device=owner.device)
    first = first.scatter_reduce_(0, owner, torch.where(
        match, _pos(total, owner.device), big), "amin")
    pos = torch.where(first < big, first - canon.data + 1, 0)
    return Column(BIGINT, pos, _and_valid(arr.valid, probe.valid))


def _array_remove(e: Call, batch: Batch) -> Column:
    arr, probe, canon, owner, match = _probe_match(e, batch)
    # a NULL probe or a NULL element drops nothing
    drop = match & _valid(probe, batch.capacity)[owner]
    keep = torch.nonzero(~drop).flatten()
    return _from_kept(e.type, canon.elements, keep, owner, batch.capacity,
                      arr.valid)


def _array_minmax(kind: str):
    def f(e: Call, batch: Batch) -> Column:
        arr = _eval(e.args[0], batch)
        cap = batch.capacity
        canon, owner = _canon(arr, batch)
        total = owner.shape[0]
        el = canon.elements
        lane, _ = _order_lane(el, total)
        evalid = _valid(el, total)
        # a NULL element makes the result NULL (reference array_min/max)
        has_null = _any_by(~evalid, owner, cap)
        if lane.is_floating_point():
            sent = float("inf") if kind == "min" else float("-inf")
        else:
            info = torch.iinfo(lane.dtype)
            sent = info.max if kind == "min" else info.min
        best = torch.full((cap,), sent, dtype=lane.dtype, device=lane.device)
        best = best.scatter_reduce_(0, owner, torch.where(evalid, lane, sent),
                                    "amin" if kind == "min" else "amax")
        valid = _and_valid(arr.valid, canon.data2 > 0, ~has_null)
        if is_string(el.type):
            code_by_rank = np.argsort(_rank_table(el.dictionary)) \
                .astype(np.int32)
            data = take_clamped(torch.from_numpy(code_by_rank)
                                .to(lane.device), best)
            return Column(el.type, data, valid, el.dictionary)
        return Column(el.type, best.to(el.data.dtype), valid)
    return f


def _value_key(el: Column, n: int):
    """(NULL flag lane, value lane) that group equal elements together,
    NULLs as one value."""
    lane, _ = _order_lane(el, n)
    ev = _valid(el, n)
    return (~ev).to(torch.int8), torch.where(ev, lane, torch.zeros_like(lane))


def _array_distinct(e: Call, batch: Batch) -> Column:
    arr = _eval(e.args[0], batch)
    cap = batch.capacity
    canon, owner = _canon(arr, batch)
    total = owner.shape[0]
    nl, vk = _value_key(canon.elements, total)
    # the first occurrence of each (owner, value) in its original order
    order = lexsort([owner, nl, vk, _pos(total, owner.device)])
    first = torch.ones(total, dtype=torch.bool, device=owner.device)
    if total > 1:
        so, sn, sv = owner[order], nl[order], vk[order]
        first[1:] = (so[1:] != so[:-1]) | (sn[1:] != sn[:-1]) \
            | (sv[1:] != sv[:-1])
    keep = torch.sort(order[first]).values
    return _from_kept(e.type, canon.elements, keep, owner, cap, arr.valid)


def _array_sort(e: Call, batch: Batch) -> Column:
    """Ascending, NULLs last: one stable sort on (owner, NULL, value)."""
    canon, owner = _canon(_eval(e.args[0], batch), batch)
    total = owner.shape[0]
    el = canon.elements
    lane, _ = _order_lane(el, total)
    order = lexsort([owner, (~_valid(el, total)).to(torch.int8), lane])
    return dc_replace(canon, type=e.type, elements=el.gather(order))


def _slice(e: Call, batch: Batch) -> Column:
    arr = _eval(e.args[0], batch)
    start = _eval(e.args[1], batch)
    length = _eval(e.args[2], batch)
    cap = batch.capacity
    canon, _ = _canon(arr, batch)
    lens = canon.data2
    s = start.data[:cap].to(_I64)
    ln = length.data[:cap].to(_I64).clamp(min=0)
    begin = torch.where(s > 0, s - 1, lens + s)          # 1-based / from end
    begin_c = torch.minimum(begin.clamp(min=0), lens)
    new_lens = torch.minimum(ln, lens - begin_c).clamp(min=0)
    new_lens = torch.where((s == 0) | (begin < 0) | (begin >= lens), 0,
                           new_lens)
    owner, j = _expand(new_lens, _total(new_lens))
    src = canon.data[owner] + begin_c[owner] + j
    return Column(e.type, _offsets(new_lens),
                  _and_valid(arr.valid, start.valid, length.valid), None,
                  new_lens, canon.elements.gather(src))


def _repeat(e: Call, batch: Batch) -> Column:
    val = _eval(e.args[0], batch)
    cnt = _eval(e.args[1], batch)
    n = torch.where(batch.row_valid(),
                    cnt.data[:batch.capacity].to(_I64).clamp(min=0), 0)
    owner, _ = _expand(n, _total(n))
    return Column(e.type, _offsets(n), cnt.valid, None, n, val.gather(owner))


def _sequence(e: Call, batch: Batch) -> Column:
    lo = _eval(e.args[0], batch)
    hi = _eval(e.args[1], batch)
    cap = batch.capacity
    dev = batch.device
    valid = _valid(lo, cap) & _valid(hi, cap)
    if len(e.args) > 2:
        stepc = _eval(e.args[2], batch)
        step = stepc.data[:cap].to(_I64)
        valid = valid & _valid(stepc, cap)
    else:
        step = torch.ones(cap, dtype=_I64, device=dev)
    a = lo.data[:cap].to(_I64)
    b = hi.data[:cap].to(_I64)
    live = batch.row_valid()
    if bool(((step == 0) & valid & live).any()):
        raise EvalError("sequence step must not be zero")
    safe = torch.where(step == 0, 1, step)
    lens = (torch.div(b - a, safe, rounding_mode="floor") + 1).clamp(min=0)
    lens = torch.where(valid & live, lens, 0)
    owner, j = _expand(lens, _total(lens))
    flat = (a[owner] + j * safe[owner]).to(torch_dtype(e.type.element))
    return Column(e.type, _offsets(lens), valid, None, lens,
                  Column(e.type.element, flat, None))


def _flatten(e: Call, batch: Batch) -> Column:
    """flatten(array(array(E))) -> array(E)."""
    arr = _eval(e.args[0], batch)
    cap = batch.capacity
    canon, owner = _canon(arr, batch)
    inner = canon.elements
    total = owner.shape[0]
    ilens = torch.where(_valid(inner, total), inner.data2[:total].to(_I64), 0)
    out_lens = torch.zeros(cap, dtype=_I64, device=owner.device) \
        .index_add_(0, owner, ilens)
    rep, j = _expand(ilens, _total(ilens))
    src = inner.data[:total].to(_I64)[rep] + j
    return Column(e.type, _offsets(out_lens), arr.valid, None, out_lens,
                  inner.elements.gather(src))


def _two_pools(e: Call, batch: Batch):
    """Two arrays' canonical pools side by side: (arrays, canons, owner,
    source, position within its pool, NULL lane, key lane)."""
    a1 = _eval(e.args[0], batch)
    a2 = _eval(e.args[1], batch)
    (c1, o1), (c2, o2) = _canon(a1, batch), _canon(a2, batch)
    t1, t2 = o1.shape[0], o2.shape[0]
    dev = batch.device
    both = concat_flat([c1.elements, c2.elements])
    nl, lk = _value_key(both, t1 + t2)
    src = torch.cat([torch.zeros(t1, dtype=_I64, device=dev),
                     torch.ones(t2, dtype=_I64, device=dev)])
    within = torch.cat([_pos(t1, dev), _pos(t2, dev)])
    return (a1, a2), (c1, c2), torch.cat([o1, o2]), src, within, nl, lk


def _array_setop(kind: str):
    """array_union / array_intersect / array_except: sort the two pools'
    (owner, value, source) entries, find each row's distinct values and
    which sources hold them, keep the values the set operation allows,
    in value order, as their first entry."""
    def f(e: Call, batch: Batch) -> Column:
        (a1, a2), (c1, c2), owner, src, within, nl, lk = _two_pools(e, batch)
        cap = batch.capacity
        total = owner.shape[0]
        order = lexsort([owner, nl, lk, src, within])
        so, sn, sk = owner[order], nl[order], lk[order]
        is_first = torch.ones(total, dtype=torch.bool, device=owner.device)
        if total > 1:
            is_first[1:] = (so[1:] != so[:-1]) | (sn[1:] != sn[:-1]) \
                | (sk[1:] != sk[:-1])
        gid = torch.cumsum(is_first.to(_I64), 0) - 1
        ngroups = max(total, 1)
        ss = src[order]
        pres = [_any_by(ss == s, gid, ngroups) for s in (0, 1)]
        if kind == "union":
            keep_grp = torch.ones(ngroups, dtype=torch.bool,
                                  device=owner.device)
        elif kind == "intersect":
            keep_grp = pres[0] & pres[1]
        else:
            keep_grp = pres[0] & ~pres[1]
        rep = order[is_first]
        rep_keep = rep[keep_grp[gid[is_first]]]
        lens = torch.bincount(owner[rep_keep], minlength=cap)[:cap].to(_I64)
        el = _gather_multi([c1.elements, c2.elements], src[rep_keep],
                           within[rep_keep])
        return Column(e.type, _offsets(lens), _and_valid(a1.valid, a2.valid),
                      None, lens, el)
    return f


def _arrays_overlap(e: Call, batch: Batch) -> Column:
    arr_t = e.args[0].type
    inter = _array_setop("intersect")(Call("array_intersect", e.args, arr_t),
                                      batch)
    return Column(BOOLEAN, inter.data2 > 0, inter.valid)


# ---- higher-order functions ------------------------------------------------

def _element_batch(params: Dict[str, Column], body, outer: Batch,
                   owner: torch.Tensor) -> Batch:
    """A Batch over flat elements: lambda parameters bind the pools, a
    captured outer column is gathered by each element's owner."""
    cols = dict(params)
    for name in input_names(body) - set(params):
        if name in outer.columns:
            cols[name] = outer.columns[name].gather(owner)
    return Batch(cols, owner.shape[0])


def _lambda_over(lam: Lambda, pools: Sequence[Column], batch: Batch,
                 owner: torch.Tensor) -> Column:
    return _eval(lam.body, _element_batch(dict(zip(lam.params, pools)),
                                          lam.body, batch, owner))


def _true(c: Column, n: int) -> torch.Tensor:
    m = c.data[:n].to(torch.bool)
    return m if c.valid is None else m & c.valid[:n]


def _transform(e: Call, batch: Batch) -> Column:
    canon, owner = _canon(_eval(e.args[0], batch), batch)
    out = _lambda_over(e.args[1], [canon.elements], batch, owner)
    return Column(e.type, canon.data, canon.valid, None, canon.data2, out)


def _filter_arr(e: Call, batch: Batch) -> Column:
    canon, owner = _canon(_eval(e.args[0], batch), batch)
    pred = _lambda_over(e.args[1], [canon.elements], batch, owner)
    keep = torch.nonzero(_true(pred, owner.shape[0])).flatten()
    return _from_kept(e.type, canon.elements, keep, owner, batch.capacity,
                      canon.valid)


def _match(kind: str):
    def f(e: Call, batch: Batch) -> Column:
        arr = _eval(e.args[0], batch)
        cap = batch.capacity
        canon, owner = _canon(arr, batch)
        total = owner.shape[0]
        pred = _lambda_over(e.args[1], [canon.elements], batch, owner)
        pv = pred.data[:total].to(torch.bool)
        pnull = ~_valid(pred, total)
        any_true = _any_by(pv & ~pnull, owner, cap)
        any_false = _any_by(~pv & ~pnull, owner, cap)
        any_null = _any_by(pnull, owner, cap)
        if kind == "any":
            # TRUE if any true; NULL if none true but a null; else FALSE
            out, nul = any_true, ~any_true & any_null
        elif kind == "all":
            out, nul = ~any_false & ~any_null, ~any_false & any_null
        else:
            out, nul = ~any_true & ~any_null, ~any_true & any_null
        return Column(BOOLEAN, out, _and_valid(arr.valid, ~nul))
    return f


def _select_state(live: torch.Tensor, new: Column, old: Column) -> Column:
    """``new`` where ``live``, else ``old`` (a string state merges the two
    dictionaries first)."""
    valid = torch.where(live, new.valid_mask(), old.valid_mask())
    if is_string(new.type):
        merged, ro, rn = old.dictionary.merge(new.dictionary)
        data = torch.where(live, _codes_through(new, rn),
                           _codes_through(old, ro))
        return Column(new.type, data, valid, merged)
    data = torch.where(live, new.data, old.data.to(new.data.dtype))
    d2 = None
    if new.data2 is not None or old.data2 is not None:
        d2 = torch.where(live, hi_lane_or_fill(new), hi_lane_or_fill(old))
    return Column(new.type, data, valid, None, d2)


def _captured(body, params, batch: Batch) -> Dict[str, Column]:
    return {n: batch.columns[n] for n in input_names(body) - set(params)
            if n in batch.columns}


def _reduce(e: Call, batch: Batch) -> Column:
    """reduce(array, init, (s, x) -> ..., s -> ...): one step per element
    position, every row at once; a row whose array is exhausted keeps its
    state."""
    arr = _eval(e.args[0], batch)
    state = _eval(e.args[1], batch)
    step: Lambda = e.args[2]
    outfn: Lambda = e.args[3]
    cap = batch.capacity
    canon, _ = _canon(arr, batch)
    lens = canon.data2
    maxlen = int(lens.max()) if cap else 0
    ssym, esym = step.params
    outer = _captured(step.body, step.params, batch)
    for j in range(maxlen):
        live = j < lens
        elem = canon.elements.gather(torch.where(live, canon.data + j, 0))
        new = _eval(step.body, Batch({**outer, ssym: state, esym: elem}, cap))
        state = _select_state(live, new, state)
    out = _eval(outfn.body, Batch(
        {**_captured(outfn.body, outfn.params, batch),
         outfn.params[0]: state}, cap))
    return dc_replace(out, valid=_and_valid(out.valid, arr.valid))


def _padded_pool(c: Column, lens: torch.Tensor, owner, j) -> Column:
    """A canonical array's elements at (owner, j) slots, NULL past its
    length."""
    inb = j < lens[owner]
    el = c.elements.gather(torch.where(inb, c.data[owner] + j, 0))
    return dc_replace(el, valid=_and_valid(el.valid, inb))


def _zip_with(e: Call, batch: Batch) -> Column:
    a1 = _eval(e.args[0], batch)
    a2 = _eval(e.args[1], batch)
    (c1, _), (c2, _) = _canon(a1, batch), _canon(a2, batch)
    lens = torch.maximum(c1.data2, c2.data2)
    owner, j = _expand(lens, _total(lens))
    out = _lambda_over(e.args[2], [_padded_pool(c1, c1.data2, owner, j),
                                   _padded_pool(c2, c2.data2, owner, j)],
                       batch, owner)
    return Column(e.type, _offsets(lens), _and_valid(a1.valid, a2.valid),
                  None, lens, out)


def _map_lambda(which: str):
    """map_filter / transform_keys / transform_values."""
    def f(e: Call, batch: Batch) -> Column:
        canon, owner = _canon(_eval(e.args[0], batch), batch)
        out = _lambda_over(e.args[1], [canon.elements, canon.elements2],
                           batch, owner)
        if which == "filter":
            keep = torch.nonzero(_true(out, owner.shape[0])).flatten()
            return _from_kept(e.type, canon.elements, keep, owner,
                              batch.capacity, canon.valid, canon.elements2)
        if which == "keys":
            return dc_replace(canon, type=e.type, elements=out)
        return dc_replace(canon, type=e.type, elements2=out)
    return f


def top_k_map_entries(col: Column, k: int) -> Column:
    """Each row's k highest-valued entries (value descending, key
    ascending on ties): the output step of approx_most_frequent."""
    cap = col.capacity
    canon, owner = _canon(col)
    total = owner.shape[0]
    counts = canon.elements2.data[:total].to(_I64)
    klane, _ = _order_lane(canon.elements, total)
    order = lexsort([owner, -counts, klane])
    so = owner[order]
    first = torch.ones(total, dtype=torch.bool, device=owner.device)
    if total > 1:
        first[1:] = so[1:] != so[:-1]
    pos = _pos(total, owner.device)
    gstart = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - gstart
    keep = torch.nonzero(rank < k).flatten()
    return _from_kept(col.type, canon.elements, keep, owner, cap,
                      canon.valid, canon.elements2)


def _map_zip_with(e: Call, batch: Batch) -> Column:
    """map_zip_with(m1, m2, (k, v1, v2) -> ...): the union of each row's
    keys; a key absent from one side binds its value to NULL."""
    m1, o1 = _canon(_eval(e.args[0], batch), batch)
    m2, o2 = _canon(_eval(e.args[1], batch), batch)
    cap = batch.capacity
    dev = batch.device
    t1, t2 = o1.shape[0], o2.shape[0]
    l1, l2 = _key_codes([m1.elements, m2.elements], [t1, t2])
    dt = torch.promote_types(l1.dtype, l2.dtype)
    owner = torch.cat([o1, o2])
    keyl = torch.cat([l1.to(dt), l2.to(dt)])
    src = torch.cat([torch.zeros(t1, dtype=_I64, device=dev),
                     torch.ones(t2, dtype=_I64, device=dev)])
    within = torch.cat([_pos(t1, dev), _pos(t2, dev)])
    total = owner.shape[0]
    order = lexsort([owner, keyl, src, within])
    so, sk = owner[order], keyl[order]
    is_first = torch.ones(total, dtype=torch.bool, device=dev)
    if total > 1:
        is_first[1:] = (so[1:] != so[:-1]) | (sk[1:] != sk[:-1])
    gid = torch.cumsum(is_first.to(_I64), 0) - 1
    ngroups = max(total, 1)
    ss = src[order]
    pos = _pos(total, dev)
    ue = order[is_first]                  # one entry a key, owner-major
    ug = gid[is_first]
    keys_pool = _gather_multi([m1.elements, m2.elements], src[ue],
                              within[ue])

    def side(s: int, pool: Column) -> Column:
        # the first sorted entry of each key from source s, if any
        big = torch.iinfo(_I64).max
        first = torch.full((ngroups,), big, dtype=_I64, device=dev)
        first = first.scatter_reduce_(0, gid, torch.where(ss == s, pos, big),
                                      "amin")
        idx = first[ug]
        present = idx < big
        w = torch.where(present, within[order[idx.clamp(max=total - 1)]]
                        if total else idx, 0)
        col = pool.gather(w)
        return dc_replace(col, valid=_and_valid(col.valid, present))

    u_owner = owner[ue]
    out = _lambda_over(e.args[2], [keys_pool, side(0, m1.elements2),
                                   side(1, m2.elements2)], batch, u_owner)
    lens = torch.bincount(u_owner, minlength=cap)[:cap].to(_I64)
    return Column(e.type, _offsets(lens), _and_valid(m1.valid, m2.valid),
                  None, lens, keys_pool, out)


# ---- string -> array functions: on the host, once per dictionary value ----

def _const_arg(e: Call, i: int, what: str):
    if not isinstance(e.args[i], Const):
        raise EvalError(f"{e.fn}: {what} must be constant")
    return e.args[i].value


def _used_codes(col: Column, batch: Batch) -> np.ndarray:
    """Which dictionary codes some live, non-NULL row holds."""
    live = _and_valid(batch.row_valid(), col.valid)
    codes = col.data.to(_I64).clamp(0, len(col.dictionary) - 1)
    used = torch.zeros(len(col.dictionary), dtype=_I64, device=col.device)
    used.index_add_(0, codes, live.to(_I64))
    return (used > 0).cpu().numpy()


def _strings_pool(rows: List[Optional[list]], device) -> Tuple:
    """(offsets, lengths, row NULL flags, element Column) of lists of
    strings (None list: NULL; None string: NULL element)."""
    lens = np.asarray([0 if r is None else len(r) for r in rows], np.int64)
    flat = [p for r in rows if r is not None for p in r]
    dct, codes = StringDictionary.from_strings(flat)
    evalid = np.asarray([p is not None for p in flat], bool)
    el = Column(VARCHAR, torch.from_numpy(codes).to(device),
                None if evalid.all() else torch.from_numpy(evalid).to(device),
                dct)
    nulls = np.asarray([r is None for r in rows], bool)
    return np.cumsum(lens) - lens, lens, nulls, el


def _per_value_arrays(typ: Type, col: Column, fn, used=None,
                      as_map: bool = False) -> Column:
    """An ARRAY column from ``fn`` applied once per dictionary value of a
    string column (``as_map``: a MAP from its (keys, values)):
    each value's list is one run of a shared pool, and a row reads its
    value's run. ``used`` limits ``fn`` to the codes some row holds."""
    dev = col.device
    if col.dictionary is None:
        return const_column(Const(None, typ), col.capacity, dev)
    vals = col.dictionary.values
    rows = [None if used is not None and not used[i] else fn(str(v))
            for i, v in enumerate(vals)]
    if as_map:
        keys = [None if r is None else r[0] for r in rows]
        mvals = [None if r is None else r[1] for r in rows]
        offs, lens, nulls, kel = _strings_pool(keys, dev)
        _, _, _, vel = _strings_pool(mvals, dev)
        pools = (kel, vel)
    else:
        offs, lens, nulls, el = _strings_pool(rows, dev)
        pools = (el,)
    valid = col.valid
    if used is None and nulls.any():
        nv = ~_codes_through(col, nulls)
        valid = nv if valid is None else valid & nv
    return Column(typ, _codes_through(col, offs), valid, None,
                  _codes_through(col, lens), *pools)


def _split(e: Call, batch: Batch) -> Column:
    delim = _const_arg(e, 1, "delimiter")
    limit = int(_const_arg(e, 2, "limit")) if len(e.args) > 2 else None

    def f(v: str):
        return v.split(delim) if limit is None else v.split(delim, limit - 1)
    return _per_value_arrays(e.type, _eval(e.args[0], batch), f)


def _regexp_extract_all(e: Call, batch: Batch) -> Column:
    pat = re.compile(_const_arg(e, 1, "pattern"))
    group = int(_const_arg(e, 2, "group")) if len(e.args) > 2 else 0
    return _per_value_arrays(
        e.type, _eval(e.args[0], batch),
        lambda v: [m.group(group) for m in pat.finditer(v)])


def _regexp_split(e: Call, batch: Batch) -> Column:
    pat = re.compile(_const_arg(e, 1, "pattern"))
    return _per_value_arrays(e.type, _eval(e.args[0], batch), pat.split)


def _split_to_map(e: Call, batch: Batch) -> Column:
    entry_d = _const_arg(e, 1, "entryDelimiter")
    kv_d = _const_arg(e, 2, "keyValueDelimiter")

    def f(v: str):
        ks, vs = [], []
        for entry in v.split(entry_d):
            if not entry:
                continue
            if kv_d not in entry:
                raise EvalError(
                    "split_to_map: entry without key-value delimiter")
            k, val = entry.split(kv_d, 1)
            if k in ks:
                raise EvalError(f"split_to_map: duplicate key {k!r}")
            ks.append(k)
            vs.append(val)
        return ks, vs
    col = _eval(e.args[0], batch)
    used = None if col.dictionary is None else _used_codes(col, batch)
    return _per_value_arrays(e.type, col, f, used, as_map=True)


def _split_to_multimap(e: Call, batch: Batch) -> Column:
    """split_to_multimap(s, entry, kv): once per used dictionary value, a
    run of distinct keys (first-seen order), each with the array of its
    values; a row reads its value's run."""
    s = _eval(e.args[0], batch)
    d1, d2 = e.args[1], e.args[2]
    if not isinstance(d1, Const) or not isinstance(d2, Const):
        raise EvalError("split_to_multimap: delimiters must be constants")
    ed, kd = str(d1.value), str(d2.value)
    dev = s.device
    if s.dictionary is None:
        return const_column(Const(None, e.type), s.capacity, dev)
    keys, flat_vals, arr_offs, arr_lens = [], [], [], []
    offs, lens = [], []
    for v in s.dictionary.values:
        per: Dict[str, list] = {}
        v = str(v)
        if v:
            for entry in v.split(ed):
                k, _, x = entry.partition(kd)
                per.setdefault(k, []).append(x)
        offs.append(len(keys))
        lens.append(len(per))
        for k, xs in per.items():
            keys.append(k)
            arr_offs.append(len(flat_vals))
            arr_lens.append(len(xs))
            flat_vals.extend(xs)
    kdict, kcodes = StringDictionary.from_strings(keys)
    vdict, vcodes = StringDictionary.from_strings(flat_vals)

    def lane(a, dt=np.int64):
        a = np.asarray(a, dt)
        return torch.from_numpy(np.pad(a, (0, max(1 - a.shape[0], 0)))) \
            .to(dev)
    varr = Column(e.type.value, lane(arr_offs), None, None, lane(arr_lens),
                  Column(VARCHAR, lane(vcodes, np.int32), None, vdict))
    return Column(e.type, _codes_through(s, np.asarray(offs, np.int64)),
                  s.valid, None, _codes_through(s, np.asarray(lens, np.int64)),
                  Column(VARCHAR, lane(kcodes, np.int32), None, kdict), varr)


def _element_tokens(el: Column, total: int):
    """(tokens, texts): each packed element's index into ``texts`` (-1
    for a NULL element), the distinct element values formatted once each
    on the host (a string pool's dictionary; the distinct bit patterns of
    a number or boolean pool, found on its device)."""
    ev = _valid(el, total)
    if is_string(el.type):
        if el.dictionary is None:       # a bare NULL
            return torch.full((total,), -1, dtype=_I64,
                              device=el.device), []
        tok = el.data[:total].to(_I64)
        texts = [str(v) for v in el.dictionary.values]
    else:
        d = el.data[:total]
        if d.is_floating_point():
            # by bit pattern, so -0.0 and 0.0 keep their own text
            ints, fl = ((torch.int64, np.float64) if d.dtype == torch.float64
                        else (torch.int32, np.float32))
            uniq, tok = torch.unique(d.view(ints), return_inverse=True)
            texts = [repr(float(x)) for x in uniq.cpu().numpy().view(fl)]
        else:
            uniq, tok = torch.unique(d.to(_I64), return_inverse=True)
            fmt = ((lambda x: "true" if x else "false")
                   if d.dtype == torch.bool else str)
            texts = [fmt(x) for x in uniq.cpu().tolist()]
    return torch.where(ev, tok, -1), texts


def _row_hashes(tok: torch.Tensor, owner: torch.Tensor, j: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Two 64-bit hashes of each row's token sequence (cap x 2): a wrapping
    sum over the row's elements of a mix of (token, position, salt)."""
    out = torch.zeros(cap, 2, dtype=_I64, device=tok.device)
    for k, salt in enumerate((0x243F6A8885A308D3, 0x13198A2E03707344)):
        h = mix64(mix64(tok + salt) ^ j)
        out[:, k].index_add_(0, owner, h)
    return out


def _array_join(e: Call, batch: Batch) -> Column:
    """The text of each distinct array, joined on the host once. Rows are
    grouped on the device by (length, two hashes of the elements' tokens);
    every row is then compared element by element with its group's first
    row, and a row that differs (a hash collision) is joined on its
    own."""
    arr = _eval(e.args[0], batch)
    delim = _const_arg(e, 1, "delimiter")
    null_repl = (_const_arg(e, 2, "null replacement")
                 if len(e.args) > 2 else None)
    cap = batch.capacity
    dev = batch.device
    canon, owner = _canon(arr, batch)
    total = owner.shape[0]
    offs, lens = canon.data, canon.data2
    tok, texts = _element_tokens(canon.elements, total)
    j = torch.arange(total, device=dev) - offs[owner]
    key = torch.cat([lens[:, None], _row_hashes(tok, owner, j, cap)], 1)
    uniq, group = torch.unique(key, dim=0, return_inverse=True)
    rows = torch.arange(cap, device=dev)
    first = torch.full((uniq.shape[0],), cap, dtype=_I64, device=dev
                       ).scatter_reduce_(0, group, rows, "amin")
    differs = tok != tok[offs[first[group]][owner] + j]
    alone = torch.zeros(cap, dtype=torch.bool, device=dev)
    alone[owner[differs]] = True
    slot = torch.where(alone, uniq.shape[0] + torch.cumsum(alone, 0) - 1,
                       group)
    joined = torch.cat([first, rows[alone]])
    # the joined rows' tokens, one row after another, read back once
    jl = lens[joined]
    jo, jj = _expand(jl, _total(jl))
    toks = tok[offs[joined][jo] + jj].cpu().tolist()
    out, at = [], 0
    for ln in jl.cpu().tolist():
        out.append(delim.join(texts[t] if t >= 0 else null_repl
                              for t in toks[at:at + ln]
                              if t >= 0 or null_repl is not None))
        at += ln
    return _table_column(out, slot, canon.valid, e.type)


# ---- zip, ngrams, combinations, entries, cosine similarity ----------------

def _zip_fn(e: Call, batch: Batch) -> Column:
    arrs = [_eval(a, batch) for a in e.args]
    canons = [_canon(a, batch)[0] for a in arrs]
    valid = _and_valid(*[a.valid for a in arrs])
    lens = canons[0].data2
    for c in canons[1:]:
        lens = torch.maximum(lens, c.data2)
    if valid is not None:
        lens = torch.where(valid, lens, 0)
    total = _total(lens)
    owner, j = _expand(lens, total)
    kids = tuple(_padded_pool(c, c.data2, owner, j) for c in canons)
    row_el = Column(e.type.element, torch.zeros(total, dtype=torch.int8,
                                                device=batch.device),
                    None, children=kids)
    return Column(e.type, _offsets(lens), valid, None, lens, row_el)


def _ngrams(e: Call, batch: Batch) -> Column:
    ne = e.args[1]
    if not isinstance(ne, Const) or ne.value is None or int(ne.value) < 1:
        raise EvalError("ngrams: n must be a positive constant")
    n = int(ne.value)
    arr = _eval(e.args[0], batch)
    canon, _ = _canon(arr, batch)
    valid = _and_valid(arr.valid, batch.row_valid())
    lens = canon.data2
    cnt = torch.where(valid, (lens - n + 1).clamp(min=1), 0)
    owner, j = _expand(cnt, _total(cnt))
    inner = Column(e.type.element, canon.data[owner] + j, None, None,
                   torch.minimum(torch.full_like(j, n),
                                 lens[owner] - j).clamp(min=0),
                   canon.elements)
    return Column(e.type, _offsets(cnt), arr.valid, None, cnt, inner)


def _combinations(e: Call, batch: Batch) -> Column:
    """combinations(array, n): one table of index tuples per distinct
    array length (made on the host once each), expanded over the rows of
    that length on the device."""
    ne = e.args[1]
    if not isinstance(ne, Const) or ne.value is None:
        raise EvalError("combinations: n must be a constant")
    n = int(ne.value)
    if n < 0 or n > 5:
        raise EvalError("combinations: n must be in [0, 5]")
    arr = _eval(e.args[0], batch)
    cap = batch.capacity
    dev = batch.device
    canon, _ = _canon(arr, batch)
    valid = _and_valid(arr.valid, batch.row_valid())
    lens = canon.data2
    distinct = sorted(set(torch.unique(lens).cpu().tolist()))
    tables = [np.asarray(list(itertools.combinations(range(L), n)),
                         np.int64).reshape(-1, n) for L in distinct]
    ncomb = np.asarray([t.shape[0] for t in tables], np.int64)
    tbase = np.cumsum(ncomb) - ncomb
    flat_tbl = torch.from_numpy(
        np.concatenate(tables) if tables else np.zeros((0, n), np.int64)
    ).to(dev)
    which = torch.searchsorted(torch.tensor(distinct, dtype=_I64, device=dev),
                               lens)
    cnt = torch.where(valid, take_clamped(torch.from_numpy(ncomb).to(dev),
                                          which), 0)
    owner, j = _expand(cnt, _total(cnt))
    row_of_tbl = take_clamped(torch.from_numpy(tbase).to(dev),
                              which[owner]) + j
    total = owner.shape[0]
    idx = (flat_tbl[row_of_tbl] if total else
           torch.zeros((0, n), dtype=_I64, device=dev))
    pool = canon.elements.gather((canon.data[owner][:, None] + idx)
                                 .reshape(-1))
    inner = Column(e.type.element, _pos(total, dev) * n, None, None,
                   torch.full((total,), n, dtype=_I64, device=dev), pool)
    return Column(e.type, _offsets(cnt), arr.valid, None, cnt, inner)


def _array_end(which: str):
    def f(e: Call, batch: Batch) -> Column:
        arr = _eval(e.args[0], batch)
        canon, _ = _canon(arr, batch)
        lens = canon.data2
        nonempty = _and_valid(arr.valid, lens > 0)
        idx = canon.data if which == "first" else canon.data + lens - 1
        el = canon.elements.gather(torch.where(nonempty, idx, 0))
        return dc_replace(el, valid=_and_valid(el.valid, nonempty))
    return f


def _entry_children(canon: Column, total: int):
    row_el = canon.elements
    if row_el.children is None or len(row_el.children) != 2:
        raise EvalError("map_from_entries requires array(row(K, V))")
    if not bool(_valid(row_el, total).all()):
        raise EvalError("map entry cannot be null")
    return row_el.children


def _key_groups(owner: torch.Tensor, lane: torch.Tensor):
    """Sort (owner, key, position): the order, each sorted entry's group
    id, and the flags of the first entry of each (owner, key)."""
    total = owner.shape[0]
    order = lexsort([owner, lane, _pos(total, owner.device)])
    so, sk = owner[order], lane[order]
    first = torch.ones(total, dtype=torch.bool, device=owner.device)
    if total > 1:
        first[1:] = (so[1:] != so[:-1]) | (sk[1:] != sk[:-1])
    return order, torch.cumsum(first.to(_I64), 0) - 1, first


def _map_from_entries(e: Call, batch: Batch) -> Column:
    canon, owner = _canon(_eval(e.args[0], batch), batch)
    total = owner.shape[0]
    kcol, vcol = _entry_children(canon, total)
    if not bool(_valid(kcol, total).all()):
        raise EvalError("map key cannot be null")
    lane, _ = _order_lane(kcol, total)
    _, _, first = _key_groups(owner, lane)
    if not bool(first.all()):
        raise EvalError("Duplicate map keys are not allowed")
    return Column(e.type, canon.data, canon.valid, None, canon.data2,
                  prefix(kcol, total), prefix(vcol, total))


def _multimap_from_entries(e: Call, batch: Batch) -> Column:
    """Per row, its distinct keys in first-seen order, each with the array
    of its values in entry order."""
    cap = batch.capacity
    canon, owner = _canon(_eval(e.args[0], batch), batch)
    total = owner.shape[0]
    kcol, vcol = _entry_children(canon, total)
    lane, _ = _order_lane(kcol, total)
    dev = owner.device
    order, gid, first = _key_groups(owner, lane)
    ngroups = max(total, 1)
    # each group's first entry (its representative) and size
    rep = torch.full((ngroups,), total, dtype=_I64, device=dev)
    rep = rep.scatter_reduce_(0, gid, order, "amin")
    size = torch.bincount(gid, minlength=ngroups)
    g_of = torch.empty(total, dtype=_I64, device=dev)
    g_of[order] = gid
    # groups in (owner, first-seen) order; values grouped likewise
    nk = int(first.sum())
    gorder = torch.sort(rep[:nk]).indices
    vorder = lexsort([rep[g_of], _pos(total, dev)])
    alens = size[gorder].to(_I64)
    key_owner = owner[rep[gorder]]
    out_len = torch.bincount(key_owner, minlength=cap)[:cap].to(_I64)
    varr = Column(e.type.value, _offsets(alens), None, None, alens,
                  vcol.gather(vorder))
    return Column(e.type, _offsets(out_len), canon.valid, None, out_len,
                  kcol.gather(rep[gorder]), varr)


def _cosine_similarity(e: Call, batch: Batch) -> Column:
    """Over two maps of numeric values: the dot product of the values
    of shared keys over the product of the norms (NULL when a norm is
    zero)."""
    cap = batch.capacity
    m1, o1 = _canon(_eval(e.args[0], batch), batch)
    m2, o2 = _canon(_eval(e.args[1], batch), batch)
    dev = batch.device
    t1, t2 = o1.shape[0], o2.shape[0]
    v1 = m1.elements2.data[:t1].to(torch.float64)
    v2 = m2.elements2.data[:t2].to(torch.float64)

    def norm(v, o):
        return torch.sqrt(torch.zeros(cap, dtype=torch.float64, device=dev)
                          .index_add_(0, o, v * v))
    na, nb = norm(v1, o1), norm(v2, o2)
    l1, l2 = _key_codes([m1.elements, m2.elements], [t1, t2])
    dt = torch.promote_types(l1.dtype, l2.dtype)
    owner = torch.cat([o1, o2])
    key = torch.cat([l1.to(dt), l2.to(dt)])
    src = torch.cat([torch.zeros(t1, dtype=_I64, device=dev),
                     torch.ones(t2, dtype=_I64, device=dev)])
    val = torch.cat([v1, v2])
    order = lexsort([owner, key, src])
    so, sk, ss, sv = owner[order], key[order], src[order], val[order]
    pair = (so[1:] == so[:-1]) & (sk[1:] == sk[:-1]) & (ss[:-1] == 0) \
        & (ss[1:] == 1)
    dot = torch.zeros(cap, dtype=torch.float64, device=dev).index_add_(
        0, so[1:], torch.where(pair, sv[1:] * sv[:-1], 0.0)) \
        if order.shape[0] > 1 else \
        torch.zeros(cap, dtype=torch.float64, device=dev)
    ok = (na != 0.0) & (nb != 0.0)
    out = dot / torch.where(ok, na * nb, 1.0)
    return Column(DOUBLE, out, _and_valid(m1.valid, m2.valid, ok))


# ---- quantile digests -------------------------------------------------------

def _digest_host(col: Column):
    """(starts, lens, means, weights, row validity) of a digest column on
    the host."""
    h = dg.host
    n = col.capacity
    valid = np.ones(n, bool) if col.valid is None else h(col.valid)
    return (h(col.data).astype(np.int64), h(col.data2).astype(np.int64),
            h(col.elements.data).astype(np.float64),
            h(col.elements2.data).astype(np.float64), valid)


def _digest_rows(col: Column, fn) -> Tuple[np.ndarray, np.ndarray]:
    """fn(means, weights, row) over every non-empty, non-NULL row."""
    starts, lens, means, weights, valid = _digest_host(col)
    n = starts.shape[0]
    out = [None] * n
    for i in range(n):
        if valid[i] and lens[i] > 0:
            s, ln = starts[i], lens[i]
            out[i] = fn(means[s:s + ln], weights[s:s + ln], i)
    return out


def _digest_value_column(col: Column, vals: List, out_type: Type,
                         device) -> Column:
    """Quantile values as a column of the digest's value type: a QDIGEST
    of integers rounds them."""
    vt = col.type.value_type if isinstance(col.type, QDigestType) else None
    ok = np.asarray([v is not None for v in vals], bool)
    data = np.asarray([0.0 if v is None else v for v in vals], np.float64)
    if vt is not None and is_integral(vt):
        data = np.round(data)
    return Column(out_type, torch.from_numpy(data).to(device)
                  .to(torch_dtype(out_type)),
                  None if ok.all() else torch.from_numpy(ok).to(device))


def _value_at_quantile(e: Call, batch: Batch) -> Column:
    col = _eval(e.args[0], batch)
    qs = _eval(e.args[1], batch).data.cpu().numpy().astype(np.float64)
    vals = _digest_rows(col, lambda m, w, i: dg.digest_quantile(
        m, w, float(qs[i % qs.shape[0]])))
    return _digest_value_column(col, vals, e.type, batch.device)


def _values_at_quantiles(e: Call, batch: Batch) -> Column:
    col = _eval(e.args[0], batch)
    qarr = _eval(e.args[1], batch)
    qoffs = qarr.data.cpu().numpy().astype(np.int64)
    qlens = qarr.data2.cpu().numpy().astype(np.int64)
    qvals = qarr.elements.data.cpu().numpy().astype(np.float64)
    rows = _digest_rows(col, lambda m, w, i: [
        dg.digest_quantile(m, w, float(qvals[j]))
        for j in range(int(qoffs[i]), int(qoffs[i] + qlens[i]))])
    lens = np.asarray([0 if r is None else len(r) for r in rows], np.int64)
    flat = [x for r in rows if r is not None for x in r]
    inner = _digest_value_column(col, flat or [0.0], e.type.element,
                                 batch.device)
    dev = batch.device
    ok = np.asarray([r is not None for r in rows], bool)
    return Column(e.type, torch.from_numpy(np.cumsum(lens) - lens).to(dev),
                  None if ok.all() else torch.from_numpy(ok).to(dev), None,
                  torch.from_numpy(lens).to(dev), inner)


def _quantile_at_value(e: Call, batch: Batch) -> Column:
    col = _eval(e.args[0], batch)
    vs = _eval(e.args[1], batch).data.cpu().numpy().astype(np.float64)
    vals = _digest_rows(col, lambda m, w, i: dg.digest_quantile_at_value(
        m, w, float(vs[i % vs.shape[0]])))
    ok = np.asarray([v is not None for v in vals], bool)
    data = np.asarray([0.0 if v is None else v for v in vals], np.float64)
    dev = batch.device
    return Column(DOUBLE, torch.from_numpy(data).to(dev),
                  None if ok.all() else torch.from_numpy(ok).to(dev))


DISPATCH: Dict[str, Callable] = {
    "split": _split,
    "regexp_extract_all": _regexp_extract_all,
    "regexp_split": _regexp_split,
    "split_to_map": _split_to_map,
    "array_join": _array_join,
    "$map": _map_ctor,
    "$row": _row_ctor,
    "$field": _row_field,
    "map": _map_ctor,
    "map_keys": _map_keys,
    "map_values": _map_values,
    "map_entries": _map_entries,
    "map_concat": _map_concat,
    "contains": _contains,
    "array_position": _array_position,
    "array_min": _array_minmax("min"),
    "array_max": _array_minmax("max"),
    "array_distinct": _array_distinct,
    "array_sort": _array_sort,
    "slice": _slice,
    "repeat": _repeat,
    "sequence": _sequence,
    "flatten": _flatten,
    "array_union": _array_setop("union"),
    "array_intersect": _array_setop("intersect"),
    "array_except": _array_setop("except"),
    "arrays_overlap": _arrays_overlap,
    "transform": _transform,
    "filter": _filter_arr,
    "any_match": _match("any"),
    "all_match": _match("all"),
    "none_match": _match("none"),
    "reduce": _reduce,
    "zip_with": _zip_with,
    "map_filter": _map_lambda("filter"),
    "transform_keys": _map_lambda("keys"),
    "transform_values": _map_lambda("values"),
    "map_zip_with": _map_zip_with,
    "array_remove": _array_remove,
    "zip": _zip_fn,
    "ngrams": _ngrams,
    "combinations": _combinations,
    "array_first": _array_end("first"),
    "array_last": _array_end("last"),
    "map_from_entries": _map_from_entries,
    "multimap_from_entries": _multimap_from_entries,
    "split_to_multimap": _split_to_multimap,
    "cosine_similarity": _cosine_similarity,
}

_DISPATCH.update(DISPATCH)
_DISPATCH.update({
    "$array": _array_ctor,
    "element_at": _element_at,
    "value_at_quantile": _value_at_quantile,
    "values_at_quantiles": _values_at_quantiles,
    "quantile_at_value": _quantile_at_value,
})
