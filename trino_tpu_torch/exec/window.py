"""Window function execution over torch tensors.

Counterpart of ``trino_tpu/exec/window.py``: one lexsort by (partition,
order) keys, then every function is segment arithmetic over the sorted
order: partition boundaries from key-change detection, ranks from
order-key-change cumsums, running aggregates from prefix sums. Results
scatter back to input row order, so WindowNode preserves row positions.

Differences from the JAX engine, all about where and in what order the
work runs, never about the answer:

- Eager only: there is no jit cache of window programs.
- Float prefix sums restart at each partition start (a segmented scan),
  so rounding stays at the partition's scale; the JAX engine subtracts
  the partition's base from a prefix sum over the whole batch. Whole-
  partition float sums reduce each partition's sorted run in a fixed
  order (``torch.segment_reduce``); nothing uses floating-point atomics,
  so two runs give the same bits.
- Explicit frames (ROWS/RANGE/GROUPS BETWEEN ...) stay on the device:
  RANGE offsets by a vectorized bisection inside each partition's
  non-null key run, min/max by a sparse table built with tensor ops.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..columnar import Batch, Column, take_clamped
from ..ops import sort as sort_ops
from ..ops.groupby import _changes, _key_lanes
from ..plan.nodes import WindowFunction, WindowNode
from ..types import is_string
from .expr import cast_column

_I64 = torch.int64
_F64 = torch.float64


def execute_window(src: Batch, node: WindowNode) -> Batch:
    cap = src.capacity
    dev = src.device
    live = src.row_valid()

    skeys = [sort_ops.SortKey(s, True, False) for s in node.partition_by]
    skeys += [sort_ops.SortKey(k.symbol, k.ascending, k.nulls_first)
              for k in node.order_by]
    order = (sort_ops.sort_order(src, skeys) if skeys
             else torch.arange(cap, dtype=_I64, device=dev))
    live_s = live[order]
    pos = torch.arange(cap, dtype=_I64, device=dev)
    first = pos == 0

    # partition boundaries over the sorted order
    p_boundary = _changes(_key_lanes(src, list(node.partition_by),
                                     live)[1:], order, first) & live_s
    pid = (torch.cumsum(p_boundary.to(_I64), 0) - 1).clamp(0, cap - 1)
    part_start = _seg_reduce(torch.where(live_s, pos, cap), pid, cap,
                             "amin", cap)
    part_size = torch.zeros(cap, dtype=_I64, device=dev).index_add_(
        0, pid, live_s.to(_I64))

    # peer (order-key) boundaries for rank/dense_rank
    if node.order_by:
        peer_boundary = _changes(_key_lanes(
            src, [k.symbol for k in node.order_by], live)[1:], order,
            p_boundary) & live_s
    else:
        peer_boundary = p_boundary

    w = _Win(src, node, order, live_s, pid, pos, part_start, part_size,
             peer_boundary)
    # scatter back to input row order
    inv = torch.empty_like(order).scatter_(0, order, pos)
    out_cols: Dict[str, Column] = dict(src.columns)
    for sym, fn in node.functions.items():
        res = _eval_fn(fn, w)
        data, valid = res[0], res[1]
        # lag/lead may return a merged dictionary as a third element
        fn_dict = res[2] if len(res) > 2 else None
        out_data = data[inv]
        out_valid = None if valid is None else valid[inv]
        if fn_dict is None and fn.argument is not None and fn.kind in (
                "min", "max", "any_value", "first_value", "last_value",
                "nth_value"):
            fn_dict = src.column(fn.argument).dictionary
        if fn_dict is not None:
            out_cols[sym] = Column(fn.type, out_data.to(torch.int32),
                                   out_valid, fn_dict)
        else:
            out_cols[sym] = Column(fn.type, out_data, out_valid)
    return Batch(out_cols, src.num_rows)


class _Win:
    """The sorted frame of reference every function reads: the sort
    order, sorted liveness, partition id of each sorted row, partition
    starts and sizes (indexed by partition id), peer-group starts."""

    def __init__(self, src, node, order, live_s, pid, pos, part_start,
                 part_size, peer_boundary):
        self.src, self.node, self.order = src, node, order
        self.live_s, self.pid, self.pos = live_s, pid, pos
        self.cap = int(pos.shape[0])
        self.peer_boundary = peer_boundary
        self.start = part_start[pid]             # per sorted row
        self.size = part_size[pid]

    def sorted_lane(self, col: Column):
        """(values, validity) of a column in sorted order; dead rows are
        invalid."""
        vals = col.data[self.order]
        valid = self.live_s if col.valid is None \
            else self.live_s & col.valid[self.order]
        return vals, valid

    def peer_ids(self):
        return (torch.cumsum(self.peer_boundary.to(_I64), 0) - 1).clamp(
            0, self.cap - 1)


def _seg_reduce(vals, ids, n: int, how: str, ident) -> torch.Tensor:
    """[n] reduction of vals by ids (amin/amax: exact in any order)."""
    out = torch.full((n,), ident, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids, vals, how)


def _run_sums(vals: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums that restart at each partition start. Integer
    lanes take one global cumsum minus the partition's base (exact);
    float lanes a segmented scan, so rounding stays at the partition's
    scale."""
    if vals.is_floating_point():
        return _segmented_scan(vals, pid, torch.add)
    run = torch.cumsum(vals, 0)
    first = torch.ones_like(pid, dtype=torch.bool)
    first[1:] = pid[1:] != pid[:-1]
    start_pos = torch.cummax(torch.where(first, torch.arange(
        pid.shape[0], device=pid.device), 0), 0).values
    return run - (run[start_pos] - vals[start_pos])


def _part_totals(vals: torch.Tensor, pid: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """[cap] per-partition totals. The sorted rows of a partition are one
    run (pid is nondecreasing), so a float total reduces that run in a
    fixed order, with no atomics."""
    if vals.is_floating_point():
        lengths = torch.bincount(pid, minlength=cap)
        return torch.segment_reduce(vals, "sum", lengths=lengths,
                                    unsafe=True)
    return torch.zeros(cap, dtype=vals.dtype,
                       device=vals.device).index_add_(0, pid, vals)


def _eval_fn(fn: WindowFunction, w: _Win):
    cap, pid, pos = w.cap, w.pid, w.pos
    k = fn.kind
    if k == "row_number":
        return pos - w.start + 1, None
    if k in ("rank", "percent_rank"):
        # rank = position of the peer-group start within the partition
        peer_start = _running_last_where(pos, w.peer_boundary)
        if k == "rank":
            return peer_start - w.start + 1, None
        r = (peer_start - w.start).to(_F64)
        n = w.size.to(_F64)
        return torch.where(n > 1, r / torch.clamp(n - 1.0, min=1.0),
                           torch.zeros_like(r)), None
    if k == "dense_rank":
        dr = torch.cumsum(w.peer_boundary.to(_I64), 0)
        part_first = _seg_reduce(torch.where(w.live_s, dr, cap + 1), pid,
                                 cap, "amin", cap + 1)
        return dr - part_first[pid] + 1, None
    if k == "cume_dist":
        # count of rows up to the current peer group's end
        peer_id = w.peer_ids()
        peer_end = _seg_reduce(torch.where(w.live_s, pos, -1), peer_id,
                               cap, "amax", -1)
        rel = (peer_end[peer_id] - w.start + 1).to(_F64)
        return rel / torch.clamp(w.size.to(_F64), min=1.0), None
    if k == "ntile":
        # the first (n % b) buckets get ceil(n / b) rows, filled
        # consecutively; also right when b > n
        if fn.offset is None:
            raise ValueError("ntile() requires a bucket-count argument")
        bcol = w.src.column(fn.offset)
        b = torch.clamp(bcol.data[w.order].to(_I64), min=1)
        b_valid = None if bcol.valid is None else bcol.valid[w.order]
        n = w.size
        q, rem = n // b, n % b
        thresh = rem * (q + 1)
        r = pos - w.start
        bucket = torch.where(
            r < thresh, r // torch.clamp(q + 1, min=1),
            rem + (r - thresh) // torch.clamp(q, min=1))
        return bucket + 1, b_valid

    # value / aggregate functions need the argument lane in sorted order
    col = w.src.column(fn.argument) if fn.argument else None
    if col is not None:
        vals, valid_lane = w.sorted_lane(col)
    else:
        vals, valid_lane = w.live_s.to(_I64), w.live_s

    if _explicit_frame(fn) and k not in ("lag", "lead"):
        return _framed_eval(fn, w, vals, valid_lane)

    unbounded_end = (fn.frame_end == "unbounded_following"
                     or not w.node.order_by)
    # the default RANGE frame ends at the current row's peer-group end;
    # a ROWS frame at the row itself
    if fn.frame_unit == "rows":
        frame_pos = pos
    else:
        peer_id = w.peer_ids()
        peer_end = _seg_reduce(torch.where(w.live_s, pos, -1), peer_id,
                               cap, "amax", -1)
        frame_pos = peer_end[peer_id].clamp(0, cap - 1)
    part_last = (w.start + w.size - 1).clamp(0, cap - 1)

    if k == "first_value":
        first_pos = w.start.clamp(0, cap - 1)
        return vals[first_pos], valid_lane[first_pos]
    if k == "last_value":
        last_pos = part_last if unbounded_end else frame_pos
        return vals[last_pos], valid_lane[last_pos]
    if k == "nth_value":
        # the value at the n-th row of the frame; NULL past its end
        if fn.offset is None:
            raise ValueError("nth_value() requires a position argument")
        ocol = w.src.column(fn.offset)
        nth = ocol.data[w.order].to(_I64)
        tgt = w.start + nth - 1
        frame_end = w.start + w.size - 1 if unbounded_end else pos
        tgt_c = tgt.clamp(0, cap - 1)
        valid = (nth >= 1) & (tgt <= frame_end) & valid_lane[tgt_c]
        if ocol.valid is not None:
            valid = valid & ocol.valid[w.order]
        return vals[tgt_c], valid
    if k in ("lag", "lead"):
        return _lag_lead(fn, w, col, vals, valid_lane)

    # aggregates over the partition, or running when ordered
    if k in ("count", "count_star"):
        lane = valid_lane.to(_I64)
        if unbounded_end:
            return _part_totals(lane, pid, cap)[pid], None
        return _run_sums(lane, pid)[frame_pos], None
    nval = valid_lane.to(_I64)
    if k in ("sum", "avg"):
        acc = torch.where(valid_lane, vals, torch.zeros_like(vals)).to(
            _F64 if k == "avg" or vals.is_floating_point() else _I64)
        if unbounded_end:
            s = _part_totals(acc, pid, cap)[pid]
            n = _part_totals(nval, pid, cap)[pid]
        else:
            s = _run_sums(acc, pid)[frame_pos]
            n = _run_sums(nval, pid)[frame_pos]
        if k == "avg":
            return s / torch.clamp(n.to(_F64), min=1.0), n > 0
        return s.to(vals.dtype), n > 0
    if k in ("min", "max"):
        work = vals.to(torch.int32) if vals.dtype == torch.bool else vals
        ident = _identity(k, work.dtype)
        wv = torch.where(valid_lane, work, torch.full_like(work, ident))
        if unbounded_end:
            tot = _seg_reduce(wv, pid, cap, "amin" if k == "min"
                              else "amax", ident)
            return tot[pid], _part_totals(nval, pid, cap)[pid] > 0
        op = torch.minimum if k == "min" else torch.maximum
        run = _segmented_scan(wv, pid, op)
        return run[frame_pos], _run_sums(nval, pid)[frame_pos] > 0
    raise ValueError(f"window function '{k}' not implemented")


def _lag_lead(fn: WindowFunction, w: _Win, col: Optional[Column], vals,
              valid_lane):
    cap = w.cap
    off_valid = None
    if fn.offset is not None:
        ocol = w.src.column(fn.offset)
        off = ocol.data[w.order].to(_I64)
        if ocol.valid is not None:
            # a NULL offset gives NULL
            off_valid = ocol.valid[w.order]
    else:
        off = 1
    tgt = w.pos - off if fn.kind == "lag" else w.pos + off
    same_part = (tgt >= w.start) & (tgt < w.start + w.size)
    tgt_c = torch.as_tensor(tgt).clamp(0, cap - 1)
    data = vals[tgt_c]
    valid = valid_lane[tgt_c] & same_part
    out_dict = col.dictionary if col is not None else None
    if fn.default is not None:
        dcol = w.src.column(fn.default)
        if col is not None and dcol.type != col.type \
                and not is_string(col.type):
            # a default of another type (-1.0, a DECIMAL(2,1) literal, for
            # a DOUBLE value) takes the value's type, unscaled lanes and
            # all
            dcol = cast_column(dcol, col.type)
        dvals = dcol.data
        if out_dict is not None:
            # codes from two pools: remap the default lane into a merged
            # dictionary
            if dcol.dictionary is None:
                raise ValueError("lag/lead default for a dictionary "
                                 "column must be a string")
            merged, _, remap = out_dict.merge(dcol.dictionary)
            dvals = take_clamped(torch.from_numpy(remap).to(dvals.device),
                                 dvals)
            out_dict = merged
        dvals = dvals.to(vals.dtype)[w.order]
        dvalid = w.live_s if dcol.valid is None \
            else w.live_s & dcol.valid[w.order]
        data = torch.where(same_part, data, dvals)
        valid = torch.where(same_part, valid, dvalid)
    if off_valid is not None:
        valid = valid & off_valid
    return data, valid, out_dict


def _identity(kind: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


# the kinds whose explicit frame the default paths still evaluate
_PRE_FRAME_KINDS = frozenset((
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "lag", "lead"))


def window_recordable(node: WindowNode) -> bool:
    """The JAX package's ``window_traceable``, the gate of its window
    program cache and of the window's hot shape: no function with an
    explicit frame outside the ranking and offset kinds."""
    return not any(_explicit_frame(f) and f.kind not in _PRE_FRAME_KINDS
                   for f in node.functions.values())


def _explicit_frame(fn) -> bool:
    """True when the function carries a frame the default running /
    whole-partition paths cannot express: offset bounds, GROUPS unit, or
    a non-default start or end."""
    return (fn.frame_start_value is not None
            or fn.frame_end_value is not None
            or fn.frame_unit == "groups"
            or fn.frame_start not in ("unbounded_preceding",)
            or fn.frame_end == "following")


def _bisect(lane, a, b, t, right: bool, steps: int):
    """Per row, the first index i in [a, b) with lane[i] >= t (left) or
    lane[i] > t (right); b when there is none. ``lane`` is ascending on
    each row's [a, b)."""
    lo, hi = a.clone(), b.clone()
    n = lane.shape[0]
    for _ in range(steps):
        open_ = lo < hi
        mid = (lo + hi) // 2
        v = lane[mid.clamp(0, n - 1)]
        go_right = (v <= t) if right else (v < t)
        lo = torch.where(open_ & go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    return lo


def _framed_eval(fn, w: _Win, vals, valid_lane):
    """Explicit-frame evaluation (ROWS/RANGE/GROUPS BETWEEN ...): the
    inclusive [lo, hi] sorted-position bounds of each row's frame, then
    each aggregate over them."""
    cap, pos, pid = w.cap, w.pos, w.pid
    ps = w.start
    pe = ps + w.size - 1
    unit = fn.frame_unit
    k = fn.kind
    if unit != "rows":
        gidx = w.peer_ids()
        g_start = _seg_reduce(pos, gidx, cap, "amin", cap)
        g_end = _seg_reduce(pos, gidx, cap, "amax", -1)

    def bound(which):
        btype = fn.frame_start if which == "start" else fn.frame_end
        bval = fn.frame_start_value if which == "start" \
            else fn.frame_end_value
        if btype == "unbounded_preceding":
            return ps
        if btype == "unbounded_following":
            return pe
        if btype == "current":
            if unit == "rows":
                return pos
            # RANGE/GROUPS: the current row means its whole peer group
            return g_start[gidx] if which == "start" else g_end[gidx]
        sign = -1 if btype == "preceding" else 1
        n = int(bval or 0)
        if unit == "rows":
            return pos + sign * n
        if unit == "groups":
            g = torch.maximum(torch.minimum(
                gidx + sign * n, gidx[pe.clamp(0, cap - 1)]),
                gidx[ps.clamp(0, cap - 1)])
            return g_start[g] if which == "start" else g_end[g]
        return _range_offset_bound(w, which, sign * n, g_start, g_end,
                                   gidx)

    lo = torch.maximum(bound("start"), ps)
    hi = torch.minimum(bound("end"), pe)
    empty = lo > hi
    lo_c = lo.clamp(0, cap - 1)
    hi_c = hi.clamp(0, cap - 1)

    if k in ("first_value", "last_value", "nth_value"):
        if k == "first_value":
            idx, ok = lo_c, ~empty
        elif k == "last_value":
            idx, ok = hi_c, ~empty
        else:
            ocol = w.src.column(fn.offset)
            nth = ocol.data[w.order].to(_I64)
            idx = (lo_c + nth - 1).clamp(0, cap - 1)
            ok = ~empty & (nth >= 1) & (lo + nth - 1 <= hi)
            if ocol.valid is not None:
                ok = ok & ocol.valid[w.order]
        return vals[idx], ok & valid_lane[idx]

    def frame_total(run):
        """run[hi] - run[lo - 1] inside each partition (0 when empty):
        ``run`` restarts at partition starts."""
        before = torch.where(lo_c > ps, run[(lo_c - 1).clamp(0, cap - 1)],
                             torch.zeros_like(run))
        return torch.where(empty, torch.zeros_like(run), run[hi_c] - before)

    c = frame_total(_run_sums(valid_lane.to(_I64), pid))
    if k in ("count", "count_star"):
        return c, None
    ok = ~empty & (c > 0)
    if k in ("sum", "avg"):
        acc_dt = _F64 if vals.is_floating_point() else _I64
        masked = torch.where(valid_lane, vals.to(acc_dt),
                             torch.zeros((), dtype=acc_dt,
                                         device=vals.device))
        s = frame_total(_run_sums(masked, pid))
        if k == "avg":
            return s / torch.clamp(c, min=1).to(_F64), ok
        return torch.where(ok, s, torch.zeros_like(s)).to(vals.dtype), ok
    if k in ("min", "max"):
        work = vals.to(torch.int32) if vals.dtype == torch.bool else vals
        ident = (2 if k == "min" else -1) if vals.dtype == torch.bool \
            else _identity(k, work.dtype)
        wv = torch.where(valid_lane, work, torch.full_like(work, ident))
        return _range_query(wv, lo_c, hi_c, k), ok
    raise ValueError(
        f"window function '{k}' does not support explicit frames")


def _range_offset_bound(w: _Win, which: str, delta: int, g_start, g_end,
                        gidx):
    """RANGE frame bound with a value offset: inside each partition's run
    of non-NULL keys, the first key >= key + delta (start) or the last
    key <= key + delta (end). Descending keys are negated so the run is
    ascending; in that mirrored space PRECEDING is still the smaller
    side. A NULL-key row's frame is its NULL peer group."""
    node = w.node
    if len(node.order_by) != 1:
        raise ValueError(
            "RANGE offset frames require exactly one ORDER BY key")
    key = node.order_by[0]
    kcol = w.src.column(key.symbol)
    lane = kcol.data[w.order]
    if lane.dtype == torch.bool or kcol.dictionary is not None:
        raise ValueError(
            "RANGE offset frames require a numeric ORDER BY key")
    kvalid = w.live_s if kcol.valid is None \
        else w.live_s & kcol.valid[w.order]
    if not key.ascending:
        lane = -lane
    cap, pos, pid = w.cap, w.pos, w.pid
    vs = _seg_reduce(torch.where(kvalid, pos, cap), pid, cap, "amin",
                     cap)[pid]
    ve = _seg_reduce(torch.where(kvalid, pos, -1), pid, cap, "amax",
                     -1)[pid]
    target = lane + delta
    steps = max(int(cap).bit_length() + 1, 1)
    if which == "start":
        out = _bisect(lane, vs, ve + 1, target, False, steps)
        null_bound = g_start[gidx]
    else:
        out = _bisect(lane, vs, ve + 1, target, True, steps) - 1
        null_bound = g_end[gidx]
    return torch.where(kvalid, out, null_bound)


def _range_query(wv: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 kind: str) -> torch.Tensor:
    """min or max of wv over [lo, hi] per row, from a sparse table:
    level l holds op over [i, i + 2^l), and a query combines the two
    level-l windows that cover its range."""
    op = torch.minimum if kind == "min" else torch.maximum
    cap = wv.shape[0]
    length = (hi - lo + 1).clamp(min=1)
    lvl = torch.floor(torch.log2(length.to(_F64))).to(_I64).clamp(min=0)
    out = torch.empty_like(wv)
    level, span, li = wv, 1, 0
    while True:
        m = lvl == li
        b = (hi - span + 1).clamp(0, level.shape[0] - 1)
        a = lo.clamp(0, level.shape[0] - 1)
        out = torch.where(m, op(level[a], level[b]), out)
        if span * 2 > cap:
            break
        level = op(level[:level.shape[0] - span], level[span:])
        span *= 2
        li += 1
    return out


def _running_last_where(pos, flag):
    """For each position, the most recent position where flag was
    True."""
    return torch.cummax(torch.where(flag, pos, -1), 0).values


def _segmented_scan(vals, pid, op):
    """Inclusive scan that restarts at each pid change (pid is
    nondecreasing): a Hillis-Steele scan of log2(n) whole-lane steps,
    each combining a row with the row 2^s before it when both lie in one
    partition. The order of combination is fixed, so the bits are too."""
    n = vals.shape[0]
    out = vals
    d = 1
    while d < n:
        same = torch.zeros(n, dtype=torch.bool, device=vals.device)
        same[d:] = pid[d:] == pid[:-d]
        prev = torch.cat([out[:d], out[:-d]])
        out = torch.where(same, op(prev, out), out)
        d *= 2
    return out
