"""Joins as sort + binary search, over torch tensors.

Counterpart of ``trino_tpu/ops/join.py``:

1. each side's keys become one u64 equality lane (bijective splitmix64 of
   a single integer key; multi-column and float keys are hash-combined,
   and the executor re-verifies their equality, ``join_verify_filter``);
   string keys first move onto one dictionary merged across both sides;
2. the build side is sorted by that lane, with unusable rows (dead, or a
   NULL key) forced past the usable prefix;
3. every probe row finds its match run by two ``searchsorted`` calls.

Torch sorts and searches int64 only, so every u64 lane is mapped to
int64 by flipping its sign bit (``hashing.to_signed_order``): the order is
the JAX engine's u64 order, and its ``U64MAX`` sentinel for the dead tail
becomes ``INT64_MAX``.

Output cardinality is data-dependent: callers run ``match_counts``, read
the total on the host, pick a capacity bucket, then ``expand_join``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..columnar import Batch, take_clamped
from .hashing import (INT64_MAX, combine_hashes, lane_to_u64, mix64,
                      to_signed_order)
from .sort import lexsort

_I64 = torch.int64


def align_string_keys(probe: Batch, build: Batch,
                      probe_keys: Sequence[str],
                      build_keys: Sequence[str]) -> Tuple[Batch, Batch]:
    """Remap string key columns of both sides onto a merged dictionary so
    that code equality is string equality across the two batches."""
    pcols = dict(probe.columns)
    bcols = dict(build.columns)
    for pk, bk in zip(probe_keys, build_keys):
        pc, bc = pcols[pk], bcols[bk]
        if pc.dictionary is None or bc.dictionary is None \
                or pc.dictionary is bc.dictionary:
            continue
        merged, rs, ro = pc.dictionary.merge(bc.dictionary)
        pcols[pk] = pc.with_dictionary(merged, rs)
        bcols[bk] = bc.with_dictionary(merged, ro)
    return Batch(pcols, probe.num_rows), Batch(bcols, build.num_rows)


def equality_lane(batch: Batch, key_names: Sequence[str]):
    """(lane, usable): the u64 key lane (int64 carrier); usable is False
    for dead rows and rows with any NULL key (NULL never matches)."""
    usable = batch.row_valid()
    lanes = []
    for name in key_names:
        col = batch.column(name)
        lanes.append(lane_to_u64(col.data))
        if col.valid is not None:
            usable = usable & col.valid
    if len(lanes) == 1:
        lane = mix64(lanes[0])          # bijective: exact equality
    else:
        lane = combine_hashes([mix64(x) for x in lanes])
    return lane, usable


def build_side(batch: Batch, key_names: Sequence[str]):
    """Sort the build side by key lane. Returns (sorted keys in signed
    order, perm, m): the first m entries are the usable sorted keys, the
    tail is INT64_MAX."""
    lane, usable = equality_lane(batch, key_names)
    key = to_signed_order(lane)
    order = lexsort([(~usable).to(torch.int8), key])
    m = usable.sum(dtype=_I64)
    pos = torch.arange(batch.capacity, dtype=_I64, device=batch.device)
    sorted_key = torch.where(pos < m, key[order],
                             torch.full_like(key, INT64_MAX))
    return sorted_key, order, m


def _match_runs(probe: Batch, build: Batch, probe_keys: Sequence[str],
                build_keys: Sequence[str]):
    probe, build = align_string_keys(probe, build, probe_keys, build_keys)
    lane_p, usable_p = equality_lane(probe, probe_keys)
    sorted_key, order, m = build_side(build, build_keys)
    key_p = to_signed_order(lane_p)
    left = torch.minimum(torch.searchsorted(sorted_key, key_p), m)
    right = torch.minimum(
        torch.searchsorted(sorted_key, key_p, side="right"), m)
    return left, right, usable_p, order


def match_counts(probe: Batch, build: Batch, probe_keys: Sequence[str],
                 build_keys: Sequence[str]):
    """Per-probe-row (start, count) of its build match run, and the build
    permutation: start indexes the sorted build order."""
    left, right, usable_p, order = _match_runs(probe, build, probe_keys,
                                               build_keys)
    count = torch.where(usable_p, right - left, 0)
    return left, count, order


def expand_join(probe: Batch, build: Batch, start: torch.Tensor,
                count: torch.Tensor, order: torch.Tensor,
                out_capacity: int, join_type: str = "inner",
                build_prefix: str = "") -> Batch:
    """Materialise join rows from per-probe match runs. join_type inner
    or left; for left, a probe row without a match emits one row with
    NULL build columns."""
    outer = join_type == "left"
    dev = probe.device
    if outer:
        eff = torch.where(probe.row_valid(), count.clamp(min=1), 0)
    else:
        eff = count
    incl = torch.cumsum(eff, 0)
    total = incl[-1]
    offs = incl - eff                   # exclusive
    i = torch.arange(out_capacity, dtype=_I64, device=dev)
    p = torch.searchsorted(incl, i, side="right").clamp(
        0, probe.capacity - 1)
    b_sorted = take_clamped(start, p) + (i - take_clamped(offs, p))
    b = take_clamped(order, b_sorted)
    pad_build = take_clamped(count == 0, p) if outer else None
    cols = {name: col.gather(p) for name, col in probe.columns.items()}
    for name, col in build.columns.items():
        cols[build_prefix + name] = col.gather(b, pad_build)
    return Batch(cols, total)


def semi_join_mask(probe: Batch, build: Batch, probe_keys: Sequence[str],
                   build_keys: Sequence[str]):
    """(matched, probe_key_null, build_has_null, build_nonempty) for IN /
    semi-join with SQL three-valued semantics: a NULL probe key, or a
    NULL on the build side, gives NULL instead of FALSE."""
    left, right, usable_p, _ = _match_runs(probe, build, probe_keys,
                                           build_keys)
    matched = (right > left) & usable_p
    key_null = probe.row_valid() & ~usable_p
    live_b = build.row_valid()
    any_null_key = torch.zeros((), dtype=torch.bool, device=build.device)
    for name in build_keys:
        col = build.column(name)
        if col.valid is not None:
            any_null_key = any_null_key | (live_b & ~col.valid).any()
    nonempty = live_b.any()
    return matched, key_null, any_null_key, nonempty


def cross_counts(probe: Batch, build: Batch):
    """Nested-loop (cross) join sizing: every live probe row matches every
    live build row."""
    count = torch.where(probe.row_valid(), build.num_rows_device(), 0)
    start = torch.zeros(probe.capacity, dtype=_I64, device=probe.device)
    order = torch.arange(build.capacity, dtype=_I64, device=build.device)
    return start, count, order
