"""Device sort / TopN over torch tensors.

Counterpart of ``trino_tpu/ops/sort.py``. Each sort key becomes a few
comparable lanes (a null-ordering lane, for floats a NaN lane, then the
value lane, negated or complemented for DESC); a leading liveness lane
pushes dead rows past the end. ``jnp.lexsort`` over that lane list becomes
a chain of stable ``torch.sort`` passes, least significant lane first.

Strings sort by dictionary RANK codes (collation order), not by raw
codes, which follow insertion order. Trino's default null ordering:
nulls are largest. Float total order: NaN is largest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..columnar import Batch, Column, take_clamped
from ..obs.trace import device_wait
from ..types import is_string


@dataclass(frozen=True)
class SortKey:
    column: str
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None -> Trino default (nulls = max)

    def resolved_nulls_first(self) -> bool:
        if self.nulls_first is not None:
            return self.nulls_first
        return not self.ascending  # nulls largest


def _key_lanes_for(col: Column, asc: bool, nulls_first: bool,
                   live: torch.Tensor) -> List[torch.Tensor]:
    d = col.data
    is_null = ~col.valid_mask() & live
    lanes: List[torch.Tensor] = [
        torch.where(is_null, 0 if nulls_first else 1,
                    1 if nulls_first else 0).to(torch.int32)]
    if is_string(col.type):
        with device_wait():
            ranks = torch.from_numpy(col.dictionary.rank_codes()).to(
                d.device)
        v = take_clamped(ranks, d).to(torch.int64)
        lanes.append(v if asc else -v)
    elif d.is_floating_point():
        f = d.to(torch.float64)
        nan = torch.isnan(f)
        lanes.append(torch.where(nan, 1 if asc else 0,
                                 0 if asc else 1).to(torch.int32))
        v = torch.where(nan, 0.0, f)
        lanes.append(v if asc else -v)
    elif d.dtype == torch.bool:
        v = d.to(torch.int32)
        lanes.append(v if asc else 1 - v)
    else:
        v = d.to(torch.int64)
        lanes.append(v if asc else torch.bitwise_not(v))
    # null rows' value lanes are neutral, so the null lane alone orders
    # them (and the sort stays stable among nulls)
    lanes[1:] = [torch.where(is_null, torch.zeros_like(x), x)
                 for x in lanes[1:]]
    return lanes


def sort_lanes(batch: Batch, keys: Sequence[SortKey]) -> List[torch.Tensor]:
    """Lane list, most significant first: liveness, then per-key lanes."""
    live = batch.row_valid()
    lanes: List[torch.Tensor] = [(~live).to(torch.int32)]
    for k in keys:
        lanes.extend(_key_lanes_for(batch.column(k.column), k.ascending,
                                    k.resolved_nulls_first(), live))
    return lanes


def lexsort(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by the lanes, most significant
    first (``jnp.lexsort(lanes[::-1])``): one stable sort per lane,
    least significant first."""
    perm = torch.arange(lanes[0].shape[0], dtype=torch.int64,
                        device=lanes[0].device)
    for lane in reversed(lanes):
        step = torch.sort(lane[perm], stable=True).indices
        perm = perm[step]
    return perm


def sort_order(batch: Batch, keys: Sequence[SortKey]) -> torch.Tensor:
    """Stable permutation realizing ORDER BY."""
    return lexsort(sort_lanes(batch, keys))


def sort_batch(batch: Batch, keys: Sequence[SortKey]) -> Batch:
    return batch.gather(sort_order(batch, keys), batch.num_rows)


def topn_batch(batch: Batch, keys: Sequence[SortKey], n: int) -> Batch:
    """ORDER BY ... LIMIT n: full sort, then truncate."""
    out = sort_batch(batch, keys)
    with device_wait():
        limit = torch.as_tensor(n, dtype=torch.int64, device=out.device)
    count = torch.minimum(out.num_rows_device(), limit)
    return Batch(out.columns, count)
