"""Row selection & compaction over torch tensors.

Counterpart of ``trino_tpu/ops/compact.py``: a mask becomes a
capacity-length gather whose first ``count`` entries are the selected
positions in order, so a filter keeps the batch's capacity bucket and a
device-side row count.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..columnar import Batch


def mask_to_gather(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Turn a boolean row mask into (indices, count). The tail past
    ``count`` points at row 0 (the fixed-size ``nonzero`` of the JAX
    engine, padded by hand)."""
    cap = mask.shape[0]
    count = mask.sum(dtype=torch.int64)
    # stable sort of ~mask puts selected rows first, in order, with no
    # host sync for the data-dependent count
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    pos = torch.arange(cap, device=mask.device)
    idx = torch.where(pos < count, order, torch.zeros_like(order))
    return idx, count


def filter_batch(batch: Batch, mask: torch.Tensor) -> Batch:
    """Keep rows where mask & live, compacted, with a device num_rows."""
    idx, count = mask_to_gather(mask & batch.row_valid())
    return batch.gather(idx, count)


def limit_batch(batch: Batch, limit: Union[int, torch.Tensor]) -> Batch:
    """LIMIT n without data movement."""
    n = torch.minimum(batch.num_rows_device(), torch.as_tensor(
        limit, dtype=torch.int64, device=batch.device))
    return Batch(batch.columns, n)



def offset_batch(batch: Batch, offset: Union[int, torch.Tensor]) -> Batch:
    """OFFSET n: shift the rows down by n."""
    cap = batch.capacity
    off = torch.as_tensor(offset, dtype=torch.int64, device=batch.device)
    idx = torch.arange(cap, dtype=torch.int64, device=batch.device) + off
    n = torch.clamp(batch.num_rows_device() - off, min=0)
    return batch.gather(idx.clamp(0, max(cap - 1, 0)), n)
