"""The least time a kernel could take on the card, from its shapes.

Frozen copy of the bound arithmetic of
``trino_tpu_torch/bench_grouped_sums.py`` (``measure``: ``nbytes``, ``ops``,
``bound_ms``), which ``chip_smoke.py``'s ``kernel_split`` lines report, at
commit 02b59fe5773712a2e689bf918db914d607cd01fb. Peaks are NVIDIA's data
sheet for the H100 SXM (dense rates, at its 700 W power limit).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 67e12


def grouped_sums_bytes(rows: int, k: int, nseg: int) -> int:
    """Bytes ``grouped_sums`` must move for ``rows`` rows: every f64 lane
    and the int32 id lane read once, the [K, nseg] f64 sums written
    once."""
    return k * rows * 8 + rows * 4 + k * nseg * 8


def grouped_sums_bound_s(rows: int, k: int, nseg: int) -> float:
    """The larger of its bytes over the HBM rate and its K * rows f64
    additions over the FP64 rate."""
    return max(grouped_sums_bytes(rows, k, nseg) / HBM_BYTES_PER_S,
               k * rows / FP64_OPS_PER_S)
