"""Straggler detection for speculative task re-dispatch.

Counterpart of ``trino_tpu/fte/speculate.py`` (host code).

Reference parity: speculative execution as in Trino's adaptive task
scheduling (and the classic MapReduce backup-task design): track the
runtime distribution of COMPLETED attempts per fragment; a still-running
attempt whose elapsed time exceeds a configurable multiple of the
fragment median is a straggler and earns one speculative duplicate on a
different worker. First completion wins — the spool's first-commit-wins
protocol (fte/spool.py) makes the race safe by construction.

The detector is pure bookkeeping (no threads): the scheduler's
speculation monitor polls ``is_straggler`` with each running task's
elapsed time. Quantiles come from the recorded sample list — fragments
dispatch a handful of tasks (one per worker), so O(n log n) on demand
beats maintaining a sketch.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..obs.metrics import METRICS

SPECULATIVE_TASKS = METRICS.counter(
    "trino_tpu_speculative_tasks_total",
    "Speculative duplicate task attempts launched for stragglers")
SPECULATIVE_WINS = METRICS.counter(
    "trino_tpu_speculative_wins_total",
    "Speculative attempts that committed before the original attempt")


class StragglerDetector:
    """Per-fragment runtime quantiles + the straggler predicate."""

    def __init__(self, multiplier: float = 2.0, min_samples: int = 2,
                 min_runtime_s: float = 0.2):
        self.multiplier = float(multiplier)
        self.min_samples = int(min_samples)
        self.min_runtime_s = float(min_runtime_s)
        self._lock = threading.Lock()
        self._samples: Dict[int, List[float]] = {}

    def record(self, fragment_id: int, runtime_s: float) -> None:
        with self._lock:
            self._samples.setdefault(fragment_id, []).append(
                float(runtime_s))

    def quantile(self, fragment_id: int, q: float) -> Optional[float]:
        """Nearest-rank quantile of completed runtimes, or None with no
        samples."""
        with self._lock:
            xs = sorted(self._samples.get(fragment_id, ()))
        if not xs:
            return None
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def median(self, fragment_id: int) -> Optional[float]:
        return self.quantile(fragment_id, 0.5)

    def samples(self, fragment_id: int) -> int:
        with self._lock:
            return len(self._samples.get(fragment_id, ()))

    def is_straggler(self, fragment_id: int, elapsed_s: float) -> bool:
        """True once ``min_samples`` sibling attempts have completed
        and this attempt has run more than ``multiplier`` x their
        median (and past the absolute floor — re-dispatching a 5ms task
        buys nothing)."""
        if elapsed_s < self.min_runtime_s:
            return False
        if self.samples(fragment_id) < self.min_samples:
            return False
        med = self.median(fragment_id)
        return med is not None and elapsed_s > self.multiplier * med
