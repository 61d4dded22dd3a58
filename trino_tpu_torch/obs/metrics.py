"""Process-wide metrics registry, for now only the counters the plan
sanity checker reads.

Counterpart of the core of ``trino_tpu/obs/metrics.py``: a small
lock-safe registry (``METRICS``) of named label-keyed counters, rendered
in the Prometheus text format (version 0.0.4). Label support is
positional-by-name: a metric declares its label names once; every
sample supplies them as keyword arguments, and a mismatched label set
raises. The gauges, histograms and the engine's other counters are not
ported yet.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

def _escape(v: object) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base: a named family of (label-tuple -> value) samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels "
                f"{self.labelnames}, got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def samples(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._values.items())

    def _render_labels(self, key: Tuple[str, ...],
                       extra: Sequence[Tuple[str, str]] = ()) -> str:
        pairs = [f'{n}="{_escape(v)}"'
                 for n, v in list(zip(self.labelnames, key)) + list(extra)]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        samples = self.samples()
        if not samples and not self.labelnames:
            # Prometheus convention: an unlabeled family is initialized
            # to 0 at registration — scrapers can alert on rate() the
            # moment the process boots, not after the first event
            samples = [((), 0.0)]
        for key, v in samples:
            lines.append(
                f"{self.name}{self._render_labels(key)} {_fmt(v)}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount



class MetricsRegistry:
    """Named-metric registry; ``counter`` is get-or-create (idempotent
    across modules instrumenting the same family). ``render()``
    produces the text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not Counter:
                    raise ValueError(
                        f"metric {name} already registered as {m.kind}")
                return m
            m = Counter(name, help, tuple(labelnames), self._lock)
            self._metrics[name] = m
            return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# the process-wide registry
METRICS = MetricsRegistry()

# plan sanity checking (analysis/sanity.py): runs are counted so that
# validation switched off by accident shows (the rate drops to 0 while
# queries keep flowing); failures carry the validator name — the
# responsible optimizer pass is in the error message
PLAN_VALIDATIONS = METRICS.counter(
    "trino_tpu_plan_validations_total",
    "Plan sanity-checker batteries executed")
PLAN_VALIDATION_FAILURES = METRICS.counter(
    "trino_tpu_plan_validation_failures_total",
    "Plans rejected by the sanity checker, by validator", ("validator",))
