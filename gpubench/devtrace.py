"""Read a slice of the window from ``torch.profiler``'s trace.

The profiler runs over a steady slice of the window and its Chrome trace
is read here: the device's activity (kernels, copies, sets), the launches
of each kernel and the host's runtime calls that made them. Times are in
the trace's microseconds; ``Slice.to_perf`` maps them onto the host's
``time.perf_counter``, so spans and calls timed on the host line up with
the device's activity. The map comes from short ``CLOCK`` annotations,
each opened between two reads of the host's clock: the pair that lies
closest together places the trace's clock, where a single read could
wait on the interpreter lock for milliseconds while query threads run.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "gpubench.slice"
CLOCK = "gpubench.clock"


@dataclass
class Slice:
    start_us: float
    end_us: float
    offset_s: float            # perf_counter = ts_us / 1e6 + offset_s
    device: List[dict] = field(default_factory=list)
    runtime: Dict[int, dict] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def to_perf(self, ts_us: float) -> float:
        return ts_us / 1e6 + self.offset_s

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's activity, clipped to the slice, as
        sorted (start, end) in trace microseconds."""
        spans = sorted((max(e["ts"], self.start_us),
                        min(e["ts"] + e.get("dur", 0.0), self.end_us))
                       for e in self.device)
        out: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches between the busy ones, in trace us."""
        out, at = [], self.start_us
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < self.end_us:
            out.append((at, self.end_us))
        return out

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"]

    def device_ops(self, top: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took most time."""
        by: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by[e["name"][:120]] += e.get("dur", 0.0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def launch_of(self, kernel: dict):
        """(host thread id, perf_counter time) of the runtime call that
        launched ``kernel``, where the trace holds it."""
        corr = (kernel.get("args") or {}).get("correlation")
        rt = self.runtime.get(corr) if corr is not None else None
        if rt is None:
            return None
        return rt.get("tid"), self.to_perf(rt["ts"])


def load(path: str, clock: List[Tuple[float, float]]) -> Slice:
    """The slice of the trace at ``path`` that the ``MARK`` annotation
    spans; ``clock`` holds, for each ``CLOCK`` annotation in order, the
    perf_counter reads just before and just after it opened."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    mark = [e for e in events if e.get("name") == MARK and "dur" in e]
    if not mark:
        raise ValueError("the trace has no slice annotation")
    ticks = sorted(float(e["ts"]) for e in events
                   if e.get("name") == CLOCK and "dur" in e)
    if len(ticks) != len(clock) or not ticks:
        raise ValueError(f"the trace has {len(ticks)} clock annotations, "
                         f"{len(clock)} were made")
    (a, b), ts = min(zip(clock, ticks), key=lambda p: p[0][1] - p[0][0])
    m = mark[0]
    sl = Slice(float(m["ts"]), float(m["ts"]) + float(m["dur"]),
               (a + b) / 2 - ts / 1e6)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            e["ts"] = float(e["ts"])
            e["dur"] = float(e.get("dur", 0.0))
            if e["ts"] + e["dur"] > sl.start_us and e["ts"] < sl.end_us:
                sl.device.append(e)
        elif cat == "cuda_runtime":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                e["ts"] = float(e["ts"])
                sl.runtime[corr] = e
    return sl
