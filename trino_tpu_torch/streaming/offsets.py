"""Spool-backed consumer offset store — the ingest watermark ledger.

Counterpart of ``trino_tpu/streaming/offsets.py`` (host only), over the
port's spool; the epochs' frames are the same JSON, so either package
loads the other's.

Reference parity: Kafka's ``__consumer_offsets`` topic, rebuilt on the
FTE spool (fte/spool.py) so every backend — local dir AND the
object-store shape — works unchanged and a replacement coordinator on
the same spool resumes consumers where the dead one sealed them.

Addressing: consumer ``c`` commits under query id ``stream.c`` and the
reserved fragment -3 (-1 = persisted results, -2 = execution
manifests), one spool PART per monotonically increasing EPOCH. An
epoch's frame is the JSON offsets map {topic: {partition: next
offset}} as of the END of that cycle. First-commit-wins per
(consumer, epoch) is the idempotency mechanism: two racing cycle
drivers (a coordinator failing over mid-commit, a retried cycle) can
both attempt epoch N but only one frame seals, and the loser reads
the winner's watermark back instead of double-advancing.

``load`` probes epochs UPWARD from the last one this process saw —
O(new epochs), not O(history) — so a continuous job polling every few
hundred ms pays one spool read per cycle, not a scan.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

from ..fte.faultpoints import fault_point
from ..fte.spool import SpoolManager
from ..obs.metrics import OFFSET_COMMITS

# reserved spool fragment for consumer offsets (see fte/spool.py:
# -1 persisted results, -2 execution manifests)
OFFSETS_FRAGMENT = -3

# {topic: {partition: next offset to read}}
Offsets = Dict[str, Dict[int, int]]


def _qid(consumer: str) -> str:
    if not consumer or "/" in consumer:
        raise ValueError(f"invalid consumer name {consumer!r}")
    return f"stream.{consumer}"


class OffsetStore:
    def __init__(self, spool: SpoolManager):
        self.spool = spool
        self._lock = threading.Lock()
        self._last: Dict[str, Tuple[int, Offsets]] = {}  # cache

    def commit(self, consumer: str, epoch: int,
               offsets: Offsets) -> bool:
        """Seal ``offsets`` as consumer's epoch. Returns True when
        THIS commit won the epoch, False when an earlier one already
        had (the caller should reload and resume from the winner)."""
        # chaos site: a crash here is the cycle dying AFTER its data
        # landed but BEFORE the watermark advanced — the next cycle
        # re-covers the same window (at-least-once across the gap)
        fault_point("stream.pre_offset_commit")
        frame = json.dumps({"epoch": int(epoch),
                            "offsets": offsets}).encode()
        # attempt id = pid: distinct racers get distinct attempts, so
        # the returned winner tells us whether OUR frame sealed
        attempt = os.getpid()
        win = self.spool.commit(_qid(consumer), OFFSETS_FRAGMENT,
                                int(epoch), attempt, [frame])
        won = win == attempt
        OFFSET_COMMITS.inc(
            outcome="committed" if won else "superseded")
        if won:
            with self._lock:
                last = self._last.get(consumer)
                if last is None or last[0] < epoch:
                    self._last[consumer] = (int(epoch), offsets)
        return won

    def _read_epoch(self, consumer: str,
                    epoch: int) -> Optional[Offsets]:
        frames = self.spool.read(_qid(consumer), OFFSETS_FRAGMENT,
                                 int(epoch))
        if not frames:
            return None
        try:
            doc = json.loads(frames[0])
            return {t: {int(p): int(o) for p, o in parts.items()}
                    for t, parts in doc.get("offsets", {}).items()}
        except (ValueError, AttributeError):
            return None

    def load(self, consumer: str) -> Tuple[int, Offsets]:
        """(last committed epoch, its offsets); (0, {}) when the
        consumer has never committed. Epochs start at 1."""
        with self._lock:
            epoch, offs = self._last.get(consumer, (0, {}))
        while True:
            nxt = self._read_epoch(consumer, epoch + 1)
            if nxt is None:
                break
            epoch, offs = epoch + 1, nxt
        with self._lock:
            last = self._last.get(consumer)
            if last is None or last[0] < epoch:
                self._last[consumer] = (epoch, offs)
        return epoch, offs

    def release(self, consumer: str) -> None:
        """Drop a canceled consumer's ledger."""
        self.spool.release(_qid(consumer))
        with self._lock:
            self._last.pop(consumer, None)
