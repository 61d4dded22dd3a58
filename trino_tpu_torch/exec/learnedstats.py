"""Learned per-operator statistics keyed by canonical program key.

Counterpart of ``trino_tpu/exec/learnedstats.py`` (host only). Every
execution with node stats (exec/executor.py ``NodeStats``) folds each
operator's rows-in, rows-out and wall time into an EMA of selectivity
(rows_out / rows_in) and throughput (rows_out / wall_s) per (canonical
program key, operator, occurrence). ``merge`` takes origin-stamped
deltas from workers and skips self-originated ones, so a worker that
shares the coordinator's process never double-counts.

``save`` and ``load`` round-trip the EMAs through a JSON file under the
coordinator's history directory (``GET /v1/stats``,
``system.runtime.operator_stats``). Observed by query threads and read
by HTTP handler threads: every method takes the registry lock."""


from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..config import CONFIG
from ..obs.metrics import LEARNED_STATS_OBSERVATIONS, LEARNED_STATS_SIZE


def plan_key_for(root) -> str:
    """Stable canonical key for a plan (sub)tree: the progkey
    structural fingerprint when the plan canonicalizes (renamed /
    reordered plans share one key), else a digest of the rendered plan tree so
    EVERY plan gets a non-empty, deterministic key."""
    try:
        from .progkey import node_fingerprint
        fp = node_fingerprint(root)
    except Exception:           # noqa: BLE001 — keying is best-effort
        fp = None
    if fp is not None:
        raw = repr(fp)
    else:
        try:
            from ..plan.nodes import plan_tree_lines
            raw = "\n".join(plan_tree_lines(root))
        except Exception:       # noqa: BLE001
            raw = repr(type(root).__name__)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


class LearnedStatsRegistry:
    """EMA store of observed operator behavior, LRU-bounded per
    (program key, operator name, occurrence index)."""

    def __init__(self, capacity: Optional[int] = None,
                 alpha: Optional[float] = None) -> None:
        import uuid
        self._lock = threading.Lock()
        self._capacity = (capacity if capacity is not None
                          else CONFIG.learned_stats_entries)
        self._alpha = (alpha if alpha is not None
                       else CONFIG.learned_stats_alpha)
        # (key, op, idx) -> entry dict; OrderedDict end == most
        # recently observed (the LRU eviction order)
        self._ops: "OrderedDict[Tuple[str, str, int], dict]" = \
            OrderedDict()
        # observation ring for delta export: each observe()/merge()
        # appends one compact record; export_delta ships the suffix
        # recorded after the caller's seq snapshot
        self._pending: "deque[dict]" = deque(maxlen=4096)
        self._seq = 0
        # identity stamped on exported observations — merge() drops
        # self-originated ones (a worker in the coordinator's process
        # never double-counts)
        self.origin = uuid.uuid4().hex[:12]

    # -- write side ----------------------------------------------------
    def observe(self, key: str, op: str, idx: int, rows_in: int,
                rows_out: int, wall_s: float,
                origin: Optional[str] = None,
                _outcome: str = "observed") -> None:
        """Fold one observed operator execution into the EMAs. Rows
        may be -1 (unknown); selectivity only updates when both sides
        are known, throughput when wall is non-zero."""
        now = time.time()
        sel = (rows_out / rows_in
               if rows_in is not None and rows_out is not None
               and rows_in > 0 and rows_out >= 0 else None)
        rate = (rows_out / wall_s
                if rows_out is not None and rows_out >= 0
                and wall_s and wall_s > 0 else None)
        with self._lock:
            k = (key, str(op), int(idx))
            ent = self._ops.get(k)
            if ent is None:
                ent = {"key": key, "op": str(op), "idx": int(idx),
                       "n": 0, "selectivity": None, "rows_per_s": None,
                       "rows_in": 0, "rows_out": 0, "wall_s": 0.0,
                       "updated": now}
                self._ops[k] = ent
                while len(self._ops) > max(self._capacity, 1):
                    self._ops.popitem(last=False)
            a = self._alpha
            if sel is not None:
                ent["selectivity"] = (sel if ent["selectivity"] is None
                                      else (1 - a) * ent["selectivity"]
                                      + a * sel)
            if rate is not None:
                ent["rows_per_s"] = (rate if ent["rows_per_s"] is None
                                     else (1 - a) * ent["rows_per_s"]
                                     + a * rate)
            ent["n"] += 1
            ent["rows_in"] += max(int(rows_in or 0), 0)
            ent["rows_out"] += max(int(rows_out or 0), 0)
            ent["wall_s"] += max(float(wall_s or 0.0), 0.0)
            ent["updated"] = now
            self._ops.move_to_end(k)
            self._seq += 1
            self._pending.append({
                "seq": self._seq, "key": key, "op": str(op),
                "idx": int(idx), "rows_in": int(rows_in or 0),
                "rows_out": int(rows_out or 0),
                "wall_s": float(wall_s or 0.0),
                "origin": origin or self.origin})
            LEARNED_STATS_SIZE.set(len(self._ops))
        LEARNED_STATS_OBSERVATIONS.inc(outcome=_outcome)

    def merge(self, observations: List[dict]) -> int:
        """Absorb observations exported by another process (worker
        task status riding back to the coordinator). Defensive: a
        malformed entry is skipped, never raises into the status
        path. Original origins are preserved in the pending ring, so
        a re-export through a shared-process relay still dedups at
        the true source."""
        n = 0
        for o in observations or ():
            try:
                if o.get("origin") == self.origin:
                    continue    # recorded by THIS registry already
                self.observe(str(o["key"]), str(o["op"]),
                             int(o.get("idx") or 0),
                             int(o.get("rows_in") or 0),
                             int(o.get("rows_out") or 0),
                             float(o.get("wall_s") or 0.0),
                             origin=str(o.get("origin") or ""),
                             _outcome="merged")
                n += 1
            except (KeyError, TypeError, ValueError):
                continue
        return n

    # -- delta transport -----------------------------------------------
    def seq(self) -> int:
        """Current observation sequence — the ``export_delta``
        baseline a worker snapshots before running a task."""
        with self._lock:
            return self._seq

    def export_delta(self, since: int) -> List[dict]:
        """Observations recorded after the ``since`` snapshot — the
        worker-side delta a task status ships back. Raw observations
        (not EMAs) keep the coordinator's merge additive: N statuses
        each contribute exactly the executions that happened, and the
        receiving registry applies its OWN smoothing."""
        with self._lock:
            return [dict(o) for o in self._pending
                    if o["seq"] > since]

    # -- read side -----------------------------------------------------
    def snapshot(self) -> List[dict]:
        """Every tracked operator's learned stats, most-recently
        observed first — the /v1/stats and
        system.runtime.operator_stats payload."""
        with self._lock:
            out = [dict(e) for e in self._ops.values()]
        out.reverse()
        return out

    def lookup(self, key: str, op: str, idx: int = 0) -> Optional[dict]:
        with self._lock:
            ent = self._ops.get((key, str(op), int(idx)))
            return dict(ent) if ent is not None else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ops)

    def clear(self) -> None:
        with self._lock:
            self._ops.clear()
            self._pending.clear()
            LEARNED_STATS_SIZE.set(0)

    # -- persistence ---------------------------------------------------
    def save(self, path: str) -> bool:
        """Persist the EMAs as JSON (atomic rename). Best-effort: an
        unwritable directory must never fail a query's terminal
        bookkeeping."""
        with self._lock:
            entries = [dict(e) for e in self._ops.values()]
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"entries": entries}, f)
            os.replace(tmp, path)
            return True
        except OSError:
            return False

    def load(self, path: str) -> int:
        """Absorb a saved snapshot: absent keys adopt the persisted
        EMAs wholesale (they ARE this registry's own prior state from
        before a restart); keys already live keep their fresher
        in-memory values."""
        try:
            with open(path) as f:
                entries = (json.load(f) or {}).get("entries") or []
        except (OSError, ValueError):
            return 0
        n = 0
        now = time.time()
        with self._lock:
            for e in entries:
                try:
                    k = (str(e["key"]), str(e["op"]),
                         int(e.get("idx") or 0))
                except (KeyError, TypeError, ValueError):
                    continue
                if k in self._ops:
                    continue
                self._ops[k] = {
                    "key": k[0], "op": k[1], "idx": k[2],
                    "n": max(int(e.get("n") or 0), 0),
                    "selectivity": e.get("selectivity"),
                    "rows_per_s": e.get("rows_per_s"),
                    "rows_in": max(int(e.get("rows_in") or 0), 0),
                    "rows_out": max(int(e.get("rows_out") or 0), 0),
                    "wall_s": max(float(e.get("wall_s") or 0.0), 0.0),
                    "updated": float(e.get("updated") or now)}
                n += 1
            while len(self._ops) > max(self._capacity, 1):
                self._ops.popitem(last=False)
            LEARNED_STATS_SIZE.set(len(self._ops))
        return n


# the process-wide registry (coordinator and worker alike: a worker
# observes what it executes and exports deltas via task status; the
# coordinator observes its local executions directly and merges
# worker deltas)
LEARNED_STATS = LearnedStatsRegistry()


def _session_allows(session) -> bool:
    try:
        return bool(session.get("learned_stats_enabled")) \
            if session is not None else True
    except KeyError:
        return True


def record_node_stats(plan_key: str, stats, session=None) -> int:
    """Executor-completion hook: fold one execution's per-operator
    NodeStats into the registry under ``plan_key``. Occurrence index
    disambiguates repeated operator names within one plan (same
    convention as exec/executor.py merge_node_stats). Gated per query
    by the ``learned_stats_enabled`` session property."""
    if not plan_key or not stats or not _session_allows(session):
        return 0
    seen: Dict[str, int] = {}
    n = 0
    for s in stats:
        name = getattr(s, "name", None)
        if name is None and isinstance(s, dict):
            name = s.get("name")
        if not name:
            continue
        idx = seen.get(name, 0)
        seen[name] = idx + 1
        if isinstance(s, dict):
            rows_in = int(s.get("input_rows", -1))
            rows_out = int(s.get("output_rows", -1))
            wall = float(s.get("wall_s", 0.0))
        else:
            rows_in = int(getattr(s, "input_rows", -1))
            rows_out = int(getattr(s, "output_rows", -1))
            wall = float(getattr(s, "wall_s", 0.0))
        LEARNED_STATS.observe(plan_key, str(name), idx,
                              rows_in, rows_out, wall)
        n += 1
    return n
