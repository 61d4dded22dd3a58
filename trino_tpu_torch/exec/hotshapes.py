"""Coordinator hot-shape registry: a ranked LRU of the program shapes
the cluster runs, the feed of the worker pre-warm.

Counterpart of ``trino_tpu/exec/hotshapes.py`` (host code, copied). The
JAX package pays 30-90 s of XLA compile per fragment shape, so WHICH
shapes a cluster runs is precious state there. The port compiles no
programs, but a fresh worker still pays on its first query: the CUDA
modules of the torch ops its path uses load, the caching allocator
sizes its pools, ``grouped_sums`` and the host codecs build or load.
The registry records every structural program shape a process runs
(canonical key from exec/progkey.py, input lane spec at its capacity
bucket), ranks entries by hit count with LRU recency as the tiebreak
and eviction order, and serves the top-K at ``GET /v1/hotshapes`` on
the coordinator. A joining worker pulls the list while it announces,
runs each shape's code path once on a fabricated batch on a background
thread (exec/aot.py), and then announces itself warm.

Workers feed the shapes they record back to the coordinator in the task
status (``hotShapes``, deltas since the task began), so the
coordinator's registry covers every dispatched fragment's shapes.

Kinds: ``chain`` / ``stream`` / ``stream_full`` (canonical fragment
programs), ``streamjoin`` (the streamed probe chunk), ``join`` (the
materialised hash join), ``window`` (one canonical WindowNode) and
``repartition`` (the exchange bucketing, signature only).

The registry is mutated by query threads, task threads and HTTP handler
threads at once: every method takes the registry lock."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch

from ..config import CONFIG
from ..obs.metrics import METRICS

_M_RECORDS = METRICS.counter(
    "trino_tpu_hot_shapes_recorded_total",
    "Hot-shape registry records by outcome",
    ("outcome",))           # new | hit | merged | unsupported
_M_SIZE = METRICS.gauge(
    "trino_tpu_hot_shapes",
    "Program shapes currently tracked by the hot-shape registry")

# registry entries a pathological query may create: past this budget a
# query keeps HITTING existing entries but registers no new ones (a
# generated-SQL storm of one-off shapes must not evict the fleet's
# genuinely hot programs). Session-gated per query (prewarm_enabled /
# hot_shape_top_k, session.py).
_BUDGET_ATTR = "_hot_shapes_recorded"


class HotShapeRegistry:
    """Ranked LRU of (canonical key -> warm-up payload) entries."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        import uuid
        self._lock = threading.Lock()
        self._capacity = (capacity if capacity is not None
                          else CONFIG.hot_shape_entries)
        # key -> entry dict; OrderedDict end == most recently touched
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._seq = 0
        # identity stamped on exported deltas: when a worker shares
        # the process (and therefore THIS registry) with the scheduler
        # — single-host runners, tests, the bench fault/mpp legs —
        # merging its status delta back in would double-count every
        # worker-side sighting. merge() drops self-originated entries.
        self.origin = uuid.uuid4().hex[:12]

    # -- write side ----------------------------------------------------
    def record(self, kind: str, key: str,
               payload_fn: Callable[[], Optional[dict]],
               hits: int = 1) -> Optional[str]:
        """Count a sighting of ``key``; on first sight materialize the
        warm-up payload (``payload_fn`` returns None for shapes the
        warm-up cannot rebuild — oversized dictionaries, nested columns —
        which are not registered at all). Returns "new" when this call
        created the entry, "hit" when it re-ranked an existing one,
        None when the shape is unsupported."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                ent["hits"] += hits
                self._seq += 1
                ent["seq"] = self._seq
                self._entries.move_to_end(key)
                _M_RECORDS.inc(outcome="hit")
                return "hit"
        # payload built OUTSIDE the lock: serde encoding walks the
        # whole canonical fragment
        payload = payload_fn()
        if payload is None:
            _M_RECORDS.inc(outcome="unsupported")
            return None
        with self._lock:
            ent = self._entries.get(key)
            self._seq += 1
            if ent is not None:         # raced another recorder
                ent["hits"] += hits
                ent["seq"] = self._seq
                self._entries.move_to_end(key)
                _M_RECORDS.inc(outcome="hit")
                return "hit"
            new_ent = {"kind": kind, "key": key,
                       "hits": hits, "seq": self._seq,
                       "payload": payload}
            self._entries[key] = new_ent
            while len(self._entries) > max(self._capacity, 1):
                # rank-aware eviction: coldest (fewest hits), oldest-
                # touched among ties — never the entry just admitted
                # (every newcomer starts at 1 hit and would otherwise
                # evict itself, starving the registry of fresh shapes)
                victims = [e for e in self._entries.values()
                           if e is not new_ent]
                if not victims:
                    break
                v = min(victims, key=lambda e: (e["hits"], e["seq"]))
                del self._entries[v["key"]]
            _M_RECORDS.inc(outcome="new")
            _M_SIZE.set(len(self._entries))
            return "new"

    def merge(self, entries: List[dict]) -> int:
        """Absorb entries exported by another process (worker task
        status riding back to the coordinator). Defensive: a malformed
        entry is skipped, never raises into the status path."""
        n = 0
        for e in entries or ():
            try:
                if e.get("origin") == self.origin:
                    # exported from THIS registry (in-process worker):
                    # the sighting is already counted here
                    continue
                kind = str(e["kind"])
                key = str(e["key"])
                hits = max(int(e.get("hits") or 1), 1)
                payload = e["payload"]
                if not isinstance(payload, dict):
                    continue
            except (KeyError, TypeError, ValueError):
                continue
            if self.record(kind, key, lambda p=payload: p, hits=hits):
                _M_RECORDS.inc(outcome="merged")
                n += 1
        return n

    # -- read side -----------------------------------------------------
    def top(self, k: int) -> List[dict]:
        """The k hottest shapes: hit count desc, recency desc as the
        tiebreak — what a joining worker should warm first."""
        with self._lock:
            ranked = sorted(self._entries.values(),
                            key=lambda e: (-e["hits"], -e["seq"]))
            return [dict(e) for e in ranked[:max(int(k), 0)]]

    def hit_counts(self) -> Dict[str, int]:
        """Per-key hit snapshot — the baseline for ``export_delta``."""
        with self._lock:
            return {k: e["hits"] for k, e in self._entries.items()}

    def export_delta(self, before: Dict[str, int]) -> List[dict]:
        """Entries whose hit count GREW since the ``before`` snapshot,
        carrying only the growth as their ``hits`` — the worker-side
        delta a task status ships back. Shipping deltas (not
        cumulative counts) keeps the coordinator's ranking additive:
        N statuses each reporting the same entry contribute exactly
        the sightings that happened, never re-count earlier ones."""
        with self._lock:
            out = []
            for k, e in self._entries.items():
                grown = e["hits"] - before.get(k, 0)
                if grown > 0:
                    ent = dict(e)
                    ent["hits"] = grown
                    ent["origin"] = self.origin
                    out.append(ent)
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            _M_SIZE.set(0)


# the process-wide registry (coordinator and worker alike: a worker
# records what it runs and exports deltas via task status; the
# coordinator records its root-stage programs directly and merges
# worker deltas)
HOT_SHAPES = HotShapeRegistry()


def _session_allows(session) -> bool:
    try:
        return bool(session.get("prewarm_enabled")) \
            if session is not None else True
    except KeyError:
        return True


def _session_budget(session) -> int:
    try:
        return int(session.get("hot_shape_top_k")) \
            if session is not None else CONFIG.prewarm_top_k
    except KeyError:
        return CONFIG.prewarm_top_k


def record_program(kind: str, cache_key, canon, batch,
                   session, payload_fn=None) -> None:
    """Executor hook: count a structural-program sighting and (first
    time) capture its warm-up payload from the canonical input batch.
    ``cache_key`` is the program's canonical key (exec/progkey.py, the
    key the JAX package's compiled-program caches use; the registry
    keys on its repr). Gated per query by the ``prewarm_enabled``
    session property, with ``hot_shape_top_k`` as the query's new-entry
    budget. ``payload_fn`` overrides the default chain/stream payload
    builder for kinds with their own transport form (joins,
    repartition)."""
    if not _session_allows(session):
        return
    # the budget is PER QUERY: keyed by the session's current query id
    # (runner/coordinator stamp one per execution), so a long-lived
    # session keeps contributing new shapes query after query instead
    # of going silent once its first queries spent the counter
    used = 0
    qid = None
    if session is not None:
        qid = getattr(session, "query_id", "") or ""
        state = getattr(session, _BUDGET_ATTR, None)
        if isinstance(state, tuple) and state[0] == qid:
            used = state[1]
    budget = _session_budget(session)

    def build() -> Optional[dict]:
        if session is not None and used >= budget:
            return None         # budget spent: hit-count only
        if payload_fn is not None:
            return payload_fn()
        return build_payload(kind, canon, batch)

    outcome = HOT_SHAPES.record(kind, repr(cache_key), build)
    if outcome == "new" and session is not None:
        try:
            setattr(session, _BUDGET_ATTR, (qid, used + 1))
        except AttributeError:      # frozen/foreign session object
            pass


def record_canonical(kind: str, canon, batch, session,
                     key=None) -> None:
    """``record_program`` for a canonical program over ``batch`` (renamed
    to the program's canonical columns), keyed by its canonical key
    unless ``key`` is given."""
    record_program(kind, canon.key if key is None else key, canon,
                   canon.binding(batch).rename_in(batch), session)


# dictionaries above this entry count are not serialized into the
# registry (the payload would ship a whole string pool per shape);
# such shapes stay un-prewarmable rather than bloating the feed
MAX_DICT_ENTRIES = 64


def lane_dtype(t: torch.Tensor) -> str:
    """A lane's dtype under numpy's name (the payload's spelling, the
    JAX package's too)."""
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def lane_spec(batch) -> Optional[List[dict]]:
    """Per column: name, dtype, validity and high-lane presence, and a
    small dictionary's values; None when a column is nested or its
    dictionary is too large to ship."""
    cols = []
    for name, c in batch.columns.items():
        if c.elements is not None or c.elements2 is not None \
                or c.children is not None:
            return None
        ent: Dict[str, object] = {
            "name": name,
            "dtype": lane_dtype(c.data),
            "valid": c.valid is not None,
            "data2": None if c.data2 is None else lane_dtype(c.data2),
        }
        if c.dictionary is not None:
            vals = list(c.dictionary.values)
            if len(vals) > MAX_DICT_ENTRIES:
                return None
            ent["dict"] = [None if v is None else str(v) for v in vals]
        cols.append(ent)
    return cols


def num_rows_kind(batch) -> str:
    return ("int" if isinstance(batch.num_rows, int)
            else lane_dtype(batch.num_rows))


def build_payload(kind: str, canon, batch) -> Optional[dict]:
    """The warm-up transport form of one program shape: the canonical
    fragment (plan/serde wire JSON) and the observed input lane spec at
    its capacity bucket. None when the input holds lanes the warm-up
    cannot fabricate (nested ARRAY/MAP/ROW columns, large
    dictionaries)."""
    cols = lane_spec(batch)
    if cols is None:
        return None
    schema = {name: c.type for name, c in batch.columns.items()}
    return {"kind": kind,
            "fragment": canon.wire_fragment(schema),
            "cols": cols,
            "capacity": int(batch.capacity),
            "num_rows": num_rows_kind(batch)}


def join_payload(jt: str, criteria, residual, probe, build, out_cap: int,
                 kind: str) -> Optional[dict]:
    """Warm-up transport form of one hash join: the join shape as a wire
    fragment (a JoinNode over two schema-carrying RemoteSource leaves,
    ``filter`` holding the full residual with the hash-verify conjuncts)
    and both sides' lane specs at their capacities. ``kind`` is
    "streamjoin" (a streamed probe chunk) or "join" (the materialised
    join, ``probe`` the whole probe side)."""
    from ..plan.nodes import JoinNode, RemoteSourceNode
    from ..plan.serde import to_jsonable
    pcols, bcols = lane_spec(probe), lane_spec(build)
    if pcols is None or bcols is None:
        return None
    frag = JoinNode(RemoteSourceNode((), probe.schema(), "gather"),
                    RemoteSourceNode((), build.schema(), "gather"),
                    jt, tuple(criteria), residual)
    return {"kind": kind,
            "fragment": to_jsonable(frag),
            "probe_cols": pcols, "build_cols": bcols,
            "chunk_capacity": int(probe.capacity),
            "build_capacity": int(build.capacity),
            "probe_num_rows": num_rows_kind(probe),
            "build_num_rows": num_rows_kind(build),
            "out_capacity": int(out_cap)}


def join_key(kind: str, jt: str, criteria, residual, probe, build,
             out_cap: int) -> tuple:
    """The registry key of a join program: its keys, residual, both
    sides' lane specs and the capacities."""
    def spec(b):
        return tuple((n, str(c.data.dtype), c.valid is not None,
                      c.data2 is not None, c.dictionary is not None)
                     for n, c in b.columns.items())
    return (kind, jt, tuple(c.left for c in criteria),
            tuple(c.right for c in criteria), repr(residual), spec(probe),
            spec(build), int(probe.capacity), int(build.capacity),
            int(out_cap))
