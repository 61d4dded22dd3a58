"""The scan cache: table lanes kept in device memory across queries.

Counterpart of the scan-cache half of ``trino_tpu/exec/executor.py``
(``read_split_cached``, ``cache_memory_bytes``, ``evict_cache_pressure``,
``_whole_table_mode``, ``read_table_cached``). The tpch and tpcds
generators are deterministic (``scan_cache_ok``), so a split's lanes can
stay on the device and serve every later scan of the same split:

- per split and per column: overlapping projections of one split share
  one copy of each column;
- whole table (on a card only, ``_whole_table_mode``): every split of
  the table concatenated once into one batch, cached under part -1; it
  supersedes the table's per-split entries.

The cache is bounded by ``CONFIG.scan_cache_bytes`` and evicts in
insertion order. It is keyed weakly by the connector object: each
``LocalQueryRunner`` builds its own connectors, and when a runner is
gone its cached lanes go with it. ``torch.cuda.max_memory_allocated``
counts the cached lanes.

Memory governance reads ``cache_memory_bytes`` (this cache and the
coordinator's result cache, exec/resultcache.py) and sheds both through
``evict_cache_pressure``; the port has no compiled-program caches to
shed. The counters of ``STATS`` move under the cache's lock, so query
threads of one coordinator count alike.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

import torch

from ..columnar import Batch, Column
from ..config import CONFIG
from ..obs.metrics import METRICS

# the same lookups on the process registry (/metrics), under the JAX
# engine's family; a bypass counts as result "bypass"
_M_SCAN = METRICS.counter(
    "trino_tpu_scan_cache_total",
    "HBM-resident scan cache lookups by granularity and outcome",
    ("cache", "result"))
# the bytes each connector's cache holds, set wherever they change
_M_SCAN_BYTES = METRICS.gauge(
    "trino_tpu_scan_cache_bytes",
    "Bytes of table lanes resident in the scan cache", ("connector",))

_SCAN_CACHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SCAN_CACHE_LOCK = threading.Lock()

# lookups by result, summed over every connector ("split" and "table"
# reads; a hit serves the read from the cache; a bypass is a split read
# directly because its whole scan could never fit the cache)
STATS: Dict[str, int] = {"split_hit": 0, "split_miss": 0,
                         "split_bypass": 0, "table_hit": 0,
                         "table_miss": 0}


def col_bytes(c: Column) -> int:
    return sum(t.nelement() * t.element_size()
               for t in (c.data, c.valid, c.data2) if t is not None)


def _state(conn) -> dict:
    state = _SCAN_CACHES.get(conn)
    if state is None:
        state = {"entries": {}, "order": [], "bytes": 0,
                 "label": getattr(conn, "name", type(conn).__name__)}
        _SCAN_CACHES[conn] = state
    return state


def _add_bytes(state: dict, delta: int) -> None:
    state["bytes"] += delta
    _M_SCAN_BYTES.set(state["bytes"], connector=state["label"])


def _drop(state: dict, key) -> int:
    """Evict one entry; its bytes."""
    state["order"].remove(key)
    old = state["entries"].pop(key)
    size = sum(col_bytes(c) for c in old["cols"].values())
    _add_bytes(state, -size)
    return size


def _drop_oldest(state: dict) -> int:
    return _drop(state, state["order"][0])


def _insert(state: dict, key, batch: Batch) -> None:
    """Add ``batch``'s columns under ``key``, evicting the oldest entries
    until they fit."""
    size = sum(col_bytes(c) for c in batch.columns.values())
    while state["bytes"] + size > CONFIG.scan_cache_bytes \
            and state["order"]:
        _drop_oldest(state)
    entry = state["entries"].get(key)
    if entry is None:
        entry = {"cols": {}, "num_rows": batch.num_rows}
        state["entries"][key] = entry
        state["order"].append(key)
    for name, col in batch.columns.items():
        if name not in entry["cols"]:
            entry["cols"][name] = col
            _add_bytes(state, col_bytes(col))


def _lookup(state: Optional[dict], key, columns) -> Optional[Batch]:
    entry = state["entries"].get(key) if state else None
    if entry is None or any(c not in entry["cols"] for c in columns):
        return None
    return Batch({c: entry["cols"][c] for c in columns},
                 entry["num_rows"])


def _missing(state: Optional[dict], key, columns):
    entry = state["entries"].get(key) if state else None
    return [c for c in columns if entry is None or c not in entry["cols"]]


def _scan_fits(conn, handle, n_columns: int) -> bool:
    """Whether the whole scan of ``n_columns`` columns could fit the
    cache: rows x columns x 9 bytes (data and validity) from the table's
    row count, an upper bound under a pushed-down constraint. Without a
    row count the split is cached."""
    rows = (conn.table_row_count(handle)
            if hasattr(conn, "table_row_count") else None)
    return not rows or \
        int(rows) * max(n_columns, 1) * 9 <= CONFIG.scan_cache_bytes


def read_split_cached(conn, split, columns) -> Batch:
    """A split read through the connector's cache, per (split, column).
    A connector that is not deterministic, or a budget of 0, reads
    directly; so does a scan too large for the cache as a whole, whose
    splits would only evict one another (and every other table) before
    a later scan could hit them."""
    if not getattr(conn, "scan_cache_ok", False) \
            or CONFIG.scan_cache_bytes <= 0:
        return conn.read_split(split, columns)
    h = split.handle
    if not _scan_fits(conn, h, len(columns)):
        with _SCAN_CACHE_LOCK:
            STATS["split_bypass"] += 1
        _M_SCAN.inc(cache="split", result="bypass")
        return conn.read_split(split, columns)
    skey = (h.schema, h.table, split.part, split.part_count,
            h.constraint, h.limit)
    with _SCAN_CACHE_LOCK:
        state = _SCAN_CACHES.get(conn)
        hit = _lookup(state, skey, columns)
        missing = _missing(state, skey, columns)
        STATS["split_hit" if hit is not None else "split_miss"] += 1
    _M_SCAN.inc(cache="split", result="miss" if hit is None else "hit")
    if hit is not None:
        return hit
    raw = conn.read_split(split, missing)
    size = sum(col_bytes(c) for c in raw.columns.values())
    with _SCAN_CACHE_LOCK:
        state = _state(conn)
        if size <= CONFIG.scan_cache_bytes:
            _insert(state, skey, raw)
        got = _lookup(state, skey, columns)
    if got is not None:
        return got
    # the cache cannot hold this split: serve the direct read
    if all(c in raw.columns for c in columns):
        return raw.select_columns(list(columns))
    return conn.read_split(split, columns)


def cache_memory_bytes() -> int:
    """Bytes the shared caches hold: the scan caches across every live
    connector, and the result cache's host rows (process memory the
    pressure ladder can shed, so governance must see it)."""
    from .resultcache import RESULT_CACHE
    with _SCAN_CACHE_LOCK:
        scan = sum(int(state["bytes"]) for state in _SCAN_CACHES.values())
    return scan + RESULT_CACHE.bytes()


def evict_cache_pressure(need_bytes: int) -> int:
    """Shed cache entries, oldest first, until ``need_bytes`` are freed
    or the caches are empty: the scan caches first, then the result
    cache. Returns the bytes freed."""
    from ..obs.metrics import CACHE_PRESSURE_EVICTS
    from .resultcache import RESULT_CACHE
    need = max(int(need_bytes), 0)
    freed = 0
    with _SCAN_CACHE_LOCK:
        for state in list(_SCAN_CACHES.values()):
            while state["order"] and freed < need:
                freed += _drop_oldest(state)
                CACHE_PRESSURE_EVICTS.inc(cache="scan")
            if freed >= need:
                break
    if freed < need:
        before = len(RESULT_CACHE)
        freed += RESULT_CACHE.evict(need - freed)
        for _ in range(before - len(RESULT_CACHE)):
            CACHE_PRESSURE_EVICTS.inc(cache="result")
    return freed


def clear() -> None:
    """Empty every scan cache."""
    with _SCAN_CACHE_LOCK:
        for state in _SCAN_CACHES.values():
            _add_bytes(state, -state["bytes"])
        _SCAN_CACHES.clear()


def _whole_table_mode(device: torch.device) -> bool:
    """Whole-table residency: on for a card, where a dispatch per split
    costs more than the scan's compute; off on the CPU, where split by
    split keeps the working set small (as the JAX engine's "auto")."""
    return device.type == "cuda"


def read_table_cached(conn, handle, columns, par,
                      device: torch.device) -> Optional[Batch]:
    """A whole-table read through the cache: all splits concatenated
    once into one batch cached under part -1, so a later scan of the
    table is a lookup. None when the mode is off or the table does not
    fit the budget (the caller reads split by split)."""
    if not columns or not getattr(conn, "scan_cache_ok", False) \
            or CONFIG.scan_cache_bytes <= 0 \
            or not _whole_table_mode(device):
        return None
    from .executor import device_concat
    h = handle
    wkey = (h.schema, h.table, -1, 0, h.constraint, h.limit)
    with _SCAN_CACHE_LOCK:
        state = _SCAN_CACHES.get(conn)
        hit = _lookup(state, wkey, columns)
        missing = _missing(state, wkey, columns)
        STATS["table_hit" if hit is not None else "table_miss"] += 1
    _M_SCAN.inc(cache="table", result="miss" if hit is None else "hit")
    if hit is not None:
        return hit
    # an over-budget table is never materialised just to find out that
    # it does not fit: estimate the missing columns from the row count
    est_rows = (conn.table_row_count(h)
                if hasattr(conn, "table_row_count") else None)
    if est_rows:
        est = int(est_rows) * max(len(missing), 1) * 9  # data 8 + valid 1
        if 2 * est > CONFIG.scan_cache_bytes:
            return None
    splits = conn.get_splits(h, par)
    if len(splits) == 1:
        return read_split_cached(conn, splits[0], columns)
    parts = [read_split_cached(conn, s, missing) for s in splits]
    total_bytes = sum(col_bytes(c) for b in parts
                      for c in b.columns.values())
    # the concatenation pads to the next capacity bucket: budget 2x
    if 2 * total_bytes > CONFIG.scan_cache_bytes:
        return None
    whole = device_concat(parts)
    del parts
    with _SCAN_CACHE_LOCK:
        state = _state(conn)
        for k in [k for k in state["order"]
                  if k[:2] == (h.schema, h.table) and k[2] >= 0]:
            _drop(state, k)
        _insert(state, wkey, whole)
        got = _lookup(state, wkey, columns)
    # None: the budget evicted this entry while inserting it
    return got
