"""Hierarchical resource groups: admission control for query dispatch.

Counterpart of ``trino_tpu/server/resourcegroups.py`` (host only).

Reference parity: execution/resourcegroups/InternalResourceGroup.java
(hard_concurrency / max_queued enforcement, subgroup trees, fair and
weighted_fair scheduling) + InternalResourceGroupManager +
spi/resourcegroups (SelectionCriteria) + the file-based config plugin
(plugin/trino-resource-group-managers). Redesigned small: groups are an
explicit tree of ``ResourceGroup``s; selectors match (user, source) to a
leaf; a leaf admits a query immediately (below hard_concurrency), queues
it (below max_queued), or rejects it. Limits aggregate up the tree —
a query runs only if EVERY ancestor has capacity, exactly the
reference's canRunMore recursion."""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..obs.metrics import QUERY_QUEUED_SECONDS, QUEUE_REJECTIONS


class QueryQueueFullError(Exception):
    """StandardErrorCode.QUERY_QUEUE_FULL (Appendix A.8).
    ``error_name`` feeds errors.classify so the rejection reaches the
    client with the Trino name + INSUFFICIENT_RESOURCES type instead
    of a generic failure."""

    error_name = "QUERY_QUEUE_FULL"


@dataclass
class ResourceGroup:
    """One node of the group tree (InternalResourceGroup.java)."""
    name: str
    hard_concurrency: int = 100
    max_queued: int = 1000
    scheduling_weight: int = 1
    # per-group memory budget for the cluster pool (server/memory.py):
    # when the group's aggregate reservation exceeds it, the
    # low-memory killer cancels the group's largest query. 0 = none.
    soft_memory_limit_bytes: int = 0
    parent: Optional["ResourceGroup"] = None
    children: Dict[str, "ResourceGroup"] = field(default_factory=dict)

    # runtime state
    running: int = 0
    # (tag, start_fn, enqueued_at) — the timestamp feeds the
    # queued-time histogram at dequeue
    _queue: Deque[Tuple[object, Callable[[], None], float]] = \
        field(default_factory=deque)

    @property
    def full_name(self) -> str:
        if self.parent is None:
            return self.name
        return f"{self.parent.full_name}.{self.name}"

    def add(self, child: "ResourceGroup") -> "ResourceGroup":
        child.parent = self
        self.children[child.name] = child
        return child

    # --- admission (called under the manager lock) -----------------------
    def _can_run_more(self) -> bool:
        g: Optional[ResourceGroup] = self
        while g is not None:
            if g.running >= g.hard_concurrency:
                return False
            g = g.parent
        return True

    def _start(self) -> None:
        g: Optional[ResourceGroup] = self
        while g is not None:
            g.running += 1
            g = g.parent

    def _finish_one(self) -> None:
        g: Optional[ResourceGroup] = self
        while g is not None:
            g.running = max(0, g.running - 1)
            g = g.parent

    def queued(self) -> int:
        return len(self._queue)


class ResourceGroupManager:
    """InternalResourceGroupManager: selector routing + dispatch.

    ``submit(session_user, source, start_fn)`` either calls start_fn
    immediately, enqueues it for later, or raises QueryQueueFullError.
    ``query_finished(group)`` releases the slot and starts the next
    queued query (weighted-fair across sibling leaves: the eligible leaf
    with the smallest running/weight ratio dequeues first — the
    WeightedFairQueue policy)."""

    def __init__(self, root: Optional[ResourceGroup] = None):
        self.root = root or ResourceGroup("global")
        self._selectors: List[Tuple[Optional[re.Pattern],
                                    Optional[re.Pattern],
                                    ResourceGroup]] = []
        self._lock = threading.Lock()

    # --- configuration ---------------------------------------------------
    def add_selector(self, group: ResourceGroup,
                     user_regex: Optional[str] = None,
                     source_regex: Optional[str] = None) -> None:
        self._selectors.append(
            (re.compile(user_regex) if user_regex else None,
             re.compile(source_regex) if source_regex else None,
             group))

    @staticmethod
    def from_config(config: dict) -> "ResourceGroupManager":
        """Build from a dict mirroring the file-based manager's JSON
        (resource-group-managers file plugin): {"rootGroups": [...],
        "selectors": [{"user": "...", "group": "a.b"}]}."""
        mgr = ResourceGroupManager()

        def build(spec: dict, parent: ResourceGroup) -> None:
            g = parent.add(ResourceGroup(
                spec["name"],
                hard_concurrency=spec.get("hardConcurrencyLimit", 100),
                max_queued=spec.get("maxQueued", 1000),
                scheduling_weight=spec.get("schedulingWeight", 1),
                soft_memory_limit_bytes=int(
                    spec.get("softMemoryLimitBytes", 0))))
            for sub in spec.get("subGroups", []):
                build(sub, g)

        for spec in config.get("rootGroups", []):
            build(spec, mgr.root)
        for sel in config.get("selectors", []):
            g = mgr.root
            for part in sel["group"].split("."):
                g = g.children[part]
            mgr.add_selector(g, sel.get("user"), sel.get("source"))
        return mgr

    # --- routing ---------------------------------------------------------
    def select(self, user: str, source: str = "") -> ResourceGroup:
        for urx, srx, group in self._selectors:
            if urx is not None and not urx.fullmatch(user or ""):
                continue
            if srx is not None and not srx.fullmatch(source or ""):
                continue
            return group
        return self.root

    # --- dispatch --------------------------------------------------------
    def submit(self, user: str, source: str,
               start_fn: Callable[[ResourceGroup], None],
               tag: object = None) -> Tuple[ResourceGroup, bool]:
        """Returns (group, started). ``start_fn(group)`` receives the
        admitting group BEFORE any query work can begin — the caller
        must record it before launching the query thread, else a
        fast-finishing query races the assignment and leaks the
        concurrency slot. When not started, the query is queued and
        start_fn fires on a later query_finished."""
        with self._lock:
            group = self.select(user, source)
            if group._can_run_more():
                group._start()
                started = True
            elif group.queued() >= group.max_queued:
                QUEUE_REJECTIONS.inc()
                raise QueryQueueFullError(
                    f"Too many queued queries for "
                    f"\"{group.full_name}\"")
            else:
                group._queue.append((tag, start_fn, time.monotonic()))
                started = False
        if started:
            start_fn(group)
        return group, started

    def remove_queued(self, tag: object) -> bool:
        """Withdraw a still-queued query (deadline-killed or canceled
        before admission). Without this a dead entry keeps consuming
        ``max_queued`` capacity until some completion dequeues it —
        and then burns a real concurrency slot starting a query that
        will never run."""
        with self._lock:
            for g in self._walk(self.root):
                for item in g._queue:
                    if item[0] == tag:
                        g._queue.remove(item)
                        return True
        return False

    def query_finished(self, group: ResourceGroup) -> None:
        to_start: List[Tuple[Callable, ResourceGroup]] = []
        with self._lock:
            group._finish_one()
            # weighted-fair pick among leaves with queued work, lowest
            # running/weight first (WeightedFairQueue.java); within a
            # leaf the queue drains FIFO — arrival order is the
            # fairness contract queued clients observe
            while True:
                candidates = [g for g in self._walk(self.root)
                              if g.queued() and g._can_run_more()]
                if not candidates:
                    break
                g = min(candidates,
                        key=lambda x: x.running / max(
                            x.scheduling_weight, 1))
                _, fn, enq = g._queue.popleft()
                QUERY_QUEUED_SECONDS.observe(time.monotonic() - enq)
                g._start()
                to_start.append((fn, g))
        for fn, g in to_start:
            fn(g)

    def _walk(self, g: ResourceGroup):
        yield g
        for c in g.children.values():
            yield from self._walk(c)

    def info(self) -> List[dict]:
        """system.runtime-style group states (ResourceGroupInfo)."""
        with self._lock:
            return [{"name": g.full_name, "running": g.running,
                     "queued": g.queued(),
                     "hardConcurrencyLimit": g.hard_concurrency,
                     "maxQueued": g.max_queued,
                     "softMemoryLimitBytes": g.soft_memory_limit_bytes}
                    for g in self._walk(self.root)]
