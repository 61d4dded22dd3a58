"""Query lifecycle event system.

Counterpart of ``trino_tpu/server/events.py`` (host only).

Reference parity: spi/eventlistener/ (EventListener.java, QueryCreated /
QueryCompleted / SplitCompleted event classes — 19 files),
event/QueryMonitor.java:88,130,206 (builds and emits the events),
eventlistener/EventListenerManager.java (fan-out to registered
listeners). Listener exceptions are swallowed — an audit hook must not
fail queries (same contract as the reference)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass(frozen=True)
class QueryCreatedEvent:
    """spi/eventlistener/QueryCreatedEvent.java"""
    query_id: str
    sql: str
    user: str
    catalog: Optional[str]
    schema: Optional[str]
    create_time: float = field(default_factory=time.time)


@dataclass(frozen=True)
class QueryCompletedEvent:
    """spi/eventlistener/QueryCompletedEvent.java — including the
    QueryStatistics block (peakUserMemoryBytes, spilledBytes,
    operatorSummaries) so listeners can act as an audit/accounting
    sink, not just a lifecycle log."""
    query_id: str
    sql: str
    user: str
    state: str                    # FINISHED | FAILED | CANCELED
    wall_s: float
    rows: int = 0
    error_name: Optional[str] = None
    error_message: Optional[str] = None
    end_time: float = field(default_factory=time.time)
    # QueryStatistics analog (spi/eventlistener/QueryStatistics.java)
    peak_memory_bytes: int = 0
    spill_bytes: int = 0
    # cumulative operator flow: {"input_rows", "output_rows",
    # "output_bytes", "compile_s", "wall_s"} summed over NodeStats
    cumulative_operator_stats: Optional[dict] = None
    # per-operator summaries, one dict per plan node (NodeStats.to_dict)
    operator_summaries: tuple = ()


@dataclass(frozen=True)
class SplitCompletedEvent:
    """spi/eventlistener/SplitCompletedEvent.java"""
    query_id: str
    split_id: str
    wall_s: float


class EventListener:
    """spi/eventlistener/EventListener.java — subclass and override."""

    def query_created(self, event: QueryCreatedEvent) -> None:
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        pass

    def split_completed(self, event: SplitCompletedEvent) -> None:
        pass


class EventListenerManager:
    """eventlistener/EventListenerManager.java — registration + fan-out;
    listener errors are logged-and-dropped, never propagated."""

    def __init__(self):
        self._listeners: List[EventListener] = []

    def add_listener(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def _fan_out(self, method: str, event) -> None:
        for listener in self._listeners:
            try:
                getattr(listener, method)(event)
            except Exception:
                pass

    def query_created(self, event: QueryCreatedEvent) -> None:
        self._fan_out("query_created", event)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        self._fan_out("query_completed", event)

    def split_completed(self, event: SplitCompletedEvent) -> None:
        self._fan_out("split_completed", event)
