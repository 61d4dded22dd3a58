"""Per-query trace: a span tree with real span identity.

Counterpart of ``trino_tpu/obs/trace.py`` (host only). A ``QueryTrace``
rides on the Session: the runner opens parse, plan, optimize and
execute spans, the executor a ``node.<Name>`` span around each plan node
and a ``device_wait`` span around each place its thread blocks on the
card (``device_wait``), and EXPLAIN ANALYZE and /v1/query render them.
Every span carries a 128-bit trace id and a 64-bit span id, and a W3C
``traceparent`` names them, so a worker's subtree can later merge back
id-preserving (``graft``).

Concurrency: the open-span stack is per thread (``threading.local``);
cross-thread attachment is explicit through ``parent=``. The lock only
guards child-list appends.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def new_trace_id() -> str:
    """128-bit W3C trace id (32 lowercase hex chars)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit W3C span id (16 lowercase hex chars)."""
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C Trace Context header value (version 00, sampled)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: object) -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) from a ``traceparent`` value, or
    None when malformed — propagation is best-effort, a corrupt header
    must never fail a task."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


@dataclass
class Span:
    name: str
    start_s: float                      # perf_counter at open
    end_s: Optional[float] = None       # perf_counter at close
    attrs: Dict[str, object] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)
    # identity (the distributed half): 64-bit span id, minted at
    # creation or preserved off the wire; parent_id is only stored for
    # REMOTE parents (a local parent is the tree edge itself)
    span_id: str = field(default_factory=new_span_id)
    parent_id: Optional[str] = None
    # absolute wall-clock anchors (unix nanos), preserved across the
    # wire so a worker span keeps ITS host's clock instead of being
    # rebased onto the coordinator's — the id-preserving merge is also
    # a clock-preserving one
    start_unix_ns: Optional[int] = None
    end_unix_ns: Optional[int] = None

    @property
    def wall_s(self) -> float:
        return (self.end_s or self.start_s) - self.start_s

    def to_dict(self, origin_s: float,
                origin_unix_ns: Optional[int] = None) -> dict:
        d = {"name": self.name,
             "startMillis": round((self.start_s - origin_s) * 1000, 3),
             "wallMillis": round(self.wall_s * 1000, 3),
             "spanId": self.span_id}
        if self.parent_id:
            d["parentSpanId"] = self.parent_id
        start_ns = self.start_unix_ns
        if start_ns is None and origin_unix_ns is not None:
            start_ns = origin_unix_ns + int(
                (self.start_s - origin_s) * 1e9)
        if start_ns is not None:
            d["startUnixNanos"] = int(start_ns)
            end_ns = self.end_unix_ns
            if end_ns is None:
                end_ns = start_ns + int(self.wall_s * 1e9)
            d["endUnixNanos"] = int(end_ns)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict(origin_s, origin_unix_ns)
                             for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: dict, origin_s: float = 0.0) -> "Span":
        start = origin_s + d.get("startMillis", 0.0) / 1000.0
        sp = cls(d.get("name", "?"), start,
                 start + d.get("wallMillis", 0.0) / 1000.0,
                 dict(d.get("attrs", {})))
        sid = d.get("spanId")
        if sid:
            sp.span_id = str(sid)
        pid = d.get("parentSpanId")
        if pid:
            sp.parent_id = str(pid)
        if d.get("startUnixNanos") is not None:
            sp.start_unix_ns = int(d["startUnixNanos"])
        if d.get("endUnixNanos") is not None:
            sp.end_unix_ns = int(d["endUnixNanos"])
        sp.children = [cls.from_dict(c, origin_s)
                       for c in d.get("children", [])]
        return sp


class QueryTrace:
    """The span tree of one query. ``span(name)`` is a context manager
    nesting under the calling THREAD's innermost open span (explicit
    ``parent=`` overrides); ``record``/``graft`` attach pre-timed
    spans (worker-reported subtrees arrive whole, ids intact). Born
    with a 128-bit trace id — or, on a worker, with the QUERY's trace
    id and the dispatching span's id from the ``traceparent`` the task
    payload carried, so every span this trace mints already belongs to
    the distributed trace."""

    def __init__(self, query_id: str = "",
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None):
        self.query_id = query_id
        self.trace_id = trace_id or new_trace_id()
        # the REMOTE parent: root spans opened here carry it as their
        # parentSpanId, which is what makes the coordinator-side merge
        # id-preserving instead of positional
        self.parent_span_id = parent_span_id
        self.origin_s = time.perf_counter()
        self.origin_unix_ns = time.time_ns()
        self.roots: List[Span] = []
        self._tls = threading.local()   # per-thread open-span stack
        self._lock = threading.Lock()

    # -- clock mapping -------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []  # tt-lint: ignore[race-attr-write] threading.local attribute: each thread writes its OWN slot by construction — thread isolation is the whole point
        return st

    def perf_from_unix_ns(self, ns: int) -> float:
        """Map an absolute unix-nanos timestamp onto this trace's
        perf_counter timebase (the rendering clock)."""
        return self.origin_s + (ns - self.origin_unix_ns) / 1e9

    # -- W3C context ---------------------------------------------------
    def traceparent(self, span_id: Optional[str] = None) -> str:
        """The ``traceparent`` value naming ``span_id`` (default: the
        calling thread's innermost open span) as the remote parent."""
        if span_id is None:
            cur = self.current()
            span_id = cur.span_id if cur is not None else new_span_id()
        return format_traceparent(self.trace_id, span_id)

    parse_traceparent = staticmethod(parse_traceparent)
    new_span_id = staticmethod(new_span_id)

    # -- structured construction --------------------------------------
    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> "_SpanCtx":
        return _SpanCtx(self, name, attrs, parent)

    def _open(self, name: str, attrs: Dict[str, object],
              parent: Optional[Span] = None) -> Span:
        sp = Span(name, time.perf_counter(), attrs=dict(attrs))
        sp.start_unix_ns = time.time_ns()
        stack = self._stack()
        if parent is None:
            parent = stack[-1] if stack else None
        if parent is None and self.parent_span_id:
            sp.parent_id = self.parent_span_id
        with self._lock:
            (parent.children if parent is not None
             else self.roots).append(sp)
        stack.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        sp.end_s = time.perf_counter()
        sp.end_unix_ns = time.time_ns()
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def record(self, name: str, start_s: float, end_s: float,
               parent: Optional[Span] = None,
               span_id: Optional[str] = None, **attrs) -> Span:
        """Attach an already-timed span under ``parent`` (or the
        calling thread's innermost open span). ``span_id`` installs a
        PRE-MINTED id — the dispatch path mints the id before task
        submit so the worker's spans can be born pointing at it.
        Safe from fragment-dispatch threads."""
        sp = Span(name, start_s, end_s, dict(attrs))
        if span_id:
            sp.span_id = span_id
        sp.start_unix_ns = self.origin_unix_ns + int(
            (start_s - self.origin_s) * 1e9)
        sp.end_unix_ns = self.origin_unix_ns + int(
            (end_s - self.origin_s) * 1e9)
        if parent is None:
            parent = self.current()
        if parent is None and self.parent_span_id:
            sp.parent_id = self.parent_span_id
        with self._lock:
            (parent.children if parent is not None
             else self.roots).append(sp)
        return sp

    def graft(self, parent: Optional[Span], spans: List[dict],
              base_s: Optional[float] = None) -> None:
        """Attach worker-reported span dicts — the ID-PRESERVING
        merge: span/parent ids survive the wire, and spans carrying
        absolute unix-nanos anchors keep their own host's clock
        (mapped onto this trace's timebase for rendering). Legacy
        dicts without anchors fall back to rebasing the subtree at
        ``base_s`` (default = parent start)."""
        if parent is not None and base_s is None:
            base_s = parent.start_s
        for d in spans:
            sp = Span.from_dict(d, base_s if base_s is not None
                                else self.origin_s)
            self._realign(sp)
            if sp.parent_id is None and parent is not None:
                sp.parent_id = parent.span_id
            with self._lock:
                (parent.children if parent is not None
                 else self.roots).append(sp)

    def _realign(self, sp: Span) -> None:
        if sp.start_unix_ns is not None:
            start = self.perf_from_unix_ns(sp.start_unix_ns)
            end = (self.perf_from_unix_ns(sp.end_unix_ns)
                   if sp.end_unix_ns is not None
                   else start + sp.wall_s)
            sp.start_s, sp.end_s = start, end
        for c in sp.children:
            self._realign(c)

    # -- rendering ------------------------------------------------------
    def to_dicts(self) -> List[dict]:
        return [r.to_dict(self.origin_s, self.origin_unix_ns)
                for r in self.roots]

    def all_spans(self) -> List[Span]:
        """Depth-first flattening of the whole tree (the OTLP
        exporter's input — OTLP spans are a flat list linked by
        parentSpanId)."""
        out: List[Span] = []

        def walk(sp: Span) -> None:
            out.append(sp)
            for c in sp.children:
                walk(c)

        for r in self.roots:
            walk(r)
        return out

    def lines(self) -> List[str]:
        """Indented text rendering for EXPLAIN ANALYZE."""
        out: List[str] = []

        def walk(sp: Span, depth: int) -> None:
            attrs = ""
            if sp.attrs:
                attrs = " " + ", ".join(
                    f"{k}={v}" for k, v in sorted(sp.attrs.items()))
            out.append(f"{'   ' * depth}- {sp.name}: "
                       f"{sp.wall_s * 1000:.2f}ms{attrs}")
            for c in sp.children:
                walk(c, depth + 1)

        for r in self.roots:
            walk(r, 0)
        return out


def null_span(name: str, **attrs):
    """Drop-in for ``QueryTrace.span`` when no trace is installed —
    callers write ``sp = trace.span if trace else null_span`` and keep
    one code path."""
    return nullcontext()


_NO_SPAN = nullcontext()


class _Active(threading.local):
    """The trace of the query whose executor runs on this thread, for
    code that is handed no session (``device_wait``)."""
    trace: Optional[QueryTrace] = None


# installed by exec/executor.py's ``Executor.execute`` around each plan node
ACTIVE = _Active()


def device_wait():
    """A ``device_wait`` span, on the trace the executing thread has
    installed, around a host read of a value on the card (a row count, a
    total, lanes to the host) or any other call that blocks the thread
    until the card's queue drains; without a trace, a no-op."""
    trace = ACTIVE.trace
    return _NO_SPAN if trace is None else trace.span("device_wait")


class _SpanCtx:
    __slots__ = ("_trace", "_name", "_attrs", "_parent", "span")

    def __init__(self, trace: QueryTrace, name: str, attrs,
                 parent: Optional[Span] = None):
        self._trace = trace
        self._name = name
        self._attrs = attrs
        self._parent = parent
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = self._trace._open(self._name, self._attrs,
                                      self._parent)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.span is not None:
            self.span.attrs.setdefault("error", exc_type.__name__)
        self._trace._close(self.span)
