"""OTLP/JSON trace export: ResourceSpans over a file or HTTP sink.

Counterpart of ``trino_tpu/obs/otlp.py`` (host only): the same
documents, sinks, validation and counters over the port's traces.

Reference parity: the reference wires io.opentelemetry SDK exporters
(OTLP over HTTP) onto the DispatchManager / SqlQueryExecution span
boundaries; any OTel collector ingests the result. This module is the
stdlib-only analog: a finished ``QueryTrace`` (obs/trace.py — spans
already carry 128-bit trace ids, 64-bit span ids, parent links, and
absolute unix-nanos timestamps) serializes into the OTLP/JSON
``resourceSpans`` shape that ``POST {endpoint}/v1/traces`` accepts
and any collector file-reader understands.

Sinks (both best-effort — telemetry export must never fail a query):

- **file** (``TRINO_TPU_OTLP_FILE``): one JSON document per line
  (JSONL), the zero-dependency audit sink; rotate externally.
- **HTTP** (``TRINO_TPU_OTLP_ENDPOINT``): ``POST`` the document to an
  OTLP/HTTP collector; ``/v1/traces`` is appended when the endpoint
  does not already name it.

The coordinator additionally serves ``GET /v1/trace/{query_id}``
(server/coordinator.py) with the same document for a finished query —
the pull-side of the export, no collector required.

Outcomes are counted in ``trino_tpu_otlp_exports_total{sink,result}``.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

from .metrics import OTLP_EXPORTS

# OTLP enum: SPAN_KIND_INTERNAL (engine phases are internal spans;
# the task-dispatch HTTP hop is modeled by parent links, not by
# client/server kind pairs)
SPAN_KIND_INTERNAL = 1

# serializes appends so concurrent queries' documents interleave at
# line (not byte) granularity in the file sink
_FILE_LOCK = threading.Lock()


def _any_value(v: object) -> dict:
    """A typed OTLP AnyValue."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attributes(attrs: Dict[str, object]) -> List[dict]:
    return [{"key": str(k), "value": _any_value(v)}
            for k, v in sorted(attrs.items(), key=lambda kv: str(kv[0]))]


def _span_to_otlp(span, trace, parent_id: Optional[str]) -> dict:
    start_ns = span.start_unix_ns
    if start_ns is None:
        start_ns = trace.origin_unix_ns + int(
            (span.start_s - trace.origin_s) * 1e9)
    end_ns = span.end_unix_ns
    if end_ns is None:
        end_ns = start_ns + int(span.wall_s * 1e9)
    out = {
        "traceId": trace.trace_id,
        "spanId": span.span_id,
        "name": span.name,
        "kind": SPAN_KIND_INTERNAL,
        "startTimeUnixNano": str(int(start_ns)),
        "endTimeUnixNano": str(int(end_ns)),
    }
    if parent_id:
        out["parentSpanId"] = parent_id
    if span.attrs:
        out["attributes"] = _attributes(span.attrs)
    return out


def trace_to_resource_spans(trace, resource: Optional[dict] = None
                            ) -> dict:
    """The OTLP/JSON document for one query's trace. ``resource``
    attributes identify the producing process (service.name, query id)
    — the ResourceSpans envelope every OTLP consumer groups by. The
    span list is FLAT (OTLP's shape): tree edges become parentSpanId
    links, and a span grafted from a worker keeps the parent id it was
    born with (obs/trace.py id-preserving merge)."""
    attrs = {"service.name": "trino_tpu"}
    if trace.query_id:
        attrs["trino_tpu.query_id"] = trace.query_id
    attrs.update(resource or {})
    spans: List[dict] = []

    def walk(sp, parent_id: Optional[str]) -> None:
        spans.append(_span_to_otlp(sp, trace, parent_id))
        for c in sp.children:
            walk(c, sp.span_id)

    for r in trace.roots:
        # a root's remote parent (the dispatching coordinator span)
        # survives as its own parent_id; local roots have none
        walk(r, r.parent_id)
    return {"resourceSpans": [{
        "resource": {"attributes": _attributes(attrs)},
        "scopeSpans": [{
            "scope": {"name": "trino_tpu.obs", "version": "1"},
            "spans": spans}]}]}


def validate_resource_spans(doc: dict) -> None:
    """Structural validation of an OTLP/JSON document — the test- and
    ingest-side contract check. Raises ValueError naming the first
    violation."""
    if not isinstance(doc, dict) or "resourceSpans" not in doc:
        raise ValueError("missing resourceSpans")
    rs = doc["resourceSpans"]
    if not isinstance(rs, list) or not rs:
        raise ValueError("resourceSpans must be a non-empty list")
    for i, r in enumerate(rs):
        if "resource" not in r or "attributes" not in r["resource"]:
            raise ValueError(f"resourceSpans[{i}] missing resource "
                             "attributes")
        sss = r.get("scopeSpans")
        if not isinstance(sss, list) or not sss:
            raise ValueError(f"resourceSpans[{i}] missing scopeSpans")
        for ss in sss:
            for sp in ss.get("spans", ()):
                tid = sp.get("traceId", "")
                sid = sp.get("spanId", "")
                if len(tid) != 32:
                    raise ValueError(
                        f"span {sp.get('name')}: traceId must be 32 "
                        f"hex chars, got {tid!r}")
                if len(sid) != 16:
                    raise ValueError(
                        f"span {sp.get('name')}: spanId must be 16 "
                        f"hex chars, got {sid!r}")
                int(tid, 16)
                int(sid, 16)
                if "name" not in sp:
                    raise ValueError("span missing name")
                start = int(sp.get("startTimeUnixNano", "0"))
                end = int(sp.get("endTimeUnixNano", "0"))
                if end < start:
                    raise ValueError(
                        f"span {sp['name']}: endTimeUnixNano < start")
                pid = sp.get("parentSpanId")
                if pid is not None and len(pid) != 16:
                    raise ValueError(
                        f"span {sp['name']}: bad parentSpanId {pid!r}")


def spans_from_otlp(doc: dict) -> List[dict]:
    """Flatten every span out of an OTLP/JSON document — the
    round-trip read half (tests assert exported ids/parents against
    the live trace through this)."""
    out: List[dict] = []
    for r in doc.get("resourceSpans", ()):
        for ss in r.get("scopeSpans", ()):
            out.extend(ss.get("spans", ()))
    return out


class FileSink:
    """JSONL append sink — one OTLP document per line."""

    name = "file"

    def __init__(self, path: str):
        self.path = path

    def export(self, doc: dict) -> None:
        line = json.dumps(doc, separators=(",", ":")) + "\n"
        with _FILE_LOCK:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)


class HttpSink:
    """OTLP/HTTP sink: POST the JSON document to a collector.
    ``export_trace`` dispatches it on a daemon thread (async_export)
    — a down collector must cost the query thread nothing."""

    name = "http"
    async_export = True

    def __init__(self, endpoint: str, timeout_s: float = 5.0):
        ep = endpoint.rstrip("/")
        if not ep.endswith("/v1/traces"):
            ep = ep + "/v1/traces"
        self.endpoint = ep
        self.timeout_s = timeout_s

    def export(self, doc: dict) -> None:
        import urllib.request
        payload = json.dumps(doc, separators=(",", ":")).encode()
        req = urllib.request.Request(
            self.endpoint, data=payload,
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s):
            pass


def configured_sinks() -> List[object]:
    """Sinks named by process config (TRINO_TPU_OTLP_FILE /
    TRINO_TPU_OTLP_ENDPOINT); empty when export is unconfigured."""
    from ..config import CONFIG
    sinks: List[object] = []
    if CONFIG.otlp_file:
        sinks.append(FileSink(CONFIG.otlp_file))
    if CONFIG.otlp_endpoint:
        sinks.append(HttpSink(CONFIG.otlp_endpoint))
    return sinks


def _export_one(sink, doc: dict) -> bool:
    name = getattr(sink, "name", type(sink).__name__)
    try:
        sink.export(doc)
        OTLP_EXPORTS.inc(sink=name, result="ok")
        return True
    except Exception:           # noqa: BLE001 — telemetry best-effort
        OTLP_EXPORTS.inc(sink=name, result="error")
        return False


def export_trace(trace, resource: Optional[dict] = None,
                 sinks: Optional[List[object]] = None) -> int:
    """Serialize ``trace`` once and hand it to every sink; returns how
    many sinks accepted it synchronously. Sink failures are counted
    (otlp_exports_total{sink,result=error}) and swallowed — export is
    telemetry, not the query's critical path. Network sinks (those
    with ``async_export = True``, i.e. HttpSink) post from a daemon
    thread so an unreachable collector's connect timeout never rides
    the query thread."""
    if sinks is None:
        sinks = configured_sinks()
    if not sinks or trace is None or not trace.roots:
        return 0
    doc = trace_to_resource_spans(trace, resource)
    ok = 0
    for sink in sinks:
        if getattr(sink, "async_export", False):
            threading.Thread(target=_export_one, args=(sink, doc),
                             daemon=True).start()
            continue
        if _export_one(sink, doc):
            ok += 1
    return ok


def maybe_export(trace, session=None,
                 resource: Optional[dict] = None) -> int:
    """The runner-side hook: export when sinks are configured and the
    session has not opted out (``otlp_export`` session property)."""
    if trace is None or not trace.roots:
        return 0
    if session is not None:
        try:
            if not bool(session.get("otlp_export")):
                return 0
        except KeyError:        # foreign session without the knob
            pass
    return export_trace(trace, resource=resource)
