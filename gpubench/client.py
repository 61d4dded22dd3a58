"""Statement-protocol client of the benchmark.

Frozen copy of ``trino_tpu_torch/client.py`` at commit
02b59fe5773712a2e689bf918db914d607cd01fb, kept here so that a later change to
the port's client cannot move the yardstick: only the coordinator's server
side is measured. stdlib only. The original module docstring follows.

Python client for the coordinator's REST protocol.

Reference parity: client/trino-client StatementClientV1.java:108,324-336
— POST /v1/statement, then advance() through nextUri until the payload
carries no nextUri; data rows accumulate across pages. stdlib-only
(urllib), synchronous.

nextUri polls retry transient transport failures (connection refused /
reset, HTTP 503) with bounded exponential backoff, like the reference
client's advance() loop: a coordinator failover — the old process dead,
its replacement binding the same port and resuming the query from the
spooled execution manifest — looks to the client like a brief outage in
the middle of an otherwise ordinary poll chain. The initial POST is NOT
retried: submission is not idempotent.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class ClientError(Exception):
    pass


@dataclass
class ClientResult:
    columns: List[dict] = field(default_factory=list)
    rows: List[list] = field(default_factory=list)
    query_id: str = ""
    state: str = ""
    update_type: Optional[str] = None
    update_count: Optional[int] = None

    @property
    def column_names(self) -> List[str]:
        return [c["name"] for c in self.columns]


class StatementClient:
    def __init__(self, base_uri: str, user: str = "user",
                 catalog: str = "tpch", schema: str = "tiny",
                 session_properties: Optional[Dict[str, str]] = None,
                 timeout: float = 600.0, poll_retries: int = 8,
                 poll_retry_delay: float = 0.05):
        self.base_uri = base_uri.rstrip("/")
        self.user = user
        self.catalog = catalog
        self.schema = schema
        self.session_properties = dict(session_properties or {})
        self.timeout = timeout
        # transient-failure budget for one nextUri poll: attempts and
        # the initial backoff (doubled per retry, capped at 1s). ~2.5s
        # of cumulative patience at the defaults — enough to ride out
        # a coordinator restart, short enough that a dead cluster
        # still fails fast
        self.poll_retries = max(0, int(poll_retries))
        self.poll_retry_delay = float(poll_retry_delay)
        # client-held prepared statements, replayed on every request
        # via X-Trino-Prepared-Statement (ProtocolHeaders.java — the
        # coordinator's sessions are per-request, so prepared state
        # lives client-side exactly like the reference protocol)
        self.prepared: Dict[str, str] = {}

    def _request(self, method: str, uri: str, body: Optional[bytes]
                 = None) -> dict:
        from urllib.parse import quote
        req = urllib.request.Request(uri, data=body, method=method)
        req.add_header("X-Trino-User", self.user)
        req.add_header("X-Trino-Catalog", self.catalog)
        req.add_header("X-Trino-Schema", self.schema)
        if self.session_properties:
            req.add_header("X-Trino-Session", ",".join(
                f"{k}={v}" for k, v in self.session_properties.items()))
        if self.prepared:
            req.add_header("X-Trino-Prepared-Statement", ",".join(
                f"{name}={quote(sql)}"
                for name, sql in self.prepared.items()))
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    def execute(self, sql: str) -> ClientResult:
        out = ClientResult()
        payload = self._request("POST", f"{self.base_uri}/v1/statement",
                                sql.encode())
        while True:
            out.query_id = payload.get("id", out.query_id)
            out.state = payload.get("stats", {}).get("state", out.state)
            if "error" in payload:
                err = payload["error"]
                raise ClientError(
                    f"{err.get('errorName')}: {err.get('message')}")
            if "columns" in payload and not out.columns:
                out.columns = payload["columns"]
            out.rows.extend(payload.get("data", []))
            out.update_type = payload.get("updateType", out.update_type)
            out.update_count = payload.get("updateCount",
                                           out.update_count)
            nxt = payload.get("nextUri")
            if not nxt:
                self._track_prepared(sql, out)
                return out
            payload = self._poll(nxt)

    def _poll(self, uri: str) -> dict:
        """One nextUri advance with bounded retry. GET on an executing
        URI is idempotent (the token addresses the page), so retrying
        it can duplicate no rows — unlike the initial POST."""
        delay = self.poll_retry_delay
        for attempt in range(self.poll_retries + 1):
            try:
                return self._request("GET", uri)
            except urllib.error.HTTPError as e:
                # 503 = overloaded / restarting, worth the wait; any
                # other status is an answer, not an outage
                if e.code != 503 or attempt >= self.poll_retries:
                    raise
            except (urllib.error.URLError, ConnectionError,
                    http.client.HTTPException) as e:
                if attempt >= self.poll_retries:
                    raise ClientError(
                        f"giving up on {uri} after "
                        f"{self.poll_retries + 1} attempts: {e}") from e
            time.sleep(delay)
            delay = min(delay * 2, 1.0)
        raise ClientError(f"unreachable poll state for {uri}")

    def _track_prepared(self, sql: str, out: ClientResult) -> None:
        """Keep the client-side prepared-statement registry in sync
        with successful PREPARE/DEALLOCATE statements."""
        import re
        if out.update_type == "PREPARE":
            m = re.match(r"\s*prepare\s+(\w+)\s+from\s+(.*)\Z", sql,
                         re.IGNORECASE | re.DOTALL)
            if m:
                self.prepared[m.group(1)] = m.group(2).strip()
        elif out.update_type == "DEALLOCATE":
            m = re.match(r"\s*deallocate\s+(?:prepare\s+)?(\w+)", sql,
                         re.IGNORECASE)
            if m:
                self.prepared.pop(m.group(1), None)
