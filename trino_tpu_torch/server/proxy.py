"""Reverse proxy for the client protocol.

Counterpart of ``trino_tpu/server/proxy.py`` (host only).

Reference parity: service/trino-proxy (ProxyResource.java — forwards
/v1/statement and result pages to a backing coordinator, rewriting
nextUri so clients keep talking to the proxy). JWT request signing is
replaced by an optional shared-secret header check."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Optional
from urllib.parse import urlparse


class Proxy:
    def __init__(self, backend_uri: str, port: int = 0,
                 shared_secret: Optional[str] = None):
        self.backend = backend_uri.rstrip("/")
        self.shared_secret = shared_secret
        from .coordinator import HTTPServer
        self._httpd = HTTPServer(("127.0.0.1", port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def base_uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "Proxy":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()

    def rewrite(self, payload: bytes) -> bytes:
        """Point nextUri/infoUri back at the proxy."""
        try:
            obj = json.loads(payload)
        except ValueError:
            return payload
        for key in ("nextUri", "infoUri", "partialCancelUri"):
            if key in obj and isinstance(obj[key], str):
                obj[key] = obj[key].replace(self.backend, self.base_uri)
        return json.dumps(obj).encode()


def _make_handler(proxy: Proxy):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _check_secret(self) -> bool:
            if proxy.shared_secret is None:
                return True
            if self.headers.get("X-Proxy-Secret") == \
                    proxy.shared_secret:
                return True
            body = b'{"error": "Forbidden"}'
            self.send_response(403)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return False

        def _forward(self, method: str):
            if not self._check_secret():
                return
            target = proxy.backend + self.path
            n = int(self.headers.get("Content-Length", 0) or 0)
            data = self.rfile.read(n) if n else None
            req = urllib.request.Request(target, data=data,
                                         method=method)
            for h in ("X-Trino-User", "X-Trino-Catalog",
                      "X-Trino-Schema", "X-Trino-Session",
                      "X-Trino-Source", "X-Trino-Prepared-Statement",
                      "Authorization", "Content-Type"):
                if self.headers.get(h):
                    req.add_header(h, self.headers[h])
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    body = proxy.rewrite(r.read())
                    code = r.status
            except urllib.error.HTTPError as e:
                body = e.read()
                code = e.code
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def do_GET(self):
            self._forward("GET")

        def do_POST(self):
            self._forward("POST")

        def do_DELETE(self):
            self._forward("DELETE")

    return Handler
