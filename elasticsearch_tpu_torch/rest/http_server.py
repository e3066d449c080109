"""HTTP transport: sockets -> RestController (counterpart of
elasticsearch_tpu/rest/http_server.py): a threading stdlib HTTP server
that parses query params and JSON/NDJSON bodies and delegates to the
controller."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    controller = None

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _handle(self, method: str):
        url = urlsplit(self.path)
        params = dict(parse_qsl(url.query))
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        content_type = (self.headers.get("Content-Type") or "").lower()
        body = None
        if raw:
            if "x-ndjson" in content_type or url.path.rstrip("/").endswith(
                    "_bulk"):
                body = raw.decode("utf-8")
            else:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError as e:
                    self._send(400, {"error": {
                        "type": "parsing_exception",
                        "reason": f"Failed to parse request body: {e}"},
                        "status": 400})
                    return
        status, payload = self.controller.dispatch(method, url.path, params,
                                                   body)
        self._send(status, payload, head_only=(method == "HEAD"))

    def _send(self, status: int, payload, head_only: bool = False):
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-elastic-product", "Elasticsearch")
        self.end_headers()
        if not head_only:
            self.wfile.write(data)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_DELETE(self):
        self._handle("DELETE")

    def do_HEAD(self):
        self._handle("HEAD")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a burst of concurrent clients must not overflow the listen backlog
    request_queue_size = 1024


class HttpServer:
    def __init__(self, controller, host: str = "127.0.0.1", port: int = 9200):
        handler = type("BoundHandler", (_Handler,), {"controller": controller})
        self._server = _Server((host, port), handler)
        self.port = self._server.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
