"""Embedded HTTP status server.

Reference: src-cli/legacy/webserver.cpp:119-138 (nng HTTP endpoint serving
/api JSON of live-pipeline module stats) and the hserver experiment. Here a
stdlib ThreadingHTTPServer on a daemon thread; the stats callback is polled
per request so the hot path never touches the server.

A copy of satdump_tpu/core/http_status.py, its imports rewritten to the port.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class StatusServer:
    def __init__(self, stats_fn: Callable[[], dict], port: int = 0,
                 host: str = "127.0.0.1"):
        self._stats_fn = stats_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/status", "/api", "/api/status", "/"):
                    try:
                        body = json.dumps(outer._stats_fn()).encode()
                        code = 200
                    except Exception as e:  # stats must never kill the server
                        body = json.dumps({"error": str(e)}).encode()
                        code = 500
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):  # quiet
                pass

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
