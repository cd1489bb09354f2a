"""Scrapeable telemetry endpoint: a stdlib ``http.server`` thread serving
a :class:`~paddle_tpu_torch.observability.metrics.MetricsRegistry` in
Prometheus text format — port of ``paddle_tpu/observability/server.py``.

Deliberately minimal — one daemon thread, no dependencies, port-0
friendly (tests and co-located replicas bind an ephemeral port and read
it back from :attr:`MetricsServer.port`). The scrape itself walks the
registry's collectors (pull-based), so serving traffic pays nothing until
someone actually asks.

Endpoints:

- ``GET /metrics`` — the registry dump (text/plain; version=0.0.4).
- ``GET /healthz`` — ``ok`` (liveness for the fleet's operator tooling).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry

__all__ = ["MetricsServer"]


class MetricsServer:
    """>>> server = MetricsServer(registry, port=0)   # ephemeral port
    >>> urllib.request.urlopen(server.url).read()     # one scrape
    >>> server.close()

    The server thread is a daemon: an engine process exiting never hangs
    on its telemetry endpoint.
    """

    def __init__(self, registry: MetricsRegistry, host: str = "127.0.0.1",
                 port: int = 0):
        self.registry = registry
        reg = registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 — BaseHTTPRequestHandler
                if self.path.split("?", 1)[0] == "/metrics":
                    try:
                        body = reg.dump().encode("utf-8")
                    except Exception as e:   # scrape must answer, not hang
                        self.send_response(500)
                        self.end_headers()
                        self.wfile.write(str(e).encode("utf-8", "replace"))
                        return
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/healthz":
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"ok")
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pt-metrics-server",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self, timeout: Optional[float] = 2.0) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=timeout)
