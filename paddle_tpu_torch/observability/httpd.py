"""Standalone ``/metrics`` HTTP endpoint for fleet scraping (the port of
``paddle_tpu/observability/httpd.py``).

Training jobs and serving engines alike must be scrapable, so this
module serves a
:class:`~paddle_tpu_torch.observability.MetricsRegistry` as Prometheus text
from a stdlib ``ThreadingHTTPServer`` on a daemon thread.  The page body
and content type live in :func:`metrics_page` /
``PROMETHEUS_CONTENT_TYPE`` and are shared with the serving frontend's
``GET /metrics`` route of a serving frontend, so both surfaces expose
byte-identical exposition for the same registry.

Usage::

    from paddle_tpu_torch import observability as obs
    srv = obs.start_metrics_server(port=9090)   # default registry
    ...train...                                 # scrape :9090/metrics
    srv.close()                                 # atexit also closes it
"""

from __future__ import annotations

import atexit
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from .metrics import MetricsRegistry, get_registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def metrics_page(registry: MetricsRegistry) -> bytes:
    """The ``/metrics`` response body (shared with the serving route)."""
    return registry.prometheus_text().encode("utf-8")


class MetricsServer:
    """One registry's scrape endpoint on a daemon thread.

    Routes: ``GET /metrics`` (Prometheus text exposition 0.0.4) and
    ``GET /healthz`` (liveness, ``200 ok``); anything else is 404."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry if registry is not None else get_registry()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = metrics_page(outer.registry)
                    ctype = PROMETHEUS_CONTENT_TYPE
                    status = 200
                elif path == "/healthz":
                    body, ctype, status = b"ok\n", "text/plain", 200
                else:
                    body, ctype, status = b"not found\n", "text/plain", 404
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes must not spam stderr

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)
        self._closed = False

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread.ident is not None:
            # shutdown() blocks on a flag only serve_forever() sets (and
            # join() raises on an unstarted thread), so both must run
            # only if the serving thread actually started
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
        else:
            self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"


_started: List[MetricsServer] = []  # unbounded-ok: one entry per explicit start_metrics_server call, closed at exit
_started_lock = threading.Lock()
_atexit_registered = False


def _close_all() -> None:
    with _started_lock:
        servers, _started[:] = list(_started), []
    for srv in servers:
        srv.close()


def start_metrics_server(registry: Optional[MetricsRegistry] = None,
                         port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Start a daemon-thread scrape endpoint for ``registry`` (default:
    the process-wide one).  ``port=0`` binds an ephemeral port — read it
    back from ``.port``.  Every server started here is closed at
    interpreter exit via ``atexit`` (or earlier via ``.close()``)."""
    global _atexit_registered
    srv = MetricsServer(registry, host=host, port=port).start()
    with _started_lock:
        _started.append(srv)
        if not _atexit_registered:
            atexit.register(_close_all)
            _atexit_registered = True
    return srv
