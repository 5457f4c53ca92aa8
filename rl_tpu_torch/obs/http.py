"""Minimal operational HTTP sidecar: Prometheus text and a debug surface
(counterpart of :mod:`rl_tpu.obs.http`, a copy of it but for the profile
route).

The control plane is line-delimited JSON over TCP
(:class:`rl_tpu_torch.comm.TCPCommandServer`), which Prometheus cannot
scrape, so a service that wants scraping (``ServingService``) runs this
stdlib HTTP server beside its command port: one daemon thread, content
type ``text/plain; version=0.0.4``.

Routes:

- ``GET /metrics`` (and ``/``): Prometheus text exposition.
- ``GET /healthz``: 200 ``ok`` while the server thread runs.
- ``GET /debug/state``: the owning service's state snapshot
  (``state_fn``) as JSON, bounded by ``max_state_bytes``; 404 when no
  ``state_fn`` was wired.
- ``POST /profile``: fires the ``manual`` trigger of the profiler passed
  as ``profiler``. The reference's process-global triggered profiler
  (``obs/profiling``) is not ported yet (ROADMAP A7), so without one this
  route answers 404 "no profiler armed". GET /profile is 405.

Anything else: 404 on GET, 405 on POST to a GET-only route.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

__all__ = ["MetricsHTTPServer"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_TYPE = "application/json; charset=utf-8"

_GET_ROUTES = ("/metrics", "/", "/healthz", "/debug/state")


class MetricsHTTPServer:
    """Serve ``GET /metrics`` (+ health/debug/profile routes) for one
    :class:`~rl_tpu_torch.obs.registry.MetricsRegistry`.

    ``port=0`` binds an ephemeral port; read it back from ``address``.
    ``state_fn`` (optional) backs ``/debug/state``; ``profiler``
    (optional, an object with ``trigger(reason, args)``) backs
    ``POST /profile``.
    """

    def __init__(
        self,
        registry,
        host: str = "127.0.0.1",
        port: int = 0,
        state_fn: Callable[[], Any] | None = None,
        profiler: Any = None,
        max_state_bytes: int = 262144,
    ):
        self.registry = registry
        self.state_fn = state_fn
        self.profiler = profiler
        self.max_state_bytes = int(max_state_bytes)
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                route = self.path.split("?", 1)[0]
                if route in ("/metrics", "/"):
                    try:
                        body = outer.registry.render().encode()
                    except Exception as e:  # registry bug must not wedge the scraper
                        self.send_error(500, str(e))
                        return
                    self._reply(200, body, CONTENT_TYPE)
                elif route == "/healthz":
                    self._reply(200, b"ok\n", CONTENT_TYPE)
                elif route == "/debug/state":
                    if outer.state_fn is None:
                        self.send_error(404, "no state source wired")
                        return
                    self._reply(200, outer._state_body(), JSON_TYPE)
                elif route == "/profile":
                    # capture has side effects; require POST
                    self.send_error(405, "use POST /profile")
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802 (stdlib API name)
                route = self.path.split("?", 1)[0]
                if route == "/profile":
                    prof = outer._resolve_profiler()
                    if prof is None:
                        self.send_error(404, "no profiler armed (obs/profiling is not "
                                             "ported yet, ROADMAP A7)")
                        return
                    path = prof.trigger("manual", {"source": "http"})
                    body = json.dumps({"capture": path}).encode() + b"\n"
                    self._reply(200, body, JSON_TYPE)
                elif route in _GET_ROUTES:
                    self.send_error(405, f"use GET {route}")
                else:
                    self.send_error(404)

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None
        self._child = None  # supervised-mode handle

    def _resolve_profiler(self):
        # the reference falls back to its process-global triggered
        # profiler, which waits for obs/profiling (ROADMAP A7)
        return self.profiler

    def _state_body(self) -> bytes:
        """``/debug/state`` payload: the snapshot as JSON, with a bounded
        on-the-wire size — an oversize snapshot degrades to a small
        explicit error object instead of a multi-MB reply (and a raising
        state_fn to its repr), so the debug surface is always safe to
        poll."""
        try:
            payload = self.state_fn()
        except Exception as e:
            payload = {"error": repr(e)}
        try:
            body = json.dumps(payload, default=repr).encode()
        except Exception as e:
            body = json.dumps({"error": repr(e)}).encode()
        if len(body) > self.max_state_bytes:
            body = json.dumps({
                "error": "state snapshot too large",
                "bytes": len(body),
                "limit": self.max_state_bytes,
            }).encode()
        return body + b"\n"

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def start(self, supervisor=None) -> "MetricsHTTPServer":
        """Start serving; with a :class:`rl_tpu_torch.resilience.Supervisor`, the
        serve loop runs as a supervised child (restarted on crash) instead
        of a bare daemon thread."""
        if supervisor is not None:
            if self._child is None:
                self._child = supervisor.spawn(
                    "metrics-http", self._server.serve_forever, escalate=False
                )
        elif self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="metrics-http",
                daemon=True,
            )
            self._thread.start()
        return self

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._child is not None:
            self._child.stop(timeout=5)
            self._child = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
