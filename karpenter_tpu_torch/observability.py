"""HTTP health probes: /healthz and /readyz on the health-probe port.

The reference serves /healthz+/readyz on the health-probe port and /metrics
on the metrics port from its manager (controllers.go:167-181); the generated
Deployment's probes point at these. Served by the controller ENTRY POINT
(cmd/controller.py), not the Runtime constructor, so embedding runtimes in
tests never binds real ports.

The port's copy of karpenter_tpu/observability.py, cut to the probes: the
metrics listener, /metrics and the /debug index come with the registry
(ROADMAP A8).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .logsetup import get_logger

log = get_logger("observability")


def _handler(routes):
    from urllib.parse import urlparse

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            route = routes.get(urlparse(self.path).path)
            if route is None:
                self.send_error(404)
                return
            try:
                ok, content_type, body = route()
            except Exception as exc:  # noqa: BLE001 - a probe must answer, not die
                self.send_error(500, str(exc))
                return
            payload = body.encode()
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):  # kubelet probes every few seconds
            pass

    return Handler


class ObservabilityServer:
    """One listener: health (healthz/readyz)."""

    def __init__(
        self,
        healthy: Callable[[], bool],
        ready: Callable[[], bool],
        health_port: Optional[int],
        host: str = "0.0.0.0",
    ):
        def probe(fn, label):
            def route():
                ok = bool(fn())
                return ok, "text/plain; charset=utf-8", ("ok\n" if ok else f"{label} failing\n")

            return route

        # port semantics: None/negative disables the listener; 0 binds an
        # ephemeral port (tests); positive binds that port (deployments)
        self._servers: List[ThreadingHTTPServer] = []
        self._threads: List[threading.Thread] = []
        if health_port is not None and health_port >= 0:
            self._servers.append(
                ThreadingHTTPServer((host, health_port), _handler({"/healthz": probe(healthy, "liveness"), "/readyz": probe(ready, "readiness")}))
            )

    @property
    def ports(self) -> List[int]:
        return [s.server_address[1] for s in self._servers]

    def start(self) -> None:
        for server in self._servers:
            thread = threading.Thread(target=server.serve_forever, name=f"obs-{server.server_address[1]}", daemon=True)
            thread.start()
            self._threads.append(thread)
        if self._servers:
            log.info("observability endpoints on ports %s", self.ports)

    def stop(self) -> None:
        for server in self._servers:
            server.shutdown()
            server.server_close()
        for thread in self._threads:
            thread.join(timeout=2)
