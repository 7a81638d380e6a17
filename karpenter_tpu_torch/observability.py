"""HTTP observability endpoints: health probes + Prometheus metrics.

The reference serves /healthz+/readyz on the health-probe port and /metrics
on the metrics port from its manager (controllers.go:167-181); the generated
Deployment's probes and the metrics Service point at these. Served by the
controller ENTRY POINT (cmd/controller.py), not the Runtime constructor, so
embedding runtimes in tests never binds real ports.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from .logsetup import get_logger
from .metrics import REGISTRY

log = get_logger("observability")


def debug_index_route(descriptions: Dict[str, str]):
    """Build the `/debug` index route: one JSON row per registered debug
    endpoint with its one-line description, so the read surface is
    discoverable from the process itself instead of the docs. The entry
    point (cmd/controller.py) passes the paths it actually wired — an
    endpoint behind a disabled flag is absent here too, matching what a
    GET against it would find."""

    def route(query: dict) -> tuple:
        endpoints = [
            {"path": path, "description": descriptions[path]} for path in sorted(descriptions)
        ]
        body = json.dumps({"endpoints": endpoints}) + "\n"
        return 200, "application/json; charset=utf-8", body

    return route


def _handler(routes):
    import inspect
    from urllib.parse import parse_qs, urlparse

    # arity decided once at registration: probe/metrics routes are zero-arg,
    # profiling routes take the parsed query. (Dispatching on TypeError at
    # call time would re-invoke a side-effectful route whose BODY raised
    # TypeError — a second live capture.)
    wants_query = {path: len(inspect.signature(fn).parameters) >= 1 for path, fn in routes.items()}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            url = urlparse(self.path)
            route = routes.get(url.path)
            if route is None:
                self.send_error(404)
                return
            try:
                if wants_query[url.path]:
                    ok, content_type, body = route(parse_qs(url.query))
                else:
                    ok, content_type, body = route()
            except Exception as exc:  # noqa: BLE001 - a probe must answer, not die
                self.send_error(500, str(exc))
                return
            payload = body.encode()
            # a route may return an explicit int status (the tracing routes'
            # 404-shaped JSON); bool keeps the probe semantics (ok -> 200/503)
            status = ok if isinstance(ok, int) and not isinstance(ok, bool) else (200 if ok else 503)
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):  # kubelet probes every few seconds
            pass

    return Handler


class ObservabilityServer:
    """Two listeners: health (healthz/readyz) and metrics (/metrics)."""

    def __init__(
        self,
        healthy: Callable[[], bool],
        ready: Callable[[], bool],
        health_port: Optional[int],
        metrics_port: Optional[int],
        host: str = "0.0.0.0",
        registry=REGISTRY,
        extra_routes=None,
    ):
        def probe(fn, label):
            def route():
                ok = bool(fn())
                return ok, "text/plain; charset=utf-8", ("ok\n" if ok else f"{label} failing\n")

            return route

        def metrics_route():
            return True, "text/plain; version=0.0.4; charset=utf-8", registry.export_text()

        # port semantics: None/negative disables the listener; 0 binds an
        # ephemeral port (tests); positive binds that port (deployments)
        self._servers: List[ThreadingHTTPServer] = []
        self._threads: List[threading.Thread] = []
        if health_port is not None and health_port >= 0:
            self._servers.append(
                ThreadingHTTPServer((host, health_port), _handler({"/healthz": probe(healthy, "liveness"), "/readyz": probe(ready, "readiness")}))
            )
        if metrics_port is not None and metrics_port >= 0:
            # extra routes (e.g. the live profiling endpoints behind
            # --enable-profiling) share the metrics listener, the reference's
            # AddMetricsExtraHandler seam (controllers.go:183-202)
            metrics_routes = {"/metrics": metrics_route}
            metrics_routes.update(extra_routes or {})
            self._servers.append(ThreadingHTTPServer((host, metrics_port), _handler(metrics_routes)))

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
