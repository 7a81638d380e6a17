"""Controller process entry point (cmd/controller/main.go analog).

    python -m karpenter_tpu_torch.cmd.controller --health-probe-port 8081 [--apiserver-url URL]

Boots the runtime, on the card, against a cluster backend and a cloud
provider, serves the health and readiness probes and /metrics from the
moment the process is up, and stops on SIGINT or SIGTERM.

The port's copy of karpenter_tpu/cmd/controller.py. Backend selection
mirrors client-go's config loading: --apiserver-url (or
$KUBERNETES_APISERVER_URL, or the in-cluster $KUBERNETES_SERVICE_HOST with
a mounted serviceaccount token) selects the real-protocol HTTP client at
the configured QPS/burst budget; otherwise the in-memory simulation backend
runs. --metrics-port serves /metrics, the /debug index and, behind
their flags, the tracing routes (--enable-tracing: /debug/traces,
/debug/decisions), the lock witness's (--enable-lock-witness:
/debug/locks), live profiling's (--enable-profiling: /debug/pprof/...),
the SLO snapshot's (--enable-slo: /debug/slo), the flight recorder's
(--enable-solver-telemetry: /debug/solver), the journal's
(--enable-journal: /debug/journal, /debug/waterfall), the capsules'
(--enable-capsules: /debug/capsules), the residency auditor's
(--residency-audit-interval: /debug/residency), the coherence witness's
(--coherence-interval: /debug/coherence) and the invariant monitor's
(--invariants-interval: /debug/invariants). The solver fault domain's flags
(--solver-breaker-threshold, --solver-breaker-backoff, --solver-hbm-budget)
configure the Runtime's breaker and budget split; under a solver mesh a solve
over the budget splits on the solver's card and skips the mesh for that solve
only. A runtime whose loop dies ends the
process: `serve` leaves its wait, and `Runtime.stop()` releases the Lease
and re-raises, so the process exits non-zero (a device-lost the card raised
among them: a supervisor's restart gets a fresh CUDA context). `serve` runs
any built Runtime that way, as this entry point runs its own.
"""

from __future__ import annotations

import os
import signal
import sys


SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def build_kube_backend(options):
    """Select the cluster backend (controllers.go:86-103's config step):
    --apiserver-url wins; else the in-cluster serviceaccount credential set
    (rest.InClusterConfig: $KUBERNETES_SERVICE_HOST + mounted token/ca.crt);
    else the in-memory simulation backend. Returns (backend, url)."""
    url = options.apiserver_url
    ca_file = token_file = None
    if not url and os.environ.get("KUBERNETES_SERVICE_HOST"):
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        if ":" in host:  # IPv6 service host
            host = f"[{host}]"
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token_path = os.path.join(SERVICEACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICEACCOUNT_DIR, "ca.crt")
        if os.path.exists(token_path):
            url = f"https://{host}:{port}"
            ca_file, token_file = ca_path, token_path
        else:
            print(
                "karpenter-tpu: in-cluster apiserver detected but no "
                f"serviceaccount token at {token_path}; falling back to the "
                "in-memory backend — set --apiserver-url to override",
                file=sys.stderr,
            )
    if url:
        from ..kube.client import HttpKubeClient
        from ..utils.clock import Clock

        return (
            HttpKubeClient(
                url,
                qps=options.kube_client_qps,
                burst=options.kube_client_burst,
                clock=Clock(),
                ca_file=ca_file,
                token_file=token_file,
            ),
            url,
        )
    from ..kube.cluster import KubeCluster

    return KubeCluster(), ""


def debug_routes(options, runtime=None) -> dict:
    """The metrics listener's routes beside /metrics: each debug surface
    its flag turns on, and the /debug index of them. /debug/residency
    serves `runtime`'s residency auditor, so it needs the Runtime."""
    from ..observability import debug_index_route

    extra_routes = {}
    # /debug index rows: every wired debug endpoint with the one-line
    # description its OWN module declares next to its routes() — path and
    # description can only drift together, inside one file
    debug_descriptions = {}
    if options.enable_profiling:
        # live pprof-analog endpoints on the metrics port
        # (controllers.go:183-202): on-demand host profile + device trace of
        # the RUNNING process, no restart needed
        from ..profiling import LiveProfiler

        profiler = LiveProfiler()
        extra_routes.update(profiler.routes())
        debug_descriptions.update(profiler.route_descriptions())
    if options.enable_tracing:
        # decision-tracing read surface: /debug/traces (+ ?id, ?format=chrome)
        # and /debug/decisions (+ ?pod=, ?outcome=, ?limit=) on the metrics port
        from .. import tracing

        extra_routes.update(tracing.routes())
        debug_descriptions.update(tracing.route_descriptions())
    if options.enable_slo:
        # the SLO snapshot: live pending-latency quantiles, cluster $/hr,
        # cost-drift ratio, churn counters on the metrics port
        from .. import slo

        extra_routes.update(slo.routes())
        debug_descriptions.update(slo.route_descriptions())
    if options.enable_lock_witness:
        # lock-order witness read surface: acquisition-order graph, cycle
        # (potential-deadlock) list, hold times on the metrics port
        from ..analysis import witness

        extra_routes.update(witness.routes())
        debug_descriptions.update(witness.route_descriptions())
    if options.enable_solver_telemetry:
        # solver flight recorder read surface: per-solve records with
        # compile-churn attribution and HBM accounting on the metrics port
        from .. import flight

        extra_routes.update(flight.routes())
        debug_descriptions.update(flight.route_descriptions())
    if options.enable_journal:
        # lifecycle journal read surface: the pod/node transition stream and
        # the pending-latency waterfall decomposition on the metrics port
        from .. import journal

        extra_routes.update(journal.routes())
        debug_descriptions.update(journal.route_descriptions())
    if options.enable_capsules:
        # incident-capsule read surface: the captured evidence bundles and
        # live burn rates on the metrics port
        from .. import capsule

        extra_routes.update(capsule.routes())
        debug_descriptions.update(capsule.route_descriptions())
    auditor = getattr(runtime, "auditor", None)
    if options.residency_audit_interval > 0 and auditor is not None:
        # residency-auditor read surface: audit cadence, divergences by
        # kind, heal count, last divergence detail on the metrics port
        from ..solver import audit

        extra_routes.update(audit.routes(auditor))
        debug_descriptions.update(audit.route_descriptions())
    if options.coherence_interval > 0:
        # informer-coherence witness read surface: registered caches,
        # confirmed divergences vs the store, last check on the metrics port
        from ..kube import coherence

        extra_routes.update(coherence.routes())
        debug_descriptions.update(coherence.route_descriptions())
    if options.invariants_interval > 0:
        # invariant-monitor read surface: thread census, watch/ring/heap
        # leak witnesses, confirmed violations on the metrics port
        from .. import invariants

        extra_routes.update(invariants.routes())
        debug_descriptions.update(invariants.route_descriptions())
    extra_routes["/debug"] = debug_index_route(debug_descriptions)
    return extra_routes


def main(argv=None) -> int:
    from ..cloudprovider.fake import FakeCloudProvider
    from ..runtime import Runtime
    from ..utils.options import parse

    options = parse(argv)
    if options.enable_lock_witness:
        # BEFORE the kube backend exists: witnessing happens at lock
        # creation, and kube.store is the most-shared lock in the process —
        # Runtime's own enable (for embedded callers) would come too late
        from ..analysis.witness import WITNESS

        WITNESS.enable()
    kube, url = build_kube_backend(options)
    runtime = Runtime(kube=kube, cloud_provider=FakeCloudProvider(), options=options)
    return serve(runtime, options, url)


def serve(runtime, options, url: str = "") -> int:
    """Run a built Runtime as the controller process does: the probes and
    /metrics up before the election, start(), then wait until SIGINT or
    SIGTERM or until a loop of the runtime ends; stop() releases the Lease
    and re-raises the exception that ended a loop, so the process exits
    non-zero on it."""
    from ..observability import ObservabilityServer
    from ..utils.clock import Clock

    # the handlers go in before the probes answer: a SIGTERM sent once the
    # process reports ready must take the graceful path
    stop = {"flag": False}

    def handle(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    # probes + /metrics serve from the moment the process is up — BEFORE
    # runtime.start(), which blocks on leader election: a standby replica
    # must still answer kubelet probes (controllers.go:167-181)
    obs = ObservabilityServer(
        healthy=runtime.healthy,
        ready=lambda: runtime.ready() and runtime.healthy(),
        health_port=options.health_probe_port,
        metrics_port=options.metrics_port,
        extra_routes=debug_routes(options, runtime),
    )
    obs.start()
    clock = Clock()
    try:
        runtime.start()
        backend = f"apiserver {url}" if url else "in-memory backend"
        print(f"karpenter-tpu controller running ({backend}); Ctrl-C to stop", file=sys.stderr)
        while not stop["flag"] and runtime.healthy():
            clock.sleep(0.5)
    finally:
        try:
            runtime.stop()
        finally:
            obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
