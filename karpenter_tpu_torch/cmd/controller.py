"""Controller process entry point (cmd/controller/main.go analog).

    python -m karpenter_tpu_torch.cmd.controller --health-probe-port 8081 [--apiserver-url URL]

Boots the runtime, on the card, against a cluster backend and a cloud
provider, serves the health and readiness probes from the moment the
process is up, and stops on SIGINT or SIGTERM.

The port's copy of karpenter_tpu/cmd/controller.py. Backend selection
mirrors client-go's config loading: --apiserver-url (or
$KUBERNETES_APISERVER_URL, or the in-cluster $KUBERNETES_SERVICE_HOST with
a mounted serviceaccount token) selects the real-protocol HTTP client at
the configured QPS/burst budget; otherwise the in-memory simulation backend
runs. The debug surfaces'
flags raise through the Runtime (ROADMAP A8). Nothing listens on
--metrics-port until /metrics is ported (ROADMAP A8); `main` logs a warning
naming the port at boot, so a deployment that scrapes it sees why. A runtime whose loop dies
ends the process: `main` leaves its wait, and `Runtime.stop()` re-raises.
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


def main(argv=None) -> int:
    from ..cloudprovider.fake import FakeCloudProvider
    from ..logsetup import get_logger
    from ..observability import ObservabilityServer
    from ..runtime import Runtime
    from ..utils.clock import Clock
    from ..utils.options import parse

    options = parse(argv)
    kube, url = build_kube_backend(options)
    runtime = Runtime(kube=kube, cloud_provider=FakeCloudProvider(), options=options)
    get_logger("controller").warning(
        "metrics port %d: nothing listens on it, /metrics is not ported yet (ROADMAP A8); "
        "the health probes serve on port %d",
        options.metrics_port, options.health_probe_port,
    )

    # the handlers go in before the probes answer: a SIGTERM sent once the
    # process reports ready must take the graceful path
    stop = {"flag": False}

    def handle(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    # probes serve from the moment the process is up — BEFORE
    # runtime.start(), which blocks on leader election: a standby replica
    # must still answer kubelet probes (controllers.go:167-181)
    obs = ObservabilityServer(
        healthy=runtime.healthy,
        ready=lambda: runtime.ready() and runtime.healthy(),
        health_port=options.health_probe_port,
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
