"""The port's process entry points on the CPU.

- `cmd/controller.build_kube_backend`'s three choices: an apiserver URL
  (the flag, or the in-cluster service host with a mounted token and CA)
  selects the HTTP client, which both packages build for the same URL, CA,
  token and QPS/burst budget; the in-cluster host without a token and no
  host at all select the in-memory backend on both packages.
- `cmd/controller.main`: an unported flag raises before anything binds;
  without a card the Runtime raises; and the whole process on the CPU (the
  Runtime's device patched to "cpu" by a wrapper, since the entry point
  always runs on the card): the crossover measured with K1's probe at boot,
  /healthz and /readyz answering 200, exit code 0 on SIGTERM.
- `cmd/solver_service.main`: --coordinator and $KARPENTER_TPU_COORDINATOR
  without a process count raise before connecting; with one, two
  processes on the CPU (gloo) serve a gRPC solve over the fabric, placed as
  an in-process solve places it, and SIGTERM releases the peer.
- tests/test_e2e_process.py's two topology cases on both packages: an
  apiserver, the webhook process and the controller process wired only
  through sockets (the port's controller through the CPU wrapper), the
  deployment-shaped case with its /metrics and capsule checks; and its
  capsule and residency debug surfaces of a real controller process
  (:147, :201), on both packages.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from karpenter_tpu.cmd import controller as ref_controller
from karpenter_tpu.utils.options import Options as RefOptions
from karpenter_tpu_torch import logsetup
from karpenter_tpu_torch.cmd import controller, solver_service
from karpenter_tpu_torch.kube.cluster import KubeCluster
from karpenter_tpu_torch.utils.options import Options

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_cluster_env(monkeypatch):
    for name in ("KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT", "KUBERNETES_APISERVER_URL", "KARPENTER_TPU_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    yield
    # a Runtime built by main() configured the port's log handler
    logsetup.reset_for_tests()
    logsetup.set_level("info")


def _client_record(kube) -> dict:
    """What an HttpKubeClient was built with: its endpoint, TLS, token file,
    the headers it would send and its rate limit."""
    return {
        "type": type(kube).__name__,
        "host": kube._host,
        "port": kube._port,
        "tls": kube._tls,
        "token_file": kube._token_file,
        "auth": kube._auth_headers(),
        "qps": kube._limiter.qps,
        "burst": kube._limiter.burst,
    }


def _both_backends(ref_options, options):
    ref_kube, ref_url = ref_controller.build_kube_backend(ref_options)
    kube, url = controller.build_kube_backend(options)
    try:
        return (_client_record(ref_kube), ref_url), (_client_record(kube), url), kube
    finally:
        ref_kube.stop()
        kube.stop()


class TestBuildKubeBackend:
    def test_apiserver_url_selects_the_http_client(self):
        from karpenter_tpu_torch.kube.client import HttpKubeClient

        url = "http://127.0.0.1:1"
        ref, port, kube = _both_backends(
            RefOptions(apiserver_url=url, kube_client_qps=50.0, kube_client_burst=70),
            Options(apiserver_url=url, kube_client_qps=50.0, kube_client_burst=70),
        )
        assert port == ref
        assert isinstance(kube, HttpKubeClient)
        assert port[1] == url and port[0]["qps"] == 50.0 and port[0]["burst"] == 70 and not port[0]["tls"]

    @pytest.mark.parametrize("host,want", [("10.0.0.1", "https://10.0.0.1:6443"), ("fd00::1", "https://[fd00::1]:6443")])
    def test_in_cluster_token_selects_the_http_client(self, monkeypatch, tmp_path, host, want):
        """The port reads the mounted token and CA (its serviceaccount
        directory pointed at a temporary one); the JAX package's client is
        built with what its build_kube_backend passes for the same mount
        (karpenter_tpu/cmd/controller.py:45-59), since its directory is
        not redirected."""
        from karpenter_tpu.kube.client import HttpKubeClient as RefHttpKubeClient
        from karpenter_tpu.utils.clock import Clock as RefClock
        from karpenter_tpu_torch.kube.certs import generate_serving_cert

        (tmp_path / "token").write_text("t")
        (tmp_path / "ca.crt").write_bytes(generate_serving_cert().ca_pem)
        monkeypatch.setattr(controller, "SERVICEACCOUNT_DIR", str(tmp_path))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", host)
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
        defaults = RefOptions()
        ref_kube = RefHttpKubeClient(
            want, qps=defaults.kube_client_qps, burst=defaults.kube_client_burst, clock=RefClock(),
            ca_file=str(tmp_path / "ca.crt"), token_file=str(tmp_path / "token"),
        )
        kube, url = controller.build_kube_backend(Options())
        try:
            assert (_client_record(kube), url) == (_client_record(ref_kube), want)
            assert kube._tls and kube._token_file == str(tmp_path / "token")
            assert kube._auth_headers() == {"Authorization": "Bearer t"}
            assert kube._ssl_context is not None
        finally:
            ref_kube.stop()
            kube.stop()

    def test_in_cluster_without_token_falls_to_in_memory(self, monkeypatch, capsys):
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
        ref_kube, ref_url = ref_controller.build_kube_backend(RefOptions())
        kube, url = controller.build_kube_backend(Options())
        assert (type(ref_kube).__name__, ref_url) == (type(kube).__name__, url) == ("KubeCluster", "")
        assert isinstance(kube, KubeCluster)
        err = capsys.readouterr().err
        assert err.count("falling back to the in-memory backend") == 2

    def test_no_cluster_selects_in_memory(self):
        ref_kube, ref_url = ref_controller.build_kube_backend(RefOptions())
        kube, url = controller.build_kube_backend(Options())
        assert (type(ref_kube).__name__, ref_url) == (type(kube).__name__, url) == ("KubeCluster", "")


class TestControllerMain:
    def test_unported_flag_raises_before_binding(self, monkeypatch):
        """Named when --solver-breaker-threshold raised, naming ROADMAP A7:
        the entry point now configures the process-wide breaker from the
        flags, before its Runtime reaches for the card (there is none here,
        so it raises there, before binding any port)."""
        import torch

        from karpenter_tpu_torch.solver.faults import BREAKER

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        saved = (BREAKER.threshold, BREAKER.backoff, BREAKER.clock)
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                controller.main(["--solver-breaker-threshold", "5", "--solver-breaker-backoff", "12.5", "--health-probe-port", "1"])
            assert (BREAKER.threshold, BREAKER.backoff) == (5, 12.5)
        finally:
            BREAKER.threshold, BREAKER.backoff, BREAKER.clock = saved

    def test_without_a_card_the_runtime_raises(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            controller.main(["--health-probe-port", "1"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _status(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=2) as resp:
            return resp.status
    except urllib.error.HTTPError as err:
        return err.code
    except OSError:
        return 0


# the entry point always runs on the card; this wrapper pins the Runtime it
# builds to the CPU and then runs it unchanged
_CPU_CONTROLLER = (
    "import functools, sys; import karpenter_tpu_torch.runtime as rt; "
    "rt.Runtime = functools.partial(rt.Runtime, device='cpu'); "
    "from karpenter_tpu_torch.cmd.controller import main; sys.exit(main(sys.argv[1:]))"
)


def test_controller_process_boots_answers_probes_and_stops_on_sigterm():
    port, metrics_port = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-c", _CPU_CONTROLLER, "--health-probe-port", str(port), "--metrics-port", str(metrics_port),
         "--log-level", "info"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and proc.poll() is None:
            if _status(port, "/healthz") == 200 and _status(port, "/readyz") == 200:
                break
            time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1]
        assert (_status(port, "/healthz"), _status(port, "/readyz")) == (200, 200)
        assert (_status(metrics_port, "/metrics"), _status(metrics_port, "/debug")) == (200, 200)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "measured dense routing crossover: dispatch rt" in err and "-> min_batch 64" in err
    assert "dense_solver=cpu" in err and "leader election won" in err


# the solver service's entry point with its fabric, its mesh and its solver
# on the CPU: the entry point itself always runs on the card
_CPU_SOLVER_SERVICE = """
import functools, sys
from karpenter_tpu_torch import solver
from karpenter_tpu_torch.parallel import multihost, peers
multihost.initialize = functools.partial(multihost.initialize, device="cpu")
peers.PeerFabric = functools.partial(peers.PeerFabric, device="cpu")
solver.DenseSolver = functools.partial(solver.DenseSolver, device="cpu")
from karpenter_tpu_torch.cmd import solver_service
solver_service.main(sys.argv[1:])
"""


class TestSolverServiceMain:
    """--coordinator joins the fabric (parallel/multihost.initialize): with
    no process count and id it raises before any connection is tried; with
    them, process 0 serves gRPC over the fabric's mesh and process 1 follows
    its solves until SIGTERM releases it."""

    @pytest.fixture(autouse=True)
    def _no_fabric_env(self, monkeypatch):
        for name in ("KARPENTER_TPU_NUM_PROCESSES", "KARPENTER_TPU_PROCESS_ID"):
            monkeypatch.delenv(name, raising=False)

    def test_coordinator_flag_raises(self):
        with pytest.raises(ValueError, match="KARPENTER_TPU_NUM_PROCESSES"):
            solver_service.main(["--coordinator", "127.0.0.1:1"])

    def test_coordinator_env_raises(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_TPU_COORDINATOR", "127.0.0.1:1")
        with pytest.raises(ValueError, match="KARPENTER_TPU_NUM_PROCESSES"):
            solver_service.main([])

    def test_coordinator_serves_over_the_fabric(self):
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_tpu_torch.scheduler import build_scheduler
        from karpenter_tpu_torch.service.client import SolverClient
        from karpenter_tpu_torch.solver import DenseSolver

        coordinator, address = f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"
        procs = []
        for pid in range(2):
            env = {**os.environ, "KARPENTER_TPU_NUM_PROCESSES": "2", "KARPENTER_TPU_PROCESS_ID": str(pid)}
            procs.append(subprocess.Popen(
                [
                    sys.executable, "-c", _CPU_SOLVER_SERVICE, "--coordinator", coordinator, "--address", address,
                    "--backend", "gloo", "--devices-per-process", "4", "--log-level", "info",
                ],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        client = SolverClient(address, timeout=60.0)
        try:
            deadline = time.monotonic() + 120
            while True:
                assert all(p.poll() is None for p in procs), [p.communicate()[1][-2000:] for p in procs]
                try:
                    client.health()
                    break
                except Exception:
                    assert time.monotonic() < deadline, "the coordinator never served gRPC"
                    time.sleep(0.2)
            provisioner = testing.make_provisioner()
            provider = FakeCloudProvider(instance_types(20))
            pods = [testing.make_pod(name=f"fabric-{i:03d}", requests={"cpu": [0.25, 0.5, 1.0][i % 3], "memory": "512Mi"}) for i in range(60)]
            remote = client.solve([provisioner], {provisioner.name: provider.get_instance_types(provisioner)}, pods)
            local = build_scheduler([provisioner], provider, pods, dense_solver=DenseSolver(min_batch=1, device="cpu")).solve(pods)

            def layout(results):
                return sorted((n.instance_type_options[0].name(), sorted(p.metadata.name for p in n.pods)) for n in results.new_nodes)

            assert sum(len(n.pods) for n in remote.new_nodes) == len(pods) and not remote.unschedulable
            assert layout(remote) == layout(local)
            assert client.health()["sharded_batches"] == 1
            procs[0].send_signal(signal.SIGTERM)
            outs = [p.communicate(timeout=60) for p in procs]
        finally:
            client.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
        assert "entering the peer loop" in outs[1][1] and "released after 1 solves" in outs[1][1]


# -- tests/test_e2e_process.py: the deployment topology, both packages ---------


def _wait_for(predicate, timeout=60.0, interval=0.2, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


class _Side:
    """One package's apiserver, client, builders and process commands; the
    port's controller runs through the CPU wrapper."""

    def __init__(self, side: str):
        self.side = side
        if side == "ref":
            from karpenter_tpu.api.objects import OP_IN, NodeSelectorRequirement
            from karpenter_tpu.kube.apiserver import APIServer
            from karpenter_tpu.kube.client import ApiStatusError, HttpKubeClient
            from tests.helpers import make_pod, make_provisioner

            self.controller = [sys.executable, "-m", "karpenter_tpu.cmd.controller"]
            self.webhook = [sys.executable, "-m", "karpenter_tpu.cmd.webhook"]
        else:
            from karpenter_tpu_torch.api.objects import OP_IN, NodeSelectorRequirement
            from karpenter_tpu_torch.kube.apiserver import APIServer
            from karpenter_tpu_torch.kube.client import ApiStatusError, HttpKubeClient
            from karpenter_tpu_torch.testing import make_pod, make_provisioner

            self.controller = [sys.executable, "-c", _CPU_CONTROLLER]
            self.webhook = [sys.executable, "-m", "karpenter_tpu_torch.cmd.webhook"]
        self.APIServer, self.HttpKubeClient, self.ApiStatusError = APIServer, HttpKubeClient, ApiStatusError
        self.make_pod, self.make_provisioner = make_pod, make_provisioner
        self.bad_requirement = NodeSelectorRequirement("team", OP_IN, [])


class _Procs:
    """Spawns processes and servers; stops every one at the end."""

    def __init__(self, tmp_path):
        self.tmp_path, self.procs, self.stops = tmp_path, [], []

    def spawn(self, argv, capture=False, env_extra=None):
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **(env_extra or {}))
        if capture:
            out, err = subprocess.PIPE, subprocess.PIPE
        else:
            log = open(self.tmp_path / f"proc-{len(self.procs)}.log", "w")
            self.stops.append(log.close)
            out = err = log
        proc = subprocess.Popen(argv, stdout=out, stderr=err, text=True, env=env, cwd=REPO)
        self.procs.append(proc)
        return proc

    def close(self):
        for proc in reversed(self.procs):
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.communicate(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.communicate()
        for stop in reversed(self.stops):
            stop()


def _node_types(client) -> list:
    return sorted(n.metadata.labels.get("node.kubernetes.io/instance-type") for n in client.list_nodes())


def _fetch(port: int, path: str) -> tuple:
    """(status, body) of one GET on 127.0.0.1; (None, "") while nothing
    answers."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=2) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()
    except OSError:
        return None, ""


def _deployment_shaped(s: _Side, procs: _Procs) -> dict:
    """test_e2e_process.py:66: the webhook registers itself against the
    apiserver, the controller serves its probes, /metrics and the capsules'
    debug surface (an empty index, 404-shaped JSON for a missing id),
    admission enforces through the registered objects, and the controller
    process provisions a pod."""
    srv = s.APIServer().start()
    procs.stops.append(srv.stop)
    health_port, metrics_port = _free_port(), _free_port()
    procs.spawn(s.webhook + ["--port", "0"], env_extra={"KUBERNETES_APISERVER_URL": srv.url})
    procs.spawn(
        s.controller + ["--disable-dense-solver", "--enable-capsules", "--batch-max-duration", "0.3",
                        "--batch-idle-duration", "0.05", "--health-probe-port", str(health_port),
                        "--metrics-port", str(metrics_port)],
        env_extra={"KUBERNETES_APISERVER_URL": srv.url},
    )
    client = s.HttpKubeClient(srv.url)
    procs.stops.append(client.stop)
    cfg = _wait_for(
        lambda: (lambda c: c if c is not None and c.webhooks[0]["clientConfig"].get("caBundle") else None)(
            client.get("ValidatingWebhookConfiguration", "validation.webhook.karpenter-tpu.sh", namespace="")
        ),
        message="webhook self-registration",
    )
    assert cfg.webhooks[0]["clientConfig"]["url"].endswith("/validate")
    assert _wait_for(lambda: _status(health_port, "/healthz") == 200, message="healthz")
    assert _wait_for(lambda: _status(health_port, "/readyz") == 200, message="readyz")
    with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics", timeout=5) as resp:
        assert resp.status == 200 and "karpenter" in resp.read().decode()
    code, body = _fetch(metrics_port, "/debug/capsules")
    assert code == 200, body
    capsules = json.loads(body)
    assert capsules["enabled"] is True and capsules["capsules"] == []
    assert {"captures_total", "suppressed", "spool_bytes"} <= set(capsules)
    code, body = _fetch(metrics_port, "/debug/capsules?id=nope")
    missing = json.loads(body)
    assert code == 404 and missing["status"] == 404 and "nope" in missing["error"]
    with pytest.raises(s.ApiStatusError) as err:
        client.create(s.make_provisioner(name="bad", requirements=[s.bad_requirement]))
    client.create(s.make_provisioner())
    client.create(s.make_pod(name="e2e-pod", requests={"cpu": "0.5"}))
    _wait_for(lambda: client.list_nodes() or None, message="nodes from the controller process")
    return {"rejected": err.value.code, "registrations": sorted(
        (c.kind, c.metadata.name, [h["clientConfig"]["url"].rsplit("/", 1)[-1] for h in c.webhooks])
        for c in (client.get(kind, name, namespace="") for kind, name in (
            ("MutatingWebhookConfiguration", "defaulting.webhook.karpenter-tpu.sh"),
            ("ValidatingWebhookConfiguration", "validation.webhook.karpenter-tpu.sh"),
        ))
    ), "node_types": _node_types(client)}


def _full_topology(s: _Side, procs: _Procs) -> dict:
    """test_e2e_process.py:256: the webhook process's CA bundle read from
    its stdout and registered in the apiserver, then the controller process
    provisions through it and holds the election Lease."""
    srv = s.APIServer().start()
    procs.stops.append(srv.stop)
    webhook = procs.spawn(s.webhook + ["--port", "0"], capture=True)
    ca_lines, url = [], None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and url is None:
        line = webhook.stderr.readline()
        if "serving AdmissionReview at" in line:
            url = line.split(" at ")[1].split()[0]
        elif not line and webhook.poll() is not None:
            break
    assert url, "webhook did not come up"
    while True:
        line = webhook.stdout.readline()
        assert line, "webhook exited before emitting its CA bundle"
        ca_lines.append(line)
        if "END CERTIFICATE" in line:
            break
    srv.state.register_webhooks(
        kinds={"Provisioner"}, mutate_url=url + "/mutate", validate_url=url + "/validate", ca_pem="".join(ca_lines).encode()
    )
    procs.spawn(
        s.controller + ["--disable-dense-solver", "--batch-max-duration", "0.3", "--batch-idle-duration", "0.05",
                        "--health-probe-port", str(_free_port()), "--metrics-port", str(_free_port())],
        env_extra={"KUBERNETES_APISERVER_URL": srv.url},
    )
    client = s.HttpKubeClient(srv.url)
    procs.stops.append(client.stop)
    with pytest.raises(s.ApiStatusError) as err:
        client.create(s.make_provisioner(name="bad", requirements=[s.bad_requirement]))
    client.create(s.make_provisioner())
    for i in range(3):
        client.create(s.make_pod(name=f"e2e-pod-{i}", requests={"cpu": "0.5"}))
    _wait_for(lambda: client.list_nodes() or None, message="nodes from the controller process")
    lease = _wait_for(lambda: client.get("Lease", "karpenter-leader-election", "kube-system"), message="the election lease")
    assert lease.spec.holder_identity
    return {"rejected": err.value.code, "node_types": _node_types(client), "lease": (lease.metadata.name, lease.metadata.namespace)}


# tests/test_e2e_process.py:147 and :201: a debug surface of a real
# controller process, by its flags, route, 404 query key and what a healthy
# controller's index holds
DEBUG_SURFACES = {
    "capsules": (
        ["--enable-capsules"], "/debug/capsules", "id",
        lambda doc: doc["enabled"] is True and doc["capsules"] == [] and doc["captures_total"] == 0
        and {"suppressed", "spool_bytes", "burn_rate"} <= set(doc),
    ),
    "residency": (
        ["--residency-audit-interval", "1"], "/debug/residency", "row",
        lambda doc: doc["enabled"] is True and doc["interval"] == 1 and doc["divergences"] == {} and doc["heals"] == 0
        and {"passes_seen", "audits", "clean_streak", "last_divergence"} <= set(doc),
    ),
}


@pytest.mark.parametrize("surface", sorted(DEBUG_SURFACES))
@pytest.mark.parametrize("side", ["ref", "port"])
def test_controller_process_serves_debug_surface(side, surface, tmp_path):
    s, procs = _Side(side), _Procs(tmp_path)
    flags, route, key, healthy = DEBUG_SURFACES[surface]
    try:
        srv = s.APIServer().start()
        procs.stops.append(srv.stop)
        health_port, metrics_port = _free_port(), _free_port()
        procs.spawn(
            s.controller + ["--disable-dense-solver", *flags, "--batch-max-duration", "0.3", "--batch-idle-duration", "0.05",
                            "--health-probe-port", str(health_port), "--metrics-port", str(metrics_port)],
            env_extra={"KUBERNETES_APISERVER_URL": srv.url},
        )
        _wait_for(lambda: _fetch(metrics_port, route)[0] is not None, message="metrics listener")
        code, body = _fetch(metrics_port, route)
        assert code == 200, body
        assert healthy(json.loads(body)), body
        code, body = _fetch(metrics_port, f"{route}?{key}=nope")
        missing = json.loads(body)
        assert code == 404 and missing["status"] == 404 and "nope" in missing["error"]
        code, body = _fetch(metrics_port, "/debug")
        assert code == 200 and route in body
    finally:
        procs.close()


@pytest.mark.parametrize("topology", [_deployment_shaped, _full_topology], ids=["deployment_shaped", "full"])
def test_deployment_topology_on_both_packages(topology, tmp_path):
    records = {}
    for side in ("ref", "port"):
        p = _Procs(tmp_path / side)
        (tmp_path / side).mkdir()
        try:
            records[side] = topology(_Side(side), p)
        finally:
            p.close()
    assert records["port"] == records["ref"]
