"""The port's process entry points on the CPU.

- `cmd/controller.build_kube_backend`'s three choices: an apiserver URL
  (the flag, or the in-cluster service host with a mounted token) selects
  the HTTP client, which the port raises for (ROADMAP A9b) where the JAX
  package builds it, on the same URL; the in-cluster host without a token
  and no host at all select the in-memory backend on both packages.
- `cmd/controller.main`: an unported flag raises before anything binds;
  without a card the Runtime raises; and the whole process on the CPU (the
  Runtime's device patched to "cpu" by a wrapper, since the entry point
  always runs on the card): the crossover measured with K1's probe at boot,
  /healthz and /readyz answering 200, exit code 0 on SIGTERM.
- `cmd/solver_service.main`: --coordinator and $KARPENTER_TPU_COORDINATOR
  raise, naming ROADMAP A12.
"""

from __future__ import annotations

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


class TestBuildKubeBackend:
    def test_apiserver_url_selects_the_http_client(self):
        url = "http://127.0.0.1:1"
        ref_kube, ref_url = ref_controller.build_kube_backend(RefOptions(apiserver_url=url))
        try:
            assert ref_url == url and type(ref_kube).__name__ == "HttpKubeClient"
        finally:
            ref_kube.stop()
        with pytest.raises(NotImplementedError, match=f"apiserver {url}: .*ROADMAP A9b"):
            controller.build_kube_backend(Options(apiserver_url=url))

    @pytest.mark.parametrize("host,want", [("10.0.0.1", "https://10.0.0.1:6443"), ("fd00::1", "https://[fd00::1]:6443")])
    def test_in_cluster_token_selects_the_http_client(self, monkeypatch, tmp_path, host, want):
        (tmp_path / "token").write_text("t")
        monkeypatch.setattr(controller, "SERVICEACCOUNT_DIR", str(tmp_path))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", host)
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
        with pytest.raises(NotImplementedError, match=re.escape(f"apiserver {want}: ")):
            controller.build_kube_backend(Options())

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
    def test_unported_flag_raises_before_binding(self):
        with pytest.raises(NotImplementedError, match="enable_tracing: .*ROADMAP A8"):
            controller.main(["--enable-tracing", "--health-probe-port", "1"])

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
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-c", _CPU_CONTROLLER, "--health-probe-port", str(port), "--log-level", "info"],
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
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "measured dense routing crossover: dispatch rt" in err and "-> min_batch 64" in err
    assert "dense_solver=cpu" in err and "leader election won" in err
    assert "metrics port 8080: nothing listens on it" in err


class TestSolverServiceMain:
    def test_coordinator_flag_raises(self):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            solver_service.main(["--coordinator", "10.0.0.1:1234"])

    def test_coordinator_env_raises(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_TPU_COORDINATOR", "10.0.0.1:1234")
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            solver_service.main([])
