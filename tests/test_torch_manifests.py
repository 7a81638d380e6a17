"""The port's deployment manifests held against the JAX package's.

- tests/test_manifests.py's consistency cases on both packages' renders
  (every container flag a real flag of its binary, probe ports from
  Options, admission registrations pointing at the webhook Service, the
  settings ConfigMap from config.py, RBAC, the CRD schema); the sidecar's
  device resource is the card's, nvidia.com/gpu, on the port.
- The port's render equals the JAX package's after exactly the named
  substitutions: the module path (karpenter_tpu.cmd. ->
  karpenter_tpu_torch.cmd.), the sidecar's device resource
  (google.com/tpu -> nvidia.com/gpu) and the controller container's
  nvidia.com/gpu=1 (its solver runs on the card), for each render
  `--check` knows, and the JAX package's render equals its committed
  deploy/ files.
- The port's `--check` takes a directory and has no default: without one it
  is an error; after a render into a temporary directory it passes; a
  stale file there fails it, naming the file. The port never renders into
  or compares with deploy/.
"""

from __future__ import annotations

import argparse
import io
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

yaml = pytest.importorskip("yaml")

REPO = Path(__file__).resolve().parent.parent
SIDES = ("ref", "port")
# the sidecar's device resource on each package
DEVICE = {"ref": "google.com/tpu", "port": "nvidia.com/gpu"}


class MKit:
    def __init__(self, side: str):
        self.side = side
        if side == "ref":
            from karpenter_tpu.cmd import gen_manifests
            from karpenter_tpu.config import CONFIGMAP_NAME, DEFAULT_CONFIGMAP_DATA
            from karpenter_tpu.utils import options
        else:
            from karpenter_tpu_torch.cmd import gen_manifests
            from karpenter_tpu_torch.config import CONFIGMAP_NAME, DEFAULT_CONFIGMAP_DATA
            from karpenter_tpu_torch.utils import options
        self.gen, self.options = gen_manifests, options
        self.CONFIGMAP_NAME, self.DEFAULT_CONFIGMAP_DATA = CONFIGMAP_NAME, DEFAULT_CONFIGMAP_DATA
        self.module = "karpenter_tpu.cmd.gen_manifests" if side == "ref" else "karpenter_tpu_torch.cmd.gen_manifests"
        self.device = DEVICE[side]


@pytest.fixture(params=SIDES)
def k(request):
    return MKit(request.param)


def _args(**overrides):
    ns = argparse.Namespace(
        namespace="karpenter",
        image="karpenter-tpu:latest",
        replicas=2,
        cluster_name="cluster",
        solver_sidecar=False,
        tpu_resource="",
        service_monitor=False,
    )
    for key, value in overrides.items():
        setattr(ns, key, value)
    return ns


def by_kind(docs, kind):
    return [d for d in docs if d["kind"] == kind]


def controller_of(docs):
    return next(d for d in by_kind(docs, "Deployment") if d["metadata"]["name"] == "karpenter-tpu")


def rendered(k: MKit, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert k.gen.main(list(argv)) == 0
    return buf.getvalue()


# -- tests/test_manifests.py, on both packages ---------------------------------


class TestManifestBundle:
    def test_bundle_has_every_chart_object_kind(self, k):
        docs = k.gen.render(_args(service_monitor=True))
        kinds = {d["kind"] for d in docs}
        assert kinds >= {
            "Namespace", "CustomResourceDefinition", "ServiceAccount", "ClusterRole", "ClusterRoleBinding",
            "Role", "RoleBinding", "ConfigMap", "Deployment", "Service", "MutatingWebhookConfiguration",
            "ValidatingWebhookConfiguration", "PodDisruptionBudget", "ServiceMonitor",
        }
        assert len(by_kind(docs, "CustomResourceDefinition")) == 2  # Provisioner + NodeClass
        assert len(by_kind(docs, "Deployment")) == 2  # controller + webhook

    def test_yaml_round_trips(self, k):
        docs = list(yaml.safe_load_all(rendered(k, [])))
        assert all("kind" in d for d in docs)

    def test_controller_args_are_real_flags(self, k):
        containers = {c["name"]: c for c in controller_of(k.gen.render(_args(solver_sidecar=True)))["spec"]["template"]["spec"]["containers"]}
        flags = [a for a in containers["controller"]["args"] if a.startswith("--")]
        parsed = k.options.parse(containers["controller"]["args"])  # the real parser
        assert parsed.solver_service_address == "127.0.0.1:8433"
        assert flags

    def test_probe_ports_match_options(self, k):
        defaults = k.options.Options()
        docs = k.gen.render(_args())
        container = controller_of(docs)["spec"]["template"]["spec"]["containers"][0]
        ports = {p["name"]: p["containerPort"] for p in container["ports"]}
        assert ports["http-metrics"] == defaults.metrics_port
        assert ports["http"] == defaults.health_probe_port
        metrics_service = next(d for d in by_kind(docs, "Service") if d["metadata"]["name"] == "karpenter-tpu")
        assert metrics_service["spec"]["ports"][0]["port"] == defaults.metrics_port

    def test_settings_configmap_matches_config_defaults(self, k):
        cm = next(d for d in by_kind(k.gen.render(_args()), "ConfigMap") if d["metadata"]["name"] == k.CONFIGMAP_NAME)
        assert cm["data"] == k.DEFAULT_CONFIGMAP_DATA

    def test_webhook_registrations_point_at_webhook_service(self, k):
        docs = k.gen.render(_args())
        service_names = {d["metadata"]["name"] for d in by_kind(docs, "Service")}
        for kind in ("MutatingWebhookConfiguration", "ValidatingWebhookConfiguration"):
            cfg = by_kind(docs, kind)[0]
            client = cfg["webhooks"][0]["clientConfig"]["service"]
            assert client["name"] in service_names
            assert client["namespace"] == "karpenter"
            rules = cfg["webhooks"][0]["rules"][0]
            assert "provisioners" in rules["resources"] and "nodeclasses" in rules["resources"]

    def test_controller_device_request(self, k):
        """The port's controller solves on the card, so its container asks
        for one in every render; the JAX package's runs on the CPU."""
        for sidecar in (False, True):
            container = controller_of(k.gen.render(_args(solver_sidecar=sidecar)))["spec"]["template"]["spec"]["containers"][0]
            assert container["name"] == "controller"
            want = {"cpu": "1", "memory": "1Gi", **({"nvidia.com/gpu": "1"} if k.side == "port" else {})}
            assert container["resources"]["requests"] == want
            assert container["resources"]["limits"] == want

    def test_sidecar_carries_device_resource(self, k):
        docs = k.gen.render(_args(solver_sidecar=True, tpu_resource=f"{k.device}=4"))
        containers = {c["name"]: c for c in controller_of(docs)["spec"]["template"]["spec"]["containers"]}
        assert containers["solver"]["resources"]["requests"] == {k.device: "4"}
        assert containers["solver"]["resources"]["limits"] == {k.device: "4"}
        package = "karpenter_tpu" if k.side == "ref" else "karpenter_tpu_torch"
        assert containers["solver"]["command"] == ["python", "-m", f"{package}.cmd.solver_service"]

    def test_interruption_queue_wires_args_and_settings(self, k):
        docs = k.gen.render(_args(interruption_queue="karpenter-interruptions"))
        args = controller_of(docs)["spec"]["template"]["spec"]["containers"][0]["args"]
        assert args[args.index("--interruption-queue") + 1] == "karpenter-interruptions"
        cm = next(d for d in by_kind(docs, "ConfigMap") if d["metadata"]["name"] == k.CONFIGMAP_NAME)
        assert cm["data"]["interruptionQueueName"] == "karpenter-interruptions"
        plain = k.gen.render(_args())
        assert "--interruption-queue" not in controller_of(plain)["spec"]["template"]["spec"]["containers"][0]["args"]

    def test_controller_never_schedules_on_managed_capacity(self, k):
        terms = controller_of(k.gen.render(_args()))["spec"]["template"]["spec"]["affinity"]["nodeAffinity"][
            "requiredDuringSchedulingIgnoredDuringExecution"
        ]["nodeSelectorTerms"]
        assert any(
            expr["key"] == "karpenter.sh/provisioner-name" and expr["operator"] == "DoesNotExist"
            for term in terms
            for expr in term["matchExpressions"]
        )

    def test_rbac_covers_runtime_verbs(self, k):
        docs = k.gen.render(_args())
        cluster_role = by_kind(docs, "ClusterRole")[0]
        flat = [(g, r, v) for rule in cluster_role["rules"] for g in rule["apiGroups"] for r in rule["resources"] for v in rule["verbs"]]
        assert ("", "pods/eviction", "create") in flat
        assert ("", "nodes", "create") in flat and ("", "nodes", "delete") in flat
        assert ("karpenter.sh", "provisioners", "watch") in flat
        role = by_kind(docs, "Role")[0]
        lease_verbs = {v for rule in role["rules"] if "leases" in rule["resources"] for v in rule["verbs"]}
        assert {"create", "update"} <= lease_verbs

    def test_crd_schema_covers_disruption_budgets(self, k):
        crd = next(d for d in by_kind(k.gen.render(_args()), "CustomResourceDefinition") if d["metadata"]["name"] == "provisioners.karpenter.sh")
        spec_props = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]["properties"]
        budget = spec_props["disruption"]["properties"]["budgets"]["items"]
        assert budget["required"] == ["nodes"]
        assert set(budget["properties"]) == {"nodes", "schedule", "duration"}


# -- the port's render against the JAX package's --------------------------------


def _substituted(text: str) -> str:
    """The JAX package's render with the port's module path and device."""
    return text.replace("karpenter_tpu.cmd.", "karpenter_tpu_torch.cmd.").replace(DEVICE["ref"], DEVICE["port"])


def _substituted_render(text: str) -> str:
    """The JAX package's render substituted, with one card added to the
    controller container's requests and limits, dumped as the render is."""
    docs = list(yaml.safe_load_all(_substituted(text)))
    controller = next(c for c in controller_of(docs)["spec"]["template"]["spec"]["containers"] if c["name"] == "controller")
    for part in ("requests", "limits"):
        assert DEVICE["port"] not in controller["resources"][part]
        controller["resources"][part][DEVICE["port"]] = "1"
    return yaml.safe_dump_all(docs, sort_keys=False)


@pytest.mark.parametrize("target", [0, 1], ids=["karpenter-tpu.yaml", "karpenter-tpu-sidecar.yaml"])
def test_port_render_is_the_reference_render_substituted(target):
    ref, port = MKit("ref"), MKit("port")
    ref_file, ref_argv = ref.gen.CHECK_TARGETS[target]
    port_file, port_argv = port.gen.CHECK_TARGETS[target]
    assert port_file == ref_file
    assert list(port_argv) == [_substituted(a) for a in ref_argv]
    ref_text, port_text = rendered(ref, ref_argv), rendered(port, port_argv)
    assert ref_text == (REPO / "deploy" / ref_file).read_text()
    assert port_text == _substituted_render(ref_text)
    assert "karpenter_tpu.cmd." not in port_text and DEVICE["ref"] not in port_text


# -- the port's --check ------------------------------------------------------------


def _check(*args):
    return subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.cmd.gen_manifests", "--check", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )


def test_check_without_a_directory_is_an_error():
    from karpenter_tpu_torch.cmd import gen_manifests

    out = _check()
    assert out.returncode == 2 and "directory" in out.stderr
    with pytest.raises(TypeError):
        gen_manifests.check()  # no default directory


def test_check_passes_after_a_render_and_fails_on_a_stale_file(tmp_path):
    port = MKit("port")
    assert _check(str(tmp_path)).returncode == 1  # nothing rendered there yet
    for filename, argv in port.gen.CHECK_TARGETS:
        (tmp_path / filename).write_text(rendered(port, argv))
    current = _check(str(tmp_path))
    assert current.returncode == 0, current.stderr
    (tmp_path / "karpenter-tpu.yaml").write_text("# stale\n")
    stale = _check(str(tmp_path))
    assert stale.returncode == 1
    assert "karpenter-tpu.yaml is stale" in stale.stderr
    assert "karpenter_tpu_torch.cmd.gen_manifests" in stale.stderr
