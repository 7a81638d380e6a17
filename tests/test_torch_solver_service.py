"""The solver sidecar, held on both packages over a gRPC loopback.

Every case of tests/test_solver_service.py runs against the JAX package's
sidecar and the port's (its DenseSolver on the CPU) with the same inputs,
and the two launch plans must be equal: new nodes (provisioner, instance
type options in price order, the pods by their index in the request),
placements on existing nodes, unschedulable pods. Where the JAX package
falls back to the local scheduler on an unreachable sidecar
(tests/test_solver_service.py:208), the port's RemoteSchedulingError leaves
provision_once() (ROADMAP C).

The port's own: the in-process byte round trip that chip_smoke.py drives on
the card (build_request -> pickle -> SolverServer.schedule_bytes -> pickle
-> materialize) equals the gRPC one, and a capacity-failure re-solve's
nominated pods ship as cluster pods bound to their nodes.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

pytest.importorskip("grpc")

from tests.test_torch_provisioning import reference_singletons  # noqa: F401

SIDES = ("ref", "port")


@pytest.fixture(autouse=True)
def reference_auditor_off(reference_singletons):  # noqa: F811
    """The reference's residency auditor seeds random.Random with a tuple,
    which Python 3.12 rejects, so its dense solves would fall back to the
    host loop; it is disabled here and restored by reference_singletons."""
    from karpenter_tpu.solver.audit import AUDITOR

    AUDITOR.disable()
    yield


class SKit:
    """The sidecar-level classes and builders of one package."""

    def __init__(self, side: str):
        self.side = side
        if side == "ref":
            from karpenter_tpu import runtime
            from karpenter_tpu.api import labels, objects, provisioner
            from karpenter_tpu.cloudprovider import fake
            from karpenter_tpu.kube.cluster import KubeCluster
            from karpenter_tpu.scheduler import build_scheduler
            from karpenter_tpu.scheduler.builder import apply_kubelet_max_pods
            from karpenter_tpu.service import client, server
            from karpenter_tpu.solver import DenseSolver
            from karpenter_tpu.utils.options import Options
            from tests import helpers

            self.make_pod, self.make_provisioner = helpers.make_pod, helpers.make_provisioner
            self.make_node, self.make_state_node = helpers.make_node, helpers.make_state_node
            self.solver = lambda: DenseSolver(min_batch=1)
            self.extra = {}
        else:
            from karpenter_tpu_torch import runtime, testing
            from karpenter_tpu_torch.api import labels, objects, provisioner
            from karpenter_tpu_torch.cloudprovider import fake
            from karpenter_tpu_torch.kube.cluster import KubeCluster
            from karpenter_tpu_torch.scheduler import build_scheduler
            from karpenter_tpu_torch.scheduler.builder import apply_kubelet_max_pods
            from karpenter_tpu_torch.service import client, server
            from karpenter_tpu_torch.solver import DenseSolver
            from karpenter_tpu_torch.utils.options import Options

            self.make_pod, self.make_provisioner = testing.make_pod, testing.make_provisioner
            self.make_node, self.make_state_node = testing.make_node, testing.make_state_node
            self.solver = lambda: DenseSolver(min_batch=1, device="cpu")
            self.extra = {"device": "cpu"}
        self.runtime, self.labels, self.objects, self.provisioner = runtime, labels, objects, provisioner
        self.fake, self.KubeCluster, self.build_scheduler = fake, KubeCluster, build_scheduler
        self.apply_kubelet_max_pods, self.client, self.server, self.Options = apply_kubelet_max_pods, client, server, Options

    def serve(self):
        return self.server.serve("127.0.0.1:0", **self.extra)

    def types(self, provisioner, n: int):
        return {provisioner.name: self.fake.FakeCloudProvider(self.fake.instance_types(n)).get_instance_types(provisioner)}

    def Runtime(self, kube, n_types: int, **options):
        return self.runtime.Runtime(
            kube=kube, cloud_provider=self.fake.FakeCloudProvider(self.fake.instance_types(n_types)),
            options=self.Options(**options), **self.extra,
        )

    def node_labels(self, **extra):
        lbl = self.labels
        labels = {
            lbl.PROVISIONER_NAME_LABEL: "default",
            lbl.LABEL_INSTANCE_TYPE: "fake-it-9",
            lbl.LABEL_TOPOLOGY_ZONE: "test-zone-1",
            lbl.LABEL_CAPACITY_TYPE: "on-demand",
        }
        labels.update(extra)
        return labels


@pytest.fixture(scope="module")
def services():
    """One sidecar and one client per package, for the module."""
    made = {}
    for side in SIDES:
        kit = SKit(side)
        server, port, handler = kit.serve()
        made[side] = (kit, kit.client.SolverClient(f"127.0.0.1:{port}", timeout=30.0), handler, server)
    yield made
    for kit, client, handler, server in made.values():
        client.close()
        server.stop(grace=0.5)


@pytest.fixture(autouse=True)
def _process_state():
    yield
    from karpenter_tpu.runtime import LeaderElector

    LeaderElector._leader = None
    for side in SIDES:
        from importlib import import_module

        pkg = "karpenter_tpu" if side == "ref" else "karpenter_tpu_torch"
        logsetup = import_module(f"{pkg}.logsetup")
        logsetup.reset_for_tests()
        logsetup.set_level("info")


def plan(results, pods) -> dict:
    """A launch plan in package-neutral terms: pods by request index."""
    index = {p.uid: i for i, p in enumerate(pods)}
    return {
        "new": sorted(
            (n.provisioner_name, tuple(it.name() for it in n.instance_type_options), tuple(sorted(index[p.uid] for p in n.pods)))
            for n in results.new_nodes
            if n.pods
        ),
        "existing": sorted((v.node.name, tuple(sorted(index[p.uid] for p in v.pods))) for v in results.existing_nodes if v.pods),
        "unschedulable": sorted(index[p.uid] for p in results.unschedulable),
    }


def cost_of(nodes):
    return sum(min(it.price() for it in n.instance_type_options) for n in nodes)


def mixed_workload(kit, n=60):
    objects, lbl = kit.objects, kit.labels
    rng = np.random.default_rng(17)
    pods = []
    for i in range(n):
        req = {"cpu": [0.25, 0.5, 1.0][rng.integers(3)], "memory": "512Mi"}
        if i % 5 == 0:
            lab = {"s": "ab"[rng.integers(2)]}
            pods.append(kit.make_pod(labels=lab, requests=req, topology_spread_constraints=[
                objects.TopologySpreadConstraint(max_skew=1, topology_key=lbl.LABEL_TOPOLOGY_ZONE, label_selector=objects.LabelSelector(match_labels=lab))]))
        elif i % 7 == 0:
            lab = {"a": "xy"[rng.integers(2)]}
            pods.append(kit.make_pod(labels=lab, requests=req, pod_anti_requirements=[
                objects.PodAffinityTerm(topology_key=lbl.LABEL_HOSTNAME, label_selector=objects.LabelSelector(match_labels=lab))]))
        else:
            pods.append(kit.make_pod(requests=req))
    return pods


def both(services, case):
    """Run `case(kit, client, handler)` on each package; the outcomes."""
    return {side: case(*services[side][:3]) for side in SIDES}


class TestRemoteParity:
    def test_remote_matches_local_layout(self, services):
        def case(kit, client, handler):
            pods = mixed_workload(kit)
            provisioner = kit.make_provisioner()
            types = kit.types(provisioner, 15)
            remote = client.solve([provisioner], types, pods)
            local = kit.build_scheduler(
                [provisioner], kit.fake.FakeCloudProvider(types[provisioner.name]), pods, dense_solver=kit.solver()
            ).solve(pods)
            assert sum(len(n.pods) for n in remote.new_nodes) == sum(len(n.pods) for n in local.new_nodes) == 60
            assert abs(cost_of(remote.new_nodes) - cost_of([n for n in local.new_nodes if n.pods])) < 1e-6
            assert not remote.unschedulable
            assert handler.solves >= 1
            return plan(remote, pods), plan(local, pods)

        got = both(services, case)
        assert got["ref"] == got["port"]

    def test_remote_fills_existing_nodes(self, services):
        def case(kit, client, handler):
            state = kit.make_state_node(name="warm-1", labels=kit.node_labels(), allocatable={"cpu": 16, "memory": "32Gi", "pods": 110})
            pods = [kit.make_pod(requests={"cpu": 1, "memory": "1Gi"}) for _ in range(10)]
            provisioner = kit.make_provisioner()
            remote = client.solve([provisioner], kit.types(provisioner, 15), pods, state_nodes=[state])
            assert not remote.new_nodes, "existing capacity fits everything"
            assert sum(len(v.pods) for v in remote.existing_nodes) == 10
            assert remote.existing_nodes[0].node.name == state.node.name
            return plan(remote, pods)

        got = both(services, case)
        assert got["ref"] == got["port"]

    def test_cluster_pod_topology_counts_cross_the_wire(self, services):
        """A bound cluster pod populates the affinity domain; the remote
        solve must pin the cohort to that host, not bootstrap a fresh one."""

        def case(kit, client, handler):
            objects, lbl = kit.objects, kit.labels
            kube = kit.KubeCluster()
            node = kit.make_node(name="aff-host", labels=kit.node_labels(), allocatable={"cpu": 16, "memory": "32Gi", "pods": 110})
            kube.create(node)
            cohort = {"app": "svc"}
            kube.create(kit.make_pod(labels=cohort, requests={"cpu": 0.5}, node_name="aff-host", phase="Running", unschedulable=False))
            term = objects.PodAffinityTerm(topology_key=lbl.LABEL_HOSTNAME, label_selector=objects.LabelSelector(match_labels=cohort))
            pods = [kit.make_pod(labels=cohort, requests={"cpu": 0.5}, pod_requirements=[term]) for _ in range(3)]
            state = kit.make_state_node(node=node, available={"cpu": 15.5, "memory": "31Gi", "pods": 100})
            provisioner = kit.make_provisioner()
            remote = client.solve([provisioner], kit.types(provisioner, 15), pods, state_nodes=[state], kube=kube)
            assert not remote.new_nodes, "populated required affinity must join the existing host"
            assert sum(len(v.pods) for v in remote.existing_nodes) == 3
            return plan(remote, pods)

        got = both(services, case)
        assert got["ref"] == got["port"]

    def test_server_error_propagates(self, services):
        def case(kit, client, handler):
            provisioner = kit.make_provisioner()
            with pytest.raises(kit.client.RemoteSchedulingError, match="remote solve failed"):
                # bogus instance types make the server-side solve blow up
                client.solve([provisioner], {provisioner.name: [object()]}, [kit.make_pod(requests={"cpu": 1}) for _ in range(2)])
            return True

        assert both(services, case) == {"ref": True, "port": True}

    def test_health_reports_solves(self, services):
        got = both(services, lambda kit, client, handler: (client.health()["ok"], client.health()["solves"] == handler.solves))
        assert got == {"ref": (True, True), "port": (True, True)}


class TestRuntimeIntegration:
    def test_provisioning_through_the_sidecar(self):
        def case(kit):
            server, port, handler = kit.serve()
            kube = kit.KubeCluster()
            # dense_min_batch=1 opens the sub-crossover remote gate so this
            # 5-pod batch still exercises the sidecar path
            rt = kit.Runtime(kube, 8, solver_service_address=f"127.0.0.1:{port}", dense_min_batch=1)
            try:
                kube.create(kit.make_provisioner())
                pods = [kit.make_pod(requests={"cpu": 0.5}) for _ in range(5)]
                for pod in pods:
                    kube.create(pod)
                results = rt.provision_once()
                assert sum(len(n.pods) for n in results.new_nodes) == 5
                assert kube.list_nodes(), "nodes launched from the remote plan"
                assert handler.solves == 1
                return plan(results, kube.list_pods()), len(kube.list_nodes())
            finally:
                rt.stop()
                server.stop(grace=0.5)

        assert case(SKit("ref")) == case(SKit("port"))

    def test_kubelet_max_pods_caps_remote_launch_options(self, services):
        def case(kit, client, handler):
            provisioner = kit.make_provisioner(kubelet_configuration=kit.provisioner.KubeletConfiguration(max_pods=1))
            types = {
                provisioner.name: kit.apply_kubelet_max_pods(
                    provisioner, kit.fake.FakeCloudProvider(kit.fake.instance_types(6)).get_instance_types(provisioner)
                )
            }
            pods = [kit.make_pod(requests={"cpu": 0.1}) for _ in range(3)]
            results = client.solve([provisioner], types, pods)
            assert sum(len(n.pods) for n in results.new_nodes) == 3
            assert len(results.new_nodes) == 3, "maxPods=1 must split nodes on the remote path"
            for node in results.new_nodes:
                assert all(it.resources().get("pods") == 1.0 for it in node.instance_type_options)
            return plan(results, pods)

        got = both(services, case)
        assert got["ref"] == got["port"]

    def test_sub_crossover_batches_stay_local_despite_sidecar(self):
        def case(kit):
            server, port, handler = kit.serve()
            kube = kit.KubeCluster()
            rt = kit.Runtime(kube, 8, solver_service_address=f"127.0.0.1:{port}")  # measured crossover gate
            try:
                kube.create(kit.make_provisioner())
                for _ in range(5):
                    kube.create(kit.make_pod(requests={"cpu": 0.5}))
                results = rt.provision_once()
                assert sum(len(n.pods) for n in results.new_nodes) == 5
                assert handler.solves == 0, "5-pod batch must be solved locally"
                return plan(results, kube.list_pods())
            finally:
                rt.stop()
                server.stop(grace=0.5)

        assert case(SKit("ref")) == case(SKit("port"))

    @pytest.mark.parametrize("side", SIDES)
    def test_unreachable_sidecar(self, side):
        """The JAX package falls back to the local scheduler; the port's
        RemoteSchedulingError leaves provision_once() and nothing launches."""
        kit = SKit(side)
        kube = kit.KubeCluster()
        rt = kit.Runtime(kube, 8, solver_service_address="127.0.0.1:1", dense_min_batch=1)  # nothing listens
        try:
            kube.create(kit.make_provisioner())
            kube.create(kit.make_pod(requests={"cpu": 0.5}))
            rt.provisioner.remote_solver.timeout = 0.5  # don't wait out the default
            if side == "ref":
                results = rt.provision_once()
                assert sum(len(n.pods) for n in results.new_nodes) == 1
                assert kube.list_nodes(), "local fallback must still provision"
            else:
                with pytest.raises(kit.client.RemoteSchedulingError, match="unreachable"):
                    rt.provision_once()
                assert not kube.list_nodes(), "no local solve stands in for the sidecar"
        finally:
            rt.stop()


class TestTightenedRequirementsCrossTheWire:
    def test_zone_pinned_pod_launches_in_its_zone(self, services):
        def case(kit, client, handler):
            provisioner = kit.make_provisioner()
            pods = [kit.make_pod(requests={"cpu": 0.5}, node_selector={kit.labels.LABEL_TOPOLOGY_ZONE: "test-zone-2"}) for _ in range(3)]
            results = client.solve([provisioner], kit.types(provisioner, 10), pods)
            assert results.new_nodes
            for node in results.new_nodes:
                zone_req = node.template.requirements.get(kit.labels.LABEL_TOPOLOGY_ZONE)
                assert list(zone_req.values) == ["test-zone-2"], "zone pin lost across the wire"
            return plan(results, pods)

        got = both(services, case)
        assert got["ref"] == got["port"]

    def test_inverse_anti_affinity_of_bound_pods_enforced(self, services):
        def case(kit, client, handler):
            objects, lbl = kit.objects, kit.labels
            kube = kit.KubeCluster()
            labels = kit.node_labels(**{lbl.LABEL_HOSTNAME: "anti-host"})
            node = kit.make_node(name="anti-host", labels=labels, allocatable={"cpu": 16, "memory": "32Gi", "pods": 110})
            kube.create(node)
            selector = objects.LabelSelector(match_labels={"app": "web"})
            kube.create(kit.make_pod(
                labels={"app": "web"}, requests={"cpu": 0.5},
                pod_anti_requirements=[objects.PodAffinityTerm(topology_key=lbl.LABEL_HOSTNAME, label_selector=selector)],
                node_name="anti-host", phase="Running", unschedulable=False,
            ))
            state = kit.make_state_node(node=node, available={"cpu": 15.5, "memory": "31Gi", "pods": 100})
            provisioner = kit.make_provisioner()
            pods = [kit.make_pod(labels={"app": "web"}, requests={"cpu": 0.5})]
            results = client.solve([provisioner], kit.types(provisioner, 10), pods, state_nodes=[state], kube=kube)
            assert sum(len(v.pods) for v in results.existing_nodes) == 0
            assert sum(len(n.pods) for n in results.new_nodes) == 1
            return plan(results, pods)

        got = both(services, case)
        assert got["ref"] == got["port"]

    def test_consolidation_simulation_goes_remote(self, services):
        def case(kit, client, handler):
            provisioner = kit.make_provisioner()
            before = handler.solves
            pods = [kit.make_pod(requests={"cpu": 0.5}) for _ in range(4)]
            results = client.solve(
                [provisioner], kit.types(provisioner, 10), pods, simulation_mode=True, exclude_nodes=["gone-node"],
            )
            assert handler.solves == before + 1
            assert sum(len(n.pods) for n in results.new_nodes) == 4
            return plan(results, pods)

        got = both(services, case)
        assert got["ref"] == got["port"]


# -- the port's own -----------------------------------------------------------


def _overflow_request(kit):
    """A warm request: a mixed batch onto two standing nodes, one bound pod."""
    kube = kit.KubeCluster()
    states = []
    for name in ("warm-a", "warm-b"):
        node = kit.make_node(name=name, labels=kit.node_labels(**{kit.labels.LABEL_HOSTNAME: name}), allocatable={"cpu": 4, "memory": "8Gi", "pods": 110})
        kube.create(node)
        states.append(kit.make_state_node(node=node, available={"cpu": 3.5, "memory": "7Gi", "pods": 100}))
    kube.create(kit.make_pod(requests={"cpu": 0.5}, node_name="warm-a", phase="Running", unschedulable=False))
    provisioner = kit.make_provisioner()
    return [provisioner], kit.types(provisioner, 15), mixed_workload(kit), states, kube


def test_in_process_byte_round_trip_equals_grpc(services):
    """chip_smoke.py's sidecar phase: the client's request function, the
    handler serve() registers and the client's materialize, in process."""
    kit, client, handler, _ = services["port"]
    provisioners, types, pods, states, kube = _overflow_request(kit)
    over_grpc = client.solve(provisioners, types, pods, state_nodes=states, kube=kube)
    request = kit.client.build_request(provisioners, types, pods, state_nodes=states, kube=kube)
    response = pickle.loads(handler.schedule_bytes(pickle.dumps(request)))
    in_process = kit.client.materialize(response, provisioners, types, pods, states)
    assert plan(in_process, pods) == plan(over_grpc, pods)
    assert plan(in_process, pods)["existing"], "the request fills the standing nodes"
    local = kit.build_scheduler(
        provisioners, kit.fake.FakeCloudProvider(types[provisioners[0].name]), pods, kube=kube,
        state_nodes=states, dense_solver=kit.solver(),
    ).solve(pods)
    assert plan(in_process, pods) == plan(local, pods)


def test_nominated_pods_ship_bound_to_their_nodes():
    kit = SKit("port")
    provisioners, types, pods, states, kube = _overflow_request(kit)
    placed = [("warm-b", pods[:2])]
    request = kit.client.build_request(provisioners, types, pods[2:], state_nodes=states, kube=kube, nominated=placed)
    shipped = {p.uid: p.spec.node_name for p in request.cluster_pods}
    assert shipped[pods[0].uid] == shipped[pods[1].uid] == "warm-b"
    assert len(shipped) == 3, "the bound pod and the two nominated ones"
    assert not pods[0].spec.node_name, "the live pod stays unbound"


def test_solver_server_defaults_to_the_card(monkeypatch):
    import torch

    from karpenter_tpu_torch.service.server import SolverServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverServer()


def test_request_over_four_mib_crosses_the_wire(services):
    """A request past gRPC's 4 MiB default (a 10,000-pod batch pickles to
    about 7 MB; here 40 pods carrying 120 kB annotations): the JAX package's
    channel refuses it (RESOURCE_EXHAUSTED), the port's, whose ends take
    messages up to wire.MAX_MESSAGE_BYTES, solves it as the local scheduler
    does."""

    def case(kit, client, handler):
        provisioner = kit.make_provisioner()
        types = kit.types(provisioner, 15)
        pods = [kit.make_pod(requests={"cpu": 0.5}, annotations={"payload": "x" * 120_000}) for _ in range(40)]
        assert len(pickle.dumps(pods)) > 4 * 1024 * 1024
        try:
            remote = client.solve([provisioner], types, pods)
        except kit.client.RemoteSchedulingError as err:
            return ("refused", "RESOURCE_EXHAUSTED" in str(err))
        local = kit.build_scheduler(
            [provisioner], kit.fake.FakeCloudProvider(types[provisioner.name]), pods, dense_solver=kit.solver()
        ).solve(pods)
        return ("solved", plan(remote, pods) == plan(local, pods))

    got = both(services, case)
    assert got["ref"] == ("refused", True)
    assert got["port"] == ("solved", True)


def test_request_over_the_message_cap_is_refused(services):
    """A request past wire.MAX_MESSAGE_BYTES (64 MiB; here 40 pods carrying
    1.7 MB annotations) is refused on the port's channel with
    RESOURCE_EXHAUSTED, and the sidecar solves nothing."""
    from karpenter_tpu_torch.service.wire import MAX_MESSAGE_BYTES

    kit, client, handler, _server = services["port"]
    provisioner = kit.make_provisioner()
    types = kit.types(provisioner, 15)
    pods = [kit.make_pod(requests={"cpu": 0.5}, annotations={"payload": "x" * 1_700_000}) for _ in range(40)]
    assert len(pickle.dumps(pods)) > MAX_MESSAGE_BYTES
    solves = handler.solves
    with pytest.raises(kit.client.RemoteSchedulingError, match="RESOURCE_EXHAUSTED"):
        client.solve([provisioner], types, pods)
    assert handler.solves == solves


# -- ROADMAP C2: the capacity-failure re-solve through the sidecar ---------------


@pytest.mark.parametrize("refused", ["most_launched_type", "every_launched_type"])
def test_strict_ice_round_through_the_sidecar_equals_in_process(refused, services):
    """tests/test_torch_provisioner_ice.py's first case on the port, dense,
    once in process and once with every solve of the round sent to the
    sidecar (min_batch 1): the first solve, each re-solve (its batch and
    the round's nominated pods, shipped bound to their nodes), the launches
    with the pods nominated onto each, the parked pods, and no node over
    capacity must be the same."""
    from tests.test_torch_provisioner_ice import _env_with_batch, _nominations, _overbooked, _refused_types, _strict, _watch
    from tests.test_torch_provisioning import Kit

    _kit, client, handler, _server = services["port"]

    def round_of(remote: bool):
        k = Kit("port", "dense")
        first = _env_with_batch(k)
        first.provision()
        quarantined = _refused_types(first, k, refused)
        env = _env_with_batch(k)
        pools = _strict(env, k, quarantined)
        controller = env.provisioner_controller
        if remote:
            controller.remote_solver = client
        calls = _watch(controller)
        solves = handler.solves
        env.provision()
        remote_solves = handler.solves - solves
        lbl = k.lbl
        nominated = _nominations(env)
        launched = []
        for node in env.kube.list_nodes():
            labels = node.metadata.labels
            pool = (labels[lbl.LABEL_INSTANCE_TYPE], labels[lbl.LABEL_TOPOLOGY_ZONE], labels[lbl.LABEL_CAPACITY_TYPE])
            assert pool not in pools, f"node {node.name} launched on a quarantined pool"
            launched.append((node.name, *pool, tuple(sorted(nominated.get(node.name, {})))))
        record = {
            "schedule": calls["schedule"],
            "ice": calls["ice"],
            "launched": sorted(launched),
            "parked": sorted(name for _ns, name in controller._ice_backoff),
            "overbooked": _overbooked(env, k),
        }
        return record, remote_solves

    local, local_solves = round_of(remote=False)
    remote, remote_solves = round_of(remote=True)
    assert local_solves == 0 and remote_solves == len(remote["schedule"]) >= 2, "every solve of the round, re-solves too, goes to the sidecar"
    assert remote["overbooked"] == [] and local["overbooked"] == []
    assert remote == local
