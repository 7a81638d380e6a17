"""The port's provisioning round held against the JAX package, case by case.

Every case of tests/test_provisioning.py runs here on both packages: the
reference through tests/env.py's Environment and tests/helpers.py, the port
through karpenter_tpu_torch/testing.py's Environment and builders. A
scenario is written once against a `Kit` (one package's classes and
builders) and driven on each side with the same inputs: pod and node names
come from a per-kit counter, so the two sides name their objects alike. The
case's own assertions run on both sides, and the two outcomes must be
equal: the launched nodes (instance type, zone, capacity type, provisioner
and the pods nominated onto each, matched up to the provider's node names),
the nominations onto nodes that were not launched, the FailedScheduling
events and, per round, the unschedulable pods with their errors (the
virtual nodes' placeholder hostnames, numbered process-wide, left out).

Each case runs with the exact host loop and with the dense solve at
min_batch=1 (the reference's DenseSolver on JAX's CPU, without the mesh;
the port's on device="cpu", the kernels' plain versions). The reference's
process-wide singletons that a round touches (the metrics registry, the
tracer, the journal, the flight recorder, the fault injector, the breaker
and the residency auditor) are restored after every test.

The helpers of this module (Kit, both, outcome and the autouse fixture)
serve the other test_torch_*provisioning/ICE/dense-existing files too.
"""

from __future__ import annotations

import copy
import itertools
import logging
import re

import pytest

MODES = ("host", "dense")


# -- the reference's singletons, restored after every test ------------------


def _state(obj) -> dict:
    saved = {}
    for key, value in vars(obj).items():
        try:
            saved[key] = copy.deepcopy(value)
        except TypeError:  # locks, thread-locals: kept as they are
            saved[key] = value
    return saved


def _restore(obj, saved: dict) -> None:
    vars(obj).clear()
    vars(obj).update(saved)


@pytest.fixture(autouse=True)
def reference_singletons():
    """Snapshot the JAX package's process-wide singletons and put them back
    after the test, however it ends."""
    from karpenter_tpu.flight import FLIGHT
    from karpenter_tpu.journal import JOURNAL
    from karpenter_tpu.metrics import REGISTRY
    from karpenter_tpu.solver.audit import AUDITOR
    from karpenter_tpu.solver.faults import BREAKER, FAULTS
    from karpenter_tpu.tracing import DECISIONS, TRACER

    objs = (AUDITOR, TRACER, DECISIONS, JOURNAL, FLIGHT, FAULTS, BREAKER)
    saved = [(obj, _state(obj)) for obj in objs]
    metrics = {name: _state(metric) for name, metric in REGISTRY._metrics.items()}
    try:
        yield
    finally:
        for obj, state in saved:
            _restore(obj, state)
        for name, metric in list(REGISTRY._metrics.items()):
            if name in metrics:
                _restore(metric, metrics[name])
            else:
                metric.clear()


# -- one package's side of a scenario ----------------------------------------


class Kit:
    """The classes and builders of one package ("ref" or "port"), with the
    solver the mode asks for and deterministic object names."""

    def __init__(self, side: str, mode: str):
        self.side, self.mode = side, mode
        self.reset_names()
        if side == "ref":
            from karpenter_tpu.api import labels, objects, provisioner
            from karpenter_tpu.cloudprovider import fake, types
            from karpenter_tpu.kube import cluster as kube
            from karpenter_tpu.scheduler import SchedulerOptions, build_scheduler
            from karpenter_tpu.solver import DenseSolver
            from karpenter_tpu.utils import resources
            from tests import helpers
            from tests.env import Environment

            self.make_pod, self.make_provisioner = helpers.make_pod, helpers.make_provisioner
            self.make_node, self.make_state_node = helpers.make_node, helpers.make_state_node
            self.solver_class = DenseSolver
            self.solver_kwargs = {"use_mesh": False}
        else:
            from karpenter_tpu_torch import testing
            from karpenter_tpu_torch.api import labels, objects, provisioner
            from karpenter_tpu_torch.cloudprovider import fake, types
            from karpenter_tpu_torch.kube import cluster as kube
            from karpenter_tpu_torch.scheduler import SchedulerOptions, build_scheduler
            from karpenter_tpu_torch.solver import DenseSolver
            from karpenter_tpu_torch.utils import resources
            from karpenter_tpu_torch.testing import Environment

            self.make_pod, self.make_provisioner = testing.make_pod, testing.make_provisioner
            self.make_node, self.make_state_node = testing.make_node, testing.make_state_node
            self.solver_class = DenseSolver
            self.solver_kwargs = {"device": "cpu"}
        self.Environment = Environment
        self.lbl, self.obj, self.api_provisioner = labels, objects, provisioner
        self.fake, self.cloud_types, self.kube_module = fake, types, kube
        self.build_scheduler, self.SchedulerOptions = build_scheduler, SchedulerOptions
        self.res = resources

    def solver(self, min_batch: int = 1, **kwargs):
        return self.solver_class(min_batch=min_batch, **self.solver_kwargs, **kwargs)

    def mode_solver(self):
        """The dense solver of this kit's mode: None for the host loop."""
        return self.solver() if self.mode == "dense" else None

    def env(self, instance_types=None, provisioners=None, parallel_launches=False):
        """An Environment with this mode's solver and, unless `provisioners`
        is [], the given provisioners (default: one default provisioner).

        Its nodes launch one at a time unless `parallel_launches`: the fake
        provider names nodes in the order its create calls arrive, and a
        later solve walks the cluster's nodes in the order they arrived, so
        parallel launches would let thread timing decide which launched node
        a later pod joins."""
        env = self.Environment(instance_types=instance_types, dense_solver=self.mode_solver())
        if not parallel_launches:
            env.provisioner_controller.LAUNCH_WORKERS = 1
        for prov in [self.make_provisioner()] if provisioners is None else provisioners:
            env.kube.create(prov)
        return env

    def reset_names(self) -> None:
        self._pods = itertools.count()
        self._nodes = itertools.count()

    def pod(self, **kwargs):
        kwargs.setdefault("name", f"p{next(self._pods):04d}")
        return self.make_pod(**kwargs)

    def pods(self, count: int, **kwargs):
        return [self.pod(**kwargs) for _ in range(count)]

    def node(self, **kwargs):
        kwargs.setdefault("name", f"n{next(self._nodes):04d}")
        return self.make_node(**kwargs)


def _unnamed(message: str) -> str:
    """An error message without the virtual nodes' placeholder hostnames,
    which come from a process-wide counter in each package."""
    return re.sub(r"hostname-placeholder-\d+", "hostname-placeholder", message)


def round_outcome(results) -> dict:
    """What one round decided: new nodes (first option's type and pods),
    existing-node placements and the unschedulable pods with their errors."""
    return {
        "new": sorted(
            (n.instance_type_options[0].name() if n.instance_type_options else "", tuple(sorted(p.name for p in n.pods)))
            for n in results.new_nodes
            if n.pods
        ),
        "existing": sorted((v.node.name, tuple(sorted(p.name for p in v.pods))) for v in results.existing_nodes if v.pods),
        "unschedulable": sorted((p.name, _unnamed(str(err))) for p, err in results.unschedulable.items()),
    }


def outcome(env, kit: Kit) -> dict:
    """What the environment shows after a scenario: the launched nodes (up
    to their names), the nominations onto other nodes, the FailedScheduling
    events and the pods the dense solver committed (on existing nodes)."""
    lbl = kit.lbl
    nominated = {}
    for event in env.recorder.of("NominatePod"):
        nominated.setdefault(event.message.split()[-1], []).append(event.object_name)
    launched, others = [], []
    live = env.provider.live_instances
    for node in env.kube.list_nodes():
        pods = tuple(sorted(nominated.pop(node.name, [])))
        if node.name in live:
            labels = node.metadata.labels
            launched.append((
                labels.get(lbl.LABEL_INSTANCE_TYPE), labels.get(lbl.LABEL_TOPOLOGY_ZONE),
                labels.get(lbl.LABEL_CAPACITY_TYPE), labels.get(lbl.PROVISIONER_NAME_LABEL), pods,
            ))
        elif pods:
            others.append((node.name, pods))
    solver = env.provisioner_controller.dense_solver
    return {
        "dense_committed": None if solver is None else (solver.stats.pods_committed, solver.stats.pods_on_existing),
        "launched": sorted(launched),
        "nominated_elsewhere": sorted(others) + sorted((name, tuple(sorted(p))) for name, p in nominated.items()),
        "failed_scheduling": sorted((e.object_name, _unnamed(e.message)) for e in env.recorder.of("FailedScheduling")),
    }


class _FailOpen(logging.Handler):
    """Catches the JAX package's scheduler falling back from a failed dense
    presolve to the host loop (it logs the exception and goes on)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        if "dense presolve failed" in record.getMessage():
            self.messages.append(record.getMessage())


def run_both(scenario, mode: str):
    """Run `scenario(kit)` on the reference and on the port in `mode`; it
    returns a JSON-like record of what it saw (outcome/round_outcome
    snapshots). The reference's dense presolve must not have failed open to
    its host loop. Returns (reference's record, port's record)."""
    handler = _FailOpen()
    ref_logger = logging.getLogger("karpenter_tpu.scheduler")
    ref_logger.addHandler(handler)
    try:
        ref = scenario(Kit("ref", mode))
    finally:
        ref_logger.removeHandler(handler)
    assert handler.messages == [], "the reference's dense presolve failed open"
    return ref, scenario(Kit("port", mode))


def both(scenario, mode: str):
    """run_both, and the two records must be equal. Returns the port's
    record."""
    ref, port = run_both(scenario, mode)
    assert port == ref
    return port


# -- tests/test_provisioning.py ----------------------------------------------


@pytest.mark.parametrize("mode", MODES)
class TestProvisioningPipeline:
    def test_pending_pod_launches_node(self, mode):
        def scenario(k):
            env = k.env()
            env.kube.create(k.pod(requests={"cpu": "1"}))
            results = env.provision()
            assert len(results.new_nodes) == 1
            nodes = env.kube.list_nodes()
            assert len(nodes) == 1
            assert nodes[0].metadata.labels[k.lbl.PROVISIONER_NAME_LABEL] == "default"
            assert env.provider.create_calls
            assert env.recorder.of("NominatePod")
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_no_provisioner_no_node(self, mode):
        def scenario(k):
            env = k.env(provisioners=[])
            env.kube.create(k.pod())
            results = env.provision()
            assert env.kube.list_nodes() == []
            assert results.unschedulable
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_bound_pods_ignored(self, mode):
        def scenario(k):
            env = k.env()
            env.kube.create(k.pod(node_name="existing-node", unschedulable=False))
            results = env.provision()
            assert env.kube.list_nodes() == []
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_batch_packs_pods_together(self, mode):
        def scenario(k):
            env = k.env(instance_types=k.fake.instance_types(20))
            for pod in k.pods(10, requests={"cpu": "1"}):
                env.kube.create(pod)
            results = env.provision()
            assert len(env.kube.list_nodes()) == 1
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_second_round_uses_inflight_node(self, mode):
        def scenario(k):
            env = k.env(instance_types=k.fake.instance_types(20))
            env.kube.create(k.pod(requests={"cpu": "1"}))
            first = env.provision()
            assert len(env.kube.list_nodes()) == 1
            assert env.bind_nominated() == 1
            # a second small pod fits the in-flight node's remaining 0.9 cpu
            env.kube.create(k.pod(requests={"cpu": "0.5"}))
            second = env.provision()
            assert len(env.kube.list_nodes()) == 1
            return [round_outcome(first), round_outcome(second), outcome(env, k)]

        both(scenario, mode)

    def test_nominated_node_capacity_respected_before_binding(self, mode):
        def scenario(k):
            env = k.env(instance_types=[k.fake.instance_type("small", cpu=2, memory="4Gi", pods=2)])
            env.kube.create(k.pod(requests={"cpu": "1.5"}))
            first = env.provision()
            env.bind_nominated()
            env.kube.create(k.pod(requests={"cpu": "1.5"}))
            second = env.provision()
            # second pod can't fit the first node (1.5+1.5+overhead > 2)
            assert len(env.kube.list_nodes()) == 2
            return [round_outcome(first), round_outcome(second), outcome(env, k)]

        both(scenario, mode)

    def test_daemonset_overhead_reserved(self, mode):
        def scenario(k):
            env = k.env(instance_types=[k.fake.instance_type("only", cpu=3, memory="8Gi", pods=10)])
            ds_pod = k.pod(requests={"cpu": "1"}, unschedulable=False)
            env.kube.create(k.obj.DaemonSet(metadata=k.obj.ObjectMeta(name="logging"), spec_template=ds_pod))
            env.kube.create(k.pod(requests={"cpu": "2.5"}))
            results = env.provision()
            # 2.5 + 1 (daemon) + 0.1 overhead > 3 -> unschedulable
            assert results.unschedulable
            assert env.kube.list_nodes() == []
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_limits_block_launch(self, mode):
        def scenario(k):
            env = k.env(
                instance_types=[k.fake.instance_type("big", cpu=16, memory="32Gi")],
                provisioners=[k.make_provisioner(limits={"cpu": "3"})],
            )
            env.kube.create(k.pod(requests={"cpu": "1"}))
            results = env.provision()
            assert env.kube.list_nodes() == []
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_missing_pvc_blocks_pod(self, mode):
        def scenario(k):
            env = k.env()
            env.kube.create(k.pod(pvcs=["no-such-claim"]))
            results = env.provision()
            assert env.kube.list_nodes() == []
            assert env.recorder.of("FailedScheduling")
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_volume_topology_zone_injected(self, mode):
        def scenario(k):
            env = k.env()
            env.kube.create(k.obj.StorageClass(metadata=k.obj.ObjectMeta(name="zonal", namespace=""), provisioner="csi", zones=["test-zone-2"]))
            env.kube.create(k.obj.PersistentVolumeClaim(metadata=k.obj.ObjectMeta(name="data", namespace="default"), storage_class_name="zonal"))
            env.kube.create(k.pod(pvcs=["data"]))
            results = env.provision()
            node = next(n for n in results.new_nodes if n.pods)
            assert node.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE).has("test-zone-2")
            assert not node.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE).has("test-zone-1")
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_weighted_provisioner_order(self, mode):
        def scenario(k):
            env = k.env(provisioners=[k.make_provisioner(name="light", weight=1), k.make_provisioner(name="heavy", weight=100)])
            env.kube.create(k.pod())
            results = env.provision()
            assert env.kube.list_nodes()[0].metadata.labels[k.lbl.PROVISIONER_NAME_LABEL] == "heavy"
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_launch_failure_self_heals(self, mode):
        def scenario(k):
            env = k.env()
            env.provider.next_create_error = RuntimeError("insufficient capacity")
            env.kube.create(k.pod())
            first = env.provision()
            assert env.kube.list_nodes() == []
            assert env.recorder.of("FailedScheduling")
            # next round succeeds (error consumed)
            second = env.provision()
            assert len(env.kube.list_nodes()) == 1
            return [round_outcome(first), round_outcome(second), outcome(env, k)]

        both(scenario, mode)

    def test_dense_path_e2e(self, mode):
        def scenario(k):
            env = k.env(instance_types=k.fake.instance_types(30))
            for pod in k.pods(64, requests={"cpu": "0.5", "memory": "512Mi"}):
                env.kube.create(pod)
            first = env.provision()
            assert sum(len(n.pods) for n in first.new_nodes) == 64
            assert env.kube.list_nodes()
            # bind and add more pods; second round fills in-flight capacity
            env.bind_nominated()
            env.kube.create(k.pod(requests={"cpu": "0.1"}))
            second = env.provision()
            return [round_outcome(first), round_outcome(second), outcome(env, k)]

        record = both(scenario, mode)
        assert record[1]["existing"], "the second round did not fill the in-flight capacity"


class TestClusterState:
    @pytest.mark.parametrize("mode", MODES)
    def test_state_tracks_bindings(self, mode):
        def scenario(k):
            env = k.env(instance_types=k.fake.instance_types(20))
            env.kube.create(k.pod(requests={"cpu": "2"}))
            env.provision()
            env.bind_nominated()
            node = env.kube.list_nodes()[0]
            state = env.cluster.get_state_node(node.name)
            assert state is not None
            assert state.pod_count() == 1
            assert state.available["cpu"] < state.allocatable["cpu"]
            return [state.pod_count(), sorted(state.available.items()), outcome(env, k)]

        both(scenario, mode)

    @pytest.mark.parametrize("mode", MODES)
    def test_state_releases_on_pod_delete(self, mode):
        def scenario(k):
            env = k.env(instance_types=k.fake.instance_types(20))
            pod = k.pod(requests={"cpu": "2"})
            env.kube.create(pod)
            env.provision()
            env.bind_nominated()
            node = env.kube.list_nodes()[0]
            before = env.cluster.get_state_node(node.name).available["cpu"]
            env.kube.delete(pod, grace=False)
            after = env.cluster.get_state_node(node.name).available["cpu"]
            assert after > before
            return [before, after, outcome(env, k)]

        both(scenario, mode)

    def test_synchronized(self):
        def scenario(k):
            env = k.env()
            assert env.cluster.synchronized()
            return [env.cluster.synchronized()]

        both(scenario, "host")

    def test_nomination_ttl_expires(self):
        def scenario(k):
            env = k.env()
            env.cluster.nominate_node_for_pod("node-x")
            assert env.cluster.is_node_nominated("node-x")
            env.clock.step(60)
            assert not env.cluster.is_node_nominated("node-x")
            return [env.cluster.is_node_nominated("node-x")]

        both(scenario, "host")

    def test_consolidation_epoch_bumps(self):
        def scenario(k):
            env = k.env()
            before = env.cluster.consolidation_epoch()
            env.kube.create(k.pod(node_name="n1", unschedulable=False))
            assert env.cluster.consolidation_epoch() > before
            return [env.cluster.consolidation_epoch() - before]

        both(scenario, "host")


@pytest.mark.parametrize("mode", MODES)
class TestNoPreBinding:
    def test_provisioning_never_binds_pods(self, mode):
        def scenario(k):
            env = k.env()
            pods = [k.pod(requests={"cpu": 0.5}) for _ in range(6)]
            for pod in pods:
                env.kube.create(pod)
            results = env.provision()
            assert env.kube.list_nodes(), "nodes launched"
            for pod in env.kube.list_pods():
                assert pod.spec.node_name == "", f"pod {pod.name} was pre-bound"
            nominated = {e.object_name for e in env.recorder.of("NominatePod")}
            assert nominated == {p.name for p in pods}
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_existing_node_placements_not_bound_either(self, mode):
        def scenario(k):
            env = k.env()
            labels = {
                k.lbl.PROVISIONER_NAME_LABEL: "default",
                k.lbl.LABEL_INSTANCE_TYPE: "default-instance-type",
                k.lbl.LABEL_TOPOLOGY_ZONE: "test-zone-1",
                k.lbl.LABEL_CAPACITY_TYPE: "on-demand",
            }
            env.kube.create(k.node(name="warm", labels=labels, allocatable={"cpu": 16, "memory": "32Gi", "pods": 110}))
            pod = k.pod(requests={"cpu": 0.5})
            env.kube.create(pod)
            results = env.provision()
            assert not [n for n in results.new_nodes if n.pods], "pod must fill the warm node"
            assert [(v.node.name, len(v.pods)) for v in results.existing_nodes if v.pods] == [("warm", 1)]
            stored = next(p for p in env.kube.list_pods() if p.name == pod.name)
            assert stored.spec.node_name == "", "existing-node placement must nominate, not bind"
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestParallelLaunch:
    def test_slow_launches_overlap(self, mode):
        import threading
        import time

        def scenario(k):
            env = k.env(instance_types=[k.fake.instance_type("small", cpu=2, memory="4Gi")], parallel_launches=True)
            original = env.provider.create
            lock = threading.Lock()
            state = {"in_flight": 0, "peak": 0}

            def slow_create(request):
                with lock:
                    state["in_flight"] += 1
                    state["peak"] = max(state["peak"], state["in_flight"])
                time.sleep(0.05)
                try:
                    return original(request)
                finally:
                    with lock:
                        state["in_flight"] -= 1

            env.provider.create = slow_create
            for _ in range(8):
                env.kube.create(k.pod(requests={"cpu": "1.5"}))
            results = env.provision()
            assert len(env.kube.list_nodes()) == 8
            assert state["peak"] > 1, "launches did not overlap"
            return [round_outcome(results), outcome(env, k)]

        both(scenario, mode)

    def test_one_failed_launch_does_not_abort_siblings(self, mode):
        def scenario(k):
            env = k.env(instance_types=[k.fake.instance_type("small", cpu=2, memory="4Gi")], parallel_launches=True)
            original = env.provider.create
            calls = itertools.count()

            def flaky_create(request):
                if next(calls) == 2:
                    raise RuntimeError("insufficient capacity")
                return original(request)

            env.provider.create = flaky_create
            for _ in range(6):
                env.kube.create(k.pod(requests={"cpu": "1.5"}))
            results = env.provision()
            # 5 of 6 landed; the failure surfaced as an event, not an exception
            assert len(env.kube.list_nodes()) == 5
            assert len(env.recorder.of("FailedScheduling")) == 1
            # which pod's launch failed depends on the order the workers
            # reach the provider, so the events compare by count here
            got = outcome(env, k)
            got["failed_scheduling"] = [m for _p, m in got["failed_scheduling"]]
            got["launched"] = sorted(entry[:4] for entry in got["launched"])
            return [round_outcome(results), got]

        both(scenario, mode)
