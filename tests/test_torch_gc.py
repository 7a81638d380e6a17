"""The port's garbage-collection sweep held against the JAX package, case by case.

Every case of tests/test_gc.py runs here on both packages, written once
against an SKit (tests/test_torch_interruption.py): the reference through
that file's GCEnv (a Runtime over the simulated cloud), the port through
karpenter_tpu_torch/testing.py's GCEnv. The case's own assertions run on
both sides, and the two records must be equal: what the sweep returned and
the environment's nodes, pods, events, cloud instances and tally deltas
(`sim_record`). Each case runs with the exact host loop and with the dense
solve at min_batch=1 (the launch rounds of the setup; the sweep solves
nothing itself).
"""

from __future__ import annotations

import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_interruption import leader_cleared, sboth, sim_record  # noqa: F401
from tests.test_torch_provisioning import MODES, reference_singletons  # noqa: F401


@pytest.mark.parametrize("mode", MODES)
class TestOrphanSweep:
    def test_orphan_terminated_after_grace(self, mode):
        def scenario(k):
            env = k.gc_env()
            node, _ = env.launch_node()
            leaked = env.leak_instance()
            before = env.gc.collected.value(direction="orphaned-instance")
            env.clock.step(31)  # past the registration grace
            result = env.gc.reconcile()
            assert result["orphans"] == [leaked]
            assert not env.backend.instance_exists(leaked)
            assert env.backend.instance_exists(env.instance_id(node))
            assert env.gc.collected.value(direction="orphaned-instance") == before + 1
            return [result, sim_record(env, k)]

        sboth(scenario, mode)

    def test_fresh_launch_spared_inside_grace(self, mode):
        def scenario(k):
            env = k.gc_env()
            leaked = env.leak_instance()
            env.clock.step(5)  # the launch->register window is still open
            result = env.gc.reconcile()
            assert result["orphans"] == []
            assert env.backend.instance_exists(leaked)
            env.clock.step(26)
            later = env.gc.reconcile()
            assert later["orphans"] == [leaked]
            return [result, later, sim_record(env, k)]

        sboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestGhostSweep:
    def test_ghost_node_finalized_and_pods_drained(self, mode):
        def scenario(k):
            env = k.gc_env()
            node, pods = env.launch_node(pod_count=2)
            before = env.gc.collected.value(direction="ghost-node")
            env.backend.terminate_instance(env.instance_id(node))
            result = env.gc.reconcile()
            assert result["ghosts"] == [node.name]
            assert env.kube.get_node(node.name) is None, "ghost node finalized (drained + finalizer stripped)"
            for pod in pods:
                fresh = env.kube.get("Pod", pod.metadata.name, namespace=pod.metadata.namespace)
                assert fresh is None or not fresh.spec.node_name
            assert env.gc.collected.value(direction="ghost-node") == before + 1
            return [result, sim_record(env, k)]

        sboth(scenario, mode)

    def test_live_node_untouched(self, mode):
        def scenario(k):
            env = k.gc_env()
            node, _ = env.launch_node(pod_count=1)
            result = env.gc.reconcile()
            assert result == {"orphans": [], "ghosts": []}
            assert env.kube.get_node(node.name) is not None
            return [result, sim_record(env, k)]

        sboth(scenario, mode)

    def test_already_terminating_node_left_to_termination(self, mode):
        def scenario(k):
            env = k.gc_env()
            node, _ = env.launch_node(pod_count=1)
            env.backend.terminate_instance(env.instance_id(node))
            env.kube.delete(env.kube.get_node(node.name))  # termination already owns it
            before = env.gc.collected.value(direction="ghost-node")
            result = env.gc.reconcile()
            assert env.gc.collected.value(direction="ghost-node") == before
            return [result, sim_record(env, k)]

        sboth(scenario, mode)


class TestSweepScoping:
    def test_provider_without_inventory_never_sweeps(self):
        """Fixture nodes against a provider with no list_instances (the fake
        provider shape) are never reaped."""

        def scenario(k):
            kube = k.kube_module.KubeCluster(clock=k.clock.FakeClock())
            provider = k.fake.FakeCloudProvider(k.fake.instance_types(2))
            gc = k.GarbageCollectionController(kube, cluster=None, cloud_provider=provider, clock=kube.clock)
            node = k.node(labels={k.lbl.PROVISIONER_NAME_LABEL: "default"}, allocatable={"cpu": "4"})
            kube.create(node)
            # the reference's counter is process-wide: read the sweep's own
            sweeps = gc.sweeps.value()
            result = gc.reconcile()
            assert result == {"orphans": [], "ghosts": []}
            assert kube.get_node(node.name) is not None
            return [result, [n.name for n in kube.list_nodes()], gc.sweeps.value() - sweeps]

        sboth(scenario, "host")

    @pytest.mark.parametrize("mode", MODES)
    def test_node_without_provider_id_unknowable(self, mode):
        def scenario(k):
            env = k.gc_env()
            fixture = k.node(labels={k.lbl.PROVISIONER_NAME_LABEL: "default"}, allocatable={"cpu": "4"})
            env.kube.create(fixture)
            result = env.gc.reconcile()
            assert fixture.name not in result["ghosts"]
            assert env.kube.get_node(fixture.name) is not None
            return [result, sim_record(env, k)]

        sboth(scenario, mode)
