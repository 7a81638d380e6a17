"""The provisioning suite's depth cases, held on both packages.

Every case of tests/test_provisioning_catalog.py (deleting provisioners,
kubelet maxPods, resource limits, the daemonset-overhead matrix, kubelet
resource zeroing, volume-topology depth) runs through the reference's
tests/env.py Environment and the port's testing.Environment with the same
inputs, with the exact host loop and with the dense solve at min_batch=1.
The case's own assertions run on both sides, and the outcomes must be
equal (tests/test_torch_provisioning.py: `both`, `outcome`).
"""

from __future__ import annotations

import pytest

from tests.test_torch_provisioning import MODES, both, outcome, reference_singletons, round_outcome  # noqa: F401


def sized_types(k):
    """The reference's tiered fake types: 2cpu/2Gi and 4cpu/4Gi."""
    od = [k.cloud_types.Offering(capacity_type="on-demand", zone="test-zone-1")]
    return [
        k.fake.instance_type("small", cpu=2, memory="2Gi", price=1.0, offerings=od),
        k.fake.instance_type("large", cpu=4, memory="4Gi", price=2.0, offerings=od),
    ]


def gpu_type(k):
    od = [k.cloud_types.Offering(capacity_type="on-demand", zone="test-zone-1")]
    return k.fake.instance_type("gpu-box", cpu=8, memory="16Gi", price=5.0, offerings=od, resources={"vendor.com/gpu": 2})


def node_of(env, pod_name):
    for node in env.provisioner_controller.last_results.new_nodes:
        if any(p.name == pod_name for p in node.pods):
            return node
    return None


def finish(env, k):
    return [round_outcome(env.provisioner_controller.last_results), outcome(env, k)]


@pytest.mark.parametrize("mode", MODES)
class TestProvisionerLifecycle:
    def test_ignores_deleting_provisioners(self, mode):
        def scenario(k):
            env = k.env(provisioners=[])
            prov = k.make_provisioner()
            prov.metadata.finalizers.append("karpenter.sh/hold")
            env.kube.create(prov)
            env.kube.delete(prov)  # graceful: deletion timestamp set, object held
            env.kube.create(k.pod(requests={"cpu": 1}))
            env.provision()
            assert env.kube.list_nodes() == [], "deleting provisioner must not launch"
            return finish(env, k)

        both(scenario, mode)

    def test_kubelet_max_pods_splits_nodes(self, mode):
        def scenario(k):
            env = k.env(
                instance_types=k.fake.instance_types(5),
                provisioners=[k.make_provisioner(kubelet_configuration=k.api_provisioner.KubeletConfiguration(max_pods=1))],
            )
            for pod in k.pods(3, requests={"cpu": 0.1}):
                env.kube.create(pod)
            env.provision()
            results = env.provisioner_controller.last_results
            assert sum(len(n.pods) for n in results.new_nodes) == 3
            assert len(results.new_nodes) == 3, "maxPods=1 forces one pod per node"
            for node in results.new_nodes:
                assert len(node.pods) == 1
            return finish(env, k)

        both(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestResourceLimits:
    def test_partial_scheduling_when_limits_exceeded(self, mode):
        def scenario(k):
            env = k.env(instance_types=sized_types(k), provisioners=[k.make_provisioner(limits={"cpu": 4})])
            for pod in k.pods(6, requests={"cpu": 1.5}):
                env.kube.create(pod)
            env.provision()
            results = env.provisioner_controller.last_results
            scheduled = sum(len(n.pods) for n in results.new_nodes)
            assert 0 < scheduled < 6
            assert len(results.unschedulable) == 6 - scheduled
            for err in results.unschedulable.values():
                assert "limits" in err
            return finish(env, k)

        both(scenario, mode)

    def test_extended_resource_limits(self, mode):
        def scenario(k):
            env = k.env(instance_types=[gpu_type(k)], provisioners=[k.make_provisioner(limits={"vendor.com/gpu": 2})])
            for pod in k.pods(2, requests={"vendor.com/gpu": 2, "cpu": 1}):
                env.kube.create(pod)
            env.provision()
            results = env.provisioner_controller.last_results
            assert sum(len(n.pods) for n in results.new_nodes) == 1
            assert len(results.unschedulable) == 1
            return finish(env, k)

        both(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestDaemonSetOverhead:
    @staticmethod
    def _daemonset(k, env, requests=None, limits=None, node_selector=None, node_requirements=None, tolerations=None):
        template = k.pod(
            requests=requests,
            limits=limits,
            node_selector=node_selector,
            node_requirements=node_requirements,
            tolerations=tolerations,
            unschedulable=False,
        )
        env.kube.create(k.obj.DaemonSet(metadata=template.metadata, spec_template=template))

    def _one_pod(self, mode, expect, provisioner_kwargs=None, pod_kwargs=None, **ds_kwargs):
        """A daemonset, then one pod: `expect` is the type the pod's node
        takes first, or None if the pod must not schedule."""

        def scenario(k):
            env = k.env(instance_types=sized_types(k), provisioners=[k.make_provisioner(**(provisioner_kwargs or {}))])
            self._daemonset(k, env, **ds_kwargs)
            pod = k.pod(**(pod_kwargs or {"requests": {"cpu": 1, "memory": "1Gi"}}))
            env.kube.create(pod)
            env.provision()
            node = node_of(env, pod.name)
            if expect is None:
                assert node is None
            else:
                assert node is not None
                assert node.instance_type_options[0].name() == expect
            return finish(env, k)

        both(scenario, mode)

    def test_accounts_for_overhead(self, mode):
        # ds(1cpu) + pod(1cpu) doesn't fit the 2cpu type: the 4cpu type wins
        self._one_pod(mode, "large", requests={"cpu": 1, "memory": "1Gi"})

    def test_accounts_for_overhead_with_startup_taint(self, mode):
        def taint(k):
            return k.obj.Taint(key="foo.com/taint", effect="NoSchedule")

        def scenario(k):
            env = k.env(instance_types=sized_types(k), provisioners=[k.make_provisioner(startup_taints=[taint(k)])])
            self._daemonset(k, env, requests={"cpu": 1, "memory": "1Gi"})
            pod = k.pod(requests={"cpu": 1, "memory": "1Gi"})
            env.kube.create(pod)
            env.provision()
            node = node_of(env, pod.name)
            assert node is not None
            assert node.instance_type_options[0].name() == "large"
            return finish(env, k)

        both(scenario, mode)

    def test_oversized_overhead_blocks_scheduling(self, mode):
        self._one_pod(mode, None, pod_kwargs={"requests": {"cpu": 0.1}}, requests={"cpu": 10000, "memory": "10000Gi"})

    def test_limits_only_daemonset_counts_as_requests(self, mode):
        self._one_pod(mode, None, pod_kwargs={"requests": {"cpu": 0.1}}, limits={"cpu": 10000, "memory": "10000Gi"})

    def test_ignores_daemonsets_without_matching_tolerations(self, mode):
        def scenario(k):
            tainted = k.make_provisioner(taints=[k.obj.Taint(key="foo", value="bar", effect="NoSchedule")])
            env = k.env(instance_types=sized_types(k), provisioners=[tainted])
            self._daemonset(k, env, requests={"cpu": 1, "memory": "1Gi"})
            pod = k.pod(requests={"cpu": 1, "memory": "1Gi"}, tolerations=[k.obj.Toleration(operator="Exists")])
            env.kube.create(pod)
            env.provision()
            node = node_of(env, pod.name)
            assert node is not None
            assert node.instance_type_options[0].name() == "small", "no overhead: the 2cpu type suffices"
            return finish(env, k)

        both(scenario, mode)

    def test_ignores_daemonsets_with_incompatible_selector(self, mode):
        self._one_pod(mode, "small", requests={"cpu": 1, "memory": "1Gi"}, node_selector={"node": "invalid"})

    def test_accounts_daemonsets_with_notin_unspecified_key(self, mode):
        # NotIn on a key the template doesn't define is compatible
        def scenario(k):
            env = k.env(instance_types=sized_types(k))
            self._daemonset(
                k, env,
                requests={"cpu": 1, "memory": "1Gi"},
                node_requirements=[k.obj.NodeSelectorRequirement("foo", k.obj.OP_NOT_IN, ["bar"])],
            )
            pod = k.pod(
                requests={"cpu": 1, "memory": "1Gi"},
                node_requirements=[k.obj.NodeSelectorRequirement(k.lbl.LABEL_TOPOLOGY_ZONE, k.obj.OP_IN, ["test-zone-1"])],
            )
            env.kube.create(pod)
            env.provision()
            node = node_of(env, pod.name)
            assert node is not None
            assert node.instance_type_options[0].name() == "large"
            return finish(env, k)

        both(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestKubeletResourceZeroing:
    def test_zeroed_extended_resources_do_not_relaunch(self, mode):
        def scenario(k):
            env = k.env(instance_types=[gpu_type(k)])
            env.kube.create(k.pod(requests={"cpu": 0.1, "vendor.com/gpu": 1}))
            first = env.provision()
            nodes = env.kube.list_nodes()
            assert len(nodes) == 1
            # the kubelet zeroes the extended resource on the node
            node = nodes[0]
            node.status.capacity = {"vendor.com/gpu": 0.0}
            node.status.allocatable = {"vendor.com/gpu": 0.0}
            env.kube.update(node)
            env.kube.create(k.pod(requests={"cpu": 0.1, "vendor.com/gpu": 1}))
            second = env.provision()
            assert len(env.kube.list_nodes()) == 1, "the in-flight node must absorb the second GPU pod"
            return [round_outcome(first), round_outcome(second), outcome(env, k)]

        both(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestVolumeTopologyDepth:
    @staticmethod
    def _pvc(k, env, name, storage_class=None, volume_name=""):
        env.kube.create(
            k.obj.PersistentVolumeClaim(
                metadata=k.obj.ObjectMeta(name=name, namespace="default"),
                storage_class_name=storage_class,
                volume_name=volume_name,
            )
        )

    def test_valid_pods_schedule_when_sibling_has_invalid_pvc(self, mode):
        def scenario(k):
            env = k.env(instance_types=sized_types(k))
            bad = k.pod(requests={"cpu": 0.1}, pvcs=["missing-claim"])
            good = k.pod(requests={"cpu": 0.1})
            env.kube.create(bad)
            env.kube.create(good)
            env.provision()
            assert node_of(env, good.name) is not None
            assert node_of(env, bad.name) is None
            return finish(env, k)

        both(scenario, mode)

    def _zonal(self, mode, expect_zone, pv=False, pinned=False):
        """A pod whose claim's storage class (or bound volume) allows only
        one zone; `pinned` adds a zone-1 requirement, which must fail."""

        def scenario(k):
            env = k.env(instance_types=k.fake.instance_types(5))
            if pv:
                env.kube.create(k.obj.PersistentVolume(metadata=k.obj.ObjectMeta(name="pv", namespace=""), zones=[expect_zone]))
                self._pvc(k, env, "claim", volume_name="pv")
            else:
                env.kube.create(k.obj.StorageClass(metadata=k.obj.ObjectMeta(name="zonal", namespace=""), zones=[expect_zone]))
                self._pvc(k, env, "claim", storage_class="zonal")
            requirements = [k.obj.NodeSelectorRequirement(k.lbl.LABEL_TOPOLOGY_ZONE, k.obj.OP_IN, ["test-zone-1"])] if pinned else None
            pod = k.pod(requests={"cpu": 0.1}, pvcs=["claim"], node_requirements=requirements)
            env.kube.create(pod)
            env.provision()
            node = node_of(env, pod.name)
            if pinned:
                assert node is None
            else:
                assert node is not None
                zone_req = node.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE)
                assert zone_req is not None and zone_req.has(expect_zone)
                assert not zone_req.has("test-zone-1")
            return finish(env, k)

        both(scenario, mode)

    def test_schedules_to_storage_class_zones(self, mode):
        self._zonal(mode, "test-zone-3")

    def test_incompatible_storage_class_zone_fails(self, mode):
        self._zonal(mode, "test-zone-unknown", pinned=True)

    def test_schedules_to_bound_volume_zone(self, mode):
        self._zonal(mode, "test-zone-2", pv=True)

    def test_incompatible_bound_volume_zone_fails(self, mode):
        self._zonal(mode, "test-zone-2", pv=True, pinned=True)
