"""The port's node, termination and counter controllers held against the JAX package.

Every case of tests/test_deprovisioning.py's TestNodeLifecycle,
TestTermination and TestCounter runs here on both packages, written once
against a DKit (tests/test_torch_consolidation.py) and driven through each
package's DeprovEnv with the same inputs. The case's own assertions run on
both sides, and the two records must be equal: the final nodes, pods,
events and provider calls (`cluster_record`), and what the case reads on
the way (annotations, the counter's rollup). Each case runs with the exact
host loop and with the dense solve at min_batch=1 (the launch rounds of
the setup; these controllers solve nothing themselves).
"""

from __future__ import annotations

import pytest

from tests.test_torch_consolidation import MODES, cluster_record, dboth, reference_auditor_off, reference_singletons  # noqa: F401


@pytest.mark.parametrize("mode", MODES)
class TestNodeLifecycle:
    def test_initialization_marks_ready_node(self, mode):
        def scenario(k):
            env = k.deprov()
            nodes = env.launch_node_with_pods(k.pod(requests={"cpu": "1"}))
            assert nodes[0].metadata.labels.get(k.lbl.LABEL_NODE_INITIALIZED) == "true"
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_initialization_waits_for_startup_taints(self, mode):
        def scenario(k):
            taint = k.obj.Taint(key="cilium", value="x", effect="NoSchedule")
            env = k.deprov(provisioners=[k.make_provisioner(startup_taints=[taint])])
            env.kube.create(k.pod(tolerations=[]))
            env.provision()
            env.node_controller.reconcile_all()
            node = env.kube.list_nodes()[0]
            waiting = node.metadata.labels.get(k.lbl.LABEL_NODE_INITIALIZED)
            assert waiting != "true"
            node.spec.taints = [t for t in node.spec.taints if t.key != "cilium"]
            env.kube.update(node)
            env.node_controller.reconcile_all()
            assert env.kube.list_nodes()[0].metadata.labels.get(k.lbl.LABEL_NODE_INITIALIZED) == "true"
            return [waiting, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_finalizer_and_owner_ref_added(self, mode):
        def scenario(k):
            env = k.deprov()
            node = env.launch_node_with_pods(k.pod())[0]
            assert k.lbl.TERMINATION_FINALIZER in node.metadata.finalizers
            assert any(ref.kind == "Provisioner" for ref in node.metadata.owner_references)
            refs = sorted((ref.kind, ref.name) for ref in node.metadata.owner_references)
            return [list(node.metadata.finalizers), refs, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_emptiness_ttl_deletes(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.make_provisioner(ttl_seconds_after_empty=30)])
            pod = k.pod(requests={"cpu": "1"})
            env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            env.node_controller.reconcile_all()
            stamped = dict(env.kube.list_nodes()[0].metadata.annotations)
            assert k.lbl.EMPTINESS_TIMESTAMP_ANNOTATION in stamped
            env.clock.step(31)
            env.node_controller.reconcile_all()
            env.termination_controller.reconcile_all()
            assert env.kube.list_nodes() == []
            return [sorted(stamped.items()), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_emptiness_cleared_when_pod_arrives(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.make_provisioner(ttl_seconds_after_empty=30)])
            pod = k.pod(requests={"cpu": "1"})
            nodes = env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            env.node_controller.reconcile_all()
            assert k.lbl.EMPTINESS_TIMESTAMP_ANNOTATION in env.kube.list_nodes()[0].metadata.annotations
            env.kube.create(k.pod(node_name=nodes[0].name, unschedulable=False))
            env.node_controller.reconcile_all()
            assert k.lbl.EMPTINESS_TIMESTAMP_ANNOTATION not in env.kube.list_nodes()[0].metadata.annotations
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_expiration_ttl_deletes(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.make_provisioner(ttl_seconds_until_expired=3600)])
            env.launch_node_with_pods(k.owned())
            env.clock.step(3601)
            env.node_controller.reconcile_all()
            env.termination_controller.reconcile_all()
            assert env.kube.list_nodes() == []
            return [cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestTermination:
    def test_cordon_drain_delete(self, mode):
        def scenario(k):
            env = k.deprov()
            nodes = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))
            env.kube.delete(nodes[0])
            env.termination_controller.reconcile_all()
            assert env.kube.list_nodes() == []
            assert env.provider.delete_calls
            assert env.recorder.of("EvictPod")
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_do_not_evict_blocks_drain(self, mode):
        def scenario(k):
            env = k.deprov()
            nodes = env.launch_node_with_pods(k.owned(annotations={k.lbl.DO_NOT_EVICT_ANNOTATION: "true"}))
            env.kube.delete(nodes[0])
            env.termination_controller.reconcile_all()
            assert len(env.kube.list_nodes()) == 1
            assert env.recorder.of("FailedDraining")
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_pdb_blocks_then_allows(self, mode):
        def scenario(k):
            env = k.deprov()
            nodes = env.launch_node_with_pods(k.owned(labels={"app": "guarded"}, requests={"cpu": "1"}))
            pdb = k.obj.PodDisruptionBudget(
                metadata=k.obj.ObjectMeta(name="guard", namespace="default"),
                selector=k.obj.LabelSelector(match_labels={"app": "guarded"}),
                disruptions_allowed=0,
            )
            env.kube.create(pdb)
            env.kube.delete(nodes[0])
            env.termination_controller.reconcile_all()
            assert len(env.kube.list_nodes()) == 1
            blocked = cluster_record(env, k)
            pdb.disruptions_allowed = 1
            env.clock.step(1)
            env.termination_controller.reconcile_all()
            assert env.kube.list_nodes() == []
            return [blocked, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_daemonset_pods_do_not_block(self, mode):
        def scenario(k):
            env = k.deprov()
            nodes = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))
            ds_pod = k.pod(node_name=nodes[0].name, unschedulable=False)
            ds_pod.metadata.owner_references.append(k.obj.OwnerReference(kind="DaemonSet", name="ds"))
            env.kube.create(ds_pod)
            env.kube.delete(nodes[0])
            env.termination_controller.reconcile_all()
            assert env.kube.list_nodes() == []
            return [cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestCounter:
    def test_rollup(self, mode):
        def scenario(k):
            env = k.deprov()
            env.launch_node_with_pods(k.pod(requests={"cpu": "1"}))
            env.counter_controller.reconcile_all()
            prov = env.kube.list_provisioners()[0]
            assert prov.status.resources.get("cpu", 0) > 0
            return [sorted(prov.status.resources.items()), cluster_record(env, k)]

        dboth(scenario, mode)
