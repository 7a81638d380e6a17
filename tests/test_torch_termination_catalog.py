"""The port's termination controller held against the JAX package, case by case.

Every case of tests/test_termination_catalog.py runs here on both
packages, written once against a DKit (tests/test_torch_consolidation.py)
and driven through each package's DeprovEnv with the same inputs. The
case's own assertions run on both sides, and the two records must be
equal: the nodes, pods, events and provider calls (`cluster_record`) and
what the case reads on the way (the eviction queue's length). Each case
runs with the exact host loop and with the dense solve at min_batch=1 (the
launch round of the setup; termination solves nothing itself).
"""

from __future__ import annotations

import pytest

from tests.test_torch_consolidation import MODES, cluster_record, dboth, reference_auditor_off, reference_singletons  # noqa: F401


def env_with_node(k):
    env = k.deprov()
    nodes = env.launch_node_with_pods(k.owned(requests={"cpu": 0.5}))
    # the bootstrap pod is not part of any scenario: remove it
    for pod in env.kube.list_pods():
        env.kube.delete(pod, grace=False)
    return env, nodes[0]


def delete_node(env, node):
    env.kube.delete(node)
    return env.kube.get_node(node.name)


def draining(k, env, name: str):
    node = env.kube.get_node(name)
    assert node is not None, f"node {name} is gone"
    assert node.spec.unschedulable, "draining node must be cordoned"
    assert k.lbl.TERMINATION_FINALIZER in node.metadata.finalizers
    assert node.metadata.deletion_timestamp is not None
    return node


def unschedulable_toleration(k):
    return k.obj.Toleration(key=k.lbl.TAINT_NODE_UNSCHEDULABLE, operator="Exists", effect="NoSchedule")


def present(env, pod) -> bool:
    return env.kube.get("Pod", pod.name, pod.namespace) is not None


@pytest.mark.parametrize("mode", MODES)
class TestTerminationCatalog:
    def test_deletes_nodes(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_does_not_evict_pods_tolerating_unschedulable_taint(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pod_evict = k.owned(node_name=node.name, unschedulable=False)
            pod_skip = k.owned(node_name=node.name, unschedulable=False, tolerations=[unschedulable_toleration(k)])
            env.kube.create(pod_evict)
            env.kube.create(pod_skip)
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None
            assert present(env, pod_skip), "tolerating pod must survive"
            assert not present(env, pod_evict), "regular pod evicted"
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_do_not_evict_pod_tolerating_unschedulable_taint_blocks(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pod = k.owned(
                node_name=node.name,
                unschedulable=False,
                annotations={k.lbl.DO_NOT_EVICT_ANNOTATION: "true"},
                tolerations=[unschedulable_toleration(k)],
            )
            env.kube.create(pod)
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            draining(k, env, node.name)
            assert env.recorder.of("FailedDraining")
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_do_not_evict_static_pod_blocks(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pod = k.pod(node_name=node.name, unschedulable=False, annotations={k.lbl.DO_NOT_EVICT_ANNOTATION: "true"})
            pod.metadata.owner_references.append(k.obj.OwnerReference(kind="Node", name=node.name, uid="node-uid"))
            env.kube.create(pod)
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            draining(k, env, node.name)
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_ownerless_pod_blocks_drain(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pod_evict = k.owned(node_name=node.name, unschedulable=False)
            pod_no_owner = k.pod(node_name=node.name, unschedulable=False)
            env.kube.create(pod_evict)
            env.kube.create(pod_no_owner)
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            draining(k, env, node.name)
            queued = len(env.termination_controller.eviction_queue)
            assert queued == 0
            assert present(env, pod_evict)
            blocked = cluster_record(env, k)
            env.kube.delete(pod_no_owner, grace=False)
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None
            return [queued, blocked, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_deletes_nodes_with_terminal_pods(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            env.kube.create(k.pod(node_name=node.name, unschedulable=False, phase="Succeeded"))
            env.kube.create(k.pod(node_name=node.name, unschedulable=False, phase="Failed"))
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_evicts_non_critical_pods_first(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pod_evict = k.owned(node_name=node.name, unschedulable=False)
            pod_node_critical = k.owned(node_name=node.name, unschedulable=False)
            pod_node_critical.spec.priority_class_name = "system-node-critical"
            pod_cluster_critical = k.owned(node_name=node.name, unschedulable=False)
            pod_cluster_critical.spec.priority_class_name = "system-cluster-critical"
            for p in (pod_evict, pod_node_critical, pod_cluster_critical):
                env.kube.create(p)
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            draining(k, env, node.name)
            assert not present(env, pod_evict)
            assert present(env, pod_node_critical)
            assert present(env, pod_cluster_critical)
            first = cluster_record(env, k)
            env.termination_controller.reconcile_all()
            assert not present(env, pod_node_critical)
            assert not present(env, pod_cluster_critical)
            assert env.kube.get_node(node.name) is None
            return [first, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_does_not_evict_static_pods(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pod_evict = k.owned(node_name=node.name, unschedulable=False)
            pod_mirror = k.pod(node_name=node.name, unschedulable=False)
            pod_mirror.metadata.owner_references.append(k.obj.OwnerReference(kind="Node", name=node.name, uid="node-uid"))
            env.kube.create(pod_evict)
            env.kube.create(pod_mirror)
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None, "mirror pod must not block deletion"
            assert present(env, pod_mirror), "mirror pod never evicted"
            assert not present(env, pod_evict)
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_does_not_delete_node_until_all_pods_deleted(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pods = [k.owned(node_name=node.name, unschedulable=False, labels={"app": "guarded"}) for _ in range(2)]
            for p in pods:
                env.kube.create(p)
            env.kube.create(
                k.obj.PodDisruptionBudget(
                    metadata=k.obj.ObjectMeta(name="guard", namespace="default"),
                    selector=k.obj.LabelSelector(match_labels={"app": "guarded"}),
                    disruptions_allowed=1,
                )
            )
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            draining(k, env, node.name)
            guarded = len([p for p in env.kube.list_pods() if p.metadata.labels.get("app") == "guarded"])
            assert guarded == 1
            blocked = cluster_record(env, k)
            pdb = env.kube.list("PodDisruptionBudget", "default")[0]
            pdb.disruptions_allowed = 1
            env.clock.step(1)  # per-item eviction backoff
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None
            return [guarded, blocked, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_waits_for_terminating_pods_then_gives_up_after_grace(self, mode):
        def scenario(k):
            env, node = env_with_node(k)
            pod = k.owned(node_name=node.name, unschedulable=False)
            pod.metadata.finalizers.append("test/hold")  # keeps the object terminating
            env.kube.create(pod)
            env.kube.delete(pod)  # graceful: sets deletion timestamp, object stays
            assert env.kube.get("Pod", pod.name, pod.namespace).metadata.deletion_timestamp is not None
            delete_node(env, node)
            env.termination_controller.reconcile_all()
            draining(k, env, node.name)
            blocked = cluster_record(env, k)
            env.clock.step(90)
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None, "stuck-terminating pod must stop blocking"
            return [blocked, cluster_record(env, k)]

        dboth(scenario, mode)
