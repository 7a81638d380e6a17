"""Node lifecycle controller: initialization, emptiness, expiration, finalizer.

Mirrors pkg/controllers/node — an umbrella reconciler over framework-owned
nodes running four sub-reconcilers with a single update at the end
(controller.go:92-115):

  initialization — mark karpenter.sh/initialized=true once the kubelet is
                   Ready, startup taints are gone, and requested extended
                   resources registered (initialization.go:28-120)
  emptiness      — stamp the emptiness timestamp when a TTLSecondsAfterEmpty
                   provisioner's node holds no non-daemon pods; delete after
                   the TTL (emptiness.go:44-99)
  expiration     — delete nodes older than TTLSecondsUntilExpired
                   (expiration.go:38-55)
  finalizer      — ensure the termination finalizer + provisioner owner ref
                   on self-registered nodes (finalizer.go:25-49)

The port's copy of karpenter_tpu/controllers/node/controller.py; the
lifecycle journal's "initialized" event is left out with the journal
(ROADMAP A8).
"""

from __future__ import annotations

from typing import List, Optional

from ...api import labels as lbl
from ...api.objects import Node, OwnerReference
from ...api.provisioner import Provisioner
from ...kube.cluster import KubeCluster
from ...logsetup import get_logger
from ...utils import pod as podutils
from ...utils import resources as res
from ..state.cluster import Cluster

log = get_logger("node")


class NodeController:
    def __init__(self, kube: KubeCluster, cluster: Cluster, provider=None, clock=None, delegate_disruption: bool = False):
        from ...utils.clock import Clock

        self.kube = kube
        self.cluster = cluster
        self.provider = provider
        self.clock = clock or kube.clock or Clock()
        # when the disruption orchestrator owns voluntary disruption
        # (runtime.py wires this True), emptiness/expiration become pure
        # candidate SOURCES: this controller keeps stamping/clearing the
        # emptiness timestamp — the signal the orchestrator's emptiness
        # method consumes — but no longer deletes nodes itself, so every
        # voluntary deletion flows through budgets and the command queue
        self.delegate_disruption = delegate_disruption

    def reconcile_all(self) -> None:
        for node in list(self.kube.list_nodes()):
            self.reconcile(node)

    def reconcile(self, node: Node) -> None:
        provisioner = self._provisioner_of(node)
        if provisioner is None:
            return  # not ours
        if node.metadata.deletion_timestamp is not None:
            return  # termination controller owns it now
        changed = False
        changed |= self._finalizer(node, provisioner)
        changed |= self._initialization(node, provisioner)
        changed |= self._emptiness(node, provisioner)
        if changed:
            self.kube.update(node)
        if not self.delegate_disruption:
            self._expiration(node, provisioner)
            self._empty_ttl_delete(node, provisioner)

    def _provisioner_of(self, node: Node) -> Optional[Provisioner]:
        name = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
        if name is None:
            return None
        return self.kube.get("Provisioner", name, namespace="")

    # -- finalizer ----------------------------------------------------------

    def _finalizer(self, node: Node, provisioner: Provisioner) -> bool:
        changed = False
        if lbl.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(lbl.TERMINATION_FINALIZER)
            changed = True
        if not any(ref.kind == "Provisioner" for ref in node.metadata.owner_references):
            node.metadata.owner_references.append(
                OwnerReference(kind="Provisioner", name=provisioner.name, uid=provisioner.metadata.uid)
            )
            changed = True
        return changed

    # -- initialization -------------------------------------------------------

    def _initialization(self, node: Node, provisioner: Provisioner) -> bool:
        if node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) == "true":
            return False
        if not node.ready():
            return False
        startup_taints = provisioner.spec.startup_taints
        for taint in startup_taints:
            if any(t.key == taint.key and t.value == taint.value and t.effect == taint.effect for t in node.spec.taints):
                return False
        if not self._extended_resources_registered(node):
            return False
        node.metadata.labels[lbl.LABEL_NODE_INITIALIZED] = "true"
        log.info("node %s initialized (ready, startup taints cleared, extended resources registered)", node.name)
        return True

    def _extended_resources_registered(self, node: Node) -> bool:
        """Wait for device plugins: every extended resource the instance type
        advertises must appear in node capacity (initialization.go:96-120)."""
        from ...cloudprovider.types import lookup_instance_type

        it = lookup_instance_type(self.provider, node, self.kube.list_provisioners())
        if it is None:
            return True
        for resource, value in it.resources().items():
            if resource in (res.CPU, res.MEMORY, res.PODS, res.EPHEMERAL_STORAGE):
                continue
            if value > 0 and node.status.capacity.get(resource, 0.0) <= 0:
                return False
        return True

    # -- emptiness -------------------------------------------------------------

    def _emptiness(self, node: Node, provisioner: Provisioner) -> bool:
        if provisioner.spec.ttl_seconds_after_empty is None:
            return False
        if node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) != "true":
            return False
        if self.cluster.is_node_nominated(node.name):
            return False
        empty = podutils.is_node_empty(self.kube.pods_on_node(node.name))
        stamped = lbl.EMPTINESS_TIMESTAMP_ANNOTATION in node.metadata.annotations
        if empty and not stamped:
            node.metadata.annotations[lbl.EMPTINESS_TIMESTAMP_ANNOTATION] = str(self.clock.now())
            return True
        if not empty and stamped:
            del node.metadata.annotations[lbl.EMPTINESS_TIMESTAMP_ANNOTATION]
            return True
        return False

    def _empty_ttl_delete(self, node: Node, provisioner: Provisioner) -> None:
        ttl = provisioner.spec.ttl_seconds_after_empty
        if ttl is None:
            return
        stamp = node.metadata.annotations.get(lbl.EMPTINESS_TIMESTAMP_ANNOTATION)
        if stamp is None:
            return
        if self.clock.now() - float(stamp) >= ttl:
            log.info("deleting node %s: empty past ttlSecondsAfterEmpty=%.0fs", node.name, ttl)
            self.kube.delete(node)

    # -- expiration --------------------------------------------------------------

    def _expiration(self, node: Node, provisioner: Provisioner) -> None:
        ttl = provisioner.spec.ttl_seconds_until_expired
        if ttl is None:
            return
        if self.clock.now() - node.metadata.creation_timestamp >= ttl:
            log.info("deleting node %s: expired past ttlSecondsUntilExpired=%.0fs", node.name, ttl)
            self.kube.delete(node)
