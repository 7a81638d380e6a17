"""Termination controller: graceful node teardown.

Mirrors pkg/controllers/termination — when a framework-owned node carries a
deletion timestamp: cordon (terminate.go:55-68), drain by evicting pods
through the PDB-aware queue (critical pods last, do-not-evict blocks unless
terminal, stuck-terminating pods skipped, :122-168), then delete the cloud
instance and strip the finalizer so the API object is garbage collected
(:101-119).

The port's copy of karpenter_tpu/controllers/termination/controller.py. The
cordon writes through the backend's retry_on_conflict, and a conflict no
retry absorbed leaves the node to the next pass.
"""

from __future__ import annotations

from typing import List, Optional

from ...api import labels as lbl
from ...api.objects import NO_SCHEDULE, Node, Taint
from ...cloudprovider.types import CloudProvider
from ...events import Recorder
from ...journal import JOURNAL
from ...logsetup import get_logger
from ...kube.cluster import Conflict, KubeCluster
from ...scheduling.taints import Taints
from ...tracing import TRACER
from ...utils import pod as podutils
from ..edits import cordon, requeue
from .eviction import EvictionQueue

log = get_logger("termination")

_UNSCHEDULABLE = Taints([Taint(key=lbl.TAINT_NODE_UNSCHEDULABLE, effect=NO_SCHEDULE)])
_CORDON = cordon(lbl.TAINT_NODE_UNSCHEDULABLE)


class TerminationController:
    def __init__(self, kube: KubeCluster, cloud_provider: CloudProvider, recorder: Optional[Recorder] = None, clock=None):
        from ...utils.clock import Clock

        self.kube = kube
        self.cloud_provider = cloud_provider
        self.recorder = recorder or Recorder()
        self.clock = clock or kube.clock or Clock()
        self.eviction_queue = EvictionQueue(kube, self.recorder, clock=self.clock)
        self.termination_durations: List[float] = []  # metrics summary source
        from ...metrics import REGISTRY

        # the reference's termination_time_seconds summary (controller.go:52-60)
        self._termination_summary = REGISTRY.summary(
            "karpenter_nodes_termination_time_seconds", "Seconds from deletion timestamp until finalizer removal"
        )

    def reconcile_all(self) -> None:
        for node in list(self.kube.list_nodes()):
            if node.metadata.deletion_timestamp is not None:
                try:
                    self.reconcile(node)
                except Conflict as err:
                    requeue("TerminationController", node, err)

    def reconcile(self, node: Node) -> None:
        if lbl.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return
        with TRACER.span("terminate", controller="termination", node=node.name) as sp:
            with TRACER.span("cordon", node=node.name):
                self.cordon(node)
            with TRACER.span("drain", node=node.name) as drain_sp:
                drained = self.drain(node)
                drain_sp.set(drained=drained)
            if not drained:
                sp.set(outcome="pods-still-evicting")
                log.debug("draining %s: pods still evicting", node.name)
                return  # pods still evicting; re-reconcile later
            with TRACER.span("finalize", node=node.name):
                self.cloud_provider.delete(node)
                if JOURNAL.enabled:
                    # before kube.finalize: the watch DELETED fallback would
                    # otherwise record first and win the dedupe with no attrs
                    JOURNAL.node_event(node.name, "terminated", drained=drained)
                self.kube.finalize(node)
            sp.set(outcome="terminated")
        log.info("terminated node %s: drained, instance deleted, finalizer removed", node.name)
        if node.metadata.deletion_timestamp is not None:
            duration = self.clock.now() - node.metadata.deletion_timestamp
            self.termination_durations.append(duration)
            self._termination_summary.observe(duration)
        self.recorder.terminating_node(node, "deleted node and cloud instance")

    def cordon(self, node: Node) -> None:
        self.kube.retry_on_conflict("Node", node.name, node.metadata.namespace, _CORDON, held=node)

    def drain(self, node: Node) -> bool:
        """Queue evictable pods; True once nothing on the node blocks
        deletion. Guard set and order mirror terminate.go:74-102,126-145:
        terminal and stuck-terminating pods are invisible; an ownerless or
        do-not-evict pod blocks the whole drain; pods tolerating the
        unschedulable taint and static (node-owned) pods neither block nor
        get evicted."""
        to_evict = []
        for pod in self._drain_relevant_pods(node):
            # inability-to-evict guards come BEFORE the skip filters, so a
            # do-not-evict static pod still blocks (suite_test.go:217)
            if not pod.metadata.owner_references:
                self.recorder.node_failed_to_drain(node, f"pod {pod.name} does not have any owner references")
                return False
            if podutils.has_do_not_disrupt(pod):
                # both spellings: karpenter.sh/do-not-disrupt and the legacy
                # karpenter.sh/do-not-evict block a drain identically
                self.recorder.node_failed_to_drain(node, f"pod {pod.name} has do-not-evict/do-not-disrupt")
                return False
            if not self._obstructs_deletion(pod):
                continue
            to_evict.append(pod)
        self._enqueue_for_eviction(to_evict)
        self.eviction_queue.drain_once()
        # The reference returns done=len(podsToEvict)==0 and reaches the
        # fixed point on the next reconcile once the async queue empties the
        # node; the in-memory eviction is synchronous, so recheck now — the
        # same fixed point, one pass sooner.
        return not any(self._obstructs_deletion(p) for p in self._drain_relevant_pods(node))

    def _drain_relevant_pods(self, node: Node) -> List:
        """Pods that matter to a drain: not terminal, not stuck terminating
        past the 1-minute kubelet-partition window (terminate.go:126-145,166-171)."""
        return [
            p
            for p in self.kube.pods_on_node(node.name)
            if not podutils.is_terminal(p) and not self._is_stuck_terminating(p)
        ]

    def _is_stuck_terminating(self, pod) -> bool:
        ts = pod.metadata.deletion_timestamp
        return ts is not None and self.clock.now() > ts + 60.0

    @staticmethod
    def _obstructs_deletion(pod) -> bool:
        """True when the pod keeps the node alive: not tolerating the
        unschedulable taint (it would reschedule right back, terminate.go:90-93)
        and not a static mirror / daemonset pod."""
        if _UNSCHEDULABLE.tolerates(pod) is None:
            return False
        return not (podutils.is_owned_by_node(pod) or podutils.is_owned_by_daemonset(pod))

    def _enqueue_for_eviction(self, pods: List) -> None:
        """Non-critical pods go first; critical (system) pods enqueue only
        once no non-critical pod is still RUNNING — a non-critical pod
        already mid-termination no longer delays them, exactly the reference's
        evict() (terminate.go:147-164: terminating pods are skipped before
        the critical/non-critical split)."""
        critical = []
        non_critical = []
        for pod in pods:
            if podutils.is_terminating(pod):
                continue
            if self._is_critical(pod):
                critical.append(pod)
            else:
                non_critical.append(pod)
        if non_critical:
            self.eviction_queue.add(*non_critical)
        elif critical:
            self.eviction_queue.add(*critical)

    @staticmethod
    def _is_critical(pod) -> bool:
        return pod.spec.priority_class_name in ("system-cluster-critical", "system-node-critical")
