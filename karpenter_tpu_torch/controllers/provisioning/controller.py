"""Provisioning reconciler: pod-watch trigger feeding the batcher.

Mirrors pkg/controllers/provisioning/controller.go:57-85 — every pod event
for a provisionable pod pulls the batcher trigger; the orchestrator loop
does the rest.
"""

from __future__ import annotations

from ...journal import JOURNAL
from ...kube.cluster import DELETED, KubeCluster, WatchEvent
from ...utils import pod as podutils
from .provisioner import ProvisionerController


class ProvisioningReconciler:
    def __init__(self, kube: KubeCluster, provisioner: ProvisionerController):
        self.kube = kube
        self.provisioner = provisioner
        kube.watch("Pod", self._on_pod_event)

    def detach(self) -> None:
        """Stop triggering the batcher: a stopped Runtime's reconciler must
        not keep firing on the shared cluster's pod events."""
        self.kube.unwatch("Pod", self._on_pod_event)

    def _on_pod_event(self, event: WatchEvent) -> None:
        if event.type == DELETED:
            return
        if podutils.is_provisionable(event.obj):
            if JOURNAL.enabled:
                # `queued`: the pod entered the batch window — the boundary
                # between the waterfall's queue_wait and batch_wait segments
                JOURNAL.pod_event(event.obj.metadata.name, "queued")
            self.provisioner.trigger()
