"""Volume topology injection.

Mirrors pkg/controllers/provisioning/volumetopology.go — rewrites pod node
affinity with the zone requirements of its bound/pending volumes so
WaitForFirstConsumer volumes schedule into the right zone, and validates
that referenced PVCs exist before scheduling.
"""

from __future__ import annotations

from typing import List, Optional

from ...api import labels as lbl
from ...api.objects import Affinity, NodeAffinity, NodeSelectorRequirement, NodeSelectorTerm, OP_IN, Pod
from ...kube.cluster import KubeCluster


class VolumeTopology:
    def __init__(self, kube: KubeCluster):
        self.kube = kube

    def needs_injection(self, pod: Pod) -> bool:
        return any(
            self._zones_for_volume(pod, volume) for volume in pod.spec.volumes
        )

    def inject(self, pod: Pod) -> None:
        """Tighten the pod's node affinity with volume zone requirements.

        Callers pass a copy of the stored pod — injection mutates the spec."""
        requirements: List[NodeSelectorRequirement] = []
        for volume in pod.spec.volumes:
            zones = self._zones_for_volume(pod, volume)
            if zones:
                requirements.append(NodeSelectorRequirement(lbl.LABEL_TOPOLOGY_ZONE, OP_IN, sorted(zones)))
        if not requirements:
            return
        if pod.spec.affinity is None:
            pod.spec.affinity = Affinity()
        if pod.spec.affinity.node_affinity is None:
            pod.spec.affinity.node_affinity = NodeAffinity()
        required = pod.spec.affinity.node_affinity.required
        if required:
            # every OR term must carry the volume zone restriction
            for term in required:
                term.match_expressions.extend(requirements)
        else:
            pod.spec.affinity.node_affinity.required = [NodeSelectorTerm(match_expressions=requirements)]

    def _zones_for_volume(self, pod: Pod, volume) -> Optional[List[str]]:
        if volume.persistent_volume_claim is None:
            return None
        pvc = self.kube.get_persistent_volume_claim(pod.namespace, volume.persistent_volume_claim.claim_name)
        if pvc is None:
            return None
        if pvc.volume_name:
            pv = self.kube.get_persistent_volume(pvc.volume_name)
            if pv is not None and pv.zones:
                return pv.zones
        if pvc.storage_class_name:
            sc = self.kube.get_storage_class(pvc.storage_class_name)
            if sc is not None and sc.zones:
                return sc.zones
        return None

    def validate_persistent_volume_claims(self, pod: Pod) -> Optional[str]:
        """Error string if any referenced PVC is missing."""
        for volume in pod.spec.volumes:
            if volume.persistent_volume_claim is None:
                continue
            name = volume.persistent_volume_claim.claim_name
            if self.kube.get_persistent_volume_claim(pod.namespace, name) is None:
                return f"persistentvolumeclaim {name!r} not found"
        return None
