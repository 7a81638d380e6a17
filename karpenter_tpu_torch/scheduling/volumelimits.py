"""VolumeLimits: per-node CSI-driver mounted-volume counting.

Mirrors pkg/scheduling/volumelimits.go:33-236 — resolves each pod PVC through
its StorageClass/PV to a CSI driver name, counts unique mounted volumes per
driver, and compares against the node's CSINode allocatable limits.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from ..api.objects import CSINode, Pod


class VolumeCount(dict):
    """driver name -> number of unique volumes."""

    def exceeds(self, limits: "VolumeCount") -> bool:
        for driver, count in self.items():
            if driver in limits and count > limits[driver]:
                return True
        return False


class VolumeLimits:
    """Tracks which volumes are mounted per CSI driver on one node.

    The kube client is any object exposing get_persistent_volume_claim /
    get_persistent_volume / get_storage_class lookups (see kube.Client).
    """

    def __init__(self, kube_client=None):
        self._kube = kube_client
        self._volumes: Dict[str, Set[str]] = {}  # driver -> volume ids
        self._pod_volumes: Dict[str, Dict[str, Set[str]]] = {}  # pod uid -> driver -> ids

    def _resolve_driver(self, namespace: str, claim_name: str) -> Optional[str]:
        if self._kube is None:
            return None
        pvc = self._kube.get_persistent_volume_claim(namespace, claim_name)
        if pvc is None:
            return None
        if pvc.volume_name:
            pv = self._kube.get_persistent_volume(pvc.volume_name)
            if pv is not None and pv.csi_driver:
                return pv.csi_driver
        if pvc.storage_class_name:
            sc = self._kube.get_storage_class(pvc.storage_class_name)
            if sc is not None and sc.provisioner:
                return sc.provisioner
        return None

    def _volumes_for_pod(self, pod: Pod) -> Dict[str, Set[str]]:
        result: Dict[str, Set[str]] = {}
        for volume in pod.spec.volumes:
            if volume.persistent_volume_claim is None:
                continue
            claim = volume.persistent_volume_claim.claim_name
            driver = self._resolve_driver(pod.namespace, claim)
            if driver is None:
                continue
            result.setdefault(driver, set()).add(f"{pod.namespace}/{claim}")
        return result

    def validate(self, pod: Pod) -> VolumeCount:
        """Counts volumes mounted if the pod schedules (existing + new)."""
        result = VolumeCount()
        new = self._volumes_for_pod(pod)
        for driver, existing in self._volumes.items():
            result[driver] = len(existing | new.get(driver, set()))
        for driver, ids in new.items():
            if driver not in result:
                result[driver] = len(ids)
        return result

    def add(self, pod: Pod) -> None:
        per_pod = self._volumes_for_pod(pod)
        self._pod_volumes[pod.uid] = per_pod
        for driver, ids in per_pod.items():
            self._volumes.setdefault(driver, set()).update(ids)

    def delete_pod(self, uid: str) -> None:
        per_pod = self._pod_volumes.pop(uid, None)
        if not per_pod:
            return
        # rebuild driver sets from remaining pods (volumes may be shared)
        self._volumes = {}
        for volumes in self._pod_volumes.values():
            for driver, ids in volumes.items():
                self._volumes.setdefault(driver, set()).update(ids)

    def copy(self) -> "VolumeLimits":
        out = VolumeLimits(self._kube)
        out._volumes = {d: set(v) for d, v in self._volumes.items()}
        out._pod_volumes = {u: {d: set(v) for d, v in pv.items()} for u, pv in self._pod_volumes.items()}
        return out

    def to_wire(self) -> tuple:
        """Detached plain-data form for the solver-service wire (service/)."""
        return (
            {d: sorted(v) for d, v in self._volumes.items()},
            {u: {d: sorted(v) for d, v in pv.items()} for u, pv in self._pod_volumes.items()},
        )

    @classmethod
    def from_wire(cls, data: tuple, kube_client=None) -> "VolumeLimits":
        out = cls(kube_client)
        volumes, pod_volumes = data
        out._volumes = {d: set(v) for d, v in volumes.items()}
        out._pod_volumes = {u: {d: set(v) for d, v in pv.items()} for u, pv in pod_volumes.items()}
        return out


def limits_from_csi_node(csi_node: Optional[CSINode]) -> VolumeCount:
    limits = VolumeCount()
    if csi_node is not None:
        for driver in csi_node.drivers:
            if driver.allocatable_count is not None:
                limits[driver.name] = driver.allocatable_count
    return limits
