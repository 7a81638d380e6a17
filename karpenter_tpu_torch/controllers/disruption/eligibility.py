"""Shared disruption-eligibility gate: PDBs + the do-not-disrupt veto.

`PDBLimits` moved here from the consolidation-private
`controllers/consolidation/pdblimits.py` (the reference made the same move
when it unified its disruption methods): every voluntary method — emptiness,
expiration, drift, consolidation — now runs the SAME per-pass PDB snapshot
and pod-level vetoes instead of each recomputing its own.

The port's copy of karpenter_tpu/controllers/disruption/eligibility.py.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ...api.objects import Pod
from ...kube.cluster import KubeCluster
from ...utils import pod as podutils


class PDBLimits:
    """Can a node's pods all be evicted right now? Built once per disruption
    pass (the PDB list is snapshotted at construction) and shared across
    every method's candidates — the per-pass recompute the old per-method
    copies each paid is gone."""

    def __init__(self, kube: KubeCluster):
        self.kube = kube
        self.pdbs = kube.list("PodDisruptionBudget")

    def can_evict(self, pods: Iterable[Pod]) -> Optional[str]:
        """None if all pods are currently evictable; else a reason."""
        needed: dict = {}
        for pod in pods:
            for pdb in self.pdbs:
                if pdb.metadata.namespace != pod.namespace:
                    continue
                if pdb.selector is not None and pdb.selector.matches(pod.metadata.labels):
                    key = (pdb.metadata.namespace, pdb.metadata.name)
                    needed[key] = needed.get(key, 0) + 1
                    if needed[key] > pdb.disruptions_allowed:
                        return f"pdb {pdb.metadata.name} prevents pod evictions"
        return None


def pod_ineligible_reason(pods: Iterable[Pod], pdb: Optional[PDBLimits] = None) -> Optional[str]:
    """The pod-level voluntary-disruption gate shared by every method: a
    karpenter.sh/do-not-disrupt (or legacy do-not-evict) pod, an ownerless
    pod (nothing would recreate it), or a PDB at its disruption limit makes
    the node ineligible. Returns the human-readable reason, or None."""
    pods = list(pods)
    if pdb is not None:
        reason = pdb.can_evict(pods)
        if reason is not None:
            return reason
    for pod in pods:
        if podutils.is_terminal(pod):
            continue
        if podutils.has_do_not_disrupt(pod):
            return f"pod {pod.name} has karpenter.sh/do-not-disrupt"
        if not podutils.is_owned(pod) and not podutils.is_owned_by_daemonset(pod):
            return f"pod {pod.name} has no controller owner"
    return None
