"""Preference relaxation: ordered constraint-dropping for stuck pods.

Mirrors pkg/controllers/provisioning/scheduling/preferences.go:36-147 — when a
pod can't schedule, soft (and OR-semantic required) constraints are removed one
per attempt, in a fixed order:
  1. a required node-affinity term (only when >1 term: OR semantics)
  2. all preferred pod-affinity terms (heaviest first)
  3. all preferred pod-anti-affinity terms (heaviest first)
  4. the heaviest preferred node-affinity term
  5. a ScheduleAnyway topology-spread constraint
  6. (if enabled) tolerate PreferNoSchedule taints

In the dense-solver formulation this same ladder becomes the penalty
hierarchy: each relaxation level corresponds to masking one soft-constraint
matrix out of the feasibility product (solver/tpu_solver.py).
"""

from __future__ import annotations

from typing import Optional

from ..api.objects import PREFER_NO_SCHEDULE, SCHEDULE_ANYWAY, Pod, Toleration


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> Optional[Pod]:
        """Apply at most one relaxation. Returns a relaxed *copy* of the pod
        (the caller's object is never mutated — pods may be live cluster
        state, especially under consolidation simulation), or None when
        nothing is left to relax."""
        import copy

        # Pod.__deepcopy__ drops the per-pod memo caches, so the relaxed
        # copy re-derives its signature and requirements (api/objects.py)
        candidate = copy.deepcopy(pod)
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_topology_spread_schedule_anyway,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for relax in relaxations:
            if relax(candidate) is not None:
                return candidate
        return None

    def _remove_required_node_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if not (affinity and affinity.node_affinity and affinity.node_affinity.required):
            return None
        terms = affinity.node_affinity.required
        if len(terms) > 1:  # OR semantics: drop the first, keep trying the rest
            affinity.node_affinity.required = terms[1:]
            return "removed required node-affinity term[0]"
        return None

    def _remove_preferred_node_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if not (affinity and affinity.node_affinity and affinity.node_affinity.preferred):
            return None
        terms = sorted(affinity.node_affinity.preferred, key=lambda t: -t.weight)
        affinity.node_affinity.preferred = terms[1:]
        return "removed heaviest preferred node-affinity term"

    def _remove_preferred_pod_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if not (affinity and affinity.pod_affinity and affinity.pod_affinity.preferred):
            return None
        terms = sorted(affinity.pod_affinity.preferred, key=lambda t: -t.weight)
        affinity.pod_affinity.preferred = terms[1:]
        return "removed heaviest preferred pod-affinity term"

    def _remove_preferred_pod_anti_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if not (affinity and affinity.pod_anti_affinity and affinity.pod_anti_affinity.preferred):
            return None
        terms = sorted(affinity.pod_anti_affinity.preferred, key=lambda t: -t.weight)
        affinity.pod_anti_affinity.preferred = terms[1:]
        return "removed heaviest preferred pod-anti-affinity term"

    def _remove_topology_spread_schedule_anyway(self, pod: Pod) -> Optional[str]:
        for i, constraint in enumerate(pod.spec.topology_spread_constraints):
            if constraint.when_unsatisfiable == SCHEDULE_ANYWAY:
                pod.spec.topology_spread_constraints = (
                    pod.spec.topology_spread_constraints[:i] + pod.spec.topology_spread_constraints[i + 1 :]
                )
                return "removed ScheduleAnyway topology-spread constraint"
        return None

    def _tolerate_prefer_no_schedule_taints(self, pod: Pod) -> Optional[str]:
        blanket = Toleration(operator="Exists", effect=PREFER_NO_SCHEDULE)
        for toleration in pod.spec.tolerations:
            if (
                toleration.operator == "Exists"
                and not toleration.key
                and toleration.effect == PREFER_NO_SCHEDULE
            ):
                return None
        pod.spec.tolerations = list(pod.spec.tolerations) + [blanket]
        return "added toleration for PreferNoSchedule taints"
