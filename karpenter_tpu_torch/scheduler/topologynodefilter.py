"""TopologyNodeFilter: which nodes count toward a spread constraint.

Mirrors topologynodefilter.go:30-70 — a pod's nodeSelector and required
node-affinity terms (OR across terms) restrict the set of nodes whose pods are
counted for that pod's topology-spread constraints.
"""

from __future__ import annotations

from typing import List

from ..api.objects import Node, Pod
from ..scheduling.requirements import Requirements


class TopologyNodeFilter:
    def __init__(self, terms: List[Requirements]):
        self.terms = terms  # OR semantics; empty list matches everything

    @classmethod
    def for_spread(cls, pod: Pod) -> "TopologyNodeFilter":
        terms: List[Requirements] = []
        selector = Requirements.from_labels(pod.spec.node_selector)
        affinity = pod.spec.affinity
        required = affinity.node_affinity.required if (affinity and affinity.node_affinity) else []
        if required:
            for term in required:
                combined = Requirements.from_node_selector_requirements(term.match_expressions)
                combined.add(*selector.values())
                terms.append(combined)
        elif len(selector):
            terms.append(selector)
        return cls(terms)

    @classmethod
    def always(cls) -> "TopologyNodeFilter":
        """The nil filter used for affinity/anti-affinity groups."""
        return cls([])

    def matches_node(self, node: Node) -> bool:
        if not self.terms:
            return True
        labels = Requirements.from_labels(node.metadata.labels)
        return any(labels.compatible(term) is None for term in self.terms)

    def matches_requirements(self, requirements: Requirements) -> bool:
        """Would a node with these requirements count for this filter?"""
        if not self.terms:
            return True
        return any(requirements.compatible(term) is None for term in self.terms)

    def hash_key(self):
        return tuple(
            tuple(sorted((r.key, r.complement, frozenset(r.values), r.greater_than, r.less_than) for r in term))
            for term in self.terms
        )
