"""Requirements: a keyed set of Requirement values with intersection-on-add.

Mirrors pkg/scheduling/requirements.go:32-164 — including the asymmetric
`compatible` rule (custom labels must be *known* by the node side; well-known
labels are open-world) and the NotIn/DoesNotExist escape hatch in
`intersects`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional

from ..api import labels as lbl
from ..api.objects import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    NodeSelectorRequirement,
    Pod,
)
from .requirement import Requirement


class Requirements:
    __slots__ = ("_by_key",)

    def __init__(self, *requirements: Requirement):
        self._by_key: Dict[str, Requirement] = {}
        self.add(*requirements)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_node_selector_requirements(cls, reqs: Iterable[NodeSelectorRequirement]) -> "Requirements":
        return cls(*[Requirement(r.key, r.operator, *r.values) for r in reqs])

    @classmethod
    def from_labels(cls, labels: Dict[str, str]) -> "Requirements":
        return cls(*[Requirement(k, OP_IN, v) for k, v in labels.items()])

    @classmethod
    def from_pod(cls, pod: Pod) -> "Requirements":
        """Pod scheduling requirements: nodeSelector, the heaviest preferred
        node-affinity term, and the *first* required node-affinity term (OR
        semantics are handled by preference relaxation, see
        core/scheduler/preferences.py). Mirrors requirements.go:61-78.

        Memoized per (pod, resource_version): the host loop calls this for
        every candidate node it scans, and the result is treated as
        IMMUTABLE by every consumer (compatible/intersects/add never mutate
        their operands; relaxation copies drop the memo — preferences.py).
        """
        version = pod.metadata.resource_version
        cached = getattr(pod, "_reqs_cache", None)
        if cached is not None and cached[0] == version:
            return cached[1]
        requirements = cls.from_labels(pod.spec.node_selector)
        affinity = pod.spec.affinity
        if affinity is not None and affinity.node_affinity is not None:
            preferred = affinity.node_affinity.preferred
            if preferred:
                heaviest = max(preferred, key=lambda term: term.weight)
                requirements.add(*cls.from_node_selector_requirements(heaviest.preference.match_expressions).values())
            required = affinity.node_affinity.required
            if required:
                requirements.add(*cls.from_node_selector_requirements(required[0].match_expressions).values())
        try:
            pod._reqs_cache = (version, requirements)
        except AttributeError:
            pass  # slotted/frozen pod objects skip the memo
        return requirements

    # -- collection protocol ------------------------------------------------

    def same_as(self, other: "Requirements") -> bool:
        """Content equality over every key's full constraint state — the
        requirements-epoch guard of ExistingNodeView's cohort certificates
        (existingnode.py) relies on this detecting ANY semantic change."""
        if len(self._by_key) != len(other._by_key):
            return False
        for key, r in self._by_key.items():
            o = other._by_key.get(key)
            if (
                o is None
                or r.complement != o.complement
                or r.values != o.values
                or r.greater_than != o.greater_than
                or r.less_than != o.less_than
            ):
                return False
        return True

    def add(self, *requirements: Requirement) -> None:
        for requirement in requirements:
            existing = self._by_key.get(requirement.key)
            if existing is not None:
                requirement = requirement.intersection(existing)
            self._by_key[requirement.key] = requirement

    def keys(self) -> set:
        return set(self._by_key)

    def values(self) -> List[Requirement]:
        return list(self._by_key.values())

    def has(self, key: str) -> bool:
        return key in self._by_key

    def get(self, key: str) -> Requirement:
        if key not in self._by_key:
            return Requirement(key, OP_EXISTS)  # undefined keys allow anything
        return self._by_key[key]

    def copy(self) -> "Requirements":
        return Requirements(*self.values())

    def delete(self, key: str) -> None:
        self._by_key.pop(key, None)

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._by_key.values())

    def __len__(self) -> int:
        return len(self._by_key)

    # -- compatibility rules -------------------------------------------------

    def compatible(self, incoming: "Requirements") -> Optional[str]:
        """Can a node constrained by `self` satisfy `incoming`? Returns an
        error string or None. Custom (non-well-known) incoming keys must be
        defined on the node side unless the incoming operator is negative."""
        for key in incoming.keys() - lbl.WELL_KNOWN_LABELS:
            operator = incoming.get(key).operator()
            if self.has(key) or operator in (OP_NOT_IN, OP_DOES_NOT_EXIST):
                continue
            return f"key {key} does not have known values"
        return self.intersects(incoming)

    def intersects(self, incoming: "Requirements") -> Optional[str]:
        """Symmetric overlap check on shared keys; NotIn/DoesNotExist pairs
        are allowed to have empty intersections (requirements.go:130-147)."""
        for key in self.keys() & incoming.keys():
            existing = self.get(key)
            inc = incoming.get(key)
            if len(existing.intersection(inc)) == 0:
                if inc.operator() in (OP_NOT_IN, OP_DOES_NOT_EXIST) and existing.operator() in (OP_NOT_IN, OP_DOES_NOT_EXIST):
                    continue
                return f"key {key}, {inc!r} not in {existing!r}"
        return None

    def labels(self) -> Dict[str, str]:
        """Materialize concrete node labels from the requirements.

        Well-known / restricted node labels are excluded — those are injected
        by the cloud provider on the launched node (requirements.go:149-159).
        """
        out: Dict[str, str] = {}
        for key, requirement in self._by_key.items():
            if not lbl.is_restricted_node_label(key):
                value = requirement.any_value()
                if value:
                    out[key] = value
        return out

    def __repr__(self) -> str:
        shown = [r for r in self.values() if r.key not in lbl.RESTRICTED_LABELS]
        return ", ".join(repr(r) for r in shown)
