"""TopologyGroup: one topology constraint shared by many owner pods.

Mirrors topologygroup.go — a deduplicated (by hash) spread / pod-affinity /
pod-anti-affinity constraint with its domain→count index and the next-domain
selection rules:
  spread        → min-count domain within maxSkew (kube-scheduler formula)
  affinity      → any populated domain (with self-affinity bootstrap)
  anti-affinity → only zero-count domains
"""

from __future__ import annotations

import enum
from typing import Dict, Iterable, Optional, Set

from ..api import labels as lbl
from ..api.objects import LabelSelector, OP_DOES_NOT_EXIST, OP_IN, Pod
from ..scheduling.requirement import Requirement
from ..scheduling.requirements import Requirements
from .topologynodefilter import TopologyNodeFilter

MAX_INT32 = (1 << 31) - 1


class TopologyType(enum.Enum):
    SPREAD = "topology spread"
    POD_AFFINITY = "pod affinity"
    POD_ANTI_AFFINITY = "pod anti-affinity"


def _selector_hash_key(selector: Optional[LabelSelector]):
    if selector is None:
        return None
    return (
        tuple(sorted(selector.match_labels.items())),
        tuple(sorted((e.key, e.operator, tuple(sorted(e.values))) for e in selector.match_expressions)),
    )


class TopologyGroup:
    def __init__(
        self,
        topology_type: TopologyType,
        key: str,
        pod: Optional[Pod],
        namespaces: Set[str],
        selector: Optional[LabelSelector],
        max_skew: int,
        domains: Iterable[str],
    ):
        self.type = topology_type
        self.key = key
        self.namespaces = set(namespaces)
        self.selector = selector
        self.max_skew = max_skew
        # sorted for determinism: the domain universe arrives as a set, and
        # selection order must not depend on hash seeds
        self.domains: Dict[str, int] = {domain: 0 for domain in sorted(domains or ())}
        # zero-count domains, kept in sync by record/register (and
        # Topology.unregister): anti-affinity next-domain selection reads
        # this set directly instead of scanning every domain per pod — with
        # hundreds of registered hostnames that scan dominated warm-cluster
        # fills
        self._zero_domains: Set[str] = set(self.domains)
        # selects(pod) is deterministic per pod (labels are immutable during
        # a solve) but the matching scans call it twice per add per group —
        # memoize by uid (groups live for one solve; the cache dies with it)
        self._selects_cache: Dict[str, bool] = {}
        self.owners: Set[str] = set()  # pod UIDs governed by this group
        # rotates among equal-min-count domains so a pod whose chosen domain
        # proves infeasible (e.g. no offering for that zone x capacity-type
        # pair) explores the other ties on retry — the deterministic
        # counterpart of the reference's randomized Go map iteration
        self._tie_rotation = 0
        if topology_type == TopologyType.SPREAD and pod is not None:
            self.node_filter = TopologyNodeFilter.for_spread(pod)
        else:
            self.node_filter = TopologyNodeFilter.always()

    # -- identity ------------------------------------------------------------

    def hash_key(self):
        return (
            self.key,
            self.type,
            frozenset(self.namespaces),
            _selector_hash_key(self.selector),
            self.max_skew,
            self.node_filter.hash_key(),
        )

    # -- ownership / counting ------------------------------------------------

    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    def selects(self, pod: Pod) -> bool:
        cached = self._selects_cache.get(pod.uid)
        if cached is None:
            selector = self.selector or LabelSelector()
            cached = pod.namespace in self.namespaces and selector.matches(pod.metadata.labels)
            self._selects_cache[pod.uid] = cached
        return cached

    def counts(self, pod: Pod, requirements: Requirements) -> bool:
        """Would this pod, scheduled onto a node with `requirements`, count?"""
        return self.selects(pod) and self.node_filter.matches_requirements(requirements)

    def record(self, *domains: str, count: int = 1) -> None:
        for domain in domains:
            self.domains[domain] = self.domains.get(domain, 0) + count
            self._zero_domains.discard(domain)

    def register(self, *domains: str) -> None:
        for domain in domains:
            if self.domains.setdefault(domain, 0) == 0:
                self._zero_domains.add(domain)

    def unregister(self, domain: str) -> None:
        """Drop a zero-count domain (probe-node cleanup); both the counts
        dict and the zero set are maintained here so the invariant lives in
        one class."""
        if self.domains.get(domain) == 0:
            del self.domains[domain]
            self._zero_domains.discard(domain)

    # -- next-domain selection ----------------------------------------------

    # when the node pins this key to at most this many concrete values (an
    # existing node's hostname, a chosen zone), next-domain selection only
    # needs to answer membership for those values instead of scanning /
    # materializing the full domain universe — with hundreds of registered
    # hostnames that scan dominated warm-cluster fills
    _PINNED_FAST_PATH = 4

    def get(self, pod: Pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if self.type == TopologyType.SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == TopologyType.POD_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains, node_domains)

    def _next_domain_spread(self, pod: Pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        global_min = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)
        candidates: list = []
        min_count = MAX_INT32
        if not node_domains.complement and 0 < len(node_domains.values) <= self._PINNED_FAST_PATH:
            # pinned node: evaluate the skew rule for just its value(s) —
            # identical outcome to the full scan, which filters on
            # node_domains.has(domain) anyway
            domain_iter = (d for d in sorted(node_domains.values) if d in self.domains)
        else:
            domain_iter = (d for d in self.domains if node_domains.has(d))
        for domain in domain_iter:
            count = self.domains[domain]
            if self_selecting:
                count += 1
            # kube-scheduler skew rule: count - global_min <= maxSkew
            if count - global_min <= self.max_skew:
                if count < min_count:
                    min_count = count
                    candidates = [domain]
                elif count == min_count:
                    candidates.append(domain)
        if not candidates:
            return Requirement(self.key, OP_DOES_NOT_EXIST)
        choice = candidates[self._tie_rotation % len(candidates)]
        self._tie_rotation += 1
        return Requirement(self.key, OP_IN, choice)

    def admits_pinned(self, domain: str, pod_domains: Requirement, self_selecting: bool) -> bool:
        """The spread skew rule for a node pinned to `domain` — the same
        arithmetic _next_domain_spread evaluates for a pinned node, exposed
        so cohort fast paths (existingnode.add_cohort) can re-check the one
        genuinely per-pod spread condition without rebuilding requirement
        objects. Must stay byte-equivalent to the pinned branch above."""
        if domain not in self.domains or not pod_domains.has(domain):
            return False
        count = self.domains[domain]
        if self_selecting:
            count += 1
        return count - self._domain_min_count(pod_domains) <= self.max_skew

    def _domain_min_count(self, domains: Requirement) -> int:
        # hostname topologies can always mint a fresh (zero-count) domain
        if self.key == lbl.LABEL_HOSTNAME:
            return 0
        lowest = MAX_INT32
        for domain, count in self.domains.items():
            if domains.has(domain):
                lowest = min(lowest, count)
        return lowest

    def _next_domain_affinity(self, pod: Pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        options = Requirement(self.key, OP_DOES_NOT_EXIST)
        for domain, count in self.domains.items():
            if pod_domains.has(domain) and count > 0:
                options.insert(domain)
        # self-affinity bootstrap: nothing recorded yet, so seed one viable
        # domain (preferring the node's current domain set for in-flight nodes)
        if len(options) == 0 and self.selects(pod):
            intersected = pod_domains.intersection(node_domains)
            for domain in sorted(self.domains):
                if intersected.has(domain):
                    options.insert(domain)
                    break
            if len(options) == 0:
                for domain in sorted(self.domains):
                    if pod_domains.has(domain):
                        options.insert(domain)
                        break
        return options

    def _next_domain_anti_affinity(self, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if not node_domains.complement and 0 < len(node_domains.values) <= self._PINNED_FAST_PATH:
            # pinned node: the caller only uses the result to (a) test whether
            # the node's own domain is admitted and (b) distinguish "this node
            # is blocked" (non-empty result excluding it → IncompatibleError)
            # from "no zero-count domain exists anywhere" (empty result →
            # UnsatisfiableTopologyError). Answer membership for the pinned
            # values; when none is admitted, return one witness zero-count
            # domain so the global-satisfiability signal is preserved without
            # materializing all (possibly hundreds of) zero-count hostnames.
            admitted = [d for d in sorted(node_domains.values) if d in self._zero_domains and pod_domains.has(d)]
            if admitted:
                return Requirement(self.key, OP_IN, *admitted)
            # min() keeps the witness hash-seed independent (determinism is
            # load-bearing for differential testing, see line 56)
            witness = min((d for d in self._zero_domains if pod_domains.has(d)), default=None)
            if witness is not None:
                return Requirement(self.key, OP_IN, witness)
            return Requirement(self.key, OP_IN)
        # unconstrained pods (the common case: no explicit requirement on
        # the key) admit every zero-count domain — skip the per-domain scan
        if pod_domains.complement and not pod_domains.values and pod_domains.greater_than is None and pod_domains.less_than is None:
            return Requirement(self.key, OP_IN, *self._zero_domains)
        return Requirement(self.key, OP_IN, *(d for d in self._zero_domains if pod_domains.has(d)))
