"""Topology tracker: spread / affinity / anti-affinity bookkeeping for a solve.

Mirrors topology.go — topology groups deduplicated by hash, the inverse
anti-affinity index (existing pods whose anti-affinity blocks new pods),
domain counting against the cluster, requirement tightening per matching
group, and post-placement recording.

The `kube` client may be None (pure solver benchmarks); then no existing-pod
counting happens. Otherwise the bound pods and their nodes are read from its
informer cache (`cached_pods`, `cached_node`; over HTTP no request, as
Karpenter's countDomains reads its cached client), a node the cache lacks
and the nominated pods' nodes directly. The `cluster` provides `for_pods_with_anti_affinity`.
`nominated` holds (node name, pods) pairs that count as bound to that node
although they are not yet: the pods a provisioning round placed before its
capacity-failure re-solve, and those the interruption controller's earlier
re-solves placed (the port's addition; the JAX package counts bound pods
only). A nominated pod is counted once, at its nominated node, even while
it is still bound to another (the victim it is being moved off).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..api import labels as lbl
from ..api.objects import LabelSelector, Node, OP_EXISTS, Pod
from ..scheduling.requirement import Requirement
from ..scheduling.requirements import Requirements
from ..utils import pod as podutils
from .errors import UnsatisfiableTopologyError
from .topologygroup import MAX_INT32, TopologyGroup, TopologyType


class Topology:
    def __init__(
        self,
        kube=None,
        cluster=None,
        domains: Optional[Dict[str, Set[str]]] = None,
        pods: Iterable[Pod] = (),
        nominated: Sequence[tuple] = (),
    ):
        self.kube = kube
        self.cluster = cluster
        self.nominated = [(pod, name) for name, placed in nominated for pod in placed]
        self._nominated_uids: Set[str] = {pod.uid for pod, _ in self.nominated}
        self.domains: Dict[str, Set[str]] = {k: set(v) for k, v in (domains or {}).items()}
        self.topologies: Dict[tuple, TopologyGroup] = {}
        self.inverse_topologies: Dict[tuple, TopologyGroup] = {}
        # topology-key → groups index so register/unregister (called per new
        # virtual node for the placeholder hostname) touch only the groups
        # keyed on that label instead of scanning every group
        self._groups_by_key: Dict[str, List[TopologyGroup]] = {}
        pods = list(pods)  # may be a generator; we iterate twice
        # the batch being scheduled must not count toward its own topologies
        self.excluded_pods: Set[str] = {p.uid for p in pods}
        # pods that have registered ownership at least once: update() only
        # needs its remove-ownership sweep (O(groups)) for these.
        # INVARIANT: ownership enters self.topologies only through update()
        # (relaxation copies preserve pod.uid, preferences.py). Any new code
        # path that calls add_owner on a group directly must also add the uid
        # here, or the skipped sweep will leave stale owners behind.
        self._registered: Set[str] = set()
        self._update_inverse_affinities()
        for p in pods:
            self.update(p)

    # -- group construction --------------------------------------------------

    def update(self, pod: Pod) -> None:
        """(Re)register the pod as owner of its topology groups; called after
        relaxation to drop ownership of removed constraints."""
        if pod.uid in self._registered:
            for group in self.topologies.values():
                group.remove_owner(pod.uid)
        else:
            self._registered.add(pod.uid)

        if podutils.has_required_pod_anti_affinity(pod):
            self._update_inverse_anti_affinity(pod, node_labels=None)

        groups = self._new_for_spread(pod) + self._new_for_affinities(pod)
        for group in groups:
            key = group.hash_key()
            existing = self.topologies.get(key)
            if existing is None:
                self._count_domains(group)
                self.topologies[key] = group
                self._groups_by_key.setdefault(group.key, []).append(group)
                existing = group
            existing.add_owner(pod.uid)

    def _new_for_spread(self, pod: Pod) -> List[TopologyGroup]:
        return [
            TopologyGroup(
                TopologyType.SPREAD,
                constraint.topology_key,
                pod,
                {pod.namespace},
                constraint.label_selector,
                constraint.max_skew,
                self.domains.get(constraint.topology_key, set()),
            )
            for constraint in pod.spec.topology_spread_constraints
        ]

    def _new_for_affinities(self, pod: Pod) -> List[TopologyGroup]:
        groups: List[TopologyGroup] = []
        affinity = pod.spec.affinity
        if affinity is None:
            return groups
        terms = []
        if affinity.pod_affinity:
            terms += [(TopologyType.POD_AFFINITY, t) for t in affinity.pod_affinity.required]
            terms += [(TopologyType.POD_AFFINITY, wt.pod_affinity_term) for wt in affinity.pod_affinity.preferred]
        if affinity.pod_anti_affinity:
            terms += [(TopologyType.POD_ANTI_AFFINITY, t) for t in affinity.pod_anti_affinity.required]
            terms += [(TopologyType.POD_ANTI_AFFINITY, wt.pod_affinity_term) for wt in affinity.pod_anti_affinity.preferred]
        for topology_type, term in terms:
            namespaces = self._build_namespace_list(pod.namespace, term.namespaces, term.namespace_selector)
            groups.append(
                TopologyGroup(
                    topology_type,
                    term.topology_key,
                    pod,
                    namespaces,
                    term.label_selector,
                    MAX_INT32,
                    self.domains.get(term.topology_key, set()),
                )
            )
        return groups

    def _build_namespace_list(self, namespace: str, namespaces: List[str], selector: Optional[LabelSelector]) -> Set[str]:
        if not namespaces and selector is None:
            return {namespace}
        if selector is None:
            return set(namespaces)
        selected = set(namespaces)
        if self.kube is not None:
            for ns in self.kube.list_namespaces():
                if selector.matches(ns.metadata.labels):
                    selected.add(ns.metadata.name)
        return selected

    # -- inverse anti-affinity ----------------------------------------------

    def _update_inverse_affinities(self) -> None:
        for pod, name in self.nominated:
            if podutils.has_required_pod_anti_affinity(pod) and pod.uid not in self.excluded_pods:
                node = self.kube.get_node(name) if self.kube is not None else None
                self._update_inverse_anti_affinity(pod, node.metadata.labels if node is not None else None)
        if self.cluster is None:
            return

        def visit(pod: Pod, node) -> bool:
            if pod.uid not in self.excluded_pods and pod.uid not in self._nominated_uids:
                self._update_inverse_anti_affinity(pod, node.metadata.labels if node is not None else None)
            return True

        self.cluster.for_pods_with_anti_affinity(visit)

    def _update_inverse_anti_affinity(self, pod: Pod, node_labels: Optional[Dict[str, str]]) -> None:
        # only *required* anti-affinity terms are tracked inversely; preferred
        # ones add relaxation complexity for near-zero value (topology.go:203-207)
        for term in pod.spec.affinity.pod_anti_affinity.required:
            namespaces = self._build_namespace_list(pod.namespace, term.namespaces, term.namespace_selector)
            group = TopologyGroup(
                TopologyType.POD_ANTI_AFFINITY,
                term.topology_key,
                pod,
                namespaces,
                term.label_selector,
                MAX_INT32,
                self.domains.get(term.topology_key, set()),
            )
            key = group.hash_key()
            existing = self.inverse_topologies.get(key)
            if existing is None:
                self.inverse_topologies[key] = group
                self._groups_by_key.setdefault(group.key, []).append(group)
                existing = group
            if node_labels and group.key in node_labels:
                existing.record(node_labels[group.key])
            existing.add_owner(pod.uid)

    # -- domain counting ------------------------------------------------------

    def _count_domains(self, group: TopologyGroup) -> None:
        # the bound pods and their nodes come from the kube client's
        # informer cache, as Karpenter's countDomains reads its cached
        # client: over HTTP no request per group namespace
        if self.kube is None:
            return
        for namespace in group.namespaces:
            for p in self.kube.cached_pods(namespace=namespace):
                # a nominated pod still bound to the node it is being moved
                # off (an interruption victim, cordoned and deleting) is
                # counted below at its nominated node, not here as well
                if not _ignored_for_topology(p) and p.uid not in self._nominated_uids:
                    self._count_pod(group, p, p.spec.node_name, self._bound_node)
        for p, name in self.nominated:
            if p.namespace in group.namespaces and not (podutils.is_terminal(p) or podutils.is_terminating(p)):
                # read directly: the round may have launched the node so
                # recently that no watch event has brought it to the cache
                self._count_pod(group, p, name, self.kube.get_node)

    def _bound_node(self, name: Optional[str]) -> Optional[Node]:
        """A bound pod's node from the cache, or read directly when the
        Node informer has not yet decoded the node the Pod informer's pod is
        bound to (the two streams run apart): skipping the pod would leave
        it out of the counts."""
        node = self.kube.cached_node(name)
        if node is None and name:
            node = self.kube.get_node(name)
        return node

    def _count_pod(self, group: TopologyGroup, p: Pod, node_name: Optional[str], node_of) -> None:
        if group.selector is not None and not group.selector.matches(p.metadata.labels):
            return
        if p.uid in self.excluded_pods:
            return
        node = node_of(node_name)
        if node is None:
            return
        domain = node.metadata.labels.get(group.key)
        if domain is None and group.key == lbl.LABEL_HOSTNAME:
            # node may not carry the hostname label yet; fall back to name
            domain = node.name
        if domain is None:
            return
        if not group.node_filter.matches_node(node):
            return
        group.record(domain)

    # -- solve-time interface -------------------------------------------------

    def cohort_context(self, representative: Pod, inverse_index: Optional[Dict[str, List[TopologyGroup]]] = None) -> "CohortContext":
        """Precompute group membership for a cohort of identically-shaped
        pods (one dense-solver constraint-signature group). Ownership and
        selection depend only on the shared signature (labels, namespace,
        carried constraints), so one scan serves every pod in the cohort —
        the warm-cluster fill otherwise pays a full LabelSelector sweep per
        pod per group. Pass a shared `inverse_index` (inverse_owner_index)
        to amortize that build across many cohorts."""
        return CohortContext(
            owned=[g for g in self.topologies.values() if g.is_owned_by(representative.uid)],
            selected=[g for g in self.topologies.values() if g.selects(representative)],
            inverse_selected=[g for g in self.inverse_topologies.values() if g.selects(representative)],
            inverse_index=inverse_index if inverse_index is not None else self.inverse_owner_index(),
        )

    def add_requirements(
        self,
        pod_requirements: Requirements,
        node_requirements: Requirements,
        pod: Pod,
        ctx: Optional["CohortContext"] = None,
    ) -> Requirements:
        """Tighten node requirements with the next-domain choice of every
        matching topology group; raises RuntimeError when unsatisfiable."""
        requirements = Requirements(*node_requirements.values())
        if ctx is not None:
            # ownership is cohort-constant and inverse groups carry no node
            # filter, so this equals _matching_topologies for every cohort pod
            matching = ctx.owned + ctx.inverse_selected
        else:
            matching = self._matching_topologies(pod, node_requirements)
        for group in matching:
            pod_domains = pod_requirements.get(group.key) if pod_requirements.has(group.key) else Requirement(group.key, OP_EXISTS)
            node_domains = node_requirements.get(group.key) if node_requirements.has(group.key) else Requirement(group.key, OP_EXISTS)
            domains = group.get(pod, pod_domains, node_domains)
            if len(domains) == 0:
                raise UnsatisfiableTopologyError(f"unsatisfiable topology constraint for {group.type.value}, key={group.key}")
            requirements.add(domains)
        return requirements

    def record(self, pod: Pod, requirements: Requirements, ctx: Optional["CohortContext"] = None) -> None:
        """Commit domain counts after a successful placement."""
        matching = ctx.matching_for(requirements) if ctx is not None else None
        inverse_index = ctx.inverse_index if ctx is not None else None
        self.record_cohort([pod], requirements, matching=matching, inverse_index=inverse_index)

    def matching_cohort_groups(self, representative: Pod, requirements: Requirements) -> List[TopologyGroup]:
        """Groups that count a cohort represented by this pod under these
        requirements. Cacheable by the caller: cohorts from one dense bucket
        share namespace, labels, and requirements up to the per-bin
        placeholder hostname (solver/dense.py)."""
        return [g for g in self.topologies.values() if g.counts(representative, requirements)]

    def inverse_owner_index(self) -> Dict[str, List[TopologyGroup]]:
        """pod uid → inverse anti-affinity groups owning it; build once per
        commit sweep instead of scanning all inverse groups per pod."""
        index: Dict[str, List[TopologyGroup]] = {}
        for group in self.inverse_topologies.values():
            for uid in group.owners:
                index.setdefault(uid, []).append(group)
        return index

    def record_cohort(
        self,
        pods: Sequence[Pod],
        requirements: Requirements,
        matching: Optional[List[TopologyGroup]] = None,
        inverse_index: Optional[Dict[str, List[TopologyGroup]]] = None,
    ) -> None:
        """Commit domain counts for a cohort of pods placed together with
        identical requirements (one dense bin). Group membership checks run
        once per cohort instead of per pod — cohort pods share namespace and
        labels by construction (ir/encode.py groups by signature). Callers
        may pass precomputed `matching` (matching_cohort_groups) and
        `inverse_index` (inverse_owner_index) to amortize the scans across
        many cohorts; the recording rules live only here."""
        if not pods:
            return
        n = len(pods)
        if matching is None:
            matching = self.matching_cohort_groups(pods[0], requirements)
        for group in matching:
            domains = requirements.get(group.key)
            if group.type == TopologyType.POD_ANTI_AFFINITY:
                # block out every domain the pods *could* land in
                group.record(*domains.values, count=n)
            elif len(domains) == 1 and not domains.complement:
                group.record(next(iter(domains.values)), count=n)
        if inverse_index is None:
            for group in self.inverse_topologies.values():
                for pod in pods:
                    if group.is_owned_by(pod.uid):
                        group.record(*requirements.get(group.key).values)
        else:
            for pod in pods:
                for group in inverse_index.get(pod.uid, ()):
                    group.record(*requirements.get(group.key).values)

    def register(self, topology_key: str, domain: str) -> None:
        """Make a new domain (e.g. a fresh hostname) visible to all groups."""
        self.domains.setdefault(topology_key, set()).add(domain)
        for group in self._groups_by_key.get(topology_key, ()):
            group.register(domain)

    def unregister(self, topology_key: str, domain: str) -> None:
        """Retract a domain that was registered but never used (zero counts
        everywhere) — the cleanup path for discarded probe nodes."""
        self.domains.get(topology_key, set()).discard(domain)
        for group in self._groups_by_key.get(topology_key, ()):
            group.unregister(domain)

    def _matching_topologies(self, pod: Pod, requirements: Requirements) -> List[TopologyGroup]:
        matching = [g for g in self.topologies.values() if g.is_owned_by(pod.uid)]
        matching += [g for g in self.inverse_topologies.values() if g.counts(pod, requirements)]
        return matching


class CohortContext:
    """Precomputed topology-group membership for one cohort of
    identically-shaped pods; see Topology.cohort_context."""

    __slots__ = ("owned", "selected", "inverse_selected", "inverse_index")

    def __init__(self, owned, selected, inverse_selected, inverse_index):
        self.owned: List[TopologyGroup] = owned
        self.selected: List[TopologyGroup] = selected
        self.inverse_selected: List[TopologyGroup] = inverse_selected
        self.inverse_index: Dict[str, List[TopologyGroup]] = inverse_index

    def matching_for(self, requirements: Requirements) -> List[TopologyGroup]:
        """matching_cohort_groups over the precomputed selection: only the
        (spread-only) node filter still depends on the node requirements."""
        return [g for g in self.selected if g.node_filter.matches_requirements(requirements)]


def _ignored_for_topology(p: Pod) -> bool:
    return not podutils.is_scheduled(p) or podutils.is_terminal(p) or podutils.is_terminating(p)
