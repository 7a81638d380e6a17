"""ExistingNodeView: scheduling against a real or in-flight node.

Mirrors scheduling/existingnode.go — the same add() protocol as VirtualNode
but against fixed capacity: remaining daemonset headroom, ephemeral taint
filtering (not-ready/unreachable, startup taints until initialized), volume
limits, and available-resource fit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api import labels as lbl
from ..api.objects import NO_SCHEDULE, OP_EXISTS, Pod, Taint
from ..scheduling.requirement import Requirement
from ..scheduling.requirements import Requirements
from ..scheduling.taints import Taints
from ..utils import resources as res
from .errors import IncompatibleError
from .topology import Topology


class CohortCert:
    """Reusable cheap-path certificate for one (cohort, view) pair — built
    by ExistingNodeView.certify after a successful full add, consumed by
    add_certified_run. Valid while the view's requirement content is
    unchanged (epoch == view.req_epoch)."""

    __slots__ = ("epoch", "requirements", "matching", "inverse_index", "spread_checks", "portless")


class BucketCert:
    """Per-cohort certificate valid on ANY view: for a cohort whose pods
    carry no node requirements and whose owned groups are spread /
    anti-affinity / (populated) self-affinity, the exact add()'s verdict on
    a view reduces to taints + capacity + ports/volumes + per-key
    set/integer lookups against the view's own label domain — the pinned
    fast paths of topologygroup.get. Built by ExistingNodeView
    .certify_bucket, consumed by add_certified_view. Covers the dedicated
    (one-pod-per-host) shapes as the hostname special case."""

    __slots__ = ("anti_groups", "spread_checks", "affinity_groups", "inverse_groups", "ctx", "portless", "matching_by_view")


class ExistingNodeView:
    def __init__(self, state_node, topology: Topology, startup_taints, daemon_resources: Dict[str, float]):
        self.state_node = state_node
        self.node = state_node.node
        self.topology = topology
        self.pods: List[Pod] = []

        # remaining daemon resources: total expected minus already scheduled,
        # clamped at zero (existingnode.go:46-55)
        remaining = res.subtract(daemon_resources or {}, state_node.daemonset_requested)
        self.requests = res.clamp_negative_to_zero(remaining)
        self.available = dict(state_node.available)
        self.requirements = Requirements.from_labels(self.node.metadata.labels)
        # copy the shared trackers: tentative placements (and simulation-mode
        # what-ifs) must never leak reservations into live cluster state
        self.host_port_usage = state_node.host_port_usage.copy()
        self.volume_usage = state_node.volume_usage.copy()
        self.volume_limits = state_node.volume_limits

        # ephemeral taints are ignored for scheduling; startup taints only
        # until the node initializes (existingnode.go:67-84)
        ephemeral = [
            Taint(key=lbl.TAINT_NODE_NOT_READY, effect=NO_SCHEDULE),
            Taint(key=lbl.TAINT_NODE_UNREACHABLE, effect=NO_SCHEDULE),
        ]
        if self.node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) != "true":
            ephemeral += list(startup_taints or [])
        self.taints = Taints(
            t
            for t in self.node.spec.taints
            if not any(e.key == t.key and e.value == t.value and e.effect == t.effect for e in ephemeral)
        )

        hostname = self.node.metadata.labels.get(lbl.LABEL_HOSTNAME) or self.node.name
        from ..api.objects import OP_IN
        from ..scheduling.requirement import Requirement

        self.requirements.add(Requirement(lbl.LABEL_HOSTNAME, OP_IN, hostname))
        topology.register(lbl.LABEL_HOSTNAME, hostname)
        # bumped whenever add() changes this view's requirement CONTENT —
        # the validity guard for cohort certificates (certify below)
        self.req_epoch = 0

    def add(self, pod: Pod, ctx=None) -> None:
        """Exact add protocol; `ctx` (Topology.cohort_context) optionally
        amortizes group-membership scans across identically-shaped pods —
        it never changes the outcome, only skips recomputing cohort-constant
        membership."""
        err = self.taints.tolerates(pod)
        if err is not None:
            raise IncompatibleError(err)
        err = self.host_port_usage.validate(pod)
        if err is not None:
            raise IncompatibleError(err)

        mounted = self.volume_usage.validate(pod)
        if mounted.exceeds(self.volume_limits):
            raise IncompatibleError("would exceed node volume limits")

        requests = res.merge(self.requests, res.pod_requests(pod))
        if not res.fits(requests, self.available):
            raise IncompatibleError("exceeds node resources")

        node_requirements = Requirements(*self.requirements.values())
        pod_requirements = Requirements.from_pod(pod)
        err = node_requirements.compatible(pod_requirements)
        if err is not None:
            raise IncompatibleError(err)
        node_requirements.add(*pod_requirements.values())

        topology_requirements = self.topology.add_requirements(pod_requirements, node_requirements, pod, ctx=ctx)
        err = node_requirements.compatible(topology_requirements)
        if err is not None:
            raise IncompatibleError(err)
        node_requirements.add(*topology_requirements.values())

        # commit
        self.pods.append(pod)
        self.requests = requests
        if not node_requirements.same_as(self.requirements):
            self.req_epoch += 1
        self.requirements = node_requirements
        self.topology.record(pod, node_requirements, ctx=ctx)
        self.host_port_usage.add(pod)
        self.volume_usage.add(pod)

    def add_cohort(self, pods, ctx=None) -> int:
        """Add a run of identically-constrained pods (one dense-fill size
        class of one bucket) in a single protocol pass; returns the number
        committed — always a prefix of `pods`.

        The first pod runs the full add() protocol; for the rest, every
        pod-invariant check is provably identical and skipped:

        - taints / requirement compatibility / topology tightening depend
          only on the cohort's shared constraint signature (ir/encode.py
          groups by signature), and re-adding identical requirements is
          idempotent;
        - affinity pins are fixed once the domain is populated (by the
          first pod on this very node), and inverse anti-affinity counts
          only move when an *owner* lands, which cannot happen mid-cohort
          (anti-affinity carriers route to dedicated buckets);
        - the ONE genuinely per-pod topology condition is the spread
          min-count skew rule (topologygroup.go:157-184). For a node
          pinned to a single domain per spread key (every existing node),
          that rule is integer arithmetic — TopologyGroup.admits_pinned,
          the same computation _next_domain_spread runs — so owned spread
          groups are re-checked per pod without rebuilding requirement
          objects. Shapes outside this certificate (hostname-keyed owned
          groups, owned anti-affinity, multi-valued node domains) fall
          back to the full per-pod add().

        Per pod, only the genuinely per-pod state advances: host-port and
        volume validation (identical pods CAN conflict on both), exact
        resource fit, spread skew, and topology counts. Runs with no host
        ports and no volumes additionally collapse the capacity loop into
        a closed form with the same fits() tolerance.
        """
        if not pods:
            return 0
        if ctx is None:
            ctx = self.topology.cohort_context(pods[0])
        try:
            self.add(pods[0], ctx=ctx)
        except IncompatibleError:
            return 0
        if len(pods) == 1:
            return 1
        cert = self.certify(pods[0], ctx)
        if cert is None:
            committed = 1
            for pod in pods[1:]:
                try:
                    self.add(pod, ctx=ctx)
                except IncompatibleError:
                    break
                committed += 1
            return committed
        return 1 + self.add_certified_run(pods[1:], cert)

    @staticmethod
    def certify_bucket(representative: Pod, ctx) -> Optional[BucketCert]:
        """Certificate for a whole cohort, valid on ANY view: requires a
        representative with no node requirements (nodeSelector / node
        affinity would need per-view requirement algebra) and owned groups
        limited to spread, anti-affinity, and self-affinity. For those
        shapes the full add() on a view decides by (a) taints, (b) ports /
        volumes / capacity, and (c) the pinned fast paths of
        topologygroup.get — zero-count for anti-affinity, the min-count
        skew integers for spread (hostname min is 0, so dedicated cohorts
        are the hostname special case), populated-domain membership for
        affinity — and every topology tightening collapses to the view's
        existing label pins, so requirement content never changes.

        Affinity bootstrap (no domain populated anywhere) is NOT certified:
        add_certified_view returns False there, and the caller's fallback
        full add makes the bootstrap choice exactly once."""
        from .topologygroup import TopologyType

        pod_reqs = Requirements.from_pod(representative)
        if list(pod_reqs.values()):
            return None
        anti: list = []
        spreads: list = []
        affinity: list = []
        for g in ctx.owned:
            if g.type == TopologyType.POD_ANTI_AFFINITY:
                anti.append(g)
            elif g.type == TopologyType.SPREAD:
                spreads.append((g, Requirement(g.key, OP_EXISTS), g.selects(representative)))
            elif g.type == TopologyType.POD_AFFINITY:
                affinity.append(g)
            else:
                return None
        inverse: list = []
        for g in ctx.inverse_selected:
            inverse.append(g)
        spec = representative.spec
        cert = BucketCert()
        cert.anti_groups = anti
        cert.spread_checks = spreads
        cert.affinity_groups = affinity
        cert.inverse_groups = inverse
        cert.ctx = ctx
        cert.portless = not any(p.host_port for c in spec.containers for p in c.ports) and not spec.volumes
        cert.matching_by_view = {}
        return cert

    def _cert_matching(self, cert: BucketCert):
        """The counting-group set for this cohort on this view — run-constant
        (certified shapes never change requirement content), so computed
        once per (cert, view) instead of per pod."""
        matching = cert.matching_by_view.get(id(self))
        if matching is None:
            matching = cert.ctx.matching_for(self.requirements)
            cert.matching_by_view[id(self)] = matching
        return matching

    def _view_domain(self, key: str) -> Optional[str]:
        if key == lbl.LABEL_HOSTNAME:
            return self.node.metadata.labels.get(lbl.LABEL_HOSTNAME) or self.node.name
        return self.node.metadata.labels.get(key)

    def add_certified_view(self, pod: Pod, cert: BucketCert) -> bool:
        """Exact add for one certified-cohort pod on this view; False on any
        veto (the same verdict the full protocol reaches for certified
        shapes — except affinity bootstrap, which is deliberately
        uncertified and must go through the full add)."""
        if self.taints.tolerates(pod) is not None:
            return False
        if self.host_port_usage.validate(pod) is not None:
            return False
        if self.volume_usage.validate(pod).exceeds(self.volume_limits):
            return False
        requests = res.merge(self.requests, res.pod_requests(pod))
        if not res.fits(requests, self.available):
            return False
        for g in cert.anti_groups:
            domain = self._view_domain(g.key)
            if domain is None or domain not in g._zero_domains:
                return False
        for g, pod_domains, self_sel in cert.spread_checks:
            domain = self._view_domain(g.key)
            if domain is None or not g.admits_pinned(domain, pod_domains, self_sel):
                return False
        for g in cert.affinity_groups:
            domain = self._view_domain(g.key)
            if domain is None or g.domains.get(domain, 0) <= 0:
                return False  # unpopulated domain (incl. bootstrap): full add decides
        for g in cert.inverse_groups:
            domain = self._view_domain(g.key)
            if domain is None or domain not in g._zero_domains:
                return False
        self.pods.append(pod)
        self.requests = requests
        self.host_port_usage.add(pod)
        self.volume_usage.add(pod)
        self.topology.record_cohort(
            [pod], self.requirements, matching=self._cert_matching(cert), inverse_index=cert.ctx.inverse_index
        )
        return True

    def add_certified_view_run(self, pods, cert: BucketCert) -> int:
        """Commit a certified-cohort run on this view; returns how many
        landed (a prefix). Capacity-only cohorts (no owned/inverse group
        checks, no ports/volumes) collapse to one taints check plus the
        closed-form count under the same fits() tolerance; everything else
        runs add_certified_view per pod."""
        if (
            cert.anti_groups
            or cert.spread_checks
            or cert.affinity_groups
            or cert.inverse_groups
            or not cert.portless
        ):
            n = 0
            for pod in pods:
                if not self.add_certified_view(pod, cert):
                    break
                n += 1
            return n
        if self.taints.tolerates(pods[0]) is not None:
            return 0
        # the per-pod protocol's fits() covers EVERY key of the merged map —
        # including a pre-existing over-commitment on a resource this cohort
        # never requests — so the closed form must verify the base state
        # before per-size arithmetic (which only sees the cohort's own keys)
        if not res.fits(self.requests, self.available):
            return 0
        size = res.pod_requests(pods[0])
        if not all(res.pod_requests(p) == size for p in pods[1:]):
            n = 0
            for pod in pods:
                if not self.add_certified_view(pod, cert):
                    break
                n += 1
            return n
        n = len(pods)
        for name, value in size.items():
            if value <= 0:
                continue
            limit = self.available.get(name, 0.0)
            base = self.requests.get(name, 0.0)
            n = min(n, int((limit + res.tolerance(limit) - base) // value))
        if n <= 0:
            return 0
        placed = list(pods[:n])
        self.pods.extend(placed)
        self.requests = res.merge(self.requests, {name: value * n for name, value in size.items()})
        matching = self._cert_matching(cert)
        self.topology.record_cohort(placed, self.requirements, matching=matching, inverse_index=cert.ctx.inverse_index)
        return n

    def certify(self, representative: Pod, ctx) -> Optional["CohortCert"]:
        """Build the cheap-path certificate for a cohort whose identically-
        constrained representative was JUST admitted by a full add() on this
        view. Valid while this view's requirement content is unchanged
        (req_epoch — callers must check `cert.epoch == view.req_epoch`
        before reuse). None when the cohort shape can't certify: hostname-
        keyed owned groups and owned anti-affinity need the full per-pod
        protocol; zone/ct spread reduces to admits_pinned integers and
        affinity never vetoes a same-node sibling once pod 0 populated the
        domain."""
        from .topologygroup import TopologyType

        requirements = self.requirements
        spread_checks = []
        for g in ctx.owned:
            if g.key == lbl.LABEL_HOSTNAME:
                return None
            if g.type == TopologyType.SPREAD:
                node_req = requirements.get(g.key) if requirements.has(g.key) else None
                if node_req is None or node_req.complement or len(node_req.values) != 1:
                    return None
                domain = next(iter(node_req.values))
                pod_reqs = Requirements.from_pod(representative)
                pod_domains = pod_reqs.get(g.key) if pod_reqs.has(g.key) else Requirement(g.key, OP_EXISTS)
                spread_checks.append((g, domain, pod_domains, g.selects(representative)))
            elif g.type != TopologyType.POD_AFFINITY:
                return None
        spec = representative.spec
        portless = not any(p.host_port for c in spec.containers for p in c.ports) and not spec.volumes
        cert = CohortCert()
        cert.epoch = self.req_epoch
        cert.requirements = requirements
        cert.matching = ctx.matching_for(requirements)
        cert.inverse_index = ctx.inverse_index
        cert.spread_checks = spread_checks
        cert.portless = portless
        return cert

    def add_certified_run(self, pods, cert: "CohortCert") -> int:
        """Commit a run of pods identically-constrained to a certificate's
        representative; returns how many landed (a prefix). Only the
        genuinely per-pod protocol remains: host-port and volume validation,
        exact resource fit, the pinned-domain spread skew integers, and
        topology counts. Uniform portless runs with no spread checks
        collapse the capacity loop into a closed form under the same fits()
        tolerance. The caller guarantees cert validity
        (cert.epoch == view.req_epoch)."""
        requirements = cert.requirements
        matching = cert.matching
        inverse_index = cert.inverse_index
        if cert.spread_checks:
            # spread cohort: per-pod skew integers + per-pod recording (the
            # counts the next pod's check reads must be live)
            committed = 0
            for pod in pods:
                if self.host_port_usage.validate(pod) is not None:
                    break
                if self.volume_usage.validate(pod).exceeds(self.volume_limits):
                    break
                requests = res.merge(self.requests, res.pod_requests(pod))
                if not res.fits(requests, self.available):
                    break
                if not all(g.admits_pinned(d, pd, sel) for g, d, pd, sel in cert.spread_checks):
                    break
                self.pods.append(pod)
                self.requests = requests
                self.host_port_usage.add(pod)
                self.volume_usage.add(pod)
                self.topology.record_cohort([pod], requirements, matching=matching, inverse_index=inverse_index)
                committed += 1
            return committed

        size = res.pod_requests(pods[0])
        if cert.portless and all(res.pod_requests(p) == size for p in pods[1:]):
            # uniform capacity-only run: closed-form max count under the
            # same fits() tolerance the per-pod loop applies
            n = len(pods)
            for name, value in size.items():
                if value <= 0:
                    continue
                limit = self.available.get(name, 0.0)
                base = self.requests.get(name, 0.0)
                n = min(n, int((limit + res.tolerance(limit) - base) // value))
            if n <= 0:
                return 0
            placed = list(pods[:n])
            self.pods.extend(placed)
            self.requests = res.merge(self.requests, {name: value * n for name, value in size.items()})
            self.topology.record_cohort(placed, requirements, matching=matching, inverse_index=inverse_index)
            return n

        placed = []
        for pod in pods:
            if self.host_port_usage.validate(pod) is not None:
                break
            if self.volume_usage.validate(pod).exceeds(self.volume_limits):
                break
            requests = res.merge(self.requests, res.pod_requests(pod))
            if not res.fits(requests, self.available):
                break
            self.pods.append(pod)
            self.requests = requests
            self.host_port_usage.add(pod)
            self.volume_usage.add(pod)
            placed.append(pod)
        if placed:
            self.topology.record_cohort(placed, requirements, matching=matching, inverse_index=inverse_index)
        return len(placed)
