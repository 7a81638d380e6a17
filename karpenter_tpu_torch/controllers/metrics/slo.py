"""SLO cost scraper: live cluster $/hr + drift against an ideal fresh repack.

The scrape half of the SLO layer (slo.py holds the watch-driven latency
half): each pass prices every provisioned node at current offering prices
into `karpenter_slo_cluster_cost_per_hour`, and — only when cluster state
actually changed since the last computation (the consolidation epoch) —
re-solves the currently bound workload onto empty state in simulation mode
to refresh `karpenter_slo_ideal_cost_per_hour` and the
`karpenter_slo_cost_drift_ratio` gauge.

The drift ratio is the campaign's cost score: 1.0 means the live cluster
costs exactly what a fresh repack of the same pods would; creep above 1.0
after an interruption wave or a drift rollout is capacity the disruption
pipeline failed to consolidate away.

The port's copy of karpenter_tpu/controllers/metrics/slo.py. The ideal
repack is a cold dense solve through K1 on the card. Neither of the
reference's two guards is kept (ROADMAP C, no fail-open around the card): a
scrape that raises, the ideal solve's included, propagates out of
`scrape()`, so the Runtime's metrics loop ends and `healthy()` turns false.
An ideal solve that leaves pods unplaced is not an exception: the gauges
stay unchanged and the epoch is retried, as in the reference. Nor is an
ideal solve a solver fault held (solver/faults.py: a `SolverFault`, an
open breaker's included): the gauges stay unchanged and the next scrape
retries on the card; a device-lost the card raised still ends the loop
(faults.ends_the_loop).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

from ... import slo
from ...api import labels as lbl
from ...logsetup import get_logger
from ...solver.faults import SolverFault, ends_the_loop
from ...utils import pod as podutils

log = get_logger("slo")


def ideal_node_price(virtual_node) -> float:
    """Cheapest hourly price a proposed node could actually launch at: the
    minimum over its surviving instance-type options of the offerings its
    TEMPLATE requirements allow. Using each type's global-cheapest offering
    instead (it.price()) would price an on-demand-restricted provisioner at
    spot rates and report permanent fake drift no consolidation can remove."""
    from ...api import labels as lbl

    requirements = virtual_node.template.requirements
    ct_req = requirements.get(lbl.LABEL_CAPACITY_TYPE)
    zone_req = requirements.get(lbl.LABEL_TOPOLOGY_ZONE)
    best = None
    for it in virtual_node.instance_type_options:
        restricted = [
            o
            for o in it.offerings()
            if o.price is not None and ct_req.has(o.capacity_type) and zone_req.has(o.zone)
        ]
        # only AVAILABLE offerings price the ideal: a quarantined pool is
        # not launchable, and pricing it would report fake drift no
        # consolidation can remove while the crunch lasts. When EVERY
        # restriction-matching offering is quarantined, fall back to the
        # restricted set ignoring availability — the template's capacity
        # type still bounds the price (a spot-priced ideal for an
        # on-demand-only provisioner would be the same fake-drift failure).
        allowed = [o.price for o in restricted if o.available]
        if not allowed:
            allowed = [o.price for o in restricted]
        # offerings without explicit prices (the fake provider) fall back to
        # the type's headline price
        price = min(allowed) if allowed else it.price()
        if best is None or price < best:
            best = price
    return best or 0.0


def node_hourly_price(node, type_index: Dict[str, object]) -> float:
    """Price one node at current offerings: the (capacity-type, zone) match
    wins (spot markets price per pool), the type's headline price is the
    fallback, and an unknown type prices at 0 rather than poisoning the sum."""
    it = type_index.get(node.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE, ""))
    if it is None:
        return 0.0
    capacity_type = node.metadata.labels.get(lbl.LABEL_CAPACITY_TYPE, "")
    zone = node.metadata.labels.get(lbl.LABEL_TOPOLOGY_ZONE, "")
    for offering in it.offerings():
        if offering.capacity_type == capacity_type and offering.zone == zone and offering.price is not None:
            return offering.price
    return it.price()


class SLOScraper:
    """Feeds the cost gauges from cluster state; epoch-gates the repack."""

    def __init__(self, kube, cluster, cloud_provider, provisioner_controller=None, accountant=None):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.provisioner_controller = provisioner_controller
        self.accountant = accountant or slo.SLO
        self._drift_epoch = -1

    def _type_index(self) -> Dict[str, object]:
        index: Dict[str, object] = {}
        for provisioner in self.kube.list_provisioners():
            for it in self.cloud_provider.get_instance_types(provisioner):
                index.setdefault(it.name(), it)
        return index

    def scrape(self) -> None:
        if not self.accountant.enabled:
            return
        # no guard: a failed scrape (a catalog fetch, the ideal solve on the
        # card) ends the metrics loop and turns the Runtime unhealthy; a
        # solver fault the ideal solve holds is compute_drift's
        self._scrape()

    def _scrape(self) -> None:
        index = self._type_index()
        total = 0.0

        def visit(state) -> bool:
            nonlocal total
            if state.owned():
                total += node_hourly_price(state.node, index)
            return True

        self.cluster.for_each_node(visit)
        slo.CLUSTER_COST.set(total)
        epoch = self.cluster.consolidation_epoch()
        if epoch != self._drift_epoch:
            # mark the epoch consumed only on success: a transiently failed
            # drift solve on a then-quiescent cluster would otherwise never
            # be retried, freezing the ratio at its pre-failure value
            if self.compute_drift(actual_cost=total) is not None:
                self._drift_epoch = epoch

    # -- the ideal fresh repack -------------------------------------------------

    def compute_drift(self, actual_cost: Optional[float] = None) -> Optional[float]:
        """Re-solve the bound workload onto EMPTY state (simulation mode: no
        decision records, no launches) and compare costs. Returns the ratio,
        or None when it cannot be computed (no pods, no controller, or the
        ideal solve left pods unplaced — a partial repack underprices the
        ideal and would report fake drift)."""
        if self.provisioner_controller is None:
            return None
        from ...scheduler import SchedulerOptions

        pods = []
        for pod in self.kube.list_pods():
            if not pod.spec.node_name or podutils.is_terminal(pod) or podutils.is_owned_by_daemonset(pod):
                continue
            ghost = copy.deepcopy(pod)
            ghost.spec.node_name = ""
            pods.append(ghost)
        if not pods:
            # no bound workload: the ideal is the empty cluster; report
            # neutral drift rather than divide by zero (leftover capacity is
            # the emptiness method's churn to report, not a cost ratio)
            slo.IDEAL_COST.set(0.0)
            slo.COST_DRIFT.set(1.0)
            return 1.0
        try:
            results = self.provisioner_controller.schedule(pods, state_nodes=[], opts=SchedulerOptions(simulation_mode=True))
        except SolverFault as fault:
            if ends_the_loop(fault):
                raise
            log.warning("ideal repack held by a %s fault; drift gauge unchanged, the next scrape retries: %s", fault.kind, fault)
            return None
        if results.unschedulable:
            log.warning(
                "ideal repack left %d pods unplaced; drift gauge unchanged", len(results.unschedulable)
            )
            return None
        ideal = sum(
            ideal_node_price(n) for n in results.new_nodes if n.pods and n.instance_type_options
        )
        slo.IDEAL_COST.set(ideal)
        if actual_cost is None:
            actual_cost = slo.CLUSTER_COST.value()
        if ideal <= 0:
            return None
        ratio = actual_cost / ideal
        slo.COST_DRIFT.set(ratio)
        return ratio
