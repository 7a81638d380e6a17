"""Node metrics scraper: per-node allocatable/requests/limits/overhead gauges.

Mirrors pkg/controllers/metrics/state/node.go:41-128 + scraper.go — scraped
from cluster state so in-flight nodes report immediately.
"""

from __future__ import annotations

from ...api import labels as lbl
from ...metrics import REGISTRY, Registry
from ...utils import resources as res
from ..state.cluster import Cluster


class NodeMetricsScraper:
    LABELS = ("node", "provisioner", "zone", "instance_type", "resource")

    def __init__(self, cluster: Cluster, registry: Registry = REGISTRY):
        self.cluster = cluster
        self.allocatable = registry.gauge("karpenter_nodes_allocatable", "Node allocatable", self.LABELS)
        self.requests = registry.gauge("karpenter_nodes_total_pod_requests", "Total pod requests per node", self.LABELS)
        self.limits = registry.gauge("karpenter_nodes_total_pod_limits", "Total pod limits per node", self.LABELS)
        self.daemon_requests = registry.gauge("karpenter_nodes_total_daemon_requests", "Daemonset requests per node", self.LABELS)
        self.overhead = registry.gauge("karpenter_nodes_system_overhead", "Capacity minus allocatable", self.LABELS)

    def scrape(self) -> None:
        for metric in (self.allocatable, self.requests, self.limits, self.daemon_requests, self.overhead):
            metric.clear()

        def visit(state) -> bool:
            labels = {
                "node": state.name,
                "provisioner": state.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, ""),
                "zone": state.node.metadata.labels.get(lbl.LABEL_TOPOLOGY_ZONE, ""),
                "instance_type": state.node.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE, ""),
            }
            total_requests = res.subtract(state.allocatable, state.available)
            total_limits: dict = {}
            for limits in state.pod_limits.values():
                total_limits = res.merge(total_limits, limits)
            system_overhead = res.subtract(state.capacity, state.allocatable)
            for gauge, values in (
                (self.allocatable, state.allocatable),
                (self.requests, total_requests),
                (self.limits, total_limits),
                (self.daemon_requests, state.daemonset_requested),
                (self.overhead, system_overhead),
            ):
                for resource, value in values.items():
                    gauge.set(value, resource=resource, **labels)
            return True

        self.cluster.for_each_node(visit)
