"""Provisioner metrics: limit / usage / usage-percent gauges.

Mirrors pkg/controllers/metrics/provisioner/controller.go:46-78.
"""

from __future__ import annotations

from ...kube.cluster import KubeCluster
from ...metrics import REGISTRY, Registry


class ProvisionerMetricsController:
    def __init__(self, kube: KubeCluster, registry: Registry = REGISTRY):
        self.kube = kube
        self.limit = registry.gauge("karpenter_provisioner_limit", "Provisioner resource limits", ("provisioner", "resource"))
        self.usage = registry.gauge("karpenter_provisioner_usage", "Provisioned resources per provisioner", ("provisioner", "resource"))
        self.usage_pct = registry.gauge("karpenter_provisioner_usage_pct", "Usage as a fraction of the limit", ("provisioner", "resource"))

    def scrape(self) -> None:
        for metric in (self.limit, self.usage, self.usage_pct):
            metric.clear()
        for provisioner in self.kube.list_provisioners():
            usage = provisioner.status.resources or {}
            for resource, value in usage.items():
                self.usage.set(value, provisioner=provisioner.name, resource=resource)
            if provisioner.spec.limits is not None:
                for resource, limit in provisioner.spec.limits.resources.items():
                    self.limit.set(limit, provisioner=provisioner.name, resource=resource)
                    if limit > 0:
                        self.usage_pct.set(usage.get(resource, 0.0) / limit, provisioner=provisioner.name, resource=resource)
