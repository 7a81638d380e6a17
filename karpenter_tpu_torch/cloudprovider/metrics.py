"""Cloud-provider metrics decorator.

Mirrors pkg/cloudprovider/metrics/cloudprovider.go — wraps any CloudProvider
with per-method duration histograms (karpenter_cloudprovider_duration_seconds).
"""

from __future__ import annotations

from typing import List

from ..api.objects import Node
from ..api.provisioner import Provisioner
from ..metrics import REGISTRY, Registry
from .types import CloudProvider, InstanceType, NodeRequest


def decorate(provider: CloudProvider, registry: Registry = REGISTRY) -> CloudProvider:
    return MetricsCloudProvider(provider, registry)


class MetricsCloudProvider(CloudProvider):
    def __init__(self, inner: CloudProvider, registry: Registry = REGISTRY):
        self.inner = inner
        self.duration = registry.histogram(
            "karpenter_cloudprovider_duration_seconds",
            "Duration of cloud provider method calls",
            label_names=("controller", "method", "provider"),
        )

    def _timed(self, method: str):
        return self.duration.time(controller="cloudprovider", method=method, provider=self.inner.name())

    def create(self, node_request: NodeRequest) -> Node:
        with self._timed("Create"):
            return self.inner.create(node_request)

    def delete(self, node: Node) -> None:
        with self._timed("Delete"):
            return self.inner.delete(node)

    def get_instance_types(self, provisioner: Provisioner) -> List[InstanceType]:
        with self._timed("GetInstanceTypes"):
            return self.inner.get_instance_types(provisioner)

    def instance_exists(self, node: Node):
        # concrete on the base class, so __getattr__ never fires for it:
        # delegate explicitly or the inner provider's answer is lost
        with self._timed("InstanceExists"):
            return self.inner.instance_exists(node)

    def name(self) -> str:
        return self.inner.name()

    def __getattr__(self, item):
        return getattr(self.inner, item)
