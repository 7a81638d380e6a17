from .pod import PodMetricsController
from .provisioner import ProvisionerMetricsController
from .node import NodeMetricsScraper

__all__ = ["PodMetricsController", "ProvisionerMetricsController", "NodeMetricsScraper"]
