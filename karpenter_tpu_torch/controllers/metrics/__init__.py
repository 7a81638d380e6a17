from .pod import PodMetricsController
from .provisioner import ProvisionerMetricsController
from .node import NodeMetricsScraper
from .slo import SLOScraper

__all__ = ["PodMetricsController", "ProvisionerMetricsController", "NodeMetricsScraper", "SLOScraper"]
