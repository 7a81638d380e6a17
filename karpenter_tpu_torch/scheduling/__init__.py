from .requirement import Requirement
from .requirements import Requirements
from .taints import Taints
from .nodetemplate import NodeTemplate
from .hostports import HostPortUsage
from .volumelimits import VolumeLimits, VolumeCount

__all__ = [
    "Requirement",
    "Requirements",
    "Taints",
    "NodeTemplate",
    "HostPortUsage",
    "VolumeLimits",
    "VolumeCount",
]
