from .backend import CloudBackend, FleetRequest, InstanceTypeInfo
from .provider import NodeClass, SimulatedCloudProvider

__all__ = [
    "CloudBackend",
    "FleetRequest",
    "InstanceTypeInfo",
    "NodeClass",
    "SimulatedCloudProvider",
]
