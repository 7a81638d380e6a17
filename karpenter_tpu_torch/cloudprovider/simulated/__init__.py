from .api import CloudAPIService
from .apiclient import AuthError, CloudAPIClient, CloudAPIError
from .backend import CloudBackend, FleetRequest, InstanceTypeInfo
from .provider import NodeClass, SimulatedCloudProvider

__all__ = [
    "AuthError",
    "CloudAPIClient",
    "CloudAPIError",
    "CloudAPIService",
    "CloudBackend",
    "FleetRequest",
    "InstanceTypeInfo",
    "NodeClass",
    "SimulatedCloudProvider",
]
