from .types import CloudProvider, InstanceType, Offering, NodeRequest

__all__ = ["CloudProvider", "InstanceType", "Offering", "NodeRequest"]
