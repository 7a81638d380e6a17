from .cluster import Cluster, StateNode

__all__ = ["Cluster", "StateNode"]
