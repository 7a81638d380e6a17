from .cluster import KubeCluster, WatchEvent

__all__ = ["KubeCluster", "WatchEvent"]
