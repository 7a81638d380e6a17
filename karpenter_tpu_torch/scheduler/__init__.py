from .builder import build_scheduler, compute_domains, daemonset_overhead
from .errors import IncompatibleError, UnsatisfiableTopologyError
from .existingnode import ExistingNodeView
from .node import VirtualNode, filter_instance_types
from .preferences import Preferences
from .queue import Queue
from .scheduler import Scheduler, SchedulerOptions, SchedulingResults
from .topology import Topology
from .topologygroup import TopologyGroup, TopologyType

__all__ = [
    "build_scheduler",
    "compute_domains",
    "daemonset_overhead",
    "IncompatibleError",
    "UnsatisfiableTopologyError",
    "ExistingNodeView",
    "VirtualNode",
    "filter_instance_types",
    "Preferences",
    "Queue",
    "Scheduler",
    "SchedulerOptions",
    "SchedulingResults",
    "Topology",
    "TopologyGroup",
    "TopologyType",
]
