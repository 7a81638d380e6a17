"""Wire format for the solver service.

The packer plugin boundary of SURVEY.md §7.3 (BASELINE: "a C++/Python gRPC
sidecar hosting the JAX solver; the host control plane calls it behind the
packer plugin boundary — same seam as CloudProvider/SchedulerOptions").

The request carries everything one Scheduler.solve needs — provisioners,
per-provisioner instance-type universes, pods, daemonset pod templates,
existing-node snapshots, and the volume object graph (PVC/PV/StorageClass/
CSINode) so the server-side VolumeLimits resolves drivers with full
fidelity. The response is a launch plan: per new node the provisioner, the
surviving instance-type names (price order), and the pod uids; plus
existing-node placements and unschedulable reasons.

Transport serialization is pickle: the sidecar is a same-trust-domain
process (the reference's packer runs in-process; this is the out-of-process
equivalent), NOT an external API — do not expose the port beyond the pod
boundary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..api.objects import Node, Pod


@dataclass
class WireStateNode:
    """A cluster-state node snapshot: the minimal StateNode surface
    ExistingNodeView consumes (scheduler/existingnode.py), detached from the
    live Cluster object graph."""

    node: Node
    available: Dict[str, float]
    daemonset_requested: Dict[str, float] = field(default_factory=dict)
    # HostPortUsage internal entries: pod uid -> [(ip, port, protocol)]
    host_ports: Dict[str, List[tuple]] = field(default_factory=dict)
    # VolumeLimits internal state: driver -> mounted volume ids, per pod
    volumes: Dict[str, List[str]] = field(default_factory=dict)
    pod_volumes: Dict[str, Dict[str, List[str]]] = field(default_factory=dict)
    # CSINode-derived mount limits: driver -> count
    volume_limits: Dict[str, int] = field(default_factory=dict)


@dataclass
class SolveRequest:
    provisioners: List[object]
    instance_types: Dict[str, List[object]]  # provisioner name -> universe
    pods: List[Pod]
    daemonset_pods: List[Pod] = field(default_factory=list)
    state_nodes: List[WireStateNode] = field(default_factory=list)
    # bound cluster pods + their nodes: topology domain counting and
    # inverse anti-affinity need them (scheduler/topology.py _count_domains)
    cluster_pods: List[Pod] = field(default_factory=list)
    cluster_nodes: List[Node] = field(default_factory=list)
    # the volume object graph for server-side PVC->driver resolution
    pvcs: List[object] = field(default_factory=list)
    pvs: List[object] = field(default_factory=list)
    storage_classes: List[object] = field(default_factory=list)
    csi_nodes: List[object] = field(default_factory=list)
    simulation_mode: bool = False
    exclude_nodes: List[str] = field(default_factory=list)


@dataclass
class WireNewNode:
    provisioner_name: str
    instance_type_names: List[str]  # surviving options, price order
    pod_uids: List[str]
    requests: Dict[str, float]
    # the scheduler's TIGHTENED requirements (zone/capacity-type/label pins
    # from placement decisions) — the launch must honor these, not the bare
    # provisioner template
    requirements: object = None


@dataclass
class SolveResponse:
    new_nodes: List[WireNewNode]
    existing_placements: Dict[str, List[str]]  # node name -> pod uids
    unschedulable: Dict[str, str]  # pod uid -> reason
    error: Optional[str] = None


SERVICE_NAME = "karpenter_tpu.Solver"
METHOD_SCHEDULE = "Schedule"
METHOD_HEALTH = "Health"
# gRPC refuses a received message over 4 MiB by default; a request for a
# batch of 10,000 pods onto 300 nodes pickles to about 6.8 MB. Both ends of
# the channel take messages up to 64 MiB, nine times that request, and
# refuse a larger one before buffering it.
MAX_MESSAGE_BYTES = 64 * 1024 * 1024
CHANNEL_OPTIONS = (
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
)
