"""Solver-service client: the control plane's side of the packer boundary.

SolverClient turns the local scheduling inputs into a wire request, calls
the sidecar, and maps the launch plan back onto live objects
(LaunchableNode/LaunchableView quack like VirtualNode/ExistingNodeView for
everything ProvisionerController.launch_nodes consumes).

The port's copy of karpenter_tpu/service/client.py. Building the request
(`build_request`) and mapping the response back (`materialize`) are module
functions that `SolverClient.solve` calls, so they run without a channel.
One deliberate difference: the reference's caller falls back to the local
scheduler on a RemoteSchedulingError; the port's lets it out of the round,
as a failure on the card would (ROADMAP C). `nominated` (node name, pods)
pairs, the pods a round placed before its capacity-failure re-solve, ship
as cluster pods bound to their nodes, so the sidecar counts them in the
topology domains as the local re-solve does. The channel takes messages up
to wire.MAX_MESSAGE_BYTES (the reference keeps gRPC's 4 MiB default).
"""

from __future__ import annotations

import copy
import dataclasses
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from ..logsetup import get_logger
from ..scheduler.scheduler import SchedulingResults
from ..scheduling.nodetemplate import NodeTemplate
from .wire import CHANNEL_OPTIONS, METHOD_HEALTH, METHOD_SCHEDULE, SERVICE_NAME, SolveRequest, SolveResponse, WireStateNode

log = get_logger("service")


class RemoteSchedulingError(RuntimeError):
    pass


@dataclass
class LaunchableNode:
    """The VirtualNode surface launch_nodes + consolidation consume."""

    template: NodeTemplate
    instance_type_options: List[object]
    pods: List[object]
    requests: Dict[str, float] = field(default_factory=dict)

    @property
    def provisioner_name(self) -> str:
        return self.template.provisioner_name

    @property
    def requirements(self):
        return self.template.requirements


@dataclass
class LaunchableView:
    """The ExistingNodeView surface launch_nodes consumes."""

    node: object
    pods: List[object]


def snapshot_state_node(state) -> WireStateNode:
    """Detach a cluster StateNode into its wire form."""
    volumes, pod_volumes = state.volume_usage.to_wire()
    return WireStateNode(
        node=state.node,
        available=dict(state.available),
        daemonset_requested=dict(state.daemonset_requested),
        host_ports=state.host_port_usage.to_wire(),
        volumes=volumes,
        pod_volumes=pod_volumes,
        volume_limits=dict(state.volume_limits),  # VolumeCount is a dict subclass
    )


def _bound_copy(pod, node_name: str):
    bound = copy.deepcopy(pod)
    bound.spec.node_name = node_name
    return bound


def build_request(
    provisioners: Sequence[object],
    instance_types: Dict[str, List[object]],
    pods: Sequence[object],
    daemonset_pods: Sequence[object] = (),
    state_nodes: Sequence[object] = (),
    kube=None,
    simulation_mode: bool = False,
    exclude_nodes: Sequence[str] = (),
    nominated: Sequence[tuple] = (),
) -> SolveRequest:
    """The wire request of one solve: everything Scheduler.solve needs,
    detached from the live cluster."""
    cluster_pods = [p for p in kube.list_pods() if p.spec.node_name] if kube is not None else []
    cluster_pods += [_bound_copy(pod, name) for name, placed in nominated for pod in placed]
    return SolveRequest(
        provisioners=list(provisioners),
        instance_types={name: list(universe) for name, universe in instance_types.items()},
        pods=list(pods),
        daemonset_pods=list(daemonset_pods),
        state_nodes=[snapshot_state_node(s) for s in state_nodes],
        cluster_pods=cluster_pods,
        cluster_nodes=list(kube.list_nodes()) if kube is not None else [],
        pvcs=list(kube.list("PersistentVolumeClaim")) if kube is not None else [],
        pvs=list(kube.list("PersistentVolume")) if kube is not None else [],
        storage_classes=list(kube.list("StorageClass")) if kube is not None else [],
        csi_nodes=list(kube.list("CSINode")) if kube is not None else [],
        simulation_mode=simulation_mode,
        exclude_nodes=list(exclude_nodes),
    )


def materialize(response: SolveResponse, provisioners, instance_types, pods, state_nodes) -> SchedulingResults:
    """Map a launch plan back onto the request's live objects; raises
    RemoteSchedulingError for a failed solve or a plan naming objects the
    request did not carry."""
    if response.error:
        raise RemoteSchedulingError(f"remote solve failed: {response.error}")
    pods_by_uid = {p.uid: p for p in pods}
    templates = {p.name: NodeTemplate.from_provisioner(p) for p in provisioners}
    types_by_name = {
        p.name: {it.name(): it for it in instance_types.get(p.name, ())} for p in provisioners
    }
    nodes_by_name = {s.node.name: s.node for s in state_nodes}

    new_nodes: List[LaunchableNode] = []
    for wire_node in response.new_nodes:
        template = templates.get(wire_node.provisioner_name)
        universe = types_by_name.get(wire_node.provisioner_name, {})
        options = [universe[name] for name in wire_node.instance_type_names if name in universe]
        node_pods = [pods_by_uid[uid] for uid in wire_node.pod_uids if uid in pods_by_uid]
        if template is None or not options or len(node_pods) != len(wire_node.pod_uids):
            raise RemoteSchedulingError(
                f"launch plan references unknown objects (provisioner {wire_node.provisioner_name!r})"
            )
        if wire_node.requirements is not None:
            # honor the scheduler's tightened pins, not the bare template
            template = dataclasses.replace(template, requirements=wire_node.requirements)
        new_nodes.append(
            LaunchableNode(template=template, instance_type_options=options, pods=node_pods, requests=dict(wire_node.requests))
        )
    existing = []
    for node_name, uids in response.existing_placements.items():
        node = nodes_by_name.get(node_name)
        if node is None:
            raise RemoteSchedulingError(f"launch plan references unknown node {node_name!r}")
        existing.append(LaunchableView(node=node, pods=[pods_by_uid[u] for u in uids if u in pods_by_uid]))
    unschedulable = {pods_by_uid[uid]: reason for uid, reason in response.unschedulable.items() if uid in pods_by_uid}
    return SchedulingResults(new_nodes=new_nodes, existing_nodes=existing, unschedulable=unschedulable)


class SolverClient:
    def __init__(self, address: str, timeout: float = 10.0):
        import grpc

        self.address = address
        self.timeout = timeout
        self._channel = grpc.insecure_channel(address, options=CHANNEL_OPTIONS)
        self._schedule = self._channel.unary_unary(
            f"/{SERVICE_NAME}/{METHOD_SCHEDULE}",
            request_serializer=pickle.dumps,
            response_deserializer=pickle.loads,
        )
        self._health = self._channel.unary_unary(
            f"/{SERVICE_NAME}/{METHOD_HEALTH}",
            request_serializer=pickle.dumps,
            response_deserializer=pickle.loads,
        )

    def health(self) -> dict:
        return self._health(b"", timeout=self.timeout)

    def close(self) -> None:
        self._channel.close()

    def solve(
        self,
        provisioners: Sequence[object],
        instance_types: Dict[str, List[object]],
        pods: Sequence[object],
        daemonset_pods: Sequence[object] = (),
        state_nodes: Sequence[object] = (),
        kube=None,
        simulation_mode: bool = False,
        exclude_nodes: Sequence[str] = (),
        nominated: Sequence[tuple] = (),
    ) -> SchedulingResults:
        """One remote solve; raises RemoteSchedulingError on transport or
        server failure."""
        request = build_request(
            provisioners, instance_types, pods, daemonset_pods, state_nodes, kube,
            simulation_mode, exclude_nodes, nominated,
        )
        try:
            response: SolveResponse = self._schedule(request, timeout=self.timeout)
        except Exception as exc:  # noqa: BLE001 - every transport error becomes one typed error
            raise RemoteSchedulingError(f"solver service unreachable: {exc}") from exc
        return materialize(response, provisioners, instance_types, pods, state_nodes)
