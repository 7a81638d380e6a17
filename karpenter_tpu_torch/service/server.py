"""Solver service: the gRPC sidecar hosting the scheduler on the card.

SURVEY.md §7.3 — the solver runs in its own process (owning the GPU and the
kernels built for it) and the control plane calls it over gRPC behind the
packer boundary. One long-lived DenseSolver serves every request, so device
catalogs, kernel builds, and host-side catalog encodings stay warm across
batches exactly as they do in-process.

The server reconstructs a detached scheduling universe per request: an
in-memory kube holding the shipped volume object graph (full-fidelity
PVC→driver resolution), state-node views from the wire snapshots, and the
standard build_scheduler wiring. Solve output is flattened to the launch
plan (wire.SolveResponse); the control plane owns launching.

The port's copy of karpenter_tpu/service/server.py. `SolverServer` and
`serve` gain `device=` (default "cuda"), which reaches the default
DenseSolver(min_batch=1). `SolverServer.schedule_bytes` is the handler
`serve` registers: pickled request in, pickled response out.
"""

from __future__ import annotations

import pickle
import threading
from concurrent import futures
from typing import Optional

from ..logsetup import get_logger
from ..scheduler import SchedulerOptions, build_scheduler
from ..scheduling.hostports import HostPortUsage
from ..scheduling.volumelimits import VolumeCount, VolumeLimits
from ..solver import DenseSolver
from .wire import METHOD_HEALTH, METHOD_SCHEDULE, SERVICE_NAME, SolveRequest, SolveResponse, WireNewNode, WireStateNode

log = get_logger("service")


class _StateNodeView:
    """Rebuild the minimal StateNode surface from a wire snapshot."""

    def __init__(self, wire: WireStateNode, kube):
        self.node = wire.node
        self.available = dict(wire.available)
        self.daemonset_requested = dict(wire.daemonset_requested)
        self.host_port_usage = HostPortUsage.from_wire(wire.host_ports)
        self.volume_usage = VolumeLimits.from_wire((wire.volumes, wire.pod_volumes), kube)
        self.volume_limits = VolumeCount(dict(wire.volume_limits))


class _ClusterShim:
    """The one Cluster capability Topology consumes server-side: iterating
    bound pods that carry required anti-affinity (state/cluster.py)."""

    def __init__(self, kube):
        self.kube = kube

    def for_pods_with_anti_affinity(self, fn):
        from ..utils import pod as podutils

        for pod in self.kube.list_pods():
            if not pod.spec.node_name or podutils.is_terminal(pod):
                continue
            if not podutils.has_required_pod_anti_affinity(pod):
                continue
            if not fn(pod, self.kube.get_node(pod.spec.node_name)):
                return


class _Provider:
    """Serve the request's shipped instance-type universes as a
    CloudProvider."""

    def __init__(self, universes):
        self._universes = universes

    def get_instance_types(self, provisioner):
        return list(self._universes.get(provisioner.name, ()))


class SolverServer:
    """Request handler; transport-agnostic (serve() wires it into gRPC)."""

    def __init__(self, dense_solver: Optional[DenseSolver] = None, device="cuda"):
        self.dense_solver = dense_solver if dense_solver is not None else DenseSolver(min_batch=1, device=device)
        self._lock = threading.Lock()  # one solve at a time owns the device
        self.solves = 0

    def schedule_bytes(self, request_bytes: bytes) -> bytes:
        return pickle.dumps(self.schedule(pickle.loads(request_bytes)))

    def schedule(self, request: SolveRequest) -> SolveResponse:
        try:
            return self._schedule(request)
        except Exception as exc:  # noqa: BLE001 - the error crosses the wire
            log.exception("remote solve failed")
            return SolveResponse(new_nodes=[], existing_placements={}, unschedulable={}, error=repr(exc))

    def _schedule(self, request: SolveRequest) -> SolveResponse:
        from ..kube.cluster import KubeCluster

        kube = KubeCluster()
        for obj in [
            *request.cluster_nodes,
            *request.cluster_pods,
            *request.pvcs,
            *request.pvs,
            *request.storage_classes,
            *request.csi_nodes,
        ]:
            kube.create(obj)

        state_nodes = [_StateNodeView(w, kube) for w in request.state_nodes]
        opts = SchedulerOptions(simulation_mode=request.simulation_mode, exclude_nodes=list(request.exclude_nodes))
        with self._lock:
            self.solves += 1
            scheduler = build_scheduler(
                request.provisioners,
                _Provider(request.instance_types),
                request.pods,
                kube=kube,
                cluster=_ClusterShim(kube),
                state_nodes=state_nodes,
                daemonset_pods=request.daemonset_pods,
                opts=opts,
                dense_solver=self.dense_solver,
            )
            results = scheduler.solve(request.pods)

        new_nodes = [
            WireNewNode(
                provisioner_name=n.provisioner_name,
                instance_type_names=[it.name() for it in sorted(n.instance_type_options, key=lambda t: t.price())],
                pod_uids=[p.uid for p in n.pods],
                requests=dict(n.requests),
                # post-finalize (placeholder hostname stripped): the pins the
                # launch must honor
                requirements=n.template.requirements,
            )
            for n in results.new_nodes
            if n.pods
        ]
        existing = {v.node.name: [p.uid for p in v.pods] for v in results.existing_nodes if v.pods}
        unschedulable = {pod.uid: err for pod, err in results.unschedulable.items()}
        return SolveResponse(new_nodes=new_nodes, existing_placements=existing, unschedulable=unschedulable)


def serve(address: str = "127.0.0.1:0", dense_solver: Optional[DenseSolver] = None, max_workers: int = 4, device="cuda"):
    """Start the gRPC sidecar; returns (grpc server, bound port, handler).

    Pickle-over-gRPC: a same-trust-domain sidecar protocol (see wire.py) —
    bind to loopback / pod-local interfaces only.
    """
    import grpc

    handler = SolverServer(dense_solver, device=device)

    def _schedule(request_bytes, context):
        return handler.schedule_bytes(request_bytes)

    def _health(request_bytes, context):
        return pickle.dumps({"ok": True, "solves": handler.solves})

    generic = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            METHOD_SCHEDULE: grpc.unary_unary_rpc_method_handler(_schedule),
            METHOD_HEALTH: grpc.unary_unary_rpc_method_handler(_health),
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((generic,))
    port = server.add_insecure_port(address)
    if port == 0:
        raise RuntimeError(f"solver service could not bind {address!r}")
    server.start()
    log.info("solver service listening on port %d", port)
    return server, port, handler
