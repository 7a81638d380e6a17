"""Multi-process peer execution: every process takes part in each solve.

The port's copy of karpenter_tpu/parallel/peers.py, on `torch.distributed`.
The solver runs on process 0 (the coordinator, where the control plane
lives); peer processes cannot see its Python control flow, so the fabric
gives them a broadcast protocol to follow it:

  1. peers block in a fixed-shape header broadcast (`dist.broadcast` from
     rank 0, which doubles as the participation barrier);
  2. the coordinator publishes [opcode, Bp, R, Tp, seq, has_catalog, 0, 0]
     (int32 [8]) when a solve arrives;
  3. a second broadcast carries one flat float32 payload whose size the
     header fixed (bucket stats ++ allowed, then caps ++ prices when the
     header announces a new catalog epoch);
  4. every process launches K1 on the mesh blocks it owns
     (parallel/sharded.py), one `dist.all_gather` brings every block's
     packed result to every process, and each combines them over the types
     axis: the result is replicated;
  5. the coordinator returns it to the solver, peers loop back to 1
     (where a keep-alive header, [OP_KEEPALIVE, 0, ...], is counted and
     skipped).

The gathered tensor leads with a status word per process: a process whose
blocks failed (a launch error, a fault at the "cuda" seam, a failed wait)
still enters the gather with its status set, so no process is left alone in
a collective, and every process raises there. A failure of the
coordinator's alone leaves the fleet in lockstep: the coordinator raises
its fault and the peers go back to the header barrier. A peer's failure is
fatal to that peer (serve() raises), and the other processes end with it:
the coordinator raises SolverDeviceLostError, for this solve and every
later one, and sends no more broadcasts.

The collectives ride the backend's device: host tensors for gloo, the
process's card for nccl. OP_SHUTDOWN releases the peers. With one process
the fabric is inert and dispatch is the local sharded call.

An idle fleet stays alive: a peer waits in the header broadcast between
solves, and that wait fails once the process group's collective timeout
has passed (parallel/multihost.py group_timeout). So the coordinator sends
a keep-alive header (OP_KEEPALIVE), which peers count and otherwise
ignore, whenever no broadcast has gone out for a quarter of that timeout,
from a thread of its own, never while a solve is between its broadcasts
and its gather. A keep-alive rather than a longer timeout: a deployment
cannot name an idle period long enough, and a dead peer must still fail
the collective it is waited on in.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..logsetup import get_logger
from ..solver.faults import SolverDeviceLostError
from ..utils.clock import Clock
from .multihost import distributed_solver_mesh, group_timeout
from .sharded import PendingCost, ShardedBucketCost

log = get_logger("parallel")

OP_SOLVE = 1
OP_SHUTDOWN = 2
OP_KEEPALIVE = 3

KEEPALIVE_FRACTION = 0.25  # of the collective timeout, idle before a keep-alive

_HEADER = 8  # [opcode, Bp, R, Tp, seq, has_catalog, reserved x2]


class FabricSolveFailed(RuntimeError):
    """Another process's blocks of a solve failed; raised after the gather
    on every process that did not fail itself."""

    def __init__(self, ranks: list, seq: int):
        super().__init__(f"peer fabric: process(es) {ranks} failed their blocks of solve {seq}")
        self.ranks = ranks


class PeerFabric:
    """The solve-broadcast hub for one global (pods x types) mesh. Without
    `mesh`, the mesh is built from every process's blocks: `blocks` logical
    blocks on `device` each, or one per visible card."""

    def __init__(self, mesh=None, device="cuda", blocks: Optional[int] = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else distributed_solver_mesh(self.device, blocks)
        self.process_index = dist.get_rank() if dist.is_initialized() else 0
        self.process_count = dist.get_world_size() if dist.is_initialized() else 1
        flat = [r for row in self.mesh.ranks for r in row]
        if flat != sorted(flat) or self.mesh.processes != self.process_count:
            raise ValueError("the fabric's mesh must hold every process's blocks, rank by rank")
        nccl = dist.is_initialized() and dist.get_backend() == "nccl"
        # where the collectives' tensors live
        self._comm = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
        self.cost = ShardedBucketCost(self.mesh, rank=self.process_index)
        self._seq = 0
        self.catalog_broadcasts = 0  # how many dispatches re-sent the catalog
        # catalog epoch cache: caps/prices change rarely, so they are
        # broadcast and placed once per catalog, not per solve — every
        # process updates in lockstep when header[5] announces a new one
        self._catalog_key: Optional[tuple] = None
        self._catalog_placed: Optional[dict] = None
        self._Tp = 0
        # set once a peer has failed a solve: its loop has ended, so the
        # coordinator sends no more collectives
        self._lost: Optional[str] = None
        # keep-alive headers sent (coordinator) or seen (peer)
        self.keepalives = 0
        # the coordinator's broadcasts, one at a time: a solve holds
        # `_inflight` from its header to the end of its gather
        self._wire = threading.Lock()
        self._inflight = False
        self._clock = Clock()
        self._last_sent = self._clock.now()
        self._stop = threading.Event()
        self._keepalive: Optional[threading.Thread] = None
        if self.multiprocess and self.is_coordinator():
            self._keepalive = threading.Thread(target=self._keepalive_loop, name="fabric-keepalive", daemon=True)
            self._keepalive.start()

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    def is_coordinator(self) -> bool:
        return self.process_index == 0

    # -- wire helpers ---------------------------------------------------------

    def _broadcast(self, value: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(value)).to(self._comm)
        dist.broadcast(t, src=0, group=self.mesh.group)
        return t.cpu().numpy()

    @staticmethod
    def _pack(parts) -> np.ndarray:
        return np.concatenate([p.astype(np.float32).ravel() for p in parts])

    def _place_catalog(self, caps: np.ndarray, prices: np.ndarray) -> None:
        self._catalog_placed = self.cost.place_catalog(caps.astype(np.float32), prices.astype(np.float32))
        self._Tp = caps.shape[0]

    def _keepalive_loop(self) -> None:
        """The coordinator's keep-alive: a header whenever the wire has been
        idle for KEEPALIVE_FRACTION of the collective timeout."""
        interval = group_timeout() * KEEPALIVE_FRACTION
        while not self._stop.wait(interval / 4):
            with self._wire:
                if self._stop.is_set() or self._inflight or self._lost is not None:
                    continue
                if self._clock.now() - self._last_sent < interval:
                    continue
                try:
                    self._broadcast(np.asarray([OP_KEEPALIVE, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32))
                except Exception as exc:  # noqa: BLE001 - the next solve's broadcast raises it
                    log.warning("peer fabric: keep-alive broadcast failed, keep-alives stop: %s", exc)
                    return
                self._last_sent = self._clock.now()
                self.keepalives += 1

    def _end_solve(self) -> None:
        with self._wire:
            self._inflight = False
            self._last_sent = self._clock.now()

    def _gather(self, local: torch.Tensor, fault: Optional[BaseException]) -> torch.Tensor:
        """Every process's [blocks, 4, Bb] results, rank by rank, behind one
        status word each. Raises on every process when any failed: its own
        fault where it failed; on the coordinator, SolverDeviceLostError for
        a peer's, which marks the fabric lost; on a peer, FabricSolveFailed."""
        flat = torch.zeros((local.numel() + 1,), dtype=torch.int32, device=self._comm)
        if fault is None:
            flat[1:] = local.reshape(-1)
        else:
            flat[0] = 1
        parts = [torch.empty_like(flat) for _ in range(self.process_count)]
        try:
            dist.all_gather(parts, flat, group=self.mesh.group)
        finally:
            if self.is_coordinator():
                self._end_solve()
        if fault is not None:
            raise fault
        failed = [r for r, status in enumerate(torch.stack([p[0] for p in parts]).tolist()) if status]
        if failed:
            exc = FabricSolveFailed(failed, self._seq)
            if self.is_coordinator():
                self._lost = f"{exc}; their loops have ended, so the fleet must be restarted"
                raise SolverDeviceLostError(self._lost) from exc
            raise exc
        return torch.cat([p[1:] for p in parts]).reshape(-1, *local.shape[1:])

    def _enter_solve(self, stats: np.ndarray, allowed: np.ndarray, catalog: Optional[tuple] = None) -> PendingCost:
        """The step every process takes in lockstep: place a new catalog,
        launch this process's blocks; the gather and the combine run in the
        result's wait(), which every process reaches even when its own step
        failed."""
        if not self.multiprocess:
            if catalog is not None:
                self._place_catalog(*catalog)
            return self.cost.dispatch(stats.astype(np.float32), self._catalog_placed, allowed)
        fault = None
        if catalog is not None:
            try:
                self._place_catalog(*catalog)
            except Exception as exc:  # noqa: BLE001 - raised by the gather, on every process
                fault = exc
        return self.cost.dispatch(stats.astype(np.float32), self._catalog_placed, allowed, into=self._comm, gather=self._gather, fault=fault)

    # -- coordinator side ------------------------------------------------------

    def dispatch(self, bucket_stats: np.ndarray, caps: np.ndarray, prices: np.ndarray, allowed: np.ndarray) -> PendingCost:
        """Run one bucket->type solve over the global mesh (coordinator), on
        inputs padded to the mesh; returns the result in flight (its wait()
        gives the packed [3, Bp], or raises on every process).

        If a broadcast fails, the peers are released (best-effort SHUTDOWN)
        before the error surfaces. A failure past the broadcasts is carried
        into the gather (the module docstring)."""
        if self._lost is not None:
            raise SolverDeviceLostError(self._lost)
        Bp, R = bucket_stats.shape[1], bucket_stats.shape[2]
        Tp = caps.shape[0]
        key = (caps.tobytes(), prices.tobytes())
        new_catalog = (caps, prices) if key != self._catalog_key else None
        if not self.multiprocess:
            pending = self._enter_solve(bucket_stats, allowed, new_catalog)
            self._catalog_key = key
            return pending
        has_catalog = int(new_catalog is not None)
        parts = [bucket_stats, allowed] + ([caps, prices] if has_catalog else [])
        payload = self._pack(parts)
        try:
            with self._wire:
                self._inflight = True
                self._seq += 1
                self.catalog_broadcasts += has_catalog
                self._broadcast(np.asarray([OP_SOLVE, Bp, R, Tp, self._seq, has_catalog, 0, 0], dtype=np.int32))
                self._broadcast(payload)
        except Exception:
            self._end_solve()
            self.shutdown(best_effort=True)
            raise
        pending = self._enter_solve(bucket_stats, allowed, new_catalog)
        if has_catalog and pending.fault is None:
            self._catalog_key = key
        return pending

    def shutdown(self, best_effort: bool = False) -> None:
        """Release the peer loops (coordinator). Once a peer has failed, no
        peer is left in the barrier and nothing is sent.

        The keep-alive thread is joined on the way out. It holds this fabric,
        and with it the mesh's process group: left running, it may drop the
        last reference while the interpreter exits, and a process group
        destroyed on a daemon thread then aborts the process."""
        if not (self.multiprocess and self.is_coordinator()):
            return
        self._stop.set()
        try:
            if self._lost is None:
                with self._wire:
                    self._broadcast(np.asarray([OP_SHUTDOWN, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32))
        except Exception:
            if not best_effort:
                raise
            log.warning("peer fabric: best-effort shutdown broadcast failed")
        finally:
            # a keep-alive broadcast in flight ends within the group's timeout
            if self._keepalive is not None:
                self._keepalive.join(timeout=group_timeout())

    # -- peer side -------------------------------------------------------------

    def serve(self) -> int:
        """Follow the coordinator: block on the header barrier, mirror its
        solves, exit on SHUTDOWN. Returns the number of solves served.

        A failure of this peer's own step is fatal by design: it is raised
        after the gather, which carries its status to every process, and
        the coordinator stops sending — crash-and-restart is the consistent
        recovery. A failure of the coordinator's step alone is not: the
        peer logs it and goes back to the barrier."""
        served = 0
        zero_header = np.zeros((_HEADER,), dtype=np.int32)
        while True:
            header = self._broadcast(zero_header)
            op = int(header[0])
            if op == OP_SHUTDOWN:
                log.info("peer %d released after %d solves", self.process_index, served)
                return served
            if op == OP_KEEPALIVE:
                self.keepalives += 1
                continue
            if op != OP_SOLVE:
                raise RuntimeError(f"peer {self.process_index}: unknown opcode {op}")
            Bp, R, Tp = int(header[1]), int(header[2]), int(header[3])
            has_catalog = bool(header[5])
            size = 2 * Bp * R + Bp * Tp + (Tp * R + Tp if has_catalog else 0)
            payload = self._broadcast(np.zeros((size,), dtype=np.float32))
            offsets = np.cumsum([0, 2 * Bp * R, Bp * Tp, Tp * R, Tp])
            stats = payload[offsets[0] : offsets[1]].reshape(2, Bp, R)
            allowed = payload[offsets[1] : offsets[2]].reshape(Bp, Tp) > 0.5
            self._seq = int(header[4])
            catalog = (payload[offsets[2] : offsets[3]].reshape(Tp, R), payload[offsets[3] : offsets[4]]) if has_catalog else None
            try:
                self._enter_solve(stats, allowed, catalog).wait()
            except FabricSolveFailed as exc:
                if exc.ranks != [0]:
                    raise  # another peer's loop has ended, so the fleet's has
                # the coordinator's step failed alone: it raises its fault,
                # and the fleet is still in lockstep
                log.warning("peer %d: %s", self.process_index, exc)
                continue
            served += 1


def _demo_pods(count: int):
    """Self-contained pod builder for the multi-process demo (no test deps)."""
    from ..api.objects import Container, ObjectMeta, Pod, PodSpec, ResourceRequirements

    pods = []
    for i in range(count):
        cpu = [0.25, 0.5, 1.0][i % 3]
        pods.append(
            Pod(
                metadata=ObjectMeta(name=f"demo-pod-{i:04d}"),
                spec=PodSpec(containers=[Container(resources=ResourceRequirements(requests={"cpu": cpu, "memory": 512 * 2**20, "pods": 1}))]),
            )
        )
    return pods


def demo_layout(results) -> list:
    """A solve's new nodes as sorted (instance type, pod names) pairs."""
    return sorted([n.instance_type_options[0].name(), sorted(p.metadata.name for p in n.pods)] for n in results.new_nodes)


def run_demo_process(
    coordinator: str,
    num_processes: int,
    process_id: int,
    pod_count: int = 96,
    solves: int = 1,
    device="cuda",
    backend: Optional[str] = None,
    devices_per_process: Optional[int] = None,
) -> dict:
    """One process of the multi-process demo solve: process 0 runs `solves`
    sequential production scheduler solves through the SAME
    DenseSolver(peer_fabric=...) — exercising the catalog-epoch reuse across
    broadcasts — while peers serve the loop. Returns a result dict with
    this process's K1 launches (and, on the coordinator, each
    Scheduler.solve's milliseconds).

    Spawned by run_demo_fleet via `python -m karpenter_tpu_torch.parallel.peers`.
    """
    from ..ops import bucket_cost
    from .multihost import initialize

    initialize(coordinator, num_processes, process_id, backend=backend, device=device)
    try:
        fabric = PeerFabric(device=device, blocks=devices_per_process)
        common = {
            "process": process_id,
            "devices": fabric.mesh.size,
            "device": str(fabric.device),
            "backend": dist.get_backend(),
        }
        if not fabric.is_coordinator():
            served = fabric.serve()
            return {**common, "served": served, "k1_launches": bucket_cost.KEYED_LAUNCHES}

        from ..api.provisioner import Provisioner
        from ..cloudprovider.fake import FakeCloudProvider, instance_types
        from ..scheduler import build_scheduler
        from ..solver import DenseSolver

        provider = FakeCloudProvider(instance_types(64))
        dense = DenseSolver(min_batch=1, device=device, peer_fabric=fabric)
        solves = max(1, solves)
        scheduled = unschedulable = 0
        layouts, solve_ms = [], []
        try:
            for _ in range(solves):
                pods = _demo_pods(pod_count)
                scheduler = build_scheduler([Provisioner()], provider, pods, dense_solver=dense)
                t0 = time.perf_counter()
                results = scheduler.solve(pods)
                solve_ms.append((time.perf_counter() - t0) * 1e3)
                scheduled += sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes)
                unschedulable += len(results.unschedulable)
                layouts.append(demo_layout(results))
        finally:
            # a coordinator error between solves must not leave peers wedged
            # in the broadcast barrier: release them before the traceback
            fabric.shutdown(best_effort=True)
        return {
            **common,
            "scheduled": scheduled,
            "requested": pod_count * solves,
            "solves": solves,
            "catalog_broadcasts": fabric.catalog_broadcasts,
            "dense_batches": dense.stats.batches,
            "dense_committed": dense.stats.pods_committed,
            "sharded_batches": dense.stats.sharded_batches,
            "mesh": dict(fabric.mesh.shape),
            "unschedulable": unschedulable,
            "layouts": layouts,
            "solve_ms": solve_ms,
            "k1_launches": bucket_cost.KEYED_LAUNCHES,
        }
    finally:
        dist.destroy_process_group()


def run_demo_fleet(
    n_processes: int = 2,
    devices_per_process: Optional[int] = 4,
    pod_count: int = 96,
    timeout: float = 300.0,
    solves: int = 1,
    device: str = "cuda",
    backend: Optional[str] = None,
):
    """Spawn the demo fleet as OS processes on 127.0.0.1 and return their
    parsed result dicts (coordinator first); children are killed on any
    failure."""
    import json
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = []
    outs = []
    try:
        for pid in range(n_processes):
            cmd = [
                sys.executable, "-m", "karpenter_tpu_torch.parallel.peers",
                "--coordinator", coordinator,
                "--num-processes", str(n_processes),
                "--process-id", str(pid),
                "--pods", str(pod_count),
                "--solves", str(solves),
                "--device", device,
            ]
            if backend:
                cmd += ["--backend", backend]
            if devices_per_process:
                cmd += ["--devices-per-process", str(devices_per_process)]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root))
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"peer demo process failed (rc={p.returncode}):\n{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


if __name__ == "__main__":
    import argparse
    import json
    import sys

    parser = argparse.ArgumentParser(prog="karpenter-tpu-peer-demo")
    parser.add_argument("--coordinator", required=True)
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--pods", type=int, default=96)
    parser.add_argument("--solves", type=int, default=1)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on cuda, gloo on cpu)")
    parser.add_argument(
        "--devices-per-process",
        type=int,
        default=None,
        help="logical mesh blocks this process holds on its device (default: one per visible card)",
    )
    args = parser.parse_args()
    out = run_demo_process(
        args.coordinator, args.num_processes, args.process_id, args.pods, args.solves,
        device=args.device, backend=args.backend, devices_per_process=args.devices_per_process,
    )
    json.dump(out, sys.stdout)
    print()
