"""Multi-process initialization for the solver service.

The port's copy of karpenter_tpu/parallel/multihost.py, on
`torch.distributed`:

- every host runs the solver service (cmd/solver_service.py) with the same
  coordinator address; process 0 hosts the rendezvous (a TCP store);
- :func:`initialize` joins the process group from explicit arguments or the
  standard env (``KARPENTER_TPU_COORDINATOR``, ``..._NUM_PROCESSES``,
  ``..._PROCESS_ID``), with the backend's default collective timeout or the
  caller's (`timeout`); :func:`group_timeout` reads the one in force, which
  the peer fabric's keep-alive paces itself by (parallel/peers.py). Nothing detects the topology: the process count and
  this process's id must be given. The backend is an explicit choice:
  ``"nccl"`` when the process's device is CUDA, ``"gloo"`` for the CPU, or
  the caller's (``"gloo"`` for processes that share one card, which NCCL
  refuses). Under NCCL a process given "cuda" takes card
  ``process_id % cards``;
- :func:`host_mesh_axes` picks the (pods × types) factorization that keeps
  the types axis — whose combines (argmin, any-feasible) are the chatty
  ones — inside each process's own blocks, so only the pods-axis results
  cross processes;
- :func:`distributed_solver_mesh` builds the global mesh from every
  process's local blocks.

With no coordinator configured, initialize() does nothing and returns
False: everything runs on the local devices.

Cross-process execution: every process must take part in each solve's
collectives. parallel/peers.py provides that loop: the coordinator
broadcasts each solve request, peers compute their blocks, and
cmd/solver_service.py routes every non-zero process into
PeerFabric.serve(). DenseSolver's auto-detected mesh spans only this
process's cards; constructing it with peer_fabric=PeerFabric() opts into
the global mesh.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..logsetup import get_logger
from .mesh import SolverMesh, to_grid

log = get_logger("parallel")

ENV_COORDINATOR = "KARPENTER_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "KARPENTER_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "KARPENTER_TPU_PROCESS_ID"


_timeout_s: Optional[float] = None  # the collective timeout initialize() set


def group_timeout() -> float:
    """Seconds a collective of the process group may wait before it fails:
    the timeout initialize() was given, else the backend's default."""
    if _timeout_s is not None:
        return _timeout_s
    from torch.distributed import constants

    nccl = dist.is_initialized() and dist.get_backend() == "nccl"
    return (constants.default_pg_nccl_timeout if nccl else constants.default_pg_timeout).total_seconds()


def default_backend(device) -> str:
    """"nccl" for a process on a card, "gloo" for one on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout: Optional[float] = None,
) -> bool:
    """Join the multi-process solver fabric; returns True when distributed
    mode is active.

    Arguments default to the KARPENTER_TPU_* env; with no coordinator
    configured anywhere this is a no-op (False). A coordinator without a
    process count or id raises before any connection is tried. `timeout`
    (seconds) bounds each collective's wait; by default the backend's.
    Safe to call more than once."""
    global _timeout_s
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR) or None
    if not coordinator_address:
        return False
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES) is not None:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID) is not None:
        process_id = int(os.environ[ENV_PROCESS_ID])
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address}: the process count and this process's id must be given "
            f"(arguments, or {ENV_NUM_PROCESSES} and {ENV_PROCESS_ID})"
        )
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if dev.type == "cuda" and torch.device(device).index is None and backend == "nccl":
        # processes of one host take one card each: NCCL refuses two ranks
        # on one GPU
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id, **extra)
    _timeout_s = timeout
    log.info("joined solver fabric: coordinator=%s process %d/%d, backend %s", coordinator_address, process_id, num_processes, backend)
    return True


def host_mesh_axes(n_global: int, n_local: int) -> Tuple[int, int]:
    """(pods, types) axis sizes that keep types-axis combines within a host.

    The types axis carries the argmin-combine traffic, so it must not span
    hosts: its size divides the per-host device count. Pods-axis blocks
    (independent bucket rows, concatenated once per solve) span hosts.
    Examples: 2 hosts × 4 cards (8 global) → (pods=2, types=4);
    4 hosts × 8 cards (32 global) → (pods=8, types=4).
    """
    if n_local <= 0 or n_global <= 0 or n_global % max(n_local, 1):
        return (max(n_global, 1), 1)
    types = 1
    # largest power-of-two types axis that DIVIDES the per-host device count
    # (a non-dividing axis would span hosts), capped at 4: types reductions
    # saturate quickly; pods parallelism is the scaler
    while types * 2 <= 4 and n_local % (types * 2) == 0:
        types *= 2
    return (n_global // types, types)


def local_devices(device="cuda", blocks: Optional[int] = None) -> list:
    """This process's blocks: `blocks` logical blocks on `device`, or one per
    visible card when `device` is CUDA and `blocks` is None."""
    dev = resolve_device(device)
    if blocks is None:
        if dev.type != "cuda":
            raise ValueError("a CPU process must say how many logical blocks it holds")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] * blocks


def distributed_solver_mesh(device="cuda", blocks: Optional[int] = None) -> SolverMesh:
    """A global (pods × types) mesh over every process's blocks, rank by
    rank, with the types axis confined to one process (host_mesh_axes).
    Every process of the group calls it. In one process (no group) it is the
    local mesh."""
    local = local_devices(device, blocks)
    if not dist.is_initialized():
        counts, world, rank = [len(local)], 1, 0
    else:
        world, rank = dist.get_world_size(), dist.get_rank()
        counts = [None] * world
        dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"every process must hold the same number of blocks, got {counts}")
    n_local = counts[0]
    pods, types = host_mesh_axes(n_local * world, n_local)
    # a rank's own entries are its devices; another rank's are named by
    # position only (that rank computes them)
    flat = [(r, local[k] if r == rank else torch.device("cpu")) for r in range(world) for k in range(n_local)]
    grid = to_grid([d for _, d in flat], types)
    ranks = to_grid([r for r, _ in flat], types)
    return SolverMesh(devices=grid, ranks=ranks, group=dist.group.WORLD if dist.is_initialized() else None)
