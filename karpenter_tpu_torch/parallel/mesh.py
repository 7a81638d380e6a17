"""Device mesh + block layout for the distributed solver.

The problem's parallel structure (SURVEY.md section 2.10): the pods x types
feasibility/packing surface is embarrassingly parallel over pods and
reducible over types. The mesh maps that directly:

  axis "pods"  — data-parallel blocks of the pod (or bucket) axis.
  axis "types" — blocks of the instance-type axis. Reductions over types
                 (argmin cost, any-feasible) become an explicit combine of
                 the blocks' results (parallel/sharded.py).

The port's copy of karpenter_tpu/parallel/mesh.py. A `SolverMesh` is a
[pods, types] grid of `torch.device`s with the rank of the process that
owns each entry (all rank 0 in one process) and, across processes, the
process group. One device may hold several blocks: eight logical blocks on
one card are `devices=[torch.device("cuda", 0)] * 8`, and the counterpart of
the JAX package's eight virtual CPU devices is `[torch.device("cpu")] * 8`.
There is no swap to another backend: asking for more devices than the list
holds raises. The shardings become `BlockSpec`s, which `block_of` uses to
cut a block of a tensor out for its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("pods", "types")


@dataclass(frozen=True, eq=False)
class SolverMesh:
    """A [pods, types] grid of devices. `ranks[i][j]` is the rank of the
    process that computes block (i, j); `group` is the process group across
    those ranks, None within one process."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    ranks: Tuple[Tuple[int, ...], ...]
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"pods": len(self.devices), "types": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def processes(self) -> int:
        return len({r for row in self.ranks for r in row})

    def blocks(self, rank: Optional[int] = None) -> List[Tuple[int, int, torch.device]]:
        """(i, j, device) of every block in row-major order, or of those
        `rank` owns."""
        return [
            (i, j, dev)
            for i, row in enumerate(self.devices)
            for j, dev in enumerate(row)
            if rank is None or self.ranks[i][j] == rank
        ]


def to_grid(entries: Sequence, types_parallel: int) -> Tuple[tuple, ...]:
    """A flat list as [pods][types] rows of types_parallel entries."""
    return tuple(tuple(entries[i : i + types_parallel]) for i in range(0, len(entries), types_parallel))


def solver_mesh(n_devices: Optional[int] = None, types_parallel: int = 1, devices: Optional[Sequence] = None) -> SolverMesh:
    """A (pods x types) mesh over the first n devices of `devices` (default:
    every visible CUDA device); types_parallel of them shard the type axis,
    the rest shard pods. Raises when the list holds fewer than n."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n < 1 or len(devices) < n:
        raise ValueError(f"need {n} devices but the list has {len(devices)}")
    if types_parallel < 1 or n % types_parallel != 0:
        raise ValueError(f"{n} devices not divisible by types_parallel={types_parallel}")
    grid = to_grid(devices[:n], types_parallel)
    return SolverMesh(devices=grid, ranks=tuple(tuple(0 for _ in row) for row in grid))


def default_mesh(n_devices: int, types_parallel: Optional[int] = None, devices: Optional[Sequence] = None) -> SolverMesh:
    """The production mesh shape for n devices: 2-way types-parallel when the
    count allows, the rest pods-parallel — or an explicit types_parallel from
    the host-aware factorization (parallel/multihost.py host_mesh_axes)."""
    if types_parallel is None:
        types_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return solver_mesh(n_devices, types_parallel=types_parallel, devices=devices)


@dataclass(frozen=True)
class BlockSpec:
    """Which mesh axis cuts each dimension of a tensor (None: whole on every
    block), as a JAX PartitionSpec does."""

    axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if any(a is not None and a not in AXES for a in self.axes):
            raise ValueError(f"unknown mesh axis in {self.axes}")


def pod_sharding(mesh: SolverMesh) -> BlockSpec:
    """[P, ...] tensors: cut the leading pod axis."""
    return BlockSpec(("pods",))


def type_sharding(mesh: SolverMesh) -> BlockSpec:
    """[T, ...] tensors: cut the leading type axis."""
    return BlockSpec(("types",))


def pod_by_type_sharding(mesh: SolverMesh) -> BlockSpec:
    """[P, T] tensors: cut over both mesh axes."""
    return BlockSpec(("pods", "types"))


def replicated(mesh: SolverMesh) -> BlockSpec:
    return BlockSpec(())


def block_of(mesh: SolverMesh, array, spec: BlockSpec, i: int, j: int) -> torch.Tensor:
    """Block (i, j) of `array` (a host array or tensor) under `spec`, on the
    host, contiguous. Each cut dimension must divide by its axis."""
    t = torch.as_tensor(np.ascontiguousarray(array)) if isinstance(array, np.ndarray) else array
    index = []
    for d, axis in enumerate(spec.axes):
        if axis is None:
            index.append(slice(None))
            continue
        n = mesh.shape[axis]
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} of size {t.shape[d]} does not divide over the {axis} axis ({n})")
        k, size = (i if axis == "pods" else j), t.shape[d] // n
        index.append(slice(k * size, (k + 1) * size))
    return t[tuple(index)].contiguous()

