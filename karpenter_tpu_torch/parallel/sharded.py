"""The sharded solve step and bucket choice over the (pods x types) mesh.

The port's copy of karpenter_tpu/parallel/sharded.py. The JAX package runs
one jitted program under sharding annotations and lets XLA place the
collectives. Here each block of the mesh computes on its own device, and the
reductions over the types axis are an explicit, exact combine of the
blocks' results:

- the bucket -> instance-type choice (`make_sharded_bucket_cost`, the
  production dispatch): K1 (ops/bucket_cost.py:bucket_cost_keyed) launched
  on each (bucket block x type block), each block's [3, Bb] result and its
  winning keys (the f32 key reinterpreted as int32, so no copy rounds it)
  queued into one host buffer, then per bucket the lexicographic minimum of
  (key, global type index) over the type blocks in order: K1's own
  first-index argmin, so the result is bit-equal to one unsharded launch.
  A bucket with no feasible type gets t* = 0, bins = 0, feasible = 0, the
  unsharded answer;
- the toy solve step (`make_sharded_solve_step`): per-pod feasibility and
  cheapest-feasible-type with the same first-index combine, the bucket
  choice above, and per-bin segment sums per pod block
  (ops/packing.segment_usage), summed afterwards.

Shapes are padded to the mesh as the JAX package pads them: buckets to a
multiple of the pods dimension (at least one row per block), types to a
multiple of the types dimension with allowed=False and zero caps, so a
padded type never wins and a padded bucket reports infeasible.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.bucket_cost import bucket_cost_keyed
from ..ops.feasibility import resource_fit
from ..ops.packing import segment_usage
from .mesh import BlockSpec, SolverMesh, block_of, pod_sharding, type_sharding

STATS_SPEC = BlockSpec((None, "pods", None))  # bucket stats [2, B, R]
ALLOWED_SPEC = BlockSpec(("pods", "types"))  # allowed [B, T]
CAPS_SPEC = BlockSpec(("types", None))  # caps [T, R]
PRICES_SPEC = BlockSpec(("types",))  # prices [T]


def padded_shape(mesh: SolverMesh, B: int, T: int) -> Tuple[int, int]:
    """(Bp, Tp): buckets padded to a multiple of the pods dimension, at least
    one per block; types to a multiple of the types dimension."""
    pods, types = mesh.shape["pods"], mesh.shape["types"]
    return max(-(-B // pods) * pods, pods), -(-T // types) * types


def pad_catalog(mesh: SolverMesh, caps: np.ndarray, prices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """caps [Tp, R] and prices [Tp] f32, the padded types zero."""
    T = caps.shape[0]
    _, Tp = padded_shape(mesh, 1, T)
    caps_p = np.zeros((Tp, caps.shape[1]), np.float32)
    caps_p[:T] = caps
    prices_p = np.zeros((Tp,), np.float32)
    prices_p[:T] = prices
    return caps_p, prices_p


def pad_batch(mesh: SolverMesh, stats: np.ndarray, allowed: np.ndarray, Tp: int) -> Tuple[np.ndarray, np.ndarray]:
    """stats [2, Bp, R] f32 and allowed [Bp, Tp] bool, the padded buckets
    zero and allowed nowhere."""
    B = stats.shape[1]
    Bp, _ = padded_shape(mesh, B, Tp)
    stats_p = np.zeros((2, Bp, stats.shape[2]), np.float32)
    stats_p[:, :B] = stats
    allowed_p = np.zeros((Bp, Tp), dtype=bool)
    allowed_p[:B, : allowed.shape[1]] = allowed
    return stats_p, allowed_p


def combine_blocks(blocks: np.ndarray, types_per_block: int) -> np.ndarray:
    """The combine over the types axis. blocks: int32 [pods, types, 4, Bb],
    each block's (local t*, bins, feasible, key bits); returns the packed
    int32 [3, pods * Bb]. Per bucket the winning block is the first one
    holding the minimum key, which is the lexicographic minimum of (key,
    global type index), since the blocks hold ascending ranges of types."""
    keys = blocks[:, :, 3, :].view(np.float32)
    win = np.argmin(keys, axis=1)[:, None, :]  # [pods, 1, Bb]
    tstar = np.take_along_axis(blocks[:, :, 0, :], win, axis=1)[:, 0] + win[:, 0] * types_per_block
    bins = np.take_along_axis(blocks[:, :, 1, :], win, axis=1)[:, 0]
    feasible = blocks[:, :, 2, :].any(axis=1)
    return np.stack([tstar.reshape(-1), bins.reshape(-1), feasible.reshape(-1)]).astype(np.int32)


class PendingCost:
    """A dispatch in flight: this process's blocks, each block's [4, Bb]
    int32 result queued into `buffer` ([blocks, 4, Bb], pinned host memory
    when a block is on a card) behind its launch, with a CUDA event per
    block. wait() waits for them, gathers the other processes' blocks where
    there are any, and combines them into the packed int32 [3, Bp].

    Under a gather, `fault` is what this process met while launching: the
    process still enters the gather, so no other process is left alone in
    the collective, and the gather raises it there."""

    def __init__(self, cost: "ShardedBucketCost", buffer: torch.Tensor, events: list, Tp: int, gather=None, fault: Optional[BaseException] = None):
        self.cost = cost
        self.buffer = buffer
        self.events = events
        self.Tp = Tp
        self.gather = gather
        self.fault = fault

    def blocks(self) -> torch.Tensor:
        """This process's [blocks, 4, Bb] once every block has landed."""
        for event in self.events:
            event.synchronize()
        return self.buffer

    def wait(self) -> np.ndarray:
        if self.gather is None:
            return self.cost.combine(self.blocks().cpu().numpy(), self.Tp)
        fault = self.fault
        if fault is None:
            try:
                self.blocks()
            except Exception as exc:  # noqa: BLE001 - raised by the gather, on every process
                fault = exc
        return self.cost.combine(self.gather(self.buffer, fault).cpu().numpy(), self.Tp)


class ShardedBucketCost:
    """The bucket -> type choice over a mesh (make_sharded_bucket_cost).
    With `rank`, only the blocks that rank owns are launched (the peer
    fabric gathers the rest)."""

    def __init__(self, mesh: SolverMesh, rank: Optional[int] = None):
        if rank is None and mesh.processes > 1:
            raise ValueError("a mesh across processes is dispatched rank by rank (parallel/peers.py)")
        self.mesh = mesh
        self.rank = rank

    def place_catalog(self, caps_p: np.ndarray, prices_p: np.ndarray) -> Dict[tuple, tuple]:
        """The padded catalog's type blocks on the devices that read them,
        keyed by (type block, device): uploaded once per catalog."""
        placed: Dict[tuple, tuple] = {}
        for i, j, dev in self.mesh.blocks(self.rank):
            if (j, dev) not in placed:
                placed[(j, dev)] = (
                    block_of(self.mesh, caps_p, CAPS_SPEC, i, j).to(dev),
                    block_of(self.mesh, prices_p, PRICES_SPEC, i, j).to(dev),
                )
        return placed

    def dispatch(
        self,
        stats_p: np.ndarray,
        catalog: Dict[tuple, tuple],
        allowed_p: np.ndarray,
        into: Optional[torch.device] = None,
        gather=None,
        fault: Optional[BaseException] = None,
    ) -> PendingCost:
        """K1's keyed launch on each block this rank owns, from the padded
        host batch; each block's result is copied into one buffer on `into`
        (default: the host, pinned when a block is on a card) behind its
        launch. The result's wait() gives the packed [3, Bp].

        `gather(buffer, fault)` takes this process's [blocks, 4, Bb] to
        every process's (parallel/peers.py). With a gather, a launch that
        raises, or a `fault` the caller already met, is carried to the
        gather instead of raised here."""
        owned = self.mesh.blocks(self.rank)
        Bb = stats_p.shape[1] // self.mesh.shape["pods"]
        on_card = any(dev.type == "cuda" for _, _, dev in owned)
        if into is None or into.type == "cpu":
            buffer = torch.empty((len(owned), 4, Bb), dtype=torch.int32, pin_memory=on_card)
        else:
            buffer = torch.empty((len(owned), 4, Bb), dtype=torch.int32, device=into)
        events = []
        Tp = allowed_p.shape[1]
        if fault is not None:
            return PendingCost(self, buffer, events, Tp, gather, fault)
        try:
            for n, (i, j, dev) in enumerate(owned):
                caps_t, prices_t = catalog[(j, dev)]
                packed, key = bucket_cost_keyed(
                    block_of(self.mesh, stats_p, STATS_SPEC, i, j).to(dev),
                    caps_t,
                    prices_t,
                    block_of(self.mesh, allowed_p, ALLOWED_SPEC, i, j).to(dev),
                )
                buffer[n, :3].copy_(packed, non_blocking=on_card)
                buffer[n, 3].copy_(key.view(torch.int32), non_blocking=on_card)
                if dev.type == "cuda":
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                    events.append(event)
        except Exception as exc:
            if gather is None:
                raise
            return PendingCost(self, buffer, [], Tp, gather, exc)
        return PendingCost(self, buffer, events, Tp, gather)

    def combine(self, blocks: np.ndarray, Tp: int) -> np.ndarray:
        """Every block's result, [mesh.size, 4, Bb] in row-major block order
        -> the packed [3, Bp]."""
        pods, types = self.mesh.shape["pods"], self.mesh.shape["types"]
        return combine_blocks(blocks.reshape(pods, types, 4, -1), Tp // types)

    def __call__(self, stats: np.ndarray, caps: np.ndarray, prices: np.ndarray, allowed: np.ndarray) -> np.ndarray:
        """One dispatch in one process: stats [2, B, R] f32, caps [T, R],
        prices [T], allowed [B, T] host arrays -> packed int32 [3, B], equal
        to one unsharded K1 launch."""
        if self.mesh.processes > 1:
            raise ValueError("a rank's blocks alone cannot answer a dispatch; the peer fabric gathers them")
        B = stats.shape[1]
        caps_p, prices_p = pad_catalog(self.mesh, np.asarray(caps, np.float32), np.asarray(prices, np.float32))
        stats_p, allowed_p = pad_batch(self.mesh, np.asarray(stats, np.float32), np.asarray(allowed, bool), caps_p.shape[0])
        return self.dispatch(stats_p, self.place_catalog(caps_p, prices_p), allowed_p).wait()[:, :B]


def make_sharded_bucket_cost(mesh: SolverMesh) -> ShardedBucketCost:
    """The production multi-block dispatch: the bucket -> type choice over
    the mesh, bucket axis on "pods", type axis on "types"; its packed [3, B]
    equals ops/bucket_cost.py:bucket_cost_packed's."""
    return ShardedBucketCost(mesh)


def _first_min_combine(mins: np.ndarray, args: np.ndarray, types_per_block: int) -> np.ndarray:
    """[pods, types, Pb] block minima and local first-index argmins -> the
    global first-index argmin [pods * Pb]."""
    win = np.argmin(mins, axis=1)[:, None, :]
    return (np.take_along_axis(args, win, axis=1)[:, 0] + win[:, 0] * types_per_block).reshape(-1)


def make_sharded_solve_step(mesh: SolverMesh, num_bins: int):
    """The sharded solve step for a mesh and a bin budget.

    Signature of the returned fn (host arrays or CPU tensors in, CPU
    tensors out):
      (requests [P, R], group_ids [P], compat [G, T], caps [T, R],
       prices [T], allowed [B, T], bucket_sum [B, R], bucket_max [B, R],
       bin_ids [P])
        -> (feasible_any [P], best_type [P], tstar [B], bins [B],
            bin_usage [num_bins, R], bin_counts [num_bins])
    """
    bucket_cost = make_sharded_bucket_cost(mesh)
    pods, types = mesh.shape["pods"], mesh.shape["types"]

    def solve_step(requests, group_ids, compat, caps, prices, allowed, bucket_sum, bucket_max, bin_ids):
        requests, group_ids, compat, caps, prices, allowed, bucket_sum, bucket_max, bin_ids = (
            np.asarray(a) for a in (requests, group_ids, compat, caps, prices, allowed, bucket_sum, bucket_max, bin_ids)
        )
        P, R = requests.shape
        caps_p, prices_p = pad_catalog(mesh, caps.astype(np.float32), prices.astype(np.float32))
        Tp = caps_p.shape[0]
        Pp = -(-P // pods) * pods
        requests_p = np.zeros((Pp, R), np.float32)
        requests_p[:P] = requests
        group_p = np.zeros((Pp,), np.int64)
        group_p[:P] = group_ids
        bin_p = np.full((Pp,), -1, np.int64)  # padded pods land in the scratch segment
        bin_p[:P] = bin_ids
        compat_p = np.zeros((compat.shape[0], Tp), dtype=bool)
        compat_p[:, : compat.shape[1]] = compat

        # [P, T] feasibility and the cheapest feasible type, per block
        Pb, Tb = Pp // pods, Tp // types
        mins = np.empty((pods, types, Pb), np.float32)
        args = np.empty((pods, types, Pb), np.int64)
        any_ok = np.zeros((pods, types, Pb), dtype=bool)
        for i, j, dev in mesh.blocks():
            req = block_of(mesh, requests_p, pod_sharding(mesh), i, j).to(dev)
            rows = block_of(mesh, compat_p, BlockSpec((None, "types")), i, j).to(dev)
            rows = rows.index_select(0, block_of(mesh, group_p, pod_sharding(mesh), i, j).to(dev))
            feasible = resource_fit(req, block_of(mesh, caps_p, type_sharding(mesh), i, j).to(dev)) & rows
            cost = torch.where(feasible, block_of(mesh, prices_p, type_sharding(mesh), i, j).to(dev)[None, :], torch.inf)
            local = torch.argmin(cost, dim=1)
            mins[i, j] = cost.gather(1, local[:, None])[:, 0].cpu().numpy()
            args[i, j] = local.cpu().numpy()
            any_ok[i, j] = feasible.any(dim=1).cpu().numpy()
        feasible_any = any_ok.any(axis=1).reshape(-1)[:P]
        best_type = _first_min_combine(mins, args, Tb)[:P].astype(np.int32)

        # the bucket -> type choice, K1 on each block
        stats = np.stack([bucket_sum, bucket_max]).astype(np.float32)
        packed = bucket_cost(stats, caps_p, prices_p, allowed)

        # per-bin segment sums per pod block, summed afterwards
        usage = np.zeros((num_bins + 1, R), np.float32)
        counts = np.zeros((num_bins + 1,), np.int32)
        for i, j, dev in mesh.blocks():
            if j:
                continue  # one block per pod block
            u, c = segment_usage(
                block_of(mesh, requests_p, pod_sharding(mesh), i, j).to(dev),
                block_of(mesh, bin_p, pod_sharding(mesh), i, j).to(dev),
                num_bins + 1,
            )
            usage += u.cpu().numpy()
            counts += c.cpu().numpy()
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a))
            for a in (feasible_any, best_type, packed[0], packed[1], usage[:num_bins], counts[:num_bins])
        )

    return solve_step


def sharded_solve_step(mesh: SolverMesh, requests, group_ids, compat, caps, prices, allowed, bucket_sum, bucket_max, bin_ids, num_bins: int):
    return make_sharded_solve_step(mesh, num_bins)(requests, group_ids, compat, caps, prices, allowed, bucket_sum, bucket_max, bin_ids)

