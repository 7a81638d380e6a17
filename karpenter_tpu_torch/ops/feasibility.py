"""Feasibility surfaces in plain PyTorch: the [B, T] offering-availability
mask and the bucket -> instance-type cost choice.

These are the port's counterparts of the jitted programs in the JAX
package's ops/feasibility.py. They run on whatever device their tensors lie
on. `bucket_type_cost_packed` is the plain version of the hand-written
kernel in ops/bucket_cost.py: the CPU path and the yardstick the kernel is
held against on the card. The constants and the order of operations are
the reference's, so identical f32 inputs give identical outputs.
"""

from __future__ import annotations

import torch

_EPS = 1e-9
_FIT_TOL = 1e-6


def availability_counts(pair: torch.Tensor, cube: torch.Tensor) -> torch.Tensor:
    """[B, T] bool: bucket b and type t share >= 1 available (zone,
    capacity-type) offering cell.

    pair: [B, Z*C] f32 0/1 bucket allowances (zone x capacity-type outer
    product, flattened); cube: [T, Z*C] f32 0/1 offering-availability rows
    (quarantined pools are zeros). The counts are small integers, exact in
    f32 (and in TF32, were it enabled)."""
    return torch.matmul(pair, cube.T) > 0.5


def bucket_type_cost(sum_requests: torch.Tensor, max_requests: torch.Tensor, caps: torch.Tensor, prices: torch.Tensor, allowed: torch.Tensor):
    """Vectorized bucket -> instance-type choice.

    For each pack bucket b (a set of pods that will share nodes):
      frac[b, t] = max_r (sum_requests[b, r] / caps[t, r])   (fractional
                   lower bound on the nodes of type t the bucket needs)
      bins[b, t] = ceil(frac[b, t])
    feasible iff allowed AND the largest single pod fits the type. The key
    minimizes fractional cost first, then bin count, then price.

    Returns (tstar [B] int32, bins [B] int32, feasible_any [B] bool). tstar
    is the first index of the minimum key (0 on a row with no feasible
    type), and bins is 0 where tstar is not feasible.
    """
    safe_caps = torch.clamp_min(caps, _EPS)  # [T, R]
    ratio = sum_requests[:, None, :] / safe_caps[None, :, :]  # [B, T, R]
    # resources the type simply doesn't have (cap==0) but the bucket needs
    impossible = (caps[None, :, :] <= _EPS) & (sum_requests[:, None, :] > _EPS)
    frac = torch.where(impossible, torch.inf, ratio).amax(dim=-1)  # [B, T]
    bins = torch.ceil(torch.clamp_min(frac, _EPS))
    pod_fits = (max_requests[:, None, :] <= caps[None, :, :] + _FIT_TOL).all(dim=-1)  # [B, T]
    ok = allowed.bool() & pod_fits & torch.isfinite(frac)
    key = frac * prices[None, :] + bins * 1e-4 + prices[None, :] * 1e-7
    key = torch.where(ok, key, torch.inf)
    tstar = torch.argmin(key, dim=1)  # first index of the minimum
    at_star = tstar[:, None]
    chosen_bins = torch.where(ok.gather(1, at_star), bins.gather(1, at_star), 0.0)[:, 0]
    return tstar.to(torch.int32), chosen_bins.to(torch.int32), ok.any(dim=1)


def bucket_type_cost_packed(bucket_stats: torch.Tensor, caps: torch.Tensor, prices: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """bucket_stats = stack([sum, max]) [2, B, R] f32; caps [T, R] f32;
    prices [T] f32; allowed [B, T] bool. Returns one packed int32 [3, B] =
    (tstar, bins, feasible)."""
    tstar, bins, feasible = bucket_type_cost(bucket_stats[0], bucket_stats[1], caps, prices, allowed)
    return torch.stack([tstar, bins, feasible.to(torch.int32)])
