"""Reductions over a proposed packing layout, in plain PyTorch.

The port's counterparts of the jitted programs in the JAX package's
ops/packing.py: per-bin resource usage and pod counts as `index_add_`
segment sums, and the audit of a layout against its bins' capacities. They
run on whatever device their tensors lie on.
"""

from __future__ import annotations

from typing import Tuple

import torch


def segment_usage(requests: torch.Tensor, bin_ids: torch.Tensor, num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin resource usage [num_segments, R] and pod counts
    [num_segments] int32.

    Callers pass num_segments = max_bins + 1; bin_ids of -1 (unpacked pods)
    accumulate into the final scratch segment, which must stay unused by any
    real bin."""
    safe_ids = torch.where(bin_ids < 0, num_segments - 1, bin_ids).to(torch.int64)
    usage = torch.zeros((num_segments, requests.shape[1]), dtype=requests.dtype, device=requests.device)
    usage.index_add_(0, safe_ids, requests)
    counts = torch.zeros((num_segments,), dtype=torch.int32, device=requests.device)
    counts.index_add_(0, safe_ids, torch.ones_like(safe_ids, dtype=torch.int32))
    return usage, counts


def audit_layout(usage: torch.Tensor, caps_of_bin: torch.Tensor) -> torch.Tensor:
    """[B] bool: each bin's summed usage fits its assigned capacity."""
    return (usage <= caps_of_bin + 1e-6).all(dim=-1)
