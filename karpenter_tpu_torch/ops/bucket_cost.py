"""The bucket -> instance-type cost kernel: build, binding and wrapper.

The kernel (csrc/bucket_cost.cu, CUDA C++ for sm_90a) replaces the JAX
package's fused Pallas kernel (karpenter_tpu/ops/pallas_kernels.py:_kernel).
It is compiled with nvcc into a shared library with a plain C interface at
first use, into the package's _build/ directory (ops/_cuda_build.py), and
called through ctypes on PyTorch's current stream.

`bucket_cost_packed` takes the plain version (ops/feasibility.py) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises. `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._cuda_build import KernelLibrary
from .feasibility import bucket_type_cost_packed

MAX_R = 8  # the kernel is instantiated for R = 1..8

LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bucket_cost_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.bucket_cost_launch.restype = ci


LIBRARY = KernelLibrary("bucket_cost", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build


def load_catalog(caps: np.ndarray, prices: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoded catalog as the kernel's resident inputs: caps [T, R] (the
    encoding's capacities minus daemon overhead) and prices [T], both f32,
    contiguous, on `device`."""
    caps_t = torch.from_numpy(np.ascontiguousarray(caps, dtype=np.float32)).to(device)
    prices_t = torch.from_numpy(np.ascontiguousarray(prices, dtype=np.float32)).to(device)
    return caps_t, prices_t


def bucket_cost_packed(stats: torch.Tensor, caps: torch.Tensor, prices: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """stats [2, B, R] f32, caps [T, R] f32, prices [T] f32, allowed [B, T]
    bool -> packed int32 [3, B] = (tstar, bins, feasible), as
    ops/feasibility.py:bucket_type_cost_packed computes it."""
    global LAUNCHES
    tensors = (stats, caps, prices, allowed)
    if all(t.device.type == "cpu" for t in tensors):
        return bucket_type_cost_packed(stats, caps, prices, allowed)
    device = stats.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"bucket_cost_packed: inputs on {[str(t.device) for t in tensors]}; want one CUDA device")
    if stats.dim() != 3 or stats.shape[0] != 2:
        raise ValueError(f"stats must be [2, B, R], got {tuple(stats.shape)}")
    _, B, R = stats.shape
    T = caps.shape[0]
    if caps.shape != (T, R) or prices.shape != (T,) or allowed.shape != (B, T):
        raise ValueError(
            f"shape mismatch: caps {tuple(caps.shape)}, prices {tuple(prices.shape)}, allowed {tuple(allowed.shape)}"
            f" for B={B}, R={R}"
        )
    if not 1 <= R <= MAX_R or T < 1:
        raise ValueError(f"kernel takes 1 <= R <= {MAX_R} and T >= 1, got R={R}, T={T}")
    for name, t, dtype in (("stats", stats, torch.float32), ("caps", caps, torch.float32), ("prices", prices, torch.float32), ("allowed", allowed, torch.bool)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype} (contiguous={t.is_contiguous()})")
    lib = LIBRARY.load()
    out = torch.empty((3, B), dtype=torch.int32, device=device)
    if B == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bucket_cost_launch(
            stats.data_ptr(), caps.data_ptr(), prices.data_ptr(), allowed.data_ptr(), out.data_ptr(), B, T, R, stream
        )
    if err != 0:
        raise RuntimeError(f"bucket_cost kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
