"""The bucket -> instance-type cost kernel: build, binding and wrapper.

The kernel (csrc/bucket_cost.cu, CUDA C++ for sm_90a) replaces the JAX
package's fused Pallas kernel (karpenter_tpu/ops/pallas_kernels.py:_kernel).
It is compiled with nvcc into a shared library with a plain C interface at
first use, into the package's _build/ directory (ops/_cuda_build.py), and
called through ctypes on PyTorch's current stream.

`bucket_cost_packed` takes the plain version (ops/feasibility.py) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises. Before the launch it consults the fault injector at the "cuda" seam
(solver/faults.py); a launch error names the CUDA error. `LAUNCHES` counts
the kernel's launches.

`bucket_cost_keyed` is the same launch with one more output, each bucket's
winning key, which a mesh needs to combine the winners of its type blocks
(parallel/sharded.py). It follows the same rules, and `KEYED_LAUNCHES`
counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._cuda_build import KernelLibrary
from .feasibility import bucket_type_cost_keyed, bucket_type_cost_packed

MAX_R = 8  # the kernel is instantiated for R = 1..8

LAUNCHES = 0
KEYED_LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bucket_cost_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.bucket_cost_launch.restype = ci
    lib.bucket_cost_keyed_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.bucket_cost_keyed_launch.restype = ci


LIBRARY = KernelLibrary("bucket_cost", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build


def launch_error(err: int) -> RuntimeError:
    """The exception for an error code the kernel's entry point returned,
    naming the CUDA error (solver/faults.py classifies it by that name)."""
    return RuntimeError(f"bucket_cost kernel launch failed: {LIBRARY.describe(err)}")


def load_catalog(caps: np.ndarray, prices: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoded catalog as the kernel's resident inputs: caps [T, R] (the
    encoding's capacities minus daemon overhead) and prices [T], both f32,
    contiguous, on `device`."""
    caps_t = torch.from_numpy(np.ascontiguousarray(caps, dtype=np.float32)).to(device)
    prices_t = torch.from_numpy(np.ascontiguousarray(prices, dtype=np.float32)).to(device)
    return caps_t, prices_t


def _checked(stats: torch.Tensor, caps: torch.Tensor, prices: torch.Tensor, allowed: torch.Tensor, name: str):
    """The launch's (B, T, R) once the operands are checked: one CUDA
    device, the kernel's shapes, types and contiguity."""
    tensors = (stats, caps, prices, allowed)
    device = stats.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: inputs on {[str(t.device) for t in tensors]}; want one CUDA device")
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
    for label, t, dtype in (("stats", stats, torch.float32), ("caps", caps, torch.float32), ("prices", prices, torch.float32), ("allowed", allowed, torch.bool)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous {dtype}, got {t.dtype} (contiguous={t.is_contiguous()})")
    return B, T, R


def _launch(stats: torch.Tensor, caps: torch.Tensor, prices: torch.Tensor, allowed: torch.Tensor, keyed: bool, name: str):
    """One launch of the kernel on checked CUDA operands: (packed [3, B],
    keys [B] or None). Consults the "cuda" fault seam first."""
    B, T, R = _checked(stats, caps, prices, allowed, name)
    lib = LIBRARY.load()
    out = torch.empty((3, B), dtype=torch.int32, device=stats.device)
    key = torch.empty((B,), dtype=torch.float32, device=stats.device) if keyed else None
    if B == 0:
        return out, key
    from ..solver.faults import FAULTS

    FAULTS.check("cuda")
    with torch.cuda.device(stats.device):
        stream = torch.cuda.current_stream(stats.device).cuda_stream
        err = lib.bucket_cost_keyed_launch(
            stats.data_ptr(), caps.data_ptr(), prices.data_ptr(), allowed.data_ptr(), out.data_ptr(),
            key.data_ptr() if keyed else None, B, T, R, stream,
        )
    if err != 0:
        raise launch_error(err)
    return out, key


def bucket_cost_packed(stats: torch.Tensor, caps: torch.Tensor, prices: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """stats [2, B, R] f32, caps [T, R] f32, prices [T] f32, allowed [B, T]
    bool -> packed int32 [3, B] = (tstar, bins, feasible), as
    ops/feasibility.py:bucket_type_cost_packed computes it."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (stats, caps, prices, allowed)):
        return bucket_type_cost_packed(stats, caps, prices, allowed)
    out, _ = _launch(stats, caps, prices, allowed, False, "bucket_cost_packed")
    if out.shape[1]:
        LAUNCHES += 1
    return out


def bucket_cost_keyed(stats: torch.Tensor, caps: torch.Tensor, prices: torch.Tensor, allowed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bucket_cost_packed and each bucket's winning key: (packed int32
    [3, B], key f32 [B], inf where no type is ok), as
    ops/feasibility.py:bucket_type_cost_keyed computes them."""
    global KEYED_LAUNCHES
    if all(t.device.type == "cpu" for t in (stats, caps, prices, allowed)):
        return bucket_type_cost_keyed(stats, caps, prices, allowed)
    out, key = _launch(stats, caps, prices, allowed, True, "bucket_cost_keyed")
    if out.shape[1]:
        KEYED_LAUNCHES += 1
    return out, key
