"""The bucket -> instance-type cost kernel: build, binding and wrapper.

The kernel (csrc/bucket_cost.cu, CUDA C++ for sm_90a) replaces the JAX
package's fused Pallas kernel (karpenter_tpu/ops/pallas_kernels.py:_kernel).
It is compiled with nvcc into a shared library with a plain C interface at
first use, into the package's _build/ directory, and called through ctypes
on PyTorch's current stream.

`bucket_cost_packed` takes the plain version (ops/feasibility.py) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises. `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .feasibility import bucket_type_cost_packed

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bucket_cost.cu"
_BUILD_DIR = _PKG / "_build"
_LIB = _BUILD_DIR / "libbucket_cost.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]
MAX_R = 8  # the kernel is instantiated for R = 1..8

LAUNCHES = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the bucket-cost kernel cannot be built")


def build(verbose: bool = False) -> dict:
    """Compile csrc/bucket_cost.cu into _build/libbucket_cost.so when the
    library is missing or older than its source. Returns the build's seconds
    and nvcc's output (with ptxas's register report when verbose)."""
    if _LIB.exists() and _LIB.stat().st_mtime >= SOURCE.stat().st_mtime:
        return {"seconds": 0.0, "built": False, "log": ""}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a unique path and rename into place: a library another
    # process has mapped is never truncated
    tmp = _BUILD_DIR / f".libbucket_cost.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, _LIB)
    finally:
        tmp.unlink(missing_ok=True)
    return {"seconds": time.perf_counter() - t0, "built": True, "log": proc.stdout + proc.stderr}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_LIB))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.bucket_cost_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
            lib.bucket_cost_launch.restype = ci
            _lib = lib
    return _lib


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
    lib = _load()
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
