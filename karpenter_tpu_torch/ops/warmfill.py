"""The warm-fill admission surface: plain version, exact oracle and kernel wrapper.

For every distinct pod size class s in a batch and every existing node v,
an upper bound on how many pods of size s fit in v's residual headroom: the
closed form the certified cohort fast path evaluates per (run, view) pair
(scheduler/existingnode.py:add_certified_view_run), lifted to one [S, V]
surface.

Numerics contract (the JAX package's ops/warmfill.py): the surface is
computed in f32 with a deliberate upward slack, so its counts are an UPPER
BOUND on the exact f64 closed form `warm_fill_counts_np`. The host scan
(solver/warmfill.py) uses the surface only to prune views that can never
take a size class (a zero is then exact-safe); every placement is
re-derived with exact f64 host arithmetic.

`warm_fill_counts` is the plain torch version and follows the reference's
jnp formula step by step. The Pallas kernel it replaces
(karpenter_tpu/ops/warmfill.py:_kernel) floors a size at 1e-12 where the jnp
path substitutes 1 for a zero size; the two differ only for sizes in
(0, 1e-12), which no resource quantity takes, and this module follows the
jnp form. `warm_fill_counts_device` is the wrapper of the hand-written CUDA
kernel (csrc/warm_fill.cu): it takes the plain version only for tensors that
lie on the CPU; for CUDA tensors it launches the kernel or raises.
`AdmissionSurface` is the warm solve's round trip through the same kernel
on a CUDA device: the inputs up, the launch and the counts back in the one
call into the kernel's library (`_launch`) that the wrapper also makes.
Under the incremental engine the head is already resident on the card
(`AdmissionSurface.counts_resident`): only the sizes go up. `LAUNCHES`
counts the kernel's launches there.
"""

from __future__ import annotations

import ctypes
import time
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ._cuda_build import KernelLibrary

# relative slack applied on the device so f32 rounding can only round the
# count UP vs the exact f64 closed form (f32 rel. error ~1.2e-7 per operand)
_SLACK = 4e-6
# the f32 constants, each an exact f32 value held in a Python float: 1 + s
# and 1 - s are f32 sums, as jnp.float32(1.0) + slack computes them
_F32_SLACK = float(np.float32(_SLACK))
_ONE_PLUS = float(np.float32(1.0) + np.float32(_SLACK))
_ONE_MINUS = float(np.float32(1.0) - np.float32(_SLACK))
_EPS = float(np.float32(1e-12))
_BIG = float(2**30)

MAX_R = 8  # the kernel is instantiated for R = 1..8

LAUNCHES = 0


def warm_fill_counts_np(sizes: np.ndarray, head: np.ndarray) -> np.ndarray:
    """Exact f64 reference: [S, V] int32 closed-form counts.

    sizes: [S, R] f64 per-size-class request vectors; head: [V, R] f64
    residual headroom (available + tolerance - requests). A view whose
    headroom is negative on ANY resource takes nothing (the certified run's
    base-fits gate); a size's count is the min over its positive resources
    of floor(head / size)."""
    base_ok = (head >= 0).all(axis=1)  # [V]
    positive = sizes > 0  # [S, R]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = head[None, :, :] / np.where(positive, sizes, 1.0)[:, None, :]  # [S, V, R]
    ratio = np.where(positive[:, None, :], ratio, np.inf)
    counts = np.floor(ratio.min(axis=2))
    counts = np.where(np.isfinite(counts), counts, float(np.iinfo(np.int32).max))
    counts = np.clip(counts, 0, np.iinfo(np.int32).max)
    return (counts * base_ok[None, :]).astype(np.int32)


def warm_fill_counts(sizes: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Plain version: [S, V] int32 upper-bound counts on f32 sizes [S, R] and
    head [V, R], in the reference jnp path's order of operations."""
    base_ok = (head >= -_EPS).all(dim=1)  # [V]
    positive = sizes > 0  # [S, R]
    slack_head = head * _ONE_PLUS + _F32_SLACK
    safe_sizes = torch.where(positive, sizes, 1.0) * _ONE_MINUS
    ratio = slack_head[None, :, :] / safe_sizes[:, None, :]  # [S, V, R]
    ratio = torch.where(positive[:, None, :], ratio, _BIG)
    counts = torch.floor(ratio.amin(dim=2))
    counts = torch.clamp(counts, 0.0, _BIG)
    return (counts * base_ok[None, :].to(counts.dtype)).to(torch.int32)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.warm_fill_launch.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.warm_fill_launch.restype = ci
    lib.warm_fill_wait.argtypes = [vp]
    lib.warm_fill_wait.restype = ci


LIBRARY = KernelLibrary("warm_fill", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build


def _launch(device, S: int, V: int, R: int, sizes: int, head: int, out: int, staged=None, landed=None, staged_head=True) -> int:
    """The one call into the kernel's library, on `device`'s current stream:
    sizes [S, R], head [V, R] and out [S, V] are device pointers; `staged`
    (pinned host) is first copied up: sizes then head into one buffer, or
    the sizes alone when `staged_head` is False; out is copied into `landed`
    (pinned host) after the launch, each where given.
    Counts the launch; returns the stream."""
    global LAUNCHES
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.warm_fill_launch(staged, int(staged_head), sizes, head, out, landed, S, V, R, stream)
    if err != 0:
        raise RuntimeError(f"warm_fill kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return stream


def warm_fill_counts_device(sizes: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """sizes [S, R] f32, head [V, R] f32 -> int32 [S, V] upper-bound counts,
    as `warm_fill_counts` computes them."""
    tensors = (sizes, head)
    if all(t.device.type == "cpu" for t in tensors):
        return warm_fill_counts(sizes, head)
    device = sizes.device
    if device.type != "cuda" or head.device != device:
        raise ValueError(f"warm_fill_counts_device: inputs on {[str(t.device) for t in tensors]}; want one CUDA device")
    if sizes.dim() != 2 or head.dim() != 2 or sizes.shape[1] != head.shape[1]:
        raise ValueError(f"want sizes [S, R] and head [V, R], got {tuple(sizes.shape)} and {tuple(head.shape)}")
    S, R = sizes.shape
    V = head.shape[0]
    if not 1 <= R <= MAX_R:
        raise ValueError(f"kernel takes 1 <= R <= {MAX_R}, got R={R}")
    for name, t in (("sizes", sizes), ("head", head)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype} (contiguous={t.is_contiguous()})")
    out = torch.empty((S, V), dtype=torch.int32, device=device)
    if S == 0 or V == 0:
        return out
    _launch(device, S, V, R, sizes.data_ptr(), head.data_ptr(), out.data_ptr())
    return out


class AdmissionSurface:
    """The warm solve's round trip through the kernel on one CUDA device,
    with resident buffers: a pinned staging buffer for sizes and head, their
    device copy, the device counts and a pinned landing buffer for them,
    grown as problems grow.

    `counts` stages both inputs as f32 into the pinned buffer (numpy only),
    then makes the same one call into the kernel's library as
    `warm_fill_counts_device`, here with the upload and the copy back
    enqueued beside the launch, and one more call that waits for the
    stream. Inside a solve the host's caches are cold, and each PyTorch call
    costs tens of microseconds there; this path makes none per solve.
    `counts_resident` is the same round trip against a head that already
    lies on the card: it stages and uploads the sizes only. The array either
    returns is a view of the landing buffer, valid until the next call: the
    caller reads it at once."""

    def __init__(self, device):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"AdmissionSurface runs on a CUDA device, got {self.device}")
        self._staged = self._inputs = self._counts = self._landed = None

    def _reserve(self, n_in: int, n_out: int) -> None:
        if self._staged is None or self._staged.numel() < n_in:
            self._staged = torch.empty((n_in,), dtype=torch.float32, pin_memory=True)
            self._staged_np = self._staged.numpy()
            self._inputs = torch.empty((n_in,), dtype=torch.float32, device=self.device)
        if self._counts is None or self._counts.numel() < n_out:
            self._counts = torch.empty((n_out,), dtype=torch.int32, device=self.device)
            self._landed = torch.empty((n_out,), dtype=torch.int32, pin_memory=True)
            self._landed_np = self._landed.numpy()

    def counts(self, sizes: np.ndarray, head: np.ndarray) -> Tuple[np.ndarray, Tuple[float, float, float]]:
        """sizes [S, R] and head [V, R] (host arrays, cast to f32) -> the
        int32 [S, V] counts `warm_fill_counts` computes, and the host seconds
        of the three parts: staging, the enqueue call, the wait."""
        S, R = sizes.shape
        V = head.shape[0]
        if head.ndim != 2 or head.shape[1] != R or not 1 <= R <= MAX_R or S < 1 or V < 1:
            raise ValueError(f"want sizes [S, R] and head [V, R] with S, V >= 1 and 1 <= R <= {MAX_R}, got {sizes.shape} and {head.shape}")
        t0 = time.perf_counter()
        n_in = (S + V) * R
        self._reserve(n_in, S * V)
        self._staged_np[: S * R] = sizes.ravel()
        self._staged_np[S * R : n_in] = head.ravel()
        return self._trip(S, V, R, self._inputs.data_ptr() + S * R * 4, True, t0)

    def counts_resident(self, sizes: np.ndarray, head: torch.Tensor, V: int) -> Tuple[np.ndarray, Tuple[float, float, float]]:
        """sizes [S, R] (host array, cast to f32) and the first V rows of a
        resident [Vp, R] f32 buffer on this device -> the int32 [S, V] counts
        and the host seconds of staging, enqueue and wait, as `counts`. The
        kernel reads the V rows in place: they are contiguous, and the pad
        rows past them are never read."""
        S, R = sizes.shape
        if head.device != self.device or head.dtype != torch.float32 or not head.is_contiguous():
            raise ValueError(f"want a contiguous float32 head on {self.device}, got {head.dtype} on {head.device}")
        if head.dim() != 2 or head.shape[1] != R or not 1 <= V <= head.shape[0] or not 1 <= R <= MAX_R or S < 1:
            raise ValueError(f"want sizes [S, R] and head [>= V, R] with S, V >= 1 and 1 <= R <= {MAX_R}, got {sizes.shape}, {tuple(head.shape)} and V={V}")
        t0 = time.perf_counter()
        self._reserve(S * R, S * V)
        self._staged_np[: S * R] = sizes.ravel()
        return self._trip(S, V, R, head.data_ptr(), False, t0)

    def _trip(self, S: int, V: int, R: int, head: int, staged_head: bool, t0: float):
        """The launch call (upload, kernel, copy back) and the wait, after
        the staging that began at t0."""
        t1 = time.perf_counter()
        stream = _launch(
            self.device, S, V, R, self._inputs.data_ptr(), head, self._counts.data_ptr(),
            staged=self._staged.data_ptr(), landed=self._landed.data_ptr(), staged_head=staged_head,
        )
        t2 = time.perf_counter()
        with torch.cuda.device(self.device):
            err = LIBRARY.load().warm_fill_wait(stream)
        if err != 0:
            raise RuntimeError(f"warm_fill round trip failed: CUDA error {err}")
        t3 = time.perf_counter()
        return self._landed_np[: S * V].reshape(S, V), (t1 - t0, t2 - t1, t3 - t2)
