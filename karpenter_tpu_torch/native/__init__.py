"""Native host core: C++ packing engine with on-demand build + ctypes ABI.

The reference's scheduler hot loop is pure Go compiled to native code
(SURVEY.md §2.9 — the compiled role in our build is split between XLA device
kernels and this host core). The packing engine (the per-bucket FFD pack and
the P-scale bin-id expansion of solver/pack_counts.py) is the host-side hot
path that benefits; Python remains the always-available fallback so the
framework works without a toolchain.

Build model: a single translation unit compiled lazily with g++ into
_build/libpackcore.so.
No pybind11 in this image — the ABI is plain C, loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ABI_VERSION = 2

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "csrc" / "packcore.cpp"
_BUILD_DIR = _HERE / "_build"
_LIB = _BUILD_DIR / "libpackcore.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> bool:
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False  # read-only install: stay on the pure-Python path
    # compile to a unique temp path, then atomically rename into place:
    # concurrent cold-starting processes may race this build, and a rebuild
    # must never truncate a .so another live process has mapped
    tmp = _BUILD_DIR / f".libpackcore.{os.getpid()}.tmp.so"
    cmd = [
        "g++",
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        str(_SRC),
        "-o",
        str(tmp),
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            print(f"packcore build failed:\n{proc.stderr}", file=sys.stderr)
            return False
        os.replace(tmp, _LIB)
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.packcore_abi_version.restype = i64
    lib.packcore_abi_version.argtypes = []
    lib.pack_assign.restype = i64
    lib.pack_assign.argtypes = [f64p, i64p, i64, i64, i64p, i64, f64p, i64, i64p, i64p]
    lib.pack_dedicated.restype = i64
    lib.pack_dedicated.argtypes = [f64p, i64, i64, f64p, i64, i64p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The bound library, building it on first use; None when unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("KARPENTER_TPU_NO_NATIVE"):
            return None
        needs_build = not _LIB.exists() or (_SRC.exists() and _SRC.stat().st_mtime > _LIB.stat().st_mtime)
        if needs_build and not _compile():
            return None
        try:
            lib = _bind(ctypes.CDLL(str(_LIB)))
        except OSError:
            return None
        if lib.packcore_abi_version() != _ABI_VERSION:
            # stale artifact from an older source tree: rebuild once
            if not _compile():
                return None
            try:
                lib = _bind(ctypes.CDLL(str(_LIB)))
            except OSError:
                return None
            if lib.packcore_abi_version() != _ABI_VERSION:
                return None
        _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _c64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ci64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def pack_assign(
    unique: np.ndarray, counts: np.ndarray, inverse: np.ndarray, cap: np.ndarray, first_bin_id: int
) -> Optional[Tuple[np.ndarray, int, np.ndarray]]:
    """Native pack_counts+assign_bins. Returns (bin_of_item, next_bin_id,
    unplaced) or None when the native core is unavailable."""
    lib = load()
    if lib is None:
        return None
    unique = np.ascontiguousarray(unique, dtype=np.float64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    inverse = np.ascontiguousarray(inverse, dtype=np.int64)
    cap = np.ascontiguousarray(cap, dtype=np.float64)
    U, R = unique.shape
    P = len(inverse)
    bin_of_item = np.empty((P,), dtype=np.int64)
    unplaced = np.empty((U,), dtype=np.int64)
    next_bin = lib.pack_assign(
        _c64(unique), _ci64(counts), U, R, _ci64(inverse), P, _c64(cap), first_bin_id, _ci64(bin_of_item), _ci64(unplaced)
    )
    if next_bin < 0:
        return None
    return bin_of_item, int(next_bin), unplaced


def pack_dedicated(requests: np.ndarray, cap: np.ndarray, first_bin_id: int) -> Optional[Tuple[np.ndarray, int]]:
    """Native one-pod-per-bin assignment. Returns (bin_of_item, next_bin_id)
    or None when the native core is unavailable."""
    lib = load()
    if lib is None:
        return None
    requests = np.ascontiguousarray(requests, dtype=np.float64)
    cap = np.ascontiguousarray(cap, dtype=np.float64)
    P, R = requests.shape
    bin_of_item = np.empty((P,), dtype=np.int64)
    next_bin = lib.pack_dedicated(_c64(requests), P, R, _c64(cap), first_bin_id, _ci64(bin_of_item))
    if next_bin < 0:
        return None
    return bin_of_item, int(next_bin)
