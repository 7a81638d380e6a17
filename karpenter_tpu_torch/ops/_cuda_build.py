"""nvcc build of the port's CUDA sources, loaded through ctypes.

Each kernel source csrc/<name>.cu exposes a plain C entry point. At first use
it is compiled with nvcc for sm_90a into _build/lib<name>.so inside the
package (git-ignored), and loaded once per process with ctypes. A library
newer than its source is reused. Kernels launch on PyTorch's current stream,
which the wrappers pass in.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


class KernelLibrary:
    """One csrc/<name>.cu: built at first use, loaded once, its C entry
    points typed by `bind(lib)`."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.path = BUILD_DIR / f"lib{name}.so"
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        # nvcc runs in this process: a steady-state window must see none
        self.builds = 0

    def build(self, verbose: bool = False) -> dict:
        """Compile the source when the library is missing or older than it.
        Returns the build's seconds and nvcc's output (with ptxas's register
        report when verbose)."""
        if self.path.exists() and self.path.stat().st_mtime >= self.source.stat().st_mtime:
            return {"seconds": 0.0, "built": False, "log": ""}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a unique path and rename into place: a library another
        # process has mapped is never truncated
        tmp = BUILD_DIR / f".lib{self.name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), str(self.source), "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, self.path)
            self.builds += 1
        finally:
            tmp.unlink(missing_ok=True)
        return {"seconds": time.perf_counter() - t0, "built": True, "log": proc.stdout + proc.stderr}

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(str(self.path))
                self._bind(lib)
                self._lib = lib
        return self._lib
