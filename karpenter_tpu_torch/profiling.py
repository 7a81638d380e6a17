"""Profiling: host CPU profiles + device traces.

The pprof analog (reference controllers.go:112-114,183-202 exposes Go pprof
behind --enable-profiling; the benchmark harness writes CPU/heap profiles,
scheduling_benchmark_test.go:79-90). Here:

- :func:`host_profile` — cProfile a block (a provisioning round, a solve)
  and dump a .prof file readable by ``pstats``/``snakeviz``.
- :func:`device_trace` — a torch.profiler trace of the block, with CPU
  activity and, where a card is present, CUDA activity: every kernel the
  block launched on the card (K1's `bucket_cost_kernel`, K2's
  `warm_fill_kernel`, PyTorch's own) by its symbol, with its device time.
  Written as a Chrome trace (`trace.json`, chrome://tracing or Perfetto)
  under the given directory.
- env seam ``KARPENTER_TPU_PROFILE_DIR``: when set (and profiling enabled
  via Options), Runtime.provision_once wraps every round with both.

The port's copy of karpenter_tpu/profiling.py. The reference's device trace
degrades to a no-op when its profiler cannot start; the port's raises
instead (ROADMAP C, no fail-open around the card): a trace that was asked
for and not taken is a failure, not a warning.
"""

from __future__ import annotations

import cProfile
import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator, Optional

from .logsetup import get_logger

log = get_logger("profiling")

ENV_DIR = "KARPENTER_TPU_PROFILE_DIR"


@contextmanager
def host_profile(out_path: os.PathLike) -> Iterator[cProfile.Profile]:
    """cProfile the enclosed block; stats land at out_path (.prof)."""
    profiler = cProfile.Profile()
    profiler.enable()
    try:
        yield profiler
    finally:
        profiler.disable()
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        profiler.dump_stats(str(out))
        log.info("host profile written to %s", out)


TRACE_FILE = "trace.json"


@contextmanager
def device_trace(out_dir: os.PathLike) -> Iterator[None]:
    """torch.profiler trace of the block, written to out_dir/trace.json.

    CPU activity always; CUDA activity when a card is present, in which
    case the card is synchronized before the profiler stops so every kernel
    the block launched is in the trace. A profiler that cannot start or
    stop raises.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))
    log.info("device trace written to %s", out / TRACE_FILE)


def profile_dir() -> Optional[Path]:
    """The env-configured profile output directory, if any."""
    value = os.environ.get(ENV_DIR)
    return Path(value) if value else None


@contextmanager
def maybe_profile_round(enabled: bool, tag: str = "round") -> Iterator[None]:
    """Wrap one provisioning round with host+device profiling when enabled
    and KARPENTER_TPU_PROFILE_DIR is set; no-op otherwise."""
    directory = profile_dir() if enabled else None
    if directory is None:
        yield
        return
    stamp = f"{tag}-{time.strftime('%Y%m%d-%H%M%S')}-{time.monotonic_ns() % 10**9:09d}-{os.getpid()}"
    with host_profile(directory / f"{stamp}.prof"):
        with device_trace(directory / f"{stamp}-device"):
            yield


class LiveProfiler:
    """On-demand profiling over the metrics port — the live half of the
    pprof analog (controllers.go:183-202 serves /debug/pprof/* behind
    --enable-profiling). Per-round artifacts (maybe_profile_round) cover
    offline analysis; these routes profile a RUNNING process, so a live
    latency regression can be inspected without a restart:

      /debug/pprof/            index
      /debug/pprof/profile     ?seconds=N (default 1, cap 60): statistical
                               wall-clock sampler over sys._current_frames()
                               across ALL threads; returns collapsed-stack
                               text (flamegraph.pl / speedscope compatible)
      /debug/pprof/heap        tracemalloc top allocations (tracing starts
                               on the first call; the first response is the
                               baseline)
      /debug/pprof/trace       ?seconds=N: device trace (torch.profiler,
                               Chrome format) written under the profile
                               dir; returns the path

    One profile/trace at a time (a lock rejects concurrent captures), and
    the sampler excludes its own serving thread.
    """

    MAX_SECONDS = 60.0
    SAMPLE_INTERVAL = 0.005

    def __init__(self, directory: Optional[os.PathLike] = None):
        import threading

        self._capture_lock = threading.Lock()
        self._dir = Path(directory) if directory else (profile_dir() or Path("profiles"))

    def routes(self) -> dict:
        return {
            "/debug/pprof/": self.index,
            "/debug/pprof/profile": self.profile,
            "/debug/pprof/heap": self.heap,
            "/debug/pprof/trace": self.trace,
        }

    @staticmethod
    def route_descriptions() -> dict:
        """/debug-index descriptions, keyed like routes() (see tracing.py)."""
        return {
            "/debug/pprof/": "live profiling index",
            "/debug/pprof/profile": "statistical host CPU profile (?seconds=N, collapsed stacks)",
            "/debug/pprof/heap": "tracemalloc top allocations",
            "/debug/pprof/trace": "device trace (?seconds=N, torch.profiler Chrome trace)",
        }

    @staticmethod
    def _seconds(query: dict, default: float = 1.0) -> float:
        try:
            value = float(query.get("seconds", [default])[0])
        except (TypeError, ValueError):
            value = default
        return max(0.05, min(value, LiveProfiler.MAX_SECONDS))

    def index(self, query=None):
        body = "live profiling endpoints:\n  /debug/pprof/profile?seconds=N\n  /debug/pprof/heap\n  /debug/pprof/trace?seconds=N\n"
        return True, "text/plain; charset=utf-8", body

    def profile(self, query=None):
        import sys
        import threading

        if not self._capture_lock.acquire(blocking=False):
            return False, "text/plain; charset=utf-8", "a capture is already running\n"
        try:
            seconds = self._seconds(query or {})
            me = threading.get_ident()
            samples: dict = {}
            total = 0
            deadline = time.monotonic() + seconds
            while time.monotonic() < deadline:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = []
                    f = frame
                    while f is not None and len(stack) < 64:
                        code = f.f_code
                        stack.append(f"{Path(code.co_filename).name}:{code.co_name}")
                        f = f.f_back
                    key = tuple(reversed(stack))
                    samples[key] = samples.get(key, 0) + 1
                total += 1
                time.sleep(self.SAMPLE_INTERVAL)
            lines = [f"{';'.join(stack)} {n}" for stack, n in sorted(samples.items(), key=lambda kv: -kv[1])]
            header = f"# wall-clock samples over {seconds:.2f}s ({total} sweeps, {self.SAMPLE_INTERVAL * 1000:.0f}ms interval), collapsed-stack format\n"
            return True, "text/plain; charset=utf-8", header + "\n".join(lines) + "\n"
        finally:
            self._capture_lock.release()

    def heap(self, query=None):
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return True, "text/plain; charset=utf-8", "tracemalloc started; this response is the baseline — call again for allocations\n"
        snapshot = tracemalloc.take_snapshot()
        stats = snapshot.statistics("lineno")[:30]
        lines = [f"{stat.size / 1024:.1f} KiB in {stat.count} blocks: {stat.traceback}" for stat in stats]
        return True, "text/plain; charset=utf-8", "\n".join(lines) + "\n"

    def trace(self, query=None):
        if not self._capture_lock.acquire(blocking=False):
            return False, "text/plain; charset=utf-8", "a capture is already running\n"
        try:
            seconds = self._seconds(query or {})
            out = self._dir / f"live-trace-{time.strftime('%Y%m%d-%H%M%S')}"
            with device_trace(out):
                time.sleep(seconds)
            return True, "text/plain; charset=utf-8", f"device trace written to {out}\n"
        finally:
            self._capture_lock.release()
