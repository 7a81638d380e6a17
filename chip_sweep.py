"""The measurements behind the port's kernel designs, on one CUDA card.

    python3 chip_sweep.py

Run from the repository root on an NVIDIA H100 (sm_90a) with the CUDA
toolkit. The kernels' launch geometries are constants of their sources
(karpenter_tpu_torch/csrc/), and the warm solve's round trip through K2 is
one call into its library; this script measures the alternatives they were
chosen from. It compiles each kernel source into a library of its own,
together with a few lines that launch it with an explicit geometry (and,
for K2, a variant that stages each chunk's size rows in shared memory),
and prints one JSON object per phase:

  - k1_geometry: K1's device time per block size at B = 30 (one block per
    bucket), and per block size x blocks per SM at B = 2048;
  - k2_geometry: K2's device time per node tile x size-class chunk at
    (30, 2400), (300, 2400) and (30, 20000), for the kernel as it is (size
    rows in registers) and for the shared-memory variant;
  - fill_round_trip: K2's round trip at the repack solve's (30, 2400, 8)
    three ways: "pageable" (two pageable uploads, the wrapper, a blocking
    pageable copy back), "pinned_torch" (one pinned staging buffer and a
    pinned copy back behind an event, all through PyTorch calls) and
    "surface" (ops/warmfill.py:AdmissionSurface, as the solve runs it);
    back to back ("warm") and after reading COLD_BYTES of host memory
    before each call ("cold", as a solve's host work leaves the caches);
    host clock per part, and the pageable one also split on the card by
    CUDA events.

Every geometry, variant and round trip is held against the plain version
bit for bit; a mismatch exits non-zero. Each phase's default is the
geometry the kernel launches with. The last line is the card's name and
power limit. Device times come from torch.profiler, as in chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as smoke

R = 8
K1_THREADS = (64, 128, 256, 512)
K1_BLOCK_SHAPES = [(30, 500), (30, 2000)]  # B below the SM count: block size alone
K1_GRID_SHAPES = [(2048, 500), (2048, 2000)]  # block size x blocks per SM
K1_BLOCKS_PER_SM = (2, 4, 8, 16)
K2_SHAPES = [(30, 2400), (300, 2400), (30, 20000)]
K2_TILES, K2_CHUNKS = (64, 128, 256, 512), (1, 2, 4)
ROUND_TRIP_SHAPE = (30, 2400, R)  # the repack solve's
ITERS, ROUND_TRIP_ITERS = 50, 50
COLD_BYTES = 64 << 20

# appended to csrc/bucket_cost.cu: its launch with an explicit geometry, and
# the default geometry it picks
K1_SHIM = """
extern "C" int bucket_cost_sweep(const void* stats, const void* caps, const void* prices, const void* allowed,
                                 void* out, int B, int T, int R, int threads, int blocks, void* stream) {
    return launch_r(stats, caps, prices, allowed, out, B, T, R, Geometry{threads, blocks}, stream);
}

extern "C" int bucket_cost_sweep_default(int B, int T, int* geometry) {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const Geometry g = default_geometry(B, T, sms);
    geometry[0] = g.threads;
    geometry[1] = g.blocks;
    return cudaSuccess;
}
"""

# appended to csrc/warm_fill.cu: its launch with an explicit node tile and
# size-class chunk, the default chunk, and the design the kernel did not
# take: each block stages its chunk's size rows in shared memory as
# `positive` and `safe`, computed once per block behind a barrier (the same
# rounded f32 operations, so the same counts)
K2_SHIM = """
namespace {

template <int R>
__global__ void __launch_bounds__(kMaxTile)
    warm_fill_smem_kernel(const float* __restrict__ sizes, const float* __restrict__ head, int* __restrict__ out,
                          int S, int V, int chunk) {
    __shared__ float safe[kMaxChunk][R];
    __shared__ bool positive[kMaxChunk][R];
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    const int s0 = blockIdx.y * chunk;
    const int n = S - s0 < chunk ? S - s0 : chunk;
    const float eps = 1e-12f;
    const float big = 1073741824.0f;
    const float slack = 4e-6f;
    const float one_plus = __fadd_rn(1.0f, slack);
    const float one_minus = __fadd_rn(1.0f, -slack);
    if (threadIdx.x < n * R) {
        const int i = threadIdx.x / R, r = threadIdx.x % R;
        const float z = sizes[(size_t)(s0 + i) * R + r];
        positive[i][r] = z > 0.0f;
        safe[i][r] = __fmul_rn(z > 0.0f ? z : 1.0f, one_minus);
    }
    __syncthreads();
    if (v >= V) return;
    float h[R];
    load_row<R, false>(head + (size_t)v * R, h);
    bool base_ok = true;
    float slack_head[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        base_ok = base_ok && (h[r] >= -eps);
        slack_head[r] = __fadd_rn(__fmul_rn(h[r], one_plus), slack);
    }
    for (int i = 0; i < n; ++i) {
        float count = big;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float ratio = positive[i][r] ? __fdiv_rn(slack_head[r], safe[i][r]) : big;
            count = fminf(count, ratio);
        }
        count = fminf(fmaxf(floorf(count), 0.0f), big);
        out[(size_t)(s0 + i) * V + v] = base_ok ? (int)count : 0;
    }
}

template <int R>
int launch_smem(const float* sizes, const float* head, int* out, int S, int V, int tile, int chunk,
                cudaStream_t stream) {
    const dim3 grid((unsigned)((V + tile - 1) / tile), (unsigned)((S + chunk - 1) / chunk));
    warm_fill_smem_kernel<R><<<grid, tile, 0, stream>>>(sizes, head, out, S, V, chunk);
    return cudaGetLastError();
}

}  // namespace

extern "C" int warm_fill_sweep(const void* sizes, const void* head, void* out, int S, int V, int R, int tile,
                               int chunk, int smem, void* stream) {
    if (!smem) return launch_r(sizes, head, out, S, V, R, tile, chunk, stream);
    if (S <= 0 || V <= 0) return cudaSuccess;
    if (tile < 32 || tile > kMaxTile || tile % 32 != 0 || chunk < 1 || chunk > kMaxChunk || R != 8) {
        return cudaErrorInvalidValue;
    }
    return launch_smem<8>(static_cast<const float*>(sizes), static_cast<const float*>(head), static_cast<int*>(out),
                          S, V, tile, chunk, static_cast<cudaStream_t>(stream));
}

extern "C" int warm_fill_sweep_default_chunk(int S, int V, int* chunk) {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    *chunk = default_chunk(S, V, sms);
    return cudaSuccess;
}
"""


def shim_library(name: str, kernel_source, text: str, bind):
    """A library built from `kernel_source` with `text` appended, its source
    written into the package's build directory."""
    from karpenter_tpu_torch.ops._cuda_build import BUILD_DIR, KernelLibrary

    lib = KernelLibrary(name, bind)
    lib.source = BUILD_DIR / f"{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(f'#include "{kernel_source}"\n{text}')
    return lib


def _bind_k1(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bucket_cost_sweep.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.bucket_cost_sweep.restype = ci
    lib.bucket_cost_sweep_default.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.bucket_cost_sweep_default.restype = ci


def _bind_k2(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.warm_fill_sweep.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.warm_fill_sweep.restype = ci
    lib.warm_fill_sweep_default_chunk.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.warm_fill_sweep_default_chunk.restype = ci


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.ops import bucket_cost, warmfill
        from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
        from karpenter_tpu_torch.ops.warmfill import warm_fill_counts
    except ImportError as exc:
        print(f"chip_sweep: the karpenter_tpu_torch package is not importable here: {exc}", file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device("cuda")
    k1_lib = shim_library("sweep_bucket_cost", bucket_cost.SOURCE, K1_SHIM, _bind_k1)
    k2_lib = shim_library("sweep_warm_fill", warmfill.SOURCE, K2_SHIM, _bind_k2)
    smoke.build_kernels([k1_lib, k2_lib, warmfill.LIBRARY])
    k1, k2 = k1_lib.load(), k2_lib.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def k1_launch(threads, blocks, stats, caps, prices, allowed):
        _, B, R_ = stats.shape
        out = torch.empty((3, B), dtype=torch.int32, device=dev)
        ptrs = (stats.data_ptr(), caps.data_ptr(), prices.data_ptr(), allowed.data_ptr(), out.data_ptr())
        err = k1.bucket_cost_sweep(*ptrs, B, caps.shape[0], R_, threads, blocks, stream())
        smoke.check(err == 0, f"K1 launch at {threads} threads x {blocks} blocks failed: CUDA error {err}")
        return out

    def k2_launch(tile, chunk, smem, sizes, head):
        (S, R_), V = sizes.shape, head.shape[0]
        out = torch.empty((S, V), dtype=torch.int32, device=dev)
        err = k2.warm_fill_sweep(sizes.data_ptr(), head.data_ptr(), out.data_ptr(), S, V, R_, tile, chunk, int(smem), stream())
        smoke.check(err == 0, f"K2 launch at tile {tile} x chunk {chunk} (smem={smem}) failed: CUDA error {err}")
        return out

    def k1_default(B, T):
        g = (ctypes.c_int * 2)()
        smoke.check(k1.bucket_cost_sweep_default(B, T, g) == 0, "K1's default geometry query failed")
        return [g[0], g[1]]

    def k2_default(S, V):
        c = ctypes.c_int()
        smoke.check(k2.warm_fill_sweep_default_chunk(S, V, ctypes.byref(c)) == 0, "K2's default chunk query failed")
        return c.value

    # 1. K1: block size where each bucket has a block of its own, then block
    # size x blocks per SM where the buckets outnumber the SMs
    configs = [(B, T, th, B) for B, T in K1_BLOCK_SHAPES for th in K1_THREADS]
    configs += [(B, T, th, min(B, k * sms)) for B, T in K1_GRID_SHAPES for th in K1_THREADS for k in K1_BLOCKS_PER_SM]
    inputs, fns, bad = {}, [], []
    for B, T, th, bl in configs:
        if (B, T) not in inputs:
            arrays = testing.bucket_cost_problem(np.random.default_rng(B * 7 + T), B, T, R)
            inputs[B, T] = [torch.from_numpy(a).to(dev) for a in arrays]
        fn = functools.partial(k1_launch, th, bl)
        if not smoke.compare(fn, bucket_type_cost_packed, inputs[B, T])[0]:
            bad.append([B, T, th, bl])
        fns.append(functools.partial(fn, *inputs[B, T]))
    times, why = smoke.profiled_series(fns, ITERS, "bucket_cost_kernel")
    smoke.emit({
        "phase": "k1_geometry",
        "sms": sms,
        "defaults": {f"{B}x{T}": k1_default(B, T) for B, T in inputs},
        "runs": [{"shape": [B, T, R], "threads": th, "blocks": bl, "device_ms": ms} for (B, T, th, bl), ms in zip(configs, times)],
        "mismatches": bad,
        "device_ms_missing": why or None,
    })
    smoke.check(not bad, f"K1 disagrees with its plain version under the geometries {bad}")

    # 2. K2: node tile x size-class chunk, size rows in registers (the
    # kernel) or in shared memory (the variant)
    configs = [(shape, smem, tile, chunk) for shape in K2_SHAPES for smem in (False, True) for tile in K2_TILES for chunk in K2_CHUNKS]
    inputs, fns, bad = {}, [], []
    for S, V in K2_SHAPES:
        arrays = testing.warm_fill_surface(np.random.default_rng(S * 7 + V), S, V, R)
        inputs[S, V] = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]
    for shape, smem, tile, chunk in configs:
        fn = functools.partial(k2_launch, tile, chunk, smem)
        if not smoke.compare(fn, warm_fill_counts, inputs[shape])[0]:
            bad.append([*shape, "shared" if smem else "registers", tile, chunk])
        fns.append(functools.partial(fn, *inputs[shape]))
    times, why = smoke.profiled_series(fns, ITERS, "warm_fill")
    smoke.emit({
        "phase": "k2_geometry",
        "defaults": {f"{S}x{V}": [128, k2_default(S, V)] for S, V in K2_SHAPES},
        "runs": [
            {"shape": [*shape, R], "sizes_in": "shared" if smem else "registers", "tile": tile, "chunk": chunk, "device_ms": ms}
            for (shape, smem, tile, chunk), ms in zip(configs, times)
        ],
        "mismatches": bad,
        "device_ms_missing": why or None,
    })
    smoke.check(not bad, f"K2 disagrees with its plain version under {bad}")

    # 3. K2's round trip three ways, in turns, warm and cold
    S, V, R2 = ROUND_TRIP_SHAPE
    sizes_np, head_np = testing.warm_fill_surface(np.random.default_rng(S * 7 + V), S, V, R2)
    want = warm_fill_counts(*(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (sizes_np, head_np))).cpu().numpy()
    wrapper = warmfill.warm_fill_counts_device

    def pageable_round_trip(events=None):
        t0 = time.perf_counter()
        if events:
            events[0].record()
        sizes_dev = torch.from_numpy(sizes_np.astype(np.float32)).to(dev)
        head_dev = torch.from_numpy(head_np.astype(np.float32)).to(dev)
        t1 = time.perf_counter()
        if events:
            events[1].record()
        out = wrapper(sizes_dev, head_dev)
        t2 = time.perf_counter()
        if events:
            events[2].record()
        counts = out.cpu().numpy()
        if events:
            events[3].record()
        return counts, (t1 - t0, t2 - t1, time.perf_counter() - t2)

    def pinned_torch_round_trip():
        t0 = time.perf_counter()
        staged = torch.empty(((S + V) * R2,), dtype=torch.float32, pin_memory=True)
        flat = staged.numpy()
        flat[: S * R2] = sizes_np.ravel()
        flat[S * R2 :] = head_np.ravel()
        inputs_dev = staged.to(dev, non_blocking=True)
        t1 = time.perf_counter()
        out = wrapper(inputs_dev[: S * R2].view(S, R2), inputs_dev[S * R2 :].view(V, R2))
        t2 = time.perf_counter()
        landed = torch.empty((S, V), dtype=torch.int32, pin_memory=True)
        landed.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        return landed.numpy(), (t1 - t0, t2 - t1, time.perf_counter() - t2)

    surface = warmfill.AdmissionSurface(dev)
    variants = {
        "pageable": pageable_round_trip,
        "pinned_torch": pinned_torch_round_trip,
        "surface": lambda: surface.counts(sizes_np, head_np),
    }
    part_names = {"pageable": ("upload", "launch", "readback"), "pinned_torch": ("upload", "launch", "readback"), "surface": ("stage", "enqueue", "wait")}
    cold = np.ones(COLD_BYTES // 8)
    parts = {(cond, k): [] for cond in ("warm", "cold") for k in variants}
    same = True
    for cond in ("warm", "cold"):
        for i in range(ROUND_TRIP_ITERS + 3):
            order = list(variants) if i % 2 else list(variants)[::-1]
            for key in order:
                if cond == "cold":
                    cold.sum()
                t0 = time.perf_counter()
                counts, p = variants[key]()
                total = time.perf_counter() - t0
                same = same and np.array_equal(counts, want)
                if i >= 3:
                    parts[cond, key].append((total, *p))
    split = []
    for _ in range(ROUND_TRIP_ITERS):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        pageable_round_trip(events)
        events[3].synchronize()
        split.append([events[j].elapsed_time(events[j + 1]) for j in range(3)])

    line = {"phase": "fill_round_trip", "shape": [S, V, R2], "iters": ROUND_TRIP_ITERS, "cold_bytes": COLD_BYTES}
    for (cond, key), rows in parts.items():
        entry = {"ms": statistics.median(r[0] for r in rows) * 1e3}
        entry.update({f"{n}_ms": statistics.median(r[j + 1] for r in rows) * 1e3 for j, n in enumerate(part_names[key])})
        line.setdefault(cond, {})[key] = entry
    line["pageable_device_split_ms"] = {
        part: statistics.median(r[j] for r in split) for j, part in enumerate(("upload", "kernel", "readback"))
    }
    line["counts_equal"] = same
    smoke.emit(line)
    smoke.check(same, "a K2 round trip returned other counts than the plain version")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.PhaseFailed as exc:
        print(f"chip_sweep: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
