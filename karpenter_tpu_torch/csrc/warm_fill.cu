// Warm-fill admission counts on Hopper (sm_90a).
//
// Replaces karpenter_tpu/ops/warmfill.py:_kernel, the Pallas kernel of the
// JAX package. Per pod size class s and existing node v:
//
//   base_ok    = all_r head[v,r] >= -1e-12
//   slack_head = head[v,r] * (1 + 4e-6) + 4e-6
//   safe       = (size[s,r] > 0 ? size[s,r] : 1) * (1 - 4e-6)
//   ratio      = size[s,r] > 0 ? slack_head / safe : 2^30
//   count      = base_ok ? clamp(floor(min_r ratio), 0, 2^30) : 0
//
// written as int32 out[s, v]. The slack makes the count an upper bound on
// the exact f64 closed form, so a zero is exact-safe for pruning.
//
// What bounds it on this card: (S + V) * R * 4 bytes in, S * V * 4 bytes
// out and S * V * R divisions. At the repack solve's (30, 2400, 8) that is
// about 0.0001 ms of the card's memory rate, so the launch itself sets the
// kernel's time (chip_smoke.py measures the floor as the device time of the
// smallest kernel PyTorch launches); what the solve waits on is the round
// trip around it. warm_fill_launch below is the one entry point: it can
// enqueue the upload of the inputs from pinned memory and the copy of the
// counts back in the same call as the launch, which is how the warm solve
// calls it (ops/warmfill.py:AdmissionSurface). Under the incremental engine
// (solver/incremental.py) head is the first V rows of the engine's resident
// [Vp, R] buffer: only the sizes are staged and uploaded, and head never
// crosses the bus. Those V rows are contiguous and the pad rows past them
// are never read.
//
// Design: a 2-D grid of node tiles (kTile nodes, one thread each) by
// size-class chunks (up to kMaxChunk classes). Each thread issues all its
// loads at once, its node's head row and the chunk's size rows (the same
// addresses across the block, served by the cache as a broadcast; 16-byte
// vectors when R is 4 or 8 and the pointers allow it), keeps them in
// registers, computes base_ok and slack_head once for the whole chunk, and
// stores one count per size class; neighbouring threads store neighbouring
// v of one row, so the stores coalesce. No shared memory: chip_sweep.py
// measures this kernel against a variant that stages each chunk's size rows
// (positive and safe, computed once per block) in shared memory behind a
// barrier; the variant was slower at every shape it swept, geometry for
// geometry, but for a tie at 512-node tiles of 4-class chunks on
// (30, 20000) (PERF.md has the numbers). The default chunk is the
// largest of 4, 2 or 1 size classes that still launches kBlocksPerSM
// blocks per SM: a chunk saves loads but lengthens each thread's chain of
// divisions, which pays only where there are blocks enough to hide it
// (chip_sweep.py's node tile x chunk sweep). At the repack's (30, 2400) the
// chunk is 1, 19 x 30 = 570 blocks. The kernel masks its own ragged edge in
// both dimensions: no padding of S or V (the TPU version padded to 8 x 128
// tiles).
//
// Not used, and why: no tensor cores or wgmma (no matrix product: a
// division per cell), no TMA or cp.async (each thread reads (chunk + 1) * R
// floats once; there is nothing to pipeline).
//
// Numerics: every hoisted value is the same individually rounded f32
// operation as in the plain version, only computed once per thread:
// __fmul_rn/__fadd_rn/__fdiv_rn and floorf, built with -fmad=false, so no
// FMA contraction or approximate division moves a count across an
// integer boundary; the kernel equals the plain PyTorch version
// (ops/warmfill.py:warm_fill_counts) bit for bit. The constants 1 +/- 4e-6
// are the f32 sums the plain version uses.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // nodes per block, one thread each
constexpr int kMaxChunk = 4;
// the default chunk is the largest of kMaxChunk, kMaxChunk / 2, ..., 1 size
// classes per block that still launches kBlocksPerSM blocks per SM
constexpr int kBlocksPerSM = 8;
constexpr int kMaxTile = 512;
constexpr int kMaxGridY = 65535;

template <int R, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&x)[R]) {
    if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < R / 4; ++i) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
            x[4 * i] = q.x;
            x[4 * i + 1] = q.y;
            x[4 * i + 2] = q.z;
            x[4 * i + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = __ldg(p + r);
    }
}

template <int R, bool VEC>
__global__ void __launch_bounds__(kMaxTile)
    warm_fill_kernel(const float* __restrict__ sizes, const float* __restrict__ head, int* __restrict__ out, int S,
                     int V, int chunk) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= V) return;
    const int s0 = blockIdx.y * chunk;
    const int n = S - s0 < chunk ? S - s0 : chunk;

    const float eps = 1e-12f;
    const float big = 1073741824.0f;  // 2^30
    const float slack = 4e-6f;
    const float one_plus = __fadd_rn(1.0f, slack);
    const float one_minus = __fadd_rn(1.0f, -slack);

    // every load goes out before the first use: the node's head row and the
    // chunk's size rows (the same addresses for the whole block)
    float h[R];
    float z[kMaxChunk][R];
    load_row<R, VEC>(head + (size_t)v * R, h);
#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
        if (i < n) load_row<R, VEC>(sizes + (size_t)(s0 + i) * R, z[i]);
    }

    bool base_ok = true;
    float slack_head[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        base_ok = base_ok && (h[r] >= -eps);
        slack_head[r] = __fadd_rn(__fmul_rn(h[r], one_plus), slack);
    }

#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
        if (i < n) {
            float count = big;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const bool positive = z[i][r] > 0.0f;
                const float safe = __fmul_rn(positive ? z[i][r] : 1.0f, one_minus);
                const float ratio = positive ? __fdiv_rn(slack_head[r], safe) : big;
                count = fminf(count, ratio);
            }
            count = fminf(fmaxf(floorf(count), 0.0f), big);
            out[(size_t)(s0 + i) * V + v] = base_ok ? (int)count : 0;
        }
    }
}

template <int R, bool VEC>
cudaError_t launch(const float* sizes, const float* head, int* out, int S, int V, int tile, int chunk,
                   cudaStream_t stream) {
    const dim3 grid((unsigned)((V + tile - 1) / tile), (unsigned)((S + chunk - 1) / chunk));
    warm_fill_kernel<R, VEC><<<grid, tile, 0, stream>>>(sizes, head, out, S, V, chunk);
    return cudaGetLastError();
}

int launch_r(const void* sizes, const void* head, void* out, int S, int V, int R, int tile, int chunk, void* stream) {
    if (S <= 0 || V <= 0) return cudaSuccess;
    if (tile < 32 || tile > kMaxTile || tile % 32 != 0 || chunk < 1 || chunk > kMaxChunk ||
        (S + chunk - 1) / chunk > kMaxGridY) {
        return cudaErrorInvalidValue;
    }
    const float* z = static_cast<const float*>(sizes);
    const float* h = static_cast<const float*>(head);
    int* o = static_cast<int*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // rows of 4 or 8 floats are 16-byte aligned when the base pointers are
    const bool vec = ((reinterpret_cast<size_t>(sizes) | reinterpret_cast<size_t>(head)) & 15) == 0;
    switch (R) {
        case 1: return launch<1, false>(z, h, o, S, V, tile, chunk, st);
        case 2: return launch<2, false>(z, h, o, S, V, tile, chunk, st);
        case 3: return launch<3, false>(z, h, o, S, V, tile, chunk, st);
        case 4: return vec ? launch<4, true>(z, h, o, S, V, tile, chunk, st) : launch<4, false>(z, h, o, S, V, tile, chunk, st);
        case 5: return launch<5, false>(z, h, o, S, V, tile, chunk, st);
        case 6: return launch<6, false>(z, h, o, S, V, tile, chunk, st);
        case 7: return launch<7, false>(z, h, o, S, V, tile, chunk, st);
        case 8: return vec ? launch<8, true>(z, h, o, S, V, tile, chunk, st) : launch<8, false>(z, h, o, S, V, tile, chunk, st);
        default: return cudaErrorInvalidValue;
    }
}

int default_chunk(int S, int V, int sms) {
    const long long tiles = (V + kTile - 1) / kTile;
    for (int chunk = kMaxChunk; chunk > 1; chunk /= 2) {
        if (tiles * ((S + chunk - 1) / chunk) >= (long long)kBlocksPerSM * sms) return chunk;
    }
    return 1;
}

int sm_count(int* sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    return err;
}

}  // namespace

// The kernel's one entry point, enqueued on `stream`: sizes [S, R] f32,
// head [V, R] f32 and out [S, V] int32 are device pointers, contiguous.
// When `staged` (pinned host, f32) is not null it is first copied up: the
// sizes alone when `staged_head` is 0 (head is a device buffer the caller
// owns, the engine's resident rows), or the sizes then the head when it is
// 1, and then head must follow sizes in one buffer. When `landed` (pinned
// host, [S, V] int32) is not null, out is copied into it after the launch.
// Launches with the default geometry and returns the first CUDA error;
// warm_fill_wait waits for the stream.
extern "C" int warm_fill_launch(const void* staged, int staged_head, void* sizes, void* head, void* out, void* landed,
                                int S, int V, int R, void* stream) {
    if (S <= 0 || V <= 0) return cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* z = static_cast<float*>(sizes);
    float* h = static_cast<float*>(head);
    if (staged != nullptr) {
        if (staged_head && h != z + (size_t)S * R) return cudaErrorInvalidValue;
        const size_t rows = staged_head ? (size_t)(S + V) : (size_t)S;
        const cudaError_t err = cudaMemcpyAsync(z, staged, rows * R * sizeof(float), cudaMemcpyHostToDevice, st);
        if (err != cudaSuccess) return err;
    }
    int sms = 0;
    const int got = sm_count(&sms);
    if (got != cudaSuccess) return got;
    const int launched = launch_r(z, h, out, S, V, R, kTile, default_chunk(S, V, sms), stream);
    if (launched != cudaSuccess || landed == nullptr) return launched;
    return cudaMemcpyAsync(landed, out, (size_t)S * V * sizeof(int), cudaMemcpyDeviceToHost, st);
}

extern "C" int warm_fill_wait(void* stream) { return cudaStreamSynchronize(static_cast<cudaStream_t>(stream)); }
