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
// Design: one thread per (s, v) output over a flat index, so neighbouring
// threads write neighbouring v of one row and the stores coalesce. R is a
// template parameter (1-8) and the loop over it is unrolled. head [V, R] and
// sizes [S, R] are read row-major as the solver hands them over: no
// transpose and no padding (the TPU version padded to 8 x 128 tiles); the
// kernel masks its own ragged edge.
//
// Numerics: __fmul_rn/__fadd_rn/__fdiv_rn and floorf, built with
// -fmad=false, so no FMA contraction or approximate division moves a count
// across an integer boundary; the kernel equals the plain PyTorch version
// (ops/warmfill.py:warm_fill_counts) bit for bit. The constants 1 +/- 4e-6
// are the f32 sums the plain version uses.
//
// Bound: (S + V) * R * 4 bytes in and S * V * 4 bytes out, and S * V * R
// divisions. At the repack solve's shapes (tens of size classes x a few
// thousand nodes) that is well under a microsecond of the card's memory
// rate, so launch latency sets the kernel's time. Faster designs (staging
// head through shared memory, or a resident head buffer updated in place
// between solves) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int R>
__global__ void warm_fill_kernel(const float* __restrict__ sizes, const float* __restrict__ head,
                                 int* __restrict__ out, int S, int V) {
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= (long long)S * V) return;
    const int s = (int)(idx / V);
    const int v = (int)(idx - (long long)s * V);

    const float eps = 1e-12f;
    const float big = 1073741824.0f;  // 2^30
    const float slack = 4e-6f;
    const float one_plus = __fadd_rn(1.0f, slack);
    const float one_minus = __fadd_rn(1.0f, -slack);

    bool base_ok = true;
    float count = big;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float h = head[(size_t)v * R + r];
        const float z = sizes[(size_t)s * R + r];
        base_ok = base_ok && (h >= -eps);
        const float slack_head = __fadd_rn(__fmul_rn(h, one_plus), slack);
        const bool positive = z > 0.0f;
        const float safe = __fmul_rn(positive ? z : 1.0f, one_minus);
        const float ratio = positive ? __fdiv_rn(slack_head, safe) : big;
        count = fminf(count, ratio);
    }
    count = fminf(fmaxf(floorf(count), 0.0f), big);
    out[idx] = base_ok ? (int)count : 0;
}

template <int R>
cudaError_t launch(const float* sizes, const float* head, int* out, int S, int V, cudaStream_t stream) {
    const long long cells = (long long)S * V;
    const dim3 grid((unsigned)((cells + kThreads - 1) / kThreads));
    warm_fill_kernel<R><<<grid, kThreads, 0, stream>>>(sizes, head, out, S, V);
    return cudaGetLastError();
}

}  // namespace

// sizes: [S, R] f32; head: [V, R] f32; out: [S, V] int32. All device
// pointers, contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int warm_fill_launch(const void* sizes, const void* head, void* out, int S, int V, int R, void* stream) {
    if (S <= 0 || V <= 0) return cudaSuccess;
    const float* z = static_cast<const float*>(sizes);
    const float* h = static_cast<const float*>(head);
    int* o = static_cast<int*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 1: return launch<1>(z, h, o, S, V, st);
        case 2: return launch<2>(z, h, o, S, V, st);
        case 3: return launch<3>(z, h, o, S, V, st);
        case 4: return launch<4>(z, h, o, S, V, st);
        case 5: return launch<5>(z, h, o, S, V, st);
        case 6: return launch<6>(z, h, o, S, V, st);
        case 7: return launch<7>(z, h, o, S, V, st);
        case 8: return launch<8>(z, h, o, S, V, st);
        default: return cudaErrorInvalidValue;
    }
}
