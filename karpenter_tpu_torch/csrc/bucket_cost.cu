// Bucket -> instance-type cost choice on Hopper (sm_90a).
//
// Replaces karpenter_tpu/ops/pallas_kernels.py:_kernel, the fused Pallas
// kernel of the JAX package. Per bucket b and type t:
//
//   frac  = max_r sum[b,r] / max(cap[t,r], 1e-9)   (inf where cap <= 1e-9 < sum)
//   bins  = ceil(max(frac, 1e-9))
//   fits  = all_r max[b,r] <= cap[t,r] + 1e-6
//   ok    = allowed[b,t] && fits && frac finite
//   key   = frac*price + bins*1e-4 + price*1e-7, or inf where !ok
//
// and per bucket the first-index argmin t*, bins at t* (0 where t* is not
// ok), and any(ok), written as one packed [3, B] int32 array.
//
// Design: one warp per bucket row, several rows per block. Lanes stride over
// T with R unrolled (R is a template parameter), each lane keeping a running
// (key, t) pair; the pairs merge with warp shuffles, the lower t winning on
// equal keys, so the result is the first-index argmin even on all-inf rows
// (t* = 0). The [B, T, R] ratio surface never exists in memory, and the
// kernel masks its own ragged edge: no padding of B or T.
//
// Numerics: the key is built from __fmul_rn/__fadd_rn and the ratio from
// __fdiv_rn, so no FMA contraction or approximate division changes the key
// in its last bit; the kernel then agrees bit for bit with the plain PyTorch
// version (ops/feasibility.py). Build without --use_fast_math.
//
// Bound: the work is B*T*R divisions and compares, and the bytes are the
// B*T bytes of `allowed` plus a few KB of catalog. At the solve's shapes
// (tens to thousands of buckets x 500 types) that is about 0.01 us of the
// card's memory rate, so neither bytes nor operations bound it: launch
// latency and each warp's serial loop over T do (T/32 iterations of R
// correctly rounded divisions per lane). On an H100 the kernel's device time
// follows T and hardly B (chip_smoke.py's kernel_scaling phase; PERF.md).
// A faster design (one block per bucket tile with T split across its warps
// and `allowed` staged through shared memory, or the availability matmul's
// threshold fused into `allowed`) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

struct Best {
    float key;
    int t;
    int bins;
    int ok;
};

// lexicographic (key, t) order: the first-index argmin
__device__ __forceinline__ bool better(float k1, int t1, float k2, int t2) {
    return k1 < k2 || (k1 == k2 && t1 < t2);
}

template <int R>
__global__ void bucket_cost_kernel(const float* __restrict__ sum_req, const float* __restrict__ max_req,
                                   const float* __restrict__ caps, const float* __restrict__ prices,
                                   const unsigned char* __restrict__ allowed, int* __restrict__ out, int B, int T) {
    const int lane = threadIdx.x % kWarp;
    const int b = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
    if (b >= B) return;  // whole warps exit together: the shuffles below stay full-warp

    const float eps = 1e-9f;
    float s[R], m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        s[r] = sum_req[(size_t)b * R + r];
        m[r] = max_req[(size_t)b * R + r];
    }

    Best best{CUDART_INF_F, 0x7fffffff, 0, 0};
    int any_ok = 0;
    const unsigned char* row = allowed + (size_t)b * T;
    for (int t = lane; t < T; t += kWarp) {
        float frac = 0.0f;
        bool fits = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float cap = caps[(size_t)t * R + r];
            const float ratio = __fdiv_rn(s[r], fmaxf(cap, eps));
            const bool impossible = (cap <= eps) && (s[r] > eps);
            frac = fmaxf(frac, impossible ? CUDART_INF_F : ratio);
            fits = fits && (m[r] <= __fadd_rn(cap, 1e-6f));
        }
        const float bins = ceilf(fmaxf(frac, eps));
        const bool ok = row[t] != 0 && fits && frac < CUDART_INF_F;
        const float price = prices[t];
        float key = __fadd_rn(__fadd_rn(__fmul_rn(frac, price), __fmul_rn(bins, 1e-4f)), __fmul_rn(price, 1e-7f));
        key = ok ? key : CUDART_INF_F;
        if (better(key, t, best.key, best.t)) {
            best = Best{key, t, ok ? (int)bins : 0, ok ? 1 : 0};
        }
        any_ok |= ok ? 1 : 0;
    }

#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        const float k = __shfl_down_sync(0xffffffffu, best.key, offset);
        const int t = __shfl_down_sync(0xffffffffu, best.t, offset);
        const int n = __shfl_down_sync(0xffffffffu, best.bins, offset);
        const int o = __shfl_down_sync(0xffffffffu, best.ok, offset);
        if (better(k, t, best.key, best.t)) best = Best{k, t, n, o};
    }
    any_ok = __any_sync(0xffffffffu, any_ok);

    if (lane == 0) {
        out[b] = best.t == 0x7fffffff ? 0 : best.t;
        out[B + b] = best.ok ? best.bins : 0;
        out[2 * B + b] = any_ok ? 1 : 0;
    }
}

template <int R>
cudaError_t launch(const float* stats, const float* caps, const float* prices, const unsigned char* allowed, int* out,
                   int B, int T, cudaStream_t stream) {
    const dim3 block(kWarp * kRowsPerBlock);
    const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock);
    bucket_cost_kernel<R><<<grid, block, 0, stream>>>(stats, stats + (size_t)B * R, caps, prices, allowed, out, B, T);
    return cudaGetLastError();
}

}  // namespace

// stats: [2, B, R] f32 (sum, max); caps: [T, R] f32; prices: [T] f32;
// allowed: [B, T] one byte each; out: [3, B] int32. All device pointers,
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int bucket_cost_launch(const void* stats, const void* caps, const void* prices, const void* allowed,
                                  void* out, int B, int T, int R, void* stream) {
    if (B <= 0) return cudaSuccess;
    const float* s = static_cast<const float*>(stats);
    const float* c = static_cast<const float*>(caps);
    const float* p = static_cast<const float*>(prices);
    const unsigned char* a = static_cast<const unsigned char*>(allowed);
    int* o = static_cast<int*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 1: return launch<1>(s, c, p, a, o, B, T, st);
        case 2: return launch<2>(s, c, p, a, o, B, T, st);
        case 3: return launch<3>(s, c, p, a, o, B, T, st);
        case 4: return launch<4>(s, c, p, a, o, B, T, st);
        case 5: return launch<5>(s, c, p, a, o, B, T, st);
        case 6: return launch<6>(s, c, p, a, o, B, T, st);
        case 7: return launch<7>(s, c, p, a, o, B, T, st);
        case 8: return launch<8>(s, c, p, a, o, B, T, st);
        default: return cudaErrorInvalidValue;
    }
}
