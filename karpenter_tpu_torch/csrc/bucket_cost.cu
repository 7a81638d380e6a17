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
// What bounds it on this card: neither bytes nor operations. The inputs are
// the B*T bytes of `allowed` plus a few KB of catalog and bucket stats (at
// the headline's (30, 500, 8) about 0.00001 ms of the card's memory rate),
// and the work is B*T*R divisions. What is left is latency: the launch
// itself (chip_smoke.py measures the floor as the device time of the
// smallest kernel PyTorch launches) and the chain of dependent steps each
// bucket takes. The design shortens that chain and spreads it over the SMs.
//
// Design:
//   - One block per bucket, T split across the block's threads: thread i
//     owns the types i, i + blockDim, i + 2*blockDim, ... A bucket costs each
//     thread one step of R divisions per owned type instead of T/32 serial
//     steps per lane, and B buckets occupy B SMs instead of B/8.
//   - A grid-stride loop over buckets with the grid capped at a few blocks
//     per SM, so thousands of buckets do not launch thousands of blocks.
//     Each thread loads its types' catalog rows (caps and price) into
//     registers once per block and reuses them for every bucket the block
//     visits; the next bucket's stats and `allowed` bytes are loaded while
//     the current bucket reduces. Rows are read as 16-byte vectors when R is
//     4 or 8 and the pointers allow it.
//   - Neighbouring threads read neighbouring bytes of `allowed`, so the
//     loads coalesce. sum/max of the bucket are one broadcast row.
//   - Reduction: each thread keeps its best (key, t); a warp merges by
//     shuffles, the warps' bests go through shared memory (double-buffered,
//     so one barrier per bucket) and warp 0 merges them. any(ok) rides the
//     same barrier as __syncthreads_or. The order is lexicographic on
//     (key, t), so the result does not depend on the merge tree: it is the
//     first-index argmin, t* = 0 on an all-inf row.
//   - The block size and the grid cap are chosen in the launcher from B, T
//     and the SM count (default_geometry, below; chip_sweep.py sweeps both
//     and PERF.md has the result): as wide as T while B such blocks fit on
//     the card at once, narrower for many buckets. Types beyond
//     kMaxTypesPerThread * blockDim are read from global memory in a tail
//     loop.
//
// Not used, and why: no tensor cores or wgmma (there is no matrix product;
// the work is divisions and compares), and no TMA or cp.async pipeline (the
// inputs are kilobytes; one wave of loads brings them all).
//
// Numerics: the key is built from __fmul_rn/__fadd_rn and the ratio from
// __fdiv_rn, so no FMA contraction or approximate division changes the key
// in its last bit; the kernel then agrees bit for bit with the plain PyTorch
// version (ops/feasibility.py). A zero sum skips its division: the quotient
// is exactly 0 for the divisor max(cap, 1e-9) > 0, a zero dividend takes
// the division's slow path, and buckets leave most resources unrequested
// (5 of 8 at the headline). The branch is uniform across a bucket's block.
// Build without --use_fast_math.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;       // block size cap (and __launch_bounds__)
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kMinThreads = 64;        // the smallest block a large B shrinks it to
constexpr int kResidentThreadsPerSM = 1024;  // at this kernel's ~64 registers a thread
constexpr int kBlocksPerSM = 8;        // grid cap = kBlocksPerSM * SM count
constexpr int kMaxTypesPerThread = 4;  // catalog rows held in registers: J in {1, 2, 4}
constexpr float kEps = 1e-9f;

// lexicographic (key, t) order: the first-index argmin
__device__ __forceinline__ bool better(float k1, int t1, float k2, int t2) {
    return k1 < k2 || (k1 == k2 && t1 < t2);
}

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

struct Best {
    float key;
    int t;
    int bins;  // bins at t where ok, else 0
};

// One (bucket, type) cell folded into a thread's running best.
template <int R>
__device__ __forceinline__ void consider(const float (&cap)[R], float price, float price_term, const float (&s)[R],
                                         const float (&m)[R], bool allowed, int t, Best& best, bool& any_ok) {
    float frac = 0.0f;
    bool fits = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float c = cap[r];
        // a resource the bucket does not request: 0 / c is 0 for every c > 0,
        // and a zero dividend sends the division down its slow path
        const float ratio = s[r] == 0.0f ? 0.0f : __fdiv_rn(s[r], fmaxf(c, kEps));
        const bool impossible = (c <= kEps) && (s[r] > kEps);
        frac = fmaxf(frac, impossible ? CUDART_INF_F : ratio);
        fits = fits && (m[r] <= __fadd_rn(c, 1e-6f));
    }
    const float bins = ceilf(fmaxf(frac, kEps));
    const bool ok = allowed && fits && frac < CUDART_INF_F;
    float key = __fadd_rn(__fadd_rn(__fmul_rn(frac, price), __fmul_rn(bins, 1e-4f)), price_term);
    key = ok ? key : CUDART_INF_F;
    if (better(key, t, best.key, best.t)) best = Best{key, t, ok ? (int)bins : 0};
    any_ok = any_ok || ok;
}

__device__ __forceinline__ void warp_merge(Best& best) {
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        const float k = __shfl_down_sync(0xffffffffu, best.key, offset);
        const int t = __shfl_down_sync(0xffffffffu, best.t, offset);
        const int n = __shfl_down_sync(0xffffffffu, best.bins, offset);
        if (better(k, t, best.key, best.t)) best = Best{k, t, n};
    }
}

template <int R, int J, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    bucket_cost_kernel(const float* __restrict__ sum_req, const float* __restrict__ max_req,
                       const float* __restrict__ caps, const float* __restrict__ prices,
                       const unsigned char* __restrict__ allowed, int* __restrict__ out, int B, int T) {
    __shared__ float warp_key[2][kMaxWarps];
    __shared__ int warp_t[2][kMaxWarps];
    __shared__ int warp_bins[2][kMaxWarps];

    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int warps = blockDim.x / kWarp;
    const int stride = blockDim.x;

    int b = blockIdx.x;
    if (b >= B) return;  // the whole block leaves together, before any barrier

    // this bucket's stats and allowed bytes, then this thread's catalog rows:
    // every load is issued before the first use
    float s[R], m[R];
    bool al[J];
    load_row<R, VEC>(sum_req + (size_t)b * R, s);
    load_row<R, VEC>(max_req + (size_t)b * R, m);
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int t = threadIdx.x + j * stride;
        al[j] = t < T && allowed[(size_t)b * T + t] != 0;
    }
    float cap[J][R], price[J], price_term[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int t = threadIdx.x + j * stride;
        if (t < T) {
            load_row<R, VEC>(caps + (size_t)t * R, cap[j]);
            price[j] = __ldg(prices + t);
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) cap[j][r] = 0.0f;
            price[j] = 0.0f;
        }
        price_term[j] = __fmul_rn(price[j], 1e-7f);
    }

    int buf = 0;
    while (true) {
        Best best{CUDART_INF_F, INT_MAX, 0};
        bool any_ok = false;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int t = threadIdx.x + j * stride;
            if (t < T) consider<R>(cap[j], price[j], price_term[j], s, m, al[j], t, best, any_ok);
        }
        // types past the registers' reach: caps read from global memory
        for (int t = threadIdx.x + J * stride; t < T; t += stride) {
            float c[R];
            load_row<R, VEC>(caps + (size_t)t * R, c);
            const float p = __ldg(prices + t);
            consider<R>(c, p, __fmul_rn(p, 1e-7f), s, m, allowed[(size_t)b * T + t] != 0, t, best, any_ok);
        }

        // the next bucket's inputs load while this one reduces
        const int next = b + gridDim.x;
        if (next < B) {
            load_row<R, VEC>(sum_req + (size_t)next * R, s);
            load_row<R, VEC>(max_req + (size_t)next * R, m);
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const int t = threadIdx.x + j * stride;
                al[j] = t < T && allowed[(size_t)next * T + t] != 0;
            }
        }

        warp_merge(best);
        if (lane == 0) {
            warp_key[buf][warp] = best.key;
            warp_t[buf][warp] = best.t;
            warp_bins[buf][warp] = best.bins;
        }
        // one barrier per bucket: it publishes the warps' bests and ORs
        // any_ok. Warp 0 reads buffer `buf` while the others may already
        // write the next bucket's bests into the other buffer; they reach
        // `buf` again only after the next barrier, which warp 0 joins after
        // its reads.
        const int block_any = __syncthreads_or(any_ok ? 1 : 0);
        if (warp == 0) {
            Best w = lane < warps ? Best{warp_key[buf][lane], warp_t[buf][lane], warp_bins[buf][lane]}
                                  : Best{CUDART_INF_F, INT_MAX, 0};
            warp_merge(w);
            if (lane == 0) {
                out[b] = w.t == INT_MAX ? 0 : w.t;
                out[B + b] = w.bins;
                out[2 * B + b] = block_any ? 1 : 0;
            }
        }
        buf ^= 1;
        if (next >= B) break;
        b = next;
    }
}

struct Geometry {
    int threads;
    int blocks;
};

// A block as wide as T (one type per thread, at most kMaxThreads), halved
// towards kMinThreads while B such blocks would not fit on the card at once:
// with many buckets, more of them in flight beat more threads per bucket.
Geometry default_geometry(int B, int T, int sms) {
    int threads = (T + kWarp - 1) / kWarp * kWarp;
    threads = threads < kWarp ? kWarp : (threads > kMaxThreads ? kMaxThreads : threads);
    while (threads > kMinThreads && (long long)B * threads > (long long)kResidentThreadsPerSM * sms) {
        const int half = (threads / 2 + kWarp - 1) / kWarp * kWarp;
        threads = half < kMinThreads ? kMinThreads : half;
    }
    const int cap = kBlocksPerSM * sms;
    return Geometry{threads, B < cap ? B : cap};
}

template <int R, bool VEC>
cudaError_t launch(const float* stats, const float* caps, const float* prices, const unsigned char* allowed, int* out,
                   int B, int T, Geometry g, cudaStream_t stream) {
    const float* sum_req = stats;
    const float* max_req = stats + (size_t)B * R;
    const int j = (T + g.threads - 1) / g.threads;
    if (j <= 1) {
        bucket_cost_kernel<R, 1, VEC><<<g.blocks, g.threads, 0, stream>>>(sum_req, max_req, caps, prices, allowed, out, B, T);
    } else if (j <= 2) {
        bucket_cost_kernel<R, 2, VEC><<<g.blocks, g.threads, 0, stream>>>(sum_req, max_req, caps, prices, allowed, out, B, T);
    } else {
        bucket_cost_kernel<R, kMaxTypesPerThread, VEC>
            <<<g.blocks, g.threads, 0, stream>>>(sum_req, max_req, caps, prices, allowed, out, B, T);
    }
    return cudaGetLastError();
}

int launch_r(const void* stats, const void* caps, const void* prices, const void* allowed, void* out, int B, int T,
             int R, Geometry g, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (T < 1 || g.threads < kWarp || g.threads > kMaxThreads || g.threads % kWarp != 0 || g.blocks < 1) {
        return cudaErrorInvalidValue;
    }
    const float* s = static_cast<const float*>(stats);
    const float* c = static_cast<const float*>(caps);
    const float* p = static_cast<const float*>(prices);
    const unsigned char* a = static_cast<const unsigned char*>(allowed);
    int* o = static_cast<int*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // rows of 4 or 8 floats are 16-byte aligned when the base pointers are
    const bool vec = ((reinterpret_cast<size_t>(stats) | reinterpret_cast<size_t>(caps)) & 15) == 0;
    switch (R) {
        case 1: return launch<1, false>(s, c, p, a, o, B, T, g, st);
        case 2: return launch<2, false>(s, c, p, a, o, B, T, g, st);
        case 3: return launch<3, false>(s, c, p, a, o, B, T, g, st);
        case 4: return vec ? launch<4, true>(s, c, p, a, o, B, T, g, st) : launch<4, false>(s, c, p, a, o, B, T, g, st);
        case 5: return launch<5, false>(s, c, p, a, o, B, T, g, st);
        case 6: return launch<6, false>(s, c, p, a, o, B, T, g, st);
        case 7: return launch<7, false>(s, c, p, a, o, B, T, g, st);
        case 8: return vec ? launch<8, true>(s, c, p, a, o, B, T, g, st) : launch<8, false>(s, c, p, a, o, B, T, g, st);
        default: return cudaErrorInvalidValue;
    }
}

int sm_count(int* sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    return err;
}

}  // namespace

// stats: [2, B, R] f32 (sum, max); caps: [T, R] f32; prices: [T] f32;
// allowed: [B, T] one byte each; out: [3, B] int32. All device pointers,
// contiguous. Launches on `stream` with the default geometry and returns
// cudaGetLastError().
extern "C" int bucket_cost_launch(const void* stats, const void* caps, const void* prices, const void* allowed,
                                  void* out, int B, int T, int R, void* stream) {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    return launch_r(stats, caps, prices, allowed, out, B, T, R, default_geometry(B, T, sms), stream);
}
