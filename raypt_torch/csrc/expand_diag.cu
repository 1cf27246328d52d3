// The expansion's staged diagnostics, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of two scripts of scripts/:
//   * tpu_expand_debug.py: run12 (:44, body k_stage12 :30), run34 (:95,
//     body k_stage34 :68) and run5 (:151, body k_stage5 :140);
//   * tpu_expand_diag2.py: run_diag (:172, body _kernel_diag :37).
// Contracts:
//   * stage 1-2: m = bit k of mask row w (logical shift; the row's page
//     index w >> 3 clamped into the pages, as XLA's dynamic slice does; a
//     shift outside [0, 32) gives 0), and its exclusive prefix sum rank;
//   * stage 3-4: lanes with m > 0 and rank < 128 are selected; lane i
//     with 0 <= rank goes to slot rank. The slot tile holds the 24 bf16
//     payload rows; slot j computes go = (g[r] + g[6 + r]) + g[12 + r] for
//     r < 3 and gd = (g[3 + r] + g[9 + r]) + g[15 + r] (zeros in empty
//     slots) and writes them as go (6, 128); their split3 bf16 digits
//     go back to the lanes, which rebuild (hi + md) + lo into gsel (6, n),
//     -1 on lanes not selected;
//   * stage 5: stage 1's m over a grid of lane blocks;
//   * diag: per program of n rays, the OR-union of its rays' masks, its
//     set bits in ascending cluster id, and for each wanted cluster the
//     rank of the rays that want it and rounds of 128 slots. In a round
//     the selected rays write their 24 payload rows and their lane into
//     the slots; each slot rebuilds o and d as stage 3 does and splits
//     them into bf16 digits again; each ray reads its slot back. Outputs
//     per ray: v1, the largest |z1 - 1| with z1 = 1 when its slot still
//     holds its lane (a collision makes it 0); v2, the largest error of
//     its rebuilt d (the probe's slot-index term, read back through its
//     selection matmul, has no counterpart without one); nc, how many
//     rounds selected it (its mask's popcount when every wanted cluster
//     reaches it exactly once); v3, the largest error of its rebuilt o.
//     Sums are f32 in the probe's order, maxima NaN-propagating.
//
// What bounds it on this card: the block-wide rank of every wanted
// cluster, a chain of shuffles and barriers per 1,024 lanes, and the
// barriers of each round; the bytes (the mask, 48 bytes of payload and
// 24 of truth per ray) are a few MB.
//
// What the design does about it: one block of 1,024 threads per program
// (or per stage), a lane's mask bit and rank in registers, the rank a
// warp shuffle scan plus a shared scan of the 32 warp sums, the 128 slots
// a shared bf16 tile written by the selected lanes and read back by them,
// and the union's words scanned with __ffs as csrc/cluster_expand.cu
// scans them. The TPU kernels' selection matrices and their matmuls have
// no counterpart: a lane moves its payload with stores and loads.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSlots = 128;
constexpr int kMaxChunks = 4;            // lanes per program <= 4,096
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTop = (int)0xffff0000u;   // the 16 bits a bf16 keeps

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int mask_bit(int word, int k) {
    return (k >= 0 && k < 32) ? (int)(((unsigned)word >> k) & 1u) : 0;
}

// Row of the (pages * 8, n) mask that the probe's page select reads.
__device__ __forceinline__ int page_row(int w, int pages) {
    const int p = min(max(w >> 3, 0), pages - 1);
    return p * 8 + (w & 7);
}

// NaN-propagating max (jnp.maximum, torch.maximum).
__device__ __forceinline__ float max_nan(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

// split3_bf16: hi and md truncate x and its residual to their top 16
// bits; lo rounds what is left.
__device__ __forceinline__ void split3(float x, bf16* hi, bf16* md, bf16* lo) {
    const float h = __int_as_float(__float_as_int(x) & kTop);
    const float r1 = x - h;
    const float m = __int_as_float(__float_as_int(r1) & kTop);
    *hi = __float2bfloat16_rn(h);
    *md = __float2bfloat16_rn(m);
    *lo = __float2bfloat16_rn(r1 - m);
}

__global__ void __launch_bounds__(kThreads)
stage12_kernel(const int* __restrict__ wk, const int* __restrict__ mask,
               int pages, int n, int* __restrict__ m_out,
               int* __restrict__ rank_out) {
    __shared__ int s_warp[33];
    const int row = page_row(wk[0], pages), k = wk[1];
    int carry = 0;
    for (int c0 = 0; c0 < n; c0 += kThreads) {
        const int i = c0 + threadIdx.x;
        const int m = i < n ? mask_bit(mask[(long long)row * n + i], k) : 0;
        int total;
        const int ex = rk::block_exclusive_scan(m, s_warp, &total);
        if (i < n) {
            m_out[i] = m;
            rank_out[i] = carry + ex;
        }
        carry += total;
    }
}

__global__ void __launch_bounds__(kThreads)
stage34_kernel(const bf16* __restrict__ pay, const int* __restrict__ m_in,
               int n, float* __restrict__ go_out, float* __restrict__ gsel) {
    __shared__ int s_warp[33];
    __shared__ bf16 s_pay[24][kSlots];
    __shared__ bf16 s_y[18][kSlots];
    for (int e = threadIdx.x; e < 24 * kSlots; e += kThreads)
        s_pay[e / kSlots][e % kSlots] = __float2bfloat16_rn(0.0f);
    __syncthreads();
    int rank[kMaxChunks], sel[kMaxChunks];
    int carry = 0;
    for (int c = 0; c * kThreads < n; ++c) {
        const int i = c * kThreads + threadIdx.x;
        const int m = i < n ? m_in[i] : 0;
        int total;
        rank[c] = carry + rk::block_exclusive_scan(m, s_warp, &total);
        carry += total;
        sel[c] = i < n && m > 0 && rank[c] < kSlots;
        if (sel[c] && rank[c] >= 0)
            for (int r = 0; r < 24; ++r) s_pay[r][rank[c]] = pay[(long long)r * n + i];
    }
    __syncthreads();
    if (threadIdx.x < kSlots) {
        const int j = threadIdx.x;
        float g[18];
        for (int r = 0; r < 18; ++r) g[r] = __bfloat162float(s_pay[r][j]);
        for (int r = 0; r < 6; ++r) {   // rows 0-2 go (o), 3-5 gd (d)
            const float v = (g[r] + g[6 + r]) + g[12 + r];
            go_out[r * kSlots + j] = v;
            split3(v, &s_y[r][j], &s_y[6 + r][j], &s_y[12 + r][j]);
        }
    }
    __syncthreads();
    for (int c = 0; c * kThreads < n; ++c) {
        const int i = c * kThreads + threadIdx.x;
        if (i >= n) break;
        const bool in_slot = sel[c] && rank[c] >= 0;
        for (int r = 0; r < 6; ++r) {
            float back = 0.0f;
            if (in_slot) {
                const int s = rank[c];
                back = (__bfloat162float(s_y[r][s]) + __bfloat162float(s_y[6 + r][s])) +
                       __bfloat162float(s_y[12 + r][s]);
            }
            gsel[(long long)r * n + i] = sel[c] ? back : -1.0f;
        }
    }
}

__global__ void stage5_kernel(const int* __restrict__ wk, const int* __restrict__ mask,
                              int pages, long long n_total, int* __restrict__ m_out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_total) return;
    const int row = page_row(wk[0], pages);
    m_out[i] = mask_bit(mask[row * n_total + i], wk[1]);
}

__global__ void __launch_bounds__(kThreads)
expand_diag_kernel(const int* __restrict__ mask, int cwp, const bf16* __restrict__ pay,
                   const float* __restrict__ otrue, long long r_total, int n,
                   float* __restrict__ v1_out, float* __restrict__ v2_out,
                   int* __restrict__ nc_out, float* __restrict__ v3_out) {
    extern __shared__ int s_union[];   // cwp words of this program's union
    __shared__ int s_warp[33];
    __shared__ int s_owner[kSlots];
    __shared__ bf16 s_pay[24][kSlots];
    __shared__ bf16 s_y[18][kSlots];   // o digits rows 0-8, d digits 9-17
    const long long base = (long long)blockIdx.x * n;
    const int lane = threadIdx.x & 31;
    const int chunks = (n + kThreads - 1) / kThreads;

    for (int w = threadIdx.x; w < cwp; w += kThreads) s_union[w] = 0;
    __syncthreads();
    for (int w = 0; w < cwp; ++w) {
        unsigned v = 0;
        for (int c = 0; c < chunks; ++c) {
            const int i = c * kThreads + threadIdx.x;
            if (i < n) v |= (unsigned)mask[w * r_total + base + i];
        }
        v = __reduce_or_sync(kFull, v);
        if (lane == 0 && v) atomicOr(&s_union[w], (int)v);
    }
    __syncthreads();

    float v1[kMaxChunks], v2[kMaxChunks], v3[kMaxChunks];
    int nc[kMaxChunks];
    for (int c = 0; c < kMaxChunks; ++c) {
        v1[c] = v2[c] = v3[c] = 0.0f;
        nc[c] = 0;
    }
    for (int w = 0; w < cwp; ++w) {
        unsigned bits = (unsigned)s_union[w];   // uniform across the block
        while (bits) {
            const int k = __ffs(bits) - 1;
            bits &= bits - 1u;
            int m[kMaxChunks], rank[kMaxChunks];
            int count = 0;
            for (int c = 0; c < chunks; ++c) {
                const int i = c * kThreads + threadIdx.x;
                m[c] = i < n ? mask_bit(mask[w * r_total + base + i], k) : 0;
                int total;
                rank[c] = count + rk::block_exclusive_scan(m[c], s_warp, &total);
                count += total;
            }
            for (int rb = 0; rb < count; rb += kSlots) {
                for (int c = 0; c < chunks; ++c) {
                    const int i = c * kThreads + threadIdx.x;
                    if (m[c] && rank[c] >= rb && rank[c] < rb + kSlots) {
                        const int s = rank[c] - rb;
                        s_owner[s] = i;
                        for (int r = 0; r < 24; ++r)
                            s_pay[r][s] = pay[r * r_total + base + i];
                    }
                }
                __syncthreads();
                if (threadIdx.x < min(kSlots, count - rb)) {
                    const int j = threadIdx.x;
                    float g[18];
                    for (int r = 0; r < 18; ++r) g[r] = __bfloat162float(s_pay[r][j]);
                    for (int r = 0; r < 3; ++r) {
                        const float go = (g[r] + g[6 + r]) + g[12 + r];
                        const float gd = (g[3 + r] + g[9 + r]) + g[15 + r];
                        split3(go, &s_y[r][j], &s_y[3 + r][j], &s_y[6 + r][j]);
                        split3(gd, &s_y[9 + r][j], &s_y[12 + r][j], &s_y[15 + r][j]);
                    }
                }
                __syncthreads();
                for (int c = 0; c < chunks; ++c) {
                    const int i = c * kThreads + threadIdx.x;
                    if (!(m[c] && rank[c] >= rb && rank[c] < rb + kSlots)) continue;
                    const int s = rank[c] - rb;
                    const float z1 = s_owner[s] == i ? 1.0f : 0.0f;
                    v1[c] = max_nan(v1[c], fabsf(z1 - 1.0f));
                    nc[c] += 1;
                    float dvo = 0.0f, dvd = 0.0f;
                    for (int r = 0; r < 3; ++r) {
                        const float bo = (__bfloat162float(s_y[r][s]) +
                                          __bfloat162float(s_y[3 + r][s])) +
                                         __bfloat162float(s_y[6 + r][s]);
                        const float bd = (__bfloat162float(s_y[9 + r][s]) +
                                          __bfloat162float(s_y[12 + r][s])) +
                                         __bfloat162float(s_y[15 + r][s]);
                        const float eo = fabsf(bo - otrue[r * r_total + base + i]);
                        const float ed = fabsf(bd - otrue[(3 + r) * r_total + base + i]);
                        dvo = r == 0 ? eo : max_nan(dvo, eo);
                        dvd = r == 0 ? ed : max_nan(dvd, ed);
                    }
                    v3[c] = max_nan(v3[c], dvo);
                    v2[c] = max_nan(v2[c], dvd);
                }
                __syncthreads();   // the slots are rewritten by the next round
            }
        }
    }
    for (int c = 0; c < chunks; ++c) {
        const int i = c * kThreads + threadIdx.x;
        if (i >= n) break;
        v1_out[base + i] = v1[c];
        v2_out[base + i] = v2[c];
        nc_out[base + i] = nc[c];
        v3_out[base + i] = v3[c];
    }
}

}  // namespace

// wk (2,) int32 [w, k] on the device; mask (pages * 8, n) int32 ->
// m, rank (n,) int32; n <= 4,096 lanes in one block.
extern "C" int rk_expand_stage12(const int* wk, const int* mask, int pages, int n,
                                 int* m_out, int* rank_out, void* stream) {
    if (pages <= 0 || n <= 0 || n > kMaxChunks * kThreads)
        return (int)cudaErrorInvalidValue;
    stage12_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(wk, mask, pages, n,
                                                             m_out, rank_out);
    return (int)cudaGetLastError();
}

// pay (24, n) bf16, m (n,) int32 -> go (6, 128) f32, gsel (6, n) f32.
extern "C" int rk_expand_stage34(const uint16_t* pay, const int* m, int n,
                                 float* go_out, float* gsel, void* stream) {
    if (n <= 0 || n > kMaxChunks * kThreads) return (int)cudaErrorInvalidValue;
    stage34_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const bf16*>(pay), m, n, go_out, gsel);
    return (int)cudaGetLastError();
}

// wk (2,) int32; mask (pages * 8, n_total) int32 -> m (n_total,) int32.
extern "C" int rk_expand_stage5(const int* wk, const int* mask, int pages,
                                long long n_total, int* m_out, void* stream) {
    if (pages <= 0 || n_total <= 0) return (int)cudaErrorInvalidValue;
    stage5_kernel<<<(unsigned)((n_total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        wk, mask, pages, n_total, m_out);
    return (int)cudaGetLastError();
}

// mask (cwp, r) int32, pay (24, r) bf16, otrue (6, r) f32; programs of n
// rays (r a multiple of n, n <= 4,096) -> v1, v2, v3 (r,) f32, nc (r,) int32.
extern "C" int rk_expand_diag(const int* mask, int cwp, const uint16_t* pay,
                              const float* otrue, long long r, int n, float* v1,
                              float* v2, int* nc, float* v3, void* stream) {
    if (cwp <= 0 || n <= 0 || n > kMaxChunks * kThreads || r % n)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = (size_t)cwp * 4;
    if (smem > 16 * 1024) return (int)cudaErrorInvalidValue;
    expand_diag_kernel<<<(unsigned)(r / n), kThreads, smem, (cudaStream_t)stream>>>(
        mask, cwp, reinterpret_cast<const bf16*>(pay), otrue, r, n, v1, v2, nc, v3);
    return (int)cudaGetLastError();
}
