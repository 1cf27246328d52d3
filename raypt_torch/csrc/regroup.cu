// Regrouping of interested lanes into 128 slots and back: the regroup
// probes of scripts/, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of
//   * tpu_permute_probe.py (run :73, body _kernel :40): rk_permute, chain 0;
//   * tpu_permute_probe2.py (run :71, body _kernel :38): rk_permute,
//     chain 1, with fixed_s;
//   * tpu_sel_probe.py (run :71, body make_kernel :24; its four variants
//     build one selection matrix four ways): rk_sel;
//   * tpu_cycle_budget.py (run :72, body _kernel :36): rk_cycle, modes
//     full / no_mm / fixed_s.
// Every probe runs `iters` cycles c on each program of n lanes (one
// block). A cycle picks interested lanes, gives them slots, moves their
// payload rows into a 128-slot tile, runs a stand-in test on the slots
// and sends the result back to the lanes. Contracts (lane = index within
// the program, bf16 = round to nearest even):
//   * permute: lanes with ((lane * 37 + c * 131) % 199) < 5 ranked by an
//     exclusive prefix sum; the first 128 take slot = rank; slot values
//     g = bf16(x) of its lane's 8 rows, y = bf16(g * 1.0001 + 0.5); the
//     lane adds y to its output (chain 0; the output starts at 0) or adds
//     y * 1e-6 to its x, which the next cycle reads (chain 1; the output
//     is the final x). fixed_s uses cycle 0's selection in every cycle;
//   * sel: the same interest m, but rank = sum over k = 1, 2, 4, ... < n
//     of m[lane - k], minus m (the probe's shifted sum of m, not a prefix
//     sum: rank is in [-1, log2 n) and lanes may share a slot; with this
//     interest pattern no interested lane has another a power of two
//     before it, so every rank is -1 and the output is 0 for n < 2^20);
//     interested lanes with rank >= 0 take slot = rank; g = the sum of
//     the slot's lanes' 24 bf16 rows, in ascending lane order from 0;
//     y = bf16((g[r] + g[6 + r]) + g[12 + r]) for r < 6, added to rows
//     0-5 of the lane's output (rows 6-7 stay 0);
//   * cycle: lanes with ((lane + 8c) & 63) == 0 take slot (lane >> 6) &
//     127 (full), every lane slot lane & 127 (fixed_s); g = the slot's
//     lanes' bf16(x) rows summed in ascending lane order from 0, y =
//     bf16(g[r] * 1.0001 + 0.5) for r < 6, and row 0 of y is added to the
//     lane's (1, n) output. no_mm moves nothing: the interested lanes add
//     bf16(1e-9) (the selection matrix's column sum times 1e-9).
// Arithmetic in f32 without contraction (-fmad=false), so the plain
// torch versions in raypt_torch/probes/regroup.py match bit for bit.
//
// What bounds it on this card: per cycle, the block-wide rank (a chain
// of shuffles and barriers) and three barriers around the slot tile; the
// bytes (x in, the output out, once) are tens of MB at most, far below.
//
// What the design does about it: one block of 1,024 threads per program.
// permute: each thread owns a run of consecutive lanes, counts its
// interested lanes, and one block scan of the counts ranks them; the
// selected lanes post their index to the slot; thread (row, slot) moves
// one payload value into the shared bf16 tile, tests it and adds the
// result back to its lane. sel: m and the rank live in shared memory;
// warp j sums slot j with a ballot over each 32 lanes, its lanes holding
// the 24 rows, so members add in ascending order. Since rk_sel takes at
// most 16,384 lanes a program, every rank is -1: no input reaches the
// slot sums, the s_y build or the scatter, and a check against the plain
// version holds only the zero output. cycle: slot j's
// members have a closed form (64 (j + 128 t) + off, or j + 128 t), which
// warp j walks in ascending order. The TPU kernels' selection matrices,
// their matmuls and the Hillis-Steele lane scan have no counterpart.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 128;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool interest(int lane, int c) {
    return ((lane * 37 + c * 131) % 199) < 5;
}

template <bool kChain, bool kFixedS>
__global__ void __launch_bounds__(kThreads)
permute_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long len, int n, int iters) {
    __shared__ int s_warp[33];
    __shared__ int s_lane[kSlots];
    __shared__ bf16 s_g[8][kSlots];
    __shared__ bf16 s_y[8][kSlots];
    const long long base = (long long)blockIdx.x * n;
    for (int e = threadIdx.x; e < 8 * n; e += kThreads) {
        const long long a = (long long)(e / n) * len + base + e % n;
        out[a] = kChain ? x[a] : 0.0f;
    }
    const int per = (n + kThreads - 1) / kThreads;
    const int first = min(threadIdx.x * per, n), last = min(first + per, n);
    const int row = threadIdx.x / kSlots, j = threadIdx.x % kSlots;
    const float* src = kChain ? out : x;
    for (int c = 0; c < iters; ++c) {
        const int cc = kFixedS ? 0 : c;
        int cnt = 0;
        for (int i = first; i < last; ++i) cnt += interest(i, cc);
        int total;
        int rank = rk::block_exclusive_scan(cnt, s_warp, &total);
        for (int i = first; i < last && rank < kSlots; ++i)
            if (interest(i, cc)) s_lane[rank++] = i;
        const int nsel = min(total, kSlots);
        __syncthreads();
        const long long a = (long long)row * len + base + (j < nsel ? s_lane[j] : 0);
        if (j < nsel) s_g[row][j] = __float2bfloat16_rn(src[a]);
        __syncthreads();
        if (j < nsel)
            s_y[row][j] = __float2bfloat16_rn(__bfloat162float(s_g[row][j]) * 1.0001f + 0.5f);
        __syncthreads();
        if (j < nsel) {
            const float z = __bfloat162float(s_y[row][j]);
            out[a] = kChain ? out[a] + z * 1e-6f : out[a] + z;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
sel_kernel(const bf16* __restrict__ x, float* __restrict__ out, long long len,
           int n, int iters) {
    extern __shared__ signed char s_mr[];   // m (n bytes), then rank_m (n)
    signed char* s_m = s_mr;
    signed char* s_rank = s_mr + n;
    __shared__ float s_g[24][kSlots];
    __shared__ bf16 s_y[6][kSlots];
    const long long base = (long long)blockIdx.x * n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int e = threadIdx.x; e < 8 * n; e += kThreads)
        out[(long long)(e / n) * len + base + e % n] = 0.0f;
    int nk = 0;   // shifts k = 1, 2, 4, ... < n; rank_m < nk
    for (int k = 1; k < n; k *= 2) ++nk;
    const int nslots = min(nk, kSlots);
    for (int c = 0; c < iters; ++c) {
        for (int i = threadIdx.x; i < n; i += kThreads) s_m[i] = interest(i, c);
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += kThreads) {
            int rank = -s_m[i];
            for (int k = 1; k < n; k *= 2)
                if (i >= k) rank += s_m[i - k];
            s_rank[i] = s_m[i] ? rank : -1;
        }
        __syncthreads();
        for (int s = warp; s < nslots; s += kWarps) {
            float acc = 0.0f;
            for (int i0 = 0; i0 < n; i0 += 32) {
                unsigned bal = __ballot_sync(kFull, i0 + lane < n && s_rank[i0 + lane] == s);
                while (bal) {
                    const int i = i0 + __ffs(bal) - 1;
                    bal &= bal - 1u;
                    if (lane < 24)
                        acc = acc + __bfloat162float(x[(long long)lane * len + base + i]);
                }
            }
            if (lane < 24) s_g[lane][s] = acc;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < 6 * nslots; e += kThreads) {
            const int r = e / nslots, s = e % nslots;
            s_y[r][s] = __float2bfloat16_rn((s_g[r][s] + s_g[6 + r][s]) + s_g[12 + r][s]);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int s = s_rank[i];
            if (s < 0) continue;
            for (int r = 0; r < 6; ++r) {
                float* o = out + (long long)r * len + base + i;
                *o = *o + __bfloat162float(s_y[r][s]);
            }
        }
    }
}

enum CycleMode { kFullMode = 0, kNoMm = 1, kFixedMode = 2 };

template <CycleMode kMode>
__global__ void __launch_bounds__(kThreads)
cycle_kernel(const float* __restrict__ x, float* __restrict__ out, long long len,
             int n, int iters) {
    __shared__ float s_g[24][kSlots];
    __shared__ bf16 s_y[6][kSlots];
    const long long base = (long long)blockIdx.x * n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < n; i += kThreads) out[base + i] = 0.0f;
    __syncthreads();
    const float inc = round_bf16(1e-9f);
    for (int c = 0; c < iters; ++c) {
        const int off = (-8 * c) & 63;   // (lane + 8c) & 63 == 0
        if (kMode == kNoMm) {
            for (int q = threadIdx.x; 64 * q + off < n; q += kThreads)
                out[base + 64 * q + off] += inc;
            continue;
        }
        for (int s = warp; s < kSlots; s += kWarps) {
            if (lane >= 24) continue;
            float acc = 0.0f;
            for (int t = 0;; ++t) {
                const int i = kMode == kFullMode ? 64 * (s + kSlots * t) + off
                                                 : s + kSlots * t;
                if (i >= n) break;
                acc = acc + round_bf16(x[(long long)lane * len + base + i]);
            }
            s_g[lane][s] = acc;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < 6 * kSlots; e += kThreads)
            s_y[e / kSlots][e % kSlots] =
                __float2bfloat16_rn(s_g[e / kSlots][e % kSlots] * 1.0001f + 0.5f);
        __syncthreads();
        if (kMode == kFullMode) {
            for (int q = threadIdx.x; 64 * q + off < n; q += kThreads)
                out[base + 64 * q + off] += __bfloat162float(s_y[0][q & (kSlots - 1)]);
        } else {
            for (int i = threadIdx.x; i < n; i += kThreads)
                out[base + i] += __bfloat162float(s_y[0][i & (kSlots - 1)]);
        }
    }
}

int check_shape(long long len, int n, int iters) {
    return (n <= 0 || len <= 0 || len % n || iters < 0) ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// x, out (8, len) f32; programs of n lanes (len a multiple of n).
extern "C" int rk_permute(const float* x, float* out, long long len, int n,
                          int iters, int chain, int fixed_s, void* stream) {
    if (const int e = check_shape(len, n, iters)) return e;
    const unsigned grid = (unsigned)(len / n);
    cudaStream_t st = (cudaStream_t)stream;
    if (chain && fixed_s)
        permute_kernel<true, true><<<grid, kThreads, 0, st>>>(x, out, len, n, iters);
    else if (chain)
        permute_kernel<true, false><<<grid, kThreads, 0, st>>>(x, out, len, n, iters);
    else if (fixed_s)
        permute_kernel<false, true><<<grid, kThreads, 0, st>>>(x, out, len, n, iters);
    else
        permute_kernel<false, false><<<grid, kThreads, 0, st>>>(x, out, len, n, iters);
    return (int)cudaGetLastError();
}

// x (24, len) bf16 -> out (8, len) f32; n <= 16,384 lanes a program.
extern "C" int rk_sel(const uint16_t* x, float* out, long long len, int n,
                      int iters, void* stream) {
    if (const int e = check_shape(len, n, iters)) return e;
    if (n > 16384) return (int)cudaErrorInvalidValue;
    sel_kernel<<<(unsigned)(len / n), kThreads, 2 * (size_t)n, (cudaStream_t)stream>>>(
        reinterpret_cast<const bf16*>(x), out, len, n, iters);
    return (int)cudaGetLastError();
}

// x (24, len) f32 -> out (1, len) f32; mode 0 full, 1 no_mm, 2 fixed_s.
extern "C" int rk_cycle(const float* x, float* out, long long len, int n,
                        int iters, int mode, void* stream) {
    if (const int e = check_shape(len, n, iters)) return e;
    const unsigned grid = (unsigned)(len / n);
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == kFullMode)
        cycle_kernel<kFullMode><<<grid, kThreads, 0, st>>>(x, out, len, n, iters);
    else if (mode == kNoMm)
        cycle_kernel<kNoMm><<<grid, kThreads, 0, st>>>(x, out, len, n, iters);
    else if (mode == kFixedMode)
        cycle_kernel<kFixedMode><<<grid, kThreads, 0, st>>>(x, out, len, n, iters);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
