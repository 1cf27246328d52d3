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
// What bounds it on this card. The stages: the block-wide rank, a chain
// of shuffles and barriers per 1,024 lanes; their bytes are a few KB.
// diag: its bytes (the mask once, 36 bytes of payload and 24 of truth a
// ray that wants a cluster, the four outputs) are a few MB, 2 us at the
// HBM rate; its work is about 5,500 ray-cluster round trips a program of
// 2,048 rays on the probe's wavefront, some 43 rounds of 128 slots each,
// each a chain of dependent steps (rank, move, slot test, read back):
// run one after another in a program, they leave most of the card idle.
//
// What the design does about it. The stages: one block of 1,024 threads
// (or a grid of lane blocks for stage 5), a lane's mask bit and rank in
// registers, the rank a warp shuffle scan plus a shared scan of the 32
// warp sums, the 128 slots a shared bf16 tile written by the selected
// lanes and read back by them. diag: the rounds are independent (their
// slots hold distinct rays, and a ray's outputs combine over rounds by a
// max and a count), so a block of 16 warps for each (program, mask
// word) reads its rays' words w once into shared memory, forms that
// word of the union, and counts each wanted cluster's rays by ballots;
// its (cluster, round) items go round its warps, each on a tile of its
// own synced by __syncwarp, and run concurrently over the card
// (expand_diag_kernel says how). A program takes up to kDiagMaxRays =
// 16,384 rays. The TPU
// kernels' selection matrices and their matmuls have no counterpart: a
// lane moves its payload with stores and loads.
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSlots = 128;
constexpr int kMaxChunks = 4;            // the stages' lanes <= 4,096
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

// --- diag

// The diagnostics kernel's design: the most warps a block, each running
// one item at a time on a tile of its own (a launch takes the most of
// kDiagWarps, half that, ... down to 1 whose tiles fit beside the
// program's words: all 16 up to kDiagMaxRays).
constexpr int kDiagWarps = 16;

constexpr int kDiagMaxRays = 16384;   // rays a program, at most
// the dynamic shared memory a block may use, beside its static variables
constexpr int kSmemLimit = 232448 - 1024;

// An item's tile: the 24 bf16 payload rows of its 128 slots (rows 0-17
// then hold the slot's split3 digits: o's hi, md, lo in rows 0-2, 3-5,
// 6-8, d's in 9-11, 12-14, 15-17) and each slot's owner.
struct DiagTile {
    bf16 row[24][kSlots];
    int owner[kSlots];
};

// A block's dynamic shared memory: a tile a warp, the program's words w
// in whole chunks of 32 rays, and for each wanted cluster the rays with
// its bit before each chunk (fewer than 2^16).
size_t diag_smem(int n, int warps) {
    const size_t chunks = (n + 31) / 32;
    return sizeof(DiagTile) * warps + 4 * 32 * chunks + 2 * 32 * chunks;
}

// v = max(v, x) on a zeroed v, x >= +0 or a NaN with its sign bit clear
// (every value here comes from fabsf): their bit patterns order them as
// floats do, with a NaN above +inf, as max_nan does (a NaN from the
// card's arithmetic is its one canonical NaN).
__device__ __forceinline__ void merge_max(float* v, float x) {
    const int bits = __float_as_int(x);
    if (bits > 0) atomicMax(reinterpret_cast<int*>(v), bits);
}

// Block (program, word w). It reads the program's rays' words w once into
// shared memory and ORs them into the union's word w. For each set bit k
// (a wanted cluster, ascending) one warp counts, by a ballot over each 32
// rays, the rays with bit k before every chunk of 32 (a warp scan of 32
// chunks' popcounts at a time). The items (cluster, round of 128 ranks)
// go round the block's warps, each on its own tile, synced by
// __syncwarp alone: the warp finds the chunks holding ranks rb to rb +
// 127 by bisection, and per chunk a ballot ranks its rays (the count
// before the chunk plus the popcount below the lane); the selected rays
// write their lane and 24 payload rows into their slots; each slot
// rebuilds o and d and splits them into bf16 digits in place; each
// selected ray reads its slot back (owner and digits) against its truth
// rows. A ray's outputs merge over items and blocks in any order: nc by atomicAdd, v1-v3 by
// merge_max into outputs zeroed first.
__global__ void __launch_bounds__(32 * kDiagWarps)
expand_diag_kernel(const int* __restrict__ mask, const bf16* __restrict__ pay,
                   const float* __restrict__ otrue, long long r_total, int n,
                   float* __restrict__ v1_out, float* __restrict__ v2_out,
                   int* __restrict__ nc_out, float* __restrict__ v3_out) {
    extern __shared__ __align__(16) unsigned char s_raw[];
    __shared__ unsigned s_union;
    __shared__ int s_bit[32], s_count[32], s_first[33];
    const int chunks = (n + 31) / 32;
    const int warps = blockDim.x >> 5;
    DiagTile* s_tile = reinterpret_cast<DiagTile*>(s_raw);
    unsigned* s_word = reinterpret_cast<unsigned*>(s_tile + warps);
    uint16_t* s_pre = reinterpret_cast<uint16_t*>(s_word + 32 * chunks);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const long long base = (long long)blockIdx.x * n;

    if (threadIdx.x == 0) s_union = 0;
    __syncthreads();
    const int* words = mask + blockIdx.y * r_total + base;
    unsigned u = 0;
    for (int i = threadIdx.x; i < 32 * chunks; i += blockDim.x) {
        const unsigned v = i < n ? (unsigned)words[i] : 0u;
        s_word[i] = v;
        u |= v;
    }
    u = __reduce_or_sync(kFull, u);
    if (lane == 0 && u) atomicOr(&s_union, u);
    __syncthreads();
    const unsigned uni = s_union;
    if (!uni) return;
    const int wanted = __popc(uni);

    for (int b = warp; b < wanted; b += warps) {
        unsigned bits = uni;
        for (int e = 0; e < b; ++e) bits &= bits - 1u;
        const int k = __ffs(bits) - 1;
        uint16_t* pre = s_pre + b * chunks;
        int carry = 0;
        for (int q0 = 0; q0 < chunks; q0 += 32) {
            const int m = min(32, chunks - q0);
            int mine = 0;
            for (int j = 0; j < m; ++j) {
                const unsigned bal =
                    __ballot_sync(kFull, (s_word[32 * (q0 + j) + lane] >> k) & 1u);
                if (lane == j) mine = __popc(bal);
            }
            int incl = mine;
            for (int off = 1; off < 32; off <<= 1) {
                const int t = __shfl_up_sync(kFull, incl, off);
                if (lane >= off) incl += t;
            }
            if (lane < m) pre[q0 + lane] = (uint16_t)(carry + incl - mine);
            carry += __shfl_sync(kFull, incl, 31);
        }
        if (lane == 0) {
            s_bit[b] = k;
            s_count[b] = carry;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int items = 0;
        for (int b = 0; b < wanted; ++b) {
            s_first[b] = items;
            items += (s_count[b] + kSlots - 1) / kSlots;
        }
        s_first[wanted] = items;
    }
    __syncthreads();

    DiagTile& tile = s_tile[warp];
    for (int item = warp; item < s_first[wanted]; item += warps) {
        int b = 0;
        while (s_first[b + 1] <= item) ++b;
        const int k = s_bit[b], rb = (item - s_first[b]) * kSlots;
        const int nsel = min(kSlots, s_count[b] - rb);
        const uint16_t* pre = s_pre + b * chunks;
        // chunks q0 (the last with at most rb rays before it) to q1 (the
        // first with rb + 128 or more) hold the item's ranks
        int q0 = 0;
        for (int hi = chunks - 1; q0 < hi;) {
            const int mid = (q0 + hi + 1) >> 1;
            if (pre[mid] <= rb) q0 = mid;
            else hi = mid - 1;
        }
        int q1 = q0;
        for (int hi = chunks; q1 < hi;) {
            const int mid = (q1 + hi) >> 1;
            if (pre[mid] < rb + kSlots) q1 = mid + 1;
            else hi = mid;
        }
        // a lane's ray of chunk q is selected where its rank (the rays
        // before the chunk and those below the lane) falls in the round
        auto select = [&](int q, int* slot) {
            const bool m = (s_word[32 * q + lane] >> k) & 1u;
            const unsigned bal = __ballot_sync(kFull, m);
            *slot = pre[q] + __popc(bal & below) - rb;
            return m && *slot >= 0 && *slot < kSlots;
        };
        for (int q = q0; q < q1; ++q) {
            int s;
            if (!select(q, &s)) continue;
            const int i = 32 * q + lane;
            tile.owner[s] = i;
            const bf16* src = pay + base + i;
#pragma unroll
            for (int r = 0; r < 24; ++r) tile.row[r][s] = src[r * r_total];
        }
        __syncwarp();
        for (int j = lane; j < nsel; j += 32) {
            float g[18];
#pragma unroll
            for (int r = 0; r < 18; ++r) g[r] = __bfloat162float(tile.row[r][j]);
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const float go = (g[r] + g[6 + r]) + g[12 + r];
                const float gd = (g[3 + r] + g[9 + r]) + g[15 + r];
                split3(go, &tile.row[r][j], &tile.row[3 + r][j], &tile.row[6 + r][j]);
                split3(gd, &tile.row[9 + r][j], &tile.row[12 + r][j], &tile.row[15 + r][j]);
            }
        }
        __syncwarp();
        for (int q = q0; q < q1; ++q) {
            int s;
            if (!select(q, &s)) continue;
            const int i = 32 * q + lane;
            const long long o = base + i;
            const float z1 = tile.owner[s] == i ? 1.0f : 0.0f;
            float dvo = 0.0f, dvd = 0.0f;
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const float bo = (__bfloat162float(tile.row[r][s]) +
                                  __bfloat162float(tile.row[3 + r][s])) +
                                 __bfloat162float(tile.row[6 + r][s]);
                const float bd = (__bfloat162float(tile.row[9 + r][s]) +
                                  __bfloat162float(tile.row[12 + r][s])) +
                                 __bfloat162float(tile.row[15 + r][s]);
                const float eo = fabsf(bo - otrue[r * r_total + o]);
                const float ed = fabsf(bd - otrue[(3 + r) * r_total + o]);
                dvo = r == 0 ? eo : max_nan(dvo, eo);
                dvd = r == 0 ? ed : max_nan(dvd, ed);
            }
            atomicAdd(nc_out + o, 1);
            merge_max(v1_out + o, fabsf(z1 - 1.0f));
            merge_max(v3_out + o, dvo);
            merge_max(v2_out + o, dvd);
        }
        __syncwarp();   // the tile is the next item's
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
// rays (r a multiple of n, n <= kDiagMaxRays = 16,384) -> v1, v2, v3
// (r,) f32, nc (r,) int32, zeroed here first; a block for each (program,
// mask word).
extern "C" int rk_expand_diag(const int* mask, int cwp, const uint16_t* pay,
                              const float* otrue, long long r, int n, float* v1,
                              float* v2, int* nc, float* v3, void* stream) {
    if (cwp <= 0 || cwp > 65535 || n <= 0 || n > kDiagMaxRays || r % n ||
        r / n > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    for (void* out : {(void*)v1, (void*)v2, (void*)nc, (void*)v3})
        if (const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)r * 4, st))
            return (int)e;
    // the attribute set once, to the most a block may use, before any
    // graph captures a launch; the most warps whose tiles fit
    static const cudaError_t attr = cudaFuncSetAttribute(
        expand_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (attr) return (int)attr;
    int warps = kDiagWarps;
    while (warps > 1 && diag_smem(n, warps) > kSmemLimit) warps /= 2;
    expand_diag_kernel<<<dim3((unsigned)(r / n), (unsigned)cwp), 32 * warps,
                         diag_smem(n, warps), st>>>(
        mask, reinterpret_cast<const bf16*>(pay), otrue, r, n, v1, v2, nc, v3);
    return (int)cudaGetLastError();
}
