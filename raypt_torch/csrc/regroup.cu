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
// Every probe runs `iters` cycles c on each program of n lanes. A cycle
// picks interested lanes, gives them slots, moves their payload rows into a 128-slot tile, runs a stand-in test on the slots
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
// What bounds it on this card. permute: its bytes, x in (in summed mode
// only the lanes a cycle selects) and the output out, once: 33.5 MB each
// at the probes' 8,192 lanes and 128 programs; then the rank, a scan of
// each cycle's lanes up to the 128th interested one (about 5,100 of
// them) at a few integer operations a lane; cycles run in order would
// add a barrier-bound move through the slots each (the slot tile design).
// cycle: the (slot, cycle) sums, n / 128 adds each in fixed_s (64 at the
// script's n of 8,192: 67M adds over 64 cycles and 128 programs), a few
// in full; its bytes are row 0 of the selected lanes and the output,
// once. sel: one interest test per (lane, cycle) and, on the about 5/199
// interested lanes, the shifted sums (log2 n terms); its bytes are the
// output, written once (no lane reaches a slot, so no x is read).
//
// What the design does about it. permute: the selection never reads x,
// and a cycle's update of a lane reads only that lane's rows, so a lane's
// result is its count k of selecting cycles applied to its own rows in
// cycle order. One block of 1,024 threads a program ranks the cycles at
// once, a warp a cycle (rank_cycle: per 32 lanes one ballot of the
// interest tests and its popcount, the exclusive rank of a lane the count
// before its 32 lanes plus the popcount of the ballot below it, the scan
// stopped once 128 lanes are found; no block-wide barrier), the selected
// lanes adding to their counts in shared memory; then each thread loads
// its lanes' 8 rows once (neighbouring threads, neighbouring lanes),
// applies their k steps in registers and writes them once, zeros and
// untouched lanes included; lanes of many steps (fixed_s: every selected
// lane, iters of them) are packed 32 to a warp first, so no warp waits
// on one thread's steps. Past kPermuteWindow lanes the counts are
// held a window at a time (each window's ranks again from lane 0, up to
// the last lane a scan reached), so any n and iters run. The slot tile
// design of the sweep (kPermuteSlots 1) keeps the first kernel's move:
// the same ballot ranks, 32 cycles at once into lists of selected lanes,
// then per cycle in order the lanes' values into the shared bf16 tile,
// the test there and the way back to the output, behind three barriers.
// cycle: a lane's slot does not depend on the cycle ((lane >> 6) & 127 in
// full and no_mm, lane & 127 in fixed_s) and no cycle reads another's
// result, so each program splits into groups of kCycleGroup slots, one
// block each (rk_cycle launches as many groups as cover the slots that
// hold a lane), which owns its slots' lanes over all cycles. Its lanes
// are runs of kCycleGroup slots' lanes, kPeriod apart. The block stages
// bf16(x[0, lane]) of the lanes a cycle can select (in full every eighth
// lane) in shared memory, up to kCycleStage values at once: once, where
// its runs fit, else a chunk of runs at a time for each chunk of cycles;
// row 0 is the only row that reaches the output. For a chunk of
// 4 * kCycleThreads / kCycleGroup cycles at a time, each thread sums four
// neighbouring slots of one cycle in ascending lane order from 0 (16-byte
// shared loads; the sum carried over the staged chunks of runs in
// registers; lanes past n read as +0.0, which leaves a sum that starts at
// +0.0 unchanged) and writes their y0 = bf16(g * 1.0001 + 0.5) to shared
// memory. A lane's total depends only on its slot and, in full and
// no_mm, on lane % 64 / 8 (the cycles mod 8 that select it), so after one
// barrier thread (q, slot) adds, in cycle order and in registers, the y0
// of its slot in the cycles that select q (every cycle in fixed_s); no_mm
// adds bf16(1e-9) and stages nothing. Then every lane of the block's runs
// is written once, coalesced, from these 8 * kCycleGroup totals, zeros
// included; so a program takes any number of lanes. Every cycle's sums
// are computed, also in fixed_s where they repeat. The design block below
// (threads a block, slots a block, values staged at once) was swept on
// the card (`kernels/sweep.py --kernels regroup`, the probe's six calls
// from CUDA graphs, NVIDIA H100 80GB HBM3, 700.00 W): 128 threads in
// groups of 8 slots 33.0-33.6 us, 64 threads 33.0-33.1, 2,048 values
// staged against 256 (fixed_s restaged) 34.3-34.5, groups of 16 slots
// 36.6-36.8 (256 threads 37.0-37.1), of 4 44.0-44.2; the first kernel,
// one block of 1,024 threads a program, 9,243-9,245.
// sel: one block of 1,024 threads per program (at most 16,384 lanes).
// The interest depends only on (lane, c), and so does the rank: lane i
// is interested where its residue r = (37 i + 131 c) mod 199 is below 5,
// and its shifted sum then counts the shifts k = 2^j <= i whose lane
// i - k is interested too, residue r - 37 k mod 199. So each lane first
// sums, for each of the 5 residues, its shifted terms (37 * 2^j mod 199
// doubles with j) into a 5-bit mask of the residues that give it a slot;
// then, for every cycle, it carries its residue to the next cycle and
// tests it against the mask: one interest test per (lane, cycle), in
// registers, no branch, nothing in shared memory. The lanes and cycles
// are spread over the block's threads, with no barrier between cycles. One
// __syncthreads_or decides whether any (lane, cycle) of the program has
// a slot. With the probe's interest none has, and the block writes its
// zero output once (rows 6-7 before the tests, rows 0-5 after). Else the
// general path runs the cycles in order: the ranks into shared memory,
// warp s sums slot s's lanes in ascending lane order with a ballot over
// each 32 lanes, then y, and each lane adds its slot's y in registers
// (for each 1,024 lanes at a time, the cycles again); rows 0-5 are then
// written once. The interest's four constants stand in one block below:
// a test builds sel with a wider interest (residues below 32) to reach
// that path, which the probe's never does.
// The TPU kernels' selection matrices, their matmuls and the
// Hillis-Steele lane scan have no counterpart.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;   // sel's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 128;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The probes' interest: lane i is interested in cycle c when
// (i * kStride + c * kShift) % kModulus < kWidth.
constexpr int kStride = 37;
constexpr int kShift = 131;
constexpr int kModulus = 199;
constexpr int kWidth = 5;

// --- permute

// The permute kernel's design: kPermuteSlots 0 keeps each lane's rows in
// registers over the cycles that select it (the package's design), 1
// moves each cycle's lanes through the 128-slot tile, cycles in order
// (the sweep's "slot_tile"); kPermuteWindow lanes' selection counts held
// in shared memory at once; kRankWords ballots of a scan between two
// tests of its count; lanes with more than kPermuteHeavy selecting cycles
// taken from a packed list, 32 to a warp.
constexpr int kPermuteSlots = 0;
constexpr int kPermuteWindow = 6144;
constexpr int kRankWords = 8;
constexpr int kPermuteHeavy = 4;

constexpr int kPermuteThreads = 1024;
constexpr int kPermuteWarps = kPermuteThreads / 32;
constexpr int kListCycles = 32;      // cycles ranked at once by the slot tile design
constexpr int kStep32 = (32 * kStride) % kModulus;   // a lane's residue 32 lanes on

// Cycle c's selection, by one warp: lane l of the warp tests lane i0 + l
// of each 32 lanes from lane 0 (its residue stepped by kStep32), a ballot
// gathers the 32 tests, and the interested lanes are counted; an
// interested lane with rank (interested lanes before it) below kSlots is
// selected, sel(i, rank). The count is tested every kRankWords words;
// while it stays within kSlots every interested lane is selected, so the
// rank test runs only in the words where it passes kSlots, and the scan
// stops after them. Returns the lanes found (min'd with kSlots: the slots
// filled); *stop gets the lane where the scan stopped, below which every
// selected lane lies (n where fewer than kSlots lanes are interested).
template <class Sel>
__device__ __forceinline__ int rank_cycle(int c, int n, int* stop, Sel sel) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    int r = (lane * kStride + (c % kModulus) * kShift) % kModulus;
    int found = 0, i0 = 0;
    while (i0 < n && found < kSlots) {
        const bool whole = i0 + 32 * kRankWords <= n;
        bool m[kRankWords];
        unsigned bal[kRankWords];
        int total = found;
#pragma unroll
        for (int u = 0; u < kRankWords; ++u) {
            m[u] = (whole || i0 + 32 * u + lane < n) && r < kWidth;
            bal[u] = __ballot_sync(kFull, m[u]);
            total += __popc(bal[u]);
            r = r + kStep32 >= kModulus ? r + kStep32 - kModulus : r + kStep32;
        }
        if (total <= kSlots) {
#pragma unroll
            for (int u = 0; u < kRankWords; ++u) {
                if (m[u]) sel(i0 + 32 * u + lane, found + __popc(bal[u] & below));
                found += __popc(bal[u]);
            }
        } else {
#pragma unroll
            for (int u = 0; u < kRankWords; ++u) {
                const int rank = found + __popc(bal[u] & below);
                if (m[u] && rank < kSlots) sel(i0 + 32 * u + lane, rank);
                found += __popc(bal[u]);
            }
        }
        i0 += 32 * kRankWords;
    }
    *stop = min(i0, n);
    return min(found, kSlots);
}

// bf16(bf16(v) * 1.0001 + 0.5): a slot's stand-in test of one value.
__device__ __forceinline__ float permute_y(float v) {
    return round_bf16(round_bf16(v) * 1.0001f + 0.5f);
}

// A lane's 8 rows through the k cycles that select it, in registers: a
// cycle's update reads only the lane's own rows, so they are k steps of
// the same update, the 8 rows side by side. Chained, x += y * 1e-6 each
// step, y recomputed from the new x; summed, the output adds y (the same
// each step) k times from 0.
template <bool kChain>
__device__ __forceinline__ void permute_steps(float (&v)[8], int k) {
    if (kChain) {
        for (int e = 0; e < k; ++e)
#pragma unroll
            for (int r = 0; r < 8; ++r) v[r] = v[r] + permute_y(v[r]) * 1e-6f;
    } else {
        float y[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            y[r] = permute_y(v[r]);
            v[r] = 0.0f;
        }
        for (int e = 0; e < k; ++e)
#pragma unroll
            for (int r = 0; r < 8; ++r) v[r] = v[r] + y[r];
    }
}

// One block a program. Its warps rank the cycles at once (warp w cycles
// w, w + 32, ...), each selected lane adding its cycle to its count in
// shared memory, for the lanes of one window of kPermuteWindow lanes at
// a time; then each thread takes lanes of the window (neighbouring
// threads neighbouring lanes, two at a time) through their counts, and
// lanes with more than kPermuteHeavy steps, which would hold a warp for
// one busy thread, go to a list taken 32 lanes to a warp after one more
// barrier. Windows past the last lane any cycle can select (the scans'
// largest stop, known after the first) are not ranked: their lanes are
// written with count 0. So two barriers a window, none a cycle.
template <bool kChain, bool kFixedS>
__global__ void __launch_bounds__(kPermuteThreads)
permute_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long len, int n, int iters) {
    __shared__ int s_count[kPermuteWindow];
    __shared__ uint16_t s_heavy[kPermuteWindow];
    __shared__ int s_stop, s_nheavy;
    const long long base = (long long)blockIdx.x * n;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // fixed_s: cycle 0's selection, ranked once, stands for every cycle
    const int ranked = kFixedS ? min(iters, 1) : iters;
    const int weight = kFixedS ? iters : 1;
    if (threadIdx.x == 0) s_stop = 0;
    for (int w0 = 0;; w0 += kPermuteWindow) {
        const int w1 = (int)min((long long)n, (long long)w0 + kPermuteWindow);
        for (int i = threadIdx.x; i < w1 - w0; i += kPermuteThreads) s_count[i] = 0;
        if (threadIdx.x == 0) s_nheavy = 0;
        __syncthreads();
        int* count = s_count;
        for (int c = warp; c < ranked; c += kPermuteWarps) {
            int stop;
            rank_cycle(c, n, &stop, [=](int i, int) {
                if (i >= w0 && i < w1) atomicAdd(count + (i - w0), weight);
            });
            if (lane == 0) atomicMax(&s_stop, stop);
        }
        __syncthreads();
        const bool last = w1 >= s_stop;
        const int end = last ? n : w1;
        for (int i = w0 + threadIdx.x; i < end; i += 2 * kPermuteThreads) {
            float v[2][8];
            int k[2];
            bool own[2];
#pragma unroll
            for (int l = 0; l < 2; ++l) {
                const int il = i + l * kPermuteThreads;
                k[l] = il < w1 ? s_count[il - w0] : 0;
                own[l] = il < end && k[l] <= kPermuteHeavy;
                if (k[l] > kPermuteHeavy) s_heavy[atomicAdd(&s_nheavy, 1)] = il - w0;
                // a lane no cycle selects reads nothing in summed mode
                const bool load = own[l] && (kChain || k[l]);
#pragma unroll
                for (int r = 0; r < 8; ++r)
                    v[l][r] = load ? x[r * len + base + il] : 0.0f;
            }
#pragma unroll
            for (int l = 0; l < 2; ++l) {
                if (!own[l]) continue;
                const int il = i + l * kPermuteThreads;
                permute_steps<kChain>(v[l], k[l]);
#pragma unroll
                for (int r = 0; r < 8; ++r) out[r * len + base + il] = v[l][r];
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < s_nheavy; e += kPermuteThreads) {
            const int il = w0 + s_heavy[e];
            float v[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) v[r] = x[r * len + base + il];
            permute_steps<kChain>(v, s_count[il - w0]);
#pragma unroll
            for (int r = 0; r < 8; ++r) out[r * len + base + il] = v[r];
        }
        if (last) return;
        __syncthreads();   // s_count and s_heavy are the next window's
    }
}

// The slot tile design (kPermuteSlots 1): the output first set to x
// (chained) or 0; the warps rank kListCycles cycles at once into lists of
// their selected lanes; then, cycle by cycle in order, thread (row, slot)
// moves its lane's value into the shared bf16 tile, thread (slot, row)
// tests it there, and thread (row, slot) adds the result back to the
// lane in the output: three barriers a cycle.
template <bool kChain, bool kFixedS>
__global__ void __launch_bounds__(kPermuteThreads)
permute_slots_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long len, int n, int iters) {
    __shared__ int s_lane[kListCycles][kSlots];
    __shared__ int s_nsel[kListCycles];
    __shared__ bf16 s_g[8][kSlots];
    __shared__ bf16 s_y[8][kSlots];
    const long long base = (long long)blockIdx.x * n;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = 0; r < 8; ++r)
        for (int i = threadIdx.x; i < n; i += kPermuteThreads) {
            const long long a = r * len + base + i;
            out[a] = kChain ? x[a] : 0.0f;
        }
    const float* src = kChain ? out : x;
    const int row = threadIdx.x / kSlots, j = threadIdx.x % kSlots;   // move, way back
    const int trow = threadIdx.x % 8, tj = threadIdx.x / 8;           // the test
    for (int c0 = 0; c0 < iters; c0 += kListCycles) {
        const int chunk = min(kListCycles, iters - c0);
        const int lists = kFixedS ? (c0 == 0) : chunk;
        for (int e = warp; e < lists; e += kPermuteWarps) {
            int stop;
            int* list = s_lane[e];
            const int nsel = rank_cycle(kFixedS ? 0 : c0 + e, n, &stop,
                                        [=](int i, int rank) { list[rank] = i; });
            if (lane == 0) s_nsel[e] = nsel;
        }
        __syncthreads();
        for (int e = 0; e < chunk; ++e) {
            const int l = kFixedS ? 0 : e;
            const int nsel = s_nsel[l];
            const long long a = (long long)row * len + base + (j < nsel ? s_lane[l][j] : 0);
            if (j < nsel) s_g[row][j] = __float2bfloat16_rn(src[a]);
            __syncthreads();
            if (tj < nsel)
                s_y[trow][tj] = __float2bfloat16_rn(__bfloat162float(s_g[trow][tj]) * 1.0001f + 0.5f);
            __syncthreads();
            if (j < nsel) {
                const float z = __bfloat162float(s_y[row][j]);
                out[a] = kChain ? out[a] + z * 1e-6f : out[a] + z;
            }
            __syncthreads();   // the next cycle reads the lanes this one wrote
        }
    }
}

template <bool kChain, bool kFixedS>
void launch_permute(const float* x, float* out, long long len, int n, int iters,
                    cudaStream_t st) {
    const unsigned grid = (unsigned)(len / n);
    if constexpr (kPermuteSlots != 0)
        permute_slots_kernel<kChain, kFixedS><<<grid, kPermuteThreads, 0, st>>>(
            x, out, len, n, iters);
    else
        permute_kernel<kChain, kFixedS><<<grid, kPermuteThreads, 0, st>>>(
            x, out, len, n, iters);
}

// --- sel

constexpr int kSelLanes = 16384;   // lanes a program, at most
constexpr int kSelShifts = 14;     // k = 1, 2, ..., 8,192: ranks < 14

// (i * kStride + c * kShift) mod kModulus, for any i, c >= 0.
__device__ __forceinline__ int residue(int i, int c) {
    return ((i % kModulus) * kStride + (c % kModulus) * kShift) % kModulus;
}

// rank_m of lane i, interested (residue r < kWidth): the shifted sum of
// m[i - k] over k = 1, 2, 4, ... <= i (so k < n), minus 1. The residue of
// lane i - k is r - kStride * k mod kModulus, and kStride * k mod
// kModulus doubles with k.
__device__ __forceinline__ int sel_rank(int i, int r) {
    int rank = -1;
    int a = kStride % kModulus;
    for (int k = 1; k <= i; k *= 2) {
        const int t = r >= a ? r - a : r - a + kModulus;
        rank += t < kWidth;
        a = 2 * a >= kModulus ? 2 * a - kModulus : 2 * a;
    }
    return rank;
}

// Bit r (< kWidth) set where an interested lane i of residue r has a
// slot: some shift k <= i with (r - kStride k) mod kModulus < kWidth,
// i.e. r in [a, a + kWidth) for a = kStride k mod kModulus below kWidth,
// or r < a + kWidth - kModulus for a above kModulus - kWidth.
static_assert(kWidth <= 32, "a 32-bit residue mask");
__device__ __forceinline__ unsigned slot_mask(int i) {
    constexpr unsigned kAll = kWidth == 32 ? ~0u : (1u << kWidth) - 1u;
    unsigned mask = 0;
    int a = kStride % kModulus;
    for (int k = 1; k <= i; k *= 2) {
        if (a < kWidth) mask |= kAll & ~((1u << a) - 1u);
        if (a > kModulus - kWidth) mask |= (1u << (a + kWidth - kModulus)) - 1u;
        a = 2 * a >= kModulus ? 2 * a - kModulus : 2 * a;
    }
    return mask;
}

__global__ void __launch_bounds__(kThreads)
sel_kernel(const bf16* __restrict__ x, float* __restrict__ out, long long len,
           int n, int iters) {
    __shared__ signed char s_rank[kSelLanes];
    __shared__ float s_g[24][kSelShifts];
    __shared__ float s_y[6][kSelShifts];
    const long long base = (long long)blockIdx.x * n;
    for (int r = 6; r < 8; ++r)   // rows 6-7 are zero whatever the ranks
        for (int i = threadIdx.x; i < n; i += kThreads)
            out[(long long)r * len + base + i] = 0.0f;
    // every (lane, cycle) at once: `lanes` threads a cycle, the block's
    // threads over kThreads / lanes cycles in flight
    int lanes = 1;
    while (lanes < n && lanes < kThreads) lanes *= 2;
    const int step = kThreads / lanes;
    const int dr = (step % kModulus) * kShift % kModulus;
    const int c0 = threadIdx.x / lanes;
    unsigned found = 0;
    for (int i = threadIdx.x % lanes; i < n; i += lanes) {
        const unsigned mask = slot_mask(i);   // residues with a slot
        int r = residue(i, c0);
        for (int c = c0; c < iters; c += step) {   // m, then its slot
            found |= __funnelshift_rc(mask, 0u, r) & 1u;
            r = r + dr >= kModulus ? r + dr - kModulus : r + dr;
        }
    }
    if (!__syncthreads_or(found)) {   // no lane has a slot in any cycle
        for (int r = 0; r < 6; ++r)
            for (int i = threadIdx.x; i < n; i += kThreads)
                out[(long long)r * len + base + i] = 0.0f;
        return;
    }
    // The general path, cycles in order; for each kThreads lanes (a lane a
    // thread) the ranks and slot sums of every cycle again.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int nk = 0;   // shifts k < n; ranks < nk
    for (int k = 1; k < n; k *= 2) ++nk;
    for (int i0 = 0; i0 < n; i0 += kThreads) {
        const int i = i0 + threadIdx.x;
        float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int c = 0; c < iters; ++c) {
            for (int j = threadIdx.x; j < n; j += kThreads) {
                const int r = residue(j, c);
                s_rank[j] = r < kWidth ? sel_rank(j, r) : -1;
            }
            __syncthreads();
            for (int s = warp; s < nk; s += kWarps) {
                float g = 0.0f;
                for (int j0 = 0; j0 < n; j0 += 32) {
                    unsigned bal = __ballot_sync(
                        kFull, j0 + lane < n && s_rank[j0 + lane] == s);
                    while (bal) {
                        const int j = j0 + __ffs(bal) - 1;
                        bal &= bal - 1u;
                        if (lane < 24)
                            g = g + __bfloat162float(x[(long long)lane * len + base + j]);
                    }
                }
                if (lane < 24) s_g[lane][s] = g;
            }
            __syncthreads();
            for (int e = threadIdx.x; e < 6 * nk; e += kThreads) {
                const int r = e / nk, s = e % nk;
                s_y[r][s] = round_bf16((s_g[r][s] + s_g[6 + r][s]) + s_g[12 + r][s]);
            }
            __syncthreads();
            const int s = i < n ? s_rank[i] : -1;
            if (s >= 0)
                for (int r = 0; r < 6; ++r) acc[r] = acc[r] + s_y[r][s];
            __syncthreads();
        }
        if (i < n)
            for (int r = 0; r < 6; ++r) out[(long long)r * len + base + i] = acc[r];
    }
}

// --- cycle

enum CycleMode { kFullMode = 0, kNoMm = 1, kFixedMode = 2 };

// The cycle kernel's design: threads a block, slots a block (the group),
// values of row 0 staged in shared memory at once.
constexpr int kCycleThreads = 128;
constexpr int kCycleGroup = 8;
constexpr int kCycleStage = 2048;

constexpr int kPairs = 4 * kCycleThreads;   // (slot, cycle) sums a chunk
static_assert(kCycleGroup % 4 == 0 && kPairs % kCycleGroup == 0, "four slots a sum");
static_assert(8 * kCycleGroup <= kCycleThreads, "a lane total a thread");
static_assert(kCycleStage % (8 * kCycleGroup) == 0, "whole runs staged");

// A group's lanes: runs of kCycleGroup * kRun lanes, kPeriod apart, the
// first at group index * kCycleGroup * kRun; kRows staged values a slot
// a run (full: one a cycle mod 8).
template <CycleMode kMode> struct CycleLayout {
    static constexpr int kPeriod = kMode == kFixedMode ? kSlots : 64 * kSlots;
    static constexpr int kRun = kMode == kFixedMode ? 1 : 64;
    static constexpr int kRows = kMode == kFixedMode ? 1 : 8;
};

// Block (program, slot group): slots of the program from its group index
// * kCycleGroup on.
template <CycleMode kMode>
__global__ void __launch_bounds__(kCycleThreads)
cycle_kernel(const float* __restrict__ x, float* __restrict__ out, long long len,
             int n, int iters, int groups) {
    using L = CycleLayout<kMode>;
    constexpr int kQuads = kCycleGroup / 4, kChunk = kPairs / kCycleGroup;
    constexpr int kRunLanes = kCycleGroup * L::kRun;      // lanes a run
    constexpr int kPerRun = L::kRows * kCycleGroup;    // staged values a run
    constexpr int kStageRuns = kCycleStage / kPerRun;
    __shared__ __align__(16) float s_v[kCycleStage];
    __shared__ __align__(16) float s_y[kPairs];
    __shared__ float s_acc[8 * kCycleGroup];
    const long long base = (long long)(blockIdx.x / groups) * n;
    const int first = (blockIdx.x % groups) * kRunLanes;
    const int runs = (n - first + L::kPeriod - 1) / L::kPeriod;
    const int t = threadIdx.x;
    // thread t < 8 * kCycleGroup keeps the total of slot t % kCycleGroup
    // for the lanes with lane % 64 / 8 = q: selected where c % 8 == -q % 8
    const int a_slot = t % kCycleGroup, q = t / kCycleGroup;
    float acc = 0.0f;
    if (kMode == kNoMm) {
        const float inc = round_bf16(1e-9f);
        for (int c = (8 - q) & 7; c < iters; c += 8) acc = acc + inc;
    } else {
        // bf16(x[0, lane]) of runs r0..: fixed_s s_v[run][slot], full
        // s_v[run][row][slot] (lane run * kPeriod + 64 slot + 8 row + first)
        auto stage = [&](int r0) {
            const int staged = min(kStageRuns, runs - r0) * kPerRun;
            for (int e = t; e < staged; e += kCycleThreads) {
                const int run = r0 + e / kPerRun, rest = e % kPerRun;
                const int i = run * L::kPeriod + first +
                              (kMode == kFixedMode
                                   ? rest
                                   : 64 * (rest % kCycleGroup) + 8 * (rest / kCycleGroup));
                s_v[e] = i < n ? round_bf16(x[base + i]) : 0.0f;
            }
        };
        const bool once = runs <= kStageRuns;
        if (once) stage(0);
        const int u = t % kQuads, cc = t / kQuads;   // sums: slots 4u.., cycle cb + cc
        const float4* v4 = reinterpret_cast<const float4*>(s_v);
        float4* y4 = reinterpret_cast<float4*>(s_y);
        for (int cb = 0; cb < iters; cb += kChunk) {
            const int c = cb + cc;
            const int row = kMode == kFixedMode ? 0 : (-c) & 7;
            float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            for (int r0 = 0; r0 < runs; r0 += kStageRuns) {
                __syncthreads();   // s_v staged (or free to restage); s_y read
                if (!once) {
                    stage(r0);
                    __syncthreads();
                }
                if (c < iters) {
                    const int end = min(kStageRuns, runs - r0);
#pragma unroll 4
                    for (int run = 0; run < end; ++run) {
                        const float4 v = v4[(run * L::kRows + row) * kQuads + u];
                        g.x = g.x + v.x;
                        g.y = g.y + v.y;
                        g.z = g.z + v.z;
                        g.w = g.w + v.w;
                    }
                }
            }
            if (c < iters)
                y4[cc * kQuads + u] = make_float4(
                    round_bf16(__fadd_rn(__fmul_rn(g.x, 1.0001f), 0.5f)),
                    round_bf16(__fadd_rn(__fmul_rn(g.y, 1.0001f), 0.5f)),
                    round_bf16(__fadd_rn(__fmul_rn(g.z, 1.0001f), 0.5f)),
                    round_bf16(__fadd_rn(__fmul_rn(g.w, 1.0001f), 0.5f)));
            __syncthreads();
            const int end = min(kChunk, iters - cb);
            if (t < 8 * kCycleGroup) {
                if (kMode == kFixedMode)
                    for (int e = 0; e < end; ++e) acc = acc + s_y[e * kCycleGroup + a_slot];
                else
                    for (int e = (8 - q - cb) & 7; e < end; e += 8)
                        acc = acc + s_y[e * kCycleGroup + a_slot];
            }
        }
    }
    if (t < 8 * kCycleGroup) s_acc[t] = acc;
    __syncthreads();
    // block lane l is lane l / kRunLanes * kPeriod + first + l % kRunLanes
    const int lanes = runs * kRunLanes;
    for (int l = t; l < lanes; l += kCycleThreads) {
        const int o = l % kRunLanes, i = l / kRunLanes * L::kPeriod + first + o;
        if (i >= n) break;
        out[base + i] = kMode == kFixedMode ? s_acc[o]
                        : (o & 7) == 0      ? s_acc[(o & 63) / 8 * kCycleGroup + o / 64]
                                            : 0.0f;
    }
}

int check_shape(long long len, int n, int iters) {
    return (n <= 0 || len <= 0 || len % n || iters < 0) ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// x, out (8, len) f32; programs of n lanes (len a multiple of n), any n
// and iters.
extern "C" int rk_permute(const float* x, float* out, long long len, int n,
                          int iters, int chain, int fixed_s, void* stream) {
    if (const int e = check_shape(len, n, iters)) return e;
    if (len / n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (chain && fixed_s)
        launch_permute<true, true>(x, out, len, n, iters, st);
    else if (chain)
        launch_permute<true, false>(x, out, len, n, iters, st);
    else if (fixed_s)
        launch_permute<false, true>(x, out, len, n, iters, st);
    else
        launch_permute<false, false>(x, out, len, n, iters, st);
    return (int)cudaGetLastError();
}

// x (24, len) bf16 -> out (8, len) f32; n <= 16,384 lanes a program.
extern "C" int rk_sel(const uint16_t* x, float* out, long long len, int n,
                      int iters, void* stream) {
    if (const int e = check_shape(len, n, iters)) return e;
    if (n > kSelLanes) return (int)cudaErrorInvalidValue;
    sel_kernel<<<(unsigned)(len / n), kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const bf16*>(x), out, len, n, iters);
    return (int)cudaGetLastError();
}

// x (24, len) f32 -> out (1, len) f32; mode 0 full, 1 no_mm, 2 fixed_s;
// a block for each kCycleGroup slots that hold a lane of a program.
extern "C" int rk_cycle(const float* x, float* out, long long len, int n,
                        int iters, int mode, void* stream) {
    if (const int e = check_shape(len, n, iters)) return e;
    if (n > 0x7fffffff - 64 * kSlots) return (int)cudaErrorInvalidValue;
    const int run = mode == kFixedMode ? 1 : 64;
    const int used = min(kSlots, (n + run - 1) / run);   // slots holding a lane
    const int groups = (used + kCycleGroup - 1) / kCycleGroup;
    if ((len / n) * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((len / n) * groups);
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == kFullMode)
        cycle_kernel<kFullMode><<<grid, kCycleThreads, 0, st>>>(x, out, len, n, iters, groups);
    else if (mode == kNoMm)
        cycle_kernel<kNoMm><<<grid, kCycleThreads, 0, st>>>(x, out, len, n, iters, groups);
    else if (mode == kFixedMode)
        cycle_kernel<kFixedMode><<<grid, kCycleThreads, 0, st>>>(x, out, len, n, iters, groups);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
