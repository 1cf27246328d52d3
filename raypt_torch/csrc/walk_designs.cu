// Design variants of the mask-only walk (rk_topwalk_mask in
// onehot_walk.cu: one thread a ray, a block's live rays packed), built
// and timed only by `python -m raypt_torch.kernels.sweep`, which holds
// each one's mask bitwise against the package kernel's. Every variant
// takes the same step and builds the same mask columns (mask_walk.cuh);
// they differ in how a block's rays reach its kThreads threads:
//   * unpacked: thread t walks the rays at t, t + kThreads, ...,
//     dead or alive (one ray a thread: the design before the packing);
//   * kWalks walks a thread, interleaved in lockstep: each pass takes one
//     step of each, so one walk's shared row load can overlap another's
//     slab test;
//   * packed: the block's live rays listed in pixel order by a block scan,
//     so a warp holds only walking rays;
//   * refilled (kRays > kWalks, packed): a block of kRays rays a thread,
//     whose thread takes the next ray of the list from a shared counter
//     when one of its walks ends.
// And one design of the ray-major mask (rk_topwalk_mask_rows, each ray's
// words stored by the thread that walks it, at a stride of the word
// count across a warp's rays), held against that kernel's (R, cwp) mask:
//   * rows_staged: the block's rows are built in shared memory (a ray's
//     words at a stride of cwp | 1, so a warp's 32 rays take 32 banks)
//     and, after a barrier, stored by the whole block in one coalesced
//     pass: the block's kThreads x cwp words are contiguous in the mask.
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "mask_walk.cuh"

namespace {

constexpr int kThreads = 256;

template <int kRays, int kWalks, bool kPacked>
__global__ void __launch_bounds__(kThreads)
walk_design_kernel(const uint16_t* __restrict__ table, int nt,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ t0,
                   const uint8_t* __restrict__ active, int* __restrict__ mask,
                   long long r, int cwp, int max_steps) {
    static_assert(kWalks <= kRays && (kPacked || kWalks == kRays),
                  "only a packed block refills");
    constexpr int kBlockRays = kThreads * kRays;
    extern __shared__ float4 s_row[];   // nt * 2 rows, then the packed list
    int* s_list = reinterpret_cast<int*>(s_row + nt * 2);
    __shared__ int s_warp[33];
    __shared__ int s_next;
    const long long base = (long long)blockIdx.x * kBlockRays;
    // dead rays' columns are zeros; the live ones listed in pixel order
    bool any = false;
    int n = 0;
    for (int h = 0; h < kRays; ++h) {
        const int j = h * kThreads + threadIdx.x;
        const bool live = base + j < r && active[base + j];
        if (base + j < r && !live)
            for (int w = 0; w < cwp; ++w) mask[w * r + base + j] = 0;
        any |= live;
        if constexpr (kPacked) {
            int total;
            const int at = rk::block_exclusive_scan(live, s_warp, &total);
            if (live) s_list[n + at] = j;
            n += total;
        }
    }
    if (!(kPacked ? n > 0 : __syncthreads_or(any))) return;   // uniform
    rk::decode_table(table, nt, cwp, s_row);
    if (threadIdx.x == 0) s_next = kThreads * kWalks;
    __syncthreads();

    rk::WalkRay ray[kWalks];
    rk::MaskColumn col[kWalks];
    int node[kWalks], steps[kWalks];
    // slot h walks the block's ray j (none: j < 0)
    auto start = [&](int h, int j) {
        node[h] = j < 0 ? -1 : 0;
        steps[h] = 0;
        col[h].col = nullptr;
        if (j < 0) return;
        ray[h] = rk::load_walk_ray(ro, rd, t0, base + j);
        col[h] = {mask + base + j, -1, -1, 0u};
    };
#pragma unroll
    for (int h = 0; h < kWalks; ++h) {
        const int j = h * kThreads + threadIdx.x;
        if constexpr (kPacked)
            start(h, j < n ? s_list[j] : -1);
        else
            start(h, base + j < r && active[base + j] ? j : -1);
    }
    if constexpr (kRays == kWalks) {   // the walks start together
        for (int step = 0; step < max_steps; ++step) {
            bool walking = false;
#pragma unroll
            for (int h = 0; h < kWalks; ++h) walking |= node[h] >= 0;
            if (!walking) break;
#pragma unroll
            for (int h = 0; h < kWalks; ++h) {
                if (node[h] < 0) continue;
                int cid;
                node[h] = rk::walk_step(s_row, node[h], ray[h], &cid);
                if (cid >= 0) col[h].add(r, cid);
            }
        }
#pragma unroll
        for (int h = 0; h < kWalks; ++h)
            if (col[h].col) col[h].finish(r, cwp);
    } else {   // refilled: each slot counts its own steps
        for (bool walking = true; walking;) {
            walking = false;
#pragma unroll
            for (int h = 0; h < kWalks; ++h) {
                if (node[h] < 0) continue;
                walking = true;
                if (steps[h] < max_steps) {
                    int cid;
                    node[h] = rk::walk_step(s_row, node[h], ray[h], &cid);
                    ++steps[h];
                    if (cid >= 0) col[h].add(r, cid);
                } else {
                    node[h] = -1;
                }
                if (node[h] >= 0) continue;
                col[h].finish(r, cwp);
                const int k = atomicAdd(&s_next, 1);
                if (k < n) start(h, s_list[k]);
            }
        }
    }
}

template <int kRays, int kWalks, bool kPacked>
int launch(const uint16_t* table, int nt, const float* ro, const float* rd,
           const float* t0, const uint8_t* active, int* mask, long long r,
           int cw, int max_steps, void* stream) {
    if (nt <= 0 || nt >= 1 << 15 || cw <= 0)   // links: 15 bits
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    constexpr int kBlockRays = kThreads * kRays;
    const size_t smem = (size_t)nt * 32 + (kPacked ? kBlockRays * 4 : 0);
    auto* kernel = walk_design_kernel<kRays, kWalks, kPacked>;
    if (smem + sizeof(int) * 64 > 48 * 1024)   // with the static scan words
        if (const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
            return (int)e;
    kernel<<<(unsigned)((r + kBlockRays - 1) / kBlockRays), kThreads, smem,
             (cudaStream_t)stream>>>(table, nt, ro, rd, t0, active, mask, r, cw,
                                     max_steps);
    return (int)cudaGetLastError();
}

// The packed mask-only walk writing the (r, cwp) mask through shared
// memory (rows_staged, the header); an all-dead block's rows at once, as
// the package's.
__global__ void __launch_bounds__(kThreads)
rows_staged_kernel(const uint16_t* __restrict__ table, int nt,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ t0, const uint8_t* __restrict__ active,
                   int* __restrict__ mask, long long r, int cwp, int max_steps) {
    extern __shared__ float4 s_row[];   // nt * 2 rows, then the staged rows
    int* s_mask = reinterpret_cast<int*>(s_row + nt * 2);
    __shared__ int s_warp[33];
    __shared__ int s_list[kThreads];
    const int stride = cwp | 1;
    const long long base = (long long)blockIdx.x * kThreads;
    int* out = mask + base * cwp;   // the block's rows, contiguous
    const bool live = active[base + threadIdx.x];
    int n;
    const int pos = rk::block_exclusive_scan(live, s_warp, &n);
    if (n == 0) {   // uniform across the block: every row is zeros
        for (int k = threadIdx.x; k < kThreads * cwp; k += kThreads) out[k] = 0;
        return;
    }
    if (live) s_list[pos] = threadIdx.x;
    for (int k = threadIdx.x; k < kThreads * stride; k += kThreads) s_mask[k] = 0;
    rk::decode_table(table, nt, cwp, s_row);
    __syncthreads();
    if ((int)threadIdx.x < n) {
        const int j = s_list[threadIdx.x];
        const rk::WalkRay ray = rk::load_walk_ray(ro, rd, t0, base + j);
        rk::MaskColumn col{s_mask + j * stride, -1, -1, 0u};
        int node = 0;
        for (int step = 0; step < max_steps && node >= 0; ++step) {
            int cid;
            node = rk::walk_step(s_row, node, ray, &cid);
            if (cid >= 0) col.add(1, cid);
        }
        col.finish(1, cwp);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kThreads * cwp; k += kThreads)
        out[k] = s_mask[k / cwp * stride + k % cwp];
}

}  // namespace

// rk_topwalk_mask_rows' arguments: table, nt, ro, rd, t0, active -> the
// (r, cw) mask; r a multiple of kThreads, cw, max_steps, stream
extern "C" int rk_walk_rows_staged(const uint16_t* table, int nt, const float* ro,
                                   const float* rd, const float* t0,
                                   const uint8_t* active, int* mask, long long r,
                                   int cw, int max_steps, void* stream) {
    if (r % kThreads || nt <= 0 || nt >= 1 << 15 || cw <= 0)   // links: 15 bits
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = (size_t)nt * 32 + (size_t)kThreads * (cw | 1) * 4;
    if (smem + sizeof(int) * (33 + kThreads) > 48 * 1024)
        if (const cudaError_t e = cudaFuncSetAttribute(
                rows_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem))
            return (int)e;
    rows_staged_kernel<<<(unsigned)(r / kThreads), kThreads, smem,
                         (cudaStream_t)stream>>>(table, nt, ro, rd, t0, active, mask,
                                                 r, cw, max_steps);
    return (int)cudaGetLastError();
}

// rk_topwalk_mask's arguments: table, nt, ro, rd, t0, active -> mask;
// r, cw, max_steps, stream
#define RK_WALK_DESIGN(name, rays, walks, packed)                             \
    extern "C" int rk_walk_##name(const uint16_t* table, int nt,              \
                                  const float* ro, const float* rd,           \
                                  const float* t0, const uint8_t* active,     \
                                  int* mask, long long r, int cw,             \
                                  int max_steps, void* stream) {              \
        return launch<rays, walks, packed>(table, nt, ro, rd, t0, active,     \
                                           mask, r, cw, max_steps, stream);   \
    }

RK_WALK_DESIGN(unpacked, 1, 1, false)
RK_WALK_DESIGN(interleaved2, 2, 2, false)
RK_WALK_DESIGN(interleaved3, 3, 3, false)
RK_WALK_DESIGN(packed_interleaved2, 2, 2, true)
RK_WALK_DESIGN(refilled1, 4, 1, true)
RK_WALK_DESIGN(refilled2, 4, 2, true)
