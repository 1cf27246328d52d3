// Design variants of the packed skip-link walk (rk_packed_walk in
// packed_walk.cu), built and timed only by `python -m
// raypt_torch.kernels.sweep --kernels packed`, which holds each one's t
// and face bitwise against the package kernel's. Each variant has a C
// entry point rk_pwalk_<name> and rk_pwalk_<name>_info (registers, local
// bytes, resident blocks an SM, threads a block):
//   * pr12: the first kernel as it was, one thread a ray over the table's
//     64-byte rows, all four loaded before the row's kind is known, min /
//     max as compare-and-select, 1 / det an IEEE division, a 64-bit step
//     counter; no scratch argument;
//   * lean: the same walk over the same rows, with the one-instruction
//     min.NaN / max.NaN, the fast reciprocal and no step counter unless
//     a cap is given; no scratch argument;
//   * the split-table walks, each a designs::Design over the steps and
//     table of packed_walk.cuh:
//     kBatch 0 lets each lane step its own row's kind, kBatch k > 0
//     schedules a warp's steps while-while with threshold k (32: the
//     leaf tests whenever a lane waits at a leaf); kRefill 0 is one
//     thread a ray, k > 0 persistent warps that refill their idle lanes
//     from a global counter once k are idle (32: the whole warp); then
//     the launch bound's blocks an SM, the rows' L1 eviction priorities
//     (kCache: 8 keeps internal rows last, 1 allocates no leaf row in
//     L1), the carve-out of L1 for shared memory (0: the most L1) and
//     whether a block hands its rays to its threads by direction octant,
//     live rays first (kSort 1, "octsort"); kPersist blocks an SM whose
//     warps take 32 rays at a time from a counter ("persist"); kBin = 1 +
//     k: the rays walked in the order of a counting sort on direction
//     octant and origin cell, k bits an axis ("bin"); kWarpBins = 10 a
//     + b: the warps of 32 rays, kept whole, walked in the order of a
//     counting sort on their first live ray's origin and direction cells
//     ("wsort", with the blocks' octant sort on top: "wsort_octsort").
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "packed_walk.cuh"

namespace pr12 {

constexpr int kThreads = 256;

// torch.minimum / torch.maximum: NaN when either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float safe_inv(float d) {
    const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
    return 1.0f / safe;
}

__global__ void __launch_bounds__(kThreads)
packed_walk_kernel(const float4* __restrict__ rows, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ t0,
                   const bool* __restrict__ active, float* __restrict__ t_out,
                   int* __restrict__ face_out, long long r, long long max_steps) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= r) return;
    float t_best = t0[i];
    int face = -1;
    int node = active[i] ? 0 : -1;
    if (node >= 0) {
        const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
        const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
        const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
        for (long long step = 0; node >= 0 && (max_steps < 0 || step < max_steps);
             ++step) {
            const float4* row = rows + 4 * (long long)node;
            const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
                         e = __ldg(row + 3);
            const int link = __float_as_int(e.x), skip = __float_as_int(e.y);
            if (e.z > 0.5f) {
                // leaf: p0 = (a.x, a.y, a.z), e1 = (a.w, b.x, b.y),
                // e2 = (b.z, b.w, c.x)
                const float e1x = a.w, e1y = b.x, e1z = b.y;
                const float e2x = b.z, e2y = b.w, e2z = c.x;
                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const bool ok = fabsf(det) > 1e-8f;
                const float inv_det = (ok ? 1.0f : 0.0f) / (ok ? det : 1.0f);
                const float tx = ox - a.x, ty = oy - a.y, tz = oz - a.z;
                const float u = (tx * px + ty * py + tz * pz) * inv_det;
                const float qx = ty * e1z - tz * e1y;
                const float qy = tz * e1x - tx * e1z;
                const float qz = tx * e1y - ty * e1x;
                const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
                const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
                    t < t_best) {
                    t_best = t;
                    face = link;
                }
                node = skip;
            } else {
                // internal: bmin = (a.x, a.y, a.z), bmax = (a.w, b.x, b.y)
                const float n1x = (a.x - ox) * ix, n1y = (a.y - oy) * iy,
                            n1z = (a.z - oz) * iz;
                const float n2x = (a.w - ox) * ix, n2y = (b.x - oy) * iy,
                            n2z = (b.y - oz) * iz;
                const float tnear = max_nan(
                    max_nan(min_nan(n1x, n2x), min_nan(n1y, n2y)), min_nan(n1z, n2z));
                const float tfar = min_nan(
                    min_nan(max_nan(n1x, n2x), max_nan(n1y, n2y)), max_nan(n1z, n2z));
                const bool nonempty = a.x <= a.w && a.y <= b.x && a.z <= b.y;
                const bool hit_box =
                    tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
                node = hit_box ? link : skip;
            }
        }
    }
    t_out[i] = t_best;
    face_out[i] = face;
}

}  // namespace pr12

namespace lean {

constexpr int kThreads = 256;

template <bool kCapped>
__global__ void __launch_bounds__(kThreads)
lean_walk_kernel(const float4* __restrict__ rows, const float* __restrict__ ro,
                 const float* __restrict__ rd, const float* __restrict__ t0,
                 const bool* __restrict__ active, float* __restrict__ t_out,
                 int* __restrict__ face_out, long long r, long long max_steps) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= r) return;
    float t_best = t0[i];
    int face = -1;
    int node = active[i] && !(kCapped && max_steps == 0) ? 0 : -1;
    if (node >= 0) {
        const rk::WalkRay w = rk::load_walk_ray(ro, rd, i);
        long long left = max_steps;
        while (node >= 0) {
            const float4* row = rows + 4 * (long long)node;
            const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
                         e = __ldg(row + 3);
            if (e.z > 0.5f) {
                const float e1x = a.w, e1y = b.x, e1z = b.y;
                const float e2x = b.z, e2y = b.w, e2z = c.x;
                const float px = w.dy * e2z - w.dz * e2y;
                const float py = w.dz * e2x - w.dx * e2z;
                const float pz = w.dx * e2y - w.dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const bool ok = fabsf(det) > 1e-8f;
                const float inv_det = rk::leaf_inv_det(det, ok);
                const float tx = w.ox - a.x, ty = w.oy - a.y, tz = w.oz - a.z;
                const float u = (tx * px + ty * py + tz * pz) * inv_det;
                const float qx = ty * e1z - tz * e1y;
                const float qy = tz * e1x - tx * e1z;
                const float qz = tx * e1y - ty * e1x;
                const float v = (w.dx * qx + w.dy * qy + w.dz * qz) * inv_det;
                const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
                    t < t_best) {
                    t_best = t;
                    face = __float_as_int(e.x);
                }
                node = __float_as_int(e.y);
            } else {
                const float n1x = (a.x - w.ox) * w.ix, n1y = (a.y - w.oy) * w.iy,
                            n1z = (a.z - w.oz) * w.iz;
                const float n2x = (a.w - w.ox) * w.ix, n2y = (b.x - w.oy) * w.iy,
                            n2z = (b.y - w.oz) * w.iz;
                const float tnear = rk::max_nan(
                    rk::max_nan(rk::min_nan(n1x, n2x), rk::min_nan(n1y, n2y)),
                    rk::min_nan(n1z, n2z));
                const float tfar = rk::min_nan(
                    rk::min_nan(rk::max_nan(n1x, n2x), rk::max_nan(n1y, n2y)),
                    rk::max_nan(n1z, n2z));
                const bool nonempty = a.x <= a.w && a.y <= b.x && a.z <= b.y;
                const bool hit =
                    tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
                node = __float_as_int(hit ? e.x : e.y);
            }
            if constexpr (kCapped) {
                if (--left == 0) node = -1;
            }
        }
    }
    t_out[i] = t_best;
    face_out[i] = face;
}

}  // namespace lean


namespace designs {

using namespace rk;

constexpr int kRegions = 256;   // parts of the wavefront (>= the card's SMs)

// The row loads, through the read-only path, with an L1 eviction
// priority: kHint 0 the default, 1 L1::no_allocate (the row is not kept
// in L1), 2 L1::evict_last (kept before others).
template <int kHint>
__device__ __forceinline__ float4 ld_row(const float4* p) {
    if constexpr (kHint == 0) {
        return __ldg(p);
    } else {
        float4 v;
        if constexpr (kHint == 1)
            asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                : "l"(p));
        else
            asm("ld.global.nc.L1::evict_last.v4.f32 {%0, %1, %2, %3}, [%4];"
                : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                : "l"(p));
        return v;
    }
}

// A design of the walk, and the row loads (inner, leaf) of the walk
// templates of packed_walk.cuh: threads a block; kBatch, the while-while
// threshold of warp_step (0: none); kRefill, the idle lanes at which a
// persistent warp refills them (0: one thread a ray); kMinBlocks, the
// launch bound's resident blocks an SM; kCache, the L1 priority of the
// internal rows' loads (kCache / 4) and of the leaf rows' (kCache % 4),
// as ld_row's kHint; kCarveout, the shared-memory carve-out asked for
// (percent; -1: the runtime's choice); kSort 1 hands a block's rays to
// its threads by direction octant, the live ones first
// (rk::sorted_ray);
// kPersist > 0 launches that many blocks an SM whose warps take 32
// consecutive rays at a time from a global counter (with kSort, whose
// blocks take kThreads rays at a time and sort them), -n n blocks an SM
// that walk the rays of their SM's part of the wavefront first
// ("regions"); kBin = 1 + k walks
// the rays in the order of a counting sort of the wavefront on its
// rays' direction octant and origin cell, k bits an axis (bin_key);
// kWarpBins = 10 a + b walks the wavefront's 32-ray warps, kept whole, in
// the order of a counting sort on their first live ray's origin cell (a
// bits an axis) and direction cell (b bits an axis), "wsort" (warp_key).
template <int kThreads_, int kBatch_ = 0, int kRefill_ = 0, int kMinBlocks_ = 1,
          int kCache_ = 0, int kCarveout_ = -1, int kSort_ = 0, int kPersist_ = 0,
          int kBin_ = 0, int kWarpBins_ = 0>
struct Design {
    static constexpr int kThreads = kThreads_, kBatch = kBatch_, kRefill = kRefill_,
                         kMinBlocks = kMinBlocks_, kInnerHint = kCache_ / 4,
                         kLeafHint = kCache_ % 4, kCarveout = kCarveout_,
                         kSort = kSort_, kPersist = kPersist_, kBin = kBin_,
                         kWarpBins = kWarpBins_;
    static_assert(!(kWarpBins && (kPersist || kBin || kRefill)),
                  "the warps' order is for one thread a ray");
    // the warps' counting sort (kWarpBins = 10 a + b): a origin and b
    // direction bits an axis, and a bin for the warps with no live ray
    static constexpr int kWarpKeyBits = 3 * (kWarpBins / 10 + kWarpBins % 10);
    static constexpr int kWarpBinCount = kWarpBins ? (1 << kWarpKeyBits) + 1 : 0;
    static_assert(!(kSort && (kPersist < 0 || kBin || kRefill)),
                  "the in-block octant sort needs blocks of consecutive rays");
    static_assert(!(kRefill && (kPersist || kBin)), "refilled warps sort nothing");
    static __device__ __forceinline__ float4 inner(const float4* p) {
        return ld_row<kInnerHint>(p);
    }
    static __device__ __forceinline__ float4 leaf(const float4* p) {
        return ld_row<kLeafHint>(p);
    }
    // the bins of the counting sort: 8 octants x 2^(3k) cells, then the
    // dead rays'
    static constexpr int kBins = kBin ? (8 << (3 * (kBin - 1))) + 1 : 0;
};

// The bin of a ray in a counting sort of the wavefront (Design kBin
// = 1 + k): its direction octant, then the Morton code of its origin's
// cell among 2^k a side of the root row's box (a NaN coordinate or one
// outside the box takes the nearest cell); kBins - 1 for a ray that does
// not walk.
template <int kBin>
__device__ __forceinline__ int bin_key(const float* rows, const float* ro,
                                       const float* rd, long long i, bool walks) {
    constexpr int kBits = kBin - 1, kSide = 1 << kBits;
    if (!walks) return (8 << (3 * kBits));
    int key = (rd[3 * i] < 0.0f) | ((rd[3 * i + 1] < 0.0f) << 1) |
              ((rd[3 * i + 2] < 0.0f) << 2);
    int q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float lo = __ldg(rows + a), hi = __ldg(rows + 3 + a);
        const float x = fminf(fmaxf((ro[3 * i + a] - lo) / (hi - lo), 0.0f), 1.0f);
        q[a] = min((int)(x * kSide), kSide - 1);
    }
#pragma unroll
    for (int b = kBits - 1; b >= 0; --b)
#pragma unroll
        for (int a = 0; a < 3; ++a) key = (key << 1) | ((q[a] >> b) & 1);
    return key;
}

// Counts each bin's rays (one atomic a warp's lanes of one bin).
template <int kBin>
__global__ void __launch_bounds__(256)
bin_count_kernel(const float* __restrict__ rows, const float* __restrict__ ro,
                 const float* __restrict__ rd, const bool* __restrict__ active,
                 long long r, bool walks, int* __restrict__ key,
                 unsigned* __restrict__ bins) {
    const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
    const int k = i < r ? bin_key<kBin>(rows, ro, rd, i, walks && active[i]) : -1;
    if (i < r) key[i] = k;
    const unsigned peers = __match_any_sync(kFullMask, k);
    if (k >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(bins + k, (unsigned)__popc(peers));
}

// The bins' starts: an exclusive scan of n counts in place, one block.
template <int kUnused = 0>
__global__ void __launch_bounds__(1024)
bin_scan_kernel(unsigned* __restrict__ bins, int n) {
    __shared__ int s_warp[33];
    const int per = (n + 1023) / 1024;
    const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
    int sum = 0;
    for (int j = lo; j < hi; ++j) sum += (int)bins[j];
    int total;
    unsigned at = (unsigned)block_exclusive_scan(sum, s_warp, &total);
    for (int j = lo; j < hi; ++j) {
        const unsigned v = bins[j];
        bins[j] = at;
        at += v;
    }
}

// Places each ray at its bin's next slot: perm[slot] = ray; a warp's
// lanes of one bin take consecutive slots in lane order.
template <int kUnused = 0>
__global__ void __launch_bounds__(256)
bin_scatter_kernel(const int* __restrict__ key, long long r,
                   unsigned* __restrict__ starts, int* __restrict__ perm) {
    const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
    const int k = i < r ? key[i] : -1;
    const unsigned peers = __match_any_sync(kFullMask, k);
    const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
    unsigned base = 0;
    if (k >= 0 && lane == leader) base = atomicAdd(starts + k, (unsigned)__popc(peers));
    base = __shfl_sync(kFullMask, base, leader);
    if (k >= 0) perm[base + __popc(peers & ((1u << lane) - 1u))] = (int)i;
}

// The bin of a warp of 32 rays (Design kWarpBins = 10 a + b): the
// Morton code of its first live ray's origin cell among 2^a a side of
// the root row's box, then of its direction's cell among 2^b a side of
// [-1, 1]^3; the last bin for a warp with no live ray. One thread a ray:
// the first live lane counts its warp.
template <int kWarpBins>
__global__ void __launch_bounds__(256)
warp_key_kernel(const float* __restrict__ rows, const float* __restrict__ ro,
                const float* __restrict__ rd, const bool* __restrict__ active,
                long long r, bool walks, int* __restrict__ key,
                unsigned* __restrict__ bins) {
    constexpr int kA = kWarpBins / 10, kB = kWarpBins % 10;
    const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
    const bool live = i < r && walks && active[i];
    const unsigned m = __ballot_sync(kFullMask, live);
    const int lane = threadIdx.x & 31;
    if (i >= r || lane != (m ? __ffs(m) - 1 : 0)) return;
    int k = 1 << (3 * (kA + kB));
    if (live) {
        int q[6];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float lo = __ldg(rows + a), hi = __ldg(rows + 3 + a);
            const float x = fminf(fmaxf((ro[3 * i + a] - lo) / (hi - lo), 0.0f), 1.0f);
            q[a] = min((int)(x * (1 << kA)), (1 << kA) - 1);
            const float y = fminf(fmaxf((rd[3 * i + a] + 1.0f) * 0.5f, 0.0f), 1.0f);
            q[3 + a] = min((int)(y * (1 << kB)), (1 << kB) - 1);
        }
        k = 0;
#pragma unroll
        for (int b = kA - 1; b >= 0; --b)
#pragma unroll
            for (int a = 0; a < 3; ++a) k = (k << 1) | ((q[a] >> b) & 1);
#pragma unroll
        for (int b = kB - 1; b >= 0; --b)
#pragma unroll
            for (int a = 0; a < 3; ++a) k = (k << 1) | ((q[3 + a] >> b) & 1);
    }
    key[i >> 5] = k;
    atomicAdd(bins + k, 1u);
}

// Places each warp at its bin's next slot: perm[slot] = warp.
template <int kUnused = 0>
__global__ void __launch_bounds__(256)
warp_scatter_kernel(const int* __restrict__ key, long long n_warps,
                    unsigned* __restrict__ starts, int* __restrict__ perm) {
    const long long w = (long long)blockIdx.x * 256 + threadIdx.x;
    if (w < n_warps) perm[atomicAdd(starts + key[w], 1u)] = (int)w;
}

// One warp step of the lanes, after their ballots mi (on an internal
// row) and ml (at a leaf), as D schedules it:
//   kBatch == 0: each lane steps its own ray, so a warp step that holds
//     both kinds of row runs both tests;
//   kBatch > 0 ("while-while"): a warp step takes one kind only: the slab
//     steps of the lanes on internal rows while kBatch of them or more
//     are, or no lane sits at a leaf, else the leaf tests of the lanes at
//     a leaf. A lane that reaches a leaf waits there, so each ray still
//     takes its own steps in its own order, each box test after the leaf
//     test before it.
template <class D, bool kCapped>
__device__ __forceinline__ void warp_step(const float4* inner, const float4* leaves,
                                          unsigned mi, unsigned ml, int& c,
                                          const WalkRay& w, float& t_best, int& face,
                                          long long& left) {
    if constexpr (D::kBatch == 0) {
        if (c != -1) any_step<D, kCapped>(inner, leaves, c, w, t_best, face, left);
    } else if (ml == 0 || __popc(mi) >= D::kBatch) {
        if (c >= 0) any_step<D, kCapped>(inner, leaves, c, w, t_best, face, left);
    } else if (c < -1) {
        any_step<D, kCapped>(inner, leaves, c, w, t_best, face, left);
    }
}

// rk::walk_ray under a design's warp schedule: with kBatch, the lanes'
// ballots choose each warp step's kind (warp_step).
template <class D, bool kCapped>
__device__ __forceinline__ void walk_design_ray(
    long long i, const float* __restrict__ rows, const float4* __restrict__ inner,
    const float4* __restrict__ leaves, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t0,
    const bool* __restrict__ active, float* __restrict__ t_out,
    int* __restrict__ face_out, long long r, long long max_steps) {
    if constexpr (D::kBatch == 0) {
        walk_ray<D, kCapped>(i, rows, inner, leaves, ro, rd, t0, active, t_out, face_out,
                             r, max_steps);
    } else {
        const bool in = i < r;
        float t_best = in ? t0[i] : 0.0f;
        int face = -1;
        int c = (in && active[i] && !(kCapped && max_steps == 0)) ? root_code(rows) : -1;
        WalkRay w{};
        if (c != -1) w = load_walk_ray(ro, rd, i);
        long long left = max_steps;
        for (;;) {
            const unsigned mi = __ballot_sync(kFullMask, c >= 0);
            const unsigned ml = __ballot_sync(kFullMask, c < -1);
            if ((mi | ml) == 0) break;
            warp_step<D, kCapped>(inner, leaves, mi, ml, c, w, t_best, face, left);
        }
        if (in) {
            t_out[i] = t_best;
            face_out[i] = face;
        }
    }
}

// The designs' walk kernel. One thread a ray: the ray at the thread's
// slot (blocks of consecutive slots, or, with kPersist, warps taking 32
// slots at a time from the counter), or the ray the block's octant sort
// hands it, or the ray the counting sort put at the slot (perm). The
// counter and perm, which a design may not read, keep the walk kernels'
// signature one.
template <class D, bool kCapped>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks)
design_walk_kernel(const float* __restrict__ rows, const float4* __restrict__ inner,
                   const float4* __restrict__ leaves, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ t0,
                   const bool* __restrict__ active, float* __restrict__ t_out,
                   int* __restrict__ face_out, long long r, long long max_steps,
                   unsigned long long* __restrict__ next_ray,
                   const int* __restrict__ perm) {
    auto ray_at = [&](long long slot) -> long long {
        if constexpr (D::kBin != 0) return slot < r ? (long long)perm[slot] : slot;
        return slot;
    };
    if constexpr (D::kPersist == 0) {
        long long i = (long long)blockIdx.x * D::kThreads + threadIdx.x;
        if constexpr (D::kWarpBins != 0) {   // the slot's warp of rays
            const long long w = i >> 5;
            if (w < (r + 31) / 32) i = ((long long)perm[w] << 5) + (i & 31);
        }
        if constexpr (D::kSort == 1)
            i = sorted_ray<D::kThreads>(i, rd, active, r, !(kCapped && max_steps == 0));
        walk_design_ray<D, kCapped>(ray_at(i), rows, inner, leaves, ro, rd, t0, active,
                                    t_out, face_out, r, max_steps);
    } else if constexpr (D::kPersist > 0 && D::kSort == 1) {
        // a block takes kThreads consecutive rays at a time and sorts them
        __shared__ unsigned long long s_base;
        for (;;) {
            if (threadIdx.x == 0)
                s_base = atomicAdd(next_ray, (unsigned long long)D::kThreads);
            __syncthreads();
            const unsigned long long base = s_base;
            __syncthreads();
            if (base >= (unsigned long long)r) break;
            walk_design_ray<D, kCapped>(
                sorted_ray<D::kThreads>((long long)base + threadIdx.x, rd, active, r,
                                        !(kCapped && max_steps == 0)),
                rows, inner, leaves, ro, rd, t0, active, t_out, face_out, r, max_steps);
        }
    } else if constexpr (D::kPersist > 0) {
        const int lane = threadIdx.x & 31;
        for (;;) {
            unsigned long long base = 0;
            if (lane == 0) base = atomicAdd(next_ray, 32ull);
            base = __shfl_sync(kFullMask, base, 0);
            if (base >= (unsigned long long)r) break;
            walk_design_ray<D, kCapped>(ray_at((long long)base + lane), rows, inner,
                                        leaves, ro, rd, t0, active, t_out, face_out, r,
                                        max_steps);
        }
    } else {
        // regions: SM s walks the 32-ray chunks of the s-th of kRegions
        // equal parts of the wavefront, then helps the next parts
        const int lane = threadIdx.x & 31;
        unsigned smid;
        asm("mov.u32 %0, %%smid;" : "=r"(smid));
        unsigned* counts = reinterpret_cast<unsigned*>(next_ray + 1);
        const long long chunks = (r + 31) / 32;
        const long long per = (chunks + kRegions - 1) / kRegions;
        for (int k = 0; k < kRegions; ++k) {
            const int part = (int)((smid + k) % kRegions);
            for (;;) {
                unsigned c = 0;
                if (lane == 0) c = atomicAdd(counts + part, 1u);
                c = __shfl_sync(kFullMask, c, 0);
                const long long chunk = part * per + c;
                if (c >= per || chunk >= chunks) break;
                walk_design_ray<D, kCapped>(ray_at(chunk * 32 + lane), rows, inner,
                                            leaves, ro, rd, t0, active, t_out, face_out,
                                            r, max_steps);
            }
        }
    }
}

// Persistent warps: each lane takes a ray from a global counter, and a
// warp hands out new rays to its idle lanes once kRefill of them (32:
// all) are idle, consecutive rays to consecutive idle lanes. A ray's
// result is stored when its walk ends.
template <class D, bool kCapped>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks)
refill_walk_kernel(const float* __restrict__ rows, const float4* __restrict__ inner,
                   const float4* __restrict__ leaves, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ t0,
                   const bool* __restrict__ active, float* __restrict__ t_out,
                   int* __restrict__ face_out, long long r, long long max_steps,
                   unsigned long long* __restrict__ next_ray, const int* __restrict__) {
    const int lane = threadIdx.x & 31;
    const int root = root_code(rows);
    long long i = -1, left = max_steps;
    float t_best = 0.0f;
    int face = -1, c = -1;
    WalkRay w{};
    bool exhausted = false;
    for (;;) {
        const unsigned idle = __ballot_sync(kFullMask, c == -1);
        if (!exhausted && (idle == kFullMask || __popc(idle) >= D::kRefill)) {
            const int n = __popc(idle);
            unsigned long long base = 0;
            if (lane == 0) base = atomicAdd(next_ray, (unsigned long long)n);
            base = __shfl_sync(kFullMask, base, 0);
            exhausted = base + n >= (unsigned long long)r;
            if (c == -1) {
                const unsigned long long j =
                    base + __popc(idle & ((1u << lane) - 1u));
                if (j < (unsigned long long)r) {
                    i = (long long)j;
                    t_best = t0[i];
                    face = -1;
                    left = max_steps;
                    if (active[i] && !(kCapped && max_steps == 0)) {
                        c = root;
                        w = load_walk_ray(ro, rd, i);
                    } else {
                        t_out[i] = t_best;
                        face_out[i] = -1;
                    }
                }
            }
        }
        const unsigned mi = __ballot_sync(kFullMask, c >= 0);
        const unsigned ml = __ballot_sync(kFullMask, c < -1);
        if ((mi | ml) == 0) {
            if (exhausted) break;
            continue;
        }
        const bool was_walking = c != -1;
        warp_step<D, kCapped>(inner, leaves, mi, ml, c, w, t_best, face, left);
        if (was_walking && c == -1) {
            t_out[i] = t_best;
            face_out[i] = face;
        }
    }
}

// The kernel of a design: one thread a ray, or refilled warps.
template <class D, bool kCapped>
auto walk_kernel() {
    if constexpr (D::kRefill == 0)
        return design_walk_kernel<D, kCapped>;
    else
        return refill_walk_kernel<D, kCapped>;
}

// The scratch a walk of design D needs, in float4: the split table's
// internal and leaf rows, the ray counter and, with kBin, the rays' bin
// keys, the permutation and the bins.
template <class D>
long long design_scratch_f4(long long n_rows, long long r) {
    long long ints = D::kBin ? 2 * r + D::kBins : 0;
    if (D::kWarpBins) ints = 2 * ((r + 31) / 32) + D::kWarpBinCount;
    return (kInnerF4 + kLeafF4) * n_rows + 1 + (kRegions + ints + 3) / 4;
}

// Builds the split table into `scratch` (design_scratch_f4 float4: inner,
// leaves, the ray counter, the sort's keys, permutation and bins), sorts
// the rays with kBin, then launches the walk: one thread a ray, or
// persistent blocks (kRefill, kPersist), as many as fit on the card or
// kPersist an SM.
template <class D>
int launch_design(const float* rows, long long n_rows, const float* ro,
                  const float* rd, const float* t0, const bool* active, float* t_out,
                  int* face_out, long long r, long long max_steps, void* scratch,
                  void* stream) {
    if (r < 0 || n_rows < 1 || max_steps < -1 || scratch == nullptr ||
        (D::kBin && r >= INT_MAX))
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    float4* inner = reinterpret_cast<float4*>(scratch);
    float4* leaves = inner + kInnerF4 * n_rows;
    auto* next_ray = reinterpret_cast<unsigned long long*>(leaves + kLeafF4 * n_rows);
    unsigned* region_counts = reinterpret_cast<unsigned*>(next_ray + 1);
    int* key = reinterpret_cast<int*>(region_counts + kRegions);
    const long long n_keys = D::kWarpBins ? (r + 31) / 32 : r;
    int* perm = key + n_keys;
    unsigned* bins = reinterpret_cast<unsigned*>(perm + n_keys);
    if (const cudaError_t e = build_split_table(rows, n_rows, scratch, s)) return (int)e;
    if (const cudaError_t e = cudaMemsetAsync(
            next_ray, 0, sizeof(unsigned long long) + sizeof(unsigned) * kRegions, s))
        return (int)e;
    const unsigned ray_blocks = (unsigned)((r + 255) / 256);
    if constexpr (D::kBin != 0) {
        if (const cudaError_t e =
                cudaMemsetAsync(bins, 0, sizeof(unsigned) * D::kBins, s))
            return (int)e;
        bin_count_kernel<D::kBin><<<ray_blocks, 256, 0, s>>>(
            rows, ro, rd, active, r, !(max_steps == 0), key, bins);
        bin_scan_kernel<0><<<1, 1024, 0, s>>>(bins, D::kBins);
        bin_scatter_kernel<0><<<ray_blocks, 256, 0, s>>>(key, r, bins, perm);
        if (const cudaError_t e = cudaGetLastError()) return (int)e;
    }
    if constexpr (D::kWarpBins != 0) {
        if (const cudaError_t e =
                cudaMemsetAsync(bins, 0, sizeof(unsigned) * D::kWarpBinCount, s))
            return (int)e;
        warp_key_kernel<D::kWarpBins><<<ray_blocks, 256, 0, s>>>(
            rows, ro, rd, active, r, !(max_steps == 0), key, bins);
        bin_scan_kernel<0><<<1, 1024, 0, s>>>(bins, D::kWarpBinCount);
        warp_scatter_kernel<0><<<(unsigned)((n_keys + 255) / 256), 256, 0, s>>>(
            key, n_keys, bins, perm);
        if (const cudaError_t e = cudaGetLastError()) return (int)e;
    }
    const auto kernel = max_steps < 0 ? walk_kernel<D, false>() : walk_kernel<D, true>();
    static int per_sm = 0;   // blocks resident on an SM
    static int sms = 0;
    if (per_sm == 0) {
        if constexpr (D::kCarveout >= 0) {
            for (const auto k : {walk_kernel<D, false>(), walk_kernel<D, true>()})
                if (const cudaError_t e = cudaFuncSetAttribute(
                        k, cudaFuncAttributePreferredSharedMemoryCarveout,
                        D::kCarveout))
                    return (int)e;
        }
        int dev = 0;
        if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
        if (const cudaError_t e =
                cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
            return (int)e;
        if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, walk_kernel<D, false>(), D::kThreads, 0))
            return (int)e;
        per_sm = per_sm > 0 ? per_sm : 1;
    }
    unsigned grid = (unsigned)((r + D::kThreads - 1) / D::kThreads);
    if (D::kRefill) grid = (unsigned)(sms * per_sm);
    if (D::kPersist) {
        const int want = D::kPersist > 0 ? D::kPersist : -D::kPersist;
        grid = (unsigned)(sms * (want < per_sm ? want : per_sm));
    }
    kernel<<<grid, D::kThreads, 0, s>>>(rows, inner, leaves, ro, rd, t0, active, t_out,
                                        face_out, r, max_steps, next_ray, perm);
    return (int)cudaGetLastError();
}

// The uncapped walk kernel's registers, local (spill) bytes, resident
// blocks an SM and threads a block: info[0..3].
template <class D>
int design_info(int* info) {
    return walk_kernel_info(walk_kernel<D, false>(), D::kThreads, info);
}

}  // namespace designs

extern "C" int rk_pwalk_pr12(const float* rows, long long n_rows, const float* ro,
                             const float* rd, const float* t0, const bool* active,
                             float* t_out, int* face_out, long long r,
                             long long max_steps, void* stream) {
    if (r < 0 || n_rows < 1 || max_steps < -1) return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const unsigned grid = (unsigned)((r + pr12::kThreads - 1) / pr12::kThreads);
    pr12::packed_walk_kernel<<<grid, pr12::kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), ro, rd, t0, active, t_out, face_out,
        r, max_steps);
    return (int)cudaGetLastError();
}

extern "C" int rk_pwalk_pr12_info(int* info) {
    return rk::walk_kernel_info(pr12::packed_walk_kernel, pr12::kThreads, info);
}

extern "C" int rk_pwalk_lean(const float* rows, long long n_rows, const float* ro,
                             const float* rd, const float* t0, const bool* active,
                             float* t_out, int* face_out, long long r,
                             long long max_steps, void* stream) {
    if (r < 0 || n_rows < 1 || max_steps < -1) return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const unsigned grid = (unsigned)((r + lean::kThreads - 1) / lean::kThreads);
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    if (max_steps < 0)
        lean::lean_walk_kernel<false><<<grid, lean::kThreads, 0, (cudaStream_t)stream>>>(
            rows4, ro, rd, t0, active, t_out, face_out, r, max_steps);
    else
        lean::lean_walk_kernel<true><<<grid, lean::kThreads, 0, (cudaStream_t)stream>>>(
            rows4, ro, rd, t0, active, t_out, face_out, r, max_steps);
    return (int)cudaGetLastError();
}

extern "C" int rk_pwalk_lean_info(int* info) {
    return rk::walk_kernel_info(lean::lean_walk_kernel<false>, lean::kThreads, info);
}

#define RK_PWALK_DESIGN(name, ...)                                                 \
    extern "C" int rk_pwalk_##name(const float* rows, long long n_rows,            \
                                   const float* ro, const float* rd,               \
                                   const float* t0, const bool* active,            \
                                   float* t_out, int* face_out, long long r,       \
                                   long long max_steps, void* scratch,             \
                                   void* stream) {                                 \
        return designs::launch_design<designs::Design<__VA_ARGS__>>(               \
            rows, n_rows, ro, rd, t0, active, t_out, face_out, r, max_steps,       \
            scratch, stream);                                                      \
    }                                                                              \
    extern "C" int rk_pwalk_##name##_info(int* info) {                             \
        return designs::design_info<designs::Design<__VA_ARGS__>>(info);           \
    }                                                                              \
    extern "C" long long rk_pwalk_##name##_scratch(long long n_rows, long long r) { \
        return designs::design_scratch_f4<designs::Design<__VA_ARGS__>>(n_rows, r); \
    }

// name, then designs::Design's threads, kBatch, kRefill, kMinBlocks,
// kCache, kCarveout, kSort, kPersist, kBin, kWarpBins
RK_PWALK_DESIGN(split, 256, 0, 0, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_t128, 128, 0, 0, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(ww8, 256, 8, 0, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(ww16, 256, 16, 0, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(ww32, 256, 32, 0, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(refill32_split, 256, 0, 32, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(refill4_split, 256, 0, 4, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(refill8_split, 256, 0, 8, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(refill16_split, 256, 0, 16, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(refill8_ww16, 256, 16, 8, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(refill8_split_t128, 128, 0, 8, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_t64, 64, 0, 0, 1, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_mb8, 256, 0, 0, 8, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_t128_mb16, 128, 0, 0, 16, 0, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_leafna, 256, 0, 0, 1, 1, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_t128_leafna, 128, 0, 0, 1, 1, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_innerel, 256, 0, 0, 1, 8, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_innerel_leafna, 256, 0, 0, 1, 9, -1, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_carve0, 256, 0, 0, 1, 0, 0, 0, 0, 0, 0)
RK_PWALK_DESIGN(split_t128_leafna_carve0, 128, 0, 0, 1, 1, 0, 0, 0, 0, 0)
RK_PWALK_DESIGN(octsort_t128, 128, 0, 0, 1, 0, -1, 1, 0, 0, 0)
RK_PWALK_DESIGN(octsort_t256, 256, 0, 0, 1, 0, -1, 1, 0, 0, 0)
RK_PWALK_DESIGN(octsort_t512, 512, 0, 0, 1, 0, -1, 1, 0, 0, 0)
RK_PWALK_DESIGN(octsort_t1024, 1024, 0, 0, 1, 0, -1, 1, 0, 0, 0)
RK_PWALK_DESIGN(persist4_t128, 128, 0, 0, 1, 0, -1, 0, 4, 0, 0)
RK_PWALK_DESIGN(persist6_t128, 128, 0, 0, 1, 0, -1, 0, 6, 0, 0)
RK_PWALK_DESIGN(persist8_t128, 128, 0, 0, 1, 0, -1, 0, 8, 0, 0)
RK_PWALK_DESIGN(persist10_t128, 128, 0, 0, 1, 0, -1, 0, 10, 0, 0)
RK_PWALK_DESIGN(bin1_t128, 128, 0, 0, 1, 0, -1, 0, 0, 1, 0)
RK_PWALK_DESIGN(bin3_t128, 128, 0, 0, 1, 0, -1, 0, 0, 3, 0)
RK_PWALK_DESIGN(bin4_t128, 128, 0, 0, 1, 0, -1, 0, 0, 4, 0)
RK_PWALK_DESIGN(bin5_t128, 128, 0, 0, 1, 0, -1, 0, 0, 5, 0)
RK_PWALK_DESIGN(bin4_persist8_t128, 128, 0, 0, 1, 0, -1, 0, 8, 4, 0)
RK_PWALK_DESIGN(regions10_t128, 128, 0, 0, 1, 0, -1, 0, -10, 0, 0)
RK_PWALK_DESIGN(regions5_t256, 256, 0, 0, 1, 0, -1, 0, -5, 0, 0)
RK_PWALK_DESIGN(octsort_persist10_t128, 128, 0, 0, 1, 0, -1, 1, 10, 0, 0)
RK_PWALK_DESIGN(octsort_persist5_t256, 256, 0, 0, 1, 0, -1, 1, 5, 0, 0)
RK_PWALK_DESIGN(wsort32_octsort_t256, 256, 0, 0, 1, 0, -1, 1, 0, 0, 32)
RK_PWALK_DESIGN(wsort41_octsort_t256, 256, 0, 0, 1, 0, -1, 1, 0, 0, 41)
RK_PWALK_DESIGN(wsort31_octsort_t256, 256, 0, 0, 1, 0, -1, 1, 0, 0, 31)
RK_PWALK_DESIGN(wsort32_octsort_t128, 128, 0, 0, 1, 0, -1, 1, 0, 0, 32)
RK_PWALK_DESIGN(wsort32_t128, 128, 0, 0, 1, 0, -1, 0, 0, 0, 32)
