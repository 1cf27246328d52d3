// The skip-link walk of the packed LBVH table (raypt_torch/accel/
// packed.py: traverse_wavefront): the table, the steps, the walk of a
// ray and the hand-out of a block's rays by octant that the package
// kernel (packed_walk.cu) and the designs of packed_walk_designs.cu
// (timed by the sweep) share.
//
// The split table. The kernels do not walk `PackedLBVH.rows` itself but
// a table derived from it on every call (split_build_kernel), whose
// floats are the rows' bit for bit and whose links carry the kind of
// the row they point at, so a step knows which row to read before it
// reads it:
//   inner[2 n .. 2 n + 1] = [bmin, bmax.x | bmax.y, bmax.z, code(left),
//                            code(skip)]           (32 bytes, one sector)
//   leaves[3 n .. 3 n + 2] = [p0, e1.x | e1.y, e1.z, e2.x, e2.y |
//                             e2.z, face, code(skip), 0]        (48 bytes)
// indexed by the row's own number n, with code(s) = -1 for s < 0 (the
// walk's end), s for an internal row and s | 0x80000000 for a leaf row
// (its flag, row[14] > 0.5, read from the table). An internal step reads
// one 32-byte sector where a table row is 64 bytes; no link is
// renumbered, so each ray visits the same rows in the same order.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace rk {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLeafBit = INT_MIN;   // 0x80000000
constexpr int kInnerF4 = 2;         // float4 a split internal row
constexpr int kLeafF4 = 3;          // float4 a split leaf row
constexpr int kBuildThreads = 256;

// torch.minimum / torch.maximum on a comparison's operand: NaN when
// either operand is NaN (the result's sign of zero and NaN payload may
// differ from torch's; no comparison can see either).
__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// safe_reciprocal of one component (an IEEE division, once a ray).
__device__ __forceinline__ float safe_inv(float d) {
    const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
    return 1.0f / safe;
}

// (ok ? 1 : 0) / (ok ? det : 1): the fast reciprocal of cluster_test.cuh
// and, where it is wrong (|det| >= 2^126), the exact one.
__device__ __forceinline__ float leaf_inv_det(float det, bool ok) {
    bool redo = false;
    float r = inv_det_of<true>(det, ok, redo);
    if (redo) r = inv_det_of<false>(det, ok, redo);
    return r;
}

// The row loads of the walk templates below (their class L): through
// the read-only path. packed_walk_designs.cu's designs bring their own,
// with L1 eviction priorities.
struct RowLoads {
    static __device__ __forceinline__ float4 inner(const float4* p) { return __ldg(p); }
    static __device__ __forceinline__ float4 leaf(const float4* p) { return __ldg(p); }
};

struct WalkRay {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ WalkRay load_walk_ray(const float* ro, const float* rd,
                                                 long long i) {
    WalkRay w;
    w.ox = ro[3 * i];
    w.oy = ro[3 * i + 1];
    w.oz = ro[3 * i + 2];
    w.dx = rd[3 * i];
    w.dy = rd[3 * i + 1];
    w.dz = rd[3 * i + 2];
    w.ix = safe_inv(w.dx);
    w.iy = safe_inv(w.dy);
    w.iz = safe_inv(w.dz);
    return w;
}

// The slab test of an internal row: the code of the next row.
template <class L>
__device__ __forceinline__ int slab_step(const float4* __restrict__ inner, int c,
                                         const WalkRay& w, float t_best) {
    const float4* row = inner + kInnerF4 * (long long)c;
    const float4 a = L::inner(row), b = L::inner(row + 1);
    const float n1x = (a.x - w.ox) * w.ix, n1y = (a.y - w.oy) * w.iy,
                n1z = (a.z - w.oz) * w.iz;
    const float n2x = (a.w - w.ox) * w.ix, n2y = (b.x - w.oy) * w.iy,
                n2z = (b.y - w.oz) * w.iz;
    const float tnear =
        max_nan(max_nan(min_nan(n1x, n2x), min_nan(n1y, n2y)), min_nan(n1z, n2z));
    const float tfar =
        min_nan(min_nan(max_nan(n1x, n2x), max_nan(n1y, n2y)), max_nan(n1z, n2z));
    const bool nonempty = a.x <= a.w && a.y <= b.x && a.z <= b.y;
    const bool hit = tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
    return __float_as_int(hit ? b.z : b.w);
}

// The Moller-Trumbore test of a leaf row, taken when strictly nearer
// than t_best: the code of the next row (its skip).
template <class L>
__device__ __forceinline__ int leaf_step(const float4* __restrict__ leaves, int c,
                                         const WalkRay& w, float& t_best, int& face) {
    const float4* row = leaves + kLeafF4 * (long long)(c & INT_MAX);
    const float4 a = L::leaf(row), b = L::leaf(row + 1), g = L::leaf(row + 2);
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = g.x;
    const float px = w.dy * e2z - w.dz * e2y;
    const float py = w.dz * e2x - w.dx * e2z;
    const float pz = w.dx * e2y - w.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > 1e-8f;
    const float inv_det = leaf_inv_det(det, ok);
    const float tx = w.ox - a.x, ty = w.oy - a.y, tz = w.oz - a.z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (w.dx * qx + w.dy * qy + w.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < t_best) {
        t_best = t;
        face = __float_as_int(g.y);
    }
    return __float_as_int(g.z);
}

__device__ __forceinline__ int split_code(const int4* __restrict__ rows, int s) {
    if (s < 0) return -1;
    return __int_as_float(rows[4 * (long long)s + 3].z) > 0.5f ? (s | kLeafBit) : s;
}

// The split table of `rows`, one thread a row, bits copied as int4. (A
// template, like the walk kernels, so that two sources of one library
// may include this header.)
template <int kUnused = 0>
__global__ void __launch_bounds__(kBuildThreads)
split_build_kernel(const int4* __restrict__ rows, long long n_rows,
                   int4* __restrict__ inner, int4* __restrict__ leaves) {
    const long long n = (long long)blockIdx.x * kBuildThreads + threadIdx.x;
    if (n >= n_rows) return;
    const int4 a = rows[4 * n], b = rows[4 * n + 1], c = rows[4 * n + 2],
               e = rows[4 * n + 3];
    if (__int_as_float(e.z) > 0.5f) {
        int4* out = leaves + kLeafF4 * n;
        out[0] = a;
        out[1] = b;
        out[2] = make_int4(c.x, e.x, split_code(rows, e.y), 0);
    } else {
        int4* out = inner + kInnerF4 * n;
        out[0] = a;
        out[1] = make_int4(b.x, b.y, split_code(rows, e.x), split_code(rows, e.y));
    }
}

// The code of row 0, where every walk starts.
__device__ __forceinline__ int root_code(const float* rows) {
    return __ldg(rows + 14) > 0.5f ? kLeafBit : 0;
}

// The ray a thread of a kThreads block walks when the block's rays (ray
// i the thread's) are handed out by direction octant: a stable counting
// sort of the block's rays on the key octant (0-7) for a live ray, 8 for
// a dead one or one past the end, so a warp holds rays of one octant
// from neighbouring pixels where the block has 32 of them, and the dead
// rays' warps come last. The rays are independent, so the order changes
// no result.
template <int kThreads>
__device__ __forceinline__ long long sorted_ray(long long i, const float* rd,
                                                const bool* active, long long r,
                                                bool walks) {
    constexpr int kWarps = kThreads / 32, kBins = 9;
    __shared__ int s_count[kBins][kWarps];
    __shared__ int s_total[kBins];
    __shared__ long long s_ray[kThreads];
    int key = kBins - 1;
    if (walks && i < r && active[i])
        key = (rd[3 * i] < 0.0f) | ((rd[3 * i + 1] < 0.0f) << 1) |
              ((rd[3 * i + 2] < 0.0f) << 2);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int rank = 0;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
        const unsigned m = __ballot_sync(kFullMask, key == b);
        if (lane == 0) s_count[b][warp] = __popc(m);
        if (key == b) rank = __popc(m & ((1u << lane) - 1u));
    }
    __syncthreads();
    if (threadIdx.x < kBins) {
        int n = 0;
        for (int w = 0; w < kWarps; ++w) n += s_count[threadIdx.x][w];
        s_total[threadIdx.x] = n;
    }
    __syncthreads();
    int at = rank;
    for (int b = 0; b < key; ++b) at += s_total[b];
    for (int w = 0; w < warp; ++w) at += s_count[key][w];
    s_ray[at] = i;
    __syncthreads();
    const long long sorted = s_ray[threadIdx.x];
    __syncthreads();   // s_ray and the counts may be used again
    return sorted;
}

// One step of the lane's ray, of the kind its code names (c != -1),
// and the end of its walk when its step budget runs out.
template <class L, bool kCapped>
__device__ __forceinline__ void any_step(const float4* inner, const float4* leaves,
                                         int& c, const WalkRay& w, float& t_best,
                                         int& face, long long& left) {
    c = c >= 0 ? slab_step<L>(inner, c, w, t_best)
               : leaf_step<L>(leaves, c, w, t_best, face);
    if constexpr (kCapped) {
        if (--left == 0) c = -1;
    }
}

// The walk of ray i (none for i >= r), each lane its own kind of step,
// and its result's store.
template <class L, bool kCapped>
__device__ __forceinline__ void walk_ray(long long i, const float* __restrict__ rows,
                                         const float4* __restrict__ inner,
                                         const float4* __restrict__ leaves,
                                         const float* __restrict__ ro,
                                         const float* __restrict__ rd,
                                         const float* __restrict__ t0,
                                         const bool* __restrict__ active,
                                         float* __restrict__ t_out,
                                         int* __restrict__ face_out, long long r,
                                         long long max_steps) {
    const bool in = i < r;
    float t_best = in ? t0[i] : 0.0f;
    int face = -1;
    int c = (in && active[i] && !(kCapped && max_steps == 0)) ? root_code(rows) : -1;
    WalkRay w{};
    if (c != -1) w = load_walk_ray(ro, rd, i);
    long long left = max_steps;
    while (c != -1) any_step<L, kCapped>(inner, leaves, c, w, t_best, face, left);
    if (in) {
        t_out[i] = t_best;
        face_out[i] = face;
    }
}

// The scratch of the split table, in float4: an internal and a leaf row
// for each table row.
inline long long split_scratch_f4(long long n_rows) {
    return (kInnerF4 + kLeafF4) * n_rows;
}

// Builds the split table into `scratch` (split_scratch_f4 float4: the
// internal rows, then the leaf rows).
inline cudaError_t build_split_table(const float* rows, long long n_rows, void* scratch,
                                     cudaStream_t s) {
    int4* inner = reinterpret_cast<int4*>(scratch);
    split_build_kernel<0><<<(unsigned)((n_rows + kBuildThreads - 1) / kBuildThreads),
                            kBuildThreads, 0, s>>>(reinterpret_cast<const int4*>(rows),
                                                   n_rows, inner,
                                                   inner + kInnerF4 * n_rows);
    return cudaGetLastError();
}

// A walk kernel's registers, local (spill) bytes, resident blocks an SM
// and threads a block: info[0..3].
template <class K>
int walk_kernel_info(K kernel, int threads, int* info) {
    cudaFuncAttributes attr{};
    int per_sm = 0;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    info[0] = attr.numRegs;
    info[1] = (int)attr.localSizeBytes;
    info[2] = per_sm;
    info[3] = threads;
    return (int)e;
}

}  // namespace rk
