// The steps of the ordered-stack walk of the 4-wide BVH (raypt_torch/
// accel/wide.py: traverse_wide), shared by the package kernel
// (wide_walk.cu) and the designs of wide_walk_designs.cu (timed by
// `python -m raypt_torch.kernels.sweep --kernels wide`): an entry's slab
// test, an internal row's entries, their sort and pushes, a pop, a leaf
// slot's Moller-Trumbore test and a warp's cooperative leaf phase. Each
// is the plain walk's operations in its order, so a walk built from them
// gives its t, face and overflow bit for bit.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "packed_walk.cuh"

namespace wide {

constexpr int kRowF4 = 16;      // float4 a 64-float row
constexpr int kLeafK = 4;       // triangles a leaf row

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// One entry's slab test: its distance, inf where missed (NaN-propagating
// min / max, so a NaN misses).
__device__ __forceinline__ float slab(float x0, float y0, float z0, float x1, float y1,
                                      float z1, const rk::WalkRay& w, float t_best) {
    const float n1x = (x0 - w.ox) * w.ix, n1y = (y0 - w.oy) * w.iy,
                n1z = (z0 - w.oz) * w.iz;
    const float n2x = (x1 - w.ox) * w.ix, n2y = (y1 - w.oy) * w.iy,
                n2z = (z1 - w.oz) * w.iz;
    const float tnear = rk::max_nan(rk::max_nan(rk::min_nan(n1x, n2x), rk::min_nan(n1y, n2y)),
                                    rk::min_nan(n1z, n2z));
    const float tfar = rk::min_nan(rk::min_nan(rk::max_nan(n1x, n2x), rk::max_nan(n1y, n2y)),
                                   rk::max_nan(n1z, n2z));
    const bool nonempty = x0 <= x1 && y0 <= y1 && z0 <= z1;
    const bool ok = tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
    return ok ? rk::max_nan(tnear, 0.0f) : inf();
}

// The four entries of an internal row: distances (inf where missed or
// absent) and child row ids, each entry's slab test on its own float4
// pair as they load.
__device__ __forceinline__ void entries(const float4* row, const rk::WalkRay& w,
                                        float t_best, float (&tn)[4], int (&id)[4]) {
    const float4 ids = __ldg(row + 6);
    id[0] = __float_as_int(ids.x);
    id[1] = __float_as_int(ids.y);
    id[2] = __float_as_int(ids.z);
    id[3] = __float_as_int(ids.w);
    const float4 q0 = __ldg(row), q1 = __ldg(row + 1);
    tn[0] = id[0] >= 0 ? slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, w, t_best) : inf();
    const float4 q2 = __ldg(row + 2);
    tn[1] = id[1] >= 0 ? slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, w, t_best) : inf();
    const float4 q3 = __ldg(row + 3), q4 = __ldg(row + 4);
    tn[2] = id[2] >= 0 ? slab(q3.x, q3.y, q3.z, q3.w, q4.x, q4.y, w, t_best) : inf();
    const float4 q5 = __ldg(row + 5);
    tn[3] = id[3] >= 0 ? slab(q4.z, q4.w, q5.x, q5.y, q5.z, q5.w, w, t_best) : inf();
}

// One exchange of the sort, as selects: swap on strict >.
__device__ __forceinline__ void exchange(float& ta, float& tb, int& ia, int& ib) {
    const bool s = ta > tb;
    const float lo = s ? tb : ta, hi = s ? ta : tb;
    const int il = s ? ib : ia, ih = s ? ia : ib;
    ta = lo;
    tb = hi;
    ia = il;
    ib = ih;
}

// The sort of an internal row's four entries: the exchanges (0,1),
// (2,3), (0,2), (1,3), (1,2).
__device__ __forceinline__ void sort4(float (&tn)[4], int (&id)[4]) {
    exchange(tn[0], tn[1], id[0], id[1]);
    exchange(tn[2], tn[3], id[2], id[3]);
    exchange(tn[0], tn[2], id[0], id[2]);
    exchange(tn[1], tn[3], id[1], id[3]);
    exchange(tn[1], tn[2], id[1], id[2]);
}

// The Moller-Trumbore test of one leaf slot, taken when strictly nearer.
__device__ __forceinline__ void leaf_slot(const float4 a, const float4 b, const float4 g,
                                          const rk::WalkRay& w, float& t_best, int& face) {
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = g.x;
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
    if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < t_best) {
        t_best = t;
        face = __float_as_int(g.y);
    }
}

// A leaf slot's hit distance, NaN where the slot cannot hit (its test
// without the compare with t_best, on the ray o, d): the same
// operations as leaf_slot's.
__device__ __forceinline__ float slot_t(const float4 a, const float4 b, const float4 g,
                                        float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = g.x;
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > 1e-8f;
    const float inv_det = rk::leaf_inv_det(det, ok);
    const float tx = ox - a.x, ty = oy - a.y, tz = oz - a.z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
    return hit ? t : __int_as_float(0x7fffffff);
}

// A thread's stack of kCap entries in local memory.
template <int kCap>
struct LocalStack {
    int v[kCap];
    __device__ __forceinline__ void put(int k, int x) { v[k] = x; }
    __device__ __forceinline__ int get(int k) const { return v[k]; }
};

// A live ray's state.
struct Walker {
    float t_best;
    int face;
    int ovf;   // 0 or 1
    int node;
    int sp;
};

// A ray's start: t0 + rd.x * 0, face -1, at the root if it is live.
__device__ __forceinline__ Walker start(long long i, int root, const float* __restrict__ ro,
                                        const float* __restrict__ rd,
                                        const float* __restrict__ t0,
                                        const bool* __restrict__ active, rk::WalkRay& w) {
    w = rk::load_walk_ray(ro, rd, i);
    return Walker{t0[i] + w.dx * 0.0f, -1, 0, active[i] ? root : -1, 0};
}

// The row of a walker's node, its id clamped to the table.
__device__ __forceinline__ const float4* row_of(const float4* rows, int n_rows,
                                                int node) {
    return rows + kRowF4 * (long long)(node < n_rows ? node : n_rows - 1);
}

// A pop: INT_MIN from beyond the stack, -1 from an empty one.
template <class S>
__device__ __forceinline__ void pop(Walker& k, const S& st, int stack_d) {
    if (k.sp > 0) {
        --k.sp;
        k.node = k.sp < stack_d ? st.get(k.sp) : INT_MIN;
    } else {
        k.node = -1;
    }
}

// The descent to a sorted row's entry 0 when it is hit, else a pop.
template <class S>
__device__ __forceinline__ void descend(const float (&tn)[4], const int (&id)[4], Walker& k,
                                        const S& st, int stack_d) {
    if (tn[0] < inf())
        k.node = id[0];
    else
        pop(k, st, stack_d);
}

// An internal row's visit after its entries' slab tests: the entries
// sorted, the pushes (3, 2, 1, far first; a push at sp >= stack_d writes
// nothing, sets the flag and counts), then the descent.
template <class S>
__device__ __forceinline__ void order_and_push(float (&tn)[4], int (&id)[4], Walker& k,
                                               S& st, int stack_d) {
    sort4(tn, id);
#pragma unroll
    for (int e = 3; e >= 1; --e) {
        if (tn[e] < inf()) {
            if (k.sp < stack_d)
                st.put(k.sp, id[e]);
            else
                k.ovf = 1;
            ++k.sp;
        }
    }
    descend(tn, id, k, st, stack_d);
}

// A warp's shared memory for its cooperative phases: the owner lanes in
// lane order, and each one's four slots' (or entries') distances and
// faces (or child ids).
struct LeafShare {
    int owner[32];
    float t[4 * 32];
    int face[4 * 32];
};

// The cooperative leaf phase of a warp (every lane calls it together):
// the lanes of `ml` sit at leaf rows; their 4 * popc(ml) slots are
// tested 32 at a time, slot j by lane j % 32 on its owner's ray and row
// (shuffled from the owner), then each owner takes its slots' hits in
// slot order, each when strictly nearer than its t_best, as the plain
// walk's leaf step does, and pops.
template <class S>
__device__ __forceinline__ void leaf_phase(unsigned ml, const float4* __restrict__ rows,
                                           int n_rows, const rk::WalkRay& w,
                                           Walker& k, S& st, int stack_d, LeafShare& sh,
                                           int lane) {
    const bool mine = (ml >> lane) & 1u;
    const int rank = __popc(ml & ((1u << lane) - 1u));
    if (mine) sh.owner[rank] = lane;
    __syncwarp();
    const int tests = 4 * __popc(ml);
    for (int base = 0; base < tests; base += 32) {
        const int j = base + lane;
        const int owner = sh.owner[(j < tests ? j : 0) >> 2];
        const float ox = __shfl_sync(rk::kFullMask, w.ox, owner);
        const float oy = __shfl_sync(rk::kFullMask, w.oy, owner);
        const float oz = __shfl_sync(rk::kFullMask, w.oz, owner);
        const float dx = __shfl_sync(rk::kFullMask, w.dx, owner);
        const float dy = __shfl_sync(rk::kFullMask, w.dy, owner);
        const float dz = __shfl_sync(rk::kFullMask, w.dz, owner);
        const int node = __shfl_sync(rk::kFullMask, k.node, owner);
        if (j < tests) {
            const float4* row = row_of(rows, n_rows, node) + 3 * (j & 3);
            const float4 a = __ldg(row), b = __ldg(row + 1), g = __ldg(row + 2);
            sh.t[j] = slot_t(a, b, g, ox, oy, oz, dx, dy, dz);
            sh.face[j] = __float_as_int(g.y);
        }
    }
    __syncwarp();
    if (mine) {
#pragma unroll
        for (int s = 0; s < kLeafK; ++s) {
            const float t = sh.t[4 * rank + s];
            if (t < k.t_best) {
                k.t_best = t;
                k.face = sh.face[4 * rank + s];
            }
        }
        pop(k, st, stack_d);
    }
    __syncwarp();
}

}  // namespace wide
