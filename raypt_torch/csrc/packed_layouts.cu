// Skip-link walks of the packed table's other layouts, for Hopper
// (sm_90a): the cherry-merged 32-wide table, the 16-wide lookahead
// table and the quad-collapsed 64-wide table with plain or lookahead
// internal rows.
//
// Replaces XLA loops, not Pallas kernels: raypt/accel/packed.py:
// traverse_wavefront2 (:577), traverse_wavefront_la (:328) and
// traverse_wavefront4 (:497), the `lax.while_loop`s behind the `bvh`
// backend with RenderConfig.leaf_tris = 2, node_lookahead = True and
// leaf_tris = 4 (either node_lookahead); and, one launch over the whole
// wavefront, traverse_wavefront_compact (:740), traversal_mode
// "compact" / "unrolled", whose phases and compaction were a schedule
// for the TPU's loops and change no ray's result.
//
// Contract (traverse_wavefront's): each live ray starts at row 0 with
// t_best = t0 and face -1 and, until its node is -1, reads its row: an
// internal row sends it to the left child when its box is hit and to
// the skip link otherwise (a lookahead row: the left child when the
// left box is hit, else the right child when the right box is, else
// the skip link); a leaf row's triangles are tested, the nearest
// replacing (t_best, face) when strictly nearer, then the ray follows
// the skip link. Within a cherry row b replaces a only when strictly
// nearer; within a quad row the lowest slot of the least t wins. A miss
// counts as t = BIG (1e30) in that choice, and the choice is taken when
// BIG < t_best too, as the plain version takes it. A lookahead row tests
// its child boxes with the t_best after its leaf test. A dead ray keeps
// t0 and face -1 and reads nothing.
//
// Every operation is the plain torch version's (raypt_torch/accel/
// packed.py: _step2, _step_la, _quad_step), in its order, through the
// helpers of packed_walk.cuh: the clamped reciprocal direction, the slab
// test with min / max that propagate NaN, the Moller-Trumbore test with
// the correctly rounded 1 / det. Built with -fmad=false, each kernel is
// bitwise equal to its plain version.
//
// What bounds it: the rows' bytes. A step reads first the float4 that
// holds the row's kind and links (cherry [20:24], lookahead [12:16],
// quad [48:52]) and then only the floats its kind needs: an internal row
// 32 bytes of box (48 for a lookahead row's two boxes; a cherry row also
// the float4 of its left link), a cherry leaf 80 bytes, a lookahead leaf
// 48, a quad leaf 144 of triangles and 16 of face ids. The quad leaf's
// four tests are each a Moller-Trumbore test, empty slots too (their
// zero edges fail det), as in the plain version. Design (the simple one,
// as csrc/packed_walk.cu's first form): one thread walks one ray over
// the rows themselves, with no derived table, and each 128-ray block
// hands its rays to its threads by direction octant, live rays first
// (rk::sorted_ray), which changes no result.
#include <cuda_runtime.h>

#include "packed_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 1e30f;   // core.math3d.BIG: "no hit"

// The slab test of one box (slab_step's arithmetic, on floats already
// loaded).
__device__ __forceinline__ bool box_hit(float lx, float ly, float lz, float hx, float hy,
                                        float hz, const rk::WalkRay& w, float t_best) {
    const float n1x = (lx - w.ox) * w.ix, n1y = (ly - w.oy) * w.iy,
                n1z = (lz - w.oz) * w.iz;
    const float n2x = (hx - w.ox) * w.ix, n2y = (hy - w.oy) * w.iy,
                n2z = (hz - w.oz) * w.iz;
    const float tnear = rk::max_nan(rk::max_nan(rk::min_nan(n1x, n2x), rk::min_nan(n1y, n2y)),
                                    rk::min_nan(n1z, n2z));
    const float tfar = rk::min_nan(rk::min_nan(rk::max_nan(n1x, n2x), rk::max_nan(n1y, n2y)),
                                   rk::max_nan(n1z, n2z));
    const bool nonempty = lx <= hx && ly <= hy && lz <= hz;
    return tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
}

// The Moller-Trumbore test of one triangle in edge form (leaf_step's
// arithmetic): whether it is hit strictly nearer than t_best, and t.
__device__ __forceinline__ bool tri_hit(const float* q, const rk::WalkRay& w, float t_best,
                                        float& t) {
    const float p0x = q[0], p0y = q[1], p0z = q[2];
    const float e1x = q[3], e1y = q[4], e1z = q[5];
    const float e2x = q[6], e2y = q[7], e2z = q[8];
    const float px = w.dy * e2z - w.dz * e2y;
    const float py = w.dz * e2x - w.dx * e2z;
    const float pz = w.dx * e2y - w.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > 1e-8f;
    const float inv_det = rk::leaf_inv_det(det, ok);
    const float tx = w.ox - p0x, ty = w.oy - p0y, tz = w.oz - p0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (w.dx * qx + w.dy * qy + w.dz * qz) * inv_det;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < t_best;
}

// n float4 of a row into f[0 .. 4 n).
template <int kN>
__device__ __forceinline__ void load_f4(const float4* row, float* f) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
        const float4 v = __ldg(row + k);
        f[4 * k] = v.x;
        f[4 * k + 1] = v.y;
        f[4 * k + 2] = v.z;
        f[4 * k + 3] = v.w;
    }
}

// A lookahead row's child boxes (f[0:6] left, f[6:12] right): the next
// node.
__device__ __forceinline__ int child_link(const float* f, int left, int right, int skip,
                                          const rk::WalkRay& w, float t_best) {
    if (box_hit(f[0], f[1], f[2], f[3], f[4], f[5], w, t_best)) return left;
    if (box_hit(f[6], f[7], f[8], f[9], f[10], f[11], w, t_best)) return right;
    return skip;
}

// The cherry table's step (raypt_torch/accel/packed.py: _step2).
struct Cherry {
    static constexpr int kF4 = 8;   // 32 floats a row
    static __device__ __forceinline__ int step(const float4* row, const rk::WalkRay& w,
                                               float& t_best, int& face) {
        const float4 k = __ldg(row + 5);   // [20:24]: skip, flag
        const int skip = __float_as_int(k.x);
        float f[20];
        if (k.y > 0.5f) {
            load_f4<5>(row, f);
            float ta, tb;
            const bool ha = tri_hit(f, w, t_best, ta);
            const bool hb = tri_hit(f + 9, w, t_best, tb);
            ta = ha ? ta : kBig;
            tb = hb ? tb : kBig;
            const bool b_wins = tb < ta;
            const float tmin = b_wins ? tb : ta;
            if (tmin < t_best) {
                t_best = tmin;
                face = __float_as_int(b_wins ? f[19] : f[18]);
            }
            return skip;
        }
        load_f4<2>(row, f);
        const int left = __float_as_int(__ldg(row + 4).z);   // [18]
        return box_hit(f[0], f[1], f[2], f[3], f[4], f[5], w, t_best) ? left : skip;
    }
};

// The lookahead table's step (_step_la).
struct Lookahead {
    static constexpr int kF4 = 4;   // 16 floats a row
    static __device__ __forceinline__ int step(const float4* row, const rk::WalkRay& w,
                                               float& t_best, int& face) {
        const float4 k = __ldg(row + 3);   // [12:16]: left / face, skip, flag, right
        const int skip = __float_as_int(k.y);
        float f[12];
        load_f4<3>(row, f);
        if (k.z > 0.5f) {
            float t;
            if (tri_hit(f, w, t_best, t)) {
                t_best = t;
                face = __float_as_int(k.x);
            }
            return skip;
        }
        return child_link(f, __float_as_int(k.x), __float_as_int(k.w), skip, w, t_best);
    }
};

// The quad table's step (_quad_step), with plain or lookahead internal
// rows.
template <bool kLookahead>
struct Quad {
    static constexpr int kF4 = 16;   // 64 floats a row
    static __device__ __forceinline__ int step(const float4* row, const rk::WalkRay& w,
                                               float& t_best, int& face) {
        const float4 k = __ldg(row + 12);   // [48:52]: left, skip, flag, right
        const int skip = __float_as_int(k.y);
        float f[36];
        if (k.z > 0.5f) {
            load_f4<9>(row, f);
            float tmin = kBig;
            int kbest = 0;
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                float t;
                const float tk = tri_hit(f + 9 * s, w, t_best, t) ? t : kBig;
                if (tk < tmin) {   // the first slot of the least t
                    tmin = tk;
                    kbest = s;
                }
            }
            if (tmin < t_best) {
                const float4 ids = __ldg(row + 11);   // [44:48]
                t_best = tmin;
                face = __float_as_int(kbest == 0 ? ids.x : kbest == 1 ? ids.y
                                                   : kbest == 2 ? ids.z : ids.w);
            }
            return skip;
        }
        const int left = __float_as_int(k.x);
        if constexpr (kLookahead) {
            load_f4<3>(row, f);
            return child_link(f, left, __float_as_int(k.w), skip, w, t_best);
        } else {
            load_f4<2>(row, f);
            return box_hit(f[0], f[1], f[2], f[3], f[4], f[5], w, t_best) ? left : skip;
        }
    }
};

// One thread a ray: the ray rk::sorted_ray hands the thread, walked over
// the rows of layout S.
template <class S>
__global__ void __launch_bounds__(kThreads)
layout_walk_kernel(const float4* __restrict__ rows, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ t0,
                   const bool* __restrict__ active, float* __restrict__ t_out,
                   int* __restrict__ face_out, long long r) {
    const long long slot = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long i = rk::sorted_ray<kThreads>(slot, rd, active, r, true);
    const bool in = i < r;
    float t_best = in ? t0[i] : 0.0f;
    int face = -1;
    int node = (in && active[i]) ? 0 : -1;
    rk::WalkRay w{};
    if (node >= 0) w = rk::load_walk_ray(ro, rd, i);
    while (node >= 0) node = S::step(rows + (long long)S::kF4 * node, w, t_best, face);
    if (in) {
        t_out[i] = t_best;
        face_out[i] = face;
    }
}

// The layouts, by the code the wrappers pass (kernels/packed_walk.py:
// WALKS).
enum Layout { kCherry = 0, kLookahead = 1, kQuad = 2, kQuadLookahead = 3 };

template <class S>
cudaError_t launch(const float* rows, const float* ro, const float* rd, const float* t0,
                   const bool* active, float* t_out, int* face_out, long long r,
                   cudaStream_t s) {
    const unsigned grid = (unsigned)((r + kThreads - 1) / kThreads);
    layout_walk_kernel<S><<<grid, kThreads, 0, s>>>(reinterpret_cast<const float4*>(rows),
                                                    ro, rd, t0, active, t_out, face_out, r);
    return cudaGetLastError();
}

}  // namespace

// The walk of a table of layout `layout` (Layout) with n_rows rows over
// r rays. rows must be 16-byte aligned.
extern "C" int rk_layout_walk(int layout, const float* rows, long long n_rows,
                              const float* ro, const float* rd, const float* t0,
                              const bool* active, float* t_out, int* face_out, long long r,
                              void* stream) {
    if (r < 0 || n_rows < 1 || reinterpret_cast<uintptr_t>(rows) % 16)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (layout) {
        case kCherry:
            return (int)launch<Cherry>(rows, ro, rd, t0, active, t_out, face_out, r, s);
        case kLookahead:
            return (int)launch<Lookahead>(rows, ro, rd, t0, active, t_out, face_out, r, s);
        case kQuad:
            return (int)launch<Quad<false>>(rows, ro, rd, t0, active, t_out, face_out, r, s);
        case kQuadLookahead:
            return (int)launch<Quad<true>>(rows, ro, rd, t0, active, t_out, face_out, r, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// A layout's kernel's registers, local (spill) bytes, resident blocks an
// SM and threads a block (info[0..3]).
extern "C" int rk_layout_walk_info(int layout, int* info) {
    switch (layout) {
        case kCherry:
            return rk::walk_kernel_info(layout_walk_kernel<Cherry>, kThreads, info);
        case kLookahead:
            return rk::walk_kernel_info(layout_walk_kernel<Lookahead>, kThreads, info);
        case kQuad:
            return rk::walk_kernel_info(layout_walk_kernel<Quad<false>>, kThreads, info);
        case kQuadLookahead:
            return rk::walk_kernel_info(layout_walk_kernel<Quad<true>>, kThreads, info);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
