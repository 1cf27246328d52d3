// Ordered-stack walk of the 4-wide BVH with fat leaves, for Hopper
// (sm_90a).
//
// Replaces an XLA loop, not a Pallas kernel: raypt/accel/wide.py:
// traverse_wide (:186-302), the `lax.while_loop` behind the `bvh4`
// backend. Contract: (rows, root, nw_cap, ro, rd, t0, active, stack_d)
// -> (t_best f32, face i32, overflow bool), one value a ray. A live ray
// starts at `root` with t_best = t0 + rd.x * 0 and face -1 and, until
// its node is negative, reads its 256-byte row:
//   internal (node < nw_cap): four entries, each a box [bmin | bmax]
//     and a child row id (int32 bits, -1 = none). Each box gets the
//     slab test (hit when tfar >= tnear, tnear < t_best, tfar > 0 and
//     bmin <= bmax; its distance max(tnear, 0), else inf, and inf for an
//     absent child); the four (distance, id) pairs are sorted by the
//     exchanges (0,1), (2,3), (0,2), (1,3), (1,2), swapping on strict >;
//     the hit entries 3, 2, 1 are pushed (a push at sp >= stack_d writes
//     nothing, sets the overflow flag and still counts); the ray
//     descends to entry 0 when it is hit, else pops;
//   leaf: four Moller-Trumbore tests [p0 | e1 | e2 | face, 0, 0] in slot
//     order, each taken when strictly nearer than t_best; then a pop.
// A pop with sp == 0 ends the walk; a pop from slot sp - 1 >= stack_d
// reads INT_MIN (the fill of the JAX loop's take_along_axis), which ends
// it too. Node ids are clamped to the table, as JAX's gather clamps. A
// dead ray reads nothing and writes t0 + rd.x * 0, -1 and false.
//
// Every operation is the plain torch version's (raypt_torch/accel/
// wide.py: traverse_wide), in its order: the reciprocal direction with
// components below 1e-12 clamped, the slab's subtractions and products,
// min / max that propagate NaN (min.NaN / max.NaN), the cross products
// ay*bz - az*by, the three-term sums (x + y) + z, and 1 / det as the
// correctly rounded reciprocal (packed_walk.cuh: leaf_inv_det). Built
// with -fmad=false, it is bitwise equal to the plain version.
//
// What bounds it: like the packed walk (packed_walk.cu), the bytes its
// visits pull into the SMs. An internal visit reads 112 bytes (the four
// boxes and ids, seven 16-byte loads), a leaf visit 192 (twelve); the
// table, 256 bytes a row, is 4 MB for the bench scene and 46 MB for an
// 81,922-face mesh, about the size of the H100's 50 MB L2. The design is
// the simple one: one thread walks one ray, its stack in local memory
// (a compile-time capacity of 64, 256 or 1,024 entries, the smallest that
// holds stack_d), each 128-ray block's rays handed to its threads by
// direction octant as the packed walk does (packed_walk.cuh:
// sorted_ray), so a warp's rays start from neighbouring pixels in one
// octant and the dead rays' warps end at once. Making it fast is later
// work.
#include <climits>
#include <cuda_runtime.h>

#include "packed_walk.cuh"

namespace {

constexpr int kThreads = 128;   // a block's rays, handed out by octant
constexpr int kRowF4 = 16;      // float4 a 64-float row
constexpr int kLeafK = 4;       // triangles a leaf row

// One entry's slab test: its distance, inf where missed.
__device__ __forceinline__ float entry_distance(const float* b, const rk::WalkRay& w,
                                                float t_best) {
    const float n1x = (b[0] - w.ox) * w.ix, n1y = (b[1] - w.oy) * w.iy,
                n1z = (b[2] - w.oz) * w.iz;
    const float n2x = (b[3] - w.ox) * w.ix, n2y = (b[4] - w.oy) * w.iy,
                n2z = (b[5] - w.oz) * w.iz;
    const float tnear = rk::max_nan(rk::max_nan(rk::min_nan(n1x, n2x), rk::min_nan(n1y, n2y)),
                                    rk::min_nan(n1z, n2z));
    const float tfar = rk::min_nan(rk::min_nan(rk::max_nan(n1x, n2x), rk::max_nan(n1y, n2y)),
                                   rk::max_nan(n1z, n2z));
    const bool nonempty = b[0] <= b[3] && b[1] <= b[4] && b[2] <= b[5];
    const bool ok = tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
    return ok ? rk::max_nan(tnear, 0.0f) : __int_as_float(0x7f800000);
}

__device__ __forceinline__ void exchange(float* t, int* id, int a, int b) {
    if (t[a] > t[b]) {
        const float tt = t[a];
        t[a] = t[b];
        t[b] = tt;
        const int ii = id[a];
        id[a] = id[b];
        id[b] = ii;
    }
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

template <int kCap>
__global__ void __launch_bounds__(kThreads)
wide_walk_kernel(const float4* __restrict__ rows, long long n_rows, int root, long long nw,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t0, const bool* __restrict__ active,
                 float* __restrict__ t_out, int* __restrict__ face_out,
                 bool* __restrict__ ovf_out, long long r, int stack_d) {
    const long long slot = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long i = rk::sorted_ray<kThreads>(slot, rd, active, r, true);
    if (i >= r) return;
    const rk::WalkRay w = rk::load_walk_ray(ro, rd, i);
    float t_best = t0[i] + w.dx * 0.0f;
    int face = -1;
    bool ovf = false;
    int node = active[i] ? root : -1;
    int sp = 0;
    int stack[kCap];
    while (node >= 0) {
        const float4* row = rows + kRowF4 * (node < n_rows ? (long long)node : n_rows - 1);
        bool pop = true;
        if (node >= nw) {
#pragma unroll
            for (int s = 0; s < kLeafK; ++s)
                leaf_slot(__ldg(row + 3 * s), __ldg(row + 3 * s + 1), __ldg(row + 3 * s + 2),
                          w, t_best, face);
        } else {
            float box[24];
#pragma unroll
            for (int q = 0; q < 6; ++q) {
                const float4 v = __ldg(row + q);
                box[4 * q] = v.x;
                box[4 * q + 1] = v.y;
                box[4 * q + 2] = v.z;
                box[4 * q + 3] = v.w;
            }
            const float4 ids = __ldg(row + 6);
            int id[4] = {__float_as_int(ids.x), __float_as_int(ids.y), __float_as_int(ids.z),
                         __float_as_int(ids.w)};
            float tn[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tn[e] = id[e] >= 0 ? entry_distance(box + 6 * e, w, t_best)
                                   : __int_as_float(0x7f800000);
            exchange(tn, id, 0, 1);
            exchange(tn, id, 2, 3);
            exchange(tn, id, 0, 2);
            exchange(tn, id, 1, 3);
            exchange(tn, id, 1, 2);
#pragma unroll
            for (int k = 3; k >= 1; --k) {
                if (tn[k] < __int_as_float(0x7f800000)) {
                    if (sp < stack_d)
                        stack[sp] = id[k];
                    else
                        ovf = true;
                    ++sp;
                }
            }
            if (tn[0] < __int_as_float(0x7f800000)) {
                node = id[0];
                pop = false;
            }
        }
        if (pop) {
            if (sp > 0) {
                --sp;
                node = sp < stack_d ? stack[sp] : INT_MIN;
            } else {
                node = -1;
            }
        }
    }
    t_out[i] = t_best;
    face_out[i] = face;
    ovf_out[i] = ovf;
}

template <int kCap>
cudaError_t launch_walk(const float* rows, long long n_rows, int root, long long nw,
                        const float* ro, const float* rd, const float* t0,
                        const bool* active, float* t_out, int* face_out, bool* ovf_out,
                        long long r, int stack_d, cudaStream_t s) {
    const unsigned grid = (unsigned)((r + kThreads - 1) / kThreads);
    wide_walk_kernel<kCap><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(rows), n_rows, root, nw, ro, rd, t0, active, t_out,
        face_out, ovf_out, r, stack_d);
    return cudaGetLastError();
}

}  // namespace

// The largest stack_d the kernel takes.
extern "C" int rk_wide_walk_max_stack() { return 1024; }

// rows (n_rows, 64) f32, 16-byte aligned; 0 <= root < n_rows, nw <= n_rows,
// 1 <= stack_d <= rk_wide_walk_max_stack().
extern "C" int rk_wide_walk(const float* rows, long long n_rows, int root, long long nw,
                            const float* ro, const float* rd, const float* t0,
                            const bool* active, float* t_out, int* face_out, bool* ovf_out,
                            long long r, int stack_d, void* stream) {
    if (r < 0 || n_rows < 1 || root < 0 || root >= n_rows || nw < 0 || nw > n_rows ||
        stack_d < 1 || stack_d > rk_wide_walk_max_stack())
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (stack_d <= 64)
        return (int)launch_walk<64>(rows, n_rows, root, nw, ro, rd, t0, active, t_out,
                                    face_out, ovf_out, r, stack_d, s);
    if (stack_d <= 256)
        return (int)launch_walk<256>(rows, n_rows, root, nw, ro, rd, t0, active, t_out,
                                     face_out, ovf_out, r, stack_d, s);
    return (int)launch_walk<1024>(rows, n_rows, root, nw, ro, rd, t0, active, t_out,
                                  face_out, ovf_out, r, stack_d, s);
}

// The capacity-64 kernel's registers, local (spill and stack) bytes,
// resident blocks an SM and threads a block (info[0..3]).
extern "C" int rk_wide_walk_info(int* info) {
    return rk::walk_kernel_info(wide_walk_kernel<64>, kThreads, info);
}
