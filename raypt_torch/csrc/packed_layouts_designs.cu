// Design variants of the layout walks (rk_layout_walk in
// packed_layouts.cu), built and timed only by `python -m
// raypt_torch.kernels.sweep --kernels layouts`, which holds each one's t
// and face bitwise against the package kernel's. Each variant has, for
// each layout L it walks, a C entry point rk_lwalk_<name>_<L> (the
// package's arguments, without the layout), rk_lwalk_<name>_<L>_info
// (registers, local bytes, resident blocks an SM, threads a block) and
// rk_lwalk_<name>_<L>_scratch (float4 of scratch for n_rows rows):
//   * pr19: PR 19's kernels as they were, one thread a ray over the
//     table's own rows (layout_walk_kernel<Cherry>, <Lookahead>,
//     <Quad<false>>, <Quad<true>>), all four layouts: a step reads the
//     float4 of the row's kind and links, then its kind's floats (a
//     cherry internal row 64 bytes, a leaf 96; a lookahead row 64; a quad
//     internal row 48, a lookahead one 64, a leaf 176) and tests every
//     slot; no scratch;
//   * the split-table walks, each a rk::lay::Design over the tables of
//     packed_layouts.cuh (threads a block, the launch bound's blocks an
//     SM, how a step takes a leaf row's slots, every slot tested, how a
//     lookahead row's sectors are read), each block's rays handed
//     out by direction octant: RK_LWALK_DESIGN the cherry and quad
//     layouts' (kLoad 4 one slot a step, the header's slot_walk_kernel,
//     the kept design's walk; 0-3 and 5 this file's row_step_kernel),
//     RK_LWALK_LA_DESIGN the lookahead and quad-lookahead layouts' (the
//     header's slot_walk_kernel).
#include <cuda_runtime.h>

#include "packed_layouts.cuh"

namespace pr19 {

using rk::kBig;
using rk::load_walk_ray;
using rk::sorted_ray;
using rk::WalkRay;
using rk::lay::box_hit;
using rk::lay::mt_hit;

// mt_hit of the triangle at q[0:9] (p0, e1, e2).
__device__ __forceinline__ bool tri_hit(const float* q, const WalkRay& w, float t_best,
                                        float& t) {
    return mt_hit(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], w, t_best, t);
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
                                          const WalkRay& w, float t_best) {
    if (box_hit(f[0], f[1], f[2], f[3], f[4], f[5], w, t_best)) return left;
    if (box_hit(f[6], f[7], f[8], f[9], f[10], f[11], w, t_best)) return right;
    return skip;
}

// The steps over the rows themselves: each reads first the float4 that
// holds the row's kind and links (cherry [20:24], lookahead [12:16],
// quad [48:52]) and then only the floats its kind needs.

// The cherry table's step (_step2) over the rows themselves.
struct Cherry {
    static constexpr int kF4 = 8;   // 32 floats a row
    static __device__ __forceinline__ int step(const float4* row, const WalkRay& w,
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
    static __device__ __forceinline__ int step(const float4* row, const WalkRay& w,
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
// rows: a leaf row's four tests, empty slots too.
template <bool kLookahead>
struct Quad {
    static constexpr int kF4 = 16;   // 64 floats a row
    static __device__ __forceinline__ int step(const float4* row, const WalkRay& w,
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

constexpr int kRowThreads = 128;   // a block of the walks

// One thread a ray: the ray sorted_ray hands the thread, walked over
// the rows of layout S.
template <class S>
__global__ void __launch_bounds__(kRowThreads)
layout_walk_kernel(const float4* __restrict__ rows, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ t0,
                   const bool* __restrict__ active, float* __restrict__ t_out,
                   int* __restrict__ face_out, long long r) {
    const long long slot = (long long)blockIdx.x * kRowThreads + threadIdx.x;
    const long long i = sorted_ray<kRowThreads>(slot, rd, active, r, true);
    const bool in = i < r;
    float t_best = in ? t0[i] : 0.0f;
    int face = -1;
    int node = (in && active[i]) ? 0 : -1;
    WalkRay w{};
    if (node >= 0) w = load_walk_ray(ro, rd, i);
    while (node >= 0) node = S::step(rows + (long long)S::kF4 * node, w, t_best, face);
    if (in) {
        t_out[i] = t_best;
        face_out[i] = face;
    }
}

template <class S>
cudaError_t launch_row_walk(const float* rows, const float* ro, const float* rd,
                            const float* t0, const bool* active, float* t_out,
                            int* face_out, long long r, cudaStream_t s) {
    const unsigned grid = (unsigned)((r + kRowThreads - 1) / kRowThreads);
    layout_walk_kernel<S><<<grid, kRowThreads, 0, s>>>(reinterpret_cast<const float4*>(rows),
                                                       ro, rd, t0, active, t_out, face_out,
                                                       r);
    return cudaGetLastError();
}

template <class S>
int launch(const float* rows, const float* ro, const float* rd, const float* t0,
           const bool* active, float* t_out, int* face_out, long long r, void* stream) {
    if (r == 0) return 0;
    return (int)launch_row_walk<S>(rows, ro, rd, t0, active, t_out, face_out, r,
                                   (cudaStream_t)stream);
}

}  // namespace pr19

#define RK_LWALK_PR19(layout, S)                                                           \
    extern "C" int rk_lwalk_pr19_##layout(const float* rows, long long n_rows,             \
                                          const float* ro, const float* rd,                \
                                          const float* t0, const bool* active,             \
                                          float* t_out, int* face_out, long long r,        \
                                          void* scratch, void* stream) {                   \
        return pr19::launch<S>(rows, ro, rd, t0, active, t_out, face_out, r, stream);      \
    }                                                                                      \
    extern "C" int rk_lwalk_pr19_##layout##_info(int* info) {                              \
        return rk::walk_kernel_info(pr19::layout_walk_kernel<S>, pr19::kRowThreads, info); \
    }                                                                                      \
    extern "C" long long rk_lwalk_pr19_##layout##_scratch(long long n_rows) { return 0; }

RK_LWALK_PR19(cherry, pr19::Cherry)
RK_LWALK_PR19(lookahead, pr19::Lookahead)
RK_LWALK_PR19(quad, pr19::Quad<false>)
RK_LWALK_PR19(quad_la, pr19::Quad<true>)

namespace rk {
namespace lay {

// The designs that take a leaf row a step (kLoad 0-3: slot 0 holds the
// row's skip and count; 0 the other slots one at a time in a loop, 1 the
// loop unrolled, 2 with the count in the code all slots loaded at once,
// 3 two at a time) or share a warp's leaf slots out over its lanes (5,
// the count in the code).

// Slots [s0, s0 + kN) of a leaf row, those below count: all loads
// first, then the tests in slot order.
template <int kN>
__device__ __forceinline__ void slot_group(const float4* __restrict__ row, int s0, int count,
                                           const WalkRay& w, float t_best, float& m,
                                           int& f) {
    float4 q[3 * kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
        if (s0 + k < count) {
#pragma unroll
            for (int j = 0; j < 3; ++j) q[3 * k + j] = __ldg(row + kSlotF4 * (s0 + k) + j);
        }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k)
        if (s0 + k < count) slot_pick(q[3 * k], q[3 * k + 1], q[3 * k + 2], w, t_best, m, f);
}

// A leaf row's step over the split table: its slots below the count,
// the pick taken when strictly nearer than t_best; the code of the next
// row (its skip).
template <int kSlots, int kLoad>
__device__ __forceinline__ int slot_leaf_step(const float4* __restrict__ leaves, int c,
                                              const WalkRay& w, float& t_best, int& face) {
    const float4* row = leaves + (long long)kSlotF4 * (c & kEntryMask);
    float m = __int_as_float(0x7f800000);   // +inf: the first tested slot takes it
    int f = -1;
    int count, skip;
    if constexpr (kLoad >= 2) {
        count = (c >> kCountShift) & 7;
        skip = __float_as_int(__ldg(row + 2).z);
        if constexpr (kLoad == 2) {
            slot_group<kSlots>(row, 0, count, w, t_best, m, f);
        } else {
#pragma unroll
            for (int s = 0; s < kSlots; s += 2)
                if (s < count) slot_group<2>(row, s, count, w, t_best, m, f);
        }
    } else {
        const float4 a = __ldg(row), b = __ldg(row + 1), g = __ldg(row + 2);
        count = __float_as_int(g.w);
        skip = __float_as_int(g.z);
        if (count > 0) slot_pick(a, b, g, w, t_best, m, f);
        if constexpr (kLoad == 1) {
#pragma unroll
            for (int s = 1; s < kSlots; ++s) {
                if (s < count) {
                    const float4* q = row + kSlotF4 * s;
                    slot_pick(__ldg(q), __ldg(q + 1), __ldg(q + 2), w, t_best, m, f);
                }
            }
        } else {
#pragma unroll 1
            for (int s = 1; s < count; ++s) {
                const float4* q = row + kSlotF4 * s;
                slot_pick(__ldg(q), __ldg(q + 1), __ldg(q + 2), w, t_best, m, f);
            }
        }
    }
    if (count < kSlots && kBig < m) {   // the first empty slot's miss wins
        m = kBig;
        f = -1;
    }
    if (m < t_best) {
        t_best = m;
        face = f;
    }
    return skip;
}

// A warp's shared memory for its cooperative leaf phase: the owner lane
// of each of up to 4 x 32 slot tests, their t (BIG on a miss), faces,
// and the skip code read by each row's slot 0 test.
struct CoopShare {
    int owner[4 * 32];
    float t[4 * 32];
    int face[4 * 32];
    int skip[4 * 32];
};

// The cooperative leaf phase of a warp (every lane calls it together):
// the lanes whose code is a leaf row's own max(count, 1) slot tests,
// laid out in lane order; test j is taken by lane j % 32 on its owner's
// ray, t_best and row (shuffled from the owner), 32 at a time. Each
// owner then picks over its slots in slot order as slot_leaf_step does
// and follows its row's skip. A count of 0 tests slot 0, an empty slot
// that no ray hits: the pick is the same.
template <int kSlots>
__device__ __forceinline__ void coop_leaves(const float4* __restrict__ leaves, int& c,
                                            const WalkRay& w, float& t_best, int& face,
                                            CoopShare& sh, int lane) {
    const bool mine = c < -1;
    const int count = (c >> kCountShift) & 7;
    const int tests = mine ? (count > 0 ? count : 1) : 0;
    int incl = tests;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFullMask, incl, off);
        if (lane >= off) incl += u;
    }
    const int base = incl - tests;
    const int total = __shfl_sync(kFullMask, incl, 31);
    for (int s = 0; s < tests; ++s) sh.owner[base + s] = lane;
    __syncwarp();
    for (int b0 = 0; b0 < total; b0 += 32) {
        const int j = b0 + lane;
        const int owner = sh.owner[j < total ? j : 0];
        WalkRay o;
        o.ox = __shfl_sync(kFullMask, w.ox, owner);
        o.oy = __shfl_sync(kFullMask, w.oy, owner);
        o.oz = __shfl_sync(kFullMask, w.oz, owner);
        o.dx = __shfl_sync(kFullMask, w.dx, owner);
        o.dy = __shfl_sync(kFullMask, w.dy, owner);
        o.dz = __shfl_sync(kFullMask, w.dz, owner);
        const float tb = __shfl_sync(kFullMask, t_best, owner);
        const int oc = __shfl_sync(kFullMask, c, owner);
        const int ob = __shfl_sync(kFullMask, base, owner);
        if (j < total) {
            const int slot = j - ob;
            const float4* e = leaves + (long long)kSlotF4 * ((oc & kEntryMask) + slot);
            const float4 a = __ldg(e), b = __ldg(e + 1), g = __ldg(e + 2);
            float t;
            sh.t[j] = mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, g.x, o, tb, t) ? t : kBig;
            sh.face[j] = __float_as_int(g.y);
            if (slot == 0) sh.skip[j] = __float_as_int(g.z);
        }
    }
    __syncwarp();
    if (mine) {
        float m = __int_as_float(0x7f800000);
        int f = -1;
        for (int s = 0; s < tests; ++s) {
            const float tk = sh.t[base + s];
            if (tk < m) {
                m = tk;
                f = sh.face[base + s];
            }
        }
        if (count < kSlots && kBig < m) {
            m = kBig;
            f = -1;
        }
        if (m < t_best) {
            t_best = m;
            face = f;
        }
        c = sh.skip[base];
    }
    __syncwarp();
}

// One thread a ray: the ray sorted_ray hands the thread, walked over
// the split table of layout C a leaf row a step (kLoad 0-3), or a warp's
// leaf rows shared out over its lanes each pass (kLoad 5).
template <class C, class D>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks)
row_step_kernel(const float* __restrict__ rows, const float4* __restrict__ inner,
                const float4* __restrict__ leaves, const float* __restrict__ ro,
                const float* __restrict__ rd, const float* __restrict__ t0,
                const bool* __restrict__ active, float* __restrict__ t_out,
                int* __restrict__ face_out, long long r) {
    const long long slot = (long long)blockIdx.x * D::kThreads + threadIdx.x;
    const long long i = sorted_ray<D::kThreads>(slot, rd, active, r, true);
    const bool in = i < r;
    float t_best = in ? t0[i] : 0.0f;
    int face = -1;
    int c = -1;
    if (in && active[i]) c = slot_code<C, D>(reinterpret_cast<const int*>(rows), 0);
    WalkRay w{};
    if (c != -1) w = load_walk_ray(ro, rd, i);
    if constexpr (D::kLoad == 5) {
        __shared__ CoopShare s_coop[D::kThreads / 32];
        const int lane = threadIdx.x & 31;
        while (__any_sync(kFullMask, c != -1)) {
            if (c >= 0) c = slab_step<RowLoads>(inner, c, w, t_best);
            if (__any_sync(kFullMask, c < -1))
                coop_leaves<C::kSlots>(leaves, c, w, t_best, face, s_coop[threadIdx.x / 32],
                                       lane);
        }
    } else {
        while (c != -1)
            c = c >= 0 ? slab_step<RowLoads>(inner, c, w, t_best)
                       : slot_leaf_step<C::kSlots, D::kLoad>(leaves, c, w, t_best, face);
    }
    if (in) {
        t_out[i] = t_best;
        face_out[i] = face;
    }
}

// A design's build, then its walk.
template <class C, class D>
cudaError_t launch_design(const float* rows, long long n_rows, const float* ro,
                          const float* rd, const float* t0, const bool* active, float* t_out,
                          int* face_out, long long r, void* scratch, cudaStream_t s) {
    if constexpr (D::kStep) {
        return launch_slot_walk<C, D>(rows, n_rows, ro, rd, t0, active, t_out, face_out, r,
                                      scratch, s);
    } else {
        if (const cudaError_t e = build_slot_table<C, D>(rows, n_rows, scratch, s)) return e;
        const float4* inner = reinterpret_cast<const float4*>(scratch);
        const unsigned grid = (unsigned)((r + D::kThreads - 1) / D::kThreads);
        row_step_kernel<C, D><<<grid, D::kThreads, 0, s>>>(
            rows, inner, inner + C::kInner * n_rows, ro, rd, t0, active, t_out, face_out, r);
        return cudaGetLastError();
    }
}

template <class C, class D>
int design_info(int* info) {
    if constexpr (D::kStep)
        return walk_kernel_info(slot_walk_kernel<C, D>, D::kThreads, info);
    else
        return walk_kernel_info(row_step_kernel<C, D>, D::kThreads, info);
}

}  // namespace lay
}  // namespace rk

#define RK_LWALK_ONE(name, layout, C, ...)                                                 \
    extern "C" int rk_lwalk_##name##_##layout(const float* rows, long long n_rows,         \
                                              const float* ro, const float* rd,            \
                                              const float* t0, const bool* active,         \
                                              float* t_out, int* face_out, long long r,    \
                                              void* scratch, void* stream) {               \
        if (r == 0) return 0;                                                              \
        return (int)rk::lay::launch_design<C, rk::lay::Design<__VA_ARGS__>>(               \
            rows, n_rows, ro, rd, t0, active, t_out, face_out, r, scratch,                 \
            (cudaStream_t)stream);                                                         \
    }                                                                                      \
    extern "C" int rk_lwalk_##name##_##layout##_info(int* info) {                          \
        return rk::lay::design_info<C, rk::lay::Design<__VA_ARGS__>>(info);                \
    }                                                                                      \
    extern "C" long long rk_lwalk_##name##_##layout##_scratch(long long n_rows) {          \
        return rk::lay::slot_scratch_f4<C>(n_rows);                                        \
    }

#define RK_LWALK_DESIGN(name, ...)                                                         \
    RK_LWALK_ONE(name, cherry, rk::lay::CherryCols, __VA_ARGS__)                           \
    RK_LWALK_ONE(name, quad, rk::lay::QuadCols, __VA_ARGS__)

#define RK_LWALK_LA_DESIGN(name, ...)                                                      \
    RK_LWALK_ONE(name, lookahead, rk::lay::LookaheadCols, __VA_ARGS__)                     \
    RK_LWALK_ONE(name, quad_la, rk::lay::QuadLookaheadCols, __VA_ARGS__)

RK_LWALK_DESIGN(rolled, 128, 1, 0, 0, 0)
RK_LWALK_DESIGN(unrolled, 128, 1, 1, 0, 0)
RK_LWALK_DESIGN(code_all, 128, 1, 2, 0, 0)
RK_LWALK_DESIGN(code_pairs, 128, 1, 3, 0, 0)
RK_LWALK_DESIGN(code_all_t64, 64, 1, 2, 0, 0)
RK_LWALK_DESIGN(code_all_t256, 256, 1, 2, 0, 0)
RK_LWALK_DESIGN(code_all_mb12, 128, 12, 2, 0, 0)
RK_LWALK_DESIGN(code_pairs_mb12, 128, 12, 3, 0, 0)
RK_LWALK_DESIGN(code_pairs_mb16, 128, 16, 3, 0, 0)
RK_LWALK_DESIGN(rolled_mb12, 128, 12, 0, 0, 0)
RK_LWALK_DESIGN(rolled_t256, 256, 1, 0, 0, 0)
RK_LWALK_DESIGN(all_slots, 128, 1, 0, 1, 0)
RK_LWALK_DESIGN(code_all_slots, 128, 1, 2, 1, 0)
RK_LWALK_DESIGN(step, 128, 1, 4, 0, 0)
RK_LWALK_DESIGN(step_t64, 64, 1, 4, 0, 0)
RK_LWALK_DESIGN(step_t256, 256, 1, 4, 0, 0)
RK_LWALK_DESIGN(step_mb12, 128, 12, 4, 0, 0)
RK_LWALK_DESIGN(step_mb16, 128, 16, 4, 0, 0)
RK_LWALK_DESIGN(step_all_slots, 128, 1, 4, 1, 0)
RK_LWALK_DESIGN(coop, 128, 1, 5, 0, 0)
RK_LWALK_DESIGN(coop_mb12, 128, 12, 5, 0, 0)
RK_LWALK_DESIGN(coop_mb10, 128, 10, 5, 0, 0)
RK_LWALK_DESIGN(step_early, 128, 1, 6, 0, 0)
RK_LWALK_DESIGN(step_early_mb12, 128, 12, 6, 0, 0)

// The lookahead walks' designs (one slot a step; kLoad 6 with
// mt_hit_early; kBoth 1 loads a lookahead row's two sectors at once, 2
// takes sector B as a step of its own).
RK_LWALK_LA_DESIGN(la, 128, 1, 4, 0, 0)
RK_LWALK_LA_DESIGN(la_mb12, 128, 12, 4, 0, 0)
RK_LWALK_LA_DESIGN(la_mb16, 128, 16, 4, 0, 0)
RK_LWALK_LA_DESIGN(la_t256_mb6, 256, 6, 4, 0, 0)
RK_LWALK_LA_DESIGN(la_both, 128, 1, 4, 0, 1)
RK_LWALK_LA_DESIGN(la_both_mb12, 128, 12, 4, 0, 1)
RK_LWALK_LA_DESIGN(la_early, 128, 1, 6, 0, 0)
RK_LWALK_LA_DESIGN(la_early_mb12, 128, 12, 6, 0, 0)
RK_LWALK_LA_DESIGN(la_both_early_mb12, 128, 12, 6, 0, 1)
RK_LWALK_LA_DESIGN(la_sectors, 128, 1, 4, 0, 2)
RK_LWALK_LA_DESIGN(la_sectors_mb12, 128, 12, 4, 0, 2)
RK_LWALK_LA_DESIGN(la_sectors_mb16, 128, 16, 4, 0, 2)
RK_LWALK_LA_DESIGN(la_sectors_early_mb12, 128, 12, 6, 0, 2)
RK_LWALK_LA_DESIGN(la_sectors_mb14, 128, 14, 4, 0, 2)
RK_LWALK_LA_DESIGN(la_sectors_t256_mb6, 256, 6, 4, 0, 2)
RK_LWALK_LA_DESIGN(la_sectors_t64_mb24, 64, 24, 4, 0, 2)
