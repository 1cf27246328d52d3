// Design variants of the wide walk (rk_wide_walk in wide_walk.cu), built
// and timed only by `python -m raypt_torch.kernels.sweep --kernels wide`,
// which holds each one's t, face and overflow bitwise against the
// package kernel's. Each variant has C entry points rk_wwalk_<name> (the
// package kernel's arguments, then a scratch of rk_wwalk_<name>_scratch(r)
// bytes and the stream) and rk_wwalk_<name>_info (registers, local
// bytes, resident blocks an SM, threads a block, shared stack slots):
//   * pr16: the first kernel as it was, one thread a ray, its stack in
//     local memory, each 128-ray block's rays by octant;
//   * the others, each a designs::Design over the steps of wide_walk.cuh
//     (threads a block, shared stack slots, the launch bound's blocks an
//     SM, the step's form, the while-while threshold, persistent blocks
//     an SM, the cooperative leaf and internal thresholds, the refill
//     threshold; Design says what each does), built with a stack of 64
//     entries only (stack_d <= 64). coop_mb10 is the design the package
//     kernel writes out.
#include <climits>
#include <cuda_runtime.h>

#include "wide_walk.cuh"

namespace pr16 {

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
                wide::leaf_slot(__ldg(row + 3 * s), __ldg(row + 3 * s + 1),
                                __ldg(row + 3 * s + 2), w, t_best, face);
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

}  // namespace pr16

extern "C" int rk_wwalk_pr16(const float* rows, long long n_rows, int root, long long nw,
                             const float* ro, const float* rd, const float* t0,
                             const bool* active, float* t_out, int* face_out, bool* ovf_out,
                             long long r, int stack_d, void*, void* stream) {
    if (r < 0 || n_rows < 1 || root < 0 || root >= n_rows || nw < 0 || nw > n_rows ||
        stack_d < 1 || stack_d > 1024)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (stack_d <= 64)
        return (int)pr16::launch_walk<64>(rows, n_rows, root, nw, ro, rd, t0, active, t_out,
                                          face_out, ovf_out, r, stack_d, s);
    if (stack_d <= 256)
        return (int)pr16::launch_walk<256>(rows, n_rows, root, nw, ro, rd, t0, active, t_out,
                                           face_out, ovf_out, r, stack_d, s);
    return (int)pr16::launch_walk<1024>(rows, n_rows, root, nw, ro, rd, t0, active, t_out,
                                        face_out, ovf_out, r, stack_d, s);
}

extern "C" long long rk_wwalk_pr16_scratch(long long) { return 0; }

extern "C" int rk_wwalk_pr16_info(int* info) {
    const int e = rk::walk_kernel_info(pr16::wide_walk_kernel<64>, pr16::kThreads, info);
    info[4] = 0;
    return e;
}

namespace designs {

using wide::inf;
using wide::kLeafK;
using wide::kRowF4;
using wide::LeafShare;
using wide::row_of;
using wide::slab;
using wide::Walker;

// A design of the walk:
//   kThreads, threads a block, whose rays the block hands out by
//     direction octant (rk::sorted_ray);
//   kShared, the stack slots 0 .. kShared - 1 kept in shared memory, one
//     column a thread (slot k of thread t at k * kThreads + t, so a
//     warp's lanes never share a bank whatever their depths); deeper
//     slots, which the rays of a shallow tree never touch, in a local
//     array (0: the whole stack local, as the package kernel keeps it);
//   kMinBlocks, the launch bound's resident blocks an SM (a register
//     budget);
//   kLean: 0, an internal row's six box float4 loaded into one array and
//     the sort's exchanges as branches (the first kernel's form); 1, each
//     entry's slab test on its own float4 pair as they load, the
//     exchanges as selects (wide::entries, wide::sort4); 2, that and a
//     leaf slot skipped whose e1 is zero (an empty or invalid slot: its
//     det is 0 or NaN, so it can never hit); 3, the row's seven float4
//     loaded first and the four slab tests run whether or not their
//     entry is present (no branch a test, so the loads overlap), the
//     pushes as predicated stores;
//   kBatch, the while-while threshold: 0 lets each lane step its own
//     row's kind; k > 0 gives a warp step to one kind, the internal rows
//     while k or more lanes sit on one or no lane sits at a leaf, else
//     the leaves (each ray still takes its own steps in its own order);
//   kPersist, 0 for a block of rays a thread each; n > 0 launches n
//     blocks an SM (at most the resident ones) whose warps take 32 rays
//     at a time from a counter, in the order a first pass writes: the
//     octant order rk::sorted_ray gives kThreads-ray blocks;
//   kCoop, 0 for each lane testing its own leaf row's four triangles;
//     c > 0 for a warp that shares them out ("cooperative leaves"): each
//     pass, the lanes on internal rows take their step, then, once c
//     lanes or more sit at a leaf row (or no lane sits on an internal
//     one), all 32 lanes test the four slots of every leaf lane's row,
//     one slot a lane (32 slots a round), and each leaf lane takes its
//     slots' hits in slot order (wide::leaf_phase);
//   kInner (with kCoop), 0 for each lane visiting its own internal row;
//     n > 0 shares the internal rows' entries out the same way in a pass
//     where at most n lanes sit on one (inner_phase): their 4 entries
//     each are slab-tested by the 32 lanes, one entry a lane, and each
//     owner sorts its four and pushes;
//   kRefill (with kPersist and kCoop), 0 for a warp that takes its next
//     32 rays once all its lanes are done; n > 0 for one that refills
//     its idle lanes with the next rays of the order once n of them are
//     idle, each ray's result stored when its walk ends.
template <int kThreads_, int kShared_, int kMinBlocks_, int kLean_, int kBatch_,
          int kPersist_, int kCoop_ = 0, int kInner_ = 0, int kRefill_ = 0>
struct Design {
    static constexpr int kThreads = kThreads_, kShared = kShared_,
                         kMinBlocks = kMinBlocks_, kLean = kLean_, kBatch = kBatch_,
                         kPersist = kPersist_, kCoop = kCoop_, kInner = kInner_,
                         kRefill = kRefill_;
    static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, one block");
    static_assert(kShared >= 0 && kShared * kThreads * 4 <= 40 * 1024,
                  "the shared stack is static shared memory");
    static_assert(kLean >= 0 && kLean <= 3 && kBatch >= 0 && kBatch <= 32 &&
                      kPersist >= 0 && kCoop >= 0 && kCoop <= 32,
                  "a design's settings");
    static_assert(!(kCoop && kBatch), "one warp schedule");
    static_assert(kInner >= 0 && kInner <= 32 && (kCoop || !kInner),
                  "shared internal rows come with shared leaves");
    static_assert(kRefill >= 0 && kRefill <= 32 && (!kRefill || (kPersist && kCoop)),
                  "refilled lanes come with persistent warps and shared leaves");
};

// The four entries of an internal row in design D's form: distances
// (inf where missed or absent) and child row ids.
template <class D>
__device__ __forceinline__ void entries(const float4* row, const rk::WalkRay& w,
                                        float t_best, float (&tn)[4], int (&id)[4]) {
    if constexpr (D::kLean == 1 || D::kLean == 2) {
        wide::entries(row, w, t_best, tn, id);
    } else {
        const float4 ids = __ldg(row + 6);
        id[0] = __float_as_int(ids.x);
        id[1] = __float_as_int(ids.y);
        id[2] = __float_as_int(ids.z);
        id[3] = __float_as_int(ids.w);
        if constexpr (D::kLean == 0) {
            float b[24];
#pragma unroll
            for (int q = 0; q < 6; ++q) {
                const float4 v = __ldg(row + q);
                b[4 * q] = v.x;
                b[4 * q + 1] = v.y;
                b[4 * q + 2] = v.z;
                b[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tn[e] = id[e] >= 0 ? slab(b[6 * e], b[6 * e + 1], b[6 * e + 2], b[6 * e + 3],
                                          b[6 * e + 4], b[6 * e + 5], w, t_best)
                                   : inf();
        } else if constexpr (D::kLean == 3) {
            const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2),
                         q3 = __ldg(row + 3), q4 = __ldg(row + 4), q5 = __ldg(row + 5);
            const float d0 = slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, w, t_best);
            const float d1 = slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, w, t_best);
            const float d2 = slab(q3.x, q3.y, q3.z, q3.w, q4.x, q4.y, w, t_best);
            const float d3 = slab(q4.z, q4.w, q5.x, q5.y, q5.z, q5.w, w, t_best);
            tn[0] = id[0] >= 0 ? d0 : inf();
            tn[1] = id[1] >= 0 ? d1 : inf();
            tn[2] = id[2] >= 0 ? d2 : inf();
            tn[3] = id[3] >= 0 ? d3 : inf();
        }
    }
}

// One exchange of the sort as a branch: swap on strict >.
__device__ __forceinline__ void exchange_branch(float& ta, float& tb, int& ia, int& ib) {
    if (ta > tb) {
        const float tt = ta;
        ta = tb;
        tb = tt;
        const int ii = ia;
        ia = ib;
        ib = ii;
    }
}

// An internal row's visit after its entries' slab tests, in design D's
// form (wide::order_and_push's sort, pushes and descent).
template <class D, class S>
__device__ __forceinline__ void order_and_push(float (&tn)[4], int (&id)[4], Walker& k,
                                               S& st, int stack_d) {
    if constexpr (D::kLean == 1 || D::kLean == 2) {
        wide::order_and_push(tn, id, k, st, stack_d);
    } else if constexpr (D::kLean == 3) {
        wide::sort4(tn, id);
#pragma unroll
        for (int e = 3; e >= 1; --e) {
            const bool hit = tn[e] < inf(), fits = k.sp < stack_d;
            if (hit && fits) st.put(k.sp, id[e]);
            k.ovf |= (int)(hit && !fits);
            k.sp += (int)hit;
        }
        wide::descend(tn, id, k, st, stack_d);
    } else {
        exchange_branch(tn[0], tn[1], id[0], id[1]);
        exchange_branch(tn[2], tn[3], id[2], id[3]);
        exchange_branch(tn[0], tn[2], id[0], id[2]);
        exchange_branch(tn[1], tn[3], id[1], id[3]);
        exchange_branch(tn[1], tn[2], id[1], id[2]);
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
        wide::descend(tn, id, k, st, stack_d);
    }
}

template <class D>
__device__ __forceinline__ void leaf_row(const float4* row, const rk::WalkRay& w,
                                         float& t_best, int& face) {
#pragma unroll
    for (int s = 0; s < kLeafK; ++s) {
        const float4 a = __ldg(row + 3 * s), b = __ldg(row + 3 * s + 1);
        if constexpr (D::kLean == 2) {
            if (a.w == 0.0f && b.x == 0.0f && b.y == 0.0f) continue;
        }
        wide::leaf_slot(a, b, __ldg(row + 3 * s + 2), w, t_best, face);
    }
}

// A thread's stack of kCap entries: slots below kShared in its column of
// the block's shared array, the rest in a local array.
template <int kThreads, int kShared, int kCap>
struct Stack {
    static constexpr int kLocal = kCap > kShared ? kCap - kShared : 1;
    int* col;
    int local[kLocal];
    __device__ __forceinline__ explicit Stack(int* c) : col(c) {}
    __device__ __forceinline__ void put(int k, int v) {
        if constexpr (kShared >= kCap) {
            col[k * kThreads] = v;
        } else if constexpr (kShared > 0) {
            if (k < kShared)
                col[k * kThreads] = v;
            else
                local[k - kShared] = v;
        } else {
            local[k] = v;
        }
    }
    __device__ __forceinline__ int get(int k) const {
        if constexpr (kShared >= kCap) {
            return col[k * kThreads];
        } else if constexpr (kShared > 0) {
            return k < kShared ? col[k * kThreads] : local[k - kShared];
        } else {
            return local[k];
        }
    }
};

// A walker's visit of an internal row.
template <class D, class S>
__device__ __forceinline__ void internal_visit(const float4* row, const rk::WalkRay& w,
                                               Walker& k, S& st, int stack_d) {
    float tn[4];
    int id[4];
    entries<D>(row, w, k.t_best, tn, id);
    order_and_push<D>(tn, id, k, st, stack_d);
}

// One step of a walker (node >= 0): its leaf row's tests and a pop, or
// its internal row's visit.
template <class D, class S>
__device__ __forceinline__ void step(const float4* __restrict__ rows, int n_rows,
                                     int nw, const rk::WalkRay& w, Walker& k, S& st,
                                     int stack_d) {
    const float4* row = row_of(rows, n_rows, k.node);
    if (k.node >= nw) {
        leaf_row<D>(row, w, k.t_best, k.face);
        wide::pop(k, st, stack_d);
    } else {
        internal_visit<D>(row, w, k, st, stack_d);
    }
}

// The cooperative internal phase of a warp (every lane calls it
// together): the lanes of `mi` sit on internal rows; their 4 * popc(mi)
// entries are slab-tested 32 at a time, entry j by lane j % 32 on its
// owner's ray, t_best and row (shuffled from the owner; the box read as
// three float2), then each owner sorts its four entries and pushes, as
// internal_visit does.
template <class D, class S>
__device__ __forceinline__ void inner_phase(unsigned mi, const float4* __restrict__ rows,
                                            int n_rows, const rk::WalkRay& w,
                                            Walker& k, S& st, int stack_d, LeafShare& sh,
                                            int lane) {
    const bool mine = (mi >> lane) & 1u;
    const int rank = __popc(mi & ((1u << lane) - 1u));
    if (mine) sh.owner[rank] = lane;
    __syncwarp();
    const int tests = 4 * __popc(mi);
    for (int base = 0; base < tests; base += 32) {
        const int j = base + lane;
        const int owner = sh.owner[(j < tests ? j : 0) >> 2];
        rk::WalkRay v;
        v.ox = __shfl_sync(rk::kFullMask, w.ox, owner);
        v.oy = __shfl_sync(rk::kFullMask, w.oy, owner);
        v.oz = __shfl_sync(rk::kFullMask, w.oz, owner);
        v.ix = __shfl_sync(rk::kFullMask, w.ix, owner);
        v.iy = __shfl_sync(rk::kFullMask, w.iy, owner);
        v.iz = __shfl_sync(rk::kFullMask, w.iz, owner);
        const float tb = __shfl_sync(rk::kFullMask, k.t_best, owner);
        const int node = __shfl_sync(rk::kFullMask, k.node, owner);
        if (j < tests) {
            const float* f = reinterpret_cast<const float*>(row_of(rows, n_rows, node));
            const int e = j & 3;
            const int id = __float_as_int(__ldg(f + 24 + e));
            const float2 p = __ldg(reinterpret_cast<const float2*>(f + 6 * e)),
                         q = __ldg(reinterpret_cast<const float2*>(f + 6 * e + 2)),
                         r = __ldg(reinterpret_cast<const float2*>(f + 6 * e + 4));
            sh.t[j] = id >= 0 ? slab(p.x, p.y, q.x, q.y, r.x, r.y, v, tb) : inf();
            sh.face[j] = id;
        }
    }
    __syncwarp();
    if (mine) {
        float tn[4];
        int id[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            tn[e] = sh.t[4 * rank + e];
            id[e] = sh.face[4 * rank + e];
        }
        order_and_push<D>(tn, id, k, st, stack_d);
    }
    __syncwarp();
}

// One pass of the cooperative schedule (every lane calls it together):
// the internal rows' visits (each lane its own, or inner_phase), then,
// as kCoop asks, the leaf phase. False when no lane is left walking.
template <class D, class S>
__device__ __forceinline__ bool coop_pass(const float4* __restrict__ rows, int n_rows,
                                          int nw, const rk::WalkRay& w, Walker& k,
                                          S& st, int stack_d, LeafShare& sh, int lane) {
    const bool on_inner = k.node >= 0 && k.node < nw;
    if constexpr (D::kInner > 0) {
        const unsigned mi = __ballot_sync(rk::kFullMask, on_inner);
        if (mi && __popc(mi) <= D::kInner)
            inner_phase<D>(mi, rows, n_rows, w, k, st, stack_d, sh, lane);
        else if (on_inner)
            internal_visit<D>(row_of(rows, n_rows, k.node), w, k, st, stack_d);
    } else if (on_inner) {
        internal_visit<D>(row_of(rows, n_rows, k.node), w, k, st, stack_d);
    }
    const unsigned ml = __ballot_sync(rk::kFullMask, k.node >= 0 && k.node >= nw);
    const unsigned mi = __ballot_sync(rk::kFullMask, k.node >= 0 && k.node < nw);
    if ((ml | mi) == 0) return false;
    if (ml && (mi == 0 || __popc(ml) >= D::kCoop))
        wide::leaf_phase(ml, rows, n_rows, w, k, st, stack_d, sh, lane);
    return true;
}

// The walk of ray i (none for i >= r; every lane of a warp calls it
// together) and its result's store. A dead ray writes t0 + rd.x * 0, -1
// and false.
template <class D, class S>
__device__ __forceinline__ void walk_ray(long long i, const float4* __restrict__ rows,
                                         int n_rows, int root, int nw,
                                         const float* __restrict__ ro,
                                         const float* __restrict__ rd,
                                         const float* __restrict__ t0,
                                         const bool* __restrict__ active,
                                         float* __restrict__ t_out, int* __restrict__ face_out,
                                         bool* __restrict__ ovf_out, long long r, int stack_d,
                                         S& st, LeafShare& sh) {
    const bool in = i < r;
    rk::WalkRay w{};
    Walker k{0.0f, -1, 0, -1, 0};
    if (in) k = wide::start(i, root, ro, rd, t0, active, w);
    if constexpr (D::kCoop > 0) {
        const int lane = threadIdx.x & 31;
        while (coop_pass<D>(rows, n_rows, nw, w, k, st, stack_d, sh, lane)) {
        }
    } else if constexpr (D::kBatch == 0) {
        while (k.node >= 0) step<D>(rows, n_rows, nw, w, k, st, stack_d);
    } else {
        for (;;) {
            const bool on_leaf = k.node >= 0 && k.node >= nw;
            const bool on_inner = k.node >= 0 && !on_leaf;
            const unsigned mi = __ballot_sync(rk::kFullMask, on_inner);
            const unsigned ml = __ballot_sync(rk::kFullMask, on_leaf);
            if ((mi | ml) == 0) break;
            const bool inner_turn = ml == 0 || __popc(mi) >= D::kBatch;
            if (inner_turn ? on_inner : on_leaf) step<D>(rows, n_rows, nw, w, k, st, stack_d);
        }
    }
    if (in) {
        t_out[i] = k.t_best;
        face_out[i] = k.face;
        ovf_out[i] = k.ovf != 0;
    }
}

// A persistent warp with refilled lanes (kRefill): whenever kRefill of
// its lanes (or all) hold no ray, it takes as many slots of `perm` from
// the counter `next`, consecutive slots to consecutive idle lanes; a
// dead ray's result is stored at once, a live one's when its walk ends.
template <class D, class S>
__device__ __forceinline__ void refill_walk(const float4* __restrict__ rows, int n_rows,
                                            int root, int nw,
                                            const float* __restrict__ ro,
                                            const float* __restrict__ rd,
                                            const float* __restrict__ t0,
                                            const bool* __restrict__ active,
                                            float* __restrict__ t_out,
                                            int* __restrict__ face_out,
                                            bool* __restrict__ ovf_out, long long r,
                                            int stack_d, const int* __restrict__ perm,
                                            long long slots,
                                            unsigned long long* __restrict__ next, S& st,
                                            LeafShare& sh) {
    const int lane = threadIdx.x & 31;
    long long i = -1;   // the lane's ray while it walks
    rk::WalkRay w{};
    Walker k{0.0f, -1, 0, -1, 0};
    bool exhausted = false;
    for (;;) {
        const unsigned idle = __ballot_sync(rk::kFullMask, i < 0);
        if (!exhausted && (idle == rk::kFullMask || __popc(idle) >= D::kRefill)) {
            const int n = __popc(idle);
            unsigned long long base = 0;
            if (lane == 0) base = atomicAdd(next, (unsigned long long)n);
            base = __shfl_sync(rk::kFullMask, base, 0);
            exhausted = base + n >= (unsigned long long)slots;
            const unsigned long long j = base + __popc(idle & ((1u << lane) - 1u));
            if (i < 0 && j < (unsigned long long)slots && perm[j] < r) {
                const long long ray = perm[j];
                k = wide::start(ray, root, ro, rd, t0, active, w);
                if (k.node >= 0) {
                    i = ray;
                } else {
                    t_out[ray] = k.t_best;
                    face_out[ray] = k.face;
                    ovf_out[ray] = k.ovf != 0;
                }
            }
        }
        const bool walking = coop_pass<D>(rows, n_rows, nw, w, k, st, stack_d, sh, lane);
        if (i >= 0 && k.node < 0) {
            t_out[i] = k.t_best;
            face_out[i] = k.face;
            ovf_out[i] = k.ovf != 0;
            i = -1;
        }
        if (!walking && exhausted) break;
    }
}

// The walk kernel of design D with a stack of kCap entries: a block of
// rays handed out by octant, or (kPersist) warps taking 32 slots of
// `perm` at a time from the counter `next`, or refilling their lanes
// (kRefill).
template <class D, int kCap>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks)
walk_kernel(const float4* __restrict__ rows, int n_rows, int root, int nw,
            const float* __restrict__ ro, const float* __restrict__ rd,
            const float* __restrict__ t0, const bool* __restrict__ active,
            float* __restrict__ t_out, int* __restrict__ face_out, bool* __restrict__ ovf_out,
            long long r, int stack_d, const int* __restrict__ perm, long long slots,
            unsigned long long* __restrict__ next) {
    __shared__ int s_stack[D::kShared > 0 ? D::kShared * D::kThreads : 1];
    __shared__ LeafShare s_leaf[D::kCoop > 0 ? D::kThreads / 32 : 1];
    Stack<D::kThreads, D::kShared, kCap> st(s_stack + threadIdx.x);
    LeafShare& sh = s_leaf[D::kCoop > 0 ? threadIdx.x / 32 : 0];
    if constexpr (D::kRefill > 0) {
        refill_walk<D>(rows, n_rows, root, nw, ro, rd, t0, active, t_out, face_out, ovf_out,
                       r, stack_d, perm, slots, next, st, sh);
    } else if constexpr (D::kPersist == 0) {
        const long long slot = (long long)blockIdx.x * D::kThreads + threadIdx.x;
        walk_ray<D>(rk::sorted_ray<D::kThreads>(slot, rd, active, r, true), rows, n_rows,
                    root, nw, ro, rd, t0, active, t_out, face_out, ovf_out, r, stack_d, st,
                    sh);
    } else {
        const int lane = threadIdx.x & 31;
        for (;;) {
            unsigned long long base = 0;
            if (lane == 0) base = atomicAdd(next, 32ull);
            base = __shfl_sync(rk::kFullMask, base, 0);
            if (base >= (unsigned long long)slots) break;
            walk_ray<D>(perm[base + lane], rows, n_rows, root, nw, ro, rd, t0, active, t_out,
                        face_out, ovf_out, r, stack_d, st, sh);
        }
    }
}

// The persistent walk's order: slot s of each kThreads block holds the
// ray rk::sorted_ray hands that thread (r for a slot past the end).
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
octant_perm_kernel(const float* __restrict__ rd, const bool* __restrict__ active, long long r,
                   int* __restrict__ perm) {
    const long long slot = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long i = rk::sorted_ray<kThreads>(slot, rd, active, r, true);
    perm[slot] = (int)(i < r ? i : r);
}

// The scratch of design D's launch, in bytes: none, or (kPersist) the
// counter and the order of the padded wavefront's slots.
template <class D>
long long scratch_bytes(long long r) {
    if (D::kPersist == 0) return 0;
    return 8 + 4 * ((r + D::kThreads - 1) / D::kThreads * D::kThreads);
}

// Design D's walk with a stack of 64 entries (stack_d <= 64).
template <class D>
int launch(const float* rows, long long n_rows, int root, long long nw, const float* ro,
           const float* rd, const float* t0, const bool* active, float* t_out, int* face_out,
           bool* ovf_out, long long r, int stack_d, void* scratch, void* stream) {
    if (r < 0 || n_rows < 1 || n_rows >= INT_MAX || root < 0 || root >= n_rows || nw < 0 ||
        nw > n_rows || stack_d < 1 || stack_d > 64 || r >= INT_MAX ||
        (D::kPersist && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const auto* rows4 = reinterpret_cast<const float4*>(rows);
    const long long blocks = (r + D::kThreads - 1) / D::kThreads;
    if constexpr (D::kPersist == 0) {
        walk_kernel<D, 64><<<(unsigned)blocks, D::kThreads, 0, s>>>(
            rows4, (int)n_rows, root, (int)nw, ro, rd, t0, active, t_out, face_out, ovf_out, r,
            stack_d, nullptr, 0, nullptr);
    } else {
        auto* next = reinterpret_cast<unsigned long long*>(scratch);
        int* perm = reinterpret_cast<int*>(next + 1);
        static int per_sm = 0, sms = 0;
        if (per_sm == 0) {
            int dev = 0;
            if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
            if (const cudaError_t e =
                    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
                return (int)e;
            if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, walk_kernel<D, 64>, D::kThreads, 0))
                return (int)e;
            per_sm = per_sm > 0 ? per_sm : 1;
        }
        if (const cudaError_t e = cudaMemsetAsync(next, 0, sizeof(*next), s)) return (int)e;
        octant_perm_kernel<D::kThreads><<<(unsigned)blocks, D::kThreads, 0, s>>>(
            rd, active, r, perm);
        const int want = D::kPersist < per_sm ? D::kPersist : per_sm;
        walk_kernel<D, 64><<<(unsigned)(sms * want), D::kThreads, 0, s>>>(
            rows4, (int)n_rows, root, (int)nw, ro, rd, t0, active, t_out, face_out, ovf_out, r,
            stack_d, perm, blocks * D::kThreads, next);
    }
    return (int)cudaGetLastError();
}

// The kernel's registers, local (spill and stack) bytes, resident blocks
// an SM and threads a block, and the design's shared stack slots
// (info[0..4]).
template <class D>
int design_info(int* info) {
    const int e = rk::walk_kernel_info(walk_kernel<D, 64>, D::kThreads, info);
    info[4] = D::kShared;
    return e;
}

}  // namespace designs

#define RK_WWALK_DESIGN(name, ...)                                                     \
    extern "C" int rk_wwalk_##name(const float* rows, long long n_rows, int root,        \
                                   long long nw, const float* ro, const float* rd,      \
                                   const float* t0, const bool* active, float* t_out,   \
                                   int* face_out, bool* ovf_out, long long r,           \
                                   int stack_d, void* scratch, void* stream) {          \
        return designs::launch<designs::Design<__VA_ARGS__>>(                          \
            rows, n_rows, root, nw, ro, rd, t0, active, t_out, face_out, ovf_out, r,    \
            stack_d, scratch, stream);                                                  \
    }                                                                                   \
    extern "C" long long rk_wwalk_##name##_scratch(long long r) {                       \
        return designs::scratch_bytes<designs::Design<__VA_ARGS__>>(r);                 \
    }                                                                                   \
    extern "C" int rk_wwalk_##name##_info(int* info) {                                  \
        return designs::design_info<designs::Design<__VA_ARGS__>>(info);                \
    }

// name, then designs::Design's threads, shared stack slots, kMinBlocks,
// kLean, kBatch, kPersist, kCoop, kInner, kRefill
RK_WWALK_DESIGN(local, 128, 0, 1, 0, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_t128, 128, 0, 1, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(skip, 128, 0, 1, 2, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(smem8, 128, 8, 1, 0, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(smem16, 128, 16, 1, 0, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(smem32, 128, 32, 1, 0, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem8, 128, 8, 1, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16, 128, 16, 1, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem32, 128, 32, 1, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem64, 128, 64, 1, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(skip_smem16, 128, 16, 1, 2, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_mb12, 128, 0, 12, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_mb10, 128, 16, 10, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_mb12, 128, 16, 12, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_ww1, 128, 16, 1, 1, 1, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_ww16, 128, 16, 1, 1, 16, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_ww32, 128, 16, 1, 1, 32, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_persist, 128, 0, 1, 1, 0, 16, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_persist, 128, 16, 1, 1, 0, 16, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_ww16_persist, 128, 16, 1, 1, 16, 16, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem16_t256, 256, 16, 1, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(lean_smem8_t64, 64, 8, 1, 1, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(coop, 128, 0, 1, 1, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_mb12, 128, 0, 12, 1, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop4_mb12, 128, 0, 12, 1, 0, 0, 4, 0, 0)
RK_WWALK_DESIGN(coop8_mb12, 128, 0, 12, 1, 0, 0, 8, 0, 0)
RK_WWALK_DESIGN(coop_mb10, 128, 0, 10, 1, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_mb16, 128, 0, 16, 1, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_mb12_persist, 128, 0, 12, 1, 0, 16, 1, 0, 0)
RK_WWALK_DESIGN(coop_smem8_mb12, 128, 8, 12, 1, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_t256_mb6, 256, 0, 6, 1, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_local_mb12, 128, 0, 12, 0, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_in4_mb10, 128, 0, 10, 1, 0, 0, 1, 4, 0)
RK_WWALK_DESIGN(coop_in8_mb10, 128, 0, 10, 1, 0, 0, 1, 8, 0)
RK_WWALK_DESIGN(coop_in12_mb10, 128, 0, 10, 1, 0, 0, 1, 12, 0)
RK_WWALK_DESIGN(coop_in16_mb10, 128, 0, 10, 1, 0, 0, 1, 16, 0)
RK_WWALK_DESIGN(coop_in8, 128, 0, 1, 1, 0, 0, 1, 8, 0)
RK_WWALK_DESIGN(coop_mb9, 128, 0, 9, 1, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_mb10_persist, 128, 0, 10, 1, 0, 16, 1, 0, 0)
RK_WWALK_DESIGN(coop_mb10_refill8, 128, 0, 10, 1, 0, 16, 1, 0, 8)
RK_WWALK_DESIGN(coop_mb10_refill16, 128, 0, 10, 1, 0, 16, 1, 0, 16)
RK_WWALK_DESIGN(coop_mb10_refill24, 128, 0, 10, 1, 0, 16, 1, 0, 24)
RK_WWALK_DESIGN(tight_t128, 128, 0, 1, 3, 0, 0, 0, 0, 0)
RK_WWALK_DESIGN(coop_tight, 128, 0, 1, 3, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_tight_mb10, 128, 0, 10, 3, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop_tight_mb12, 128, 0, 12, 3, 0, 0, 1, 0, 0)
RK_WWALK_DESIGN(coop2_mb10, 128, 0, 10, 1, 0, 0, 2, 0, 0)
RK_WWALK_DESIGN(coop4_mb10, 128, 0, 10, 1, 0, 0, 4, 0, 0)
