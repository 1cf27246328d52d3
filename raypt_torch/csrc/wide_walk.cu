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
// What bounds it: the instructions its warps issue, not bytes. The rows
// (112 bytes an internal visit, 192 a leaf visit) come from L2 at under
// 5 TB/s, and a shared-memory stack, more resident warps, persistent
// warps and while-while schedules each moved the time by a few percent
// at most (PERF.md, the design sweep of wide_walk_designs.cu: `python -m
// raypt_torch.kernels.sweep --kernels wide`). A warp issues an internal
// row's four slab tests, sort and pushes (some 185 instructions) for
// each pass in which one of its lanes sits on an internal row, and a
// leaf row's four triangle tests (some 260) for each pass in which one
// sits at a leaf: a sixth of the visits are leaf visits, but on the
// secondary bounces 60-75% of a warp's passes hold both kinds, so the
// leaf tests ran in most passes for a few lanes.
//
// The design ("coop_mb10" of the sweep, written out here over the steps
// of wide_walk.cuh): one thread walks one ray, each 128-ray
// block's rays handed to its threads by direction octant (packed_walk.cuh:
// sorted_ray), each entry's slab test on its own float4 pair and the
// sort's exchanges as selects. Each pass, the lanes on internal rows
// visit them; then the warp shares out the leaf tests ("cooperative
// leaves", wide::leaf_phase): the 4 slots of every lane that sits at a
// leaf row are tested by the 32 lanes, one slot a lane, on the owner's
// ray and row fetched by shuffles, and each owner takes its slots' hits
// in slot order (each when strictly nearer than its t_best, as the plain
// walk takes them) and pops. So a pass runs the triangle test once for
// up to eight leaf rows; each ray still visits its rows in its own order.
// The launch bound asks for 10 blocks an SM (47 registers). The stack, a
// compile-time capacity of 64, 256 or 1,024 entries (the smallest that
// holds stack_d), stays in local memory: rays of these trees stack at
// most 15 entries, and keeping its first slots in shared memory took L1
// from the rows and was slower.
#include <climits>
#include <cuda_runtime.h>

#include "wide_walk.cuh"

namespace {

constexpr int kThreads = 128;    // a block's rays, handed out by octant
constexpr int kMinBlocks = 10;   // the launch bound's resident blocks an SM

// One pass of a warp (every lane calls it together): each lane on an
// internal row visits it; then, if any lane sits at a leaf row, the warp
// shares out the leaf tests (wide::leaf_phase). False when no lane is
// left walking.
template <int kCap>
__device__ __forceinline__ bool pass(const float4* __restrict__ rows, int n_rows, int nw,
                                     const rk::WalkRay& w, wide::Walker& k,
                                     wide::LocalStack<kCap>& st, int stack_d,
                                     wide::LeafShare& sh, int lane) {
    if (k.node >= 0 && k.node < nw) {
        float tn[4];
        int id[4];
        wide::entries(wide::row_of(rows, n_rows, k.node), w, k.t_best, tn, id);
        wide::order_and_push(tn, id, k, st, stack_d);
    }
    const unsigned ml = __ballot_sync(rk::kFullMask, k.node >= 0 && k.node >= nw);
    const unsigned mi = __ballot_sync(rk::kFullMask, k.node >= 0 && k.node < nw);
    if ((ml | mi) == 0) return false;
    if (ml) wide::leaf_phase(ml, rows, n_rows, w, k, st, stack_d, sh, lane);
    return true;
}

// One thread a ray, with a stack of kCap entries: the ray rk::sorted_ray
// hands the thread (none past the wavefront's end: the lane still takes
// part in its warp's passes), walked until no lane of the warp walks,
// and its result's store.
template <int kCap>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
wide_walk_kernel(const float4* __restrict__ rows, int n_rows, int root, int nw,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t0, const bool* __restrict__ active,
                 float* __restrict__ t_out, int* __restrict__ face_out,
                 bool* __restrict__ ovf_out, long long r, int stack_d) {
    __shared__ wide::LeafShare s_leaf[kThreads / 32];
    const long long slot = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long i = rk::sorted_ray<kThreads>(slot, rd, active, r, true);
    const bool in = i < r;
    rk::WalkRay w{};
    wide::Walker k{0.0f, -1, 0, -1, 0};
    if (in) k = wide::start(i, root, ro, rd, t0, active, w);
    wide::LocalStack<kCap> st;
    const int lane = threadIdx.x & 31;
    while (pass<kCap>(rows, n_rows, nw, w, k, st, stack_d, s_leaf[threadIdx.x / 32], lane)) {
    }
    if (in) {
        t_out[i] = k.t_best;
        face_out[i] = k.face;
        ovf_out[i] = k.ovf != 0;
    }
}

template <int kCap>
cudaError_t launch_walk(const float* rows, long long n_rows, int root, long long nw,
                        const float* ro, const float* rd, const float* t0,
                        const bool* active, float* t_out, int* face_out, bool* ovf_out,
                        long long r, int stack_d, cudaStream_t s) {
    const unsigned grid = (unsigned)((r + kThreads - 1) / kThreads);
    wide_walk_kernel<kCap><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(rows), (int)n_rows, root, (int)nw, ro, rd, t0, active,
        t_out, face_out, ovf_out, r, stack_d);
    return cudaGetLastError();
}

}  // namespace

// The largest stack_d the kernel takes.
extern "C" int rk_wide_walk_max_stack() { return 1024; }

// rows (n_rows, 64) f32, 16-byte aligned; 0 <= root < n_rows < 2^31 - 1,
// nw <= n_rows, 1 <= stack_d <= rk_wide_walk_max_stack(), r < 2^31 - 1.
extern "C" int rk_wide_walk(const float* rows, long long n_rows, int root, long long nw,
                            const float* ro, const float* rd, const float* t0,
                            const bool* active, float* t_out, int* face_out, bool* ovf_out,
                            long long r, int stack_d, void* stream) {
    if (r < 0 || r >= INT_MAX || n_rows < 1 || n_rows >= INT_MAX || root < 0 ||
        root >= n_rows || nw < 0 || nw > n_rows || stack_d < 1 ||
        stack_d > rk_wide_walk_max_stack())
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
