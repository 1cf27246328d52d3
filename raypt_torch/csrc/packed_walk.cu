// Skip-link walk of the packed LBVH table, for Hopper (sm_90a).
//
// Replaces an XLA loop, not a Pallas kernel: raypt/accel/packed.py:
// traverse_wavefront (:85-166), the `lax.while_loop` behind the `bvh`
// and `bvh2` backends. Contract: each live ray starts at node 0 with
// t_best = t0 and face -1 and, until its node is -1, reads its node's
// 64-byte row [bmin | bmax | - | left, skip, 0] or
// [p0 | e1 | e2 | face, skip, 1]; an internal row's slab test sends it to
// the left child on a hit and to the skip link otherwise, a leaf row's
// Moller-Trumbore test replaces (t_best, face) when t is strictly
// smaller, then the ray follows the skip link. A dead ray keeps t0 and
// face -1 and reads nothing. max_steps >= 0 cuts a walk after that many
// steps (the JAX loop's max_iters * unroll); -1 walks to the end.
//
// Every operation is the plain torch version's (raypt_torch/accel/
// packed.py: traverse_wavefront), in its order: the reciprocal
// direction with components below 1e-12 clamped, the slab's
// subtractions and products, min / max that propagate NaN (min.NaN /
// max.NaN, one instruction each), the cross products ay*bz - az*by, the
// three-term sums (x + y) + z and 1 / det as the correctly rounded
// reciprocal (cluster_test.cuh's fast path, exact where |det| >= 2^126).
// Built with -fmad=false, it is bitwise equal to the plain version.
//
// What bounds it on this card, as measured (python -m
// raypt_torch.kernels.sweep --kernels packed, NVIDIA H100 80GB HBM3,
// 700 W, 1980 MHz): bytes into the SMs, not instructions or latency.
// The first kernel (pr12) read every visit's whole 64-byte row (two L2 sectors)
// and walked 2.89 ms a bvh frame; cutting its instructions a step from
// 144 to 117 (one-instruction min / max, the fast reciprocal, no step
// counter) saved 6%, all of it on the coherent bounce 0, while halving
// the bytes of an internal step saved 39%, most on the secondary
// bounces. More resident warps (64 an SM at 32 registers) were slower,
// fewer too; while-while schedules and refilled warps, which raise the
// SIMD efficiency of the walks, were slower; evict-last and no-allocate
// L1 hints gained nothing or lost; rays sorted by origin and octant over
// the whole wavefront walked 15% faster, but the sort cost more than
// that.
//
// What the design does about it (packed_walk.cuh): the walk reads a
// table derived from the rows on every call, 32-byte internal rows (one
// sector) and 48-byte leaf rows, whose links carry the kind of the row
// they point at, so a step reads only its own kind's bytes; one thread
// walks one ray, and a block of 128 hands its rays to its threads by
// direction octant, live rays first, so a warp's rays start from
// neighbouring pixels in one octant and the dead rays' warps end at
// once. The build of the table is a launch of its own, counted in the
// walk's time.
#include <cuda_runtime.h>

#include "packed_walk.cuh"

namespace {

constexpr int kThreads = 128;   // a block's rays, handed out by octant

// One thread a ray: the ray rk::sorted_ray hands the thread, walked
// over the split table.
template <bool kCapped>
__global__ void __launch_bounds__(kThreads)
split_walk_kernel(const float* __restrict__ rows, const float4* __restrict__ inner,
                  const float4* __restrict__ leaves, const float* __restrict__ ro,
                  const float* __restrict__ rd, const float* __restrict__ t0,
                  const bool* __restrict__ active, float* __restrict__ t_out,
                  int* __restrict__ face_out, long long r, long long max_steps) {
    const long long slot = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long i =
        rk::sorted_ray<kThreads>(slot, rd, active, r, !(kCapped && max_steps == 0));
    rk::walk_ray<rk::RowLoads, kCapped>(i, rows, inner, leaves, ro, rd, t0, active, t_out,
                                        face_out, r, max_steps);
}

}  // namespace

extern "C" long long rk_packed_walk_scratch(long long n_rows) {
    return rk::split_scratch_f4(n_rows);
}

// The split table built into `scratch` (rk_packed_walk_scratch float4),
// then the walk.
extern "C" int rk_packed_walk(const float* rows, long long n_rows, const float* ro,
                              const float* rd, const float* t0, const bool* active,
                              float* t_out, int* face_out, long long r,
                              long long max_steps, void* scratch, void* stream) {
    if (r < 0 || n_rows < 1 || max_steps < -1 || scratch == nullptr)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (const cudaError_t e = rk::build_split_table(rows, n_rows, scratch, s))
        return (int)e;
    const float4* inner = reinterpret_cast<const float4*>(scratch);
    const float4* leaves = inner + rk::kInnerF4 * n_rows;
    const unsigned grid = (unsigned)((r + kThreads - 1) / kThreads);
    if (max_steps < 0)
        split_walk_kernel<false><<<grid, kThreads, 0, s>>>(
            rows, inner, leaves, ro, rd, t0, active, t_out, face_out, r, max_steps);
    else
        split_walk_kernel<true><<<grid, kThreads, 0, s>>>(
            rows, inner, leaves, ro, rd, t0, active, t_out, face_out, r, max_steps);
    return (int)cudaGetLastError();
}

// The uncapped walk kernel's registers, local (spill) bytes, resident
// blocks an SM and threads a block (info[0..3]), and whether a block
// hands its rays out by octant (info[4]).
extern "C" int rk_packed_walk_info(int* info) {
    info[4] = 1;
    return rk::walk_kernel_info(split_walk_kernel<false>, kThreads, info);
}
