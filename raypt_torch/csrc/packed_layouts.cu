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
// t0 and face -1 and reads nothing. Built with -fmad=false, each kernel
// is bitwise equal to its plain version (packed_layouts.cuh).
//
// What bounds them on this card, as measured (NVIDIA H100 80GB HBM3,
// 700 W): the bytes a step pulls from L2 and the steps a warp waits on.
// PR 19's cherry walk read 64 bytes an internal visit (two sectors: its
// links lie in [20:24]) and 96 a leaf, always testing both triangles;
// its quad walk 48 and 176, testing four slots where 2.52 are filled on
// average. Both took 1.9-2.2x the one-triangle split walk's time
// (csrc/packed_walk.cu) though they visit 6-14% fewer rows.
//
// What the design does about it (packed_layouts.cuh; the sweep's
// `step_mb12`, python -m raypt_torch.kernels.sweep --kernels layouts):
// the cherry and quad walks read a split table derived from the rows on
// every call (its build a launch of its own, counted in the walk's
// time): 32-byte internal rows (one sector) and 48-byte entries of the
// filled triangle slots only; links carry the kind of the row they
// point at. A walk step is a slab test or one slot's triangle test, as
// in the one-triangle walk: testing a leaf row's slots in one step made
// a warp wait on its lanes' longest row (2.2-3.0 ms a bench frame
// against 1.9-2.1). One thread walks one ray, each 128-ray block's rays
// handed out by direction octant; the launch bound of 12 blocks an SM
// holds the kernel to 40 registers. The lookahead walks keep PR 19's
// design: one thread a ray over the rows themselves.
#include <cuda_runtime.h>

#include "packed_layouts.cuh"

namespace {

using rk::lay::CherryCols;
using rk::lay::QuadCols;

// The kept split design (the sweep's "step_mb12", the "package" of
// --kernels layouts): 128 threads, a launch bound of 12 blocks an SM
// (40 registers), one slot a step, the filled slots only.
using Kept = rk::lay::Design<128, 12, 4, 0>;

// The layouts, by the code the wrappers pass (kernels/packed_walk.py:
// WALKS).
enum Layout { kCherry = 0, kLookahead = 1, kQuad = 2, kQuadLookahead = 3 };

}  // namespace

// The float4 of scratch the walk of a table of layout `layout` with
// n_rows rows needs: its split table (cherry, quad), or none (0).
extern "C" long long rk_layout_walk_scratch(int layout, long long n_rows) {
    switch (layout) {
        case kCherry:
            return rk::lay::slot_scratch_f4<CherryCols>(n_rows);
        case kQuad:
            return rk::lay::slot_scratch_f4<QuadCols>(n_rows);
        default:
            return 0;
    }
}

// The split table of a cherry or quad table alone, into `scratch`
// (rk_layout_walk_scratch float4): the walk's first launch, for its
// timing and tests.
extern "C" int rk_layout_build(int layout, const float* rows, long long n_rows,
                               void* scratch, void* stream) {
    if (n_rows < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (layout) {
        case kCherry:
            return (int)rk::lay::build_slot_table<CherryCols, Kept>(rows, n_rows,
                                                                               scratch, s);
        case kQuad:
            return (int)rk::lay::build_slot_table<QuadCols, Kept>(rows, n_rows,
                                                                             scratch, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// The walk of a table of layout `layout` (Layout) with n_rows rows over
// r rays; the cherry and quad walks build their split table into
// `scratch` (rk_layout_walk_scratch float4) first. rows must be 16-byte
// aligned.
extern "C" int rk_layout_walk(int layout, const float* rows, long long n_rows,
                              const float* ro, const float* rd, const float* t0,
                              const bool* active, float* t_out, int* face_out, long long r,
                              void* scratch, void* stream) {
    if (r < 0 || n_rows < 1 || reinterpret_cast<uintptr_t>(rows) % 16)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (layout) {
        case kCherry:
            return (int)rk::lay::launch_slot_walk<CherryCols, Kept>(
                rows, n_rows, ro, rd, t0, active, t_out, face_out, r, scratch, s);
        case kLookahead:
            return (int)rk::lay::launch_row_walk<rk::lay::Lookahead>(rows, ro, rd, t0, active,
                                                                     t_out, face_out, r, s);
        case kQuad:
            return (int)rk::lay::launch_slot_walk<QuadCols, Kept>(
                rows, n_rows, ro, rd, t0, active, t_out, face_out, r, scratch, s);
        case kQuadLookahead:
            return (int)rk::lay::launch_row_walk<rk::lay::Quad<true>>(
                rows, ro, rd, t0, active, t_out, face_out, r, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// A layout's walk kernel's registers, local (spill) bytes, resident
// blocks an SM and threads a block (info[0..3]).
extern "C" int rk_layout_walk_info(int layout, int* info) {
    using rk::lay::layout_walk_kernel;
    using rk::lay::slot_walk_kernel;
    switch (layout) {
        case kCherry:
            return rk::walk_kernel_info(slot_walk_kernel<CherryCols, Kept>, Kept::kThreads,
                                        info);
        case kLookahead:
            return rk::walk_kernel_info(layout_walk_kernel<rk::lay::Lookahead>,
                                        rk::lay::kRowThreads, info);
        case kQuad:
            return rk::walk_kernel_info(slot_walk_kernel<QuadCols, Kept>, Kept::kThreads,
                                        info);
        case kQuadLookahead:
            return rk::walk_kernel_info(layout_walk_kernel<rk::lay::Quad<true>>,
                                        rk::lay::kRowThreads, info);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
