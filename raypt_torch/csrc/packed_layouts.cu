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
// PR 19's walks read the rows themselves, a step first loading the
// float4 of the row's kind and links and then the floats its kind
// needs: two dependent L2 round trips a visit. Its cherry walk read 64
// bytes an internal visit and 96 a leaf, always testing both triangles;
// its quad walk 48 and 176, testing four slots where 2.52 are filled on
// average; its lookahead walk 64 a visit of either kind, both child
// boxes read where the right one is needed only after a left miss.
//
// What the design does about it (packed_layouts.cuh; the sweep's
// `step_mb12` and, for the lookahead walks, `la_sectors_mb12`, python -m
// raypt_torch.kernels.sweep --kernels layouts): every walk reads a split
// table derived from the rows on every call (its build a launch of its
// own, counted in the walk's time) whose links carry the kind of the row
// they point at, so a step issues its loads at once: a 32-byte internal
// row (one sector), a 48-byte entry a filled triangle slot. A lookahead
// row is two such sectors, each a step of its own: the left box, then,
// only where it misses, the right box. A walk step is a slab test or one
// slot's triangle test, as in the one-triangle walk: testing a leaf
// row's slots in one step made a warp wait on its lanes' longest row
// (2.2-3.0 ms a bench frame against 1.9-2.1), and testing a lookahead
// row's two boxes in one step (157-166 SASS a pass against 123-135)
// cost 11-12% (2.01 / 2.17 ms against 1.79 / 2.01); loading both
// sectors at once cost more (2.23 / 2.32). One thread walks one ray,
// each 128-ray block's rays handed out by direction octant; the launch
// bound of 12 blocks an SM holds the kernel to 40 registers.
#include <cuda_runtime.h>

#include "packed_layouts.cuh"

namespace {

using rk::lay::CherryCols;
using rk::lay::LookaheadCols;
using rk::lay::QuadCols;
using rk::lay::QuadLookaheadCols;

// The kept split designs (the "package" of the sweep's --kernels
// layouts): 128 threads, a launch bound of 12 blocks an SM (40
// registers), one slot a step, the filled slots only; the cherry and
// quad walks' is the sweep's "step_mb12", the lookahead walks'
// "la_sectors_mb12" (a lookahead row's two sectors steps of their own).
using Kept = rk::lay::Design<128, 12, 4, 0, 0>;
using KeptLookahead = rk::lay::Design<128, 12, 4, 0, 2>;

// The layouts, by the code the wrappers pass (kernels/packed_walk.py:
// WALKS).
enum Layout { kCherry = 0, kLookahead = 1, kQuad = 2, kQuadLookahead = 3 };

// f(C, D) for layout `layout`'s columns and kept design; `bad` for any
// other code.
template <class F, class R>
R by_layout(int layout, F f, R bad) {
    switch (layout) {
        case kCherry:
            return f(CherryCols{}, Kept{});
        case kLookahead:
            return f(LookaheadCols{}, KeptLookahead{});
        case kQuad:
            return f(QuadCols{}, Kept{});
        case kQuadLookahead:
            return f(QuadLookaheadCols{}, KeptLookahead{});
        default:
            return bad;
    }
}

}  // namespace

// The float4 of scratch the walk of a table of layout `layout` with
// n_rows rows needs: its split table.
extern "C" long long rk_layout_walk_scratch(int layout, long long n_rows) {
    return by_layout(
        layout, [&](auto c, auto) { return rk::lay::slot_scratch_f4<decltype(c)>(n_rows); },
        0LL);
}

// The split table of a table alone, into `scratch` (rk_layout_walk_scratch
// float4): the walk's first launch, for its timing and tests.
extern "C" int rk_layout_build(int layout, const float* rows, long long n_rows,
                               void* scratch, void* stream) {
    if (n_rows < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return by_layout(
        layout,
        [&](auto c, auto d) {
            return (int)rk::lay::build_slot_table<decltype(c), decltype(d)>(rows, n_rows,
                                                                            scratch, s);
        },
        (int)cudaErrorInvalidValue);
}

// The walk of a table of layout `layout` (Layout) with n_rows rows over
// r rays: the build of its split table into `scratch`
// (rk_layout_walk_scratch float4), then the walk. rows must be 16-byte
// aligned.
extern "C" int rk_layout_walk(int layout, const float* rows, long long n_rows,
                              const float* ro, const float* rd, const float* t0,
                              const bool* active, float* t_out, int* face_out, long long r,
                              void* scratch, void* stream) {
    if (r < 0 || n_rows < 1 || reinterpret_cast<uintptr_t>(rows) % 16)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    return by_layout(
        layout,
        [&](auto c, auto d) {
            return (int)rk::lay::launch_slot_walk<decltype(c), decltype(d)>(
                rows, n_rows, ro, rd, t0, active, t_out, face_out, r, scratch, s);
        },
        (int)cudaErrorInvalidValue);
}

// A layout's walk kernel's registers, local (spill) bytes, resident
// blocks an SM and threads a block (info[0..3]).
extern "C" int rk_layout_walk_info(int layout, int* info) {
    return by_layout(
        layout,
        [&](auto c, auto d) {
            using D = decltype(d);
            return rk::walk_kernel_info(rk::lay::slot_walk_kernel<decltype(c), D>,
                                        D::kThreads, info);
        },
        (int)cudaErrorInvalidValue);
}
