// The walks of the packed table's other layouts (raypt_torch/accel/
// packed.py: the cherry, lookahead and quad tables): the split tables
// that every walk of packed_layouts.cu reads, their build and their
// walk, which packed_layouts.cu and the designs of
// packed_layouts_designs.cu (timed by the sweep) share. PR 19's walks
// over the rows themselves are the design `pr19` of that file.
//
// Every operation is the plain torch version's (_step2, _step_la,
// _quad_step), in its order, through the helpers of packed_walk.cuh.
// Built with -fmad=false, each walk is bitwise equal to its plain walk.
//
// The split tables. The walks do not read the rows themselves but a
// table derived from them on every call (slot_build_kernel), like
// packed_walk.cuh's split table of the one-triangle layout. An internal
// row n of a table with plain internal rows (cherry, quad):
//   inner[2 n .. 2 n + 1] = [bmin, bmax.x | bmax.y, bmax.z, code(left),
//                            code(skip)]           (32 bytes, one sector)
// and of a table with lookahead rows (lookahead, quad with lookahead),
// two sectors of that same form, 32-byte rows 2 n and 2 n + 1, the
// second read only where the left box misses (the kept designs'; see
// kSectorSteps for the sweep's other forms):
//   inner[4 n .. 4 n + 1] = [lmin, lmax.x | lmax.y, lmax.z, code(left),
//                            2 n + 1]                         (sector A)
//   inner[4 n + 2 .. 4 n + 3] = [rmin, rmax.x | rmax.y, rmax.z,
//                                code(right), code(skip)]     (sector B)
// A leaf row's triangle slots (S a row: 1, 2 or 4):
//   leaves[3 e .. 3 e + 2] = slot entry e = S n + k, slot k of leaf row n:
//     [p0, e1.x | e1.y, e1.z, e2.x, e2.y | e2.z, face, X, Y] (48 bytes)
// inner indexed by the row's own number n, codes as packed_walk.cuh's
// (-1 the walk's end, s an internal row (2 s, its sector A, on a
// lookahead table), S s | 0x80000000 a leaf row's first entry, the kind
// read from the layout's flag column; row 0 may be a leaf row). No link
// is renumbered, so each ray visits the same rows in the same order.
//
// The lookahead table's leaf row (S = 1) is packed_walk.cuh's split
// leaf row: X the skip's code, Y 0; its step is the plain one's, the
// triangle taken where it is hit strictly nearer than t_best. The
// cherry and quad tables' leaf rows: a row's count is one past its last
// slot that is not empty; an empty slot has face id -1 and e1 = 0 (the
// packers' empty slots: a singleton cherry's b, a quad row's slots past
// its triangles), and no ray hits it (det is 0 or NaN). An invalid face
// keeps its id >= 0 and zero edges: it is tested. Entries from max(count,
// 1) on stay unwritten. The kept designs (Design::kStep) take one entry
// a step: X is the code of the next entry (the row's next slot, or after
// its last the row's skip) and Y the last entry's flag (1, or 2 where an
// empty slot follows it, else 0); the other designs take a row a step,
// slot 0's X the skip and Y the count. Either way the slots below the
// count are tested in slot order, each a miss counting as BIG, the
// first of the least t winning (the plain argmin, and a cherry's b only
// when strictly nearer than a); then the first untested slot (an empty
// one, t = BIG, face -1) wins where BIG is less than every tested t, as
// the plain step's argmin over all slots does, and the pick is taken
// when strictly nearer than t_best.
//
// A lookahead row's sectors are steps of their own, each the plain
// slab step over 32 bytes: sector A's left box, a hit going left and a
// miss to sector B, whose right box, tested with the same t_best (no
// leaf test comes between), picks right or skip. That is `where(hl,
// left, where(hr, right, skip))` of the plain step bit for bit, since
// the choice never reads hr where hl holds.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "packed_walk.cuh"

namespace rk {
namespace lay {

constexpr int kSlotF4 = 3;      // float4 a leaf slot of a split table

// The slab test of one box (slab_step's arithmetic, on floats already
// loaded).
__device__ __forceinline__ bool box_hit(float lx, float ly, float lz, float hx, float hy,
                                        float hz, const WalkRay& w, float t_best) {
    const float n1x = (lx - w.ox) * w.ix, n1y = (ly - w.oy) * w.iy,
                n1z = (lz - w.oz) * w.iz;
    const float n2x = (hx - w.ox) * w.ix, n2y = (hy - w.oy) * w.iy,
                n2z = (hz - w.oz) * w.iz;
    const float tnear = max_nan(max_nan(min_nan(n1x, n2x), min_nan(n1y, n2y)),
                                min_nan(n1z, n2z));
    const float tfar = min_nan(min_nan(max_nan(n1x, n2x), max_nan(n1y, n2y)),
                               max_nan(n1z, n2z));
    const bool nonempty = lx <= hx && ly <= hy && lz <= hz;
    return tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
}

// The Moller-Trumbore test of one triangle in edge form (leaf_step's
// arithmetic): whether it is hit strictly nearer than t_best, and t.
__device__ __forceinline__ bool mt_hit(float p0x, float p0y, float p0z, float e1x,
                                       float e1y, float e1z, float e2x, float e2y,
                                       float e2z, const WalkRay& w, float t_best,
                                       float& t) {
    const float px = w.dy * e2z - w.dz * e2y;
    const float py = w.dz * e2x - w.dx * e2z;
    const float pz = w.dx * e2y - w.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > 1e-8f;
    const float inv_det = leaf_inv_det(det, ok);
    const float tx = w.ox - p0x, ty = w.oy - p0y, tz = w.oz - p0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (w.dx * qx + w.dy * qy + w.dz * qz) * inv_det;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < t_best;
}

// mt_hit with early exits: a miss once det or u decides it (!(|det| >
// 1e-8), !(u >= 0), u > 1: with v >= 0, u + v rounds to at least u), so
// the rest of the test runs only where it can still hit; every value it
// computes is mt_hit's, in its order, and so is the result.
__device__ __forceinline__ bool mt_hit_early(float p0x, float p0y, float p0z, float e1x,
                                             float e1y, float e1z, float e2x, float e2y,
                                             float e2z, const WalkRay& w, float t_best,
                                             float& t) {
    const float px = w.dy * e2z - w.dz * e2y;
    const float py = w.dz * e2x - w.dx * e2z;
    const float pz = w.dx * e2y - w.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    if (!(fabsf(det) > 1e-8f)) return false;
    const float inv_det = leaf_inv_det(det, true);
    const float tx = w.ox - p0x, ty = w.oy - p0y, tz = w.oz - p0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    if (!(u >= 0.0f) || u > 1.0f) return false;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (w.dx * qx + w.dy * qy + w.dz * qz) * inv_det;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    return v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < t_best;
}

// mt_hit or mt_hit_early of the triangle of a slot entry's three float4.
template <bool kEarly>
__device__ __forceinline__ bool entry_hit(const float4& a, const float4& b, const float4& g,
                                          const WalkRay& w, float t_best, float& t) {
    return kEarly ? mt_hit_early(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, g.x, w, t_best, t)
                  : mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, g.x, w, t_best, t);
}

// A layout's columns (accel/packed.py: LAYOUTS, SLOT_LAYOUTS): floats a
// row, triangle slots (slot k's p0, e1, e2 at [9 k : 9 k + 9], its face
// id at [kFace0 + k]), the leaf flag, the left and skip links and, on a
// table with lookahead internal rows, the right link (else -1).
template <int kWidth_, int kSlots_, int kFace0_, int kFlag_, int kLeft_, int kSkip_,
          int kRight_ = -1>
struct Cols {
    static constexpr int kWidth = kWidth_, kSlots = kSlots_, kFace0 = kFace0_,
                         kFlag = kFlag_, kLeft = kLeft_, kSkip = kSkip_, kRight = kRight_;
    static constexpr bool kLookahead = kRight_ >= 0;
    static constexpr int kInner = kLookahead ? 4 : 2;   // float4 an internal row
};
using CherryCols = Cols<32, 2, 18, 21, 18, 20>;
using LookaheadCols = Cols<16, 1, 12, 14, 12, 13, 15>;
using QuadCols = Cols<64, 4, 44, 50, 48, 49>;
using QuadLookaheadCols = Cols<64, 4, 44, 50, 48, 49, 51>;

// A split walk's design: threads a block (its rays handed out by
// octant), the launch bound's blocks an SM, how a step takes a leaf
// row's slots (kLoad), every slot tested (1: each leaf row's count is
// its slots) or the filled ones only (0), and how a lookahead row's
// sectors are read (kBoth): sector B only where the left box misses, in
// the same step (0); both at once (1); or sector B a step of its own
// (2: kSectorSteps, below). kLoad 4 (kStep), the kept designs: one slot entry a step,
// each entry carrying the code of the next (its row's next slot, or
// after its last slot the row's skip) and a flag on the last (1, or 2
// where an empty slot follows it); a ray keeps its row's pick (m, f)
// across the row's steps and takes it at the last (slot_step). The
// others, a row a step, are the sweep's designs of the cherry and quad
// walks (packed_layouts_designs.cu): slot 0 holds the row's skip and
// count, and with kCodeCount the link codes carry the count too. kLoad
// 6: kStep with mt_hit_early.
template <int kThreads_, int kMinBlocks_, int kLoad_, int kAllSlots_, int kBoth_>
struct Design {
    static constexpr int kThreads = kThreads_, kMinBlocks = kMinBlocks_, kLoad = kLoad_,
                         kAllSlots = kAllSlots_, kBoth = kBoth_;
    static constexpr bool kCodeCount = kLoad == 2 || kLoad == 3 || kLoad == 5;
    static constexpr bool kStep = kLoad == 4 || kLoad == 6;
    static constexpr bool kEarly = kLoad == 6;
};

// Whether a walk of layout C with design D takes a lookahead row's
// sectors as steps of their own (the table at the top of this file:
// each sector a 32-byte row for slab_step, an internal row s's code 2
// s). The sweep's other forms (kBoth 0, 1) take a lookahead row in one
// step (lookahead_step) over sectors A = [lmin, lmax, code(left),
// code(right)] and B = [rmin, rmax, code(skip), 0], an internal row's
// code s.
template <class C, class D>
constexpr bool kSectorSteps = C::kLookahead && D::kBoth == 2;

constexpr int kCountShift = 28;        // a leaf code's count bits, 28-30
constexpr int kEntryMask = 0x0FFFFFFF;   // a code's slot entry: 2^28 of them

// The slots a leaf row's step tests: one past its last slot that is not
// empty (face id -1 and e1 = 0), or all of them.
template <class C, int kAllSlots>
__device__ __forceinline__ int slot_count(const int* __restrict__ row) {
    if (kAllSlots) return C::kSlots;
    int count = 0;
#pragma unroll
    for (int k = 0; k < C::kSlots; ++k) {
        const int* q = row + 9 * k;
        const bool empty = row[C::kFace0 + k] == -1 && ((q[3] | q[4] | q[5]) & INT_MAX) == 0;
        if (!empty) count = k + 1;
    }
    return count;
}

// The code of link s: -1 for s < 0, s for an internal row, its slot 0's
// entry kSlots s | kLeafBit for a leaf row, with the row's count <<
// kCountShift where the design carries it.
template <class C, class D>
__device__ __forceinline__ int slot_code(const int* __restrict__ rows, int s) {
    if (s < 0) return -1;
    const int* row = rows + (long long)C::kWidth * s;
    if (!(__int_as_float(row[C::kFlag]) > 0.5f)) return kSectorSteps<C, D> ? 2 * s : s;
    const int entry = C::kSlots * s | kLeafBit;
    if (D::kCodeCount) return entry | (slot_count<C, D::kAllSlots>(row) << kCountShift);
    return entry;
}

// The split table of `rows`, one thread a row, bits copied as ints. A
// leaf row writes its slots below max(count, 1) (the lookahead table's
// its one entry), an internal row its two or four float4; the rest
// stays unwritten (no walk reads it).
template <class C, class D>
__global__ void __launch_bounds__(kBuildThreads)
slot_build_kernel(const int* __restrict__ rows, long long n_rows, int4* __restrict__ inner,
                  int4* __restrict__ leaves) {
    const long long n = (long long)blockIdx.x * kBuildThreads + threadIdx.x;
    if (n >= n_rows) return;
    const int* row = rows + (long long)C::kWidth * n;
    if (__int_as_float(row[C::kFlag]) > 0.5f) {
        const int count = C::kSlots == 1 ? 1 : slot_count<C, D::kAllSlots>(row);
        const int skip = slot_code<C, D>(rows, row[C::kSkip]);
        const long long e0 = (long long)C::kSlots * n;
        int4* out = leaves + kSlotF4 * e0;
        const int written = count > 0 ? count : 1;
        for (int k = 0; k < written; ++k) {
            const int* q = row + 9 * k;
            int x = k == 0 ? skip : 0, y = k == 0 ? count : 0;
            if (D::kStep) {   // the next entry's code; the last slot's flag
                const bool last = k + 1 == written;
                x = last ? skip : (int)(e0 + k + 1) | kLeafBit;
                y = last && C::kSlots > 1 ? (count < C::kSlots ? 2 : 1) : 0;
            }
            out[3 * k] = make_int4(q[0], q[1], q[2], q[3]);
            out[3 * k + 1] = make_int4(q[4], q[5], q[6], q[7]);
            out[3 * k + 2] = make_int4(q[8], row[C::kFace0 + k], x, y);
        }
    } else {
        int4* out = inner + (long long)C::kInner * n;
        const int left = slot_code<C, D>(rows, row[C::kLeft]);
        const int skip = slot_code<C, D>(rows, row[C::kSkip]);
        out[0] = make_int4(row[0], row[1], row[2], row[3]);
        if constexpr (kSectorSteps<C, D>) {
            out[1] = make_int4(row[4], row[5], left, (int)(2 * n + 1));
            out[2] = make_int4(row[6], row[7], row[8], row[9]);
            out[3] = make_int4(row[10], row[11], slot_code<C, D>(rows, row[C::kRight]), skip);
        } else if constexpr (C::kLookahead) {
            out[1] = make_int4(row[4], row[5], left, slot_code<C, D>(rows, row[C::kRight]));
            out[2] = make_int4(row[6], row[7], row[8], row[9]);
            out[3] = make_int4(row[10], row[11], skip, 0);
        } else {
            out[1] = make_int4(row[4], row[5], left, skip);
        }
    }
}

// A lookahead row's step: the left box of sector A; where it misses,
// the right box of sector B (loaded then, or with A where kBoth), both
// with t_best; the code of the next row.
template <bool kBoth>
__device__ __forceinline__ int lookahead_step(const float4* __restrict__ inner, int c,
                                              const WalkRay& w, float t_best) {
    const float4* row = inner + 4 * (long long)c;
    const float4 a = __ldg(row), b = __ldg(row + 1);
    float4 p, q;
    if constexpr (kBoth) {
        p = __ldg(row + 2);
        q = __ldg(row + 3);
    }
    if (box_hit(a.x, a.y, a.z, a.w, b.x, b.y, w, t_best)) return __float_as_int(b.z);
    if constexpr (!kBoth) {
        p = __ldg(row + 2);
        q = __ldg(row + 3);
    }
    return __float_as_int(box_hit(p.x, p.y, p.z, p.w, q.x, q.y, w, t_best) ? b.w : q.z);
}

// The lookahead table's leaf step (its one entry): the triangle taken
// when hit strictly nearer than t_best; the code of the row's skip.
template <bool kEarly>
__device__ __forceinline__ int tri_step(const float4* __restrict__ leaves, int c,
                                        const WalkRay& w, float& t_best, int& face) {
    const float4* e = leaves + (long long)kSlotF4 * (c & kEntryMask);
    const float4 a = __ldg(e), b = __ldg(e + 1), g = __ldg(e + 2);
    float t;
    if (entry_hit<kEarly>(a, b, g, w, t_best, t)) {
        t_best = t;
        face = __float_as_int(g.y);
    }
    return __float_as_int(g.z);
}

// One slot's test (mt_hit, or mt_hit_early, on its three float4), a
// miss counting as BIG, into the running pick (m, f): taken when
// strictly less.
template <bool kEarly = false>
__device__ __forceinline__ void slot_pick(const float4& a, const float4& b, const float4& g,
                                          const WalkRay& w, float t_best, float& m, int& f) {
    float t;
    const float tk = entry_hit<kEarly>(a, b, g, w, t_best, t) ? t : kBig;
    if (tk < m) {
        m = tk;
        f = __float_as_int(g.y);
    }
}

// A slot entry's step (Design::kStep): its test into the row's pick (m,
// f), which at the row's last slot lets the first empty slot's miss win
// (flag 2) where BIG is less, is taken when strictly nearer than t_best
// and is reset; the code of the next entry.
template <bool kEarly>
__device__ __forceinline__ int slot_step(const float4* __restrict__ leaves, int c,
                                         const WalkRay& w, float& t_best, int& face,
                                         float& m, int& f) {
    const float4* e = leaves + (long long)kSlotF4 * (c & kEntryMask);
    const float4 a = __ldg(e), b = __ldg(e + 1), g = __ldg(e + 2);
    slot_pick<kEarly>(a, b, g, w, t_best, m, f);
    const int flag = __float_as_int(g.w);
    if (flag) {
        if (flag == 2 && kBig < m) {
            m = kBig;
            f = -1;
        }
        if (m < t_best) {
            t_best = m;
            face = f;
        }
        m = __int_as_float(0x7f800000);
    }
    return __float_as_int(g.z);
}

// One thread a ray: the ray sorted_ray hands the thread, walked over
// the split table of layout C one row or slot a step (Design::kStep):
// an internal row's slab test (a lookahead row's one or two), a leaf
// entry's triangle test.
template <class C, class D>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks)
slot_walk_kernel(const float* __restrict__ rows, const float4* __restrict__ inner,
                 const float4* __restrict__ leaves, const float* __restrict__ ro,
                 const float* __restrict__ rd, const float* __restrict__ t0,
                 const bool* __restrict__ active, float* __restrict__ t_out,
                 int* __restrict__ face_out, long long r) {
    static_assert(D::kStep, "the other designs' walks: packed_layouts_designs.cu");
    const long long slot = (long long)blockIdx.x * D::kThreads + threadIdx.x;
    const long long i = sorted_ray<D::kThreads>(slot, rd, active, r, true);
    const bool in = i < r;
    float t_best = in ? t0[i] : 0.0f;
    int face = -1;
    int c = -1;
    if (in && active[i]) c = slot_code<C, D>(reinterpret_cast<const int*>(rows), 0);
    WalkRay w{};
    if (c != -1) w = load_walk_ray(ro, rd, i);
    float m = __int_as_float(0x7f800000);   // the row's pick so far
    int f = -1;
    while (c != -1) {
        if (c >= 0) {
            if constexpr (C::kLookahead && !kSectorSteps<C, D>)
                c = lookahead_step<D::kBoth>(inner, c, w, t_best);
            else
                c = slab_step<RowLoads>(inner, c, w, t_best);
        } else if constexpr (C::kSlots == 1) {
            c = tri_step<D::kEarly>(leaves, c, w, t_best, face);
        } else {
            c = slot_step<D::kEarly>(leaves, c, w, t_best, face, m, f);
        }
    }
    if (in) {
        t_out[i] = t_best;
        face_out[i] = face;
    }
}

// The split table's scratch, in float4: an internal row and a leaf row
// of kSlots slots for each table row.
template <class C>
long long slot_scratch_f4(long long n_rows) {
    return (C::kInner + (long long)kSlotF4 * C::kSlots) * n_rows;
}

// Builds the split table into `scratch` (slot_scratch_f4 float4: the
// internal rows, then the leaf rows).
template <class C, class D>
cudaError_t build_slot_table(const float* rows, long long n_rows, void* scratch,
                             cudaStream_t s) {
    if (n_rows < 1 || n_rows > (kEntryMask + 1LL) / C::kSlots || scratch == nullptr)
        return cudaErrorInvalidValue;
    int4* inner = reinterpret_cast<int4*>(scratch);
    slot_build_kernel<C, D>
        <<<(unsigned)((n_rows + kBuildThreads - 1) / kBuildThreads), kBuildThreads, 0, s>>>(
            reinterpret_cast<const int*>(rows), n_rows, inner, inner + C::kInner * n_rows);
    return cudaGetLastError();
}

// The build, then the walk.
template <class C, class D>
cudaError_t launch_slot_walk(const float* rows, long long n_rows, const float* ro,
                             const float* rd, const float* t0, const bool* active,
                             float* t_out, int* face_out, long long r, void* scratch,
                             cudaStream_t s) {
    if (const cudaError_t e = build_slot_table<C, D>(rows, n_rows, scratch, s)) return e;
    const float4* inner = reinterpret_cast<const float4*>(scratch);
    const float4* leaves = inner + C::kInner * n_rows;
    const unsigned grid = (unsigned)((r + D::kThreads - 1) / D::kThreads);
    slot_walk_kernel<C, D><<<grid, D::kThreads, 0, s>>>(rows, inner, leaves, ro, rd, t0,
                                                        active, t_out, face_out, r);
    return cudaGetLastError();
}

}  // namespace lay
}  // namespace rk
