// Per-ray walk of the encoded cluster top tree, for Hopper (sm_90a).
//
// Replaces raypt/kernels/onehot_walk.py: pallas_topwalk_cm_u (:252),
// pallas_topwalk_union (:325), pallas_topwalk_cm (:190) and
// pallas_topwalk (:169, the same mask ray-major), all with body _kernel
// (:61).
// Contract:
// for each active ray, walk the skip-link top tree from node 0,
// slab-testing each node box against the ray with the bound t0; a hit
// internal node descends to its left child, anything else follows its
// skip link; a hit leaf sets its cluster's bit (ids in the first cwp
// words only). The table rows are the (Nt, 16) bf16 encoding of
// raypt/accel/ctree.py; links decode as round(hi) * 128 + round(lo) - 1.
// At most ceil((Nt + 1) / 4) * 4 steps. Five modes, five entry points:
//   * rk_topwalk: the word-major (cwp, R) int32 mask and union_pp
//     (R / 2048, cwp), the OR of the masks of each 2048-ray walk tile;
//   * rk_topwalk_union: only the (R / 256, cwp) OR over each 256-ray
//     union tile; the per-ray mask never reaches device memory;
//   * rk_topwalk_mask: only the (cwp, R) mask, with no union; cwp is
//     any word count (the non-fused branch passes ceil(C / 32) unpadded);
//   * rk_topwalk_mask_rows: the same mask ray-major, (R, cwp), which the
//     non-fused and Woop branches take (pallas_topwalk's layout);
//   * rk_topwalk_mask_spec: the mask of rk_topwalk_mask by a speculative
//     walk (scripts/tpu_walk_spec_probe.py: topwalk_spec :146, body
//     _kernel_spec :45): the node's row is carried in registers, and
//     both successor rows (left child and skip link) are loaded from
//     shared memory before the slab test decides which one to keep; a
//     link outside the table loads a zero row, which the walk never
//     takes (the step that would take it ends the walk or never runs).
//
// What bounds it on this card: the node fetches and slab tests of each
// ray (tens of steps), issued until the longest walk of the warp ends,
// since the rays of a warp leave the walk after different step counts,
// and the shared loads of the rows, which are broadcasts only where a
// warp's rays walk the same nodes. Memory traffic is small: 29 bytes of
// a live ray in, cwp * 4 bytes of mask out a ray (none in the union
// form). Against the bytes the function must move, the mask-and-union
// form is bound by its mask stores (8 words a ray on the bench scene:
// 32 MB at R = 2^20), the others by their operations.
//
// What the design does about it: the whole table in shared memory (89
// rows on the icosphere stand-in, 773 rows = 24.7 KB on the 69k-triangle
// bunny at leaf 384; dynamic shared memory, with the 48 KB opt-in near
// that, up to the 227 KB a block may use, about 7,000 rows). One thread
// walks one ray, and the rays of a warp are neighbours: they walk much
// the same nodes, so a row load is mostly a broadcast.
// (Interleaving two or three walks in a thread, packed or not, and
// refilling a thread from the packed rays when a walk ends are
// walk_designs.cu's variants of the mask-only form; each measured slower
// on the card, `python -m raypt_torch.kernels.sweep`.)
// The three forms of the package's finders share one design, from
// mask_walk.cuh: a block whose rays are all dead (most blocks of a late
// bounce, and after the compaction the tail of every group) writes what
// a dead ray owes, if anything, and stops before it loads the table;
// the block scan's total is the same in every thread, so the early
// return splits no barrier. A block scan packs the live rays in pixel
// order onto the first threads, so its warps hold only walking rays.
// The block decodes the table once into f32 bounds, links and flags (32
// bytes a row, as the bf16 rows), which takes the unpacking and link
// decoding out of every step (the same values, so the same walk). Then:
//   * Mask-only form (rk_topwalk_mask and rk_topwalk_mask_rows,
//     topwalk_mask_kernel<kRows>; ray-major, a ray's words are its row,
//     which the thread that walks it stores, so no transpose follows; a
//     block without a live ray stores its contiguous zero rows in one
//     coalesced pass, which cut the mode's time on config4's mostly dead
//     later bounces by a third or more, while building every block's rows
//     in shared memory to store them coalesced cost 8% on busy bounces:
//     walk_designs.cu's rows_staged): a dead ray's column is stored as
//     zeros; a live ray's mask word is built in
//     a register (rk::MaskColumn) and stored once, when the walk moves to
//     another word (the words skipped are stored as zeros then, the rest
//     when the walk ends), and a word that comes back after it was
//     stored (leaves out of id order) is ORed into memory, so any leaf
//     order gives the same mask; no word is read back otherwise.
//   * Mask-and-union form (rk_topwalk, topwalk_cm_u_kernel): the
//     mask-only form with the union beside it. Each word a ray stores is
//     also ORed into the block's shared union words as it is stored, so
//     the mask is neither zeroed first nor read back for the union (the
//     first design did both: 64 MB a launch at R = 2^20, beside a global
//     read-modify-write for every wanted leaf and the bf16 row unpacked
//     every step). After the block's last barrier each nonzero shared
//     word is ORed into its 2048-ray walk tile's row with one global
//     atomicOr; the wrapper zeroes union_pp, and a dead block adds
//     nothing.
//   * Union form (rk_topwalk_union, topwalk_union_kernel): a block is one
//     256-ray union tile. A tile whose rays are all dead stores its zero
//     words and stops before the table. A ray builds the word it wants in
//     a register (rk::UnionWord) and ORs it into the tile's shared words
//     only when its walk moves to another word and when it ends: leaves
//     come mostly in id order, so a ray flushes each word it wants about
//     once. An atomicOr for every wanted leaf would serialise a warp's
//     neighbouring rays, which want the same leaves at much the same
//     steps, on one address. kUnionWarpFlush = 1
//     merges the flushes of a warp's lanes that flush one word together
//     into one atomicOr; the sweep times both, and merging measured
//     slower on the card (a ray flushes each word about once, so little
//     is merged for the match and reduce it costs). The block stores
//     every word once at the end, so the union is written whole and
//     needs no zeroing.
//   * The speculative probe (topwalk_spec_kernel) keeps the probe's own
//     design: one thread a ray in place, the table in shared memory as
//     bf16 rows unpacked every step, the mask zeroed and ORed into.
// The TPU kernel's radix one-hot MXU fetch and its in-register OR-fold
// over lanes have no counterpart.
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "mask_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;   // rays per union_pp row (the JAX walk program)
static_assert(kRayTile % kThreads == 0, "a block lies in one walk tile");

// The union walk's design (the sweep builds the other setting): 1 merges
// a warp's flushes of one word into one atomicOr
constexpr int kUnionWarpFlush = 0;

// Row `node` of the shared bf16 table as two 16-byte words; a node
// outside the table reads as a zero row (the speculative loads).
__device__ __forceinline__ void load_row(const uint4* s_tab, int nt, int node,
                                         uint4* a, uint4* b) {
    if ((unsigned)node < (unsigned)nt) {
        *a = s_tab[node * 2];
        *b = s_tab[node * 2 + 1];
    } else {
        *a = *b = make_uint4(0u, 0u, 0u, 0u);
    }
}

// The speculative walk (rk_topwalk_mask_spec): one thread a ray in
// place, the bf16 rows in shared memory and unpacked every step, the
// ray's column zeroed first and ORed into for every wanted leaf.
__global__ void __launch_bounds__(kThreads)
topwalk_spec_kernel(const uint16_t* __restrict__ table, int nt,
                    const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t0, const uint8_t* __restrict__ active,
                    int* __restrict__ mask, long long r, int cw, int max_steps) {
    extern __shared__ uint4 s_tab[];                        // nt * 2
    const uint4* tab4 = reinterpret_cast<const uint4*>(table);
    for (int k = threadIdx.x; k < nt * 2; k += kThreads) s_tab[k] = tab4[k];
    __syncthreads();

    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    for (int w = 0; w < cw; ++w) mask[w * r + i] = 0;
    if (!active[i]) return;
    const rk::WalkRay ray = rk::load_walk_ray(ro, rd, t0, i);
    int node = 0;
    uint4 ra, rb;   // the carried row
    load_row(s_tab, nt, 0, &ra, &rb);
    for (int step = 0; step < max_steps && node >= 0; ++step) {
        // one row = 16 bf16 = two 16-byte words; element 2m is the low
        // half of 32-bit word m
        const unsigned wd[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
        float f[16];
        for (int m = 0; m < 8; ++m) {
            f[2 * m] = __uint_as_float(wd[m] << 16);
            f[2 * m + 1] = __uint_as_float(wd[m] & 0xffff0000u);
        }
        const int left = rk::decode_link(f[6], f[7]);
        const int skip = rk::decode_link(f[8], f[9]);
        uint4 la, lb, sa, sb;   // both successors' rows, before the test
        load_row(s_tab, nt, left, &la, &lb);
        load_row(s_tab, nt, skip, &sa, &sb);
        const float tn1x = (f[0] - ray.ox) * ray.ix, tn2x = (f[3] - ray.ox) * ray.ix;
        const float tn1y = (f[1] - ray.oy) * ray.iy, tn2y = (f[4] - ray.oy) * ray.iy;
        const float tn1z = (f[2] - ray.oz) * ray.iz, tn2z = (f[5] - ray.oz) * ray.iz;
        const float tnear = fmaxf(fmaxf(fminf(tn1x, tn2x), fminf(tn1y, tn2y)),
                                  fminf(tn1z, tn2z));
        const float tfar = fminf(fminf(fmaxf(tn1x, tn2x), fmaxf(tn1y, tn2y)),
                                 fmaxf(tn1z, tn2z));
        const bool nonempty = f[0] <= f[3] && f[1] <= f[4] && f[2] <= f[5];
        const bool hit = tfar >= tnear && tnear < ray.tb && tfar > 0.0f &&
                         nonempty && f[13] > 0.5f;
        const bool is_leaf = f[12] > 0.5f;
        const int cid = rk::decode_link(f[10], f[11]);
        if (hit && is_leaf && cid >= 0 && (cid >> 5) < cw)
            mask[(long long)(cid >> 5) * r + i] |= (int)(1u << (cid & 31));
        const bool take_left = hit && !is_leaf;
        ra = take_left ? la : sa;
        rb = take_left ? lb : sb;
        node = take_left ? left : skip;
    }
}

// The mask-only walk (rk_topwalk_mask, and with kRows rk_topwalk_mask_rows):
// kThreads rays a block, its live rays packed in pixel order onto its
// first threads, one a thread; the step and the mask column are
// mask_walk.cuh's. The mask is word-major (cwp, r), or with kRows
// ray-major (r, cwp): a ray's words are then its row, stored by the
// thread that walks it (a word's stride 1 instead of r).
template <bool kRows>
__global__ void __launch_bounds__(kThreads)
topwalk_mask_kernel(const uint16_t* __restrict__ table, int nt,
                    const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t0, const uint8_t* __restrict__ active,
                    int* __restrict__ mask, long long r, int cwp, int max_steps) {
    extern __shared__ float4 s_row[];   // nt * 2: the decoded table
    __shared__ int s_warp[33];
    __shared__ int s_list[kThreads];    // the live rays, in pixel order
    const long long base = (long long)blockIdx.x * kThreads;
    // word w of ray i at mask[i * at + w * stride]
    const long long at = kRows ? cwp : 1, stride = kRows ? 1 : r;
    const bool live = active[base + threadIdx.x];
    // a dead ray's words are zeros (word-major: stored now, coalesced
    // across the warp); a block without a live ray is done
    if (!kRows && !live)
        for (int w = 0; w < cwp; ++w) mask[w * r + base + threadIdx.x] = 0;
    int n;
    const int pos = rk::block_exclusive_scan(live, s_warp, &n);
    if constexpr (kRows) {
        // ray-major: a block without a live ray stores its rows, which are
        // contiguous, in one coalesced pass; in another block each dead ray
        // stores its own row
        if (n == 0)
            for (int k = threadIdx.x; k < kThreads * cwp; k += kThreads)
                mask[base * cwp + k] = 0;
        else if (!live)
            for (int w = 0; w < cwp; ++w) mask[(base + threadIdx.x) * cwp + w] = 0;
    }
    if (n == 0) return;   // uniform across the block
    if (live) s_list[pos] = threadIdx.x;
    rk::decode_table(table, nt, cwp, s_row);
    __syncthreads();
    if ((int)threadIdx.x >= n) return;
    const long long i = base + s_list[threadIdx.x];
    const rk::WalkRay ray = rk::load_walk_ray(ro, rd, t0, i);
    rk::MaskColumn col{mask + i * at, -1, -1, 0u};
    int node = 0;
    for (int step = 0; step < max_steps && node >= 0; ++step) {
        int cid;
        node = rk::walk_step(s_row, node, ray, &cid);
        if (cid >= 0) col.add(stride, cid);
    }
    col.finish(stride, cwp);
}

// The union walk (rk_topwalk_union): one 256-ray union tile a block, its
// live rays packed in pixel order onto its first threads, one a thread;
// the step is mask_walk.cuh's, each ray's words reach the tile's shared
// union through rk::UnionWord.
__global__ void __launch_bounds__(kThreads)
topwalk_union_kernel(const uint16_t* __restrict__ table, int nt,
                     const float* __restrict__ ro, const float* __restrict__ rd,
                     const float* __restrict__ t0,
                     const uint8_t* __restrict__ active,
                     int* __restrict__ unions, int cwp, int max_steps) {
    extern __shared__ float4 s_row[];   // nt * 2: the decoded table, then
    unsigned* s_union = reinterpret_cast<unsigned*>(s_row + nt * 2);  // cwp
    __shared__ int s_warp[33];
    __shared__ int s_list[kThreads];    // the live rays, in pixel order
    const long long base = (long long)blockIdx.x * kThreads;
    int* out = unions + (long long)blockIdx.x * cwp;
    const bool live = active[base + threadIdx.x];
    int n;
    const int at = rk::block_exclusive_scan(live, s_warp, &n);
    if (n == 0) {   // uniform across the block: an empty union
        for (int w = threadIdx.x; w < cwp; w += kThreads) out[w] = 0;
        return;
    }
    if (live) s_list[at] = threadIdx.x;
    for (int w = threadIdx.x; w < cwp; w += kThreads) s_union[w] = 0u;
    rk::decode_table(table, nt, cwp, s_row);
    __syncthreads();
    if ((int)threadIdx.x < n) {
        const rk::WalkRay ray =
            rk::load_walk_ray(ro, rd, t0, base + s_list[threadIdx.x]);
        rk::UnionWord<kUnionWarpFlush != 0> word{-1, 0u};
        int node = 0;
        for (int step = 0; step < max_steps && node >= 0; ++step) {
            int cid;
            node = rk::walk_step(s_row, node, ray, &cid);
            if (cid >= 0) word.add(s_union, cid);
        }
        word.finish(s_union);
    }
    __syncthreads();
    for (int w = threadIdx.x; w < cwp; w += kThreads) out[w] = (int)s_union[w];
}

// The mask-and-union walk (rk_topwalk): the mask-only walk's block with
// its union beside it. Each stored word of a ray's column is also ORed
// into the block's shared union words (rk::MaskColumn with s_union);
// after the last barrier the block ORs its nonzero words into its walk
// tile's row of union_pp, which the caller zeroed. A block without a
// live ray stores its zero columns and adds nothing.
__global__ void __launch_bounds__(kThreads)
topwalk_cm_u_kernel(const uint16_t* __restrict__ table, int nt,
                    const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t0,
                    const uint8_t* __restrict__ active, int* __restrict__ mask,
                    int* __restrict__ union_pp, long long r, int cwp,
                    int max_steps) {
    extern __shared__ float4 s_row[];   // nt * 2: the decoded table, then
    unsigned* s_union = reinterpret_cast<unsigned*>(s_row + nt * 2);  // cwp
    __shared__ int s_warp[33];
    __shared__ int s_list[kThreads];    // the live rays, in pixel order
    const long long base = (long long)blockIdx.x * kThreads;
    const bool live = active[base + threadIdx.x];
    if (!live)
        for (int w = 0; w < cwp; ++w) mask[w * r + base + threadIdx.x] = 0;
    int n;
    const int at = rk::block_exclusive_scan(live, s_warp, &n);
    if (n == 0) return;   // uniform across the block
    if (live) s_list[at] = threadIdx.x;
    for (int w = threadIdx.x; w < cwp; w += kThreads) s_union[w] = 0u;
    rk::decode_table(table, nt, cwp, s_row);
    __syncthreads();
    if ((int)threadIdx.x < n) {
        const long long i = base + s_list[threadIdx.x];
        const rk::WalkRay ray = rk::load_walk_ray(ro, rd, t0, i);
        rk::MaskColumn col{mask + i, -1, -1, 0u, s_union};
        int node = 0;
        for (int step = 0; step < max_steps && node >= 0; ++step) {
            int cid;
            node = rk::walk_step(s_row, node, ray, &cid);
            if (cid >= 0) col.add(r, cid);
        }
        col.finish(r, cwp);
    }
    __syncthreads();
    int* out = union_pp + base / kRayTile * cwp;
    for (int w = threadIdx.x; w < cwp; w += kThreads)
        if (s_union[w]) atomicOr(&out[w], (int)s_union[w]);
}

// The static shared memory of the packed walks (list and scan words,
// under kThreads + 64 ints) counts against the 48 KB default too: opt in
// to `smem` bytes of dynamic shared memory near that. Returns a CUDA
// error code.
template <typename Kernel>
int prepare_packed_smem(Kernel kernel, size_t smem) {
    if (smem + sizeof(int) * (kThreads + 64) <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// mask: (cwp, r) int32, every word written; union_pp: (r / 2048, cwp)
// int32, zeroed by the caller.
extern "C" int rk_topwalk(const uint16_t* table, int nt, const float* ro,
                          const float* rd, const float* t0, const uint8_t* active,
                          int* mask, int* union_pp, long long r, int cwp,
                          int max_steps, void* stream) {
    if (r % kRayTile || nt <= 0 || nt >= 1 << 15 || cwp <= 0)   // links: 15 bits
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = (size_t)nt * 32 + (size_t)cwp * 4;
    if (const int e = prepare_packed_smem(topwalk_cm_u_kernel, smem)) return e;
    topwalk_cm_u_kernel<<<(unsigned)(r / kThreads), kThreads, smem,
                          (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, mask, union_pp, r, cwp, max_steps);
    return (int)cudaGetLastError();
}

// unions: (r / 256, cwp) int32, every word written.
extern "C" int rk_topwalk_union(const uint16_t* table, int nt, const float* ro,
                                const float* rd, const float* t0,
                                const uint8_t* active, int* unions, long long r,
                                int cwp, int max_steps, void* stream) {
    if (r % kThreads || nt <= 0 || nt >= 1 << 15 || cwp <= 0)   // links: 15 bits
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = (size_t)nt * 32 + (size_t)cwp * 4;
    if (const int e = prepare_packed_smem(topwalk_union_kernel, smem)) return e;
    topwalk_union_kernel<<<(unsigned)(r / kThreads), kThreads, smem,
                           (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, unions, cwp, max_steps);
    return (int)cudaGetLastError();
}

namespace {

// The mask-only walk's launch: the (cw, r) mask, or with kRows (r, cw);
// every word written, r a multiple of 256.
template <bool kRows>
int launch_mask(const uint16_t* table, int nt, const float* ro, const float* rd,
                const float* t0, const uint8_t* active, int* mask, long long r, int cw,
                int max_steps, void* stream) {
    if (r % kThreads || nt <= 0 || nt >= 1 << 15 || cw <= 0)   // links: 15 bits
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = (size_t)nt * 32;
    if (const int e = prepare_packed_smem(topwalk_mask_kernel<kRows>, smem)) return e;
    topwalk_mask_kernel<kRows><<<(unsigned)(r / kThreads), kThreads, smem,
                                 (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, mask, r, cw, max_steps);
    return (int)cudaGetLastError();
}

}  // namespace

// mask: (cw, r) int32, word-major, every word written; r a multiple of 256.
extern "C" int rk_topwalk_mask(const uint16_t* table, int nt, const float* ro,
                               const float* rd, const float* t0,
                               const uint8_t* active, int* mask, long long r,
                               int cw, int max_steps, void* stream) {
    return launch_mask<false>(table, nt, ro, rd, t0, active, mask, r, cw, max_steps,
                              stream);
}

// mask: (r, cw) int32, ray-major (pallas_topwalk's layout), every word
// written; r a multiple of 256.
extern "C" int rk_topwalk_mask_rows(const uint16_t* table, int nt, const float* ro,
                                    const float* rd, const float* t0,
                                    const uint8_t* active, int* mask, long long r,
                                    int cw, int max_steps, void* stream) {
    return launch_mask<true>(table, nt, ro, rd, t0, active, mask, r, cw, max_steps,
                             stream);
}

// The mask of rk_topwalk_mask by the speculative walk.
extern "C" int rk_topwalk_mask_spec(const uint16_t* table, int nt, const float* ro,
                                    const float* rd, const float* t0,
                                    const uint8_t* active, int* mask, long long r,
                                    int cw, int max_steps, void* stream) {
    if (r % kThreads || nt <= 0 || cw <= 0)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = (size_t)nt * 32;
    if (smem > 48 * 1024)
        if (const cudaError_t e = cudaFuncSetAttribute(
                topwalk_spec_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
            return (int)e;
    topwalk_spec_kernel<<<(unsigned)(r / kThreads), kThreads, smem,
                          (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, mask, r, cw, max_steps);
    return (int)cudaGetLastError();
}
