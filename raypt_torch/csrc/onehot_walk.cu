// Per-ray walk of the encoded cluster top tree, for Hopper (sm_90a).
//
// Replaces raypt/kernels/onehot_walk.py: pallas_topwalk_cm_u (:252),
// pallas_topwalk_union (:325) and pallas_topwalk_cm (:190; with a
// transpose after it, pallas_topwalk :169), all with body _kernel (:61).
// Contract:
// for each active ray, walk the skip-link top tree from node 0,
// slab-testing each node box against the ray with the bound t0; a hit
// internal node descends to its left child, anything else follows its
// skip link; a hit leaf sets its cluster's bit (ids in the first cwp
// words only). The table rows are the (Nt, 16) bf16 encoding of
// raypt/accel/ctree.py; links decode as round(hi) * 128 + round(lo) - 1.
// At most ceil((Nt + 1) / 4) * 4 steps. Four modes, four entry points:
//   * rk_topwalk: the word-major (cwp, R) int32 mask and union_pp
//     (R / 2048, cwp), the OR of the masks of each 2048-ray walk tile;
//   * rk_topwalk_union: only the (R / 256, cwp) OR over each 256-ray
//     union tile; the per-ray mask never reaches device memory;
//   * rk_topwalk_mask: only the (cwp, R) mask, with no union; cwp is
//     any word count (the non-fused branch passes ceil(C / 32) unpadded);
//   * rk_topwalk_mask_spec: the mask of rk_topwalk_mask by a speculative
//     walk (scripts/tpu_walk_spec_probe.py: topwalk_spec :146, body
//     _kernel_spec :45): the node's row is carried in registers, and
//     both successor rows (left child and skip link) are loaded from
//     shared memory before the slab test decides which one to keep; a
//     link outside the table loads a zero row, which the walk never
//     takes (the step that would take it ends the walk or never runs).
//
// What bounds it on this card: the dependent chain of node fetches and
// slab tests per ray (tens of steps), and warp divergence, since the
// rays of a warp leave the walk after different step counts. Memory
// traffic is small: 29 bytes of ray in, cwp * 4 bytes of mask out (none
// in the union form).
//
// What the design does about it: one thread per ray, the whole table in
// shared memory (89 rows on the icosphere stand-in, 773 rows = 24.7 KB
// on the 69k-triangle bunny at leaf 384; dynamic shared memory, with
// the 48 KB opt-in above that, up to the 227 KB a block may use, about
// 7,000 rows), so a node fetch is two 16-byte shared
// loads and the row decodes in registers. Mask form: bits go straight
// into the ray's own column of the mask (zeroed first), so no
// per-thread array sits in local memory (the mask-only mode stops
// there); the tile union is a warp
// __reduce_or_sync, a shared atomicOr per block, and one global atomicOr
// per block and word. Union form: a block is one 256-ray union tile, a
// wanted bit is a shared atomicOr into the tile's words, and the block
// stores every word once at the end, so the union is written whole and
// needs no zeroing. The TPU kernel's radix one-hot MXU fetch and its
// in-register OR-fold over lanes have no counterpart.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;   // rays per union_pp row (the JAX walk program)
static_assert(kRayTile % kThreads == 0, "a block lies in one walk tile");
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int decode(float hi, float lo) {
    return (int)(rintf(hi) * 128.0f + rintf(lo)) - 1;
}

// What a launch writes: the mask and the walk-tile union_pp; only the
// block's union, to unions[blockIdx.x * cwp + w] (mask is not touched);
// or only the mask (unions and the shared union words are not touched),
// by the plain walk or by the speculative one.
enum Mode { kMaskAndUnionPP, kTileUnion, kMaskOnly, kMaskSpec };

// Row `node` of the shared table as two 16-byte words; a node outside
// the table reads as a zero row (the speculative loads only).
__device__ __forceinline__ void load_row(const uint4* s_tab, int nt, int node,
                                         uint4* a, uint4* b) {
    if ((unsigned)node < (unsigned)nt) {
        *a = s_tab[node * 2];
        *b = s_tab[node * 2 + 1];
    } else {
        *a = *b = make_uint4(0u, 0u, 0u, 0u);
    }
}

template <Mode kMode>
__global__ void __launch_bounds__(kThreads)
topwalk_kernel(const uint16_t* __restrict__ table, int nt,
               const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ t0, const uint8_t* __restrict__ active,
               int* __restrict__ mask, int* __restrict__ unions, long long r,
               int cwp, int max_steps) {
    extern __shared__ uint4 s_mem[];                        // nt * 2 rows
    int* s_union = reinterpret_cast<int*>(s_mem + nt * 2);  // cwp words
    const uint4* tab4 = reinterpret_cast<const uint4*>(table);
    for (int k = threadIdx.x; k < nt * 2; k += kThreads) s_mem[k] = tab4[k];
    constexpr bool kMaskOut = kMode == kMaskOnly || kMode == kMaskSpec;
    if constexpr (!kMaskOut)
        for (int w = threadIdx.x; w < cwp; w += kThreads) s_union[w] = 0;
    __syncthreads();

    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if constexpr (kMode != kTileUnion)
        for (int w = 0; w < cwp; ++w) mask[w * r + i] = 0;

    if (active[i]) {
        const float ox = ro[i * 3], oy = ro[i * 3 + 1], oz = ro[i * 3 + 2];
        float inv[3];
        for (int k = 0; k < 3; ++k) {
            const float d = rd[i * 3 + k];
            const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
            inv[k] = 1.0f / safe;
        }
        const float tb = t0[i];
        int node = 0;
        uint4 ra, rb;   // the speculative walk's carried row
        if constexpr (kMode == kMaskSpec) load_row(s_mem, nt, 0, &ra, &rb);
        for (int step = 0; step < max_steps && node >= 0; ++step) {
            // one row = 16 bf16 = two 16-byte shared loads; element 2k is
            // the low half of 32-bit word k
            uint4 a, b;
            if constexpr (kMode == kMaskSpec) {
                a = ra;
                b = rb;
            } else {
                a = s_mem[node * 2];
                b = s_mem[node * 2 + 1];
            }
            const unsigned wd[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
            float f[16];
            for (int k = 0; k < 8; ++k) {
                f[2 * k] = __uint_as_float(wd[k] << 16);
                f[2 * k + 1] = __uint_as_float(wd[k] & 0xffff0000u);
            }
            const int left = decode(f[6], f[7]), skip = decode(f[8], f[9]);
            uint4 la, lb, sa, sb;   // speculative: both successors' rows,
            if constexpr (kMode == kMaskSpec) {   // loaded before the test
                load_row(s_mem, nt, left, &la, &lb);
                load_row(s_mem, nt, skip, &sa, &sb);
            }
            const float tn1x = (f[0] - ox) * inv[0], tn2x = (f[3] - ox) * inv[0];
            const float tn1y = (f[1] - oy) * inv[1], tn2y = (f[4] - oy) * inv[1];
            const float tn1z = (f[2] - oz) * inv[2], tn2z = (f[5] - oz) * inv[2];
            const float tnear = fmaxf(fmaxf(fminf(tn1x, tn2x), fminf(tn1y, tn2y)),
                                      fminf(tn1z, tn2z));
            const float tfar = fminf(fminf(fmaxf(tn1x, tn2x), fmaxf(tn1y, tn2y)),
                                     fmaxf(tn1z, tn2z));
            const bool nonempty = f[0] <= f[3] && f[1] <= f[4] && f[2] <= f[5];
            const bool hit = tfar >= tnear && tnear < tb && tfar > 0.0f &&
                             nonempty && f[13] > 0.5f;
            const bool is_leaf = f[12] > 0.5f;
            const int cid = decode(f[10], f[11]);
            if (hit && is_leaf && cid >= 0 && (cid >> 5) < cwp) {
                const int bit = (int)(1u << (cid & 31));
                if constexpr (kMode == kTileUnion)
                    atomicOr(&s_union[cid >> 5], bit);
                else
                    mask[(long long)(cid >> 5) * r + i] |= bit;
            }
            const bool take_left = hit && !is_leaf;
            if constexpr (kMode == kMaskSpec) {
                ra = take_left ? la : sa;
                rb = take_left ? lb : sb;
            }
            node = take_left ? left : skip;
        }
    }

    if constexpr (kMode == kTileUnion) {
        __syncthreads();
        for (int w = threadIdx.x; w < cwp; w += kThreads)
            unions[(long long)blockIdx.x * cwp + w] = s_union[w];
        return;
    }
    if constexpr (kMaskOut) return;
    const int lane = threadIdx.x & 31;
    for (int w = 0; w < cwp; ++w) {
        const unsigned v = __reduce_or_sync(kFull, (unsigned)mask[w * r + i]);
        if (lane == 0 && v) atomicOr(&s_union[w], (int)v);
    }
    __syncthreads();
    const long long tile = ((long long)blockIdx.x * kThreads) / kRayTile;
    for (int w = threadIdx.x; w < cwp; w += kThreads)
        if (s_union[w]) atomicOr(&unions[tile * cwp + w], s_union[w]);
}

// Dynamic shared memory of a launch: the table and, in the union modes,
// cwp union words, opted in above 48 KB. Returns a CUDA error code.
template <Mode kMode>
int prepare_smem(int nt, int cwp, size_t* smem) {
    *smem = (size_t)nt * 32 +
            (kMode == kMaskOnly || kMode == kMaskSpec ? 0 : (size_t)cwp * 4);
    if (*smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(topwalk_kernel<kMode>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
}

}  // namespace

extern "C" int rk_topwalk(const uint16_t* table, int nt, const float* ro,
                          const float* rd, const float* t0, const uint8_t* active,
                          int* mask, int* union_pp, long long r, int cwp,
                          int max_steps, void* stream) {
    if (r % kRayTile || nt <= 0 || cwp <= 0)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem<kMaskAndUnionPP>(nt, cwp, &smem)) return e;
    topwalk_kernel<kMaskAndUnionPP><<<(unsigned)(r / kThreads), kThreads, smem,
                            (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, mask, union_pp, r, cwp, max_steps);
    return (int)cudaGetLastError();
}

// unions: (r / 256, cwp) int32, every word written.
extern "C" int rk_topwalk_union(const uint16_t* table, int nt, const float* ro,
                                const float* rd, const float* t0,
                                const uint8_t* active, int* unions, long long r,
                                int cwp, int max_steps, void* stream) {
    if (r % kThreads || nt <= 0 || cwp <= 0)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem<kTileUnion>(nt, cwp, &smem)) return e;
    topwalk_kernel<kTileUnion><<<(unsigned)(r / kThreads), kThreads, smem,
                           (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, nullptr, unions, r, cwp, max_steps);
    return (int)cudaGetLastError();
}

// mask: (cw, r) int32, every word written; r a multiple of 256.
extern "C" int rk_topwalk_mask(const uint16_t* table, int nt, const float* ro,
                               const float* rd, const float* t0,
                               const uint8_t* active, int* mask, long long r,
                               int cw, int max_steps, void* stream) {
    if (r % kThreads || nt <= 0 || cw <= 0)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem<kMaskOnly>(nt, cw, &smem)) return e;
    topwalk_kernel<kMaskOnly><<<(unsigned)(r / kThreads), kThreads, smem,
                                (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, mask, nullptr, r, cw, max_steps);
    return (int)cudaGetLastError();
}

// The mask of rk_topwalk_mask by the speculative walk (kMaskSpec).
extern "C" int rk_topwalk_mask_spec(const uint16_t* table, int nt, const float* ro,
                                    const float* rd, const float* t0,
                                    const uint8_t* active, int* mask, long long r,
                                    int cw, int max_steps, void* stream) {
    if (r % kThreads || nt <= 0 || cw <= 0)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem<kMaskSpec>(nt, cw, &smem)) return e;
    topwalk_kernel<kMaskSpec><<<(unsigned)(r / kThreads), kThreads, smem,
                                (cudaStream_t)stream>>>(
        table, nt, ro, rd, t0, active, mask, nullptr, r, cw, max_steps);
    return (int)cudaGetLastError();
}
