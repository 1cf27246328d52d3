// The pieces of the mask-only walk (rk_topwalk_mask), the union walk
// (rk_topwalk_union) and the mask-and-union walk (rk_topwalk), shared by
// their kernels (onehot_walk.cu: topwalk_mask_kernel,
// topwalk_union_kernel, topwalk_cm_u_kernel) and the design variants
// that `python -m raypt_torch.kernels.sweep` times against the first
// (walk_designs.cu): the table decoded once a block, one step of a walk
// on the decoded rows, a ray's mask column built a word at a time (its
// stores also ORed into the block's union words where the kernel keeps
// a union beside the mask), and a ray's share of its tile's union built
// the same way without a mask.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace rk {

// A link or cluster id stored as two bf16 halves, hi * 128 + lo, plus one.
__device__ __forceinline__ int decode_link(float hi, float lo) {
    return (int)(rintf(hi) * 128.0f + rintf(lo)) - 1;
}

// The bf16 table (nt rows of 16 halves) decoded by the block's threads
// into s_row, two float4 a row: (lo.x, lo.y, lo.z, hi.x) and (hi.y, hi.z,
// links, cid), links = left + 1 | (skip + 1) << 15 | the box's test flag
// (nonempty and valid) << 30 | leaf << 31, cid -1 unless a leaf whose
// cluster is in the first cwp words. The same values as the bf16 row, so
// the same walk. The caller syncs the block after it.
__device__ inline void decode_table(const uint16_t* __restrict__ table, int nt,
                                    int cwp, float4* s_row) {
    const uint4* tab4 = reinterpret_cast<const uint4*>(table);
    for (int k = threadIdx.x; k < nt; k += blockDim.x) {
        const uint4 a = tab4[2 * k], b = tab4[2 * k + 1];
        const unsigned wd[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float f[16];
#pragma unroll
        for (int m = 0; m < 8; ++m) {   // element 2m: the low half of word m
            f[2 * m] = __uint_as_float(wd[m] << 16);
            f[2 * m + 1] = __uint_as_float(wd[m] & 0xffff0000u);
        }
        const int left = decode_link(f[6], f[7]), skip = decode_link(f[8], f[9]);
        const int cid = decode_link(f[10], f[11]);
        const bool nonempty = f[0] <= f[3] && f[1] <= f[4] && f[2] <= f[5];
        const bool is_leaf = f[12] > 0.5f;
        const unsigned links = ((unsigned)(left + 1) & 0x7fffu) |
                               ((unsigned)(skip + 1) & 0x7fffu) << 15 |
                               (unsigned)(nonempty && f[13] > 0.5f) << 30 |
                               (unsigned)is_leaf << 31;
        const bool want = is_leaf && cid >= 0 && (cid >> 5) < cwp;
        s_row[2 * k] = make_float4(f[0], f[1], f[2], f[3]);
        s_row[2 * k + 1] = make_float4(f[4], f[5], __uint_as_float(links),
                                       __int_as_float(want ? cid : -1));
    }
}

// A walking ray: its origin, the reciprocal of its direction (components
// below 1e-12 in magnitude clamped to +-1e-12) and its t bound.
struct WalkRay {
    float ox, oy, oz, ix, iy, iz, tb;
};

__device__ __forceinline__ WalkRay load_walk_ray(const float* __restrict__ ro,
                                                 const float* __restrict__ rd,
                                                 const float* __restrict__ t0,
                                                 long long i) {
    float inv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float d = rd[i * 3 + k];
        const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
        inv[k] = 1.0f / safe;
    }
    return {ro[i * 3], ro[i * 3 + 1], ro[i * 3 + 2], inv[0], inv[1], inv[2],
            t0[i]};
}

// One step of a walk at `node` of the decoded table: returns the next
// node (-1: the walk ends) and sets *cid to the wanted cluster of a leaf
// the ray's box test hits, else -1.
__device__ __forceinline__ int walk_step(const float4* s_row, int node,
                                         const WalkRay& k, int* cid) {
    const float4 a = s_row[node * 2], b = s_row[node * 2 + 1];
    const unsigned links = __float_as_uint(b.z);
    const float tn1x = (a.x - k.ox) * k.ix, tn2x = (a.w - k.ox) * k.ix;
    const float tn1y = (a.y - k.oy) * k.iy, tn2y = (b.x - k.oy) * k.iy;
    const float tn1z = (a.z - k.oz) * k.iz, tn2z = (b.y - k.oz) * k.iz;
    const float tnear = fmaxf(fmaxf(fminf(tn1x, tn2x), fminf(tn1y, tn2y)),
                              fminf(tn1z, tn2z));
    const float tfar = fminf(fminf(fmaxf(tn1x, tn2x), fmaxf(tn1y, tn2y)),
                             fmaxf(tn1z, tn2z));
    const bool hit = tfar >= tnear && tnear < k.tb && tfar > 0.0f &&
                     (links >> 30 & 1u);
    *cid = hit ? __float_as_int(b.w) : -1;
    return hit && !(links >> 31) ? (int)(links & 0x7fffu) - 1
                                 : (int)(links >> 15 & 0x7fffu) - 1;
}

// A ray's mask column, built a word at a time in registers: the word
// being built (cur_w, bits) and the last word stored (every word up to it
// is in memory). A word is stored once, with the words skipped before it
// as zeros; a word that comes back after it was stored (leaves out of id
// order) is ORed into memory, so any leaf order gives the same mask.
// With s_union set (the mask-and-union walk), each nonzero word is also
// ORed into the block's shared union words when it is stored: one
// register word feeds both outputs, and the mask is never read back.
// The calls' `r` is the stride of a ray's words: R for the word-major
// (cwp, R) mask, 1 for the ray-major (R, cwp) one.
struct MaskColumn {
    int* col;          // word 0 of the ray's column; word w at col[w * r]
    int cur_w, last;
    unsigned bits;
    unsigned* s_union = nullptr;   // the block's union words, or none

    __device__ __forceinline__ void store(long long r, int w, unsigned b) {
        if (s_union) atomicOr(&s_union[w], b);
        if (w > last) {
            for (int z = last + 1; z < w; ++z) col[z * r] = 0;
            col[w * r] = (int)b;
            last = w;
        } else {
            col[w * r] |= (int)b;
        }
    }
    __device__ __forceinline__ void add(long long r, int cid) {
        if ((cid >> 5) != cur_w) {
            if (bits) store(r, cur_w, bits);
            cur_w = cid >> 5;
            bits = 0u;
        }
        bits |= 1u << (cid & 31);
    }
    // the walk has ended: the word being built and the words after it
    __device__ __forceinline__ void finish(long long r, int cwp) {
        if (bits) store(r, cur_w, bits);
        for (int z = last + 1; z < cwp; ++z) col[z * r] = 0;
    }
};

// A ray's share of its tile's union, built a word at a time in
// registers like a MaskColumn: the word being built (cur_w, bits) is
// ORed into the block's shared union words when the walk moves to
// another word, and once more when it ends, so a ray whose leaves come
// in id order flushes each of its words once (a word that comes back is
// ORed again: any leaf order gives the same union). With kWarp, the
// lanes of a warp that flush the same word together merge their bits
// first (__match_any_sync, then __reduce_or_sync) and one of them
// does the shared atomicOr.
template <bool kWarp>
struct UnionWord {
    int cur_w;
    unsigned bits;

    __device__ __forceinline__ void flush(unsigned* s_union) {
        if constexpr (kWarp) {
            const unsigned peers = __match_any_sync(__activemask(), cur_w);
            const unsigned v = __reduce_or_sync(peers, bits);
            if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
                atomicOr(&s_union[cur_w], v);
        } else {
            atomicOr(&s_union[cur_w], bits);
        }
    }
    __device__ __forceinline__ void add(unsigned* s_union, int cid) {
        if ((cid >> 5) != cur_w) {
            if (bits) flush(s_union);
            cur_w = cid >> 5;
            bits = 0u;
        }
        bits |= 1u << (cid & 31);
    }
    // the walk has ended
    __device__ __forceinline__ void finish(unsigned* s_union) {
        if (bits) flush(s_union);
    }
};

}  // namespace rk
