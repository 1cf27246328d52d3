// Alive compaction of a ray wavefront and its inverse, for Hopper (sm_90a).
//
// Replaces raypt/kernels/compact.py: pallas_alive_compact (:180, body
// _kernel_compact :79) and pallas_alive_uncompact (:218, body
// _kernel_uncompact :118). Contract: within each `group`-lane block,
// the stable alive-first permutation; lane i goes to pa(i) when alive
// and to na + (i - pa(i)) when dead (pa = alive lanes before i, na =
// the group's alive count). Uncompaction gathers out[i] = y[dest(i)]
// with dest recomputed from the same original alive mask.
//
// What bounds it on this card: memory traffic. A compaction moves 29
// bytes per lane (ro, rd, t0, alive) in and out; an uncompaction 17
// (the mask, t and face in, t and face out). At R = 2^20 that is ~60
// and ~18 MB, ~18 and ~5 us at 3.35 TB/s. The rank is a few integer ops
// per lane; what it needs from outside the lane's own chunk is two
// numbers, the alive lanes of its group before the chunk and in the
// whole group.
//
// What the design does about it, in both directions: the work is spread
// over the whole card, one block per kChunk-lane chunk of a group (4,096
// blocks for a 2^20-ray wavefront at chunks of 256, whatever the group;
// a group that is not a multiple of the chunk ends in a partial chunk;
// one block a group would give the bench path's groups of 32,768 lanes
// 32 blocks for 132 SMs, each ranking its group's 32 chunks one after
// another, as the uncompaction's first design did). A
// block needs its chunk's carry (the alive lanes of the group's chunks
// before it) and the group's count na:
//   * two passes (kTwoPass = 1): a count kernel, one warp a chunk, sums
//     each chunk's alive bytes (16-byte loads and __dp4a where the group
//     is a multiple of 16 lanes and the mask 16-byte aligned, byte loads
//     else) into a scratch int the wrapper allocates; the main kernel
//     sums its group's chunk counts, split at its own chunk;
//   * recount (kTwoPass = 0): no count pass; each block sums its whole
//     group's alive bytes itself (mostly from L2), split at its chunk.
// Then a block scan (block_scan.cuh) ranks the chunk's lanes
// (chunk_lane), and each thread moves its lane: the compaction's reads
// and the uncompaction's writes are coalesced, and the other side
// scatters only inside the group. `python -m raypt_torch.kernels.sweep
// --kernels compact uncompact` builds and times the designs: for the
// compaction two passes at 256 were the fastest on the card (recounting
// at 256 next: its blocks read their group's mask from L2 many times
// over). The uncompaction has no count pass of its own where its
// caller passes the counts the compaction of the same mask and group
// left in its scratch (`counted`, the expand finder's flow): 17% faster
// on the card than counting again, and recounting in each block 69%
// slower.
// The TPU kernel's one-hot selection matmuls and split3_bf16 transport
// have no counterpart: a permutation here is plain loads and stores.
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The compaction's design, and the uncompaction's (the sweep builds the
// other settings)
constexpr int kChunk = 256;    // lanes a block ranks, one a thread
constexpr int kTwoPass = 1;    // 1: count pass, then move; 0: recount

static_assert(kChunk % 32 == 0 && kChunk <= 1024, "whole warps, one block");
static_assert(kChunk % 16 == 0, "a chunk boundary is a 16-byte boundary");
constexpr int kCountThreads = 256;   // the count kernel: one warp a chunk

// Alive bytes of alive[begin, end) taken by this thread: every `stride`
// th 16-byte word from `first` when vec (begin and end 16-byte aligned),
// else every stride-th byte; `split`: also those below it into *below.
__device__ __forceinline__ int alive_bytes(const uint8_t* __restrict__ alive,
                                           long long begin, long long end,
                                           long long split, int first,
                                           int stride, bool vec, int* below) {
    int all = 0, lo = 0;
    if (vec) {
        const uint4* a4 = reinterpret_cast<const uint4*>(alive + begin);
        const long long n = (end - begin) >> 4;
        for (long long k = first; k < n; k += stride) {
            const uint4 v = a4[k];
            int s = __dp4a(__vsetne4(v.x, 0u), 0x01010101u, 0u);
            s = __dp4a(__vsetne4(v.y, 0u), 0x01010101u, (unsigned)s);
            s = __dp4a(__vsetne4(v.z, 0u), 0x01010101u, (unsigned)s);
            s = __dp4a(__vsetne4(v.w, 0u), 0x01010101u, (unsigned)s);
            all += s;
            if (begin + 16 * k < split) lo += s;
        }
    } else {
        for (long long j = begin + first; j < end; j += stride) {
            const int s = alive[j] != 0;
            all += s;
            if (j < split) lo += s;
        }
    }
    *below = lo;
    return all;
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// Block sums of a and b, valid in every thread after the call (s holds
// 64 ints).
__device__ __forceinline__ void block_sum2(int* a, int* b, int* s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wa = warp_sum(*a), wb = warp_sum(*b);
    if (lane == 0) {
        s[warp] = wa;
        s[32 + warp] = wb;
    }
    __syncthreads();
    const int nw = blockDim.x >> 5;
    int ta = 0, tb = 0;
    for (int k = 0; k < nw; ++k) {
        ta += s[k];
        tb += s[32 + k];
    }
    *a = ta;
    *b = tb;
}

// The count pass: counts[q] = alive lanes of chunk q (chunk c of group
// g is q = g * cpg + c), one warp a chunk.
__global__ void __launch_bounds__(kCountThreads)
chunk_count_kernel(const uint8_t* __restrict__ alive, int* __restrict__ counts,
                   int group, int cpg, long long n_chunks, bool vec) {
    const long long q = ((long long)blockIdx.x * kCountThreads + threadIdx.x) >> 5;
    if (q >= n_chunks) return;   // uniform across the warp
    const long long g = q / cpg;
    const int c = (int)(q - g * cpg);
    const long long begin = g * group + (long long)c * kChunk;
    const long long end = g * group + min((long long)group,
                                          (long long)(c + 1) * kChunk);
    int unused;
    const int n = warp_sum(alive_bytes(alive, begin, end, begin,
                                       threadIdx.x & 31, 32, vec, &unused));
    if ((threadIdx.x & 31) == 0) counts[q] = n;
}

// The lane of this thread in the block's chunk of its group (block
// blockIdx.x is chunk c of group g): its carry and na, from the count
// pass's counts (kTwoPass) or from the group's alive bytes, then the
// chunk's ranks. Sets the lane's source and destination lanes; false for
// a thread past the end of its group. Every thread of the block calls
// it.
__device__ __forceinline__ bool chunk_lane(const uint8_t* __restrict__ alive,
                                           const int* __restrict__ counts,
                                           int group, int cpg, bool vec,
                                           long long* src, long long* dst) {
    __shared__ int s_sum[64];
    __shared__ int s_warp[33];
    const long long g = (long long)blockIdx.x / cpg;
    const int c = (int)(blockIdx.x - g * cpg);
    const long long gbase = g * group;
    int carry, na;
    if constexpr (kTwoPass) {
        carry = 0;
        na = 0;
        for (int k = threadIdx.x; k < cpg; k += kChunk) {
            const int v = counts[g * cpg + k];
            na += v;
            if (k < c) carry += v;
        }
    } else {
        na = alive_bytes(alive, gbase, gbase + group,
                         gbase + (long long)c * kChunk, threadIdx.x, kChunk,
                         vec, &carry);
    }
    block_sum2(&carry, &na, s_sum);
    const int j = c * kChunk + threadIdx.x;   // the lane within its group
    const bool a = j < group && alive[gbase + j] != 0;
    int n;
    const int pa = carry + rk::block_exclusive_scan(a, s_warp, &n);
    *src = gbase + j;
    *dst = gbase + (a ? pa : na + (j - pa));
    return j < group;
}

// One block a chunk: each lane moved to its destination.
__global__ void __launch_bounds__(kChunk)
alive_compact_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                     const float* __restrict__ t0,
                     const uint8_t* __restrict__ alive,
                     const int* __restrict__ counts,
                     float* __restrict__ ro_out, float* __restrict__ rd_out,
                     float* __restrict__ t0_out, uint8_t* __restrict__ alive_out,
                     int group, int cpg, bool vec) {
    long long src, dst;
    if (!chunk_lane(alive, counts, group, cpg, vec, &src, &dst)) return;
    for (int k = 0; k < 3; ++k) {
        ro_out[dst * 3 + k] = ro[src * 3 + k];
        rd_out[dst * 3 + k] = rd[src * 3 + k];
    }
    t0_out[dst] = t0[src];
    alive_out[dst] = alive[src];
}

// One block a chunk: each lane fetched back from its destination.
__global__ void __launch_bounds__(kChunk)
alive_uncompact_kernel(const float* __restrict__ t, const int* __restrict__ face,
                       const uint8_t* __restrict__ alive,
                       const int* __restrict__ counts,
                       float* __restrict__ t_out, int* __restrict__ face_out,
                       int group, int cpg, bool vec) {
    long long src, dst;
    if (!chunk_lane(alive, counts, group, cpg, vec, &src, &dst)) return;
    t_out[src] = t[dst];
    face_out[src] = face[dst];
}

// The chunks of a launch (r / group groups of cpg chunks), checked; and
// the count pass where the design has one. Returns a CUDA error code.
int launch_counts(const uint8_t* alive, int* counts, long long r, int group,
                  bool count, cudaStream_t s, int* cpg, long long* n_chunks,
                  bool* vec) {
    if (group <= 0 || r % group) return (int)cudaErrorInvalidValue;
    *cpg = (group + kChunk - 1) / kChunk;
    *n_chunks = r / group * *cpg;
    if (*n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    *vec = group % 16 == 0 && ((uintptr_t)alive & 15) == 0;
    if (!count || *n_chunks == 0) return 0;
    constexpr int kPerBlock = kCountThreads / 32;
    chunk_count_kernel<<<(unsigned)((*n_chunks + kPerBlock - 1) / kPerBlock),
                         kCountThreads, 0, s>>>(alive, counts, group, *cpg,
                                                *n_chunks, *vec);
    return (int)cudaGetLastError();
}

}  // namespace

// counts: scratch of r / group * ceil(group / kChunk) ints (written by
// the count pass and read by the main kernel in the two-pass design).
extern "C" int rk_alive_compact(const float* ro, const float* rd, const float* t0,
                                const uint8_t* alive, float* ro_out, float* rd_out,
                                float* t0_out, uint8_t* alive_out, int* counts,
                                long long r, int group, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int cpg;
    long long n_chunks;
    bool vec;
    if (const int e = launch_counts(alive, counts, r, group, kTwoPass, s, &cpg,
                                    &n_chunks, &vec))
        return e;
    if (n_chunks == 0) return 0;
    alive_compact_kernel<<<(unsigned)n_chunks, kChunk, 0, s>>>(
        ro, rd, t0, alive, counts, ro_out, rd_out, t0_out, alive_out, group, cpg,
        vec);
    return (int)cudaGetLastError();
}

// counts: as rk_alive_compact's; counted: they already hold the counts
// that rk_alive_compact left for this mask and group, so the count pass
// is skipped.
extern "C" int rk_alive_uncompact(const float* t, const int* face,
                                  const uint8_t* alive, float* t_out, int* face_out,
                                  int* counts, int counted, long long r,
                                  int group, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int cpg;
    long long n_chunks;
    bool vec;
    if (const int e = launch_counts(alive, counts, r, group,
                                    kTwoPass && !counted, s, &cpg, &n_chunks,
                                    &vec))
        return e;
    if (n_chunks == 0) return 0;
    alive_uncompact_kernel<<<(unsigned)n_chunks, kChunk, 0, s>>>(
        t, face, alive, counts, t_out, face_out, group, cpg, vec);
    return (int)cudaGetLastError();
}

extern "C" const char* rk_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
