// Per-ray-exact closest hit against the clusters in each ray's mask, for
// Hopper (sm_90a).
//
// Replaces raypt/kernels/cluster_expand.py: pallas_cluster_expand (:246,
// body _kernel_expand :111). Contract: for each ray, visit the set bits
// of its (cwp, R) mask column in ascending cluster id (bits >= C are
// dropped, the guard at cluster_expand.py:274-282) and Moller-Trumbore
// test the cluster's L triangles from the (C, L, 12) table
// [p0, e1, e2, face id bits, 0, 0] with cluster_test.cuh's test, which
// is _test_cluster's (raypt/kernels/cluster_pallas.py:52-69) in its
// order, built with -fmad=false. Merge: the cluster's
// smallest t, then the lowest face id among its triangles with that t;
// the ray's carry (seeded with `seed`, face -1) takes it only when
// strictly smaller. That is the lexicographic minimum over (t, cluster
// id, face id) in which the seed wins every tie.
//
// What bounds it on this card: the triangle tests, ~60 f32 operations
// for each of L triangles of each wanted cluster (384 per cluster on the
// bench path), issued one lane per test. One thread per ray walking its
// own mask (the first port) ran the lanes of a warp that want different
// clusters one after another: ~30% of the lanes did useful work.
//
// What the design does about it: rays are regrouped by cluster inside
// a block, the Hopper counterpart of the TPU kernel's lane regrouping
// (rank, one-hot selection matmuls, split3_bf16 transport). A block owns
// kThreads rays of one walk tile, one a thread, and their carries in
// shared memory. It ORs its live rays' masks into its own union (reading
// only the words union_pp marks nonzero) and visits the union's clusters
// in ascending id. For each, it stages the cluster's 48 L bytes in
// shared memory with cp.async, double-buffered so that the next cluster
// loads during this one's tests, and lists the rays that want it (a
// block scan of the mask bits). The list's tests are spread over all
// threads: m listed rays take kThreads / m threads each (above a warp of
// rays; below, kThreads / m' with m' the power of two above m), which
// split the L triangles; the lanes of a warp test different rays
// against the same triangle, a shared-memory broadcast. The partial
// (t, face) folds are reduced in shared memory by the within-cluster
// key, which the order of the reduction cannot change, and each listed
// ray's carry takes the cluster with the strict rule. A ray whose seed
// is not > 0 (a dead ray is seeded -BIG) joins no list: every candidate
// t lies in (0, inf], so nothing could replace its seed. The test takes
// the reciprocal's fast path (cluster_test.cuh). Blocks of 256 rays ran
// faster on the card than blocks of 512, 1,024 or 2,048, whose longer
// lists split less but whose blocks are fewer and heavier.
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "cluster_test.cuh"

namespace {

constexpr int kThreads = 256;    // rays a block owns, one a thread
constexpr int kRayTile = 2048;   // rays per union_pp row (onehot_walk.cu)
static_assert(kRayTile % kThreads == 0, "a block lies in one walk tile");

// Shared memory: two staged clusters (2 * 3L float4), then the rays'
// carries, the list, the partial folds, the scan's and the union's words.
size_t smem_bytes(int leaf, int cw) {
    return (size_t)leaf * 3 * 2 * sizeof(float4) + (size_t)kThreads * 5 * sizeof(int) +
           33 * sizeof(int) + (size_t)cw * sizeof(unsigned);
}

// (t, f) takes (t2, f2) when it is lexicographically smaller: the
// within-cluster rule of rk::test_triangle, for merging partial folds.
__device__ __forceinline__ void fold_min(float t2, int f2, float& t, int& f) {
    if (t2 < t || (t2 == t && f2 < f)) {
        t = t2;
        f = f2;
    }
}

// Tests the m rays of s_list (block-local ids) against the staged
// cluster and merges it into their carries with the strict rule.
__device__ void test_list(const float4* tri, int leaf, const int* s_list, int m,
                          const float* __restrict__ ro,
                          const float* __restrict__ rd, long long base,
                          float* s_t, int* s_f, float* s_pt, int* s_pf) {
    // thread tid tests ray slot `slot` against triangles part, part +
    // parts, ...: parts = kThreads / m above a warp of rays; below, m is
    // rounded up to a power of two m', parts = kThreads / m', and the
    // partial folds reduce as a tree
    const int tid = threadIdx.x;
    const int lg = m > 1 ? 32 - __clz(m - 1) : 0;   // m' = 1 << lg >= m
    const bool wide = m > 32;
    const int stride = wide ? m : 1 << lg;
    const int slot = wide ? tid % m : tid & ((1 << lg) - 1);
    const int part = wide ? tid / m : tid >> lg;
    const int parts = kThreads / stride;
    float tmin[1] = {rk::kBig};
    int fmin[1] = {rk::kBigI};
    int id = 0;
    if (slot < m && part < parts) {
        id = s_list[slot];
        const rk::Ray ray[1] = {rk::load_ray(ro, rd, base + id)};
        rk::fold_cluster(tri + part * 3, tri + leaf * 3, parts * 3, ray, tmin, fmin);
    }
    float t = tmin[0];
    int f = fmin[0];
    if (parts > 1) {   // uniform across the block
        s_pt[tid] = t;
        s_pf[tid] = f;
        __syncthreads();
        if (wide) {   // at most 7 partials a ray
            if (tid < m)
                for (int p = 1; p < parts; ++p)
                    fold_min(s_pt[tid + p * m], s_pf[tid + p * m], t, f);
        } else {
            for (int h = kThreads >> 1; h >= stride; h >>= 1) {
                if (tid < h) {
                    fold_min(s_pt[tid + h], s_pf[tid + h], t, f);
                    s_pt[tid] = t;
                    s_pf[tid] = f;
                }
                __syncthreads();
            }
        }
    }
    if (part == 0 && slot < m && t < s_t[id]) {
        s_t[id] = t;
        s_f[id] = f;
    }
}

__global__ void __launch_bounds__(kThreads, 4)
cluster_expand_kernel(const int* __restrict__ mask, const int* __restrict__ union_pp,
                      const float* __restrict__ rows, int c_total, int leaf,
                      const float* __restrict__ ro, const float* __restrict__ rd,
                      const float* __restrict__ seed, float* __restrict__ t_out,
                      int* __restrict__ face_out, long long r, int cwp) {
    extern __shared__ float4 smem[];
    const int l3 = leaf * 3;
    const int cw = (c_total + 31) / 32;
    float4* s_tri = smem;                                       // 2 * l3
    float* s_t = reinterpret_cast<float*>(smem + 2 * l3);       // kThreads
    int* s_f = reinterpret_cast<int*>(s_t + kThreads);          // kThreads
    int* s_list = s_f + kThreads;                               // kThreads
    float* s_pt = reinterpret_cast<float*>(s_list + kThreads);  // kThreads
    int* s_pf = reinterpret_cast<int*>(s_pt + kThreads);        // kThreads
    int* s_scan = s_pf + kThreads;                              // 33
    unsigned* s_union = reinterpret_cast<unsigned*>(s_scan + 33);   // cw

    const int tid = threadIdx.x;
    const long long base = (long long)blockIdx.x * kThreads;
    const long long i = base + tid;   // the thread's ray
    const int* tile_union = union_pp + base / kRayTile * cwp;
    const float sd = seed[i];
    const bool live = sd > 0.0f;   // false for -BIG and nan seeds
    s_t[tid] = sd;
    s_f[tid] = -1;
    for (int w = tid; w < cw; w += kThreads) s_union[w] = 0u;
    __syncthreads();
    for (int w = 0; w < cw; ++w) {
        if (tile_union[w] == 0) continue;   // uniform across the block
        const unsigned v = __reduce_or_sync(
            0xffffffffu, live ? (unsigned)mask[w * r + i] : 0u);
        if ((tid & 31) == 0 && v) atomicOr(&s_union[w], v);   // a bit set
    }
    __syncthreads();

    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    rk::BitWalk walk([=](int w) { return s_union[w]; }, cw, c_total);
    int c = walk.next();
    if (c >= 0) rk::stage_async(rows4 + (long long)c * l3, s_tri, l3, kThreads);
    int cur_w = -1;
    unsigned bits = 0u;   // the thread's mask word cur_w
    for (int k = 0; c >= 0; ++k) {
        if ((c >> 5) != cur_w) {
            cur_w = c >> 5;
            bits = live ? (unsigned)mask[cur_w * r + i] : 0u;
        }
        const int want = (bits >> (c & 31)) & 1u;
        int m;
        const int pos = rk::block_exclusive_scan(want, s_scan, &m);
        if (want) s_list[pos] = tid;
        rk::stage_wait();
        __syncthreads();   // cluster k staged, the list written
        const int next = walk.next();
        if (next >= 0)
            rk::stage_async(rows4 + (long long)next * l3, s_tri + ((k + 1) & 1) * l3,
                            l3, kThreads);
        test_list(s_tri + (k & 1) * l3, leaf, s_list, m, ro, rd, base, s_t, s_f, s_pt,
                  s_pf);
        __syncthreads();   // the list and cluster k's buffer are free again
        c = next;
    }
    t_out[i] = s_t[tid];
    face_out[i] = s_f[tid];
}

}  // namespace

extern "C" int rk_cluster_expand(const int* mask, const int* union_pp,
                                 const float* rows, int c_total, int leaf,
                                 const float* ro, const float* rd,
                                 const float* seed, float* t_out, int* face_out,
                                 long long r, int cwp, void* stream) {
    if (r % kRayTile || cwp * 32 < c_total || leaf <= 0 || c_total < 0)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = smem_bytes(leaf, (c_total + 31) / 32);
    if (const cudaError_t e = cudaFuncSetAttribute(
            cluster_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem))
        return (int)e;
    cluster_expand_kernel<<<(unsigned)(r / kThreads), kThreads, smem,
                            (cudaStream_t)stream>>>(
        mask, union_pp, rows, c_total, leaf, ro, rd, seed, t_out, face_out, r, cwp);
    return (int)cudaGetLastError();
}
