// Dense cluster intersection per 256-ray tile, for Hopper (sm_90a).
//
// Replaces raypt/kernels/cluster_pallas.py:
//   * pallas_cluster_intersect_mask (:331, body _kernel_mask :255): each
//     tile tests all its rays against every cluster whose bit is set in
//     the tile's (n_tiles, cw) union, in ascending cluster id; bits >= C
//     are dropped (the wrapper guard at :343-351, here for every word);
//   * pallas_cluster_intersect (:104, body _kernel :80): each tile tests
//     all its rays against the first min(counts[tile], cap) entries of
//     its (n_tiles, cap) worklist, in list order; ids outside [0, C) are
//     skipped.
// The triangle test is cluster_test.cuh's (the (C, L, 12) table). Merge:
// the cluster's smallest t, then the lowest face id among its triangles
// with that t; the ray's carry (seeded with `seed`, face -1) takes it
// only when strictly smaller.
//
// What bounds it on this card: the triangle tests, ~54 flops for each of
// L triangles of each cluster for each of the tile's 256 rays, whether
// or not the ray wanted the cluster (the union or worklist is per tile).
// The table is read once per tile and cluster (6 KB at leaf 128, 3 KB at
// leaf 64) and stays in L2.
//
// What the design does about it: one block of 256 threads per tile, one
// thread per ray. The cluster loop is uniform across the block, so no
// warp diverges on which cluster to test: the block stages the cluster's
// L rows in shared memory (48 L bytes: 6 KB at leaf 128, 18 KB at 384)
// and every thread reads each triangle as a broadcast. The TPU kernels'
// two-level word summary, de Bruijn bit scan and 8-tile SMEM blocks are
// TPU workarounds with no counterpart: here the scan is __ffs on the
// union word, which every thread reads from the same address.
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace {

constexpr int kTile = 256;

// Stages cluster c's rows in shared memory with the whole block, tests
// the thread's ray against each, and merges the cluster into (tb, fb).
// Every thread of the block calls it with the same c.
__device__ __forceinline__ void test_cluster(const float4* __restrict__ rows4,
                                             int c, int leaf, float4* s_tri,
                                             const rk::Ray& ray, float& tb,
                                             int& fb) {
    __syncthreads();   // the previous cluster's rows are read by all
    const float4* src = rows4 + (long long)c * leaf * 3;
    for (int k = threadIdx.x; k < leaf * 3; k += kTile) s_tri[k] = src[k];
    __syncthreads();
    float tmin = rk::kBig;
    int fmin = rk::kBigI;
    for (int j = 0; j < leaf; ++j)
        rk::test_triangle(s_tri[j * 3], s_tri[j * 3 + 1], s_tri[j * 3 + 2], ray,
                          tmin, fmin);
    if (tmin < tb) {
        tb = tmin;
        fb = fmin;
    }
}

__global__ void __launch_bounds__(kTile)
cluster_intersect_mask_kernel(const int* __restrict__ unions, int cw,
                              const float* __restrict__ rows, int c_total, int leaf,
                              const float* __restrict__ ro,
                              const float* __restrict__ rd,
                              const float* __restrict__ seed,
                              float* __restrict__ t_out, int* __restrict__ face_out) {
    extern __shared__ float4 s_tri[];   // leaf * 3
    const long long tile = blockIdx.x;
    const long long i = tile * kTile + threadIdx.x;
    const rk::Ray ray = rk::load_ray(ro, rd, i);
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    float tb = seed[i];
    int fb = -1;
    for (int w = 0; w < cw && w * 32 < c_total; ++w) {
        unsigned bits = (unsigned)unions[tile * cw + w];
        const int valid = c_total - w * 32;   // bits of this word naming clusters
        if (valid < 32) bits &= (1u << valid) - 1u;
        while (bits) {
            const int c = w * 32 + (__ffs(bits) - 1);
            bits &= bits - 1u;
            test_cluster(rows4, c, leaf, s_tri, ray, tb, fb);
        }
    }
    t_out[i] = tb;
    face_out[i] = fb;
}

__global__ void __launch_bounds__(kTile)
cluster_intersect_kernel(const int* __restrict__ worklist,
                         const int* __restrict__ counts, int cap,
                         const float* __restrict__ rows, int c_total, int leaf,
                         const float* __restrict__ ro, const float* __restrict__ rd,
                         const float* __restrict__ seed, float* __restrict__ t_out,
                         int* __restrict__ face_out) {
    extern __shared__ float4 s_tri[];   // leaf * 3
    const long long tile = blockIdx.x;
    const long long i = tile * kTile + threadIdx.x;
    const rk::Ray ray = rk::load_ray(ro, rd, i);
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    float tb = seed[i];
    int fb = -1;
    const int n = min(counts[tile], cap);
    for (int w = 0; w < n; ++w) {
        const int c = worklist[tile * cap + w];
        if (c < 0 || c >= c_total) continue;   // uniform across the block
        test_cluster(rows4, c, leaf, s_tri, ray, tb, fb);
    }
    t_out[i] = tb;
    face_out[i] = fb;
}

// Dynamic shared memory of one staged cluster, opted in above 48 KB.
template <typename K>
int prepare_smem(K kernel, int leaf, size_t* smem) {
    *smem = (size_t)leaf * 3 * sizeof(float4);
    if (*smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
}

}  // namespace

extern "C" int rk_cluster_intersect_mask(const int* unions, int cw, const float* rows,
                                         int c_total, int leaf, const float* ro,
                                         const float* rd, const float* seed,
                                         float* t_out, int* face_out,
                                         long long n_tiles, void* stream) {
    if (cw <= 0 || c_total <= 0 || leaf <= 0 || n_tiles < 0)
        return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem(cluster_intersect_mask_kernel, leaf, &smem)) return e;
    cluster_intersect_mask_kernel<<<(unsigned)n_tiles, kTile, smem,
                                    (cudaStream_t)stream>>>(
        unions, cw, rows, c_total, leaf, ro, rd, seed, t_out, face_out);
    return (int)cudaGetLastError();
}

extern "C" int rk_cluster_intersect(const int* worklist, const int* counts, int cap,
                                    const float* rows, int c_total, int leaf,
                                    const float* ro, const float* rd,
                                    const float* seed, float* t_out, int* face_out,
                                    long long n_tiles, void* stream) {
    if (cap <= 0 || c_total <= 0 || leaf <= 0 || n_tiles < 0)
        return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem(cluster_intersect_kernel, leaf, &smem)) return e;
    cluster_intersect_kernel<<<(unsigned)n_tiles, kTile, smem, (cudaStream_t)stream>>>(
        worklist, counts, cap, rows, c_total, leaf, ro, rd, seed, t_out, face_out);
    return (int)cudaGetLastError();
}
