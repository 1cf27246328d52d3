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
// strictly smaller.
//
// What bounds it on this card: the triangle tests, ~40 flops for each
// of L triangles of each wanted cluster (384 per cluster on the bench
// path), and warp divergence, since the rays of a warp want different
// clusters and different numbers of them. The table (0.8 MB on the
// icosphere stand-in at leaf 384) stays in L2.
//
// What the design does about it: one thread per ray; a triangle is
// three 16-byte read-only loads, broadcast within a warp when its rays
// want the same cluster, which pixel-block ray order makes common. The
// block reads its walk tile's union_pp row into shared memory and skips
// mask words that are zero for the whole tile (6 of 8 on the stand-in).
// Divergence is accepted here; regrouping rays by cluster is later
// work. The TPU kernel's in-kernel lane regrouping (rank, one-hot
// selection matmuls, split3_bf16 transport) has no counterpart.
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;   // rays per union_pp row (onehot_walk.cu)
static_assert(kRayTile % kThreads == 0, "a block lies in one walk tile");

__global__ void __launch_bounds__(kThreads)
cluster_expand_kernel(const int* __restrict__ mask, const int* __restrict__ union_pp,
                      const float* __restrict__ rows, int c_total, int leaf,
                      const float* __restrict__ ro, const float* __restrict__ rd,
                      const float* __restrict__ seed, float* __restrict__ t_out,
                      int* __restrict__ face_out, long long r, int cwp) {
    extern __shared__ int s_union[];   // cwp words of this block's walk tile
    const long long tile = ((long long)blockIdx.x * kThreads) / kRayTile;
    for (int w = threadIdx.x; w < cwp; w += kThreads)
        s_union[w] = union_pp[tile * cwp + w];
    __syncthreads();

    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    const rk::Ray ray = rk::load_ray(ro, rd, i);
    float tb = seed[i];
    int fb = -1;
    const int cw = (c_total + 31) / 32;
    const int tail = c_total & 31;
    for (int w = 0; w < cw; ++w) {
        if (s_union[w] == 0) continue;   // uniform across the block
        unsigned bits = (unsigned)mask[w * r + i];
        if (w == cw - 1 && tail) bits &= (1u << tail) - 1u;
        while (bits) {
            const int c = w * 32 + (__ffs(bits) - 1);
            bits &= bits - 1u;
            const float4* tri = reinterpret_cast<const float4*>(rows) +
                                (long long)c * leaf * 3;
            float tmin = rk::kBig;
            int fmin = rk::kBigI;
            for (int j = 0; j < leaf; ++j)
                rk::test_triangle(__ldg(tri + j * 3), __ldg(tri + j * 3 + 1),
                                  __ldg(tri + j * 3 + 2), ray, tmin, fmin);
            if (tmin < tb) {
                tb = tmin;
                fb = fmin;
            }
        }
    }
    t_out[i] = tb;
    face_out[i] = fb;
}

}  // namespace

extern "C" int rk_cluster_expand(const int* mask, const int* union_pp,
                                 const float* rows, int c_total, int leaf,
                                 const float* ro, const float* rd,
                                 const float* seed, float* t_out, int* face_out,
                                 long long r, int cwp, void* stream) {
    if (r % kRayTile || cwp * 32 < c_total || leaf <= 0)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const size_t smem = (size_t)cwp * 4;
    cluster_expand_kernel<<<(unsigned)(r / kThreads), kThreads, smem,
                            (cudaStream_t)stream>>>(
        mask, union_pp, rows, c_total, leaf, ro, rd, seed, t_out, face_out, r, cwp);
    return (int)cudaGetLastError();
}
