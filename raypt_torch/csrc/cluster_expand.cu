// Per-ray-exact closest hit against the clusters in each ray's mask, for
// Hopper (sm_90a).
//
// Replaces raypt/kernels/cluster_expand.py: pallas_cluster_expand (:246,
// body _kernel_expand :111). Contract: for each ray, visit the set bits
// of its (cwp, R) mask column in ascending cluster id (bits >= C are
// dropped, the guard at cluster_expand.py:274-282) and Moller-Trumbore
// test the cluster's L triangles from the (C, L, 12) table
// [p0, e1, e2, face id bits, 0, 0]. The arithmetic is _test_cluster's
// (raypt/kernels/cluster_pallas.py:52-69) in its order; the build uses
// -fmad=false so no multiply-add is contracted. Merge: the cluster's
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

namespace {

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;   // rays per union_pp row (onehot_walk.cu)
static_assert(kRayTile % kThreads == 0, "a block lies in one walk tile");
constexpr float kBig = 1e30f;
constexpr int kBigI = 1 << 30;

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
    const float ox = ro[i * 3], oy = ro[i * 3 + 1], oz = ro[i * 3 + 2];
    const float dx = rd[i * 3], dy = rd[i * 3 + 1], dz = rd[i * 3 + 2];
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
            float tmin = kBig;
            int fmin = kBigI;
            for (int j = 0; j < leaf; ++j) {
                const float4 a = __ldg(tri + j * 3);
                const float4 b = __ldg(tri + j * 3 + 1);
                const float4 g = __ldg(tri + j * 3 + 2);
                const float p0x = a.x, p0y = a.y, p0z = a.z;
                const float e1x = a.w, e1y = b.x, e1z = b.y;
                const float e2x = b.z, e2y = b.w, e2z = g.x;
                const int fid = __float_as_int(g.y);
                const float pvx = dy * e2z - dz * e2y;
                const float pvy = dz * e2x - dx * e2z;
                const float pvz = dx * e2y - dy * e2x;
                const float det = e1x * pvx + e1y * pvy + e1z * pvz;
                const bool ok_det = fabsf(det) > 1e-8f;
                const float inv_det = (ok_det ? 1.0f : 0.0f) / (ok_det ? det : 1.0f);
                const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
                const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
                const float qvx = tvy * e1z - tvz * e1y;
                const float qvy = tvz * e1x - tvx * e1z;
                const float qvz = tvx * e1y - tvy * e1x;
                const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
                float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
                const bool hit = ok_det && u >= 0.0f && v >= 0.0f &&
                                 u + v <= 1.0f && t > 0.0f;
                if (!hit) t = kBig;
                if (t < tmin) {
                    tmin = t;
                    fmin = fid;
                } else if (t == tmin && fid < fmin) {
                    fmin = fid;
                }
            }
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
