// Dense cluster intersection per 256-ray tile, for Hopper (sm_90a).
//
// Replaces raypt/kernels/cluster_pallas.py:
//   * pallas_cluster_intersect_mask (:331, body _kernel_mask :255): each
//     tile tests all its rays against every cluster whose bit is set in
//     the tile's (n_tiles, cw) union, in ascending cluster id; bits >= C
//     are dropped (the wrapper guard at :343-351, here for every word);
//   * pallas_cluster_intersect_mask_woop (:486, body _kernel_mask_woop
//     :399): the same scan with the Woop test of the (C, 4, 3L) affine
//     table (accel/clusters.py::build_woop_cm), returning packed =
//     cid * L + lane; within a cluster the lowest lane wins a tie;
//   * pallas_cluster_intersect (:104, body _kernel :80): each tile tests
//     all its rays against the first min(counts[tile], cap) entries of
//     its (n_tiles, cap) worklist, in list order; ids outside [0, C) are
//     skipped;
//   * pallas_cluster_intersect_grouped (:183, body _kernel_grouped :154):
//     the worklist kernel with group > 1, which visits min(counts, cap)
//     rounded up to a multiple of group, at most cap, slots. On the TPU
//     grouping amortised scalar loop bookkeeping over independent test
//     chains; here it has no such reason, and exists for its contract: a
//     valid id in a slot past counts but within the last group is tested.
// The Moller-Trumbore test is cluster_test.cuh's (the (C, L, 12) table).
// Merge: the cluster's smallest t, then the lowest face id (Woop: lane)
// among its triangles with that t; the ray's carry (seeded with `seed`,
// face -1) takes it only when strictly smaller.
//
// What bounds it on this card: the triangle tests, ~57 flops (Moller-
// Trumbore) or ~56 (Woop: six 4-term sums, a division, u, v and the
// tests) for each of L triangles of each cluster for each ray of the
// tile (the union or worklist is per tile), ~70 instructions each
// without fused multiply-adds. The table is read once per tile and
// cluster (6 KB at leaf 128, 3 KB at leaf 64) and stays in L2.
//
// What the design does about it: one block per tile. The cluster loop
// is uniform across the block, so no warp diverges on which cluster to
// test: the block stages the cluster's 48 L bytes in shared memory and
// every thread reads each triangle as a broadcast.
//   * The union kernel (Moller-Trumbore) does only work that can change
//     the result. A ray whose seed is not > 0 (a dead ray is seeded
//     -BIG) keeps its seed and face -1 untested: every candidate t lies
//     in (0, inf], so nothing could replace it. The live rays are packed
//     to the low slots of shared memory by a block scan, so warps are
//     whole-live or idle; 128 threads take two rays each (kRays), which
//     share each triangle's three shared loads (two ran faster on the
//     card than one or four); the next cluster is staged with cp.async
//     (double-buffered) while this one is tested, one barrier a cluster.
//   * All three Moller-Trumbore kernels take the reciprocal's fast path
//     (cluster_test.cuh).
//   * The Woop union kernel and the worklist kernel test every ray of the
//     tile with one thread a ray, staging each cluster between two
//     barriers.
// The TPU kernels' two-level word summary, de Bruijn bit scan and 8-tile
// SMEM blocks, and the Woop kernel's MXU contraction of (4, 3L) by
// (4, 2T) rays, are TPU devices with no counterpart: here the scan is
// __ffs on the union word, which every thread reads from the same
// address, and the Woop transform is 24 multiplies and adds a triangle in
// the thread's registers.
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "cluster_test.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kRays = 2;                   // the union kernel: rays a thread
constexpr int kMaskThreads = kTile / kRays;

// Stages cluster c's 48 L bytes (L * 3 float4: the L rows of the
// (C, L, 12) table, or the (4, 3L) Woop table) in shared memory with the
// whole block. Every thread of the block calls it with the same c.
__device__ __forceinline__ void stage_cluster(const float4* __restrict__ rows4,
                                              int c, int leaf, float4* s_tri) {
    __syncthreads();   // the previous cluster's rows are read by all
    const float4* src = rows4 + (long long)c * leaf * 3;
    for (int k = threadIdx.x; k < leaf * 3; k += kTile) s_tri[k] = src[k];
    __syncthreads();
}

// One ray's fold of a cluster into its carry: the strict rule.
__device__ __forceinline__ void merge(float tmin, int fmin, float& tb, int& fb) {
    if (tmin < tb) {
        tb = tmin;
        fb = fmin;
    }
}

// Tests the thread's ray against each staged triangle of cluster c
// (Moller-Trumbore) and merges the cluster into (tb, fb).
__device__ __forceinline__ void test_cluster(const float4* s_tri, int leaf,
                                             const rk::Ray& ray, float& tb,
                                             int& fb) {
    const rk::Ray r[1] = {ray};
    float tmin[1];
    int fmin[1];
    rk::fold_cluster(s_tri, s_tri + leaf * 3, 3, r, tmin, fmin);
    merge(tmin[0], fmin[0], tb, fb);
}

// The Woop test of each staged triangle of cluster c, s_w[k * 3L + r * L
// + j] the k-th coefficient of row r (u, v, w) of triangle j, in the
// operation order of _test_cluster_woop (kernels/cluster_pallas.py): the
// homogeneous terms a3 * 1 and a3 * 0 included. Merges packed = c * L +
// lane into (tb, pb).
__device__ __forceinline__ void test_cluster_woop(const float* s_w, int c,
                                                  int leaf, const rk::Ray& ray,
                                                  float& tb, int& pb) {
    const int l3 = 3 * leaf;
    float tmin = rk::kBig;
    int lmin = 0;
    for (int j = 0; j < leaf; ++j) {
        float o[3], d[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            const float* a = s_w + r * leaf + j;
            const float a0 = a[0], a1 = a[l3], a2 = a[2 * l3], a3 = a[3 * l3];
            o[r] = a0 * ray.ox + a1 * ray.oy + a2 * ray.oz + a3 * 1.0f;
            d[r] = a0 * ray.dx + a1 * ray.dy + a2 * ray.dz + a3 * 0.0f;
        }
        const float tq = -o[2] / d[2];   // parallel rays: +-inf or nan
        const float u = o[0] + tq * d[0];
        const float v = o[1] + tq * d[1];
        const bool hit = tq > 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
        const float t = hit ? tq : rk::kBig;
        if (t < tmin) {   // ascending lanes: the lowest lane wins a tie
            tmin = t;
            lmin = j;
        }
    }
    if (tmin < tb) {
        tb = tmin;
        pb = c * leaf + lmin;
    }
}

__global__ void __launch_bounds__(kMaskThreads, 6)
cluster_intersect_mask_kernel(const int* __restrict__ unions, int cw,
                              const float* __restrict__ rows, int c_total, int leaf,
                              const float* __restrict__ ro,
                              const float* __restrict__ rd,
                              const float* __restrict__ seed,
                              float* __restrict__ t_out, int* __restrict__ face_out) {
    extern __shared__ float4 s_tri[];   // two staged clusters, 2 * 3L
    __shared__ float s_ray[7][kTile];   // the live rays, packed: o, d, seed
    __shared__ int s_id[kTile];         // their ids in the tile
    __shared__ int s_scan[33];
    const int l3 = leaf * 3;
    const int tid = threadIdx.x;
    const long long first = (long long)blockIdx.x * kTile;

    // pack the live rays (the tile's rays tid + h * kMaskThreads)
    bool live[kRays];
    float sd[kRays];
    int n_live, cnt = 0;
#pragma unroll
    for (int h = 0; h < kRays; ++h) {
        const long long i = first + tid + h * kMaskThreads;
        sd[h] = seed[i];
        live[h] = sd[h] > 0.0f;   // false for -BIG and nan seeds
        cnt += live[h];
        if (!live[h]) {
            t_out[i] = sd[h];
            face_out[i] = -1;
        }
    }
    int pos = rk::block_exclusive_scan(cnt, s_scan, &n_live);
    if (n_live == 0) return;   // uniform across the block
#pragma unroll
    for (int h = 0; h < kRays; ++h) {
        if (!live[h]) continue;
        const int k = tid + h * kMaskThreads;
        const long long i = first + k;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            s_ray[e][pos] = ro[i * 3 + e];
            s_ray[3 + e][pos] = rd[i * 3 + e];
        }
        s_ray[6][pos] = sd[h];
        s_id[pos++] = k;
    }

    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    rk::BitWalk walk(
        [=](int w) { return (unsigned)unions[(long long)blockIdx.x * cw + w]; }, cw,
        c_total);
    int c = walk.next();
    if (c >= 0) rk::stage_async(rows4 + (long long)c * l3, s_tri, l3, kMaskThreads);
    __syncthreads();   // the packed rays are written

    // the thread's slots tid + h * na; a slot past the live rays repeats
    // the first and is not written
    const int na = (n_live + kRays - 1) / kRays;
    const bool active = tid < na;
    int slot[kRays];
    bool own[kRays];
    rk::Ray rays[kRays];
    float tb[kRays];
    int fb[kRays];
#pragma unroll
    for (int h = 0; h < kRays; ++h) {
        own[h] = active && tid + h * na < n_live;
        slot[h] = own[h] ? tid + h * na : 0;
        const int q = slot[h];
        rays[h] = {s_ray[0][q], s_ray[1][q], s_ray[2][q],
                   s_ray[3][q], s_ray[4][q], s_ray[5][q]};
        tb[h] = s_ray[6][q];
        fb[h] = -1;
    }
    for (int k = 0; c >= 0; ++k) {
        rk::stage_wait();
        __syncthreads();   // cluster k staged; cluster k - 1's buffer free
        const int next = walk.next();
        if (next >= 0)
            rk::stage_async(rows4 + (long long)next * l3, s_tri + ((k + 1) & 1) * l3,
                            l3, kMaskThreads);
        if (active) {   // one triangle's shared loads serve the thread's rays
            const float4* tri = s_tri + (k & 1) * l3;
            float ct[kRays];
            int cf[kRays];
            rk::fold_cluster(tri, tri + l3, 3, rays, ct, cf);
#pragma unroll
            for (int h = 0; h < kRays; ++h) merge(ct[h], cf[h], tb[h], fb[h]);
        }
        c = next;
    }
#pragma unroll
    for (int h = 0; h < kRays; ++h) {
        if (!own[h]) continue;
        t_out[first + s_id[slot[h]]] = tb[h];
        face_out[first + s_id[slot[h]]] = fb[h];
    }
}

__global__ void __launch_bounds__(kTile)
cluster_intersect_mask_woop_kernel(const int* __restrict__ unions, int cw,
                                   const float* __restrict__ woop, int c_total,
                                   int leaf, const float* __restrict__ ro,
                                   const float* __restrict__ rd,
                                   const float* __restrict__ seed,
                                   float* __restrict__ t_out,
                                   int* __restrict__ packed_out) {
    extern __shared__ float4 s_tri[];   // leaf * 3
    const long long tile = blockIdx.x;
    const long long i = tile * kTile + threadIdx.x;
    const rk::Ray ray = rk::load_ray(ro, rd, i);
    const float4* rows4 = reinterpret_cast<const float4*>(woop);
    float tb = seed[i];
    int fb = -1;
    for (int w = 0; w < cw && w * 32 < c_total; ++w) {
        unsigned bits = (unsigned)unions[tile * cw + w];
        const int valid = c_total - w * 32;   // bits of this word naming clusters
        if (valid < 32) bits &= (1u << valid) - 1u;
        while (bits) {
            const int c = w * 32 + (__ffs(bits) - 1);
            bits &= bits - 1u;
            stage_cluster(rows4, c, leaf, s_tri);
            test_cluster_woop(reinterpret_cast<const float*>(s_tri), c, leaf, ray, tb,
                              fb);
        }
    }
    t_out[i] = tb;
    packed_out[i] = fb;
}

// 1 / det as the kernels get it (rk::inv_det_of's fast path, and its
// exact path where the fast one asks for a redo) against the division of
// the Pallas kernel, (ok ? one : 0) / (ok ? det : 1) with one = 1 passed
// at run time, so that the compiler cannot fold it: for every one of the
// 2^32 bit patterns of det, the count of patterns whose results differ
// in any bit, and the lowest such pattern.
__global__ void inv_det_sweep_kernel(float one, unsigned long long* mismatches,
                                     unsigned* first_bad) {
    unsigned long long bad = 0;
    const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
    for (unsigned long long k = (unsigned long long)blockIdx.x * blockDim.x +
                                threadIdx.x;
         k < (1ull << 32); k += stride) {
        const float det = __uint_as_float((unsigned)k);
        const bool ok = fabsf(det) > 1e-8f;
        const float want = (ok ? one : 0.0f) / (ok ? det : 1.0f);
        bool redo = false;
        float got = rk::inv_det_of<true>(det, ok, redo);
        if (redo) got = rk::inv_det_of<false>(det, ok, redo);
        if (__float_as_uint(want) != __float_as_uint(got)) {
            ++bad;
            atomicMin(first_bad, (unsigned)k);
        }
    }
    if (bad) atomicAdd(mismatches, bad);
}

__global__ void __launch_bounds__(kTile)
cluster_intersect_kernel(const int* __restrict__ worklist,
                         const int* __restrict__ counts, int cap, int group,
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
    int n = min(counts[tile], cap);
    if (group > 1) n = min((n + group - 1) / group * group, cap);
    for (int w = 0; w < n; ++w) {
        const int c = worklist[tile * cap + w];
        if (c < 0 || c >= c_total) continue;   // uniform across the block
        stage_cluster(rows4, c, leaf, s_tri);
        test_cluster(s_tri, leaf, ray, tb, fb);
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

bool bad_mask_args(int cw, int c_total, int leaf, long long n_tiles) {
    return cw <= 0 || c_total <= 0 || leaf <= 0 || n_tiles < 0;
}

}  // namespace

extern "C" int rk_cluster_intersect_mask(const int* unions, int cw, const float* rows,
                                         int c_total, int leaf, const float* ro,
                                         const float* rd, const float* seed,
                                         float* t_out, int* face_out,
                                         long long n_tiles, void* stream) {
    if (bad_mask_args(cw, c_total, leaf, n_tiles)) return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    const size_t smem = (size_t)leaf * 3 * 2 * sizeof(float4);
    if (const cudaError_t e = cudaFuncSetAttribute(
            cluster_intersect_mask_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
        return (int)e;
    cluster_intersect_mask_kernel<<<(unsigned)n_tiles, kMaskThreads, smem,
                                    (cudaStream_t)stream>>>(
        unions, cw, rows, c_total, leaf, ro, rd, seed, t_out, face_out);
    return (int)cudaGetLastError();
}

extern "C" int rk_cluster_intersect_mask_woop(const int* unions, int cw,
                                              const float* woop, int c_total,
                                              int leaf, const float* ro,
                                              const float* rd, const float* seed,
                                              float* t_out, int* packed_out,
                                              long long n_tiles, void* stream) {
    if (bad_mask_args(cw, c_total, leaf, n_tiles)) return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem(cluster_intersect_mask_woop_kernel, leaf, &smem))
        return e;
    cluster_intersect_mask_woop_kernel<<<(unsigned)n_tiles, kTile, smem,
                                         (cudaStream_t)stream>>>(
        unions, cw, woop, c_total, leaf, ro, rd, seed, t_out, packed_out);
    return (int)cudaGetLastError();
}

extern "C" int rk_cluster_intersect(const int* worklist, const int* counts, int cap,
                                    int group, const float* rows, int c_total,
                                    int leaf, const float* ro, const float* rd,
                                    const float* seed, float* t_out, int* face_out,
                                    long long n_tiles, void* stream) {
    if (cap <= 0 || group <= 0 || c_total <= 0 || leaf <= 0 || n_tiles < 0)
        return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    size_t smem;
    if (const int e = prepare_smem(cluster_intersect_kernel, leaf, &smem)) return e;
    cluster_intersect_kernel<<<(unsigned)n_tiles, kTile, smem, (cudaStream_t)stream>>>(
        worklist, counts, cap, group, rows, c_total, leaf, ro, rd, seed, t_out,
        face_out);
    return (int)cudaGetLastError();
}

extern "C" int rk_inv_det_sweep(float one, unsigned long long* mismatches,
                                unsigned* first_bad, void* stream) {
    inv_det_sweep_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(one, mismatches,
                                                                   first_bad);
    return (int)cudaGetLastError();
}
