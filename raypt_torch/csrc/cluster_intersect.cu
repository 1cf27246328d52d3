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
//     skipped, and a repeated id is tested again;
//   * pallas_cluster_intersect_grouped (:183, body _kernel_grouped :154):
//     the worklist kernel with group > 1, which visits min(counts, cap)
//     rounded up to a multiple of group, at most cap, slots. On the TPU
//     grouping amortised scalar loop bookkeeping over independent test
//     chains; here it has no such reason, and exists for its contract: a
//     valid id in a slot past counts but within the last group is tested.
// And, with its own rules, raypt/accel/clusters.py::intersect_worklist_jnp
// (:318), the XLA worklist test of the onehot finder's non-fused branch,
// of the cluster finder's overflow fallback and of find_closest_cluster(
// use_pallas=False): each tile tests its rays against every one of the
// cap slots of its worklist, in slot order, whatever the counts; a -1
// slot tests nothing (contract: ids lie in [-1, C), as both worklist
// builders emit them; the kernel skips any id outside [0, C), and the
// wrapper does not check, which would cost a host sync); a miss counts
// +inf, and within a cluster the first lane of the smallest t wins.
// The Moller-Trumbore test is cluster_test.cuh's (the (C, L, 12) table),
// whose order is also intersect_worklist_jnp's cross/dot form.
// Merge: the cluster's smallest t, then the lowest face id (Woop: lane;
// the worklist test: the first lane) among its triangles with that t;
// the ray's carry (seeded with `seed`, face -1) takes it only when
// strictly smaller.
//
// What bounds it on this card: the triangle tests, ~57 flops (Moller-
// Trumbore) or ~56 (Woop: six 4-term sums, a division, u, v and the
// tests) for each of L triangles of each cluster for each ray of the
// tile (the union or worklist is per tile) that can change the result:
// only its live rays. ~70 instructions each without fused multiply-adds.
// The table is read once per tile and cluster (6 KB at leaf 128, 3 KB at
// leaf 64) and stays in L2.
//
// What the design does about it: one block per tile. The cluster loop
// is uniform across the block, so no warp diverges on which cluster to
// test: the block stages the cluster's 48 L bytes in shared memory and
// every thread reads each triangle as a broadcast.
//   * All five kernels are one template, union_kernel<Test, Source>, over
//     the test (MtTest, WoopTest, WorklistTest: MtTest under the first-
//     lane rule) and over where a tile's cluster ids come from
//     (UnionSource: rk::BitWalk over the union's set bits, ascending;
//     ListSource: rk::ListWalk over the worklist's slots, in list order,
//     the group's rounding included; SlotSource: rk::ListWalk over all cap
//     slots). Each does only work that can change
//     the result. A ray whose seed is not > 0 (a dead ray is seeded -BIG)
//     keeps its seed and id -1 untested: every candidate t lies in (0,
//     inf], so nothing could replace it. The live rays are packed to the
//     low slots of shared memory by a block scan, so warps are whole-live
//     or idle; each thread takes kRays rays, which share each triangle's
//     shared loads; the next cluster is staged with cp.async
//     (double-buffered) while this one is tested, one barrier a cluster.
//     The worklist instance keeps the mask kernel's constants (MtTest:
//     every other setting measured slower). A tile with few live
//     rays is latency-bound: one warp would walk all L triangles of
//     each cluster. So the Woop kernel spreads each live ray's triangles
//     over as many threads as the tile has to spare (up to kMaxSplit,
//     consecutive lanes of a warp) and reduces their (t, id) by
//     shuffles, which keeps the rule: the lowest lane wins a tie.
//   * The Woop test reads four lanes' coefficients with one 16-byte
//     shared load (the table is lane-minor) where L % 4 == 0.
//   * All three Moller-Trumbore kernels take the reciprocal's fast path
//     (cluster_test.cuh).
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

// One ray's fold of a cluster into its carry: the strict rule.
__device__ __forceinline__ void merge(float tmin, int fmin, float& tb, int& fb) {
    if (tmin < tb) {
        tb = tmin;
        fb = fmin;
    }
}

// The tests. fold<N>(tri, leaf, c, part, split, rays, t,
// id) gives each of the N rays (smallest t, its id) over the staged
// cluster c's triangles part, part + split, ... (groups of V lanes for
// the Woop test): the id is the face id (MtTest) or packed = c * L +
// lane (WoopTest), and over all parts the smallest (t, id) is the
// cluster's result under its rule. kThreads threads a tile, kRays rays
// a thread; a tile with few live rays spreads each ray's triangles over
// up to kMaxSplit threads (1: never).
struct MtTest {   // the (C, L, 12) rows, cluster_test.cuh
    static constexpr int kThreads = 128;
    static constexpr int kRays = 2;
    static constexpr int kMinBlocks = 6;
    static constexpr int kMaxSplit = 1;
    template <int N>
    __device__ static __forceinline__ void fold(const float4* tri, int leaf, int,
                                                int part, int split,
                                                const rk::Ray (&r)[N],
                                                float (&t)[N], int (&id)[N]) {
        rk::fold_cluster(tri + part * 3, tri + leaf * 3, 3 * split, r, t, id);
    }
};

// intersect_worklist_jnp's test: MtTest's arithmetic and schedule under
// its tie rule (a miss is +inf, the first lane of the smallest t wins).
struct WorklistTest {
    static constexpr int kThreads = MtTest::kThreads;
    static constexpr int kRays = MtTest::kRays;
    static constexpr int kMinBlocks = MtTest::kMinBlocks;
    static constexpr int kMaxSplit = 1;
    template <int N>
    __device__ static __forceinline__ void fold(const float4* tri, int leaf, int,
                                                int, int, const rk::Ray (&r)[N],
                                                float (&t)[N], int (&id)[N]) {
        rk::fold_cluster<N, rk::Tie::kFirstLane>(tri, tri + leaf * 3, 3, r, t, id);
    }
};

// V of a row's consecutive lanes from shared memory (one 16-byte load
// for four).
template <int V>
__device__ __forceinline__ void load_lanes(const float* p, float (&a)[V]) {
    if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        a[0] = q.x;
        a[1] = q.y;
        a[2] = q.z;
        a[3] = q.w;
    } else {
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] = p[v];
    }
}

// Row r (0: u, 1: v, 2: w) of lanes j .. j + V - 1 of a staged Woop
// table for N rays: o'[v][n] and d'[v][n], the 4-term sums of
// _test_cluster_woop (kernels/cluster_pallas.py) in its order, the
// homogeneous terms a3 * 1 and a3 * 0 included. s_w[k * 3L + r * L + j]
// is the k-th coefficient of row r of triangle j.
template <int V, int N>
__device__ __forceinline__ void woop_row(const float* s_w, int leaf, int r, int j,
                                         const rk::Ray (&ray)[N],
                                         float (&o)[V][N], float (&d)[V][N]) {
    const float* p = s_w + r * leaf + j;
    const int l3 = 3 * leaf;
    float a0[V], a1[V], a2[V], a3[V];
    load_lanes<V>(p, a0);
    load_lanes<V>(p + l3, a1);
    load_lanes<V>(p + 2 * l3, a2);
    load_lanes<V>(p + 3 * l3, a3);
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
            o[v][n] = a0[v] * ray[n].ox + a1[v] * ray[n].oy + a2[v] * ray[n].oz +
                      a3[v] * 1.0f;
            d[v][n] = a0[v] * ray[n].dx + a1[v] * ray[n].dy + a2[v] * ray[n].dz +
                      a3[v] * 0.0f;
        }
    }
}

// The Woop test of the (C, 4, 3L) table (accel/clusters.py::
// build_woop_cm), V lanes at a time (V = 4 needs L % 4 == 0): t = -o'w /
// d'w (an IEEE division; parallel rays give +-inf or nan), u = o'u + t
// d'u, v = o'v + t d'v; a part's lanes in ascending order, so the lowest
// lane wins a tie.
template <int V>
struct WoopTest {
    static constexpr int kThreads = 512;
    static constexpr int kRays = 2;
    static constexpr int kMinBlocks = 2;
    static constexpr int kMaxSplit = 32;
    template <int N>
    __device__ static __forceinline__ void fold(const float4* tri, int leaf, int c,
                                                int part, int split,
                                                const rk::Ray (&r)[N],
                                                float (&tmin)[N], int (&id)[N]) {
        const float* s_w = reinterpret_cast<const float*>(tri);
        int lmin[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
            tmin[n] = rk::kBig;
            lmin[n] = 0;
        }
        for (int j = part * V; j < leaf; j += V * split) {
            float o[V][N], d[V][N], tq[V][N], u[V][N];
            woop_row<V, N>(s_w, leaf, 2, j, r, o, d);
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
                for (int n = 0; n < N; ++n) tq[v][n] = -o[v][n] / d[v][n];
            woop_row<V, N>(s_w, leaf, 0, j, r, o, d);
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
                for (int n = 0; n < N; ++n) u[v][n] = o[v][n] + tq[v][n] * d[v][n];
            woop_row<V, N>(s_w, leaf, 1, j, r, o, d);
#pragma unroll
            for (int v = 0; v < V; ++v) {
#pragma unroll
                for (int n = 0; n < N; ++n) {
                    const float vv = o[v][n] + tq[v][n] * d[v][n];
                    const bool hit = tq[v][n] > 0.0f && u[v][n] >= 0.0f &&
                                     vv >= 0.0f && u[v][n] + vv <= 1.0f;
                    const float t = hit ? tq[v][n] : rk::kBig;
                    if (t < tmin[n]) {
                        tmin[n] = t;
                        lmin[n] = j + v;
                    }
                }
            }
        }
#pragma unroll
        for (int n = 0; n < N; ++n) id[n] = c * leaf + lmin[n];
    }
};

// Where a tile's cluster ids come from. walk(tile, c_total) gives the
// block-uniform walk whose next() returns them in the order the tile
// tests them, -1 at the end.
struct UnionSource {   // the set bits of the tile's cw union words
    const int* unions;
    int cw;
    struct Word {
        const int* p;
        __device__ unsigned operator()(int w) const { return (unsigned)p[w]; }
    };
    __device__ rk::BitWalk<Word> walk(long long tile, int c_total) const {
        return rk::BitWalk<Word>(Word{unions + tile * cw}, cw, c_total);
    }
};

struct ListSource {   // the first slots of the tile's worklist of cap
    const int* worklist;
    const int* counts;
    int cap, group;
    // min(counts, cap) slots, rounded up to a multiple of group (at most
    // cap) when group > 1
    __device__ rk::ListWalk walk(long long tile, int c_total) const {
        int n = min(counts[tile], cap);
        if (group > 1) n = min((n + group - 1) / group * group, cap);
        return rk::ListWalk(worklist + tile * cap, n, c_total);
    }
};

struct SlotSource {   // every slot of the tile's worklist of cap
    const int* worklist;
    int cap;
    __device__ rk::ListWalk walk(long long tile, int c_total) const {
        return rk::ListWalk(worklist + tile * cap, cap, c_total);
    }
};

// Tests the block's n_live packed rays (s_ray, ids s_id in the tile)
// against every cluster of `walk` with N rays a thread, and
// writes each ray's (t, id). With kSplit, 2^log_split consecutive
// threads (within a warp) share the thread's rays, each testing every
// 2^log_split-th of a cluster's triangles, and their results are
// reduced by shuffles before the merge. Every thread of the block calls
// it.
template <class Test, int N, bool kSplit, class Walk>
__device__ __forceinline__ void test_union(
    Walk walk, const float4* __restrict__ rows4, int leaf, int n_live, int log_split,
    const float (*s_ray)[kTile], const int* s_id, float4* s_tri, long long first,
    float* __restrict__ t_out, int* __restrict__ id_out) {
    constexpr int kThreads = Test::kThreads;
    const int l3 = leaf * 3;
    const int tid = threadIdx.x;
    int c = walk.next();
    if (c >= 0) rk::stage_async(rows4 + (long long)c * l3, s_tri, l3, kThreads);
    __syncthreads();   // the packed rays are written

    // the thread's slots g + h * na (g: its group of 2^log_split threads);
    // a slot past the live rays repeats the first and is not written
    const int split = kSplit ? 1 << log_split : 1;
    const int part = kSplit ? tid & (split - 1) : 0;
    const int g = kSplit ? tid >> log_split : tid;
    const int na = (n_live + N - 1) / N;
    const bool active = g < na;
    // with kSplit a warp tests (and shuffles) together if any of it is active
    const bool run = kSplit ? ((tid & ~31) >> log_split) < na : active;
    int slot[N];
    bool own[N];
    rk::Ray rays[N];
    float tb[N];
    int fb[N];
#pragma unroll
    for (int h = 0; h < N; ++h) {
        own[h] = active && g + h * na < n_live;
        slot[h] = own[h] ? g + h * na : 0;
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
                            l3, kThreads);
        if (run) {   // one triangle's shared loads serve the thread's rays
            float ct[N];
            int cf[N];
            Test::template fold<N>(s_tri + (k & 1) * l3, leaf, c, part, split, rays,
                                   ct, cf);
            if constexpr (kSplit) {
                for (int off = split >> 1; off > 0; off >>= 1) {
#pragma unroll
                    for (int h = 0; h < N; ++h) {
                        const float t2 = __shfl_xor_sync(0xffffffffu, ct[h], off);
                        const int f2 = __shfl_xor_sync(0xffffffffu, cf[h], off);
                        if (t2 < ct[h] || (t2 == ct[h] && f2 < cf[h])) {
                            ct[h] = t2;
                            cf[h] = f2;
                        }
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < N; ++h) merge(ct[h], cf[h], tb[h], fb[h]);
        }
        c = next;
    }
#pragma unroll
    for (int h = 0; h < N; ++h) {
        if (!own[h] || part != 0) continue;
        t_out[first + s_id[slot[h]]] = tb[h];
        id_out[first + s_id[slot[h]]] = fb[h];
    }
}

// Each tile's live rays against every cluster `src` names for it (`Test`
// on the cluster's table), Test::kThreads threads a tile.
template <class Test, class Source>
__global__ void __launch_bounds__(Test::kThreads, Test::kMinBlocks)
union_kernel(Source src, const float* __restrict__ rows, int c_total, int leaf,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ seed, float* __restrict__ t_out,
             int* __restrict__ id_out) {
    constexpr int kRays = Test::kRays, kThreads = Test::kThreads;
    static_assert(kThreads * kRays >= kTile, "every live ray needs a slot");
    constexpr int kPack = (kTile + kThreads - 1) / kThreads;   // rays to pack
    extern __shared__ float4 s_tri[];   // two staged clusters, 2 * 3L
    __shared__ float s_ray[7][kTile];   // the live rays, packed: o, d, seed
    __shared__ int s_id[kTile];         // their ids in the tile
    __shared__ int s_scan[33];
    const int tid = threadIdx.x;
    const long long first = (long long)blockIdx.x * kTile;

    // pack the live rays (the tile's rays tid + h * kThreads)
    bool live[kPack];
    float sd[kPack];
    int n_live, cnt = 0;
#pragma unroll
    for (int h = 0; h < kPack; ++h) {
        const int k = tid + h * kThreads;
        const long long i = first + k;
        const bool in = kThreads * kPack == kTile || k < kTile;
        sd[h] = in ? seed[i] : 0.0f;
        live[h] = sd[h] > 0.0f;   // false for -BIG and nan seeds
        cnt += live[h];
        if (!live[h] && in) {
            t_out[i] = sd[h];
            id_out[i] = -1;
        }
    }
    int pos = rk::block_exclusive_scan(cnt, s_scan, &n_live);
    if (n_live == 0) return;   // uniform across the block
#pragma unroll
    for (int h = 0; h < kPack; ++h) {
        if (!live[h]) continue;
        const int k = tid + h * kThreads;
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
    int log_split = 0;   // uniform across the block: the widest split that
    if constexpr (Test::kMaxSplit > 1) {   // fits the live rays
        const int groups = (n_live + kRays - 1) / kRays;
        while ((2 << log_split) <= Test::kMaxSplit &&
               (groups << (log_split + 1)) <= kThreads)
            ++log_split;
    }
    test_union<Test, kRays, (Test::kMaxSplit > 1)>(
        src.walk(blockIdx.x, c_total), rows4, leaf, n_live, log_split, s_ray, s_id,
        s_tri, first, t_out, id_out);
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

// Launches union_kernel<Test, Source>: two staged clusters of dynamic
// shared memory a block, one block a tile.
template <class Test, class Source>
int launch_union(Source src, const float* rows, int c_total, int leaf,
                 const float* ro, const float* rd, const float* seed, float* t_out,
                 int* id_out, long long n_tiles, void* stream) {
    if (c_total <= 0 || leaf <= 0 || n_tiles < 0) return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    const size_t smem = (size_t)leaf * 3 * 2 * sizeof(float4);
    if (const cudaError_t e = cudaFuncSetAttribute(
            union_kernel<Test, Source>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem))
        return (int)e;
    union_kernel<Test, Source><<<(unsigned)n_tiles, Test::kThreads, smem,
                                 (cudaStream_t)stream>>>(src, rows, c_total, leaf, ro,
                                                         rd, seed, t_out, id_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rk_cluster_intersect_mask(const int* unions, int cw, const float* rows,
                                         int c_total, int leaf, const float* ro,
                                         const float* rd, const float* seed,
                                         float* t_out, int* face_out,
                                         long long n_tiles, void* stream) {
    if (cw <= 0) return (int)cudaErrorInvalidValue;
    return launch_union<MtTest>(UnionSource{unions, cw}, rows, c_total, leaf, ro, rd,
                                seed, t_out, face_out, n_tiles, stream);
}

// packed_out = cid * L + lane; four lanes a shared load where L % 4 == 0.
extern "C" int rk_cluster_intersect_mask_woop(const int* unions, int cw,
                                              const float* woop, int c_total,
                                              int leaf, const float* ro,
                                              const float* rd, const float* seed,
                                              float* t_out, int* packed_out,
                                              long long n_tiles, void* stream) {
    if (cw <= 0) return (int)cudaErrorInvalidValue;
    const UnionSource src{unions, cw};
    if (leaf % 4 == 0)
        return launch_union<WoopTest<4>>(src, woop, c_total, leaf, ro, rd, seed, t_out,
                                         packed_out, n_tiles, stream);
    return launch_union<WoopTest<1>>(src, woop, c_total, leaf, ro, rd, seed, t_out,
                                     packed_out, n_tiles, stream);
}

extern "C" int rk_cluster_intersect(const int* worklist, const int* counts, int cap,
                                    int group, const float* rows, int c_total,
                                    int leaf, const float* ro, const float* rd,
                                    const float* seed, float* t_out, int* face_out,
                                    long long n_tiles, void* stream) {
    if (cap <= 0 || group <= 0) return (int)cudaErrorInvalidValue;
    return launch_union<MtTest>(ListSource{worklist, counts, cap, group}, rows,
                                c_total, leaf, ro, rd, seed, t_out, face_out, n_tiles,
                                stream);
}

// intersect_worklist_jnp: every slot of the (n_tiles, cap) worklist,
// the first-lane rule; face_out -1 where no cluster won.
extern "C" int rk_intersect_worklist(const int* worklist, int cap, const float* rows,
                                     int c_total, int leaf, const float* ro,
                                     const float* rd, const float* seed, float* t_out,
                                     int* face_out, long long n_tiles, void* stream) {
    if (cap < 0) return (int)cudaErrorInvalidValue;
    return launch_union<WorklistTest>(SlotSource{worklist, cap}, rows, c_total, leaf,
                                      ro, rd, seed, t_out, face_out, n_tiles, stream);
}

extern "C" int rk_inv_det_sweep(float one, unsigned long long* mismatches,
                                unsigned* first_bad, void* stream) {
    inv_det_sweep_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(one, mismatches,
                                                                   first_bad);
    return (int)cudaGetLastError();
}
