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
// only its live rays, and for the worklist test only the (ray, cluster)
// pairs its cull keeps, plus the cull itself. ~70 instructions each
// without fused multiply-adds.
// The table is read once per tile and cluster (6 KB at leaf 128, 3 KB at
// leaf 64) and stays in L2.
//
// What the design does about it: one block per tile. The cluster loop
// is uniform across the block, so no warp diverges on which cluster to
// test: the block stages the cluster's 48 L bytes in shared memory and
// every thread reads each triangle as a broadcast.
//   * The mask, list, grouped and Woop kernels are one template,
//     union_kernel<Test, Source>, over the test (MtTest, WoopTest) and
//     over where a tile's cluster ids come from (UnionSource: rk::BitWalk
//     over the union's set bits, ascending; ListSource: rk::ListWalk over
//     the worklist's slots, in list order, the group's rounding included).
//     The worklist test (worklist_cull_kernel, below) takes its ids from
//     SlotSource: rk::ListWalk over all cap slots. Each does only work
//     that can change the result. A ray whose seed is not > 0 (a dead ray
//     is seeded -BIG) keeps its seed and id -1 untested: every candidate t
//     lies in (0, inf], so nothing could replace it. The live rays are
//     packed to the low slots of shared memory by a block scan, so warps
//     are whole-live or idle; each thread takes kRays rays, which share
//     each triangle's shared loads; the next cluster is staged with
//     cp.async (double-buffered) while this one is tested, one barrier a
//     cluster. A tile with few live rays is latency-bound: one warp would
//     walk all L triangles of each cluster. So the Woop kernel spreads
//     each live ray's triangles over as many threads as the tile has to
//     spare (up to kMaxSplit, consecutive lanes of a warp) and reduces
//     their (t, id) by shuffles, which keeps the rule: the lowest lane
//     wins a tie.
//   * The Woop test reads four lanes' coefficients with one 16-byte
//     shared load (the table is lane-minor) where L % 4 == 0.
//   * All three Moller-Trumbore kernels take the reciprocal's fast path
//     (cluster_test.cuh).
//   * The worklist test (intersect_worklist) is redesigned around a
//     per-ray cluster cull (worklist_cull.cuh derives its bound).
//     On the incoherent bounces a tile's worklist holds most clusters
//     while one ray can hit few, and the test (65.5 SASS a triangle
//     under -fmad=false) already ran near its instruction-rate floor,
//     so the gain must come from testing fewer pairs. A pre-pass (cull_prep_kernel,
//     a warp a cluster) derives each cluster's box, normal cone and
//     bound scalars from the rows on every call; worklist_cull_kernel
//     then culls each (live ray, cluster) pair with the box grown by the
//     test's error radius (far fewer operations than the 128 x 65.5 SASS
//     of a cluster's tests it saves), lists the kept rays with a block
//     scan, so no warp carries a skipped ray, and tests only them: the work is
//     dealt out evenly as items of (a kept ray, one of kCullChunks chunks
//     of the triangles), chunk-major so that a warp's threads read the
//     same triangles, and each item's (t, lane) goes into the ray's
//     64-bit key in shared memory by atomicMin (t's bits above the lane:
//     the least key is the smallest t, then the first lane). Giving each
//     kept ray's triangles to a power-of-two group of threads, reduced by
//     shuffles, left up to half the block idle when just over 128 rays
//     were kept and measured 11-37% slower. The carry lives in shared
//     memory; the keys are folded into it after the next barrier, so the
//     merge stays in slot order: a skipped pair had nothing the strict
//     merge could take, so the result is unchanged.
//     A may_hit pre-test, a per-triangle branch inside a warp, measured
//     slower: some ray of the warp nearly always went on. Here the cull
//     is per pair and ahead of the tests.
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
#include "worklist_cull.cuh"

namespace {

constexpr int kTile = 256;

// The worklist test's design (the sweep builds the other settings): the
// cull skips the (ray, cluster) pairs whose grown box the ray misses
// (worklist_cull.cuh), and with kCullCarry 1 also those whose grown box
// it meets only beyond its carry. The kept rays' tests are dealt out over
// the block as items of (kCullRays kept rays, one of kCullChunks chunks
// of the cluster's triangles) (test_chunks); kCullMinBlocks: the launch
// bound's blocks an SM.
constexpr int kCullCarry = 1;
constexpr int kCullRays = 1;
constexpr int kCullChunks = 8;
constexpr int kCullMinBlocks = 6;

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

// ---- the worklist test (intersect_worklist), behind the cull ----

constexpr int kPrepThreads = 128;   // four clusters a block, a warp each

// A warp's reduction of v by op; every lane gets lane 0's result, so the
// lanes agree bit for bit whatever order the butterfly took.
template <class T, class Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
    for (int off = 16; off > 0; off >>= 1)
        v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
    return __shfl_sync(0xffffffffu, v, 0);
}

// One row of the (C, L, 12) table as the pre-pass reads it: p0, e1, e2 in
// f32, the f64 normal e1 x e2 (each product of f32 values exact), its
// length and the edges', whether a value is not finite or past
// kCoordLimit (wild), and whether it can pass |det| > 1e-8.
struct PrepTri {
    float p[3], a[3], b[3];
    double n[3], nn, na, nb;
    bool wild, pass;
};

__device__ __forceinline__ PrepTri prep_tri(const float* __restrict__ row) {
    PrepTri t;
    t.wild = false;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        t.p[i] = row[i];
        t.a[i] = row[3 + i];
        t.b[i] = row[6 + i];
        t.wild |= !(fabsf(t.p[i]) <= rk::cull::kCoordLimit) ||
                  !(fabsf(t.a[i]) <= rk::cull::kCoordLimit) ||
                  !(fabsf(t.b[i]) <= rk::cull::kCoordLimit);
    }
    const double a0 = t.a[0], a1 = t.a[1], a2 = t.a[2];
    const double b0 = t.b[0], b1 = t.b[1], b2 = t.b[2];
    t.n[0] = a1 * b2 - a2 * b1;
    t.n[1] = a2 * b0 - a0 * b2;
    t.n[2] = a0 * b1 - a1 * b0;
    t.nn = sqrt(t.n[0] * t.n[0] + t.n[1] * t.n[1] + t.n[2] * t.n[2]);
    t.na = sqrt(a0 * a0 + a1 * a1 + a2 * a2);
    t.nb = sqrt(b0 * b0 + b1 * b1 + b2 * b2);
    t.pass = !t.wild && rk::cull::can_pass(t.nn, t.na, t.nb);
    return t;
}

// The pre-pass: each cluster's record (worklist_cull.cuh: rk::cull::Field)
// from its rows as the test reads them, one warp a cluster. The box holds
// p0, p0 + e1 and p0 + e2 of the triangles that can pass |det| > 1e-8
// (the sums rounded outward); the cone's axis is the sum of their unit
// normals, each turned to the side of the first one's, and cos alpha the
// least |cos| between the axis as stored and a normal; s_min, E and E2
// over the same triangles, each rounded to the safe side.
__global__ void __launch_bounds__(kPrepThreads)
cull_prep_kernel(const float* __restrict__ rows, int c_total, int leaf,
                 float* __restrict__ recs) {
    namespace cl = rk::cull;
    const int c = blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
    if (c >= c_total) return;   // uniform across the warp
    const int lane = threadIdx.x & 31;
    const float* tri = rows + (long long)c * leaf * 12;
    float* rec = recs + (long long)c * cl::kRec;
    int first = 0x7fffffff;
    bool wild = false;
    for (int j = lane; j < leaf; j += 32) {
        const PrepTri t = prep_tri(tri + j * 12);
        wild |= t.wild;
        if (t.pass && j < first) first = j;
    }
    wild = __any_sync(0xffffffffu, wild);
    first = __reduce_min_sync(0xffffffffu, first);
    if (wild || first == 0x7fffffff) {   // never cull, or cull every ray
        if (lane < cl::kRec)
            rec[lane] = lane == cl::kState ? (wild ? 0.0f : -1.0f) : 0.0f;
        return;
    }
    const PrepTri ref = prep_tri(tri + first * 12);
    float lo[3], hi[3];
    double s[3] = {0.0, 0.0, 0.0}, smin = 1.0, e = 0.0, e2 = 0.0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        lo[i] = __int_as_float(0x7f800000);
        hi[i] = -lo[i];
    }
    for (int j = lane; j < leaf; j += 32) {
        const PrepTri t = prep_tri(tri + j * 12);
        if (!t.pass) continue;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            lo[i] = fminf(lo[i], fminf(t.p[i], fminf(__fadd_rd(t.p[i], t.a[i]),
                                                     __fadd_rd(t.p[i], t.b[i]))));
            hi[i] = fmaxf(hi[i], fmaxf(t.p[i], fmaxf(__fadd_ru(t.p[i], t.a[i]),
                                                     __fadd_ru(t.p[i], t.b[i]))));
        }
        if (t.nn > 0.0) {
            const double side =
                t.n[0] * ref.n[0] + t.n[1] * ref.n[1] + t.n[2] * ref.n[2] >= 0.0 ? 1.0
                                                                                 : -1.0;
#pragma unroll
            for (int i = 0; i < 3; ++i) s[i] += side * t.n[i] / t.nn;
        }
        smin = fmin(smin, t.nn / (t.na * t.nb));
        e = fmax(e, fmax(t.na, t.nb));
        e2 = fmax(e2, t.na * t.nb);
    }
    auto fmin_op = [](float x, float y) { return fminf(x, y); };
    auto fmax_op = [](float x, float y) { return fmaxf(x, y); };
    auto dsum = [](double x, double y) { return x + y; };
    auto dmin = [](double x, double y) { return fmin(x, y); };
    auto dmax = [](double x, double y) { return fmax(x, y); };
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        lo[i] = warp_reduce(lo[i], fmin_op);
        hi[i] = warp_reduce(hi[i], fmax_op);
        s[i] = warp_reduce(s[i], dsum);
    }
    smin = warp_reduce(smin, dmin);
    e = warp_reduce(e, dmax);
    e2 = warp_reduce(e2, dmax);
    const double len = sqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
    float ax[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        ax[i] = len > 0.0 ? (float)(s[i] / len) : (i == 0 ? 1.0f : 0.0f);
    const double axn = sqrt((double)ax[0] * ax[0] + (double)ax[1] * ax[1] +
                            (double)ax[2] * ax[2]);
    double ca = 1.0;
    for (int j = lane; j < leaf; j += 32) {
        const PrepTri t = prep_tri(tri + j * 12);
        if (!t.pass) continue;
        const double cosv =
            t.nn > 0.0
                ? fabs(t.n[0] * ax[0] + t.n[1] * ax[1] + t.n[2] * ax[2]) / (t.nn * axn)
                : 0.0;
        ca = fmin(ca, cosv);
    }
    ca = warp_reduce(ca, dmin);
    if (lane == 0) {
        const float ca_lo = __double2float_rd(fmax(0.0, ca - 0x1p-40));
        const double sa = sqrt(fmax(0.0, 1.0 - (double)ca_lo * (double)ca_lo));
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            rec[cl::kLo + i] = lo[i];
            rec[cl::kHi + i] = hi[i];
            rec[cl::kAxis + i] = ax[i];
        }
        rec[cl::kCa] = ca_lo;
        rec[cl::kSa] = __double2float_ru(fmin(1.0, sa + 0x1p-40));
        rec[cl::kSmin] = __double2float_rd(smin * (1.0 - 0x1p-40));
        rec[cl::kE] = __double2float_ru(e * (1.0 + 0x1p-40));
        rec[cl::kE2] = __double2float_ru(e2 * (1.0 + 0x1p-40));
        rec[cl::kState] = 1.0f;
        rec[15] = 0.0f;
    }
}

// One thread's fold of N rays over the staged cluster's triangles begin
// .. end - 1, in lane order: each ray's (smallest t, its first lane), a
// miss +inf (the worklist test's rule; the lane stands in the face id's
// place of rk::test_triangle).
template <bool kFast, int N>
__device__ __forceinline__ void fold_lanes(const float4* tri, int begin, int end,
                                           const rk::Ray (&r)[N], float (&t)[N],
                                           int (&lane)[N], bool& redo) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
        t[n] = rk::miss_t<rk::Tie::kFirstLane>();
        lane[n] = rk::kBigI;
    }
    for (int j = begin; j < end; ++j) {
        const float4 a = tri[3 * j], b = tri[3 * j + 1], g0 = tri[3 * j + 2];
        const float4 g = make_float4(g0.x, __int_as_float(j), g0.z, g0.w);
#pragma unroll
        for (int n = 0; n < N; ++n)
            rk::test_triangle<kFast, rk::Tie::kFirstLane>(a, b, g, r[n], t[n], lane[n],
                                                          redo);
    }
}

// fold_lanes with the reciprocal's fast path, and again with the exact
// one where a det needed it (rk::fold_cluster's rule).
template <int N>
__device__ __forceinline__ void fold_lanes_exact(const float4* tri, int begin, int end,
                                                 const rk::Ray (&r)[N], float (&t)[N],
                                                 int (&lane)[N]) {
    bool redo = false;
    fold_lanes<true>(tri, begin, end, r, t, lane, redo);
    if (redo) fold_lanes<false>(tri, begin, end, r, t, lane, redo);
}

constexpr int kCullThreads = 128;
constexpr int kCullPack = kTile / kCullThreads;   // packed rays a thread culls

// The kept rays of one cluster against its staged triangles as items of
// (kCullRays kept rays, one of kChunks chunks of the triangles), dealt
// out over the block chunk-major (a warp's threads mostly read the same
// triangles: broadcasts): each item's (t, lane) per ray goes into the
// ray's key in shared memory by a 64-bit atomicMin of t's bits above the
// lane, so the least key is the smallest t, then the first lane (t >= 0:
// its bits order as the floats). The keys are folded into the carries
// after the block's next barrier (fold_keys). Every thread calls it.
template <int kChunks>
__device__ __forceinline__ void test_chunks(const float4* tri, int leaf, int n_kept,
                                            const float (*s_ray)[kTile],
                                            const int* s_keep,
                                            unsigned long long* s_key) {
    constexpr int N = kCullRays;
    const int groups = (n_kept + N - 1) / N;
    const int span = (leaf + kChunks - 1) / kChunks;
    for (int i = threadIdx.x; i < groups * kChunks; i += kCullThreads) {
        const int chunk = i / groups, g = i - chunk * groups;
        int slot[N];
        bool own[N];
        rk::Ray r[N];
#pragma unroll
        for (int h = 0; h < N; ++h) {
            own[h] = g + h * groups < n_kept;
            slot[h] = s_keep[own[h] ? g + h * groups : g];
            const int q = slot[h];
            r[h] = {s_ray[0][q], s_ray[1][q], s_ray[2][q], s_ray[3][q], s_ray[4][q],
                    s_ray[5][q]};
        }
        float t[N];
        int lane[N];
        fold_lanes_exact<N>(tri, chunk * span, min(leaf, (chunk + 1) * span), r, t,
                            lane);
#pragma unroll
        for (int h = 0; h < N; ++h)
            if (own[h] && t[h] < rk::miss_t<rk::Tie::kFirstLane>())
                atomicMin(&s_key[slot[h]],
                          (unsigned long long)__float_as_uint(t[h]) << 32 |
                              (unsigned)lane[h]);
    }
}

// A thread's rays (packed slots tid + h * kCullThreads) kept in cluster
// c: each key of test_chunks folded into the ray's carry, the strict
// merge; the face id from the cluster's row in the table.
__device__ __forceinline__ void fold_keys(const bool (&kept)[kCullPack], int c,
                                          const float* __restrict__ rows, int leaf,
                                          const unsigned long long* s_key,
                                          float (*s_ray)[kTile], int* s_fb) {
#pragma unroll
    for (int h = 0; h < kCullPack; ++h) {
        if (!kept[h]) continue;
        const int q = threadIdx.x + h * kCullThreads;
        const unsigned long long key = s_key[q];
        const float t = __uint_as_float((unsigned)(key >> 32));
        if (key != ~0ull && t < s_ray[6][q]) {
            s_ray[6][q] = t;
            s_fb[q] = __float_as_int(
                __ldg(rows + ((long long)c * leaf + (unsigned)key) * 12 + 9));
        }
    }
}

// intersect_worklist_jnp over every slot of each tile's worklist, one
// block a tile, with the cull of worklist_cull.cuh (the box, and with
// kCarry the carry): for each slot's cluster, each live ray is
// culled against the cluster's record, the kept rays are listed in
// s_keep by a block scan and only they are tested (test_chunks), their
// keys folded into the carries after the next barrier (fold_keys), so
// the merge stays in slot order. With kAudit,
// audit[0] += live ray-cluster pairs, audit[1] += pairs kept, and every
// skipped pair is tested in full: audit[2] += those whose hit the merge
// would have taken (0 for a sound cull).
template <bool kCarry, bool kAudit>
__global__ void __launch_bounds__(kCullThreads, kCullMinBlocks)
worklist_cull_kernel(SlotSource src, const float* __restrict__ rows, int c_total,
                     int leaf, const float* __restrict__ recs,
                     const float* __restrict__ ro, const float* __restrict__ rd,
                     const float* __restrict__ seed, float* __restrict__ t_out,
                     int* __restrict__ id_out, unsigned long long* __restrict__ audit) {
    extern __shared__ float4 s_tri[];   // two staged clusters, 2 * 3L
    __shared__ float s_ray[7][kTile];   // the live rays, packed: o, d, carry t
    __shared__ int s_id[kTile];         // their ids in the tile
    __shared__ int s_fb[kTile];         // their carry's face
    __shared__ int s_keep[kTile];       // a cluster's kept rays (packed slots)
    __shared__ float s_inv[3][kTile];   // the rays' cull data
    __shared__ float s_dn[kTile], s_idn[kTile];
    __shared__ unsigned long long s_key[kTile];   // the kept rays' (t, lane)
    __shared__ int s_scan[33];
    const int tid = threadIdx.x;
    const long long first = (long long)blockIdx.x * kTile;

    // pack the live rays (the tile's rays tid + h * kCullThreads)
    bool live[kCullPack];
    float sd[kCullPack];
    int n_live, cnt = 0;
#pragma unroll
    for (int h = 0; h < kCullPack; ++h) {
        const long long i = first + tid + h * kCullThreads;
        sd[h] = seed[i];
        live[h] = sd[h] > 0.0f;   // false for -BIG and nan seeds
        cnt += live[h];
        if (!live[h]) {
            t_out[i] = sd[h];
            id_out[i] = -1;
        }
    }
    int pos = rk::block_exclusive_scan(cnt, s_scan, &n_live);
    if (n_live == 0) return;   // uniform across the block
#pragma unroll
    for (int h = 0; h < kCullPack; ++h) {
        if (!live[h]) continue;
        const int k = tid + h * kCullThreads;
        const long long i = first + k;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            s_ray[e][pos] = ro[i * 3 + e];
            s_ray[3 + e][pos] = rd[i * 3 + e];
        }
        s_ray[6][pos] = sd[h];
        s_fb[pos] = -1;
        s_id[pos++] = k;
    }
    __syncthreads();   // the packed rays are written
#pragma unroll
    for (int h = 0; h < kCullPack; ++h) {
        const int q = tid + h * kCullThreads;
        if (q >= n_live) continue;
        const rk::cull::RayData c = rk::cull::ray_data(
            s_ray[0][q], s_ray[1][q], s_ray[2][q], s_ray[3][q], s_ray[4][q], s_ray[5][q]);
        s_inv[0][q] = c.ix;
        s_inv[1][q] = c.iy;
        s_inv[2][q] = c.iz;
        s_dn[q] = c.dn;
        s_idn[q] = c.idn;
    }
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    const float4* recs4 = reinterpret_cast<const float4*>(recs);
    const int l3 = leaf * 3;
    rk::ListWalk walk = src.walk(blockIdx.x, c_total);
    int c = walk.next();
    if (c >= 0) rk::stage_async(rows4 + (long long)c * l3, s_tri, l3, kCullThreads);
    unsigned long long n_pairs = 0, n_kept_pairs = 0, n_bad = 0;
    bool kept_prev[kCullPack] = {};   // the rays whose keys are to fold
    int c_prev = 0;
    for (int k = 0; c >= 0; ++k) {
        rk::stage_wait();
        __syncthreads();   // cluster k staged; cluster k - 1's merges done
        fold_keys(kept_prev, c_prev, rows, leaf, s_key, s_ray, s_fb);
        const int next = walk.next();
        if (next >= 0)
            rk::stage_async(rows4 + (long long)next * l3, s_tri + ((k + 1) & 1) * l3, l3,
                            kCullThreads);
        const float4* tri = s_tri + (k & 1) * l3;
        float rec[rk::cull::kRec];
#pragma unroll
        for (int v = 0; v < rk::cull::kRec / 4; ++v) {
            const float4 x = __ldg(recs4 + (long long)c * (rk::cull::kRec / 4) + v);
            rec[4 * v] = x.x;
            rec[4 * v + 1] = x.y;
            rec[4 * v + 2] = x.z;
            rec[4 * v + 3] = x.w;
        }
        bool keep[kCullPack];
        int n_mine = 0;
#pragma unroll
        for (int h = 0; h < kCullPack; ++h) {
            const int q = tid + h * kCullThreads;
            keep[h] = false;
            if (q < n_live) {
                const rk::cull::RayData rdq{s_inv[0][q], s_inv[1][q], s_inv[2][q],
                                            s_dn[q], s_idn[q]};
                keep[h] = rk::cull::keep_pair<kCarry>(
                    s_ray[0][q], s_ray[1][q], s_ray[2][q], s_ray[3][q], s_ray[4][q],
                    s_ray[5][q], rdq, s_ray[6][q], rec);
            }
            n_mine += keep[h];
        }
        int n_kept;
        int at = rk::block_exclusive_scan(n_mine, s_scan, &n_kept);
#pragma unroll
        for (int h = 0; h < kCullPack; ++h) {
            if (!keep[h]) continue;
            s_keep[at++] = tid + h * kCullThreads;
            s_key[tid + h * kCullThreads] = ~0ull;
        }
        __syncthreads();   // s_keep and the keys are written
        if (n_kept > 0) test_chunks<kCullChunks>(tri, leaf, n_kept, s_ray, s_keep, s_key);
#pragma unroll
        for (int h = 0; h < kCullPack; ++h) kept_prev[h] = keep[h];
        c_prev = c;
        if constexpr (kAudit) {
            n_pairs += n_live;
            n_kept_pairs += n_kept;
#pragma unroll
            for (int h = 0; h < kCullPack; ++h) {
                const int q = tid + h * kCullThreads;
                if (q >= n_live || keep[h]) continue;
                const rk::Ray r1[1] = {{s_ray[0][q], s_ray[1][q], s_ray[2][q],
                                        s_ray[3][q], s_ray[4][q], s_ray[5][q]}};
                float t1[1];
                int l1[1];
                fold_lanes_exact<1>(tri, 0, leaf, r1, t1, l1);
                n_bad += t1[0] < s_ray[6][q];
            }
        }
        c = next;
    }
    __syncthreads();   // the last cluster's tests are done
    fold_keys(kept_prev, c_prev, rows, leaf, s_key, s_ray, s_fb);
#pragma unroll
    for (int h = 0; h < kCullPack; ++h) {
        const int q = tid + h * kCullThreads;
        if (q >= n_live) continue;
        t_out[first + s_id[q]] = s_ray[6][q];
        id_out[first + s_id[q]] = s_fb[q];
    }
    if constexpr (kAudit) {
        if (tid == 0) {
            atomicAdd(audit, n_pairs);
            atomicAdd(audit + 1, n_kept_pairs);
        }
        if (n_bad) atomicAdd(audit + 2, n_bad);
    }
}

// The pre-pass into recs (C x kRec floats), then the culled kernel.
template <bool kAudit>
int launch_cull(SlotSource src, const float* rows, int c_total, int leaf, float* recs,
                const float* ro, const float* rd, const float* seed, float* t_out,
                int* id_out, unsigned long long* audit, long long n_tiles,
                void* stream) {
    if (c_total <= 0 || leaf <= 0 || n_tiles < 0) return (int)cudaErrorInvalidValue;
    if (n_tiles == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    constexpr int kPer = kPrepThreads / 32;
    cull_prep_kernel<<<(unsigned)((c_total + kPer - 1) / kPer), kPrepThreads, 0, s>>>(
        rows, c_total, leaf, recs);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    auto kernel = worklist_cull_kernel<kCullCarry != 0, kAudit>;
    const size_t smem = (size_t)leaf * 3 * 2 * sizeof(float4);
    if (const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
        return (int)e;
    kernel<<<(unsigned)n_tiles, kCullThreads, smem, s>>>(src, rows, c_total, leaf, recs,
                                                         ro, rd, seed, t_out, id_out,
                                                         audit);
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
// the first-lane rule; face_out -1 where no cluster won. recs: scratch of
// C x 16 floats for the cull's pre-pass.
extern "C" int rk_intersect_worklist(const int* worklist, int cap, const float* rows,
                                     int c_total, int leaf, const float* ro,
                                     const float* rd, const float* seed, float* t_out,
                                     int* face_out, float* recs, long long n_tiles,
                                     void* stream) {
    if (cap < 0) return (int)cudaErrorInvalidValue;
    return launch_cull<false>(SlotSource{worklist, cap}, rows, c_total, leaf, recs, ro,
                              rd, seed, t_out, face_out, nullptr, n_tiles, stream);
}

// rk_intersect_worklist with the cull's audit: audit (3 counts, zeroed by
// the caller) += live ray-cluster pairs, pairs kept, and skipped pairs
// whose full test the merge would have taken (0 for a sound cull); recs
// holds the pre-pass's records after the call.
extern "C" int rk_intersect_worklist_audit(const int* worklist, int cap,
                                           const float* rows, int c_total, int leaf,
                                           const float* ro, const float* rd,
                                           const float* seed, float* t_out,
                                           int* face_out, float* recs,
                                           unsigned long long* audit, long long n_tiles,
                                           void* stream) {
    if (cap < 0) return (int)cudaErrorInvalidValue;
    return launch_cull<true>(SlotSource{worklist, cap}, rows, c_total, leaf, recs, ro,
                             rd, seed, t_out, face_out, audit, n_tiles, stream);
}

extern "C" int rk_inv_det_sweep(float one, unsigned long long* mismatches,
                                unsigned* first_bad, void* stream) {
    inv_det_sweep_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(one, mismatches,
                                                                   first_bad);
    return (int)cudaGetLastError();
}
