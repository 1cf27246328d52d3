// Closest hit of every ray against every triangle in Woop form, for
// Hopper (sm_90a).
//
// Replaces raypt/kernels/dense_pallas.py: pallas_closest_dense (:84, body
// _kernel :37), the kernel of the `pallas` backend. Contract: wu, wv, ww
// are (3, T) and cu, cv, cw (1, T) f32, the rows of each triangle's map M
// and offset c; ro, rd (R, 3) and t0 (R,) f32. For each ray and triangle,
// o' = M o + c and d' = M d; where |d'_w| > 1e-12, t = -o'_w / d'_w, u =
// o'_u + t d'_u, v = o'_v + t d'_v, and a hit needs u, v >= 0, u + v <= 1
// and t > 0. Out: t (R,) f32, the smallest hit t strictly below t0 (else
// t0), and face (R,) int32, the lowest triangle index at that t (-1 when
// no hit beat t0). The Pallas kernel's chunk merge (smallest t and lowest
// index within a chunk, strictly smaller across chunks) is the same as
// this one ascending scan with a strict `<`. Operation order as the
// Pallas kernel's: o'_u = ((o_x wu0 + o_y wu1) + o_z wu2) + cu, d'_u =
// (d_x wu0 + d_y wu1) + d_z wu2; built with -fmad=false and IEEE
// division, so the plain version in kernels/dense_pallas.py matches bit
// for bit.
//
// What bounds it on this card: operations. Every ray is tested against
// every triangle that can hit, ~49 f32 operations a pair and no
// multiply-add; the bytes are a few per ray and 48 per triangle, read
// once per block from L2.
//
// What the design does about it:
//   * A triangle whose ww row is all zero (either sign: the table's
//     padding to a multiple of tri_chunk, and degenerate faces, which get
//     zero maps) is never tested: d'_w is +-0 (or nan) for every ray, so
//     no ray can hit it. A pre-pass (pack_live_kernel, one block) lists
//     the other triangles in ascending index with a block scan, wherever
//     the zero rows sit, as rows of three float4 (wu0, wu1, wu2, cu),
//     (wv0, wv1, wv2, cv), (ww0, ww1, ww2, cw), with their indices. A ray
//     keeps the position of its best triangle in that list; the ascending
//     order makes the lowest position the lowest index, so the tie rule
//     and the face ids stay those of the whole table.
//   * The main kernel stages kStage listed triangles at a time in shared
//     memory with cp.async from the contiguous rows, double-buffered: the
//     next stage is copied while this one is tested, one barrier a stage.
//   * Each thread takes kRays rays, which share each staged triangle's
//     three 16-byte broadcast loads, and kSplit neighbouring threads share
//     a group of rays, each testing every kSplit-th triangle; their (t,
//     position) are reduced by shuffles under the same rule. A block
//     holds kThreads / kSplit * kRays = 128 rays; the split measured 3%
//     faster than none at the same rays and threads.
//   * kCull = 1 builds a pre-test (may_hit) that forms o'_w and d'_w first
//     and skips the rest of a test when no ray of the thread can hit the
//     triangle below its best t. python -m raypt_torch.kernels.sweep
//     measures it: it pays where a warp's rays are coherent (a bounce of
//     primary rays) and loses more where they are not, so the package
//     builds without it.
// The constants are the sweep's choice on the bench scene's wavefronts.
// The TPU kernel's six (R, 3) x (3, T) MXU products and its two lane
// reductions per chunk have no counterpart: a thread keeps its rays in
// registers and their best hits as running minima.
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "cluster_test.cuh"

namespace {

// The main kernel's design (python -m raypt_torch.kernels.sweep builds
// variants of these constants)
constexpr int kThreads = 128;   // threads a block
constexpr int kRays = 4;        // rays a thread
constexpr int kStage = 256;     // triangles a stage
constexpr int kSplit = 4;       // threads sharing a group of rays
constexpr int kCull = 0;        // 1: the pre-test may_hit before the rest

constexpr int kPackThreads = 1024;

// Lists the triangles whose ww row is not all zero in ascending index:
// rows[3k .. 3k + 2] the k-th one's three float4, id[k] its index, *n_live
// their count. One block.
__global__ void __launch_bounds__(kPackThreads)
pack_live_kernel(const float* __restrict__ wu, const float* __restrict__ wv,
                 const float* __restrict__ ww, const float* __restrict__ cu,
                 const float* __restrict__ cv, const float* __restrict__ cw,
                 long long n_tris, float4* __restrict__ rows,
                 int* __restrict__ id, int* __restrict__ n_live) {
    __shared__ int s_scan[33];
    int n = 0;
    for (long long base = 0; base < n_tris; base += kPackThreads) {
        const long long g = base + threadIdx.x;
        float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
        if (g < n_tris) {
            w0 = ww[g];
            w1 = ww[n_tris + g];
            w2 = ww[2 * n_tris + g];
        }
        const bool keep = !(w0 == 0.0f && w1 == 0.0f && w2 == 0.0f);
        int total;
        const long long at = n + rk::block_exclusive_scan(keep, s_scan, &total);
        if (keep) {
            rows[at * 3] = make_float4(wu[g], wu[n_tris + g], wu[2 * n_tris + g], cu[g]);
            rows[at * 3 + 1] = make_float4(wv[g], wv[n_tris + g], wv[2 * n_tris + g],
                                           cv[g]);
            rows[at * 3 + 2] = make_float4(w0, w1, w2, cw[g]);
            id[at] = (int)g;
        }
        n += total;
    }
    if (threadIdx.x == 0) *n_live = n;
}

// Whether a triangle whose o'_w, d'_w are ow, dw for a ray can pass the
// test below that ray's best t, tb. A hit needs |d'_w| > 1e-12 and t =
// -ow / dw > 0, so ow nonzero and of the sign opposite dw's; and t < tb,
// which the correctly rounded division gives only where the exact
// quotient is below tb (tb is a float), that is where |ow| - tb |dw| < 0
// exactly: the fused multiply-add rounds that difference once, which
// keeps its sign (a positive result means a positive difference). A
// triangle this rejects fails the test, so the result is the same.
__device__ __forceinline__ bool may_hit(float ow, float dw, float tb) {
    return fabsf(dw) > 1e-12f && ow != 0.0f &&
           (__float_as_int(ow) ^ __float_as_int(dw)) < 0 &&
           !(__fmaf_rn(-tb, fabsf(dw), fabsf(ow)) > 0.0f);
}

// kRays rays of the thread's group: ray h is first + g + h * groups.
__global__ void __launch_bounds__(kThreads)
closest_dense_kernel(const float4* __restrict__ rows, const int* __restrict__ id,
                     const int* __restrict__ n_live_p, const float* __restrict__ ro,
                     const float* __restrict__ rd, const float* __restrict__ t0,
                     float* __restrict__ t_out, int* __restrict__ face_out,
                     long long r) {
    constexpr int kGroups = kThreads / kSplit;
    static_assert(kThreads % kSplit == 0 && 32 % kSplit == 0, "split in a warp");
    __shared__ float4 s_tri[2][kStage * 3];
    const int n_live = *n_live_p;
    const int tid = threadIdx.x;
    const int part = tid % kSplit, g = tid / kSplit;
    const long long first = (long long)blockIdx.x * kGroups * kRays;
    bool in[kRays];
    rk::Ray ray[kRays];
    float tb[kRays];
    int pb[kRays];   // position of the best triangle in the list, or -1
#pragma unroll
    for (int h = 0; h < kRays; ++h) {
        const long long i = first + g + h * kGroups;
        in[h] = i < r;
        const long long q = in[h] ? i : first;
        ray[h] = rk::load_ray(ro, rd, q);
        tb[h] = t0[q];
        pb[h] = -1;
    }
    if (n_live > 0)
        rk::stage_async(rows, s_tri[0], min(kStage, n_live) * 3, kThreads);
    for (int s = 0, base = 0; base < n_live; ++s, base += kStage) {
        rk::stage_wait();
        __syncthreads();   // stage s staged; stage s - 1's buffer free
        if (base + kStage < n_live)
            rk::stage_async(rows + (long long)(base + kStage) * 3, s_tri[(s + 1) & 1],
                            min(kStage, n_live - base - kStage) * 3, kThreads);
        const float4* tri = s_tri[s & 1];
        const int n = min(kStage, n_live - base);
        for (int j = part; j < n; j += kSplit) {
            const float4 a = tri[j * 3], b = tri[j * 3 + 1], c = tri[j * 3 + 2];
            float ow[kRays], dw[kRays];
            bool maybe[kRays], any = false;
#pragma unroll
            for (int h = 0; h < kRays; ++h) {
                const rk::Ray& q = ray[h];
                ow[h] = ((q.ox * c.x + q.oy * c.y) + q.oz * c.z) + c.w;
                dw[h] = (q.dx * c.x + q.dy * c.y) + q.dz * c.z;
                maybe[h] = !kCull || may_hit(ow[h], dw[h], tb[h]);
                any |= maybe[h];
            }
            if (!any) continue;
#pragma unroll
            for (int h = 0; h < kRays; ++h) {
                const rk::Ray& q = ray[h];
                const float ou = ((q.ox * a.x + q.oy * a.y) + q.oz * a.z) + a.w;
                const float ov = ((q.ox * b.x + q.oy * b.y) + q.oz * b.z) + b.w;
                const float du = (q.dx * a.x + q.dy * a.y) + q.dz * a.z;
                const float dv = (q.dx * b.x + q.dy * b.y) + q.dz * b.z;
                const float t = -ow[h] / dw[h];
                const float u = ou + t * du;
                const float v = ov + t * dv;
                if (maybe[h] && fabsf(dw[h]) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                    u + v <= 1.0f && t > 0.0f && t < tb[h]) {
                    tb[h] = t;
                    pb[h] = base + j;
                }
            }
        }
    }
    if constexpr (kSplit > 1) {
        // the smallest t, then the lowest position: a miss keeps t0, and
        // a hit is strictly below it, so equal t pairs two hits or two misses
        for (int off = kSplit >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int h = 0; h < kRays; ++h) {
                const float t2 = __shfl_xor_sync(0xffffffffu, tb[h], off);
                const int p2 = __shfl_xor_sync(0xffffffffu, pb[h], off);
                if (t2 < tb[h] || (t2 == tb[h] && p2 < pb[h])) {
                    tb[h] = t2;
                    pb[h] = p2;
                }
            }
        }
    }
    if (part != 0) return;
#pragma unroll
    for (int h = 0; h < kRays; ++h) {
        if (!in[h]) continue;
        const long long i = first + g + h * kGroups;
        t_out[i] = tb[h];
        face_out[i] = pb[h] >= 0 ? id[pb[h]] : -1;
    }
}

}  // namespace

// wu, wv, ww: (3, n_tris); cu, cv, cw: (1, n_tris); ro, rd: (r, 3); t0,
// t_out, face_out: (r,); r a multiple of 256. Scratch: rows (n_tris, 12)
// f32, id (n_tris,) and n_live (1,) int32, 16-byte aligned.
extern "C" int rk_closest_dense(const float* wu, const float* wv, const float* ww,
                                const float* cu, const float* cv, const float* cw,
                                long long n_tris, const float* ro, const float* rd,
                                const float* t0, float* t_out, int* face_out,
                                long long r, float* rows, int* id, int* n_live,
                                void* stream) {
    if (r % 256 || r < 0 || n_tris < 0 || n_tris >= (1LL << 31) ||
        (uintptr_t)rows % 16)
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    float4* rows4 = reinterpret_cast<float4*>(rows);
    pack_live_kernel<<<1, kPackThreads, 0, s>>>(wu, wv, ww, cu, cv, cw, n_tris, rows4,
                                                id, n_live);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    constexpr long long kBlockRays = (long long)kThreads / kSplit * kRays;
    closest_dense_kernel<<<(unsigned)((r + kBlockRays - 1) / kBlockRays), kThreads,
                           0, s>>>(rows4, id, n_live, ro, rd, t0, t_out, face_out, r);
    return (int)cudaGetLastError();
}
