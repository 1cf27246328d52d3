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
// every triangle, ~49 f32 operations a pair and no multiply-add; the
// bytes are a few per ray and 48 per triangle, read once per block from
// L2.
//
// What the design does about it: one thread per ray, 256-thread blocks.
// The block stages kStage triangles at a time in shared memory, 12
// floats as three float4 (24 KB), and every thread reads each triangle
// as a broadcast, three 16-byte shared loads. The TPU kernel's six
// (R, 3) x (3, T) MXU products and its two lane reductions per chunk have
// no counterpart: a thread keeps its ray in registers and its best hit
// as a running minimum.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 512;   // triangles staged in shared memory per step

__global__ void __launch_bounds__(kThreads)
closest_dense_kernel(const float* __restrict__ wu, const float* __restrict__ wv,
                     const float* __restrict__ ww, const float* __restrict__ cu,
                     const float* __restrict__ cv, const float* __restrict__ cw,
                     long long n_tris, const float* __restrict__ ro,
                     const float* __restrict__ rd, const float* __restrict__ t0,
                     float* __restrict__ t_out, int* __restrict__ face_out) {
    // triangle j of a stage: (wu0, wu1, wu2, cu), (wv0, wv1, wv2, cv),
    // (ww0, ww1, ww2, cw)
    __shared__ float4 s_tri[kStage * 3];
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    const float ox = ro[i * 3], oy = ro[i * 3 + 1], oz = ro[i * 3 + 2];
    const float dx = rd[i * 3], dy = rd[i * 3 + 1], dz = rd[i * 3 + 2];
    float tb = t0[i];
    int fb = -1;
    for (long long base = 0; base < n_tris; base += kStage) {
        const int n = (int)min((long long)kStage, n_tris - base);
        __syncthreads();   // every thread is done with the previous stage
        for (int j = threadIdx.x; j < n; j += kThreads) {
            const long long g = base + j;
            s_tri[j * 3] = make_float4(wu[g], wu[n_tris + g], wu[2 * n_tris + g], cu[g]);
            s_tri[j * 3 + 1] = make_float4(wv[g], wv[n_tris + g], wv[2 * n_tris + g], cv[g]);
            s_tri[j * 3 + 2] = make_float4(ww[g], ww[n_tris + g], ww[2 * n_tris + g], cw[g]);
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float4 a = s_tri[j * 3], b = s_tri[j * 3 + 1], c = s_tri[j * 3 + 2];
            const float ou = ((ox * a.x + oy * a.y) + oz * a.z) + a.w;
            const float ov = ((ox * b.x + oy * b.y) + oz * b.z) + b.w;
            const float ow = ((ox * c.x + oy * c.y) + oz * c.z) + c.w;
            const float du = (dx * a.x + dy * a.y) + dz * a.z;
            const float dv = (dx * b.x + dy * b.y) + dz * b.z;
            const float dw = (dx * c.x + dy * c.y) + dz * c.z;
            if (!(fabsf(dw) > 1e-12f)) continue;
            const float t = -ow / dw;
            const float u = ou + t * du;
            const float v = ov + t * dv;
            if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < tb) {
                tb = t;
                fb = (int)(base + j);
            }
        }
    }
    t_out[i] = tb;
    face_out[i] = fb;
}

}  // namespace

// wu, wv, ww: (3, n_tris); cu, cv, cw: (1, n_tris); ro, rd: (r, 3); t0,
// t_out, face_out: (r,); r a multiple of 256.
extern "C" int rk_closest_dense(const float* wu, const float* wv, const float* ww,
                                const float* cu, const float* cv, const float* cw,
                                long long n_tris, const float* ro, const float* rd,
                                const float* t0, float* t_out, int* face_out,
                                long long r, void* stream) {
    if (r % kThreads || r < 0 || n_tris < 0 || n_tris >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    closest_dense_kernel<<<(unsigned)(r / kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(
        wu, wv, ww, cu, cv, cw, n_tris, ro, rd, t0, t_out, face_out);
    return (int)cudaGetLastError();
}
