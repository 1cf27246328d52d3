// Skip-link walk of the packed LBVH table, for Hopper (sm_90a).
//
// Replaces an XLA loop, not a Pallas kernel: raypt/accel/packed.py:
// traverse_wavefront (:85-166), the `lax.while_loop` behind the `bvh`
// and `bvh2` backends. Contract: each live ray starts at node 0 with
// t_best = t0 and face -1 and, until its node is -1, reads its node's
// 64-byte row [bmin | bmax | - | left, skip, 0] or
// [p0 | e1 | e2 | face, skip, 1]; an internal row's slab test sends it to
// the left child on a hit and to the skip link otherwise, a leaf row's
// Moller-Trumbore test replaces (t_best, face) when t is strictly
// smaller, then the ray follows the skip link. A dead ray keeps t0 and
// face -1 and reads nothing. max_steps >= 0 cuts a walk after that many
// steps (the JAX loop's max_iters * unroll); -1 walks to the end.
//
// Every operation is the plain torch version's (raypt_torch/accel/
// packed.py: traverse_wavefront), in its order: the reciprocal
// direction with components below 1e-12 clamped, the slab's
// subtractions and products, min / max that propagate NaN (as
// torch.minimum / jnp.minimum do; fminf / fmaxf would drop a NaN), the
// cross products ay*bz - az*by, the three-term sums (x + y) + z and the
// inverse determinant as a division. Built with -fmad=false and IEEE
// division, it is bitwise equal to the plain version on the card.
//
// What bounds it on this card: the dependent row loads of each step.
// A walk is a chain: a step's row address is the previous step's link,
// so a ray waits one L2 round trip a step. The table (11.5 MB at 90,112
// slots) fits in the 50 MB L2. The arithmetic is ~45 f32 operations a
// step.
//
// What the design does about it: one thread walks one ray to its end,
// neighbouring rays (pixel-block order) in a warp, so the warp's lanes
// read the same rows near the root and the loads coalesce there; the row
// comes as four 16-byte loads through the read-only path; a leaf row's
// triangle test and an internal row's slab test are each computed only
// on their own kind of row. No layout of the TPU version is kept: its
// unroll, tiles and shared trip count were loop-overhead workarounds.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// torch.minimum / torch.maximum: NaN when either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float safe_inv(float d) {
    const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
    return 1.0f / safe;
}

__global__ void __launch_bounds__(kThreads)
packed_walk_kernel(const float4* __restrict__ rows, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ t0,
                   const bool* __restrict__ active, float* __restrict__ t_out,
                   int* __restrict__ face_out, long long r, long long max_steps) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= r) return;
    float t_best = t0[i];
    int face = -1;
    int node = active[i] ? 0 : -1;
    if (node >= 0) {
        const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
        const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
        const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
        for (long long step = 0; node >= 0 && (max_steps < 0 || step < max_steps);
             ++step) {
            const float4* row = rows + 4 * (long long)node;
            const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
                         e = __ldg(row + 3);
            const int link = __float_as_int(e.x), skip = __float_as_int(e.y);
            if (e.z > 0.5f) {
                // leaf: p0 = (a.x, a.y, a.z), e1 = (a.w, b.x, b.y),
                // e2 = (b.z, b.w, c.x)
                const float e1x = a.w, e1y = b.x, e1z = b.y;
                const float e2x = b.z, e2y = b.w, e2z = c.x;
                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const bool ok = fabsf(det) > 1e-8f;
                const float inv_det = (ok ? 1.0f : 0.0f) / (ok ? det : 1.0f);
                const float tx = ox - a.x, ty = oy - a.y, tz = oz - a.z;
                const float u = (tx * px + ty * py + tz * pz) * inv_det;
                const float qx = ty * e1z - tz * e1y;
                const float qy = tz * e1x - tx * e1z;
                const float qz = tx * e1y - ty * e1x;
                const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
                const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
                    t < t_best) {
                    t_best = t;
                    face = link;
                }
                node = skip;
            } else {
                // internal: bmin = (a.x, a.y, a.z), bmax = (a.w, b.x, b.y)
                const float n1x = (a.x - ox) * ix, n1y = (a.y - oy) * iy,
                            n1z = (a.z - oz) * iz;
                const float n2x = (a.w - ox) * ix, n2y = (b.x - oy) * iy,
                            n2z = (b.y - oz) * iz;
                const float tnear = max_nan(
                    max_nan(min_nan(n1x, n2x), min_nan(n1y, n2y)), min_nan(n1z, n2z));
                const float tfar = min_nan(
                    min_nan(max_nan(n1x, n2x), max_nan(n1y, n2y)), max_nan(n1z, n2z));
                const bool nonempty = a.x <= a.w && a.y <= b.x && a.z <= b.y;
                const bool hit_box =
                    tfar >= tnear && tnear < t_best && tfar > 0.0f && nonempty;
                node = hit_box ? link : skip;
            }
        }
    }
    t_out[i] = t_best;
    face_out[i] = face;
}

}  // namespace

extern "C" int rk_packed_walk(const float* rows, long long n_rows, const float* ro,
                              const float* rd, const float* t0, const bool* active,
                              float* t_out, int* face_out, long long r,
                              long long max_steps, void* stream) {
    if (r < 0 || n_rows < 1 || max_steps < -1) return (int)cudaErrorInvalidValue;
    if (r == 0) return 0;
    const unsigned grid = (unsigned)((r + kThreads - 1) / kThreads);
    packed_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), ro, rd, t0, active, t_out, face_out,
        r, max_steps);
    return (int)cudaGetLastError();
}
