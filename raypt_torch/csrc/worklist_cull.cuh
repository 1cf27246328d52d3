// The worklist test's conservative per-ray cluster cull, shared by the
// culled worklist kernel (cluster_intersect.cu: worklist_cull_kernel) and
// its pre-pass (cull_prep_kernel).
//
// What it decides: for a ray (o, d) with carry tb and a cluster of the
// (C, L, 12) table, whether any triangle of the cluster can return a hit
// that the worklist test (cluster_test.cuh's Moller-Trumbore test, built
// with -fmad=false, 1 / det correctly rounded) would accept and the
// strict merge would take: |det| > 1e-8, u >= 0, v >= 0, u + v <= 1,
// 0 < t < tb. A pair is skipped only where none can, so skipping it
// leaves the kernel's result unchanged, bit for bit.
//
// The bound. Write a = e1, b = e2, p = p0, tv = o - p exactly, and the
// test's values computed in f32 (eps = 2^-24, g_k = k eps / (1 - k eps))
// with a tilde: pv~ = d x b, D~ = a . pv~, U~ = tv~ . pv~, qv~ = tv~ x a,
// V~ = d . qv~, T~ = b . qv~, u~ = U~ * fl(1 / D~) and so v~, t~. The
// exact values D = a . (d x b) = -d . n (n = a x b), U, V, T solve
// tv = (U a + V b - T d) / D (Cramer). With S(x, y, z) = sum over the
// six index permutations of |x_i| |y_j| |z_k| <= sqrt(2) |x| |y| |z|,
// the standard error model of one rounding an operation gives
//   |D~ - D| <= g5 S(a, d, b),  |U~ - U| <= g7 S(tv, d, b),
//   |V~ - V| <= g7 S(d, tv, a), |T~ - T| <= g7 S(b, tv, a),
// and for an accepted hit (|u~|, |v~| <= 1 + eps), with
// r = |D~ - D| / |D| and rho = (r + 2 eps)(1 + 3 eps),
//   |u~ - U / D| <= rho + |U~ - U| / |D|,  likewise v,
//   |t~ - T / D| <= rho |t~| + |T~ - T| / |D|.
// Let W bound |a| |b| / |D| over the cluster's triangles for this ray
// and g = sqrt(2) |d| W. Then r <= g5 g, and each of the three error
// terms times its vector (|a|, |b| and |d|) is at most g7 |tv| g. The
// point q = p + u~ a + v~ b lies within 1.01 eps E of the triangle (E:
// the largest |a|, |b|; fl(u~ + v~) <= 1 gives u~ + v~ <= 1 + eps), so in
// the cluster's box, and the ray's point o + t~ d is within
//   |t~ - t| |d| + |u~ - u| |a| + |v~ - v| |b|  of it.
// With Rf >= |o - x| for every x of the box (the sum over the axes of
// the larger of |o_i - lo_i|, |o_i - hi_i|), |t~| |d| <= Rf + delta, so
//   delta = (rho (2 E + Rf) + 3 g7 Rf g + 1.01 eps E) / (1 - rho)
// bounds that distance, and o + t~ d with 0 < t~ < tb lies in the box
// grown by delta on every side. A ray that misses that box over (0, tb)
// has no hit the merge would take. (Underflow adds absolute errors below
// 2^-100 for coordinates within 2^40; 2^-30 (2 E + Rf) more covers them.)
//
// W comes from two bounds, the smaller taken:
//   * the normal cone: every kept triangle's normal lies within angle
//     alpha of the cluster's axis (as lines); beta is d's angle to the
//     axis. Where beta + alpha < 90 degrees, |D| = |d| |n| |cos theta| >=
//     |d| |n| cos(beta + alpha), so |a| |b| / |D| <= 1 / (|d| s_min
//     cmin), s_min the least sin of the angle between a and b, cmin a
//     lower bound of cos(beta + alpha): g = sqrt(2) / (s_min cmin).
//     In the cone's grazing band (cmin below 2^-10) there is no such
//     bound: an accepted hit's u, v, t can be wrong by O(1) there;
//   * the threshold: an accepted hit has |D~| > 1e-8, so |D| > 1e-8 -
//     g5 sqrt(2) E2 |d| (E2: the largest |a| |b|), and W <= E2 / that,
//     valid while g5 sqrt(2) E2 |d| < 1e-8 / 3 (small triangles).
// Where neither holds, or g5 g > 1/4, delta is infinite and the pair is
// always tested. Each constant is rounded up (down where it bounds from
// below), each f32 step of the cull is covered by factors 1.0001 and
// 1.001 and margins of 1e-6 on the cosines, and the slab test runs in
// f64 on 1 / d rounded to f32 with a relative slack of 2^-20 (its own
// error is below 2^-23).
//
// What is left out: a triangle that cannot pass |det| > 1e-8 for any ray
// with |d| <= kDirLimit (a zero row, a sliver whose |n| is too small:
// |D~| <= |d| (|n| + g5 sqrt(2) |a| |b|)) enters neither the box nor the
// cone, and a cluster of only such triangles is skipped for every such
// ray. A ray with |d| > kDirLimit, a coordinate past kCoordLimit or a
// value that is not finite is never culled, nor is any ray against a
// cluster with such a row.
#pragma once

#include <cuda_runtime.h>

namespace rk {
namespace cull {

constexpr int kRec = 16;                  // floats of a cluster's record
constexpr float kDirLimit = 2.0f;         // |d| above it: never culled
constexpr float kCoordLimit = 0x1p40f;    // |coordinate| above it: never
constexpr float kDetMin = 1e-8f;          // the test's |det| threshold
// gamma5, sqrt(2) gamma5, gamma7 and 2 eps, each rounded up
constexpr float kG5 = 3.0e-7f, kS2G5 = 4.25e-7f, kG7 = 4.2e-7f;
constexpr float k2Eps = 1.2e-7f;
constexpr float kGMax = 8.0e5f;           // above it g5 g may pass 1/4
constexpr float kConeMin = 0x1p-10f;      // cmin below it: no cone bound
constexpr float kSqrt2 = 1.4143f;         // sqrt(2), rounded up

// A cluster's record: its box, cone, bound scalars and state.
enum Field {
    kLo = 0,      // lo x, y, z (rounded down)
    kHi = 3,      // hi x, y, z (rounded up)
    kAxis = 6,    // the cone's axis (about unit length)
    kCa = 9,      // cos alpha, rounded down
    kSa = 10,     // sin alpha, rounded up
    kSmin = 11,   // the least sin of the angle between e1 and e2
    kE = 12,      // the largest |e1|, |e2|
    kE2 = 13,     // the largest |e1| |e2|
    kState = 14,  // 1: cull by the bound; 0: never cull; -1: no
                  // triangle can pass |det| > 1e-8 (cull every ray)
};

// Whether triangle (a, b) can pass |det| > 1e-8 for some ray with |d| <=
// kDirLimit (f64; the products of f32 values are exact).
__device__ __forceinline__ bool can_pass(double nn, double na, double nb) {
    const double hi = (double)kDirLimit * (nn + (double)kS2G5 * na * nb) *
                      (1.0 + 0x1p-40) + 1e-30;
    return hi >= (double)kDetMin;
}

// A packed ray's cull data: 1 / d in f32 (0 where d_i is 0: that axis is
// tested by o_i alone; inf where 0 < |d_i| < 2^-60, whose reciprocal
// could overflow: that axis is not tested), |d| rounded up and 1 / |d|;
// idn <= 0 marks a ray that is never culled.
struct RayData {
    float ix, iy, iz;
    float dn, idn;
};

__device__ __forceinline__ float inv_axis(float d) {
    if (d == 0.0f) return 0.0f;
    return fabsf(d) < 0x1p-60f ? __int_as_float(0x7f800000) : 1.0f / d;
}

__device__ __forceinline__ RayData ray_data(float ox, float oy, float oz, float dx,
                                            float dy, float dz) {
    RayData r{0.0f, 0.0f, 0.0f, 0.0f, -1.0f};
    const float lim = kCoordLimit;
    const bool finite_o = fabsf(ox) <= lim && fabsf(oy) <= lim && fabsf(oz) <= lim;
    const bool finite_d = fabsf(dx) <= lim && fabsf(dy) <= lim && fabsf(dz) <= lim;
    if (!finite_o || !finite_d) return r;
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (!(d2 > 1e-30f) || !(d2 <= kDirLimit * kDirLimit * 0.999f)) return r;
    const float dn = sqrtf(d2);
    r.dn = dn * 1.0001f;
    r.idn = 1.0f / dn;
    r.ix = inv_axis(dx);
    r.iy = inv_axis(dy);
    r.iz = inv_axis(dz);
    return r;
}

// One axis of the slab test over the box grown by delta: false where the
// ray cannot be in it (d_i = 0 and o_i outside), else narrows [tn, tf]
// (not at all where inv is inf).
__device__ __forceinline__ bool slab(float o, float inv, float lo, float hi,
                                     float delta, double& tn, double& tf) {
    const float l = __fsub_rd(lo, delta), h = __fadd_ru(hi, delta);
    if (inv == 0.0f) return !(o < l || o > h);
    if (isinf(inv)) return true;
    const double t1 = ((double)l - (double)o) * (double)inv;
    const double t2 = ((double)h - (double)o) * (double)inv;
    tn = fmax(tn, fmin(t1, t2));
    tf = fmin(tf, fmax(t1, t2));
    return true;
}

// Whether the pair (ray, cluster) must be tested: false only where no
// triangle of the cluster can return a hit the merge would take (the
// header). rec: the cluster's record; tb: the ray's carry (> 0), used
// only with kCarry.
template <bool kCarry>
__device__ __forceinline__ bool keep_pair(float ox, float oy, float oz, float dx,
                                          float dy, float dz, const RayData& rd,
                                          float tb, const float* rec) {
    if (!(rd.idn > 0.0f)) return true;
    const float state = rec[kState];
    if (state < 0.0f) return false;
    if (!(state > 0.0f)) return true;
    const float e = rec[kE], e2 = rec[kE2];
    // g = sqrt(2) |d| W, from the cone and from the threshold
    float g = __int_as_float(0x7f800000);
    const float dot = fabsf(dx * rec[kAxis] + dy * rec[kAxis + 1] + dz * rec[kAxis + 2]);
    const float cb = fminf(dot * rd.idn - 1e-6f, 1.0f);   // <= cos beta
    if (cb > 0.0f) {
        const float sb = sqrtf((1.0f - cb) * (1.0f + cb)) * 1.0001f;   // >= sin beta
        const float cmin = cb * rec[kCa] - sb * rec[kSa] - 1e-6f;
        if (cmin > kConeMin) g = kSqrt2 / (rec[kSmin] * cmin) * 1.0001f;
    }
    const float k = kS2G5 * e2 * rd.dn + 1e-30f;
    if (k < kDetMin / 3.0f) g = fminf(g, kSqrt2 * e2 * rd.dn / (kDetMin - k) * 1.0001f);
    if (!(g < kGMax)) return true;
    const float rho = (kG5 * g + k2Eps) * 1.0001f + 1e-9f;
    const float o[3] = {ox, oy, oz};
    float rf = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
        rf += fmaxf(fabsf(o[i] - rec[kLo + i]), fabsf(o[i] - rec[kHi + i]));
    rf *= 1.0001f;
    const float delta =
        (rho * (2.0f * e + rf) + 3.0f * kG7 * rf * g + 6.1e-8f * e) / (1.0f - rho) *
        1.001f;
    if (!(delta < kCoordLimit)) return true;
    double tn = 0.0;
    double tf = kCarry ? (double)tb : (double)__int_as_float(0x7f800000);
    if (!slab(ox, rd.ix, rec[kLo], rec[kHi], delta, tn, tf) ||
        !slab(oy, rd.iy, rec[kLo + 1], rec[kHi + 1], delta, tn, tf) ||
        !slab(oz, rd.iz, rec[kLo + 2], rec[kHi + 2], delta, tn, tf))
        return false;
    return !(tn - tf > 0x1p-20 * (fabs(tn) + fabs(tf)));
}

}  // namespace cull
}  // namespace rk
