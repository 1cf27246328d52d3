// Row gather out = table[idx], for Hopper (sm_90a).
//
// Replaces the gather probes of scripts/: pallas_gather_test.py (run :17,
// body kern :11, `tab_ref[i]`) and pallas_gather_test2.py (the pallas_call
// in try_variant :10 with bodies k_take :31, k_take_clip :35, k_loop :39
// and k_tal :46). All five bodies compute one function; only k_take_clip
// clamps the index, and on the other four the probes' indices are in
// range. Contract: out[r, :] = table[idx[r], :] for a (n, w) f32 table and
// (R,) int32 indices; with clip, idx is clamped to [0, n - 1]; without,
// an index outside [0, n) gives a row of NaN (jnp.take's default) instead
// of a read outside the table.
//
// What bounds it on this card: memory traffic, 4 bytes of index and two
// rows of w floats per output row (64 bytes each at the probes' w = 16).
//
// What the design does about it: w / 4 threads per row, each moving one
// 16-byte float4, so a warp reads and writes whole rows with 16-byte
// accesses; the index is loaded once per thread through the read-only
// path. The TPU kernel's VMEM residency of the whole table has no
// counterpart: the table's rows are read from device memory (or L2).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kClip>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, long long n,
                   const int* __restrict__ idx, float4* __restrict__ out,
                   long long rows, int q_per_row) {
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (t >= rows * q_per_row) return;
    const long long r = t / q_per_row;
    const int q = (int)(t - r * q_per_row);
    long long i = __ldg(idx + r);
    if (kClip) {
        i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    } else if (i < 0 || i >= n) {
        const float nan = __int_as_float(0x7fc00000);
        out[t] = make_float4(nan, nan, nan, nan);
        return;
    }
    out[t] = __ldg(table + i * q_per_row + q);
}

}  // namespace

// table (n, w) f32, w a multiple of 4; idx (rows,) int32 -> out (rows, w).
extern "C" int rk_gather_rows(const float* table, long long n, int w,
                              const int* idx, float* out, long long rows,
                              int clip, void* stream) {
    if (w <= 0 || w % 4 || n <= 0 || rows < 0)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const int q = w / 4;
    const long long threads = rows * q;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    const float4* t4 = reinterpret_cast<const float4*>(table);
    float4* o4 = reinterpret_cast<float4*>(out);
    if (clip)
        gather_rows_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            t4, n, idx, o4, rows, q);
    else
        gather_rows_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            t4, n, idx, o4, rows, q);
    return (int)cudaGetLastError();
}
