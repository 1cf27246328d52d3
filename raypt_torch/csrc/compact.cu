// Alive compaction of a ray wavefront and its inverse, for Hopper (sm_90a).
//
// Replaces raypt/kernels/compact.py: pallas_alive_compact (:180, body
// _kernel_compact :79) and pallas_alive_uncompact (:218, body
// _kernel_uncompact :118). Contract: within each `group`-lane block,
// the stable alive-first permutation; lane i goes to pa(i) when alive
// and to na + (i - pa(i)) when dead (pa = alive lanes before i, na =
// the group's alive count). Uncompaction gathers out[i] = y[dest(i)]
// with dest recomputed from the same original alive mask.
//
// What bounds it on this card: memory traffic. A compaction moves 29
// bytes per lane (ro, rd, t0, alive) in and out; an uncompaction 8.
// At R = 2^20 that is ~60 MB, ~20 us at 3.35 TB/s. The rank pass is a
// few integer ops per lane.
//
// What the design does about it: one block of 1024 threads per group
// (32,768 lanes on the bench path, so 32 blocks per 2^20-ray
// wavefront). The group is walked in 1024-lane chunks: __ballot_sync
// and __popc rank lanes inside a warp, a shared-memory scan of the 32
// warp counts ranks the warps, and a running carry ranks the chunks.
// Reads are coalesced; writes scatter only inside the group. The TPU
// kernel's one-hot selection matmuls and split3_bf16 transport have no
// counterpart: a permutation here is plain loads and stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Alive count of the group, valid in every thread after the call.
__device__ int group_alive_count(const uint8_t* alive, long long base,
                                 int group, int* s_warp) {
    int cnt = 0;
    for (int j = threadIdx.x; j < group; j += kThreads)
        cnt += alive[base + j] != 0;
    for (int off = 16; off > 0; off >>= 1)
        cnt += __shfl_down_sync(kFull, cnt, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) s_warp[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
        int v = s_warp[lane];
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(kFull, v, off);
        if (lane == 0) s_warp[32] = v;
    }
    __syncthreads();
    const int na = s_warp[32];
    __syncthreads();   // s_warp is reused by the caller
    return na;
}

// Calls f(src_lane, dest_lane) for every lane of the block's group.
template <typename F>
__device__ void for_each_destination(const uint8_t* alive, int group, F f) {
    __shared__ int s_warp[33];
    const long long base = (long long)blockIdx.x * group;
    const int na = group_alive_count(alive, base, group, s_warp);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int carry = 0;   // alive lanes in the chunks before this one
    for (int c0 = 0; c0 < group; c0 += kThreads) {
        const int j = c0 + threadIdx.x;
        const bool a = j < group && alive[base + j] != 0;
        const unsigned b = __ballot_sync(kFull, a);
        const int in_warp = __popc(b & ((1u << lane) - 1u));
        if (lane == 0) s_warp[warp] = __popc(b);
        __syncthreads();
        if (warp == 0) {   // exclusive scan of the 32 warp counts
            const int v = s_warp[lane];
            int incl = v;
            for (int off = 1; off < 32; off <<= 1) {
                const int u = __shfl_up_sync(kFull, incl, off);
                if (lane >= off) incl += u;
            }
            s_warp[lane] = incl - v;
            if (lane == 31) s_warp[32] = incl;
        }
        __syncthreads();
        if (j < group) {
            const int pa = carry + s_warp[warp] + in_warp;
            const int dest = a ? pa : na + (j - pa);
            f(base + j, base + dest);
        }
        carry += s_warp[32];
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads)
alive_compact_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                     const float* __restrict__ t0,
                     const uint8_t* __restrict__ alive,
                     float* __restrict__ ro_out, float* __restrict__ rd_out,
                     float* __restrict__ t0_out, uint8_t* __restrict__ alive_out,
                     int group) {
    for_each_destination(alive, group, [&](long long src, long long dst) {
        for (int k = 0; k < 3; ++k) {
            ro_out[dst * 3 + k] = ro[src * 3 + k];
            rd_out[dst * 3 + k] = rd[src * 3 + k];
        }
        t0_out[dst] = t0[src];
        alive_out[dst] = alive[src];
    });
}

__global__ void __launch_bounds__(kThreads)
alive_uncompact_kernel(const float* __restrict__ t, const int* __restrict__ face,
                       const uint8_t* __restrict__ alive,
                       float* __restrict__ t_out, int* __restrict__ face_out,
                       int group) {
    for_each_destination(alive, group, [&](long long src, long long dst) {
        t_out[src] = t[dst];
        face_out[src] = face[dst];
    });
}

}  // namespace

extern "C" int rk_alive_compact(const float* ro, const float* rd, const float* t0,
                                const uint8_t* alive, float* ro_out, float* rd_out,
                                float* t0_out, uint8_t* alive_out, long long r,
                                int group, void* stream) {
    if (group <= 0 || r % group) return (int)cudaErrorInvalidValue;
    const long long n_groups = r / group;
    if (n_groups == 0) return 0;
    alive_compact_kernel<<<(unsigned)n_groups, kThreads, 0, (cudaStream_t)stream>>>(
        ro, rd, t0, alive, ro_out, rd_out, t0_out, alive_out, group);
    return (int)cudaGetLastError();
}

extern "C" int rk_alive_uncompact(const float* t, const int* face,
                                  const uint8_t* alive, float* t_out, int* face_out,
                                  long long r, int group, void* stream) {
    if (group <= 0 || r % group) return (int)cudaErrorInvalidValue;
    const long long n_groups = r / group;
    if (n_groups == 0) return 0;
    alive_uncompact_kernel<<<(unsigned)n_groups, kThreads, 0, (cudaStream_t)stream>>>(
        t, face, alive, t_out, face_out, group);
    return (int)cudaGetLastError();
}

extern "C" const char* rk_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
