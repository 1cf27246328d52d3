// Block-wide exclusive scan shared by the probe kernels (expand_diag.cu,
// regroup.cu): a warp shuffle scan, then a scan of the warp sums in
// shared memory. For blocks of whole warps, at most 32 of them.
#pragma once
#include <cuda_runtime.h>

namespace rk {

// Exclusive scan of v over the block's threads, in thread order; *total
// gets the block's sum. Every thread calls it. s_warp holds 33 ints.
__device__ inline int block_exclusive_scan(int v, int* s_warp, int* total) {
    constexpr unsigned kFull = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
    for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int w = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0;
        int wi = w;
        for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(kFull, wi, off);
            if (lane >= off) wi += u;
        }
        s_warp[lane] = wi - w;
        if (lane == 31) s_warp[32] = wi;
    }
    __syncthreads();
    const int out = s_warp[warp] + incl - v;
    *total = s_warp[32];
    __syncthreads();   // s_warp is reused by the next scan
    return out;
}

}  // namespace rk
