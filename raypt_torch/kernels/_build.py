"""Build and launch of the Hopper kernels, `raypt_torch/csrc/*.cu`:
compiled with nvcc for `sm_90a` on first use, one nvcc process per
source, all started together, then linked into one shared library (see
`raypt_torch._native_build`), bound through a plain C interface and
loaded with ctypes. A failed build or launch raises: nothing on the
main path falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil

from .._native_build import PKG_DIR, load_library

CSRC_DIR = os.path.join(PKG_DIR, "csrc")

# -fmad=false: no multiply-add contraction, so every kernel rounds after
# each operation exactly like the separate elementwise ops of its plain
# torch version. No --use_fast_math: division and sqrt stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]
KERNEL_SOURCES = ("compact.cu", "onehot_walk.cu", "cluster_expand.cu",
                  "cluster_intersect.cu", "dense_closest.cu", "gather.cu",
                  "expand_diag.cu", "regroup.cu", "packed_walk.cu",
                  "wide_walk.cu", "packed_layouts.cu")
KERNEL_HEADERS = ("cluster_test.cuh", "block_scan.cuh", "mask_walk.cuh",
                  "packed_walk.cuh", "wide_walk.cuh", "packed_layouts.cuh")
SMEM_LIMIT = 232448   # shared memory a block may use on Hopper (227 KB)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (PATH or /usr/local/cuda/bin)")


@functools.lru_cache(maxsize=None)
def kernel_lib() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with every C
    entry point's argtypes declared."""
    srcs = [os.path.join(CSRC_DIR, s) for s in KERNEL_SOURCES]
    hdrs = tuple(os.path.join(CSRC_DIR, s) for s in KERNEL_HEADERS)
    lib = load_library("raypt_kernels", [_nvcc()], NVCC_FLAGS, ["-shared"],
                       srcs, hdrs)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # the stream is always the last argument (see `launch`)
    sigs = {
        # ro, rd, t0, alive -> ro', rd', t0', alive'; scratch counts, r,
        # group, stream
        "rk_alive_compact": [p, p, p, p, p, p, p, p, p, i64, i32, p],
        # t, face, alive -> t', face'; counts, counted, r, group, stream
        "rk_alive_uncompact": [p, p, p, p, p, p, i32, i64, i32, p],
        # table, nt, ro, rd, t0, active -> mask, union_pp;
        # r, cwp, max_steps, stream
        "rk_topwalk": [p, i32, p, p, p, p, p, p, i64, i32, i32, p],
        # table, nt, ro, rd, t0, active -> unions; r, cwp, max_steps, stream
        "rk_topwalk_union": [p, i32, p, p, p, p, p, i64, i32, i32, p],
        # table, nt, ro, rd, t0, active -> mask; r, cw, max_steps, stream
        "rk_topwalk_mask": [p, i32, p, p, p, p, p, i64, i32, i32, p],
        "rk_topwalk_mask_spec": [p, i32, p, p, p, p, p, i64, i32, i32, p],
        # mask, union_pp, rows, c_total, leaf, ro, rd, seed -> t, face;
        # r, cwp, stream
        "rk_cluster_expand": [p, p, p, i32, i32, p, p, p, p, p, i64, i32, p],
        # unions, cw, rows, c_total, leaf, ro, rd, seed -> t, face;
        # n_tiles, stream
        "rk_cluster_intersect_mask": [p, i32, p, i32, i32, p, p, p, p, p, i64,
                                      p],
        # unions, cw, woop, c_total, leaf, ro, rd, seed -> t, packed;
        # n_tiles, stream
        "rk_cluster_intersect_mask_woop": [p, i32, p, i32, i32, p, p, p, p, p,
                                           i64, p],
        # worklist, cap, rows, c_total, leaf, ro, rd, seed -> t, face;
        # n_tiles, stream
        "rk_intersect_worklist": [p, i32, p, i32, i32, p, p, p, p, p, i64, p],
        # one -> mismatches, first_bad; stream (the check of 1 / det)
        "rk_inv_det_sweep": [ctypes.c_float, p, p, p],
        # worklist, counts, cap, group, rows, c_total, leaf, ro, rd, seed
        # -> t, face; n_tiles, stream
        "rk_cluster_intersect": [p, p, i32, i32, p, i32, i32, p, p, p, p, p,
                                 i64, p],
        # wu, wv, ww, cu, cv, cw, n_tris, ro, rd, t0 -> t, face; r,
        # scratch rows, id, n_live, stream
        "rk_closest_dense": [p, p, p, p, p, p, i64, p, p, p, p, p, i64, p, p,
                             p, p],
        # rows, n_rows, ro, rd, t0, active -> t, face; r, max_steps,
        # scratch, stream
        "rk_packed_walk": [p, i64, p, p, p, p, p, p, i64, i64, p, p],
        # layout, rows, n_rows, ro, rd, t0, active -> t, face; r,
        # scratch, stream
        "rk_layout_walk": [i32, p, i64, p, p, p, p, p, p, i64, p, p],
        # layout, rows, n_rows -> scratch (the split table); stream
        "rk_layout_build": [i32, p, i64, p, p],
        # rows, n_rows, root, nw_cap, ro, rd, t0, active -> t, face,
        # overflow; r, stack_d, stream
        "rk_wide_walk": [p, i64, i32, i64, p, p, p, p, p, p, p, i64, i32, p],
        # the scripts/ probes (raypt_torch/probes/)
        # table, n, w, idx -> out; rows, clip, stream
        "rk_gather_rows": [p, i64, i32, p, p, i64, i32, p],
        # wk, mask, pages, n -> m, rank; stream
        "rk_expand_stage12": [p, p, i32, i32, p, p, p],
        # pay, m, n -> go, gsel; stream
        "rk_expand_stage34": [p, p, i32, p, p, p],
        # wk, mask, pages, n_total -> m; stream
        "rk_expand_stage5": [p, p, i32, i64, p, p],
        # mask, cwp, pay, otrue, r, n -> v1, v2, nc, v3; stream
        "rk_expand_diag": [p, i32, p, p, i64, i32, p, p, p, p, p],
        # x -> out; len, n, iters, chain, fixed_s, stream
        "rk_permute": [p, p, i64, i32, i32, i32, i32, p],
        # x -> out; len, n, iters, stream
        "rk_sel": [p, p, i64, i32, i32, p],
        # x -> out; len, n, iters, mode, stream
        "rk_cycle": [p, p, i64, i32, i32, i32, p],
    }
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.rk_error_string.argtypes = [ctypes.c_int]
    lib.rk_error_string.restype = ctypes.c_char_p
    # the packed walk's scratch (float4) for n_rows, and its kernel's
    # registers, local bytes, resident blocks an SM, threads a block and
    # whether a block hands its rays out by octant (5 ints)
    lib.rk_packed_walk_scratch.argtypes = [i64]
    lib.rk_packed_walk_scratch.restype = i64
    lib.rk_packed_walk_info.argtypes = [p]
    lib.rk_packed_walk_info.restype = ctypes.c_int
    # a layout walk's scratch (float4) for n_rows, and its kernel's
    # registers, local bytes, resident blocks an SM and threads a block
    # (4 ints)
    lib.rk_layout_walk_scratch.argtypes = [i32, i64]
    lib.rk_layout_walk_scratch.restype = i64
    lib.rk_layout_walk_info.argtypes = [i32, p]
    lib.rk_layout_walk_info.restype = ctypes.c_int
    # the wide walk's largest stack_d, and its kernel's registers, local
    # bytes, resident blocks an SM and threads a block (4 ints)
    lib.rk_wide_walk_max_stack.argtypes = []
    lib.rk_wide_walk_max_stack.restype = ctypes.c_int
    lib.rk_wide_walk_info.argtypes = [p]
    lib.rk_wide_walk_info.restype = ctypes.c_int
    return lib


def on_cuda(specs: dict) -> bool:
    """specs: name -> (tensor, shape, dtype). Raise unless every tensor
    has its shape and dtype, is contiguous, and all share one device;
    True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version). Any other device raises."""
    devices = set()
    for name, (t, shape, dtype) in specs.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def launch(fn_name: str, *args) -> None:
    """Call a kernel's C entry point on the current stream; raise when it
    returns a CUDA error (a refused launch never runs, and a later
    synchronize would not report it)."""
    import torch
    lib = kernel_lib()
    rc = getattr(lib, fn_name)(*args,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} "
                           f"({lib.rk_error_string(rc).decode()})")
