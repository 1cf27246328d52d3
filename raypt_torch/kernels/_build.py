"""Build and launch of the four Hopper kernels, `raypt_torch/csrc/*.cu`:
compiled with nvcc for `sm_90a` on first use (see
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
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
KERNEL_SOURCES = ("compact.cu", "onehot_walk.cu", "cluster_expand.cu")


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
    lib = load_library("raypt_kernels", [_nvcc()], NVCC_FLAGS, srcs)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # the stream is always the last argument (see `launch`)
    sigs = {
        # ro, rd, t0, alive -> ro', rd', t0', alive'; r, group, stream
        "rk_alive_compact": [p, p, p, p, p, p, p, p, i64, i32, p],
        # t, face, alive -> t', face'; r, group, stream
        "rk_alive_uncompact": [p, p, p, p, p, i64, i32, p],
        # table, nt, ro, rd, t0, active -> mask, union_pp;
        # r, cwp, max_steps, stream
        "rk_topwalk": [p, i32, p, p, p, p, p, p, i64, i32, i32, p],
        # mask, union_pp, rows, c_total, leaf, ro, rd, seed -> t, face;
        # r, cwp, stream
        "rk_cluster_expand": [p, p, p, i32, i32, p, p, p, p, p, i64, i32, p],
    }
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.rk_error_string.argtypes = [ctypes.c_int]
    lib.rk_error_string.restype = ctypes.c_char_p
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
