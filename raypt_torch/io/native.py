"""ctypes binding to the host SAH builder in `native/raypt_native.cpp`
(the JAX package's `raypt/io/native.py`, SAH entry only).

The source is compiled into the port's build directory on first use
with `g++ -O3 -fPIC -std=c++17 -shared`. The committed
`native/libraypt_native.so` is never loaded: it was built with
`-march=native`, which ends in SIGILL, not an OSError, on a host with
another CPU. A failed build raises; there is no tree-builder fallback.

Without `-march=native` g++ emits no fused multiply-adds, so on meshes
where two SAH split costs nearly tie the tree can differ from the one
the committed library builds (it does on the icosphere bunny stand-in).
"""
from __future__ import annotations

import ctypes as C
import os

import numpy as np

from .._native_build import PKG_DIR, load_library

SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "raypt_native.cpp")
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17"]


def load() -> C.CDLL:
    lib = load_library("raypt_native", ["g++"], GXX_FLAGS, ["-shared"],
                       [SOURCE])
    lib.rn_free.argtypes = [C.c_void_p]
    lib.rn_build_sah_bvh.argtypes = [
        C.POINTER(C.c_float), C.c_int, C.POINTER(C.c_int), C.c_int,
        C.POINTER(C.POINTER(C.c_float)), C.POINTER(C.POINTER(C.c_uint32)),
        C.POINTER(C.POINTER(C.c_uint32))]
    lib.rn_build_sah_bvh.restype = C.c_int
    return lib


def _take(lib, ptr, count, dtype):
    """Copy a malloc'd native buffer into numpy and free it."""
    arr = np.ctypeslib.as_array(
        C.cast(ptr, C.POINTER(C.c_uint8)),
        shape=(count * np.dtype(dtype).itemsize,)).view(dtype)[:count].copy()
    lib.rn_free(ptr)
    return arr


def build_sah_host(positions: np.ndarray, faces: np.ndarray):
    """Binned-SAH build over (V, 3) positions and (F, 3) faces, F >= 1.
    Returns (bounds (2F-1, 6), meta (2F-1, 2), order (F,)) as the
    native builder emits them (see `raypt_torch.accel.host_bvh`)."""
    lib = load()
    positions = np.ascontiguousarray(positions, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    b_p = C.POINTER(C.c_float)()
    m_p = C.POINTER(C.c_uint32)()
    o_p = C.POINTER(C.c_uint32)()
    nodes = lib.rn_build_sah_bvh(
        positions.ctypes.data_as(C.POINTER(C.c_float)), len(positions),
        faces.ctypes.data_as(C.POINTER(C.c_int)), len(faces),
        C.byref(b_p), C.byref(m_p), C.byref(o_p))
    if nodes <= 0:
        raise RuntimeError(f"native SAH build failed ({nodes})")
    total = 2 * len(faces) - 1
    bounds = _take(lib, b_p, total * 6, np.float32).reshape(-1, 6)
    meta = _take(lib, m_p, total * 2, np.uint32).reshape(-1, 2)
    order = _take(lib, o_p, len(faces), np.uint32)
    return bounds, meta, order
