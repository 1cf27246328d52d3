"""ctypes binding to the native host runtime in `native/raypt_native.cpp`
(the JAX package's `raypt/io/native.py`): the SAH builder, the OBJ
parser, smooth normals, the reference-semantics midpoint BVH and the
morton order.

The source is compiled into the port's build directory on first use
with `g++ -O3 -fPIC -std=c++17 -shared`. The committed
`native/libraypt_native.so` is never loaded: it was built with
`-march=native`, which ends in SIGILL, not an OSError, on a host with
another CPU. A failed build raises; there is no tree-builder fallback.
The other helpers keep the JAX package's contract instead: without the
library (`available()` false) `load_obj_native`, `build_midpoint_bvh`
and `morton_order` return None and `smooth_normals_native` computes in
numpy.

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
    lib.rn_load_obj.argtypes = [
        C.c_char_p,
        C.POINTER(C.POINTER(C.c_float)), C.POINTER(C.c_int),
        C.POINTER(C.POINTER(C.c_float)), C.POINTER(C.c_int),
        C.POINTER(C.POINTER(C.c_float)), C.POINTER(C.c_int),
        C.POINTER(C.POINTER(C.c_int)), C.POINTER(C.c_int),
        C.POINTER(C.c_int)]
    lib.rn_load_obj.restype = C.c_int
    lib.rn_smooth_normals.argtypes = [
        C.POINTER(C.c_float), C.c_int, C.POINTER(C.c_int), C.c_int,
        C.POINTER(C.c_float)]
    lib.rn_smooth_normals.restype = None
    lib.rn_build_midpoint_bvh.argtypes = [
        C.POINTER(C.c_float), C.c_int, C.POINTER(C.c_int), C.c_int,
        C.POINTER(C.POINTER(C.c_float)), C.POINTER(C.POINTER(C.c_uint32)),
        C.POINTER(C.POINTER(C.c_uint32))]
    lib.rn_build_midpoint_bvh.restype = C.c_int
    lib.rn_morton_order.argtypes = [
        C.POINTER(C.c_float), C.c_int, C.POINTER(C.c_uint32),
        C.POINTER(C.c_int)]
    lib.rn_morton_order.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


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


def load_obj_native(path: str):
    """Native OBJ parse -> the mesh dict of `io.obj.load_obj`
    (positions, normals, uvs, faces), or None when the library is
    unavailable, the file cannot be read, or it indexes normals or uvs
    per corner (the Python parser splits those corners)."""
    if not available():
        return None
    lib = load()
    pos_p = C.POINTER(C.c_float)()
    nrm_p = C.POINTER(C.c_float)()
    uv_p = C.POINTER(C.c_float)()
    f_p = C.POINTER(C.c_int)()
    nv, nn, nu, nf, flags = (C.c_int() for _ in range(5))
    rc = lib.rn_load_obj(os.fsencode(path), C.byref(pos_p), C.byref(nv),
                         C.byref(nrm_p), C.byref(nn), C.byref(uv_p),
                         C.byref(nu), C.byref(f_p), C.byref(nf),
                         C.byref(flags))
    if rc < 0:
        return None
    if flags.value & 1 and (nn.value or nu.value):
        for ptr in (pos_p, nrm_p, uv_p, f_p):
            lib.rn_free(ptr)
        return None
    positions = _take(lib, pos_p, nv.value * 3, np.float32).reshape(-1, 3)
    normals_src = _take(lib, nrm_p, nn.value * 3, np.float32).reshape(-1, 3)
    uvs_src = _take(lib, uv_p, nu.value * 2, np.float32).reshape(-1, 2)
    faces = _take(lib, f_p, nf.value * 3, np.int32).reshape(-1, 3).astype(
        np.int64)
    normals = (normals_src if len(normals_src) == len(positions)
               else smooth_normals_native(positions, faces))
    uvs = (uvs_src if len(uvs_src) == len(positions)
           else np.zeros((len(positions), 2), np.float32))
    return {"positions": positions, "normals": normals, "uvs": uvs,
            "faces": faces}


def smooth_normals_native(positions: np.ndarray, faces: np.ndarray):
    """Area-weighted smooth vertex normals (V, 3) f32, by the library,
    or by `io.obj.smooth_normals` without it."""
    if not available():
        from .obj import smooth_normals
        return smooth_normals(positions, faces)
    positions = np.ascontiguousarray(positions, np.float32)
    f32 = np.ascontiguousarray(faces, np.int32)
    out = np.zeros_like(positions)
    load().rn_smooth_normals(
        positions.ctypes.data_as(C.POINTER(C.c_float)), len(positions),
        f32.ctypes.data_as(C.POINTER(C.c_int)), len(f32),
        out.ctypes.data_as(C.POINTER(C.c_float)))
    return out


def build_midpoint_bvh(positions: np.ndarray, faces: np.ndarray):
    """The reference-semantics midpoint BVH (the largest axis's midpoint,
    the other axes on failure, a leaf when no axis splits): a dict of
    bounds (2F-1, 6) f32, meta (2F-1, 2) uint32 (a leaf's first and
    count, an internal node's left child and 0), order (F,) uint32 and
    nodes_used (the nodes written, from the front), or None without the
    library or when F < 1."""
    if not available():
        return None
    lib = load()
    positions = np.ascontiguousarray(positions, np.float32)
    f32 = np.ascontiguousarray(faces, np.int32)
    b_p = C.POINTER(C.c_float)()
    m_p = C.POINTER(C.c_uint32)()
    o_p = C.POINTER(C.c_uint32)()
    n = lib.rn_build_midpoint_bvh(
        positions.ctypes.data_as(C.POINTER(C.c_float)), len(positions),
        f32.ctypes.data_as(C.POINTER(C.c_int)), len(f32),
        C.byref(b_p), C.byref(m_p), C.byref(o_p))
    if n < 0:
        return None
    total = 2 * len(f32) - 1
    return {"bounds": _take(lib, b_p, total * 6, np.float32).reshape(-1, 6),
            "meta": _take(lib, m_p, total * 2, np.uint32).reshape(-1, 2),
            "order": _take(lib, o_p, len(f32), np.uint32), "nodes_used": n}


def morton_order(centroids: np.ndarray):
    """30-bit morton codes of (N, 3) centroids over their bounds and
    their stable ascending order: a dict of codes (N,) uint32 and order
    (N,) int32, or None without the library."""
    if not available():
        return None
    c = np.ascontiguousarray(centroids, np.float32)
    codes = np.zeros(len(c), np.uint32)
    order = np.zeros(len(c), np.int32)
    load().rn_morton_order(c.ctypes.data_as(C.POINTER(C.c_float)), len(c),
                           codes.ctypes.data_as(C.POINTER(C.c_uint32)),
                           order.ctypes.data_as(C.POINTER(C.c_int)))
    return {"codes": codes, "order": order}
