"""Minimal OBJ mesh loader (numpy; a copy of `raypt/io/obj.py`), with
the native parser of `io.native` first where it applies.

Replaces the reference's Assimp import path (utils/AssimpLoader.cpp:29-51
with aiProcess_Triangulate | JoinIdenticalVertices | GenSmoothNormals
| SortByPType) for the formats the reference actually consumes (the
Stanford bunny: pure v/f records). Supports v, vn, vt, f with 1-based,
negative, and v/vt/vn-style indices; polygons are fan-triangulated
(Assimp's Triangulate equivalent); missing normals are generated
angle-weighted-smooth (GenSmoothNormals equivalent; we use area-weighted
accumulation which matches Assimp's default behaviour for smooth meshes
like the bunny).
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str, use_native: bool = True):
    """Parse an OBJ file -> dict with positions (V,3) f32, normals (V,3)
    f32, uvs (V,2) f32, faces (F,3) i64. Vertices referenced with
    differing vt/vn combinations are split, so the output is a
    consistent indexed mesh.

    With use_native, the native parser (`io.native.load_obj_native`)
    reads the file when the library is available and no corner needs
    splitting; otherwise this Python parser does.
    """
    if use_native:
        from .native import load_obj_native
        m = load_obj_native(path)
        if m is not None:
            return m
    positions, normals, uvs = [], [], []
    out_pos, out_nrm, out_uv, out_faces = [], [], [], []
    corner_cache: dict = {}
    simple_faces = []   # faces that only index positions ("f a b c")
    any_split = False   # saw an "a/b/c"-style corner

    def corner(tok: str) -> int:
        key = tok
        idx = corner_cache.get(key)
        if idx is not None:
            return idx
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(uvs) + t
        if len(parts) > 2 and parts[2]:
            n = int(parts[2])
            ni = n - 1 if n > 0 else len(normals) + n
        idx = len(out_pos)
        out_pos.append(positions[vi])
        out_uv.append(uvs[ti] if ti is not None else (0.0, 0.0))
        out_nrm.append(normals[ni] if ni is not None else None)
        corner_cache[key] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v" and len(tok) >= 4:
                positions.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "vn" and len(tok) >= 4:
                normals.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "vt" and len(tok) >= 3:
                uvs.append((float(tok[1]), float(tok[2])))
            elif tok[0] == "f" and len(tok) >= 4:
                if any("/" in t for t in tok[1:]):
                    any_split = True
                if any_split:
                    ids = [corner(t) for t in tok[1:]]
                    for k in range(1, len(ids) - 1):  # fan triangulation
                        out_faces.append((ids[0], ids[k], ids[k + 1]))
                else:
                    ids = [int(t) for t in tok[1:]]
                    ids = [i - 1 if i > 0 else len(positions) + i for i in ids]
                    for k in range(1, len(ids) - 1):
                        simple_faces.append((ids[0], ids[k], ids[k + 1]))

    if any_split:
        # re-route pure-position faces through the corner table too
        for f in simple_faces:
            out_faces.append(tuple(corner(str(i + 1)) for i in f))
        pos = np.asarray(out_pos, np.float32)
        faces = np.asarray(out_faces, np.int64)
        uv = (np.asarray(out_uv, np.float32)
              if out_uv else np.zeros((len(pos), 2), np.float32))
        if any(n is None for n in out_nrm):
            nrm = smooth_normals(pos, faces)
        else:
            nrm = np.asarray(out_nrm, np.float32)
    else:
        # pure "f a b c" file (e.g. the Stanford bunny): keep the raw
        # vertex table so counts match the source exactly
        pos = np.asarray(positions, np.float32)
        faces = np.asarray(simple_faces, np.int64)
        uv = np.zeros((len(pos), 2), np.float32)
        if normals and len(normals) == len(positions):
            nrm = np.asarray(normals, np.float32)
        else:
            nrm = smooth_normals(pos, faces)
    return {"positions": pos, "normals": nrm, "uvs": uv, "faces": faces}


def smooth_normals(positions: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (Assimp GenSmoothNormals
    analogue used by the reference import, AssimpLoader.cpp:36)."""
    n = np.zeros_like(positions)
    p0 = positions[faces[:, 0]]
    p1 = positions[faces[:, 1]]
    p2 = positions[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)  # magnitude = 2*area => area weighting
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    ln[ln == 0] = 1.0
    return (n / ln).astype(np.float32)
