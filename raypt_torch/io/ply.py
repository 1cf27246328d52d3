"""Minimal PLY mesh loader, ascii and binary little / big endian (a
copy of `raypt/io/ply.py`).

Returns the mesh dict of `io.obj.load_obj`: positions (V,3) f32, normals
(V,3) f32, uvs (V,2) f32, faces (F,3) i64. Polygon faces are
fan-triangulated; missing normals are generated smooth (area-weighted,
like the OBJ path). `load_mesh` picks OBJ, PLY or glTF by extension or
signature and calls the port's own loaders.
"""
from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


class PLYError(ValueError):
    pass


def _parse_header(raw: bytes):
    end = raw.find(b"end_header")
    if raw[:3] != b"ply" or end < 0:
        raise PLYError("not a PLY file")
    end = raw.find(b"\n", end) + 1
    lines = raw[:end].decode("ascii", "replace").splitlines()
    fmt = None
    elements = []       # [(name, count, [(prop_name, type, list_idx_type)])]
    for ln in lines[1:]:
        parts = ln.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise PLYError("property before element")
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))
        elif parts[0] in ("ply", "end_header"):
            pass
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise PLYError(f"unsupported format {fmt!r}")
    return fmt, elements, end


def _np_type(t, endian):
    if t not in _PLY_TYPES:
        raise PLYError(f"unsupported property type {t!r}")
    return np.dtype(endian + _PLY_TYPES[t])


def load_ply(path_or_bytes):
    """Parse a PLY file -> mesh dict (same contract as load_obj)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    fmt, elements, body_off = _parse_header(raw)
    endian = {"ascii": "=", "binary_little_endian": "<",
              "binary_big_endian": ">"}[fmt]

    data = {}
    if fmt == "ascii":
        tokens = raw[body_off:].split()
        ti = 0
        for name, count, props in elements:
            cols = {p: [] for p, _, _ in props}
            for _ in range(count):
                for p, t, list_t in props:
                    if list_t is not None:
                        k = int(tokens[ti]); ti += 1
                        cols[p].append([float(tokens[ti + j])
                                        for j in range(k)])
                        ti += k
                    else:
                        cols[p].append(float(tokens[ti])); ti += 1
            data[name] = cols
    else:
        off = body_off
        for name, count, props in elements:
            fixed = all(lt is None for _, _, lt in props)
            if fixed:
                dt = np.dtype([(p, _np_type(t, endian)) for p, t, _ in props])
                arr = np.frombuffer(raw, dt, count, off)
                off += dt.itemsize * count
                data[name] = {p: arr[p].astype(np.float64)
                              for p, _, _ in props}
            else:
                cols = {p: [] for p, _, _ in props}
                for _ in range(count):
                    for p, t, list_t in props:
                        if list_t is not None:
                            cdt = _np_type(list_t, endian)
                            k = int(np.frombuffer(raw, cdt, 1, off)[0])
                            off += cdt.itemsize
                            vdt = _np_type(t, endian)
                            v = np.frombuffer(raw, vdt, k, off)
                            off += vdt.itemsize * k
                            cols[p].append(v.astype(np.float64))
                        else:
                            vdt = _np_type(t, endian)
                            cols[p].append(float(
                                np.frombuffer(raw, vdt, 1, off)[0]))
                            off += vdt.itemsize
                data[name] = cols

    if "vertex" not in data:
        raise PLYError("no vertex element")
    v = data["vertex"]
    pos = np.stack([np.asarray(v["x"], np.float32),
                    np.asarray(v["y"], np.float32),
                    np.asarray(v["z"], np.float32)], axis=-1)
    nv = pos.shape[0]
    if all(k in v for k in ("nx", "ny", "nz")):
        nrm = np.stack([np.asarray(v["nx"], np.float32),
                        np.asarray(v["ny"], np.float32),
                        np.asarray(v["nz"], np.float32)], axis=-1)
    else:
        nrm = None
    if all(k in v for k in ("u", "v")):
        uv = np.stack([np.asarray(v["u"], np.float32),
                       np.asarray(v["v"], np.float32)], axis=-1)
    elif all(k in v for k in ("s", "t")):
        uv = np.stack([np.asarray(v["s"], np.float32),
                       np.asarray(v["t"], np.float32)], axis=-1)
    else:
        uv = np.zeros((nv, 2), np.float32)

    faces = []
    face_el = data.get("face", {})
    idx_col = None
    for key in ("vertex_indices", "vertex_index"):
        if key in face_el:
            idx_col = face_el[key]
            break
    if idx_col is not None:
        for poly in idx_col:
            ids = np.asarray(poly, np.int64)
            for k in range(1, len(ids) - 1):   # fan triangulation
                faces.append((ids[0], ids[k], ids[k + 1]))
    faces = (np.asarray(faces, np.int64) if faces
             else np.zeros((0, 3), np.int64))
    if faces.size and (faces.min() < 0 or faces.max() >= nv):
        raise PLYError("face index out of range")

    if nrm is None:
        from .obj import smooth_normals
        nrm = smooth_normals(pos, faces)
    return {"positions": pos, "normals": nrm.astype(np.float32),
            "uvs": uv, "faces": faces}


def load_mesh(path):
    """Format-dispatching mesh load: OBJ, PLY or glTF/GLB by extension,
    else by the file's first bytes."""
    p = str(path)
    low = p.lower()
    if low.endswith(".ply"):
        return load_ply(p)
    if low.endswith((".gltf", ".glb")):
        from .gltf import load_gltf
        return load_gltf(p)
    if low.endswith(".obj"):
        from .obj import load_obj
        return load_obj(p)
    with open(p, "rb") as f:
        head = f.read(4)
    if head[:3] == b"ply":
        return load_ply(p)
    if head == b"glTF" or head[:1] == b"{":
        from .gltf import load_gltf
        return load_gltf(p)
    from .obj import load_obj
    return load_obj(p)
