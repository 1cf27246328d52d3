"""Minimal glTF 2.0 mesh loader (.gltf JSON + .glb binary container;
numpy, a copy of `raypt/io/gltf.py`).

It walks the glTF scene graph as the reference's Assimp import does
(utils/AssimpLoader.cpp:8-27): node-local TRS/matrix transforms
composed root-down. Every triangle primitive is flattened into one
indexed mesh with the contract of io.obj: positions (V,3) f32, normals
(V,3) f32, uvs (V,2) f32, faces (F,3) i64.

Extras beyond the other loaders (returned only when present so the
dict stays drop-in compatible): "materials" — a list of dicts with
albedo/emissive/roughness/metallic from pbrMetallicRoughness — and
"face_materials" (F,) i64 indices into it, letting SceneBuilder carry
per-primitive materials through the same add_mesh path.

Supported: GLB v2 container, external .bin buffers, base64 data URIs,
interleaved bufferViews (byteStride), all accessor component types +
`normalized`, sparse accessors, triangle modes 4/5/6 (strips and fans
are converted), non-indexed primitives, node matrix or TRS transforms,
default-scene fallback. Missing NORMAL attributes are generated
area-weighted-smooth (Assimp GenSmoothNormals equivalent); normals are
transformed by the inverse-transpose and renormalized.
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


class GLTFError(ValueError):
    pass


def _parse_glb(raw: bytes):
    """GLB container -> (gltf json dict, BIN chunk bytes or None)."""
    if len(raw) < 12 or raw[:4] != b"glTF":
        raise GLTFError("not a GLB file")
    version, length = struct.unpack_from("<II", raw, 4)
    if version != 2:
        raise GLTFError(f"unsupported GLB version {version}")
    off = 12
    js, bin_chunk = None, None
    while off + 8 <= min(length, len(raw)):
        clen, ctype = struct.unpack_from("<II", raw, off)
        data = raw[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:          # 'JSON'
            js = json.loads(data.decode("utf-8"))
        elif ctype == 0x004E4942:        # 'BIN\0'
            bin_chunk = data
        off += 8 + clen + ((-clen) % 4 if ctype == 0x4E4F534A else 0)
        # chunks are 4-byte aligned; GLB writers pad JSON with spaces
        # and BIN with zeros *inside* clen, so no extra skip is needed
        # beyond clen for spec-conformant files. (The JSON branch above
        # tolerates writers that pad outside clen.)
    if js is None:
        raise GLTFError("GLB missing JSON chunk")
    return js, bin_chunk


def _load_buffers(gltf: dict, bin_chunk, base_dir: str):
    bufs = []
    for i, b in enumerate(gltf.get("buffers", [])):
        uri = b.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise GLTFError(f"buffer {i} has no uri and no BIN chunk")
            bufs.append(bin_chunk)
        elif uri.startswith("data:"):
            _, _, payload = uri.partition(",")
            bufs.append(base64.b64decode(payload))
        else:
            # percent-decoding limited to %20, the common case
            path = os.path.join(base_dir, uri.replace("%20", " "))
            with open(path, "rb") as f:
                bufs.append(f.read())
        if len(bufs[-1]) < b.get("byteLength", 0):
            raise GLTFError(f"buffer {i} shorter than byteLength")
    return bufs


def _read_accessor(gltf: dict, buffers, idx: int) -> np.ndarray:
    """Accessor -> (count, width) ndarray in its native component type
    (normalized integers are scaled to float32 per spec)."""
    acc = gltf["accessors"][idx]
    count = acc["count"]
    width = _TYPE_WIDTH[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
    elem = dtype.itemsize * width

    bv_idx = acc.get("bufferView")
    if bv_idx is None:
        out = np.zeros((count, width), dtype)
    else:
        bv = gltf["bufferViews"][bv_idx]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or elem
        if stride == elem:
            out = np.frombuffer(data, dtype, count * width,
                                start).reshape(count, width)
        else:     # interleaved
            raw = np.frombuffer(data, np.uint8,
                                stride * (count - 1) + elem, start)
            rows = np.lib.stride_tricks.as_strided(
                raw, (count, elem), (stride, 1), writeable=False)
            out = rows.reshape(-1).view(dtype).reshape(count, width)

    sparse = acc.get("sparse")
    if sparse:
        out = out.copy()
        sc = sparse["count"]
        iv = sparse["indices"]
        ibv = gltf["bufferViews"][iv["bufferView"]]
        idt = np.dtype(_COMPONENT_DTYPES[iv["componentType"]]) \
            .newbyteorder("<")
        ind = np.frombuffer(buffers[ibv["buffer"]], idt, sc,
                            ibv.get("byteOffset", 0)
                            + iv.get("byteOffset", 0))
        vv = sparse["values"]
        vbv = gltf["bufferViews"][vv["bufferView"]]
        vals = np.frombuffer(buffers[vbv["buffer"]], dtype, sc * width,
                             vbv.get("byteOffset", 0)
                             + vv.get("byteOffset", 0)).reshape(sc, width)
        out[ind.astype(np.int64)] = vals

    if acc.get("normalized") and out.dtype.kind in "iu":
        info = np.iinfo(out.dtype)
        scale = float(max(-info.min, info.max))
        out = np.maximum(out.astype(np.float32) / scale, -1.0)
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:          # xyzw quaternion
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
             2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             1 - 2 * (x * x + y * y)]])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _tri_indices(idx: np.ndarray, mode: int) -> np.ndarray:
    """Index list -> (F,3) for triangles(4) / strip(5) / fan(6)."""
    if mode == 4:
        if len(idx) % 3:
            raise GLTFError("triangle index count not divisible by 3")
        return idx.reshape(-1, 3)
    if mode == 5:    # strip: winding alternates
        n = len(idx) - 2
        tris = np.stack([idx[:-2], idx[1:-1], idx[2:]], axis=1)
        odd = np.arange(n) % 2 == 1
        tris[odd] = tris[odd][:, [0, 2, 1]]
        return tris
    if mode == 6:    # fan
        return np.stack([np.broadcast_to(idx[0], (len(idx) - 2,)),
                         idx[1:-1], idx[2:]], axis=1)
    raise GLTFError(f"unsupported primitive mode {mode}")


def _materials(gltf: dict):
    out = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        out.append({
            "name": m.get("name", ""),
            "albedo": tuple(float(c) for c in base[:3]),
            "emissive": tuple(float(c)
                              for c in m.get("emissiveFactor", [0, 0, 0])),
            "roughness": float(pbr.get("roughnessFactor", 1.0)),
            "metallic": float(pbr.get("metallicFactor", 1.0)),
        })
    return out


def load_gltf(path_or_bytes, base_dir: str | None = None):
    """Load a .gltf/.glb file (path, or raw bytes) -> mesh dict (see
    module docstring). All triangle primitives reachable from the
    default scene (or every node, if no scene is declared) are
    flattened into one mesh in world space."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
        base = base_dir or "."
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
        base = base_dir or os.path.dirname(os.path.abspath(path_or_bytes))

    if raw[:4] == b"glTF":
        gltf, bin_chunk = _parse_glb(raw)
    else:
        gltf, bin_chunk = json.loads(raw.decode("utf-8")), None
    buffers = _load_buffers(gltf, bin_chunk, base)

    nodes = gltf.get("nodes", [])
    scenes = gltf.get("scenes", [])
    if scenes:
        roots = scenes[gltf.get("scene", 0)].get("nodes", [])
    else:
        child = {c for n in nodes for c in n.get("children", [])}
        roots = [i for i in range(len(nodes)) if i not in child]

    # recursive node walk accumulating transforms
    # (AssimpLoader.cpp:8-27 CopyNodes parity, minus the -90 deg X root
    # rotation, which is an Assimp z-up import artifact glTF defines
    # away: glTF is y-up like our world)
    flat: list[tuple[int, np.ndarray]] = []    # (mesh index, world 4x4)

    def walk(ni: int, parent: np.ndarray):
        node = nodes[ni]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            flat.append((node["mesh"], world))
        for c in node.get("children", []):
            walk(c, world)

    for r in roots:
        walk(r, np.eye(4))
    if not flat and gltf.get("meshes"):
        flat = [(i, np.eye(4)) for i in range(len(gltf["meshes"]))]

    all_pos, all_nrm, all_uv, all_faces, all_fmat = [], [], [], [], []
    vbase = 0
    for mesh_idx, world in flat:
        for prim in gltf["meshes"][mesh_idx].get("primitives", []):
            mode = prim.get("mode", 4)
            if mode not in (4, 5, 6):
                continue     # points/lines: not renderable geometry here
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]) \
                .astype(np.float64)
            n_v = len(pos)
            pos_w = pos @ world[:3, :3].T + world[:3, 3]

            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, buffers, attrs["NORMAL"]) \
                    .astype(np.float64)
                nit = np.linalg.inv(world[:3, :3]).T
                nrm_w = nrm @ nit.T
                ln = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
                nrm_w = nrm_w / np.maximum(ln, 1e-20)
            else:
                nrm_w = None

            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(gltf, buffers, attrs["TEXCOORD_0"]) \
                    .astype(np.float32)[:, :2]
            else:
                uv = np.zeros((n_v, 2), np.float32)

            if "indices" in prim:
                idx = _read_accessor(
                    gltf, buffers, prim["indices"]).reshape(-1) \
                    .astype(np.int64)
            else:
                idx = np.arange(n_v, dtype=np.int64)
            faces = _tri_indices(idx, mode)

            # a negative-determinant transform flips winding
            if np.linalg.det(world[:3, :3]) < 0:
                faces = faces[:, [0, 2, 1]]

            all_pos.append(pos_w.astype(np.float32))
            all_nrm.append(None if nrm_w is None
                           else nrm_w.astype(np.float32))
            all_uv.append(uv)
            all_faces.append(faces + vbase)
            all_fmat.append(np.full(len(faces),
                                    prim.get("material", -1), np.int64))
            vbase += n_v

    if not all_pos:
        raise GLTFError("no triangle primitives in file")
    positions = np.concatenate(all_pos)
    faces = np.concatenate(all_faces)
    if any(n is None for n in all_nrm):
        from .obj import smooth_normals
        normals = smooth_normals(positions, faces).astype(np.float32)
        for chunk, start in zip(
                all_nrm, np.cumsum([0] + [len(p) for p in all_pos[:-1]])):
            if chunk is not None:
                normals[start:start + len(chunk)] = chunk
    else:
        normals = np.concatenate(all_nrm)

    out = {"positions": positions, "normals": normals,
           "uvs": np.concatenate(all_uv), "faces": faces}
    mats = _materials(gltf)
    if mats:
        out["materials"] = mats
        out["face_materials"] = np.concatenate(all_fmat)
    return out
