"""The config-4 scene (`raypt/scenes/config4.py`; BASELINE.json
configs[3]: "Multi-mesh Assimp scene with textures + HDR environment
light, 1024^2, 8 bounces, russian roulette").

  * the multi-mesh scene is authored as a glTF 2.0 GLB in memory (the
    bunny, an icosphere instanced by two nodes with different materials
    through one shared accessor set, and a ground quad, with pbr
    materials and TEXCOORD_0) and read back with `io.gltf.load_gltf`;
  * albedo textures (checker ground, marble bunny) ride the material
    texture stack (`render.shading.sample_albedo_texture`);
  * the environment is a procedural sun and sky panorama written and
    read back through the Radiance .hdr codec (`io.hdr`), an HDR
    equirect light;
  * one icosphere instance is glass (refraction_percent 0.96, ior 1.5):
    render with cfg.enable_refraction=True.
Without `stanford-bunny.obj` the bunny is the 5,120-triangle icosphere
stand-in, so the scene has 7,682 faces, padded to 8,192.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile

import numpy as np
import torch

from ..core.scene import MaterialDef, SceneBuilder
from ..core.types import EnvMap
from ..io.gltf import load_gltf
from ..io.hdr import load_hdr, write_hdr
from .builtin import _icosphere, bunny_mesh


def _pack_glb(gltf: dict, bin_chunk: bytes) -> bytes:
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    chunks = struct.pack("<II", len(js), 0x4E4F534A) + js
    bin_pad = bin_chunk + b"\0" * ((-len(bin_chunk)) % 4)
    chunks += struct.pack("<II", len(bin_pad), 0x004E4942) + bin_pad
    total = 12 + len(chunks)
    return b"glTF" + struct.pack("<II", 2, total) + chunks


def author_config4_glb() -> bytes:
    """Author the multi-mesh GLB (deterministic, in-memory).

    Meshes: 0 = bunny (normalized to sit on y=0, height 1.5),
    1/2 = icosphere sharing ONE accessor set but bound to different
    materials (chrome / glass), 3 = ground quad with tiled uvs.
    Nodes: bunny at origin; two sphere instances via node transforms;
    ground. Materials: bunny (textured marble), chrome (metallic),
    glass (ior via extension-free KHR-style transmission stand-in —
    carried as a name tag, resolved by config4_scene), ground
    (textured checker)."""
    bun = bunny_mesh()
    pos = np.asarray(bun["positions"], np.float32)
    lo, hi = pos.min(0), pos.max(0)
    scale = 1.5 / (hi[1] - lo[1])
    pos = (pos - [(lo[0] + hi[0]) / 2, lo[1], (lo[2] + hi[2]) / 2]) * scale
    nrm = np.asarray(bun["normals"], np.float32)
    # spherical uvs for the marble texture
    c = pos.mean(0)
    d = pos - c
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    buv = np.stack([np.arctan2(d[:, 0], d[:, 2]) / (2 * np.pi) + 0.5,
                    np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi],
                   axis=1).astype(np.float32)
    bfaces = np.asarray(bun["faces"], np.uint32)

    ico = _icosphere(3)
    spos = np.asarray(ico["positions"], np.float32)
    snrm = spos.copy()
    suv = np.zeros((len(spos), 2), np.float32)
    sfaces = np.asarray(ico["faces"], np.uint32)

    gpos = np.asarray([[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]],
                      np.float32)
    gnrm = np.asarray([[0, 1, 0]] * 4, np.float32)
    guv = np.asarray([[0, 0], [6, 0], [6, 6], [0, 6]], np.float32)
    gfaces = np.asarray([[0, 2, 1], [0, 3, 2]], np.uint32)

    blobs, views, accessors = [], [], []

    def add_blob(arr, target=None):
        off = sum(len(b) for b in blobs)
        raw = arr.tobytes()
        blobs.append(raw + b"\0" * ((-len(raw)) % 4))
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(raw)})
        return len(views) - 1

    def add_accessor(arr, ctype, atype):
        v = add_blob(arr)
        acc = {"bufferView": v, "componentType": ctype,
               "count": len(arr), "type": atype}
        if atype == "VEC3":
            acc["min"] = [float(x) for x in arr.min(0)]
            acc["max"] = [float(x) for x in arr.max(0)]
        accessors.append(acc)
        return len(accessors) - 1

    def add_mesh_accessors(p, n, uv, f):
        return {"POSITION": add_accessor(p, 5126, "VEC3"),
                "NORMAL": add_accessor(n, 5126, "VEC3"),
                "TEXCOORD_0": add_accessor(uv, 5126, "VEC2"),
                "idx": add_accessor(f.reshape(-1), 5125, "SCALAR")}

    ab = add_mesh_accessors(pos, nrm, buv, bfaces)
    as_ = add_mesh_accessors(spos, snrm, suv, sfaces)
    ag = add_mesh_accessors(gpos, gnrm, guv, gfaces)

    def prim(acc, mat):
        return {"attributes": {"POSITION": acc["POSITION"],
                               "NORMAL": acc["NORMAL"],
                               "TEXCOORD_0": acc["TEXCOORD_0"]},
                "indices": acc["idx"], "material": mat}

    gltf = {
        "asset": {"version": "2.0", "generator": "raypt config4"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2, 3]}],
        "nodes": [
            {"mesh": 0, "name": "bunny"},
            {"mesh": 1, "name": "sphere_chrome",
             "translation": [-1.6, 0.55, 0.9],
             "scale": [0.55, 0.55, 0.55]},
            {"mesh": 2, "name": "sphere_glass",
             "translation": [1.5, 0.5, 1.3],
             "scale": [0.5, 0.5, 0.5]},
            {"mesh": 3, "name": "ground"},
        ],
        "meshes": [
            {"primitives": [prim(ab, 0)], "name": "bunny"},
            {"primitives": [prim(as_, 1)], "name": "sphere_chrome"},
            # accessor sharing: same vertex data, different material
            {"primitives": [prim(as_, 2)], "name": "sphere_glass"},
            {"primitives": [prim(ag, 3)], "name": "ground"},
        ],
        "materials": [
            {"name": "bunny_marble", "pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.85, 0.8, 1.0],
                "roughnessFactor": 0.7, "metallicFactor": 0.15}},
            {"name": "chrome", "pbrMetallicRoughness": {
                "baseColorFactor": [0.95, 0.95, 0.97, 1.0],
                "roughnessFactor": 0.1, "metallicFactor": 0.9}},
            {"name": "glass", "pbrMetallicRoughness": {
                "baseColorFactor": [0.96, 0.99, 0.98, 1.0],
                "roughnessFactor": 0.0, "metallicFactor": 0.0}},
            {"name": "ground_checker", "pbrMetallicRoughness": {
                "baseColorFactor": [0.85, 0.85, 0.85, 1.0],
                "roughnessFactor": 0.9, "metallicFactor": 0.0}},
        ],
        "buffers": [{"byteLength": sum(len(b) for b in blobs)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    return _pack_glb(gltf, b"".join(blobs))


def _sun_sky(h: int = 256, w: int = 512) -> np.ndarray:
    """Procedural HDR sun + sky panorama (equirect, linear radiance;
    sun disk ~80x the sky peak so it is genuinely high dynamic range)."""
    v = (np.arange(h) + 0.5) / h          # 0 top .. 1 bottom
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi                      # polar
    phi = (u - 0.5) * 2 * np.pi
    y = np.cos(theta)[:, None] + 0 * phi[None, :]
    sky_t = np.clip(y, 0, 1) ** 0.6
    horizon = np.exp(-np.abs(y) * 6.0)
    col = (sky_t[..., None] * np.array([0.35, 0.55, 1.0])
           + (1 - sky_t[..., None]) * np.array([0.9, 0.75, 0.6]) * 0.5
           + horizon[..., None] * np.array([1.0, 0.55, 0.3]) * 0.6)
    # ground hemisphere: dim warm bounce
    col = np.where((y < 0)[..., None],
                   np.array([0.25, 0.22, 0.2]) * (0.3 + 0.7 * (1 + y[..., None])),
                   col)
    # sun disk
    sun_dir = np.array([0.45, 0.55, -0.6])
    sun_dir /= np.linalg.norm(sun_dir)
    dirs = np.stack([np.sin(theta)[:, None] * np.sin(phi)[None, :],
                     np.broadcast_to(np.cos(theta)[:, None], (h, w)),
                     np.sin(theta)[:, None] * -np.cos(phi)[None, :]], -1)
    cosang = dirs @ sun_dir
    col = col + np.exp((cosang[..., None] - 1.0) * 900.0) * \
        np.array([80.0, 70.0, 55.0])
    return col.astype(np.float32)


def _checker(n: int = 256, tiles: int = 8) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((yy * tiles // n + xx * tiles // n) % 2).astype(np.float32)
    base = 0.25 + 0.65 * c
    rgb = np.stack([base, base * 0.95, base * 0.9], -1)
    return rgb.astype(np.float32)


def _marble(n: int = 256) -> np.ndarray:
    yy, xx = np.meshgrid(np.linspace(0, 4, n), np.linspace(0, 4, n),
                         indexing="ij")
    veins = np.sin(6 * xx + 4 * np.sin(2 * yy) + 2 * np.sin(5 * xx))
    base = 0.7 + 0.25 * veins
    rgb = np.stack([base, base * 0.92, base * 0.85], -1)
    return np.clip(rgb, 0, 1).astype(np.float32)


def config4_scene(hdr_path: str | None = None) -> SceneBuilder:
    """The config-4 SceneBuilder: the GLB multi-mesh import, two albedo
    textures and the HDR sun/sky equirect environment. The panorama is
    written to `hdr_path` and read back (the .hdr round trip is part of
    the scene: RGBE quantises it); by default to a file under the
    system's temporary directory, never into the repository."""
    if hdr_path is None:
        hdr_path = os.path.join(tempfile.gettempdir(), "config4_sky.hdr")
    write_hdr(hdr_path, _sun_sky())
    sky = load_hdr(hdr_path)

    mesh = load_gltf(author_config4_glb())
    b = SceneBuilder(env=EnvMap(data=torch.from_numpy(sky), is_cube=False))

    tex_marble = b.add_texture(_marble())
    tex_checker = b.add_texture(_checker())
    by_name = {m["name"]: i for i, m in enumerate(mesh["materials"])}
    mat_ids = {}
    for name, i in by_name.items():
        m = mesh["materials"][i]
        if name == "bunny_marble":
            mat_ids[i] = b.add_material(MaterialDef(
                albedo=m["albedo"], roughness=m["roughness"],
                specular=(0.6, 0.6, 0.6),
                specular_percent=m["metallic"], texture=tex_marble))
        elif name == "chrome":
            mat_ids[i] = b.add_material(MaterialDef(
                albedo=m["albedo"], specular=(0.9, 0.9, 0.95),
                roughness=m["roughness"],
                specular_percent=m["metallic"]))
        elif name == "glass":
            mat_ids[i] = b.add_material(MaterialDef(
                albedo=m["albedo"], roughness=0.0,
                refraction_percent=0.96, ior=1.5))
        else:
            mat_ids[i] = b.add_material(MaterialDef(
                albedo=m["albedo"], roughness=m["roughness"],
                texture=tex_checker))

    fm = np.asarray(mesh["face_materials"])
    for mi in np.unique(fm):
        b.add_mesh(mesh["positions"], mesh["normals"],
                   mesh["faces"][fm == mi], uvs=mesh["uvs"],
                   material=mat_ids[int(mi)])

    b.camera.position = (0.4, 1.5, 4.2)
    b.camera.angle_x = -12.0
    b.camera.angle_y = 0.0
    return b
