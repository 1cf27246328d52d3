"""Built-in scenes of the render path (`raypt/scenes/builtin.py`):
the bench's Stanford bunny, the minimal triangle-on-ground scene and the
small textured scene (`textured_demo`).

Assets are looked up in RAYPT_DATA_DIR, `<repo>/data`, then the
reference data mount, as in the JAX package. Without
`stanford-bunny.obj` the bunny is a 5,120-triangle icosphere stand-in,
and without the sunset DDS cubemap the sky is procedural.
"""
from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch

from ..core.scene import MaterialDef, SceneBuilder
from ..core.types import EnvMap
from ..io.dds import load_env_cubemap
from ..io.obj import load_obj, smooth_normals

_DATA_CANDIDATES = (
    os.environ.get("RAYPT_DATA_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
    "/root/reference/data",
)


def _find_asset(name: str):
    for d in _DATA_CANDIDATES:
        if not d:
            continue
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def _procedural_sky(h: int = 64) -> EnvMap:
    """Gradient cubemap used when the sunset DDS is unavailable."""
    w = h
    ys = np.linspace(1.0, -1.0, h, dtype=np.float32)
    faces = []
    for f in range(6):
        if f == 2:   # +y: sky top
            img = np.full((h, w, 3), (0.45, 0.65, 1.0), np.float32)
        elif f == 3:  # -y: ground
            img = np.full((h, w, 3), (0.15, 0.12, 0.1), np.float32)
        else:
            t = (ys[:, None, None] * 0.5 + 0.5)
            img = (t * np.array([0.45, 0.65, 1.0], np.float32)
                   + (1 - t) * np.array([0.9, 0.85, 0.8], np.float32))
            img = np.broadcast_to(img, (h, w, 3)).astype(np.float32)
        faces.append(img)
    return EnvMap(data=torch.from_numpy(np.stack(faces)), is_cube=True)


@lru_cache(maxsize=1)
def load_reference_envmap() -> EnvMap:
    """The sunset cubemap (6, H, W, 3), or the procedural sky when the
    DDS is absent."""
    p = _find_asset("sunset_uncompressed.dds")
    if p is None:
        return _procedural_sky()
    return EnvMap(data=torch.from_numpy(load_env_cubemap(p)), is_cube=True)


def _icosphere(subdiv: int = 4):
    """Procedural smooth mesh (5,120 tris at subdiv 4), the bunny's
    stand-in when the OBJ is absent."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [tuple(v) for v in verts]
    cache = {}

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        m = np.array(verts[a]) + np.array(verts[b])
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nf
    pos = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    return {"positions": pos, "normals": pos.copy(), "faces": f,
            "uvs": np.zeros((len(pos), 2), np.float32)}


@lru_cache(maxsize=1)
def bunny_mesh():
    """Stanford bunny (69,451 tris) with smooth normals, or the
    icosphere stand-in."""
    p = _find_asset("stanford-bunny.obj")
    if p is None:
        return _icosphere(4)
    mesh = load_obj(p)
    if np.allclose(mesh["normals"], 0):
        mesh["normals"] = smooth_normals(mesh["positions"], mesh["faces"])
    return mesh


def triangle_ground() -> SceneBuilder:
    """Single triangle above a ground quad."""
    b = SceneBuilder(env=_procedural_sky(16))
    ground = b.add_material(MaterialDef(albedo=(0.7, 0.7, 0.7)))
    red = b.add_material(MaterialDef(albedo=(0.9, 0.2, 0.2)))
    b.add_quad((-5, -1, 5), (5, -1, 5), (5, -1, -5), (-5, -1, -5), ground)
    b.add_triangle((-1, 0, -3), (1, 0, -3), (0, 1.5, -3), red)
    b.camera.position = (0, 0.5, 2)
    return b


def _bunny_transform() -> np.ndarray:
    """translate(30, -18, 20) * rotY(-pi) * scale(150): the reference's
    scene transform composed with its importer's root rotation."""
    c, s = math.cos(-math.pi), math.sin(-math.pi)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                         np.float32) * 150.0
    m[:3, 3] = (30, -18, 20)
    return m


def stanford_bunny(builder: SceneBuilder | None = None) -> SceneBuilder:
    """Bunny mesh (specular green, rough 0.8), 100x ground quad at
    y=-12.45, emissive teal sphere light; standalone, the camera frames
    the bunny (the bench scene)."""
    b = builder if builder is not None else SceneBuilder(
        env=load_reference_envmap())
    mesh = bunny_mesh()
    mat = b.add_material(MaterialDef(
        albedo=(1, 1, 1), specular=(0.3, 1.0, 0.3),
        specular_percent=0.5, roughness=0.8))
    b.add_mesh(mesh["positions"], mesh["normals"], mesh["faces"],
               uvs=mesh["uvs"], transform=_bunny_transform(), material=mat)

    off = np.array([20, 0, 0], np.float32)
    sc = np.array([50, 1, 50], np.float32)
    ground = b.add_material(MaterialDef(albedo=(0.7, 0.7, 0.7)))
    b.add_quad(sc * (-1, -12.45, 1) + off, sc * (1, -12.45, 1) + off,
               sc * (1, -12.45, -1) + off, sc * (-1, -12.45, -1) + off,
               ground)
    light = b.add_material(MaterialDef(albedo=(0, 0, 0),
                                       emissive=(3.0, 9.0, 7.0)))
    b.add_sphere((30, 10, 40), 8, light)
    if builder is None:
        b.camera.position = (32.5, -2.0, 0.0)
        b.camera.angle_y = 180.0
    return b


def textured_demo(checker_res: int = 64) -> SceneBuilder:
    """A small textured scene: a checker-textured ground (uvs to 4), two
    icospheres of 320 triangles, an emissive sphere light and an HDR
    gradient sky as an equirect panorama."""
    h, w = 64, 128
    ys = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    sky = ((1 - ys) * np.array([2.5, 3.0, 4.0], np.float32)
           + ys * np.array([0.4, 0.3, 0.25], np.float32))
    env = EnvMap(data=torch.from_numpy(np.broadcast_to(sky, (h, w, 3)).copy()),
                 is_cube=False)
    b = SceneBuilder(env=env)

    check = (np.indices((checker_res, checker_res)).sum(0) // 8 % 2
             ).astype(np.float32)
    tid = b.add_texture(np.stack([check, check * 0.6 + 0.2, 1.0 - check], -1))
    floor_mat = b.add_material(MaterialDef(albedo=(0.9, 0.9, 0.9),
                                           texture=tid))
    g = 12.0
    pos = np.array([[-g, -1, g], [g, -1, g], [g, -1, -g], [-g, -1, -g]],
                   np.float32)
    nrm = np.tile([[0, 1, 0]], (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    b.add_mesh(pos, nrm, np.array([[0, 1, 2], [0, 2, 3]]), uvs=uv,
               material=floor_mat)

    ico = _icosphere(2)
    glossy = b.add_material(MaterialDef(albedo=(0.9, 0.6, 0.3),
                                        specular=(0.9, 0.9, 0.9),
                                        specular_percent=0.4, roughness=0.15))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (-1.5, 0.2, -5)
    b.add_mesh(ico["positions"], ico["normals"], ico["faces"], transform=t,
               material=glossy)
    diffuse = b.add_material(MaterialDef(albedo=(0.3, 0.5, 0.9)))
    t2 = np.eye(4, dtype=np.float32) * 0.7
    t2[3, 3] = 1.0
    t2[:3, 3] = (1.6, -0.3, -4.2)
    b.add_mesh(ico["positions"], ico["normals"], ico["faces"], transform=t2,
               material=diffuse)

    light = b.add_material(MaterialDef(albedo=(0, 0, 0),
                                       emissive=(12.0, 11.0, 9.0)))
    b.add_sphere((0, 4.0, -4), 0.8, light)
    b.camera.position = (0, 0.6, 1.5)
    return b
