"""Host scene builder (`raypt/core/scene.py`): numpy state, frozen into
a `Scene` of tensors by `freeze(device)`. Capacities are padded as in
the JAX package, so both packages freeze a builder to identical arrays.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .camera import Camera
from .types import EnvMap, Materials, MeshArrays, Scene, Spheres


def _pad_capacity(n: int) -> int:
    """Next power of two up to 8192 (min 8), then the next multiple of
    8192."""
    c = 8
    while c < n and c < 8192:
        c *= 2
    if n > c:
        c = -(-n // 8192) * 8192
    return c


class MaterialDef:
    def __init__(self, albedo=(0, 0, 0), emissive=(0, 0, 0), specular=(0, 0, 0),
                 roughness=0.9, specular_percent=0.0, ior=1.0, texture=-1,
                 refraction_percent=0.0):
        self.albedo = tuple(map(float, albedo))
        self.emissive = tuple(map(float, emissive))
        self.specular = tuple(map(float, specular))
        self.roughness = float(roughness)
        self.specular_percent = float(specular_percent)
        self.refraction_percent = float(refraction_percent)
        self.ior = float(ior)
        self.texture = int(texture)


class SceneBuilder:
    def __init__(self, env: Optional[EnvMap] = None):
        self.camera = Camera()
        self._materials: list[MaterialDef] = []
        self._spheres: list[tuple] = []          # (center, radius, material)
        self._positions: list = []
        self._normals: list = []
        self._uvs: list = []
        self._faces: list = []                   # (v0, v1, v2, material)
        self.env = env if env is not None else EnvMap.constant()

    def add_material(self, material: MaterialDef) -> int:
        self._materials.append(material)
        return len(self._materials) - 1

    def add_sphere(self, center, radius: float, material: int = 0) -> None:
        self._spheres.append((tuple(map(float, center)), float(radius),
                              int(material)))

    def add_triangle(self, a, b, c, material: int = 0) -> None:
        """Flat-shaded triangle, normal = normalize(cross(c-b, a-b))."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        c = np.asarray(c, np.float32)
        n = np.cross(c - b, a - b)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else np.array([0, 1, 0], np.float32)
        i0 = len(self._positions)
        for p in (a, b, c):
            self._positions.append(p)
            self._normals.append(n.astype(np.float32))
            self._uvs.append(np.zeros(2, np.float32))
        self._faces.append((i0, i0 + 1, i0 + 2, int(material)))

    def add_quad(self, a, b, c, d, material: int = 0) -> None:
        """Two triangles (a, b, c) and (c, d, a)."""
        self.add_triangle(a, b, c, material)
        self.add_triangle(c, d, a, material)

    def add_mesh(self, positions, normals, faces, uvs=None,
                 transform: Optional[np.ndarray] = None,
                 material: int = 0) -> None:
        """Indexed mesh; an optional 4x4 transform applies to positions
        (w=1) and normals (w=0)."""
        positions = np.asarray(positions, np.float32)
        normals = np.asarray(normals, np.float32)
        faces = np.asarray(faces, np.int64)
        uvs = (np.zeros((len(positions), 2), np.float32)
               if uvs is None else np.asarray(uvs, np.float32))
        if transform is not None:
            m = np.asarray(transform, np.float32)
            positions = positions @ m[:3, :3].T + m[:3, 3]
            normals = normals @ m[:3, :3].T
        offset = len(self._positions)
        self._positions.extend(positions)
        self._normals.extend(normals)
        self._uvs.extend(uvs)
        for f in faces:
            self._faces.append((int(f[0]) + offset, int(f[1]) + offset,
                                int(f[2]) + offset, int(material)))

    def freeze(self, device="cpu") -> Scene:
        nmat = max(len(self._materials), 1)
        nsph = len(self._spheres)
        nvert = max(len(self._positions), 1)
        nface = len(self._faces)
        cm = _pad_capacity(nmat)
        cs = _pad_capacity(max(nsph, 1))
        cv = _pad_capacity(nvert)
        cf = _pad_capacity(max(nface, 1))
        # a default MaterialDef with albedo 1 fills the slots exactly as
        # the padding values do, so an empty builder needs no branch
        mats = self._materials or [MaterialDef(albedo=(1, 1, 1))]

        materials = Materials(
            albedo=_fill((cm, 3), [m.albedo for m in mats], 1.0),
            emissive=_fill((cm, 3), [m.emissive for m in mats], 0.0),
            specular=_fill((cm, 3), [m.specular for m in mats], 0.0),
            roughness=_fill((cm,), [m.roughness for m in mats], 0.9),
            specular_percent=_fill((cm,), [m.specular_percent for m in mats],
                                   0.0),
            refraction_percent=_fill(
                (cm,), [m.refraction_percent for m in mats], 0.0),
            ior=_fill((cm,), [m.ior for m in mats], 1.0),
            texture=_fill((cm,), [m.texture for m in mats], -1, np.int32))
        spheres = Spheres(
            center=_fill((cs, 3), [s[0] for s in self._spheres], 0.0),
            radius=_fill((cs,), [s[1] for s in self._spheres], 0.0),
            material=_fill((cs,), [s[2] for s in self._spheres], 0, np.int32),
            valid=torch.from_numpy(np.arange(cs) < nsph))
        mesh = MeshArrays(
            positions=_fill((cv, 3), self._positions, 0.0),
            normals=_fill((cv, 3), self._normals, 0.0),
            uvs=_fill((cv, 2), self._uvs, 0.0),
            faces=_fill((cf, 3), [f[:3] for f in self._faces], 0, np.int32),
            face_material=_fill((cf,), [f[3] for f in self._faces], 0,
                                np.int32),
            face_valid=torch.from_numpy(np.arange(cf) < nface))
        return Scene(materials=materials, spheres=spheres, mesh=mesh,
                     env=self.env, camera=self.camera.rays()).to(device)

    @property
    def num_faces(self) -> int:
        return len(self._faces)


def _fill(shape, rows: Sequence, fill_value, dtype=np.float32):
    out = np.full(shape, fill_value, dtype)
    if len(rows):
        arr = np.asarray(rows, dtype)
        out[: len(rows)] = arr.reshape((len(rows),) + shape[1:])
    return torch.from_numpy(out)
