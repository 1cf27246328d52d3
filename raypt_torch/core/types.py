"""Scene containers of the port: dataclasses of torch tensors, SoA
layout, padded to fixed capacities with validity masks
(`raypt/core/types.py`).

Every container has `.to(device)`, which returns a copy whose tensors
live on `device`; autograd leaves are made by the caller
(`dataclasses.replace` a field with a tensor that requires grad).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _to(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, TensorTree):
        return value.to(device)
    return value


class TensorTree:
    """Mixin for dataclasses whose fields are tensors or other
    TensorTrees."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Materials(TensorTree):
    """(M, 3) albedo / emissive / specular; (M,) roughness,
    specular_percent, refraction_percent, ior; (M,) int32 texture id."""
    albedo: torch.Tensor
    emissive: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    specular_percent: torch.Tensor
    refraction_percent: torch.Tensor
    ior: torch.Tensor
    texture: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.albedo.shape[0]


@dataclasses.dataclass
class Spheres(TensorTree):
    center: torch.Tensor      # (S, 3) f32
    radius: torch.Tensor      # (S,) f32
    material: torch.Tensor    # (S,) int32
    valid: torch.Tensor       # (S,) bool

    @property
    def capacity(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass
class MeshArrays(TensorTree):
    positions: torch.Tensor      # (V, 3) f32
    normals: torch.Tensor        # (V, 3) f32
    uvs: torch.Tensor            # (V, 2) f32
    faces: torch.Tensor          # (F, 3) int32
    face_material: torch.Tensor  # (F,) int32
    face_valid: torch.Tensor     # (F,) bool

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


@dataclasses.dataclass
class EnvMap(TensorTree):
    """Cubemap (6, H, W, 3) f32 (`is_cube`), or equirect (H, W, 3)."""
    data: torch.Tensor
    is_cube: bool = True

    @staticmethod
    def constant(color=(0.0, 0.0, 0.0)) -> "EnvMap":
        data = torch.tensor(color, dtype=torch.float32).expand(6, 1, 1, 3)
        return EnvMap(data=data.contiguous(), is_cube=True)


@dataclasses.dataclass
class CameraRays(TensorTree):
    """Ray-gen frame; get_ray(u, v) = (origin, lower_left + u*horizontal
    + v*vertical - origin), direction unnormalized."""
    origin: torch.Tensor       # (3,) f32
    lower_left: torch.Tensor   # (3,) f32
    horizontal: torch.Tensor   # (3,) f32
    vertical: torch.Tensor     # (3,) f32

    def get_ray(self, u: torch.Tensor, v: torch.Tensor):
        d = (self.lower_left
             + u[..., None] * self.horizontal
             + v[..., None] * self.vertical
             - self.origin)
        return self.origin.expand(d.shape), d


@dataclasses.dataclass
class Scene(TensorTree):
    materials: Materials
    spheres: Spheres
    mesh: MeshArrays
    env: EnvMap
    camera: CameraRays
    textures: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters, with the JAX package's fields and
    defaults. The port renders `backend="onehot"` (its defaults,
    `onehot_expand=0`, select the dense-union branch; `onehot_expand > 0`
    the per-ray-exact one; an accel with a Woop table the Woop branch),
    `"cluster"`, `"bruteforce"`, `"dense"`, `"pallas"` and `"auto"`; the
    `bvh` backends raise where they are read."""
    width: int = 1024
    height: int = 768
    samples_per_pixel: int = 5
    num_bounces: int = 6
    env_radiance_clamp: float = 50.0
    normal_offset: float = 0.01
    exposure: float = 0.5
    russian_roulette: bool = True
    enable_refraction: bool = False
    env_yaw_pi: bool = True
    backend: str = "auto"
    traversal_mode: str = "tiled"
    traversal_tile: int = 8192
    traversal_unroll: int = 2
    leaf_tris: int = 1
    node_lookahead: bool = False
    pixel_block: int = 32
    ray_sort: bool = False
    onehot_expand: int = 0
    onehot_compact: int = 0
    # the bench path builds with leaf 384; pass the leaf explicitly
    onehot_leaf: int = 128

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


_GROUPS = {"materials": Materials, "spheres": Spheres, "mesh": MeshArrays,
           "camera": CameraRays}


def scene_from_numpy(leaves: dict, device="cuda") -> Scene:
    """Build a `Scene` on `device` from numpy arrays keyed
    "<group>.<field>" (e.g. "mesh.positions", "env.data",
    "env.is_cube"), as read from the leaves of a frozen JAX-package
    `Scene`. Missing "textures" means none."""
    groups = {}
    for name, cls in _GROUPS.items():
        groups[name] = cls(**{
            f.name: torch.from_numpy(
                np.array(leaves[f"{name}.{f.name}"]))
            for f in dataclasses.fields(cls)})
    env = EnvMap(data=torch.from_numpy(np.array(leaves["env.data"])),
                 is_cube=bool(leaves["env.is_cube"]))
    tex = leaves.get("textures")
    return Scene(env=env, textures=None if tex is None
                 else torch.from_numpy(np.array(tex)), **groups).to(device)
