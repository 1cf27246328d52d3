"""Optimizable scene parameters for inverse rendering
(`raypt/diff/params.py`).

Parameters live in unconstrained space and are mapped into the scene:
  vertex_offsets: additive, world units
  albedo/specular: sigmoid -> (0, 1)
  roughness/specular_percent: sigmoid -> (0, 1)
  emissive: softplus -> [0, inf)
  camera: origin delta + ray-frame deltas
  lattice_scalar (optional): a (K, K, K) displacement field along the
    vertex normals, trilinearly sampled at the base positions

`SceneParams` is an `nn.Module` whose parameters carry the JAX package's
field names, so a `torch.optim` optimizer steps them in place.
`replace` (and so a `param_map`) returns `ParamValues`, plain tensors
under the same names, through which gradients reach the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.types import CameraRays, Scene

FIELDS = ("vertex_offsets", "albedo_logits", "specular_logits",
          "emissive_raw", "roughness_logits", "specular_percent_logits",
          "cam_origin_delta", "cam_frame_delta", "lattice_scalar")


def _inv_sigmoid(x, eps=1e-5):
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def _inv_softplus(x, eps=1e-6):
    x = torch.clamp(x, min=eps)
    return x + torch.log(-torch.expm1(-x))


@dataclasses.dataclass
class ParamValues:
    """The values of a SceneParams (or of a map of one) as plain
    tensors, under its field names."""
    vertex_offsets: torch.Tensor        # (V, 3)
    albedo_logits: torch.Tensor         # (M, 3)
    specular_logits: torch.Tensor       # (M, 3)
    emissive_raw: torch.Tensor          # (M, 3) softplus-space
    roughness_logits: torch.Tensor      # (M,)
    specular_percent_logits: torch.Tensor  # (M,)
    cam_origin_delta: torch.Tensor      # (3,)
    cam_frame_delta: torch.Tensor       # (3, 3): lower_left/horiz./vertical
    lattice_scalar: Optional[torch.Tensor] = None   # (K, K, K)

    def replace(self, **kw) -> "ParamValues":
        return dataclasses.replace(self, **kw)


class SceneParams(nn.Module):
    """Unconstrained optimizable parameters, one `nn.Parameter` a field
    (`lattice_scalar` is None, and no parameter, without a lattice)."""

    def __init__(self, vertex_offsets, albedo_logits, specular_logits,
                 emissive_raw, roughness_logits, specular_percent_logits,
                 cam_origin_delta, cam_frame_delta, lattice_scalar=None):
        super().__init__()
        for name, v in zip(FIELDS, (
                vertex_offsets, albedo_logits, specular_logits, emissive_raw,
                roughness_logits, specular_percent_logits, cam_origin_delta,
                cam_frame_delta, lattice_scalar)):
            self.register_parameter(
                name, None if v is None else nn.Parameter(v.detach().clone()))

    @staticmethod
    def init(scene: Scene, lattice: int = 0) -> "SceneParams":
        """Parameters reproducing `scene` (zero-residual init), on its
        device; lattice > 0 adds the displacement field at that
        resolution."""
        m = scene.materials
        dev = scene.mesh.positions.device
        return SceneParams(
            vertex_offsets=torch.zeros_like(scene.mesh.positions),
            albedo_logits=_inv_sigmoid(m.albedo),
            specular_logits=_inv_sigmoid(m.specular),
            emissive_raw=_inv_softplus(m.emissive + 1e-6),
            roughness_logits=_inv_sigmoid(m.roughness),
            specular_percent_logits=_inv_sigmoid(m.specular_percent),
            cam_origin_delta=torch.zeros(3, device=dev),
            cam_frame_delta=torch.zeros((3, 3), device=dev),
            lattice_scalar=(torch.zeros((lattice,) * 3, device=dev)
                            if lattice else None))

    def replace(self, **kw) -> ParamValues:
        """The fields as ParamValues, those in kw replaced."""
        values = {name: getattr(self, name) for name in FIELDS}
        return ParamValues(**values).replace(**kw)


def params_from_numpy(d: dict, device="cuda") -> SceneParams:
    """The port's SceneParams from the JAX package's SceneParams fields
    as numpy arrays, keyed by field name (a missing or None
    "lattice_scalar" means none)."""
    return SceneParams(**{
        name: None if d.get(name) is None else
        torch.from_numpy(np.array(d[name], np.float32))
        for name in FIELDS}).to(device)


def sample_lattice(lat: torch.Tensor, pos: torch.Tensor, bmin: torch.Tensor,
                   bmax: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a (K, K, K) scalar lattice at world points pos
    (..., 3) over the [bmin, bmax] box, clamped to K - 1 - 1e-4.
    Differentiable w.r.t. lat: its eight corner reads are index
    gathers, whose backward is the deterministic sort-based
    accumulate."""
    k = lat.shape[0]
    u = (pos - bmin) / torch.clamp(bmax - bmin, min=1e-6) * (k - 1)
    u = torch.clamp(u, 0.0, k - 1 - 1e-4)
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0
    out = 0.0
    for dx in (0, 1):
        wx = f[..., 0] if dx else 1.0 - f[..., 0]
        for dy in (0, 1):
            wy = f[..., 1] if dy else 1.0 - f[..., 1]
            for dz in (0, 1):
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                c = lat[torch.clamp(i0[..., 0] + dx, max=k - 1),
                        torch.clamp(i0[..., 1] + dy, max=k - 1),
                        torch.clamp(i0[..., 2] + dz, max=k - 1)]
                out = out + wx * wy * wz * c
    return out


def geometry_offsets(scene: Scene, p) -> torch.Tensor:
    """Total per-vertex world-space offset: vertex_offsets plus, with a
    lattice, its displacement along the vertex normal. The base
    positions and normals carry no gradient."""
    off = p.vertex_offsets
    if p.lattice_scalar is not None:
        base = scene.mesh.positions.detach()
        bmin = torch.amin(base, dim=0)
        bmax = torch.amax(base, dim=0)
        n = scene.mesh.normals
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-9)
        s = sample_lattice(p.lattice_scalar, base, bmin, bmax)
        off = off + s[:, None] * n.detach()
    return off


def apply_params(scene: Scene, p) -> Scene:
    """The scene the parameters realize (a SceneParams or ParamValues),
    differentiable in them: mesh positions, materials and camera."""
    mesh = scene.mesh.replace(
        positions=scene.mesh.positions + geometry_offsets(scene, p))
    mats = scene.materials.replace(
        albedo=torch.sigmoid(p.albedo_logits),
        specular=torch.sigmoid(p.specular_logits),
        emissive=nn.functional.softplus(p.emissive_raw),
        roughness=torch.sigmoid(p.roughness_logits),
        specular_percent=torch.sigmoid(p.specular_percent_logits))
    cam = scene.camera
    cam = CameraRays(origin=cam.origin + p.cam_origin_delta,
                     lower_left=cam.lower_left + p.cam_frame_delta[0],
                     horizontal=cam.horizontal + p.cam_frame_delta[1],
                     vertical=cam.vertical + p.cam_frame_delta[2])
    return scene.replace(mesh=mesh, materials=mats, camera=cam)


def freeze_except(params: SceneParams, trainable: Sequence[str]) -> None:
    """Set the gradient of every field not named in `trainable`, and of
    any field that got none, to zeros, never to None: optax updates
    every field with one shared step count, and `torch.optim.Adam`
    keeps a field's count only while the field has a gradient."""
    for name, p in params.named_parameters():
        if name not in trainable or p.grad is None:
            p.grad = torch.zeros_like(p)
