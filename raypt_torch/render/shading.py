"""Differentiable hit shading with one shade-row gather per ray
(`raypt/render/shading.py`). The JAX package fetches material and sphere
rows with one-hot matmuls (a TPU workaround for slow gathers); here they
are index gathers, which give the same values.

Shade row layout (32 x f32):
  [0:3] p0  [3:6] e1  [6:9] e2  [9:12] n0 [12:15] n1 [15:18] n2
  [18:20] uv0 [20:22] uv1 [22:24] uv2  [24] material id (as float)
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.traverse import Hit, HitIds
from ..core.math3d import BIG, GLM_EPS, cross, dot, normalize
from ..core.types import Scene

SHADE_ROW = 32


@dataclasses.dataclass
class ShadeTables:
    rows: torch.Tensor   # (F, 32) per-face shade rows
    mats: torch.Tensor   # (M, 16) [albedo, emissive, specular, rough,
                         #          spec%, texture, refr%, ior, 0, 0]
    sph: torch.Tensor    # (S, 8)  [center, radius, mat, 0, 0, 0]


def build_shade_tables(scene: Scene) -> ShadeTables:
    m = scene.mesh
    f = m.faces.long()
    p0, p1, p2 = (m.positions[f[:, k]] for k in range(3))
    n0, n1, n2 = (m.normals[f[:, k]] for k in range(3))
    t0, t1, t2 = (m.uvs[f[:, k]] for k in range(3))
    rows = torch.cat([p0, p1 - p0, p2 - p0, n0, n1, n2, t0, t1, t2,
                      m.face_material.to(torch.float32)[:, None],
                      torch.zeros((f.shape[0], 7), device=p0.device)], dim=-1)
    mt = scene.materials
    mats = torch.cat([
        mt.albedo, mt.emissive, mt.specular, mt.roughness[:, None],
        mt.specular_percent[:, None], mt.texture.to(torch.float32)[:, None],
        mt.refraction_percent[:, None], mt.ior[:, None],
        torch.zeros((mt.capacity, 2), device=mt.albedo.device)], dim=-1)
    sp = scene.spheres
    sph = torch.cat([
        sp.center, sp.radius[:, None], sp.material.to(torch.float32)[:, None],
        torch.zeros((sp.capacity, 3), device=sp.center.device)], dim=-1)
    return ShadeTables(rows=rows, mats=mats, sph=sph)


def recompute_hit_packed(tables: ShadeTables, ro, rd, ids: HitIds):
    """Differentiable hit attributes and material properties; returns
    (Hit, matprops (..., 16))."""
    is_tri = ids.tri >= 0
    is_sph = ids.sphere >= 0

    r = tables.rows[torch.clamp(ids.tri, min=0).long()]      # (..., 32)
    p0, e1, e2 = r[..., 0:3], r[..., 3:6], r[..., 6:9]
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    ok_det = torch.abs(det) > 1e-8
    one = torch.ones_like(det)
    inv_det = torch.where(ok_det, one, torch.zeros_like(det)) / torch.where(
        ok_det, det, one)
    tvec = ro - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    tt = dot(e2, qvec) * inv_det
    w = 1.0 - u - v
    tri_n = normalize(w[..., None] * r[..., 9:12] + u[..., None] * r[..., 12:15]
                      + v[..., None] * r[..., 15:18])
    backface = dot(rd, tri_n) >= 0.0
    tri_n = torch.where(backface[..., None], -tri_n, tri_n)
    tri_uv = (w[..., None] * r[..., 18:20] + u[..., None] * r[..., 20:22]
              + v[..., None] * r[..., 22:24])
    tri_mat = r[..., 24]

    s = tables.sph[torch.clamp(ids.sphere, min=0).long()]
    center, radius, sph_mat = s[..., 0:3], s[..., 3], s[..., 4]
    # glm semantics including the far root for rays starting inside
    oc = ro - center
    bq = dot(oc, rd)
    cq = dot(oc, oc) - radius * radius
    disc = bq * bq - cq
    half = torch.sqrt(torch.where(disc > 0.0, torch.clamp(disc, min=1e-12),
                                  torch.ones_like(disc)))
    st = torch.where(-bq > half + GLM_EPS, -bq - half, -bq + half)

    big = torch.full_like(tt, BIG)
    t = torch.where(is_tri, tt, torch.where(is_sph, st, big))
    pos = ro + rd * t[..., None]
    sph_n = (pos - center) / torch.clamp(radius, min=1e-12)[..., None]
    normal = torch.where(is_tri[..., None], tri_n,
                         torch.where(is_sph[..., None], sph_n,
                                     torch.zeros_like(sph_n)))
    uv = torch.where(is_tri[..., None], tri_uv, torch.zeros_like(tri_uv))
    mat_f = torch.where(is_tri, tri_mat,
                        torch.where(is_sph, sph_mat, torch.zeros_like(sph_mat)))
    mat_id = torch.round(mat_f).to(torch.int32)
    front = torch.where(is_tri, ~backface, is_sph & (dot(rd, sph_n) < 0.0))
    matprops = tables.mats[mat_id.long()]
    hit = Hit(valid=is_tri | is_sph, t=t, position=pos, normal=normal, uv=uv,
              mat_id=mat_id, front_face=front)
    return hit, matprops


def sample_albedo_texture(textures: torch.Tensor, tex_id: torch.Tensor,
                          uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the albedo texture stack (K, TH, TW, 3) at hit
    uvs (..., 2), wrapped by floor-mod (uvs may lie outside [0, 1]);
    tex_id < 0 (untextured) gives 1.0."""
    k, th, tw = textures.shape[0], textures.shape[1], textures.shape[2]
    x = uv[..., 0] * tw - 0.5
    y = (1.0 - uv[..., 1]) * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), tw)
    x1i = torch.remainder(x0i + 1, tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    y1i = torch.remainder(y0i + 1, th)
    ti = torch.clamp(tex_id, 0, k - 1).long()
    a = textures[ti, y0i, x0i]
    b = textures[ti, y0i, x1i]
    c = textures[ti, y1i, x0i]
    d = textures[ti, y1i, x1i]
    rgb = (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
    return torch.where((tex_id >= 0)[..., None], rgb, torch.ones_like(rgb))
