"""Cubemap environment sampling (`raypt/render/envmap.py`, cube path).

Bilinear filtering as the CUDA texture unit does it; face order +x, -x,
+y, -y, +z, -z with t running top-down. Equirect panoramas and the mip
chain are not ported (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import torch

from ..core.types import EnvMap


def _require_cube(env: EnvMap) -> None:
    if not env.is_cube:
        raise NotImplementedError("equirect environments are not ported "
                                  "(ROADMAP queue 1 item 8)")


def _cube_faceuv(d: torch.Tensor):
    """Face index and per-face (s, t) in [0, 1] of directions d (..., 3)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3),
                    torch.where(z > 0, 4, 5))).to(torch.int32)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-12)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    s = (sc / ma + 1.0) * 0.5
    t = (tc / ma + 1.0) * 0.5
    return face, s, t


def _texel(env_hw, face, s, t):
    h, w = env_hw
    x = s * w - 0.5
    y = t * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int32), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    return x0i, y0i, fx, fy


def sample_env(env: EnvMap, d: torch.Tensor) -> torch.Tensor:
    """Radiance for unit directions d (..., 3) -> (..., 3)."""
    _require_cube(env)
    face, s, t = _cube_faceuv(d)
    h, w = env.data.shape[1], env.data.shape[2]
    x0i, y0i, fx, fy = _texel((h, w), face, s, t)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    f, x0l, y0l, x1l, y1l = (v.long() for v in (face, x0i, y0i, x1i, y1i))
    a = env.data[f, y0l, x0l]
    b = env.data[f, y0l, x1l]
    c = env.data[f, y1l, x0l]
    e = env.data[f, y1l, x1l]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + e * fx) * fy


def build_env_quads(env: EnvMap):
    """(F*H*W, 12) table of each texel's bilinear 2x2 neighbourhood
    [(y,x), (y,x+1), (y+1,x), (y+1,x+1)], and (H, W)."""
    _require_cube(env)
    data = env.data
    f, h, w = data.shape[0], data.shape[1], data.shape[2]
    xs1 = torch.clamp(torch.arange(w, device=data.device) + 1, max=w - 1)
    ys1 = torch.clamp(torch.arange(h, device=data.device) + 1, max=h - 1)
    quads = torch.cat([data, data[:, :, xs1], data[:, ys1],
                       data[:, ys1][:, :, xs1]], dim=-1)
    return quads.reshape(f * h * w, 12), (h, w)


def sample_env_quads(env: EnvMap, quads, hw, d: torch.Tensor):
    """Bilinear env sample through the quad table (one gather per ray)."""
    _require_cube(env)
    h, w = hw
    face, s, t = _cube_faceuv(d)
    x0i, y0i, fx, fy = _texel(hw, face, s, t)
    idx = (face * h + y0i) * w + x0i
    q = quads[idx.long()]
    a, b, c, e = q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + e * fx) * fy


def rotate_y_pi(d: torch.Tensor) -> torch.Tensor:
    """The reference rotates the env lookup 180 degrees about Y:
    (x, y, z) -> (-x, y, -z)."""
    return torch.stack([-d[..., 0], d[..., 1], -d[..., 2]], dim=-1)
