"""Environment sampling (`raypt/render/envmap.py`): a cubemap (6, H, W,
3), face order +x, -x, +y, -y, +z, -z with t running top-down, or an
equirect panorama (H, W, 3), u = atan2(x, -z) / 2 pi + 0.5 wrapped and
v = acos(y) / pi clamped. Bilinear filtering as the CUDA texture unit
does it. The mip chain and the cube/equirect converters are not ported
(ROADMAP: the "`render_aovs` and env LOD" item).
"""
from __future__ import annotations

import math

import torch

from ..core.types import EnvMap


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


def _equirect_texel(hw, d: torch.Tensor):
    """(x0, y0, fx, fy) of directions d (..., 3) on an equirect panorama
    of hw = (H, W): x0 wrapped, y0 not clamped (-1 above the first row's
    centre; the callers clamp it as the JAX package does)."""
    h, w = hw
    u = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi) + 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return torch.remainder(x0.to(torch.int32), w), y0.to(torch.int32), fx, fy


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
    if not env.is_cube:
        h, w = env.data.shape[0], env.data.shape[1]
        x0i, y0, fx, fy = _equirect_texel((h, w), d)
        x1i = torch.remainder(x0i + 1, w)
        # both rows clamped from the unclamped y0 (`_bilinear`): above
        # the first row's centre both are row 0
        y0i = torch.clamp(y0, 0, h - 1)
        y1i = torch.clamp(y0 + 1, 0, h - 1)
        x0l, x1l, y0l, y1l = (v.long() for v in (x0i, x1i, y0i, y1i))
        a = env.data[y0l, x0l]
        b = env.data[y0l, x1l]
        c = env.data[y1l, x0l]
        e = env.data[y1l, x1l]
        return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + e * fx) * fy
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
    [(y,x), (y,x+1), (y+1,x), (y+1,x+1)], and (H, W); F = 6 for a
    cubemap (x + 1 clamped), 1 for an equirect panorama (x + 1 wrapped)."""
    data = env.data if env.is_cube else env.data[None]
    f, h, w = data.shape[0], data.shape[1], data.shape[2]
    xs1 = torch.arange(w, device=data.device) + 1
    xs1 = torch.clamp(xs1, max=w - 1) if env.is_cube else xs1 % w
    ys1 = torch.clamp(torch.arange(h, device=data.device) + 1, max=h - 1)
    quads = torch.cat([data, data[:, :, xs1], data[:, ys1],
                       data[:, ys1][:, :, xs1]], dim=-1)
    return quads.reshape(f * h * w, 12), (h, w)


def sample_env_quads(env: EnvMap, quads, hw, d: torch.Tensor):
    """Bilinear env sample through the quad table (one gather per ray)."""
    h, w = hw
    if env.is_cube:
        face, s, t = _cube_faceuv(d)
        x0i, y0i, fx, fy = _texel(hw, face, s, t)
        idx = (face * h + y0i) * w + x0i
    else:
        x0i, y0, fx, fy = _equirect_texel(hw, d)
        idx = torch.clamp(y0, 0, h - 1) * w + x0i
    q = quads[idx.long()]
    a, b, c, e = q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + e * fx) * fy


def rotate_y_pi(d: torch.Tensor) -> torch.Tensor:
    """The reference rotates the env lookup 180 degrees about Y:
    (x, y, z) -> (-x, y, -z)."""
    return torch.stack([-d[..., 0], d[..., 1], -d[..., 2]], dim=-1)
