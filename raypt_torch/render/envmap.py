"""Environment sampling (`raypt/render/envmap.py`): a cubemap (6, H, W,
3), face order +x, -x, +y, -y, +z, -z with t running top-down, or an
equirect panorama (H, W, 3), u = atan2(x, -z) / 2 pi + 0.5 wrapped and
v = acos(y) / pi clamped. Bilinear filtering as the CUDA texture unit
does it. Also the box-filtered mip chain and explicit-LOD sampling
(the reference's texCubemapLod), and the cube / equirect converters.
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


# Mip chain and LOD sampling (`raypt/render/envmap.py:169-212`).


def build_mip_chain(data: torch.Tensor, max_levels: int = 0) -> list:
    """Box-filter mip pyramid of data (H, W, C) or (F, H, W, C): each
    level halves H and W (an axis of 1 stays), down to 1 x 1 or to
    max_levels > 0 levels. Returns [level0, level1, ...]."""
    lead = data.ndim == 4
    img = data if lead else data[None]
    chain = [data]
    while max(img.shape[1], img.shape[2]) > 1:
        if max_levels and len(chain) >= max_levels:
            break
        f, h, w, c = img.shape
        kh, kw = (2 if h > 1 else 1), (2 if w > 1 else 1)
        h2, w2 = h // kh, w // kw
        img = img[:, : h2 * kh, : w2 * kw]
        img = img.reshape(f, h2, kh, w2, kw, c).mean(dim=(2, 4))
        chain.append(img if lead else img[0])
    return chain


def sample_env_lod(env: EnvMap, chain: list, d: torch.Tensor,
                   lod) -> torch.Tensor:
    """Trilinear environment sample: bilinear in the two mip levels
    around `lod` (a scalar or one per ray), linear between them; lod 0
    is sample_env."""
    lod = torch.as_tensor(lod, dtype=torch.float32, device=d.device)
    n = len(chain)
    l0 = torch.clamp(torch.floor(lod).to(torch.int64), 0, n - 1)
    frac = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)[..., None]

    def at_level(i):
        return sample_env(env.replace(data=chain[i]), d)

    if n == 1:
        return at_level(0)
    levels = torch.stack([at_level(i) for i in range(n)])   # (L, ..., 3)

    def pick(level):
        idx = torch.broadcast_to(level, d.shape[:-1])[None, ..., None]
        return torch.gather(levels, 0, idx.expand((1,) + levels.shape[1:]))[0]

    a = pick(l0)
    b = pick(torch.clamp(l0 + 1, max=n - 1))
    return a * (1.0 - frac) + b * frac


# Cubemap <-> equirect conversion (`raypt/render/envmap.py:215-269`).

# direction basis a face: dir = normalize(axis + s' s_axis + t' t_axis)
# with s', t' in [-1, 1] (t runs top-down, see _cube_faceuv)
_FACE_AXES = (
    ((1, 0, 0), (0, 0, -1), (0, -1, 0)),    # +x
    ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),    # -x
    ((0, 1, 0), (1, 0, 0), (0, 0, 1)),      # +y
    ((0, -1, 0), (1, 0, 0), (0, 0, -1)),    # -y
    ((0, 0, 1), (1, 0, 0), (0, -1, 0)),     # +z
    ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),   # -z
)


def _face_dirs(size: int, device=None) -> torch.Tensor:
    """(6, size, size, 3) unit directions at cube-face texel centres."""
    sp = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
        / size * 2.0 - 1.0
    s = sp[None, :, None]
    t = sp[:, None, None]
    faces = []
    for axis, s_ax, t_ax in _FACE_AXES:
        vec = [torch.tensor(v, dtype=torch.float32, device=device)
               for v in (axis, s_ax, t_ax)]
        d = vec[0][None, None] + s * vec[1] + t * vec[2]
        faces.append(d / torch.linalg.norm(d, dim=-1, keepdim=True))
    return torch.stack(faces)


def equirect_to_cube(data: torch.Tensor, size: int = 0) -> torch.Tensor:
    """Equirect (H, W, C) -> cubemap (6, size, size, C) by bilinear
    resampling (size H / 2 by default, about the same angular
    resolution)."""
    size = size or max(data.shape[0] // 2, 1)
    return sample_env(EnvMap(data=data, is_cube=False),
                      _face_dirs(size, data.device))


def cube_to_equirect(data: torch.Tensor, height: int = 0) -> torch.Tensor:
    """Cubemap (6, S, S, C) -> equirect (height, 2 height, C) (height 2 S
    by default)."""
    height = height or 2 * data.shape[1]
    width = 2 * height
    dev = data.device
    v = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        / height * math.pi
    u = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
         / width - 0.5) * (2.0 * math.pi)
    y = torch.cos(v)[:, None] * torch.ones((1, width), device=dev)
    sy = torch.sin(v)[:, None]
    x = sy * torch.sin(u)[None, :]
    z = -sy * torch.cos(u)[None, :]
    return sample_env(EnvMap(data=data, is_cube=True),
                      torch.stack([x, y, z], dim=-1))
