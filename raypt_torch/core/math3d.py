"""Vector math on torch tensors whose last axis is the vector axis
(`raypt/core/math3d.py`, the parts the render path uses).

Three-component sums are written out term by term, left to right, so
the rounding order is fixed on every device ("no hit" is BIG).
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e30   # "no hit" distance
EPS = 1e-8
GLM_EPS = 1.1920929e-07  # std::numeric_limits<float>::epsilon()


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dot_keep(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return dot(a, b)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v * rsqrt(|v|^2), guarding the zero vector."""
    return v * torch.rsqrt(torch.clamp(dot_keep(v, v), min=EPS * EPS))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - 2.0 * dot_keep(d, n) * n


def lerp(a, b, t):
    return a + (b - a) * t


def intersect_sphere(ro, rd, center, radius):
    """glm::intersectRaySphere semantics for normalized rd: the far root
    when the ray starts inside; returns (hit, t) with t = BIG on a miss.
    Broadcast over leading dims."""
    diff = center - ro
    t0 = dot(diff, rd)
    d2 = dot(diff, diff) - t0 * t0
    r2 = radius * radius
    within = d2 <= r2
    # clamp the unselected lane so sqrt'(0) = inf cannot reach a gradient
    t1 = torch.sqrt(torch.where(within, torch.clamp(r2 - d2, min=EPS * EPS),
                                torch.ones_like(d2)))
    t = torch.where(t0 > t1 + GLM_EPS, t0 - t1, t0 + t1)
    hit = within & (t > GLM_EPS)
    return hit, torch.where(hit, t, torch.full_like(t, BIG))


def intersect_triangle(ro, rd, v0, v1, v2):
    """Moller-Trumbore, front and back faces; returns (hit, t, u, v) with
    t = BIG on a miss."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    ok_det = torch.abs(det) > EPS
    one = torch.ones_like(det)
    inv_det = torch.where(ok_det, one, torch.zeros_like(det)) / torch.where(
        ok_det, det, one)
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, torch.where(hit, t, torch.full_like(t, BIG)), u, v


def euler_to_mat(ax: float, ay: float, az: float = 0.0) -> np.ndarray:
    """Ry(ay) @ Rx(ax) @ Rz(az) as a float32 numpy 3x3."""
    def c_s(a):
        a = np.float32(a)
        return np.cos(a), np.sin(a)

    cx, sx = c_s(ax)
    cy, sy = c_s(ay)
    cz, sz = c_s(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return ry @ rx @ rz


def aces_film(x):
    """ACES filmic curve of the reference pixel shader."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap(hdr, exposure=0.5):
    return aces_film(hdr * exposure)
