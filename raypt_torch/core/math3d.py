"""Vector math on torch tensors whose last axis is the vector axis
(`raypt/core/math3d.py`): vectors, ray-primitive tests, transforms and
tone mapping.

Three-component sums are written out term by term, left to right, so
the rounding order is fixed on every device ("no hit" is BIG).
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e30   # "no hit" distance
EPS = 1e-8
GLM_EPS = 1.1920929e-07  # std::numeric_limits<float>::epsilon()
# ray-primitive pairs per step of the plain torch loops (brute force,
# box cull, worklist intersection, the dense closest hit's plain
# version): bounds their temporaries to ~64 MB a float32 array
STEP_PAIRS = 1 << 24


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dot_keep(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return dot(a, b)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v * rsqrt(|v|^2), guarding the zero vector."""
    return v * torch.rsqrt(torch.clamp(dot_keep(v, v), min=EPS * EPS))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - 2.0 * dot_keep(d, n) * n


def lerp(a, b, t):
    return a + (b - a) * t


def refract(d: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """glm::refract for unit d and a unit n facing against d, eta =
    n_incident / n_transmitted; the zero vector on total internal
    reflection."""
    cos_i = -dot_keep(d, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    # sqrt at a safe argument on TIR lanes, so sqrt'(0) = inf cannot
    # reach a gradient through the unselected branch
    k_safe = torch.where(tir, torch.ones_like(k), torch.clamp(k, min=0.0))
    out = eta * d + (eta * cos_i - torch.sqrt(k_safe)) * n
    return torch.where(tir, torch.zeros_like(out), out)


def schlick_fresnel(cos_i, ior_a, ior_b):
    """Schlick's reflectance from index ior_a into ior_b at incidence
    cosine cos_i (>= 0)."""
    r0 = ((ior_a - ior_b) / (ior_a + ior_b)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


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


def intersect_aabb(ro, inv_rd, bmin, bmax, tmax):
    """Slab test: True where the ray meets the box nearer than tmax.
    inv_rd is the hoisted reciprocal direction. Inverted (empty) boxes,
    min > max, are rejected: the LBVH gives subtrees of padded faces
    such boxes, which a plain slab test would treat as unbounded. The
    min / max propagate NaN, as jnp's do."""
    t1 = (bmin - ro) * inv_rd
    t2 = (bmax - ro) * inv_rd
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    tnear = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tfar = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    nonempty = ((bmin[..., 0] <= bmax[..., 0]) & (bmin[..., 1] <= bmax[..., 1])
                & (bmin[..., 2] <= bmax[..., 2]))
    return (tfar >= tnear) & (tnear < tmax) & (tfar > 0.0) & nonempty


def aabb_empty(device=None):
    """(min, max) of the empty box: BIG and -BIG."""
    return (torch.full((3,), BIG, dtype=torch.float32, device=device),
            torch.full((3,), -BIG, dtype=torch.float32, device=device))


def aabb_union(amin, amax, bmin, bmax):
    return torch.minimum(amin, bmin), torch.maximum(amax, bmax)


def _cos_sin(a):
    a = torch.as_tensor(a, dtype=torch.float32)
    return torch.cos(a), torch.sin(a)


def rot_x(a) -> torch.Tensor:
    """Rotation by a (radians, f32) about x as a 3x3 f32 tensor."""
    c, s = _cos_sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([one, zero, zero]),
                        torch.stack([zero, c, -s]),
                        torch.stack([zero, s, c])])


def rot_y(a) -> torch.Tensor:
    c, s = _cos_sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, zero, s]),
                        torch.stack([zero, one, zero]),
                        torch.stack([-s, zero, c])])


def rot_z(a) -> torch.Tensor:
    c, s = _cos_sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, -s, zero]),
                        torch.stack([s, c, zero]),
                        torch.stack([zero, zero, one])])


def compose_matrix(translation, rot3, scale) -> torch.Tensor:
    """TRS compose: a 4x4 f32 whose 3x3 block is rot3 with column j
    scaled by scale[j] and whose last column is the translation."""
    rot3 = torch.as_tensor(rot3, dtype=torch.float32)
    m = torch.eye(4, dtype=torch.float32, device=rot3.device)
    m[:3, :3] = rot3 * torch.as_tensor(scale, dtype=torch.float32,
                                       device=rot3.device)[None, :]
    m[:3, 3] = torch.as_tensor(translation, dtype=torch.float32,
                               device=rot3.device)
    return m


def transform_points(mat4, pts):
    """A 4x4 applied to (..., 3) points (w = 1)."""
    return pts @ mat4[:3, :3].T + mat4[:3, 3]


def transform_dirs(mat4, dirs):
    """A 4x4 applied to (..., 3) directions (w = 0)."""
    return dirs @ mat4[:3, :3].T


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
