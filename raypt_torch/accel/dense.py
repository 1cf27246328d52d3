"""Woop unit-triangle transforms (`raypt/accel/dense.py`), the table of
the `dense` and `pallas` finder backends.

Each triangle becomes an affine map M (p - p0) into unit-triangle space;
for a ray (o, d), o' = M o + c and d' = M d, and
  t = -o'_w / d'_w,  u = o'_u + t d'_u,  v = o'_v + t d'_v,
  hit iff u >= 0, v >= 0, u + v <= 1, t > 0.

`build_woop` computes the table once on the host in float32 numpy and
returns CPU tensors (`.to(device)` moves them), as the cluster tables
are built, so the card and the CPU test the same table bits. Every
(ray, triangle) pair is tested by the dense closest-hit kernel
(`kernels/dense_pallas.py`, through `kernels/intersect.py`'s finder).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import TensorTree


@dataclasses.dataclass
class WoopTris(TensorTree):
    m: torch.Tensor       # (T, 3, 3) f32 world -> unit-triangle linear map
    c: torch.Tensor       # (T, 3) f32 offset, -M p0
    valid: torch.Tensor   # (T,) bool

    @property
    def num_tris(self) -> int:
        return self.m.shape[0]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cross product of (..., 3) float32 arrays, one rounding per
    operation."""
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)


def build_woop(positions, faces, face_valid) -> WoopTris:
    """Per-triangle Woop transforms: the adjugate inverse of A = [e1 | e2
    | n], n = e1 x e2, with det(A) in the closed form `jnp.linalg.det`
    uses for 3x3 matrices. Invalid and degenerate faces (|det| <= 1e-18)
    get zero maps, which never hit. The mesh arrays may be tensors on
    any device or numpy; the result is on the CPU."""
    pos = _host(positions).astype(np.float32)
    f = _host(faces).astype(np.int64)
    fv = _host(face_valid).astype(bool)
    p0, p1, p2 = pos[f[:, 0]], pos[f[:, 1]], pos[f[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    n = _cross(e1, e2)
    a = np.stack([e1, e2, n], axis=-1)           # columns e1, e2, n

    def el(i, j):
        return a[:, i, j]

    det = (el(0, 0) * el(1, 1) * el(2, 2) + el(0, 1) * el(1, 2) * el(2, 0)
           + el(0, 2) * el(1, 0) * el(2, 1) - el(0, 2) * el(1, 1) * el(2, 0)
           - el(0, 0) * el(1, 2) * el(2, 1) - el(0, 1) * el(1, 0) * el(2, 2))
    ok = fv & (np.abs(det) > 1e-18)
    adj = np.stack([_cross(a[:, :, 1], a[:, :, 2]),
                    _cross(a[:, :, 2], a[:, :, 0]),
                    _cross(a[:, :, 0], a[:, :, 1])], axis=1)   # rows
    safe = np.where(ok, det, np.float32(1.0))
    m = np.where(ok[:, None, None], adj / safe[:, None, None],
                 np.float32(0.0)).astype(np.float32)
    c = -((m[:, :, 0] * p0[:, None, 0] + m[:, :, 1] * p0[:, None, 1])
          + m[:, :, 2] * p0[:, None, 2])
    return WoopTris(m=torch.from_numpy(np.ascontiguousarray(m)),
                    c=torch.from_numpy(np.ascontiguousarray(c, np.float32)),
                    valid=torch.from_numpy(ok))


def woop_from_numpy(m, c, valid, device="cuda") -> WoopTris:
    """A WoopTris on `device` from the arrays of a JAX-package
    `build_woop` output: m (T, 3, 3) and c (T, 3) float32, valid (T,)
    bool."""
    return WoopTris(m=torch.from_numpy(np.array(m, np.float32)),
                    c=torch.from_numpy(np.array(c, np.float32)),
                    valid=torch.from_numpy(np.array(valid, bool))).to(device)
