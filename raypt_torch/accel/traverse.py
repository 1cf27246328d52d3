"""Closest-hit finders (`raypt/accel/traverse.py`): the brute-force toy
oracle and the onehot finder's per-ray-exact branch (alive compaction,
top-tree walk, cluster expansion, uncompaction).

Finders return only discrete results and run without autograd; shading
recomputes the chosen hit differentiably (`render.shading`). A triangle
wins over a sphere only when strictly closer: the cluster pass is seeded
with the sphere distance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..core.math3d import BIG, intersect_sphere, intersect_triangle
from ..core.types import Scene
from ..kernels import cluster_expand as _expand
from ..kernels import compact as _compact
from ..kernels import onehot_walk as _walk
from .ctree import OnehotAccel


@dataclasses.dataclass
class HitIds:
    """Discrete closest-hit result."""
    t: torch.Tensor        # (...,) f32 closest distance (BIG = miss)
    tri: torch.Tensor      # (...,) int32 face id, -1 if not a triangle hit
    sphere: torch.Tensor   # (...,) int32 sphere id, -1 if not a sphere hit

    @property
    def valid(self) -> torch.Tensor:
        return self.t < BIG


@dataclasses.dataclass
class Hit:
    """Differentiable hit attributes."""
    valid: torch.Tensor
    t: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor       # shading normal, faces the ray for triangles
    uv: torch.Tensor
    mat_id: torch.Tensor
    front_face: torch.Tensor


def _closest_sphere(scene: Scene, ro, rd):
    """(t, sphere id) of the closest valid sphere, (BIG, -1) on a miss;
    the lowest id wins a tie."""
    sp = scene.spheres
    hit, t = intersect_sphere(ro.reshape(-1, 1, 3), rd.reshape(-1, 1, 3),
                              sp.center[None], sp.radius[None])
    t = torch.where(hit & sp.valid[None], t, torch.full_like(t, BIG))
    tmin = torch.amin(t, dim=1)
    col = torch.arange(t.shape[1], dtype=torch.int32,
                       device=t.device).expand(t.shape)
    imin = torch.amin(torch.where(t <= tmin[:, None], col,
                                  torch.full_like(col, 2 ** 30)), dim=1)
    i = torch.where(tmin < BIG, imin, torch.full_like(imin, -1))
    return tmin.reshape(ro.shape[:-1]), i.reshape(ro.shape[:-1])


@torch.no_grad()
def find_closest_bruteforce(scene: Scene, ro, rd, active=None) -> HitIds:
    """Every ray against every face: a toy-size oracle. rd normalized."""
    ts, si = _closest_sphere(scene, ro, rd)
    m = scene.mesh
    f = m.faces.long()
    p0, p1, p2 = (m.positions[f[:, k]][None] for k in range(3))
    flat_o = ro.reshape(-1, 1, 3)
    flat_d = rd.reshape(-1, 1, 3)
    hit, t, _, _ = intersect_triangle(flat_o, flat_d, p0, p1, p2)
    t = torch.where(hit & m.face_valid[None], t, torch.full_like(t, BIG))
    tt, ti = torch.min(t, dim=1)          # first index of the minimum
    ti = torch.where(tt < BIG, ti.to(torch.int32), torch.full_like(ti, -1,
                                                                   dtype=torch.int32))
    tt, ti = tt.reshape(ts.shape), ti.reshape(ts.shape)
    tri_wins = tt < ts
    minus1 = torch.full_like(si, -1)
    return HitIds(t=torch.minimum(ts, tt),
                  tri=torch.where(tri_wins, ti, minus1),
                  sphere=torch.where(~tri_wins & (ts < BIG), si, minus1))


class OnehotOps(NamedTuple):
    """The four stages of the onehot finder. KERNELS dispatches on the
    tensors' device (CUDA kernel or plain version); PLAIN always runs
    the plain torch versions, to hold the kernels against on the card."""
    compact: Callable
    walk: Callable
    expand: Callable
    uncompact: Callable


KERNELS = OnehotOps(_compact.alive_compact, _walk.topwalk_cm_u,
                    _expand.cluster_expand, _compact.alive_uncompact)
PLAIN = OnehotOps(_compact.alive_compact_plain, _walk.topwalk_cm_u_plain,
                  _expand.cluster_expand_plain, _compact.alive_uncompact_plain)


def onehot_inputs(scene: Scene, ro, rd, active, compact_n: int):
    """Sphere pass and the flat, padded wavefront the stages consume:
    (flat_o, flat_d, flat_t, flat_a, ts, si). Padding rays are dead; R
    is padded to a multiple of the walk tile and of compact_n (so
    compaction never switches itself off)."""
    ts, si = _closest_sphere(scene, ro, rd)
    flat_o = ro.reshape(-1, 3)
    flat_d = rd.reshape(-1, 3)
    flat_t = ts.reshape(-1)
    flat_a = (torch.ones_like(flat_t, dtype=torch.bool) if active is None
              else active.reshape(-1))
    n = flat_o.shape[0]
    chunk = math.lcm(_walk.RAY_TILE, compact_n or 1)
    pad = (-n) % chunk
    if pad:
        dev = flat_o.device
        flat_o = torch.cat([flat_o, torch.zeros((pad, 3), device=dev)])
        flat_d = torch.cat([flat_d, torch.tensor([0.0, 0.0, 1.0], device=dev)
                            .expand(pad, 3)])
        flat_t = torch.cat([flat_t, torch.full((pad,), BIG, device=dev)])
        flat_a = torch.cat([flat_a, torch.zeros((pad,), dtype=torch.bool,
                                                device=dev)])
    return (flat_o.contiguous(), flat_d.contiguous(), flat_t.contiguous(),
            flat_a.contiguous(), ts, si)


@torch.no_grad()
def find_closest_onehot(scene: Scene, ro, rd, active=None, *,
                        accel: OnehotAccel, expand_n: int, compact_n: int,
                        ops: OnehotOps = KERNELS) -> HitIds:
    """The onehot finder's per-ray-exact branch: compact live rays to
    the front of each compact_n group (when compact_n > 0), walk the
    top tree, test each ray's wanted clusters, restore the ray order.
    expand_n > 0 selects this branch; the CUDA expansion runs one thread
    per ray, so its value shapes nothing else. The dense-union branch
    (expand_n == 0) is not ported."""
    if not expand_n:
        raise NotImplementedError(
            "onehot_expand=0 (the dense-union branch) is not ported "
            "(ROADMAP queue 1 item 10)")
    if scene.mesh.num_faces >= 1 << 24:
        raise ValueError("face ids must stay below 2^24")
    flat_o, flat_d, flat_t, flat_a, ts, si = onehot_inputs(
        scene, ro, rd, active, compact_n)
    n = ro.reshape(-1, 3).shape[0]
    orig_a = flat_a
    if compact_n:
        flat_o, flat_d, flat_t, flat_a = ops.compact(
            flat_o, flat_d, flat_t, flat_a, compact_n)
    cwp = -(-accel.num_clusters // 256) * 8     # words, padded to 8
    mask_cm, union_pp = ops.walk(accel.table, flat_o, flat_d, flat_t, flat_a,
                                 cwp)
    seed = torch.where(flat_a, flat_t, torch.full_like(flat_t, -BIG))
    t_best, face = ops.expand(mask_cm, union_pp, accel.clusters.tri_rows,
                              flat_o, flat_d, seed)
    if compact_n:
        t_best, face = ops.uncompact(t_best, face, orig_a, compact_n)
    shape = ts.shape
    t_best = torch.where(orig_a, t_best, torch.full_like(t_best, BIG))[:n]
    face = torch.where(orig_a, face, torch.full_like(face, -1))[:n]
    t_best, face = t_best.reshape(shape), face.reshape(shape)
    tri_wins = face >= 0
    minus1 = torch.full_like(si, -1)
    return HitIds(t=t_best, tri=torch.where(tri_wins, face, minus1),
                  sphere=torch.where(~tri_wins & (ts < BIG), si, minus1))
