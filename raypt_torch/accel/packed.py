"""The packed skip-link table and its walk (`raypt/accel/packed.py`):
one 64-byte row per node, so a walk step reads one row.

Row layout (16 x f32):
  internal: [0:3]=bmin [3:6]=bmax [12]=left child [13]=skip [14]=0
  leaf:     [0:3]=p0   [3:6]=e1   [6:9]=e2 [12]=face id [13]=skip [14]=1
Integer links are int32 bit patterns in float slots. A leaf row holds
its triangle in edge form and is tested without a box test; an invalid
face gets e1 = e2 = 0, so det = 0 and it is never hit.

`traverse_wavefront` is the plain torch walk, the one the CPU runs and
the one `csrc/packed_walk.cu` (`kernels.packed_walk`) is held against,
bitwise, on the card. The cherry, quad and lookahead layouts are not
ported (ROADMAP queue 1, the "LBVH build and the packed `bvh` backend"
item).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import EPS, cross, dot
from ..core.types import TensorTree
from .lbvh import LBVH

ROW = 16


@dataclasses.dataclass
class PackedLBVH(TensorTree):
    rows: torch.Tensor   # (2N-1, 16) f32

    @property
    def num_nodes(self) -> int:
        return self.rows.shape[0]


def _itof(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def ftoi(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


@torch.no_grad()
def pack(bvh: LBVH, positions: torch.Tensor, faces: torch.Tensor,
         face_valid: torch.Tensor) -> PackedLBVH:
    """The packed table of an LBVH at the current vertex positions, on
    the positions' device. Re-run after `lbvh.refit`."""
    dev = positions.device
    n = bvh.num_leaves
    total = bvh.num_nodes
    ni = n - 1

    def host(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    left = host(bvh.left, np.int32)
    skip = host(bvh.skip, np.int32)
    lf = host(bvh.leaf_face, np.int32)
    rows = torch.zeros((total, ROW), dtype=torch.float32, device=dev)
    rows[:ni, 0:3] = host(bvh.bmin[:ni], np.float32)
    rows[:ni, 3:6] = host(bvh.bmax[:ni], np.float32)
    rows[:ni, 12] = _itof(left[:ni])
    rows[:ni, 13] = _itof(skip[:ni])

    f = faces.to(dev, torch.int64)[lf.long()]
    positions = positions.detach()
    p0, p1, p2 = (positions[f[:, k]] for k in range(3))
    ok = face_valid.to(dev)[lf.long()][:, None]
    zero = torch.zeros_like(p0)
    rows[ni:, 0:3] = p0
    rows[ni:, 3:6] = torch.where(ok, p1 - p0, zero)
    rows[ni:, 6:9] = torch.where(ok, p2 - p0, zero)
    rows[ni:, 12] = _itof(lf)
    rows[ni:, 13] = _itof(skip[ni:])
    rows[ni:, 14] = 1.0
    return PackedLBVH(rows=rows)


def safe_reciprocal(rd: torch.Tensor) -> torch.Tensor:
    """1 / rd with components below 1e-12 in magnitude clamped to
    +-1e-12 (sign of the component, +0 counting as positive), so the
    slab test never multiplies 0 by inf."""
    tiny = torch.full_like(rd, 1e-12)
    safe = torch.where(rd.abs() > 1e-12, rd,
                       torch.where(rd >= 0, tiny, -tiny))
    return 1.0 / safe


@torch.no_grad()
def traverse_wavefront(pbvh: PackedLBVH, ro: torch.Tensor, rd: torch.Tensor,
                       t0: torch.Tensor, active: torch.Tensor,
                       max_iters: int | None = None, unroll: int = 8,
                       visits: list | None = None):
    """Skip-link walk of a wavefront: ro, rd (R, 3) f32 with rd
    normalized, t0 (R,) f32 the starting best distance (the sphere pass's
    t), active (R,) bool. Returns (t_best (R,) f32, face (R,) int32, -1
    = none); a dead ray keeps t0 and face -1.

    Each step of a live ray reads its node's row and, in the JAX
    package's operation order, as separate elementwise ops: the slab
    test of an internal row (hit -> left child, else skip) and the
    Moller-Trumbore test of a leaf row (taken when strictly nearer than
    t_best; then skip). The walk ends at node -1. Only the rays still
    walking are computed each step; rays are independent, so that
    changes no result.

    `unroll` is the JAX loop's steps per iteration and changes no
    result. `max_iters`, when given, cuts each ray's walk after
    max_iters * unroll steps, as the JAX loop does; no finder passes it.
    With a `visits` list, each step appends (rows read, leaf rows read),
    for the kernel's bound."""
    rows = pbvh.rows
    inv = safe_reciprocal(rd)
    node = torch.where(active, 0, -1).to(torch.int32)
    t_best = t0.clone()
    face = torch.full_like(node, -1)
    max_steps = None if max_iters is None else max_iters * unroll
    live = torch.nonzero(node >= 0).flatten()
    step = 0
    while live.numel() and (max_steps is None or step < max_steps):
        r = rows[node[live].long()]
        o, d, iv, tb = ro[live], rd[live], inv[live], t_best[live]
        is_leaf = r[:, 14] > 0.5
        if visits is not None:
            visits.append((live.numel(), int(is_leaf.sum())))

        # slab test (internal rows)
        tn1 = (r[:, 0:3] - o) * iv
        tn2 = (r[:, 3:6] - o) * iv
        lo = torch.minimum(tn1, tn2)
        hi = torch.maximum(tn1, tn2)
        tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        nonempty = ((r[:, 0] <= r[:, 3]) & (r[:, 1] <= r[:, 4])
                    & (r[:, 2] <= r[:, 5]))
        hit_box = (tfar >= tnear) & (tnear < tb) & (tfar > 0.0) & nonempty

        # Moller-Trumbore (leaf rows: p0 = [0:3], e1 = [3:6], e2 = [6:9])
        e1, e2 = r[:, 3:6], r[:, 6:9]
        pvec = cross(d, e2)
        det = dot(e1, pvec)
        ok = det.abs() > EPS
        one = torch.ones_like(det)
        inv_det = torch.where(ok, one, torch.zeros_like(det)) / torch.where(
            ok, det, one)
        tvec = o - r[:, 0:3]
        u = dot(tvec, pvec) * inv_det
        qvec = cross(tvec, e1)
        v = dot(d, qvec) * inv_det
        t = dot(e2, qvec) * inv_det
        tri_hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
                   & (t < tb))

        take = is_leaf & tri_hit
        link, nxt_skip = ftoi(r[:, 12]), ftoi(r[:, 13])
        t_best[live] = torch.where(take, t, tb)
        face[live] = torch.where(take, link, face[live])
        nxt = torch.where(is_leaf | ~hit_box, nxt_skip, link)
        node[live] = nxt
        live = live[nxt >= 0]
        step += 1
    return t_best, face
