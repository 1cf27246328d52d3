"""The `pallas` finder backend (`raypt/kernels/intersect.py`), which
also serves `dense`: the sphere pass in torch, then every ray against
every triangle of the Woop table through the dense closest-hit kernel
(`kernels/dense_pallas.py`), seeded with its sphere t.

As in the JAX package, `active` is ignored: dead rays are traced too.
Rays are padded to a multiple of RAY_TILE with o = 0, d = (0, 0, 1),
t0 = BIG.
"""
from __future__ import annotations

from functools import partial

import torch

from ..accel.dense import WoopTris, build_woop
from ..accel.traverse import KERNELS, FinderOps, HitIds, _hit_ids, \
    wavefront_inputs
from .dense_pallas import RAY_TILE, pick_tri_chunk, prepare_woop_mats


def make_pallas_finder(scene, cfg, accel=None):
    """The finder over `accel` when it is a WoopTris, else over the
    table built from the scene's mesh on the host; moved to the scene's
    device. The returned finder takes `ops` (KERNELS by default)."""
    m = scene.mesh
    woop = accel if isinstance(accel, WoopTris) else build_woop(
        m.positions, m.faces, m.face_valid)
    woop = woop.to(m.positions.device)
    tri_chunk = pick_tri_chunk(woop.num_tris)
    return partial(_pallas_finder, prepare_woop_mats(woop, tri_chunk),
                   tri_chunk)


@torch.no_grad()
def _pallas_finder(mats, tri_chunk: int, scene, ro, rd, active=None,
                   ops: FinderOps = KERNELS) -> HitIds:
    flat_o, flat_d, flat_t, flat_a, ts, si = wavefront_inputs(
        scene, ro, rd, None, RAY_TILE)
    t_best, face = ops.closest_dense(*mats, flat_o, flat_d, flat_t,
                                     tri_chunk=tri_chunk)
    return _hit_ids(t_best, face, flat_a, ro.reshape(-1, 3).shape[0], ts, si)
