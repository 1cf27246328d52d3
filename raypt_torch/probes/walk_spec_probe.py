"""`scripts/tpu_walk_spec_probe.py` on the card: the top-tree walk with
both successor rows fetched before the slab test (`topwalk_spec`, the
`topwalk_spec_kernel` of `csrc/onehot_walk.cu`) against the production
mask-only walk (`kernels.onehot_walk.topwalk_cm`) on the bench wavefront
(the bunny's primary rays at WS_SIZE^2, block order, leaf WS_LEAF):
times of both, and their masks must be equal, and equal to the plain
walk, bitwise.

    WS_LEAF=512 WS_SIZE=1024 python -m raypt_torch.probes.walk_spec_probe
"""
from __future__ import annotations

import os
import sys

import torch

from ..accel.ctree import walk_max_steps
from ..kernels._build import launch, on_cuda
from ..kernels.onehot_walk import (UNION_TILE, _check_table, _walk_specs,
                                   topwalk_cm, topwalk_cm_plain)
from ._common import bits_equal, card_label, parse_device, require, time_ms

LEAF = int(os.environ.get("WS_LEAF", 512))
SIZE = int(os.environ.get("WS_SIZE", 1024))


def topwalk_spec(table, ro, rd, t0, active, num_words: int):
    """topwalk_cm's (num_words, R) int32 mask by the speculative walk;
    R % 256 == 0. Its plain version is `topwalk_cm_plain`."""
    r = ro.shape[0]
    nt = table.shape[0]
    if r % UNION_TILE:
        raise ValueError(f"R={r} must be a multiple of {UNION_TILE}")
    if not on_cuda(_walk_specs(table, ro, rd, t0, active)):
        return topwalk_cm_plain(table, ro, rd, t0, active, num_words)
    _check_table(table, 0)
    mask = torch.empty((num_words, r), dtype=torch.int32, device=ro.device)
    launch("rk_topwalk_mask_spec", table.data_ptr(), nt, ro.data_ptr(),
           rd.data_ptr(), t0.data_ptr(), active.data_ptr(), mask.data_ptr(),
           r, num_words, walk_max_steps(nt))
    topwalk_spec.launches += 1
    return mask


topwalk_spec.launches = 0


def wavefront(device, size: int = SIZE, leaf: int = LEAF):
    """(table, ro, rd, t0, active, num_words) of the script: the bunny's
    primary rays at size^2 in block order, rd normalized, t0 1e30, all
    active, and the leaf's encoded top tree."""
    from ..accel.ctree import build_onehot
    from ..accel.host_bvh import build_sah
    from ..core.math3d import normalize
    from ..core.types import RenderConfig
    from ..render.integrator import (_block_order, camera_rays_for_ids,
                                     pixel_id_grid)
    from ..scenes.builtin import stanford_bunny

    b = stanford_bunny()
    b.camera.viewport_width = b.camera.viewport_height = size
    scene = b.freeze(device)
    m = scene.mesh
    accel = build_onehot(build_sah(m), m.positions, m.faces, m.face_valid,
                         leaf=leaf).to(device)
    nw = -(-accel.num_clusters // 32)
    cfg = RenderConfig(width=size, height=size)
    ids, _ = _block_order(pixel_id_grid(cfg, device))
    ro, rd = camera_rays_for_ids(scene, cfg, ids, torch.full(
        (size, size, 2), 0.5, device=device))
    ro = ro.reshape(-1, 3).contiguous()
    rd = normalize(rd).reshape(-1, 3).contiguous()
    r = ro.shape[0]
    return (accel.table, ro, rd, torch.full((r,), 1e30, device=device),
            torch.ones(r, dtype=torch.bool, device=device), nw)


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    args = wavefront(device, SIZE, LEAF)
    base = topwalk_cm(*args)
    spec = topwalk_spec(*args)
    for name, fn in (("baseline walk (cm)", topwalk_cm),
                     ("speculative walk  ", topwalk_spec)):
        ms = time_ms(device, lambda: fn(*args), 3)
        print(f"{name}: {ms:.3f} ms  [{card}]", flush=True)
    same = bits_equal(base, spec)
    print(f"outputs equal: {same}", flush=True)
    require(same and bits_equal(spec, topwalk_cm_plain(*args)),
            "the speculative walk's mask differs from the walk's")


if __name__ == "__main__":
    main(sys.argv[1:])
