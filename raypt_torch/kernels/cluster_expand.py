"""Per-ray-exact closest hit: every ray is tested against the triangles
of exactly the clusters set in its wanted-cluster mask
(`raypt/kernels/cluster_expand.py`: `pallas_cluster_expand`).

Merge rules, which decide the exact result:
  * within a cluster the smallest t wins, and among triangles with that
    t the lowest face id;
  * across clusters, visited in ascending id, a cluster replaces the
    ray's carry only when its t is strictly smaller;
  * the carry starts at the seed (the sphere t for live rays, -BIG for
    dead ones) with face -1.
A lexicographic (t, face) minimum over all clusters is not the same rule.

The triangle test is `kernels.cluster_pallas._test_cluster`, shared with
the dense cluster intersection: Moller-Trumbore in the Pallas kernel's
operation order, as separate elementwise ops, so that torch on the card
rounds after every operation exactly as the kernel, built with
-fmad=false, does.

On CUDA tensors this launches `csrc/cluster_expand.cu`; on CPU tensors
it runs the plain torch version below.
"""
from __future__ import annotations

import torch

from ._build import launch, on_cuda
from .cluster_pallas import PLAIN_CHUNK, _test_cluster
from .onehot_walk import RAY_TILE

def cluster_expand_plain(mask_cm, union_pp, tri_rows, ro, rd, seed):
    """Loop over cluster ids 0..C-1, testing only the rays whose bit is
    set, with the strict merge. union_pp is not needed here."""
    del union_pp
    c_total = tri_rows.shape[0]
    tb = seed.clone()
    fb = torch.full_like(seed, -1, dtype=torch.int32)
    for c in range(c_total):
        want = ((mask_cm[c >> 5] >> (c & 31)) & 1).bool()
        idx_all = torch.nonzero(want).flatten()
        for s in range(0, idx_all.numel(), PLAIN_CHUNK):
            idx = idx_all[s:s + PLAIN_CHUNK]
            tmin, fmin = _test_cluster(tri_rows[c], ro[idx], rd[idx])
            better = tmin < tb[idx]
            tb[idx] = torch.where(better, tmin, tb[idx])
            fb[idx] = torch.where(better, fmin, fb[idx])
    return tb, fb


def cluster_expand(mask_cm, union_pp, tri_rows, ro, rd, seed):
    """mask_cm (cwp, R) int32 wanted-cluster bits (bits >= C ignored),
    union_pp (R // RAY_TILE, cwp) int32 OR of the masks of each walk
    tile (the kernel reads only the mask words it marks nonzero),
    tri_rows (C, L, 12) f32, ro/rd (R, 3) f32, seed (R,) f32. Returns
    (t (R,) f32, face (R,) int32, -1 where no cluster won)."""
    cwp, r = mask_cm.shape
    c_total, leaf = tri_rows.shape[0], tri_rows.shape[1]
    if cwp * 32 < c_total:
        raise ValueError(f"{cwp} mask words cannot hold {c_total} clusters")
    if r % RAY_TILE:
        raise ValueError(f"R={r} must be a multiple of {RAY_TILE}")
    if not on_cuda({"mask_cm": (mask_cm, (cwp, r), torch.int32),
                    "union_pp": (union_pp, (r // RAY_TILE, cwp), torch.int32),
                    "tri_rows": (tri_rows, (c_total, leaf, 12),
                                 torch.float32),
                    "ro": (ro, (r, 3), torch.float32),
                    "rd": (rd, (r, 3), torch.float32),
                    "seed": (seed, (r,), torch.float32)}):
        return cluster_expand_plain(mask_cm, union_pp, tri_rows, ro, rd, seed)
    t_out = torch.empty_like(seed)
    f_out = torch.empty((r,), dtype=torch.int32, device=seed.device)
    launch("rk_cluster_expand", mask_cm.data_ptr(), union_pp.data_ptr(),
           tri_rows.data_ptr(), c_total, leaf, ro.data_ptr(), rd.data_ptr(),
           seed.data_ptr(), t_out.data_ptr(), f_out.data_ptr(), r, cwp)
    cluster_expand.launches += 1
    return t_out, f_out


cluster_expand.launches = 0
