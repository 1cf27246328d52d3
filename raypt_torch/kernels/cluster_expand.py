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

The triangle test is Moller-Trumbore in `_test_cluster`'s operation
order (`raypt/kernels/cluster_pallas.py`), written as separate
elementwise ops so that torch on the card rounds after every operation
exactly as the kernel, built with -fmad=false, does.

On CUDA tensors this launches `csrc/cluster_expand.cu`; on CPU tensors
it runs the plain torch version below.
"""
from __future__ import annotations

import torch

from ..core.math3d import BIG
from ._build import launch, on_cuda
from .onehot_walk import RAY_TILE

BIG_I = 2 ** 30
PLAIN_CHUNK = 65536   # rays per (rays, L) block of the plain version


def _test_cluster(blk: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """blk (L, 12) triangles, o/d (n, 3) rays -> (tmin (n,), face (n,))
    of the cluster; tmin = BIG when nothing is hit."""
    def col(k):
        return blk[:, k][None, :]

    p0x, p0y, p0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok_det = torch.abs(det) > 1e-8
    one = torch.ones_like(det)
    inv_det = torch.where(ok_det, one, torch.zeros_like(det)) / torch.where(
        ok_det, det, one)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    t = torch.where(hit, t, torch.full_like(t, BIG))
    tmin = torch.amin(t, dim=1)
    fid = blk[:, 9].contiguous().view(torch.int32)[None, :]
    fmin = torch.amin(torch.where(t <= tmin[:, None], fid,
                                  torch.full_like(fid, BIG_I)), dim=1)
    return tmin, fmin


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
