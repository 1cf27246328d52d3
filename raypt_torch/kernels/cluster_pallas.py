"""Dense cluster intersection per 256-ray tile
(`raypt/kernels/cluster_pallas.py`): every ray of a tile is tested
against every triangle of each cluster the tile names, either the set
bits of the tile's wanted-cluster union (`cluster_intersect_mask`,
`pallas_cluster_intersect_mask`; `cluster_intersect_mask_woop`,
`pallas_cluster_intersect_mask_woop`, with the Woop test) or the first
`counts` entries of the tile's worklist (`cluster_intersect`,
`pallas_cluster_intersect`; `cluster_intersect_grouped`,
`pallas_cluster_intersect_grouped`, which rounds the count up to a
multiple of its group); and, with the rules of the JAX package's XLA
reference `raypt/accel/clusters.py::intersect_worklist_jnp`, every slot
of the tile's worklist (`intersect_worklist`).

Merge rules, which decide the exact result: within a cluster the
smallest t wins, and among triangles with that t the lowest face id (the
Woop kernel: the lowest lane); across clusters, in the tile's order
(ascending id for the union, list order for the worklist), a cluster
replaces the ray's carry only when its t is strictly smaller; the carry
starts at the seed with face -1. `intersect_worklist` keeps
intersect_worklist_jnp's own rules instead: every slot is scanned
whatever the counts (a -1 slot tests nothing), a miss is inf, and within
a cluster the first lane of the smallest t wins (argmin), where the
kernels above take the lowest face id; across slots the same strict
merge. Its test is written with cross/dot, whose operation order is
`_test_cluster`'s.

`_test_cluster` is the Moller-Trumbore test of one cluster in the Pallas
kernel's operation order, written as separate elementwise ops so that
torch on the card rounds after every operation exactly as the kernels,
built with -fmad=false, do. The expansion kernel's plain version
(`kernels/cluster_expand.py`) uses it too.

`_test_cluster_woop` is the Woop test of one cluster in the operation
order of `csrc/cluster_intersect.cu`: six 4-term sums over [o; 1] and
[d; 0], the homogeneous terms included (a3 * 0 turns a -0.0 sum into
+0.0, which sets the sign of the division's infinity), then t = -o'w /
d'w, u = o'u + t d'u, v = o'v + t d'v.

On CUDA tensors each wrapper launches `csrc/cluster_intersect.cu`; on
CPU tensors it runs its plain torch version. The kernels compute 1 / det
as the correctly rounded reciprocal where `_test_cluster` divides a
select by a select; `inv_det_sweep` holds the two bitwise equal on the
card.
"""
from __future__ import annotations

import torch

from ..core.math3d import BIG, EPS, STEP_PAIRS, cross, dot
from ._build import SMEM_LIMIT, launch, on_cuda

TILE = 256            # rays per tile: one CUDA block
BIG_I = 2 ** 30
PLAIN_CHUNK = 65536   # rays per (rays, L) block of the plain versions


def _test_cluster(blk: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """blk (..., L, 12) triangles, o/d (..., n, 3) rays -> (tmin (..., n),
    face (..., n)) of the cluster; tmin = BIG when nothing is hit. Leading
    dimensions broadcast (one cluster per tile in the worklist version)."""
    def col(k):
        return blk[..., None, :, k]

    p0x, p0y, p0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]

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
    tmin = torch.amin(t, dim=-1)
    fid = blk[..., 9].contiguous().view(torch.int32)[..., None, :]
    fmin = torch.amin(torch.where(t <= tmin[..., None], fid,
                                  torch.full_like(fid, BIG_I)), dim=-1)
    return tmin, fmin


def _test_cluster_woop(tab: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """tab (4, 3L) one cluster's Woop table, o/d (n, 3) rays -> (tmin
    (n,), lane (n,) int32 of the lowest lane with that t); tmin = BIG
    when nothing is hit."""
    leaf = tab.shape[1] // 3
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    def transform(r):
        a0, a1, a2, a3 = (tab[k, r * leaf:(r + 1) * leaf] for k in range(4))
        return (a0 * ox + a1 * oy + a2 * oz + a3 * 1.0,
                a0 * dx + a1 * dy + a2 * dz + a3 * 0.0)

    (ou, du), (ov, dv), (ow, dw) = transform(0), transform(1), transform(2)
    tq = -ow / dw
    u = ou + tq * du
    v = ov + tq * dv
    hit = (tq > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    t = torch.where(hit, tq, torch.full_like(tq, BIG))
    tmin = torch.amin(t, dim=-1)
    lane = torch.arange(leaf, dtype=torch.int32, device=t.device).expand(
        t.shape)
    lmin = torch.amin(torch.where(t <= tmin[:, None], lane,
                                  torch.full_like(lane, BIG_I)), dim=-1)
    return tmin, lmin


def inv_det_sweep(device="cuda"):
    """The kernels' 1 / det (`csrc/cluster_test.cuh`: `inv_det_of`, the
    reciprocal's fast path, and `__frcp_rn` where |det| >= 2^126) against
    the division of `_test_cluster`, (ok ? 1 : 0) / (ok ? det : 1) with
    ok = |det| > 1e-8, over all 2^32 f32 bit patterns of det in one launch
    on the card. Returns (patterns whose results differ in any bit, the
    lowest such pattern or None)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the sweep runs on a CUDA device, not {device}")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    first = torch.full((1,), -1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        launch("rk_inv_det_sweep", 1.0, bad.data_ptr(), first.data_ptr())
    n = int(bad.item())
    return n, (int(first.item()) & 0xFFFFFFFF) if n else None


def _valid_union(union: torch.Tensor, c_total: int) -> torch.Tensor:
    """The union with every bit >= c_total cleared (the wrapper guard of
    `pallas_cluster_intersect_mask`, applied to every word)."""
    cw = union.shape[1]
    keep = torch.clamp(c_total - 32 * torch.arange(cw, device=union.device),
                       0, 32)
    mask = torch.where(keep >= 32, -1, (1 << keep) - 1).to(torch.int32)
    return union & mask[None, :]


def cluster_intersect_mask_plain(union, tri_rows, ro, rd, t0):
    """Loop over cluster ids 0..C-1; test every ray of each tile whose
    union has the cluster's bit, with the strict merge."""
    c_total = tri_rows.shape[0]
    union = _valid_union(union, c_total)
    tb = t0.clone()
    fb = torch.full_like(t0, -1, dtype=torch.int32)
    lane = torch.arange(TILE, device=ro.device)
    for c in range(c_total):
        tiles = torch.nonzero((union[:, c >> 5] >> (c & 31)) & 1).flatten()
        idx_all = (tiles[:, None] * TILE + lane[None, :]).flatten()
        for s in range(0, idx_all.numel(), PLAIN_CHUNK):
            idx = idx_all[s:s + PLAIN_CHUNK]
            tmin, fmin = _test_cluster(tri_rows[c], ro[idx], rd[idx])
            better = tmin < tb[idx]
            tb[idx] = torch.where(better, tmin, tb[idx])
            fb[idx] = torch.where(better, fmin, fb[idx])
    return tb, fb


def cluster_intersect_mask_woop_plain(union, woop_cm, ro, rd, t0):
    """Loop over cluster ids 0..C-1; test every ray of each tile whose
    union has the cluster's bit with the Woop test, with the strict
    merge; the result's second half is packed = cid * L + lane."""
    c_total, leaf = woop_cm.shape[0], woop_cm.shape[2] // 3
    union = _valid_union(union, c_total)
    tb = t0.clone()
    pb = torch.full_like(t0, -1, dtype=torch.int32)
    lane = torch.arange(TILE, device=ro.device)
    for c in range(c_total):
        tiles = torch.nonzero((union[:, c >> 5] >> (c & 31)) & 1).flatten()
        idx_all = (tiles[:, None] * TILE + lane[None, :]).flatten()
        for s in range(0, idx_all.numel(), PLAIN_CHUNK):
            idx = idx_all[s:s + PLAIN_CHUNK]
            tmin, lmin = _test_cluster_woop(woop_cm[c], ro[idx], rd[idx])
            better = tmin < tb[idx]
            tb[idx] = torch.where(better, tmin, tb[idx])
            pb[idx] = torch.where(better, c * leaf + lmin, pb[idx])
    return tb, pb


def _grouped_counts(counts, cap: int, group: int):
    """Slots the grouped kernel visits: min(counts, cap) rounded up to a
    multiple of group, at most cap."""
    n = torch.clamp(counts, max=cap)
    return torch.clamp((n + group - 1) // group * group, max=cap)


def cluster_intersect_grouped_plain(worklist, counts, tri_rows, ro, rd, t0,
                                    group: int = 4):
    """The worklist intersection over the slots `_grouped_counts` gives:
    a valid id in a slot past counts but within the group is tested."""
    return cluster_intersect_plain(
        worklist, _grouped_counts(counts, worklist.shape[1], group),
        tri_rows, ro, rd, t0)


def cluster_intersect_plain(worklist, counts, tri_rows, ro, rd, t0):
    """Loop over worklist slots; at slot w, every tile with counts > w
    tests its rays against its own cluster worklist[tile, w] (ids outside
    [0, C) are skipped), with the strict merge."""
    n_tiles, cap = worklist.shape
    c_total = tri_rows.shape[0]
    counts = torch.clamp(counts, max=cap)
    o = ro.view(n_tiles, TILE, 3)
    d = rd.view(n_tiles, TILE, 3)
    tb = t0.clone().view(n_tiles, TILE)
    fb = torch.full_like(tb, -1, dtype=torch.int32)
    per_chunk = max(PLAIN_CHUNK // TILE, 1)
    for w in range(int(counts.max()) if n_tiles else 0):
        cid = worklist[:, w]
        live = torch.nonzero((counts > w) & (cid >= 0)
                             & (cid < c_total)).flatten()
        for s in range(0, live.numel(), per_chunk):
            tiles = live[s:s + per_chunk]
            tmin, fmin = _test_cluster(tri_rows[cid[tiles].long()], o[tiles],
                                       d[tiles])
            better = tmin < tb[tiles]
            tb[tiles] = torch.where(better, tmin, tb[tiles])
            fb[tiles] = torch.where(better, fmin, fb[tiles])
    return tb.view(-1), fb.view(-1)


# the kernels' static shared memory: a tile's packed live rays (seven
# floats and an id each) and the scan's words
UNION_SMEM = 4 * (8 * TILE + 33)


def _ray_specs(table, shape, ro, rd, t0, n_tiles: int) -> dict:
    """Checks of the rays and of the cluster table, (C, L, 12) or Woop
    (C, 4, 3L): the kernels stage two clusters' 48 L bytes each in shared
    memory, beside their packed rays."""
    staged = 4 * shape[1] * shape[2]
    if 2 * staged + UNION_SMEM > SMEM_LIMIT:
        raise ValueError(f"a cluster of {tuple(shape[1:])} floats does not "
                         f"fit in shared memory (the kernels stage two "
                         f"clusters there)")
    r = n_tiles * TILE
    return {"table": (table, shape, torch.float32),
            "ro": (ro, (r, 3), torch.float32),
            "rd": (rd, (r, 3), torch.float32),
            "t0": (t0, (r,), torch.float32)}


def _rows_shape(tri_rows):
    return tri_rows.shape[0], tri_rows.shape[1], 12


def _n_tiles(ro) -> int:
    r = ro.shape[0]
    if r % TILE:
        raise ValueError(f"R={r} must be a multiple of {TILE}")
    return r // TILE


def cluster_intersect_mask(union, tri_rows, ro, rd, t0):
    """union (R // TILE, CW) int32 wanted-cluster bits per tile (bits >= C
    are ignored), tri_rows (C, L, 12) f32, ro/rd (R, 3) f32, t0 (R,) f32
    seed. Returns (t (R,) f32, face (R,) int32, -1 where no cluster
    won)."""
    n_tiles = _n_tiles(ro)
    cw = union.shape[1]
    specs = _ray_specs(tri_rows, _rows_shape(tri_rows), ro, rd, t0, n_tiles)
    specs["union"] = (union, (n_tiles, cw), torch.int32)
    if not on_cuda(specs):
        return cluster_intersect_mask_plain(union, tri_rows, ro, rd, t0)
    t_out = torch.empty_like(t0)
    f_out = torch.empty((ro.shape[0],), dtype=torch.int32, device=ro.device)
    launch("rk_cluster_intersect_mask", union.data_ptr(), cw,
           tri_rows.data_ptr(), tri_rows.shape[0], tri_rows.shape[1],
           ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), t_out.data_ptr(),
           f_out.data_ptr(), n_tiles)
    cluster_intersect_mask.launches += 1
    return t_out, f_out


cluster_intersect_mask.launches = 0


def cluster_intersect_mask_woop(union, woop_cm, ro, rd, t0):
    """union (R // TILE, CW) int32 wanted-cluster bits per tile (bits >= C
    are ignored), woop_cm (C, 4, 3L) f32 (`accel.clusters.build_woop_cm`),
    ro/rd (R, 3) f32, t0 (R,) f32 seed. Returns (t (R,) f32, packed (R,)
    int32 = cid * L + lane, -1 where no cluster won); the face id is
    fid_flat[packed]."""
    n_tiles = _n_tiles(ro)
    cw = union.shape[1]
    specs = _ray_specs(woop_cm, (woop_cm.shape[0], 4,
                                 woop_cm.shape[2] // 3 * 3), ro, rd, t0,
                       n_tiles)
    specs["union"] = (union, (n_tiles, cw), torch.int32)
    if not on_cuda(specs):
        return cluster_intersect_mask_woop_plain(union, woop_cm, ro, rd, t0)
    t_out = torch.empty_like(t0)
    p_out = torch.empty((ro.shape[0],), dtype=torch.int32, device=ro.device)
    launch("rk_cluster_intersect_mask_woop", union.data_ptr(), cw,
           woop_cm.data_ptr(), woop_cm.shape[0], woop_cm.shape[2] // 3,
           ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), t_out.data_ptr(),
           p_out.data_ptr(), n_tiles)
    cluster_intersect_mask_woop.launches += 1
    return t_out, p_out


cluster_intersect_mask_woop.launches = 0


def cluster_intersect(worklist, counts, tri_rows, ro, rd, t0):
    """worklist (R // TILE, cap) int32 cluster ids in test order, counts
    (R // TILE,) int32 entries to test (clamped to cap; ids outside
    [0, C) are skipped), tri_rows (C, L, 12) f32, ro/rd (R, 3) f32, t0
    (R,) f32 seed. Returns (t (R,) f32, face (R,) int32, -1 where no
    cluster won)."""
    out = _worklist_kernel(worklist, counts, tri_rows, ro, rd, t0, 1)
    if out is None:
        return cluster_intersect_plain(worklist, counts, tri_rows, ro, rd, t0)
    cluster_intersect.launches += 1
    return out


cluster_intersect.launches = 0


def cluster_intersect_grouped(worklist, counts, tri_rows, ro, rd, t0,
                              group: int = 4):
    """`cluster_intersect` in groups of `group` worklist entries
    (`pallas_cluster_intersect_grouped`): the slots visited are min(counts,
    cap) rounded up to a multiple of group, at most cap, so a valid id in
    a slot past counts but within the last group is tested; -1 slots and
    ids outside [0, C) are skipped."""
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    out = _worklist_kernel(worklist, counts, tri_rows, ro, rd, t0, group)
    if out is None:
        return cluster_intersect_grouped_plain(worklist, counts, tri_rows, ro,
                                               rd, t0, group)
    cluster_intersect_grouped.launches += 1
    return out


cluster_intersect_grouped.launches = 0


def _worklist_kernel(worklist, counts, tri_rows, ro, rd, t0, group: int):
    """Check the worklist kernel's inputs; on CUDA tensors launch it with
    `group` and return (t, face), on CPU tensors return None (the caller
    runs its plain version)."""
    n_tiles = _n_tiles(ro)
    cap = worklist.shape[1]
    specs = _ray_specs(tri_rows, _rows_shape(tri_rows), ro, rd, t0, n_tiles)
    specs["worklist"] = (worklist, (n_tiles, cap), torch.int32)
    specs["counts"] = (counts, (n_tiles,), torch.int32)
    if not on_cuda(specs):
        return None
    t_out = torch.empty_like(t0)
    f_out = torch.empty((ro.shape[0],), dtype=torch.int32, device=ro.device)
    launch("rk_cluster_intersect", worklist.data_ptr(), counts.data_ptr(), cap,
           group, tri_rows.data_ptr(), tri_rows.shape[0], tri_rows.shape[1],
           ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), t_out.data_ptr(),
           f_out.data_ptr(), n_tiles)
    return t_out, f_out


@torch.no_grad()
def intersect_worklist_plain(worklist, tri_rows, ro, rd, t0,
                             tile: int = TILE):
    """The worklist intersection reference (`intersect_worklist_jnp`):
    every ray of a tile of `tile` rays against every slot of the tile's
    worklist (n_tiles, cap), in slot order. A -1 slot tests nothing, a
    miss is inf, within a cluster the first lane of the smallest t wins
    (argmin), and the test is written with cross/dot. Across slots the
    carry takes a strictly smaller t. Tiles are processed in chunks of
    about STEP_PAIRS ray-triangle pairs a slot; none depends on another.

    A chunk of tiles scans its slots only up to the last one that any of
    its tiles fills: both worklist builders pad with trailing -1, a -1
    slot tests nothing, and inf < t never holds, so the result is the
    same. Reading the chunks' slot counts costs one host sync, which the
    kernel does not make."""
    r = ro.shape[0]
    n_tiles, cap = worklist.shape
    leaf = tri_rows.shape[1]
    o_all = ro.view(n_tiles, tile, 1, 3)
    d_all = rd.view(n_tiles, tile, 1, 3)
    tb = t0.reshape(n_tiles, tile).clone()
    fb = torch.full_like(tb, -1, dtype=torch.int32)
    chunk = max(1, STEP_PAIRS // (tile * leaf))
    slot = torch.arange(1, cap + 1, device=worklist.device)
    filled = torch.where(worklist >= 0, slot, 0).amax(dim=1) if cap else \
        torch.zeros((n_tiles,), dtype=torch.int64, device=worklist.device)
    starts = range(0, n_tiles, chunk)
    ends = torch.stack([filled[s0:s0 + chunk].amax() for s0 in starts]
                       ).tolist() if n_tiles else []
    for s0, n_slots in zip(starts, ends):
        tiles = slice(s0, s0 + chunk)
        o, d = o_all[tiles], d_all[tiles]
        for w in range(n_slots):
            cid = worklist[tiles, w]
            rows = tri_rows[torch.clamp(cid, min=0).long()]
            p0 = rows[..., 0:3][:, None]             # (T, 1, leaf, 3)
            e1 = rows[..., 3:6][:, None]
            e2 = rows[..., 6:9][:, None]
            fid = rows[..., 9].contiguous().view(torch.int32)[:, None]
            pvec = cross(d, e2)
            det = dot(e1, pvec)
            ok_det = torch.abs(det) > EPS
            inv_det = (torch.where(ok_det, 1.0, 0.0)
                       / torch.where(ok_det, det, torch.ones_like(det)))
            tvec = o - p0
            u = dot(tvec, pvec) * inv_det
            qvec = cross(tvec, e1)
            v = dot(d, qvec) * inv_det
            t = dot(e2, qvec) * inv_det
            hit = (ok_det & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 0.0)
                   & (cid >= 0)[:, None, None])
            t = torch.where(hit, t, torch.full_like(t, torch.inf))
            tmin, col = torch.min(t, dim=-1)         # first index of the min
            fmin = torch.gather(fid.expand(t.shape), -1, col[..., None])[..., 0]
            better = tmin < tb[tiles]
            tb[tiles] = torch.where(better, tmin, tb[tiles])
            fb[tiles] = torch.where(better, fmin, fb[tiles])
    return tb.view(r), fb.view(r)


def intersect_worklist(worklist, tri_rows, ro, rd, t0):
    """worklist (R // TILE, cap) int32 cluster ids, every slot tested in
    slot order (ids in [-1, C): a -1 slot tests nothing; the contract is
    not checked, which would cost a host sync, and the kernel skips any
    id outside [0, C)), tri_rows (C, L, 12) f32, ro/rd (R, 3) f32, t0
    (R,) f32 seed. Returns (t (R,) f32, face (R,) int32, -1 where no
    cluster won) under intersect_worklist_jnp's rules (the module
    docstring). One launch of `csrc/cluster_intersect.cu`'s
    union_kernel<WorklistTest, SlotSource> on CUDA tensors (no host
    sync); `intersect_worklist_plain` on CPU tensors."""
    n_tiles = _n_tiles(ro)
    cap = worklist.shape[1] if worklist.dim() == 2 else -1
    specs = _ray_specs(tri_rows, _rows_shape(tri_rows), ro, rd, t0, n_tiles)
    specs["worklist"] = (worklist, (n_tiles, cap), torch.int32)
    if not on_cuda(specs):
        return intersect_worklist_plain(worklist, tri_rows, ro, rd, t0)
    t_out = torch.empty_like(t0)
    f_out = torch.empty((ro.shape[0],), dtype=torch.int32, device=ro.device)
    launch("rk_intersect_worklist", worklist.data_ptr(), cap,
           tri_rows.data_ptr(), tri_rows.shape[0], tri_rows.shape[1],
           ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), t_out.data_ptr(),
           f_out.data_ptr(), n_tiles)
    intersect_worklist.launches += 1
    return t_out, f_out


intersect_worklist.launches = 0
