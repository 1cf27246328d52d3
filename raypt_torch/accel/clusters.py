"""Triangle clusters: the LBVH cut at subtree size <= leaf into
morton-contiguous blocks (`raypt/accel/clusters.py`'s `Clusters` and
`build_clusters`), built once on the host in numpy and moved to the
device with `.to(device)`; and the per-tile glue of the cluster finders,
in torch on the clusters' device: the dense box cull into nearest-first
worklists (`tile_worklists`), the union of per-ray masks over ray tiles
(`tile_union_counts`), the ascending-id worklists of those unions
(`worklist_slice`, `worklists_from_masks`), each ray's first wanted
cluster (`first_wanted`, the onehot finder's "mask" sort key) and the
worklist intersection reference (`intersect_worklist`, the plain version
of the kernel that the cluster finder's overflow fallback and the
onehot finder's non-fused branch run); and the Woop table of the
clusters' triangles (`build_woop_cm`), built on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import BIG, STEP_PAIRS
from ..core.types import TensorTree
from ..kernels.cluster_pallas import intersect_worklist_plain
from .lbvh import LBVH

CLUSTER_LEAF = 64     # triangles per cluster of backend "cluster"
# Worklist slots per ray tile of backend "cluster"; a tile whose cull
# finds more clusters overflows into the finder's fallback.
WORKLIST_CAP = 512


@dataclasses.dataclass
class Clusters(TensorTree):
    bmin: torch.Tensor       # (C, 3) f32 cluster bounds
    bmax: torch.Tensor       # (C, 3) f32
    tri_rows: torch.Tensor   # (C, L, 12) f32 [p0, e1, e2, fid bits, 0, 0]
    valid: torch.Tensor      # (C,) bool

    @property
    def num_clusters(self) -> int:
        return self.bmin.shape[0]


def cluster_capacity(n_leaves: int, leaf: int) -> int:
    """Static cluster count C for a tree of n_leaves leaves."""
    return max(n_leaves // max(leaf // 2, 1) + 2, 8)


def cluster_cut(bvh: LBVH, leaf: int):
    """(cut, parent, counts, attached, l_int, r_int): the cluster roots
    are the attached nodes with <= leaf leaves whose parent has more."""
    from .ctree import tree_structure
    parent, counts, l_int, r_int, attached = tree_structure(bvh)
    parent_count = np.where(parent >= 0, counts[np.clip(parent, 0, None)],
                            leaf + 1)
    cut = attached & (counts <= leaf) & (parent_count > leaf)
    return cut, parent, counts, attached, l_int, r_int


def _host_array(a) -> np.ndarray:
    """numpy view of a tensor (on any device) or array-like."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def build_clusters(bvh: LBVH, positions, faces, face_valid,
                   leaf: int) -> Clusters:
    """Cut the tree into C = cluster_capacity clusters of <= leaf
    triangles; triangle j of cluster c is the j-th leaf of the cut
    node's subtree. Padded triangle slots carry zeros and face id 0.
    The mesh arrays may be tensors or numpy; the result is on the CPU."""
    positions, faces, face_valid = (_host_array(a) for a in
                                    (positions, faces, face_valid))
    n = bvh.num_leaves
    ni = n - 1
    total = 2 * n - 1
    cut, parent, counts, attached, l_int, r_int = cluster_cut(bvh, leaf)
    used = bvh.left[:ni] >= 0
    is_leaf_bin = np.arange(total) >= ni

    # first leaf slot of every subtree (64 rounds, as the JAX package)
    starts = np.where(is_leaf_bin, np.arange(total) - ni, 0).astype(np.int32)
    for _ in range(64):
        si = np.where(used, np.minimum(starts[l_int[:ni]], starts[r_int[:ni]]),
                      0)
        starts = starts.copy()
        starts[:ni] = si

    c_cap = cluster_capacity(n, leaf)
    cluster_id = np.cumsum(cut.astype(np.int32)) - 1
    tgt = np.where(cut & (cluster_id < c_cap), cluster_id, c_cap)

    def scatter(fill, shape, dtype, src):
        out = np.full((c_cap + 1,) + shape, fill, dtype)
        out[tgt] = src
        return out[:c_cap]

    bmin = scatter(BIG, (3,), np.float32, bvh.bmin)
    bmax = scatter(-BIG, (3,), np.float32, bvh.bmax)
    cvalid = scatter(False, (), bool, cut)
    cl_start = scatter(0, (), np.int32, starts)
    cl_count = scatter(0, (), np.int32, np.where(cut, counts, 0))

    lane = np.arange(leaf)[None, :]
    slot = cl_start[:, None] + lane
    slot_ok = lane < cl_count[:, None]
    tri_ids = np.where(slot_ok, bvh.leaf_face[np.clip(slot, 0, n - 1)],
                       0).astype(np.int32)
    fvalid = (slot_ok & face_valid[tri_ids])[..., None]
    p0 = positions[faces[tri_ids, 0]]
    p1 = positions[faces[tri_ids, 1]]
    p2 = positions[faces[tri_ids, 2]]
    zero = np.float32(0.0)
    tri_rows = np.concatenate([
        np.where(fvalid, p0, zero), np.where(fvalid, p1 - p0, zero),
        np.where(fvalid, p2 - p0, zero),
        tri_ids.view(np.float32)[..., None],
        np.zeros(p0.shape[:-1] + (2,), np.float32)], axis=-1)
    return Clusters(bmin=torch.from_numpy(bmin), bmax=torch.from_numpy(bmax),
                    tri_rows=torch.from_numpy(tri_rows),
                    valid=torch.from_numpy(cvalid))


def build_woop_cm(clusters: Clusters):
    """Woop affine table of every cluster triangle (`build_woop_cm`), for
    the Woop mask intersection (`kernels.cluster_pallas.
    cluster_intersect_mask_woop`): per triangle (p0, e1, e2), W = [e1 e2
    n]^-1 with the unit normal n maps world points to unit-triangle
    coordinates (u, v, w); A = W, b = -W p0. Inverted in float64 on the
    host, so the cast to float32 is the only rounding; degenerate and
    padded triangles encode a miss, A = 0, b = (0, 0, 1).

    Returns (woop_cm (C, 4, 3L) f32 with woop_cm[c, k, r*L + j] the k-th
    coefficient (A[r, 0..2], b[r]) of row r of triangle j, fid_flat (C*L,)
    int32 face ids), on the clusters' device."""
    rows = clusters.tri_rows
    c, leaf, _ = rows.shape
    rows_np = rows.detach().cpu().numpy().astype(np.float64)
    p0, e1, e2 = rows_np[..., 0:3], rows_np[..., 3:6], rows_np[..., 6:9]
    n = np.cross(e1, e2)
    nl = np.linalg.norm(n, axis=-1, keepdims=True)
    ok = nl[..., 0] > 1e-20
    n = n / np.where(nl > 1e-20, nl, 1.0)
    m = np.stack([e1, e2, n], axis=-1)           # (C, L, 3, 3) columns
    safe_m = np.where(ok[..., None, None], m,
                      np.broadcast_to(np.eye(3), m.shape))
    w = np.linalg.inv(safe_m)                    # rows u, v, w
    b = -np.einsum("clij,clj->cli", w, p0)
    a4 = np.concatenate([w, b[..., None]], axis=-1)    # (C, L, 3, 4)
    miss = np.zeros((3, 4))
    miss[2, 3] = 1.0
    a4 = np.where(ok[..., None, None], a4, miss)
    woop_cm = np.transpose(a4, (0, 3, 2, 1)).reshape(c, 4, 3 * leaf)
    fid_flat = rows[..., 9].contiguous().view(torch.int32).reshape(c * leaf)
    return (torch.from_numpy(woop_cm.astype(np.float32)).to(rows.device),
            fid_flat.contiguous())


def tile_union_counts(mask: torch.Tensor, tile: int):
    """mask (R, CW) int32 per-ray wanted-cluster bits, R divisible by the
    power-of-two tile -> (union (R // tile, CW) int32 OR over each tile,
    counts (R // tile,) int32 set bits of each union, not clamped)."""
    if tile <= 0 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    r, cw = mask.shape
    m = mask.view(r // tile, tile, cw)
    t = tile
    while t > 1:
        half = t // 2
        m = m[:, :half] | m[:, half:t]
        t = half
    union = m[:, 0]
    bits = torch.arange(32, dtype=torch.int32, device=mask.device)
    counts = ((union[..., None] >> bits) & 1).sum(dim=(1, 2))
    return union.contiguous(), counts.to(torch.int32)


def worklist_slice(union: torch.Tensor, c_total: int, cap: int,
                   round_: int = 0) -> torch.Tensor:
    """The set bits of each tile's union (R // tile, CW) int32 below
    c_total, as cluster ids in ascending order, sliced to entries
    [round_ * cap, (round_ + 1) * cap): (R // tile, cap) int32, -1
    padded. The JAX package sorts by top_k over c_total - id; a stable
    compaction of the wanted bits gives the same list."""
    n_tiles = union.shape[0]
    dev = union.device
    cid = torch.arange(c_total, dtype=torch.int32, device=dev)
    wanted = ((union[:, (cid >> 5).long()] >> (cid & 31)) & 1).bool()
    pos = torch.cumsum(wanted, dim=1, dtype=torch.int32) - 1 - round_ * cap
    take = wanted & (pos >= 0) & (pos < cap)
    # a scatter into one spare column for what is not taken: no host sync
    wl = torch.full((n_tiles, cap + 1), -1, dtype=torch.int32, device=dev)
    wl.scatter_(1, torch.where(take, pos, cap).long(),
                cid.expand(n_tiles, c_total))
    return wl[:, :cap].contiguous()


def worklists_from_masks(mask: torch.Tensor, tile: int, cap: int,
                         c_total: int):
    """Per-tile worklists from per-ray wanted-cluster masks (R, CW) int32,
    R divisible by the power-of-two tile (`worklists_from_masks`): the
    first cap clusters of each tile's union in ascending id. Returns
    (worklist (R // tile, cap) int32 [-1 pad], counts clamped to cap,
    overflow: the union holds more than cap)."""
    union, counts = tile_union_counts(mask, tile)
    wl = worklist_slice(union, c_total, cap, 0)
    return wl, torch.clamp(counts, max=cap), counts > cap


def first_wanted(mask: torch.Tensor) -> torch.Tensor:
    """Each ray's lowest set bit of its (R, CW) int32 wanted-cluster mask
    as a cluster id (the nearest wanted cluster in Morton order), 1 << 29
    where the mask is empty: (R,) int32 (`first_wanted`). The bit's
    index is read from the exponent of the isolated bit as a float, as
    in the JAX package; int32 negation wraps there and here, so bit 31
    (whose isolated bit is -2^31) counts as 31."""
    lsb = mask & -mask
    f = (lsb.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    idx = (f.view(torch.int32) >> 23) - 127
    base = torch.arange(mask.shape[1], dtype=torch.int32,
                        device=mask.device) * 32
    cand = torch.where(lsb != 0, base[None, :] + idx,
                       torch.full_like(idx, 1 << 29))
    return torch.amin(cand, dim=1)



@torch.no_grad()
def tile_worklists(clusters: Clusters, ro, rd, t0, tile: int,
                   cap: int = WORKLIST_CAP):
    """Dense cull: every ray (R, 3), R divisible by tile, slab-tests every
    cluster box with the bound t0; a tile's worklist holds the clusters
    any of its rays hits, ordered by the tile's smallest entry distance
    (nearest first; a stable sort, so ties keep ascending id).

    Returns (worklist (R // tile, cap) int32 [-1 pad], counts (R // tile,)
    int32 clamped to cap, overflow (R // tile,) bool: more than cap
    clusters were hit). Tiles are culled in groups of about STEP_PAIRS
    ray-cluster pairs, as the JAX package's lax.map does, so that no
    (R, C) temporary is built."""
    r = ro.shape[0]
    n_tiles = r // tile
    c = clusters.num_clusters
    safe = torch.where(torch.abs(rd) > 1e-12, rd,
                       torch.where(rd >= 0, torch.full_like(rd, 1e-12),
                                   torch.full_like(rd, -1e-12)))
    inv = 1.0 / safe
    group = max(1, min(n_tiles, STEP_PAIRS // max(tile * c, 1)))
    while n_tiles % group:
        group -= 1
    k2 = min(c, cap)
    wl = torch.full((n_tiles, cap), -1, dtype=torch.int32, device=ro.device)
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=ro.device)
    slot = torch.arange(k2, device=ro.device)
    for g0 in range(0, n_tiles, group):
        rays = slice(g0 * tile, (g0 + group) * tile)
        o, iv, tb = ro[rays], inv[rays], t0[rays]
        tn = torch.full((o.shape[0], c), -torch.inf, device=ro.device)
        tf = torch.full((o.shape[0], c), torch.inf, device=ro.device)
        for k in range(3):
            t1 = (clusters.bmin[None, :, k] - o[:, k:k + 1]) * iv[:, k:k + 1]
            t2 = (clusters.bmax[None, :, k] - o[:, k:k + 1]) * iv[:, k:k + 1]
            tn = torch.maximum(tn, torch.minimum(t1, t2))
            tf = torch.minimum(tf, torch.maximum(t1, t2))
        hit = ((tf >= tn) & (tf > 0.0) & (tn < tb[:, None])
               & clusters.valid[None, :])
        tile_hit = hit.view(group, tile, c).any(dim=1)
        tnc = torch.where(hit, torch.clamp(tn, min=0.0),
                          torch.full_like(tn, torch.inf)).view(group, tile, c)
        order = torch.sort(tnc.amin(dim=1), dim=1, stable=True).indices
        cnt = tile_hit.sum(dim=1).to(torch.int32)
        wl[g0:g0 + group, :k2] = torch.where(
            slot[None, :] < torch.clamp(cnt, max=k2)[:, None],
            order[:, :k2].to(torch.int32), -1)
        counts[g0:g0 + group] = cnt
    return wl, torch.clamp(counts, max=cap), counts > cap



def intersect_worklist(clusters: Clusters, worklist, ro, rd, t0,
                       tile: int):
    """Reference worklist intersection (`intersect_worklist_jnp`) over
    tiles of `tile` rays: `kernels.cluster_pallas.
    intersect_worklist_plain` on the clusters' triangles, the plain
    version of the worklist kernel `kernels.cluster_pallas.
    intersect_worklist` (whose tiles are 256 rays). Every slot is scanned
    (-1 slots test nothing), a miss is inf, within a cluster the first
    lane of the smallest t wins, and the test is written with cross/dot;
    across slots the carry takes a strictly smaller t."""
    return intersect_worklist_plain(worklist, clusters.tri_rows, ro, rd, t0,
                                    tile)
