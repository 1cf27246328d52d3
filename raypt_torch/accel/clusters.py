"""Triangle clusters: the LBVH cut at subtree size <= leaf into
morton-contiguous blocks (`raypt/accel/clusters.py`'s `Clusters` and
`build_clusters`). Built once on the host in numpy, then moved to the
device with `.to(device)`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import BIG
from ..core.types import TensorTree
from .lbvh import LBVH


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


def build_clusters(bvh: LBVH, positions: np.ndarray, faces: np.ndarray,
                   face_valid: np.ndarray, leaf: int) -> Clusters:
    """Cut the tree into C = cluster_capacity clusters of <= leaf
    triangles; triangle j of cluster c is the j-th leaf of the cut
    node's subtree. Padded triangle slots carry zeros and face id 0."""
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
