"""Host SAH tree -> skip-link `LBVH` (`raypt/accel/host_bvh.py`).

Host node format (singleton leaves, exactly 2n-1 nodes):
  meta[i] = (order_slot, 1)  leaf holding triangle order[order_slot]
  meta[i] = (left_child, 0)  internal; the right child is the node
                             whose id follows left's whole subtree (DFS
                             order), recovered with a subtree-size pass.
"""
from __future__ import annotations

import numpy as np

from ..io.native import build_sah_host
from .lbvh import LBVH


def _subtree_sizes(meta: np.ndarray) -> np.ndarray:
    """sizes[i] = number of nodes in i's subtree. Host ids are DFS
    preorder of a full binary tree, so the subtree of i is the
    contiguous range [i, j] where j is the first position at which the
    leaf-minus-internal excess over [i, j] reaches +1 (balanced-
    parentheses property: every strict prefix of a subtree has
    excess <= 0). Vectorized: with c = cumsum(+1 leaf / -1 internal),
    j = first index >= i with c[j] == c[i-1] + 1; found for all i at
    once with one searchsorted over positions sorted by (c value, pos)."""
    n = len(meta)
    is_leaf = meta[:, 1] > 0
    c = np.cumsum(np.where(is_leaf, 1, -1)).astype(np.int64)
    target = np.concatenate(([0], c[:-1])) + 1          # c[i-1] + 1
    pos = np.arange(n, dtype=np.int64)
    keys = c * (n + 1) + pos                            # sorted by (c, pos)
    order = np.argsort(keys, kind="stable")
    queries = target * (n + 1) + pos
    idx = np.searchsorted(keys[order], queries)
    if idx.max(initial=0) >= n:
        raise ValueError("malformed host BVH: unbalanced preorder")
    j = order[idx]
    return j - pos + 1


def host_tree_to_lbvh(bounds: np.ndarray, meta: np.ndarray,
                      order: np.ndarray, num_faces_padded: int) -> LBVH:
    """Convert host output to the LBVH id space (internals [0, N-2],
    leaves [N-1, 2N-2], skip links). N = padded face capacity; host
    leaves beyond the real triangle count don't exist, so padded leaf
    slots get empty boxes and identity face mapping."""
    n_real = len(order)
    total_host = 2 * n_real - 1
    meta = meta[:total_host]
    bounds = bounds[:total_host]
    sizes = _subtree_sizes(meta)
    is_leaf = meta[:, 1] > 0

    n_pad = num_faces_padded
    total = 2 * n_pad - 1
    ni = n_pad - 1

    # new ids: internals numbered by host order among internals; leaves
    # numbered by host order among leaves
    internal_rank = np.cumsum(~is_leaf) - 1
    leaf_rank = np.cumsum(is_leaf) - 1
    new_id = np.where(is_leaf, ni + leaf_rank, internal_rank).astype(np.int64)

    left_arr = np.full(total, -1, np.int32)
    right_arr = np.full(total, -1, np.int32)
    parent = np.full(total, -1, np.int32)
    is_left_child = np.zeros(total, bool)

    host_ids = np.arange(total_host)
    int_ids = host_ids[~is_leaf]
    l_host = meta[int_ids, 0].astype(np.int64)
    r_host = l_host + sizes[l_host]
    me = new_id[int_ids].astype(np.int32)
    lc = new_id[l_host].astype(np.int32)
    rc = new_id[r_host].astype(np.int32)
    left_arr[me] = lc
    right_arr[me] = rc
    parent[lc] = me
    parent[rc] = me
    is_left_child[lc] = True

    # skip links (vectorized fixpoint like accel.lbvh.build)
    sib = np.full(total, -1, np.int32)
    has_par = parent >= 0
    sib[has_par & is_left_child] = right_arr[parent[has_par & is_left_child]]
    skip = np.full(total, -1, np.int32)
    for _ in range(64):
        par = np.clip(parent, 0, total - 1)
        new = np.where(parent < 0, -1,
                       np.where(is_left_child, sib, skip[par]))
        if np.array_equal(new, skip):
            break
        skip = new

    bmin = np.full((total, 3), 1e30, np.float32)
    bmax = np.full((total, 3), -1e30, np.float32)
    bmin[new_id] = bounds[:, 0:3]
    bmax[new_id] = bounds[:, 3:6]

    leaf_face = np.arange(n_pad, dtype=np.int32)
    host_leaves = host_ids[is_leaf]
    leaf_face[leaf_rank[host_leaves]] = order[meta[host_leaves, 0]]

    return LBVH(left=left_arr, skip=skip, bmin=bmin, bmax=bmax,
                leaf_face=leaf_face)


def build_sah(mesh) -> LBVH:
    """Native binned-SAH build over a `MeshArrays` (valid faces only) ->
    `LBVH` in the padded face-id space. Raises with fewer than 2 valid
    faces, or when the native builder cannot be built."""
    faces = mesh.faces.cpu().numpy()
    valid = mesh.face_valid.cpu().numpy()
    vidx = np.nonzero(valid)[0]
    if len(vidx) < 2:
        raise ValueError("build_sah needs at least 2 valid faces")
    positions = mesh.positions.detach().cpu().numpy()
    bounds, meta, order_local = build_sah_host(positions, faces[vidx])
    order_global = vidx[order_local].astype(np.uint32)
    return host_tree_to_lbvh(bounds, meta, order_global, mesh.num_faces)
