"""Cluster top tree and its encoded walk table (`raypt/accel/ctree.py`).

The top tree is the top of the triangle tree: nodes with more than
`leaf` leaves stay internal and the cluster cuts become its leaves. Its
rows are encoded exactly as the JAX package encodes them, so both walk
the same (Nt, 16) bf16 table:
  [0:3] bmin rounded down to bf16   [3:6] bmax rounded up to bf16
  [6:8] left, [8:10] skip, [10:12] cluster id, each as two base-128
        digits (id = hi*128 + lo - 1, exact in bf16)
  [12] is_leaf  [13] valid  [14:16] 0
The host build is numpy; bf16 values are handled as uint16 bit patterns
and become a torch.bfloat16 tensor at the end.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import BIG
from ..core.types import TensorTree
from .clusters import Clusters, build_clusters, cluster_capacity, cluster_cut
from .lbvh import LBVH

ROW = 16


def tree_structure(bvh: LBVH):
    """(parent, counts, l_int, r_int, attached) for any LBVH-layout tree,
    including host SAH trees with unused internal slots (left == -1)
    and detached padded leaves. Fixed 64-round fixpoints, as the JAX
    package computes them."""
    n = bvh.num_leaves
    ni = n - 1
    total = 2 * n - 1
    left = bvh.left
    used = left[:ni] >= 0
    l_int = np.clip(left, 0, total - 1)
    right = np.where(left >= 0, bvh.skip[l_int], -1)
    r_int = np.clip(right, 0, total - 1)

    idx_i = np.arange(ni, dtype=np.int32)
    parent = np.full((total + 1,), -1, np.int32)
    parent[np.where(used, l_int[:ni], total)] = idx_i
    parent[np.where(used, r_int[:ni], total)] = idx_i
    parent = parent[:total]

    is_leaf_bin = np.arange(total) >= ni
    counts = np.where(is_leaf_bin, 1, 0).astype(np.int32)
    for _ in range(64):
        ci = np.where(used, counts[l_int[:ni]] + counts[r_int[:ni]], 0)
        counts = counts.copy()
        counts[:ni] = ci

    root_ok = np.arange(total) == 0
    attached = root_ok
    for _ in range(64):
        attached = root_ok | (attached[np.clip(parent, 0, total - 1)]
                              & (parent >= 0))
    return parent, counts, l_int, r_int, attached


@dataclasses.dataclass
class ClusterTree:
    """Compacted top tree over clusters (f32 form, numpy)."""
    bmin: np.ndarray       # (Nt, 3) f32
    bmax: np.ndarray       # (Nt, 3) f32
    left: np.ndarray       # (Nt,) int32, -1 for leaves
    skip: np.ndarray       # (Nt,) int32, -1 = done
    cluster: np.ndarray    # (Nt,) int32 cluster id of leaves, -1 internal
    valid: np.ndarray      # (Nt,) bool

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]


def build_cluster_tree(bvh: LBVH, leaf: int) -> ClusterTree:
    """Top tree of 2C+1 slots; its cluster ids match build_clusters'."""
    n = bvh.num_leaves
    ni = n - 1
    total = 2 * n - 1
    is_leaf_bin = np.arange(total) >= ni
    cut, _, counts, attached, _, _ = cluster_cut(bvh, leaf)
    is_top = cut | (attached & ~is_leaf_bin & (counts > leaf))

    n_top = 2 * cluster_capacity(n, leaf) + 1
    top_id = np.cumsum(is_top.astype(np.int32)) - 1
    cluster_id = np.cumsum(cut.astype(np.int32)) - 1

    def remap(e):
        return np.where(e >= 0, top_id[np.clip(e, 0, total - 1)],
                        -1).astype(np.int32)

    tgt = np.where(is_top & (top_id < n_top), top_id, n_top)

    def scatter(fill, shape, dtype, src):
        out = np.full((n_top + 1,) + shape, fill, dtype)
        out[tgt] = src
        return out[:n_top]

    return ClusterTree(
        bmin=scatter(BIG, (3,), np.float32, bvh.bmin),
        bmax=scatter(-BIG, (3,), np.float32, bvh.bmax),
        left=scatter(-1, (), np.int32, np.where(cut, -1, remap(bvh.left))),
        skip=scatter(-1, (), np.int32, remap(bvh.skip)),
        cluster=scatter(-1, (), np.int32,
                        np.where(cut, cluster_id, -1).astype(np.int32)),
        valid=scatter(False, (), bool, is_top))


# ---------------------------------------------------------------------------
# bf16 as uint16 bit patterns
# ---------------------------------------------------------------------------

def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even float32 -> bf16 bits (finite inputs)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = b + 0x7FFF + ((b >> 16) & 1)
    return (b >> 16).astype(np.uint16)


def _bf16_bits_to_f32(h: np.ndarray) -> np.ndarray:
    return (h.astype(np.uint32) << 16).view(np.float32)


def _bf16_down(x: np.ndarray) -> np.ndarray:
    """Bits of the largest bf16 <= x."""
    b = _f32_to_bf16_bits(x)
    bits = b.astype(np.int32)
    stepped = np.where(bits & 0x8000 > 0, bits + 1, np.maximum(bits - 1, 0))
    # a zero steps down to the smallest negative bf16
    stepped = np.where((bits & 0x7FFF) == 0, 0x8001, stepped)
    return np.where(_bf16_bits_to_f32(b) <= x, b, stepped.astype(np.uint16))


def _bf16_up(x: np.ndarray) -> np.ndarray:
    """Bits of the smallest bf16 >= x."""
    return _bf16_down(-x) ^ np.uint16(0x8000)


def _digits(ids: np.ndarray):
    """id (>= -1) -> two bf16-exact digits as bits; -1 -> (0, 0)."""
    v = ids.astype(np.int32) + 1
    return (_f32_to_bf16_bits((v // 128).astype(np.float32)),
            _f32_to_bf16_bits((v % 128).astype(np.float32)))


def decode_digits(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of the digit encoding on f32 values of the table."""
    return (torch.round(hi) * 128.0 + torch.round(lo)).to(torch.int32) - 1


def encode_topwalk_table(tree: ClusterTree) -> np.ndarray:
    """(Nt, 16) uint16: the bf16 bits of the walk table."""
    nt = tree.num_nodes
    if nt >= 128 * 256 - 1:
        raise ValueError(
            f"onehot top tree has {nt} nodes; the bf16 digit-pair "
            f"encoding is exact only below {128 * 256 - 1} ids - raise "
            f"`leaf` in build_onehot to coarsen the clustering")
    one = _f32_to_bf16_bits(np.float32(1.0))
    rows = np.zeros((nt, ROW), np.uint16)
    rows[:, 0:3] = _bf16_down(tree.bmin)
    rows[:, 3:6] = _bf16_up(tree.bmax)
    for col, ids in ((6, tree.left), (8, tree.skip), (10, tree.cluster)):
        rows[:, col], rows[:, col + 1] = _digits(ids)
    rows[:, 12] = np.where(tree.cluster >= 0, one, 0)
    rows[:, 13] = np.where(tree.valid, one, 0)
    return rows


@dataclasses.dataclass
class OnehotAccel(TensorTree):
    """The onehot finder's accel: clusters plus the encoded top tree."""
    clusters: Clusters
    table: torch.Tensor      # (Nt, 16) bfloat16

    @property
    def num_clusters(self) -> int:
        return self.clusters.num_clusters


def _table_tensor(table_u16: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(
        np.array(table_u16, np.uint16).view(np.int16)).view(torch.bfloat16)


def build_onehot(bvh: LBVH, positions, faces, face_valid,
                 leaf: int) -> OnehotAccel:
    """Clusters and encoded top-tree table for a mesh (tensors or numpy
    arrays; built on the host, returned on the CPU)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    clusters = build_clusters(bvh, host(positions), host(faces),
                              host(face_valid), leaf=leaf)
    table = encode_topwalk_table(build_cluster_tree(bvh, leaf=leaf))
    return OnehotAccel(clusters=clusters, table=_table_tensor(table))


def onehot_accel_from_numpy(tri_rows, bmin, bmax, valid,
                            table_u16) -> OnehotAccel:
    """The accel from arrays of the JAX package's build_onehot output:
    Clusters' leaves and the table's bf16 bits as uint16."""
    clusters = Clusters(
        bmin=torch.from_numpy(np.array(bmin, np.float32)),
        bmax=torch.from_numpy(np.array(bmax, np.float32)),
        tri_rows=torch.from_numpy(np.array(tri_rows, np.float32)),
        valid=torch.from_numpy(np.array(valid, bool)))
    return OnehotAccel(clusters=clusters, table=_table_tensor(table_u16))


def table_bits(table: torch.Tensor) -> np.ndarray:
    """(Nt, 16) uint16 bits of a bf16 table tensor."""
    return table.cpu().view(torch.int16).numpy().view(np.uint16)


def walk_max_steps(nt: int) -> int:
    """Step cap of the walk: the JAX kernel runs ceil((Nt+1)/4)
    iterations of 4 unrolled steps. A skip-link walk ends in <= Nt
    steps, so the cap never binds on a well-formed table."""
    return -(-(nt + 1) // 4) * 4


def walk_topwalk(table: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor,
                 t0: torch.Tensor, active: torch.Tensor,
                 num_words: int) -> torch.Tensor:
    """Reference walk over the encoded table: (R, num_words) int32
    wanted-cluster bitmask (`walk_topwalk_jnp`). Each step works only on
    the rays whose walk has not ended."""
    safe = torch.where(torch.abs(rd) > 1e-12, rd,
                       torch.where(rd >= 0, torch.full_like(rd, 1e-12),
                                   torch.full_like(rd, -1e-12)))
    inv = torch.reciprocal(safe)
    r_count = ro.shape[0]
    mask = torch.zeros((r_count, num_words), dtype=torch.int32,
                       device=ro.device)
    tab = table.float()
    idx = torch.nonzero(active).flatten()
    node = torch.zeros_like(idx)
    for _ in range(walk_max_steps(table.shape[0])):
        if idx.numel() == 0:
            break
        r = tab[node]                                    # (n, 16)
        o, iv = ro[idx], inv[idx]
        ok_row = r[:, 13] > 0.5
        tn1 = (r[:, 0:3] - o) * iv
        tn2 = (r[:, 3:6] - o) * iv
        tnear = torch.amax(torch.minimum(tn1, tn2), dim=-1)
        tfar = torch.amin(torch.maximum(tn1, tn2), dim=-1)
        nonempty = torch.all(r[:, 0:3] <= r[:, 3:6], dim=-1)
        hit = ((tfar >= tnear) & (tnear < t0[idx]) & (tfar > 0.0)
               & nonempty & ok_row)
        is_leaf = r[:, 12] > 0.5
        cid = decode_digits(r[:, 10], r[:, 11])
        want = hit & is_leaf & (cid >= 0) & ((cid >> 5) < num_words)
        if bool(want.any()):
            wi, wc = idx[want], cid[want]
            word = (wc >> 5).long()
            bit = torch.bitwise_left_shift(torch.ones_like(wc), wc & 31)
            mask[wi, word] = mask[wi, word] | bit
        nxt = torch.where(hit & ~is_leaf, decode_digits(r[:, 6], r[:, 7]),
                          decode_digits(r[:, 8], r[:, 9]))
        keep = nxt >= 0
        idx, node = idx[keep], nxt[keep].long()
    return mask
