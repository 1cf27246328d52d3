"""The binary skip-link tree (`raypt/accel/lbvh.py`): its container, the
Karras (2012) build over Morton codes and the refit of its boxes.

Node ids: internal nodes [0, N-2] (root 0), leaves [N-1, 2N-2], leaf j
holds face `leaf_face[j]`. Each node knows its left child and the node
to go to when its subtree is skipped or done, so a walk needs no stack.

The container holds numpy arrays, whoever built it: `build` and `refit`
compute on the positions' device and return the arrays on the host,
where the cluster builds (`ctree`, `clusters`) read them, as they read
the native SAH tree (`host_bvh.build_sah`). `packed.pack` moves the
walk's table to the positions' device. `LBVH.tensors` uploads the arrays
once; `refit` and `pack` of that `LBVHTensors` stay on its device, so a
fit step that refits every step makes no host round trip.

Parity: the build is integer work apart from the centroid
(p0 + p1 + p2) / 3, the scene bounds, the [0, 1] mapping and the box
min / max, each a separate IEEE operation, so the same inputs give the
same tree on the CPU, on the card and in the JAX package run op by op.
Like the JAX package, it runs exactly 32 range-growing rounds, two
31-step searches and 64 rounds each of refit and skip links: a tree
deeper than 64 levels keeps the boxes and links those rounds reach.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import BIG
from ..core.types import TensorTree

_U32 = 0xFFFFFFFF
# descending powers of two of the range and split searches
_T_SEQ = tuple(2 ** k for k in range(30, -1, -1))


@dataclasses.dataclass
class LBVH:
    left: np.ndarray       # (2N-1,) int32 left child, -1 for leaves
    skip: np.ndarray       # (2N-1,) int32 next node when done, -1 = exit
    bmin: np.ndarray       # (2N-1, 3) f32
    bmax: np.ndarray       # (2N-1, 3) f32
    leaf_face: np.ndarray  # (N,) int32

    @property
    def num_leaves(self) -> int:
        return self.leaf_face.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]

    def tensors(self, device) -> "LBVHTensors":
        """The arrays as tensors on `device` (links and faces int64)."""
        def up(a, dtype):
            return torch.from_numpy(np.array(a, dtype)).to(device)
        return LBVHTensors(left=up(self.left, np.int64),
                           skip=up(self.skip, np.int64),
                           bmin=up(self.bmin, np.float32),
                           bmax=up(self.bmax, np.float32),
                           leaf_face=up(self.leaf_face, np.int64))


@dataclasses.dataclass
class LBVHTensors(TensorTree):
    """An LBVH's arrays on one device (`LBVH.tensors`)."""
    left: torch.Tensor       # (2N-1,) int64
    skip: torch.Tensor       # (2N-1,) int64
    bmin: torch.Tensor       # (2N-1, 3) f32
    bmax: torch.Tensor       # (2N-1, 3) f32
    leaf_face: torch.Tensor  # (N,) int64

    @property
    def num_leaves(self) -> int:
        return self.leaf_face.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]

    def tensors(self, device) -> "LBVHTensors":
        """Itself on `device`: refit and pack take either container."""
        return self.to(device)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits after each of the low 10 bits (int64 holding
    a uint32; every mask fits in 32 bits, so each `&` is also the
    uint32 wrap of the product)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(xyz01: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of coordinates in [0, 1]^3, (..., 3) f32 ->
    (...,) int64 holding the uint32 code. Each coordinate is clipped to
    [0, 1023] after scaling by 1024 and truncated toward zero."""
    q = torch.clamp(xyz01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (((_expand_bits(q[..., 0]) << 2) & _U32)
            | ((_expand_bits(q[..., 1]) << 1) & _U32)
            | _expand_bits(q[..., 2]))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the uint32 in each int64 (32 for 0), by a binary
    search over shifts."""
    x = x & _U32
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_zero = (x >> (32 - s)) == 0
        n = n + top_zero.to(x.dtype) * s
        x = torch.where(top_zero, (x << s) & _U32, x)
    return torch.where(x == 0, torch.full_like(n, 32), n)


def _to_host(bvh_arrays) -> LBVH:
    left, skip, bmin, bmax, leaf_face = (a.cpu().numpy() for a in bvh_arrays)
    return LBVH(left=left.astype(np.int32), skip=skip.astype(np.int32),
                bmin=bmin, bmax=bmax, leaf_face=leaf_face.astype(np.int32))


def _leaf_boxes(p0, p1, p2, valid):
    """(lmin, lmax) of each leaf's triangle; invalid faces get the empty
    box (BIG, -BIG)."""
    v = valid[:, None]
    lmin = torch.minimum(torch.minimum(p0, p1), p2)
    lmax = torch.maximum(torch.maximum(p0, p1), p2)
    return (torch.where(v, lmin, torch.full_like(lmin, BIG)),
            torch.where(v, lmax, torch.full_like(lmax, -BIG)))


def _refit_rounds(bmin, bmax, lc, rc, ni: int):
    """64 rounds of internal box = union of its children's boxes."""
    for _ in range(64):
        nmin = torch.minimum(bmin[lc], bmin[rc])
        nmax = torch.maximum(bmax[lc], bmax[rc])
        bmin[:ni] = nmin
        bmax[:ni] = nmax
    return bmin, bmax


@torch.no_grad()
def build(positions: torch.Tensor, faces: torch.Tensor,
          face_valid: torch.Tensor) -> LBVH:
    """The LBVH over (possibly padded) faces, computed on the positions'
    device: positions (V, 3) f32, faces (F, 3) int, face_valid (F,)
    bool, F >= 2. Invalid faces sort last with empty boxes."""
    dev = positions.device
    n = faces.shape[0]
    if n < 2:
        raise ValueError("LBVH needs at least 2 (padded) faces")
    positions = positions.detach()
    f = faces.to(dev, torch.int64)
    valid = face_valid.to(dev)
    p0, p1, p2 = (positions[f[:, k]] for k in range(3))
    centroid = (p0 + p1 + p2) / 3.0

    # scene bounds over valid centroids (invalid faces take the top code
    # so they sort to the end)
    vmask = valid[:, None]
    cmin = torch.amin(torch.where(vmask, centroid,
                                  torch.full_like(centroid, BIG)), dim=0)
    cmax = torch.amax(torch.where(vmask, centroid,
                                  torch.full_like(centroid, -BIG)), dim=0)
    extent = torch.clamp(cmax - cmin, min=1e-9)
    unit = torch.clamp((centroid - cmin) / extent, 0.0, 1.0)
    codes = torch.where(valid, morton3d(unit),
                        torch.full((n,), _U32, dtype=torch.int64, device=dev))
    codes, order = torch.sort(codes, stable=True)
    leaf_face = order

    ni = n - 1
    idx = torch.arange(ni, dtype=torch.int64, device=dev)
    codes_i = codes[:ni]
    minus1 = torch.full_like(idx, -1)

    def delta(j):
        """Common-prefix length of sorted codes idx and j, ties broken by
        the index bits (Karras 2012 sec. 4); -1 outside [0, n-1]."""
        ok = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = codes_i ^ codes[jc]
        d = torch.where(x == 0, 32 + _clz32(idx ^ jc), _clz32(x))
        return torch.where(ok, d, minus1)

    # direction and length of each node's range
    d_dir = torch.sign(delta(idx + 1) - delta(idx - 1))
    d_dir = torch.where(d_dir == 0, torch.ones_like(d_dir), d_dir)
    delta_min = delta(idx - d_dir)
    l_max = torch.full_like(idx, 2)
    for _ in range(32):
        l_max = torch.where(delta(idx + l_max * d_dir) > delta_min, l_max * 2,
                            l_max)
    # exact length: the largest l with delta(idx, idx + l d) > delta_min,
    # summed over descending powers of two
    length = torch.zeros_like(idx)
    for t in _T_SEQ:
        use = t < l_max
        cand = length + torch.where(use, t, 0)
        ok = use & (delta(idx + cand * d_dir) > delta_min)
        length = torch.where(ok, cand, length)
    j = idx + length * d_dir
    first = torch.minimum(idx, j)
    last = torch.maximum(idx, j)

    # split: the highest differing bit within [first, last]
    delta_node = delta(j)
    s = torch.zeros_like(idx)
    for t in _T_SEQ:
        cand = s + t
        ok = (cand < length) & (delta(idx + cand * d_dir) > delta_node)
        s = torch.where(ok, cand, s)
    gamma = idx + s * d_dir + torch.clamp(d_dir, max=0)

    left_child = torch.where(first == gamma, ni + gamma, gamma)
    right_child = torch.where(last == gamma + 1, ni + gamma + 1, gamma + 1)
    total = 2 * n - 1
    left = torch.full((total,), -1, dtype=torch.int64, device=dev)
    right = torch.full_like(left, -1)
    left[:ni] = left_child
    right[:ni] = right_child
    parent = torch.full_like(left, -1)
    parent[left_child] = idx
    parent[right_child] = idx
    is_left = torch.zeros((total,), dtype=torch.bool, device=dev)
    is_left[left_child] = True

    # bottom-up boxes
    lmin, lmax = _leaf_boxes(p0[leaf_face], p1[leaf_face], p2[leaf_face],
                             valid[leaf_face])
    bmin = torch.full((total, 3), BIG, dtype=torch.float32, device=dev)
    bmax = torch.full((total, 3), -BIG, dtype=torch.float32, device=dev)
    bmin[ni:] = lmin
    bmax[ni:] = lmax
    bmin, bmax = _refit_rounds(bmin, bmax, torch.clamp(left[:ni], 0, total - 1),
                               torch.clamp(right[:ni], 0, total - 1), ni)

    # skip links: a left child skips to its sibling, a right child to its
    # parent's skip
    par = torch.clamp(parent, 0, total - 1)
    sibling = torch.where(is_left, right[par], left[par])
    no_parent = parent < 0
    skip = torch.full_like(left, -1)
    for _ in range(64):
        skip = torch.where(no_parent, -1, torch.where(is_left, sibling,
                                                      skip[par]))
    return _to_host((left, skip, bmin, bmax, leaf_face))


@torch.no_grad()
def refit(bvh, positions: torch.Tensor, faces: torch.Tensor,
          face_valid: torch.Tensor):
    """The same topology with boxes recomputed for moved vertices, on
    the positions' device; returns the kind of container it was given:
    an LBVH (numpy, the boxes copied back to the host) or an LBVHTensors
    (on its device, no copy). Every internal box starts from the
    given tree's, as in the JAX package. A node's right child is
    recovered as the skip of its left child."""
    dev = positions.device
    tree = bvh.tensors(dev)
    n = tree.num_leaves
    total = tree.num_nodes
    ni = n - 1
    f = faces.to(dev, torch.int64)[tree.leaf_face]
    positions = positions.detach()
    lmin, lmax = _leaf_boxes(positions[f[:, 0]], positions[f[:, 1]],
                             positions[f[:, 2]],
                             face_valid.to(dev)[tree.leaf_face])
    bmin = tree.bmin.clone()
    bmax = tree.bmax.clone()
    bmin[ni:] = lmin
    bmax[ni:] = lmax
    lc = torch.clamp(tree.left[:ni], 0, total - 1)
    rc = torch.clamp(tree.skip[lc], 0, total - 1)
    bmin, bmax = _refit_rounds(bmin, bmax, lc, rc, ni)
    if isinstance(bvh, LBVHTensors):
        return dataclasses.replace(tree, bmin=bmin, bmax=bmax)
    return dataclasses.replace(bvh, bmin=bmin.cpu().numpy(),
                               bmax=bmax.cpu().numpy())
