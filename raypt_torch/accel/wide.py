"""The 4-wide BVH with fat leaves and its ordered-stack walk
(`raypt/accel/wide.py`), the tree of the `bvh4` backend.

The wide tree is collapsed from the binary Karras LBVH on the positions'
device: subtree leaf counts and leaf-range starts by 64 bottom-up
rounds, depths by 64 top-down rounds, ids by cumulative sums, as in the
JAX package. Every value is a gather, a select, an integer sum or the
subtraction p - p0, so the rows are the JAX package's bit for bit
(the dump row aside: many nodes scatter into it).

Row layout (64 x f32):
  internal row k (k < nw_cap):
    [e*6:(e+1)*6]  box of entry e (inverted box = missing entry)
    [24+e]         child row id of entry e (int32 bits), -1 = none
  leaf row nw_cap + b:
    [t*12:(t+1)*12] = p0(3), e1(3), e2(3), face id (int32 bits), 0, 0
    for its LEAF_K triangle slots; an empty or invalid slot has
    e1 = e2 = 0 and is never hit.

`traverse_wide` is the plain torch walk, the one the CPU runs and the
one `csrc/wide_walk.cu` (`kernels.wide_walk`) is held against, bitwise,
on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import BIG
from ..core.types import TensorTree
from .packed import _itof, ftoi, leaf_hit, safe_reciprocal

ROW = 64
LEAF_K = 4      # triangles a leaf row
STACK_D = 64    # default pending-entry budget of a ray; a push beyond it
                # sets the ray's overflow flag, and find_closest_wide
                # walks the flagged rays again with a 4x deeper stack
ROUNDS = 64     # bottom-up and top-down fixpoint rounds of collapse
POP_FILL = -(1 << 31)   # a pop from a slot >= stack_d reads this
                        # (jnp.take_along_axis's fill), ending the walk
CHECK_EVERY = 16        # plain walk steps between host reads of "any ray
                        # still walking"


@dataclasses.dataclass
class WideBVH(TensorTree):
    rows: torch.Tensor   # (nw_cap + nb_cap + 1, ROW) f32; the last is a dump row
    root: int            # row id of the root
    nw_cap: int          # internal rows: ids >= nw_cap are leaf rows

    @property
    def num_rows(self) -> int:
        return self.rows.shape[0]


def wide_from_numpy(rows, root, nw_cap, device="cuda") -> WideBVH:
    """The port's WideBVH from the JAX package's `collapse` output, row
    bits kept."""
    return WideBVH(rows=torch.from_numpy(np.array(rows, np.float32)).to(
        device), root=int(root), nw_cap=int(nw_cap))


@torch.no_grad()
def collapse(bvh, positions: torch.Tensor, faces: torch.Tensor,
             face_valid: torch.Tensor) -> WideBVH:
    """Collapse the binary LBVH (an LBVH, or its LBVHTensors) into the
    wide layout on the positions' device. Fixed shapes: nw_cap = N - 1
    internal rows, N leaf rows and the dump row. Reading the root id
    back is the one host read."""
    dev = positions.device
    tree = bvh.tensors(dev)
    positions = positions.detach()
    n = tree.num_leaves
    ni = n - 1
    total = 2 * n - 1
    idx = torch.arange(total, device=dev)
    left = tree.left
    l_int = torch.clamp(left, 0, total - 1)
    right = torch.where(left >= 0, tree.skip[l_int], -1)   # left's sibling
    r_int = torch.clamp(right, 0, total - 1)
    is_leaf_bin = idx >= ni

    parent = torch.full((total,), -1, dtype=torch.int64, device=dev)
    parent[l_int[:ni]] = idx[:ni]
    parent[r_int[:ni]] = idx[:ni]

    # subtree leaf counts and leaf-range starts (bottom-up fixpoints)
    counts = is_leaf_bin.to(torch.int64)
    starts = torch.where(is_leaf_bin, idx - ni, 0)
    for _ in range(ROUNDS):
        ci = counts[l_int] + counts[r_int]
        si = torch.minimum(starts[l_int], starts[r_int])
        counts = torch.cat([ci[:ni], counts[ni:]])
        starts = torch.cat([si[:ni], starts[ni:]])

    # depth (top-down fixpoint through the parents)
    par = torch.clamp(parent, 0, total - 1)
    depth = torch.zeros((total,), dtype=torch.int64, device=dev)
    for _ in range(ROUNDS):
        depth = torch.where(parent < 0, 0, depth[par] + 1)

    # cut nodes (<= LEAF_K leaves under a parent with more) become leaf
    # rows; even-depth internal nodes with more than LEAF_K become wide
    cut = (counts <= LEAF_K) & (torch.where(parent >= 0, counts[par],
                                            LEAF_K + 1) > LEAF_K)
    wide = (~is_leaf_bin) & (counts > LEAF_K) & (depth % 2 == 0)
    nw_cap, nb_cap = ni, n
    wide_id = torch.cumsum(wide.to(torch.int64), 0) - 1
    block_id = torch.cumsum(cut.to(torch.int64), 0) - 1

    def row_id(e):
        """Binary node id -> wide row id (internal or leaf row)."""
        e = torch.clamp(e, 0, total - 1)
        return torch.where(cut[e], nw_cap + block_id[e], wide_id[e])

    # internal rows: an entry is a cut child itself, else its two children
    L, R = l_int, r_int
    cut_l, cut_r = cut[L], cut[R]
    minus1 = torch.full_like(L, -1)
    entries = torch.stack([torch.where(cut_l, L, l_int[L]),
                           torch.where(cut_l, minus1, r_int[L]),
                           torch.where(cut_r, R, l_int[R]),
                           torch.where(cut_r, minus1, r_int[R])], dim=1)
    evalid = (entries >= 0)[..., None]
    ec = torch.clamp(entries, min=0)
    ebmin = torch.where(evalid, tree.bmin[ec], BIG)
    ebmax = torch.where(evalid, tree.bmax[ec], -BIG)
    eid = torch.where(entries >= 0, row_id(entries), -1)

    n_rows = nw_cap + nb_cap
    dump = n_rows                       # scratch row, never visited
    rows = torch.zeros((n_rows + 1, ROW), dtype=torch.float32, device=dev)
    rows[:, 0:3] = BIG                  # inverted boxes everywhere
    rows[:, 3:6] = -BIG
    tgt = torch.where(wide, wide_id, dump)
    box6 = torch.cat([ebmin, ebmax], dim=-1).reshape(total, 24)
    rows[tgt, :28] = torch.cat([box6, _itof(eid)], dim=-1)

    # leaf rows: block b <- cut node c, triangles lf[starts[c] : +counts[c]]
    lf = tree.leaf_face
    k = torch.arange(LEAF_K, device=dev)[None, :]
    slot_ok = (k < counts[:, None]) & cut[:, None]
    tri_ids = torch.where(slot_ok, lf[torch.clamp(starts[:, None] + k, 0,
                                                  n - 1)], 0)
    fvalid = (slot_ok & face_valid.to(dev)[tri_ids])[..., None]
    f = faces.to(dev, torch.int64)[tri_ids]
    p0, p1, p2 = (positions[f[..., j]] for j in range(3))
    zero = torch.zeros_like(p0)
    payload = torch.cat([p0, torch.where(fvalid, p1 - p0, zero),
                         torch.where(fvalid, p2 - p0, zero),
                         _itof(tri_ids)[..., None],
                         torch.zeros(p0.shape[:-1] + (2,), device=dev)],
                        dim=-1)
    leaf_tgt = torch.where(cut, nw_cap + block_id, dump)
    rows[leaf_tgt, :LEAF_K * 12] = payload.reshape(total, LEAF_K * 12)

    root = int(row_id(torch.zeros((), dtype=torch.int64, device=dev)))
    return WideBVH(rows=rows, root=root, nw_cap=nw_cap)


def slab_entries(r: torch.Tensor, o, iv, tb):
    """The four entries of internal rows r (n, ROW): (entry distance
    (n, 4), inf where missed or absent; child row ids (n, 4) int32), in
    the JAX package's operation order: each box is hit when tfar >=
    tnear, tnear < tb, tfar > 0 and it is not empty (min / max propagate
    NaN, so a NaN misses); a hit entry's distance is max(tnear, 0)."""
    inf = torch.full_like(tb, float("inf"))
    tn = []
    for b0 in (0, 6, 12, 18):
        bmin, bmax = r[:, b0:b0 + 3], r[:, b0 + 3:b0 + 6]
        t1 = (bmin - o) * iv
        t2 = (bmax - o) * iv
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        nonempty = ((bmin[:, 0] <= bmax[:, 0]) & (bmin[:, 1] <= bmax[:, 1])
                    & (bmin[:, 2] <= bmax[:, 2]))
        ok = (far >= near) & (near < tb) & (far > 0.0) & nonempty
        tn.append(torch.where(ok, torch.clamp(near, min=0.0), inf))
    cid = ftoi(r[:, 24:28].contiguous())
    tn = torch.where(cid >= 0, torch.stack(tn, dim=1), float("inf"))
    return tn, cid


def sort4(tn: torch.Tensor, cid: torch.Tensor):
    """(tn, cid) ascending by tn through the exchange network (0,1),
    (2,3), (0,2), (1,3), (1,2), swapping on strict > only."""
    tn, cid = tn.clone(), cid.clone()
    for a, b in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        swap = tn[:, a] > tn[:, b]
        ta, tb_ = tn[:, a].clone(), tn[:, b].clone()
        ia, ib = cid[:, a].clone(), cid[:, b].clone()
        tn[:, a] = torch.where(swap, tb_, ta)
        tn[:, b] = torch.where(swap, ta, tb_)
        cid[:, a] = torch.where(swap, ib, ia)
        cid[:, b] = torch.where(swap, ia, ib)
    return tn, cid


@torch.no_grad()
def traverse_wide(w: WideBVH, ro: torch.Tensor, rd: torch.Tensor,
                  t0: torch.Tensor, active: torch.Tensor,
                  stack_d: int = STACK_D, visits: list | None = None,
                  steps: list | None = None, depths: list | None = None):
    """Ordered stack walk of a wavefront: ro, rd (R, 3) f32 with rd
    normalized, t0 (R,) the starting best distance (the sphere pass's
    t), active (R,) bool. Returns (t_best (R,) f32, face (R,) int32, -1
    = none, overflow (R,) bool): overflow marks rays whose stack had to
    drop a pending subtree (their result may miss a hit; the caller
    walks them again with a deeper stack). t_best starts as t0 + rd.x *
    0.0, as in the JAX package, dead rays too.

    A live ray's step reads its row. An internal row's four entries are
    slab-tested, sorted near to far, the hit entries 3, 2, 1 pushed
    (a push at sp >= stack_d writes nothing, sets the flag and still
    counts), and the ray descends to entry 0 when it is hit, else pops.
    A leaf row's four triangles are tested in slot order, each taken
    when strictly nearer; then the ray pops. A pop from slot sp - 1 >=
    stack_d reads POP_FILL, which ends the walk, as JAX's take_along_axis
    fill does. Node ids are clamped to the table as JAX's gather clamps.

    Each step is computed for the rays still walking at the last check;
    a finished ray is inert, so checking only every CHECK_EVERY steps
    changes no result. With a `visits` list, each step appends (internal
    rows read, leaf rows read), for the kernel's bound; with a `steps`
    list, (the indices of the rays that took the step (int64), the rows
    they read (int64), which of them sat on a leaf row (bool)), the
    record of `accel.packed.traverse_wavefront` that `simd_efficiency`
    and `mixed_share` read; with a `depths` list, those rays' stack
    depth after the step's pushes (int64: the entries pending, pushes
    beyond stack_d counted), whose maximum is the deepest slot a walk
    writes plus one. A step that records syncs with the host."""
    rows = w.rows
    dev = ro.device
    n_rows = rows.shape[0]
    t_best = t0 + rd[:, 0] * 0.0
    face = torch.full(t0.shape, -1, dtype=torch.int32, device=dev)
    ovf = torch.zeros(t0.shape, dtype=torch.bool, device=dev)
    live = torch.nonzero(active).flatten()
    m = live.numel()
    # the walkers' state, indexed like `live`
    node = torch.full((m,), w.root, dtype=torch.int64, device=dev)
    sp = torch.zeros((m,), dtype=torch.int64, device=dev)
    stack = torch.zeros((m, stack_d), dtype=torch.int32, device=dev)
    o_all, d_all = ro[live], rd[live]
    iv_all = safe_reciprocal(d_all)
    tb_all, f_all, ov_all = t_best[live], face[live], ovf[live]
    sel = torch.arange(m, device=dev)   # walkers still walking at the check
    step = 0
    while sel.numel():
        nd = node[sel]
        walking = nd >= 0
        r = rows[torch.clamp(nd, 0, n_rows - 1)]
        o, d, iv, tb = o_all[sel], d_all[sel], iv_all[sel], tb_all[sel]
        s, fc, ov = sp[sel], f_all[sel], ov_all[sel]
        is_leaf = nd >= w.nw_cap
        if visits is not None:
            visits.append((int((walking & ~is_leaf).sum()),
                           int((walking & is_leaf).sum())))
        if steps is not None:
            steps.append((live[sel[walking]], torch.clamp(
                nd[walking], 0, n_rows - 1), is_leaf[walking]))

        # internal: four ordered slab tests and the pushes, far first
        tn, cid = sort4(*slab_entries(r, o, iv, tb))
        hit = tn < float("inf")
        can_push = walking & ~is_leaf
        for k in (3, 2, 1):
            do = can_push & hit[:, k]
            ov = ov | (do & (s >= stack_d))
            at = torch.clamp(s, max=stack_d - 1)
            stack[sel, at] = torch.where(do & (s < stack_d), cid[:, k],
                                         stack[sel, at])
            s = s + do.to(torch.int64)
        if depths is not None:
            depths.append(s[walking])

        # leaf: four Moller-Trumbore tests in slot order
        leaf_now = walking & is_leaf
        for slot in range(LEAF_K):
            b = slot * 12
            tri, t = leaf_hit(r[:, b:b + 3], r[:, b + 3:b + 6],
                              r[:, b + 6:b + 9], o, d, tb)
            take = leaf_now & tri
            tb = torch.where(take, t, tb)
            fc = torch.where(take, ftoi(r[:, b + 9].contiguous()), fc)

        # next node: descend to entry 0 when it is hit, else pop
        descend = can_push & hit[:, 0]
        can_pop = walking & (is_leaf | ~hit[:, 0]) & (s > 0)
        s_pop = torch.clamp(s - 1, min=0)
        popped = stack[sel, torch.clamp(s_pop, max=stack_d - 1)]
        popped = torch.where(s_pop < stack_d, popped, POP_FILL).to(torch.int64)
        nxt = torch.where(descend, cid[:, 0].to(torch.int64),
                          torch.where(can_pop, popped, -1))
        node[sel] = torch.where(walking, nxt, nd)
        sp[sel] = torch.where(can_pop, s_pop, s)
        tb_all[sel], f_all[sel], ov_all[sel] = tb, fc, ov
        step += 1
        if step % CHECK_EVERY == 0:
            sel = sel[node[sel] >= 0]
    t_best[live], face[live], ovf[live] = tb_all, f_all, ov_all
    return t_best, face, ovf
