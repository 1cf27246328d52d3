"""The packed skip-link table and its walk (`raypt/accel/packed.py`):
one 64-byte row per node, so a walk step reads one row.

Row layout (16 x f32):
  internal: [0:3]=bmin [3:6]=bmax [12]=left child [13]=skip [14]=0
  leaf:     [0:3]=p0   [3:6]=e1   [6:9]=e2 [12]=face id [13]=skip [14]=1
Integer links are int32 bit patterns in float slots. A leaf row holds
its triangle in edge form and is tested without a box test; an invalid
face gets e1 = e2 = 0, so det = 0 and it is never hit.

`traverse_wavefront` is the plain torch walk, the one the CPU runs and
the one `csrc/packed_walk.cu` (`kernels.packed_walk`) is held against,
bitwise, on the card. `split_table`, `traverse_split` and
`octant_order` model what the kernel changes (its table, its walk, its
rays' order) for the CPU tests and the design sweep. The
cherry, quad and lookahead layouts are not ported (ROADMAP queue 1, the
"LBVH build and the packed `bvh` backend" item).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.math3d import EPS, cross, dot
from ..core.types import TensorTree

ROW = 16


@dataclasses.dataclass
class PackedLBVH(TensorTree):
    rows: torch.Tensor   # (2N-1, 16) f32

    @property
    def num_nodes(self) -> int:
        return self.rows.shape[0]


def _itof(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def ftoi(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


@torch.no_grad()
def pack(bvh, positions: torch.Tensor, faces: torch.Tensor,
         face_valid: torch.Tensor) -> PackedLBVH:
    """The packed table of an LBVH, or of its `LBVHTensors` (read where
    they lie, with no host copy), at the current vertex positions, on
    the positions' device. Re-run after `lbvh.refit`."""
    dev = positions.device
    tree = bvh.tensors(dev)
    n = tree.num_leaves
    total = tree.num_nodes
    ni = n - 1
    lf = tree.leaf_face
    rows = torch.zeros((total, ROW), dtype=torch.float32, device=dev)
    rows[:ni, 0:3] = tree.bmin[:ni]
    rows[:ni, 3:6] = tree.bmax[:ni]
    rows[:ni, 12] = _itof(tree.left[:ni])
    rows[:ni, 13] = _itof(tree.skip[:ni])

    f = faces.to(dev, torch.int64)[lf]
    positions = positions.detach()
    p0, p1, p2 = (positions[f[:, k]] for k in range(3))
    ok = face_valid.to(dev)[lf][:, None]
    zero = torch.zeros_like(p0)
    rows[ni:, 0:3] = p0
    rows[ni:, 3:6] = torch.where(ok, p1 - p0, zero)
    rows[ni:, 6:9] = torch.where(ok, p2 - p0, zero)
    rows[ni:, 12] = _itof(lf)
    rows[ni:, 13] = _itof(tree.skip[ni:])
    rows[ni:, 14] = 1.0
    return PackedLBVH(rows=rows)


def safe_reciprocal(rd: torch.Tensor) -> torch.Tensor:
    """1 / rd with components below 1e-12 in magnitude clamped to
    +-1e-12 (sign of the component, +0 counting as positive), so the
    slab test never multiplies 0 by inf."""
    tiny = torch.full_like(rd, 1e-12)
    safe = torch.where(rd.abs() > 1e-12, rd,
                       torch.where(rd >= 0, tiny, -tiny))
    return 1.0 / safe


def slab_hit(bmin, bmax, o, iv, tb):
    """The slab test of internal rows, in the JAX package's order: the
    box is hit when tfar >= tnear, tnear < tb, tfar > 0 and it is not
    empty (min / max propagate NaN, so a NaN misses)."""
    tn1 = (bmin - o) * iv
    tn2 = (bmax - o) * iv
    lo = torch.minimum(tn1, tn2)
    hi = torch.maximum(tn1, tn2)
    tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    nonempty = ((bmin[:, 0] <= bmax[:, 0]) & (bmin[:, 1] <= bmax[:, 1])
                & (bmin[:, 2] <= bmax[:, 2]))
    return (tfar >= tnear) & (tnear < tb) & (tfar > 0.0) & nonempty


def leaf_hit(p0, e1, e2, o, d, tb):
    """The Moller-Trumbore test of leaf rows: (hit strictly nearer than
    tb, t)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() > EPS
    one = torch.ones_like(det)
    inv_det = torch.where(ok, one, torch.zeros_like(det)) / torch.where(
        ok, det, one)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
            & (t < tb)))
    return hit, t


@torch.no_grad()
def traverse_wavefront(pbvh: PackedLBVH, ro: torch.Tensor, rd: torch.Tensor,
                       t0: torch.Tensor, active: torch.Tensor,
                       max_iters: int | None = None, unroll: int = 8,
                       visits: list | None = None, steps: list | None = None):
    """Skip-link walk of a wavefront: ro, rd (R, 3) f32 with rd
    normalized, t0 (R,) f32 the starting best distance (the sphere pass's
    t), active (R,) bool. Returns (t_best (R,) f32, face (R,) int32, -1
    = none); a dead ray keeps t0 and face -1.

    Each step of a live ray reads its node's row and, in the JAX
    package's operation order, as separate elementwise ops: the slab
    test of an internal row (hit -> left child, else skip) and the
    Moller-Trumbore test of a leaf row (taken when strictly nearer than
    t_best; then skip). The walk ends at node -1. Only the rays still
    walking are computed each step; rays are independent, so that
    changes no result.

    `unroll` is the JAX loop's steps per iteration and changes no
    result. `max_iters`, when given, cuts each ray's walk after
    max_iters * unroll steps, as the JAX loop does; no finder passes it.
    With a `visits` list, each step appends (rows read, leaf rows read),
    for the kernel's bound; with a `steps` list, (the indices of the rays
    that took the step (int64), the rows they read (int32), which of
    them sat on a leaf row (bool)): a record for `simd_efficiency` and
    `mixed_share`, the schedule of one thread a ray in launch order."""
    rows = pbvh.rows
    inv = safe_reciprocal(rd)
    node = torch.where(active, 0, -1).to(torch.int32)
    t_best = t0.clone()
    face = torch.full_like(node, -1)
    max_steps = None if max_iters is None else max_iters * unroll
    live = torch.nonzero(node >= 0).flatten()
    step = 0
    while live.numel() and (max_steps is None or step < max_steps):
        r = rows[node[live].long()]
        o, d, iv, tb = ro[live], rd[live], inv[live], t_best[live]
        is_leaf = r[:, 14] > 0.5
        if visits is not None:
            visits.append((live.numel(), int(is_leaf.sum())))
        if steps is not None:
            steps.append((live, node[live], is_leaf))

        hit_box = slab_hit(r[:, 0:3], r[:, 3:6], o, iv, tb)
        tri_hit, t = leaf_hit(r[:, 0:3], r[:, 3:6], r[:, 6:9], o, d, tb)

        take = is_leaf & tri_hit
        link, nxt_skip = ftoi(r[:, 12]), ftoi(r[:, 13])
        t_best[live] = torch.where(take, t, tb)
        face[live] = torch.where(take, link, face[live])
        nxt = torch.where(is_leaf | ~hit_box, nxt_skip, link)
        node[live] = nxt
        live = live[nxt >= 0]
        step += 1
    return t_best, face


# Plain models of the kernel: its split table, its walk and its rays'
# order, held against traverse_wavefront on the CPU.
LEAF_BIT = -(1 << 31)   # a split code's leaf flag, the int32 sign bit
WARP = 32


def split_table(rows: torch.Tensor):
    """csrc/packed_walk.cuh's split table of a packed table (its
    split_build_kernel): (inner (N, 8), leaves (N, 12)) f32, row n's
    floats copied bit for bit, its links as codes: -1 for a link < 0,
    s for an internal row s, s | LEAF_BIT for a leaf row s.
      inner:  [bmin, bmax, code(left), code(skip)] (internal rows)
      leaves: [p0, e1, e2, face, code(skip), 0]    (leaf rows)
    The rows of the other kind are zeros here (the kernel leaves them
    unwritten; no walk reads them)."""
    bits = rows.contiguous().view(torch.int32)
    is_leaf = rows[:, 14] > 0.5
    n = rows.shape[0]

    def code(s):
        ok = s >= 0
        leaf = is_leaf[s.clamp(0, n - 1).long()] & ok
        return torch.where(ok, torch.where(leaf, s | LEAF_BIT, s),
                           torch.full_like(s, -1))

    inner = torch.zeros((n, 8), dtype=torch.int32, device=rows.device)
    inner[:, 0:6] = bits[:, 0:6]
    inner[:, 6] = code(bits[:, 12])
    inner[:, 7] = code(bits[:, 13])
    leaves = torch.zeros((n, 12), dtype=torch.int32, device=rows.device)
    leaves[:, 0:9] = bits[:, 0:9]
    leaves[:, 9] = bits[:, 12]
    leaves[:, 10] = code(bits[:, 13])
    inner[is_leaf] = 0
    leaves[~is_leaf] = 0
    return inner.view(torch.float32), leaves.view(torch.float32)


def split_steps(table, c, si, sl, ro, rd, inv, t_best, face,
                left=None, trace=None):
    """One step of the rays `si` on internal rows and `sl` on leaf rows
    over the split table `table` (split_table's pair), in place: their
    codes c, and t_best and face where a leaf test hits. `left`, each
    ray's steps still allowed where a cap is given, counts down and ends
    a walk at 0. With a `trace` list, appends (the rays that stepped,
    their rows, which sat on a leaf row), traverse_wavefront's `steps`
    record."""
    inner, leaves = table
    if trace is not None:
        trace.append((torch.cat([si, sl]),
                      torch.cat([c[si], c[sl] & ~LEAF_BIT]),
                      torch.cat([torch.zeros_like(si, dtype=torch.bool),
                                 torch.ones_like(sl, dtype=torch.bool)])))
    if si.numel():
        row = inner[c[si].long()]
        bits = row.view(torch.int32)
        hit = slab_hit(row[:, 0:3], row[:, 3:6], ro[si], inv[si], t_best[si])
        c[si] = torch.where(hit, bits[:, 6], bits[:, 7])
    if sl.numel():
        row = leaves[(c[sl] & ~LEAF_BIT).long()]
        bits = row.view(torch.int32)
        hit, t = leaf_hit(row[:, 0:3], row[:, 3:6], row[:, 6:9], ro[sl],
                          rd[sl], t_best[sl])
        t_best[sl] = torch.where(hit, t, t_best[sl])
        face[sl] = torch.where(hit, bits[:, 9], face[sl])
        c[sl] = bits[:, 10]
    if left is not None:
        stepped = torch.cat([si, sl])
        left[stepped] -= 1
        c[stepped] = torch.where(left[stepped] == 0, -1, c[stepped])


def split_start(pbvh: PackedLBVH, active: torch.Tensor, lanes: int,
                max_iters: int | None, unroll: int):
    """A split-table walk's start on `lanes` lanes (rays past the end of
    `active` dead): each ray's code (the root's, or -1 for a dead ray or
    a cap of 0 steps) and, under a cap, its steps allowed (else None)."""
    root = LEAF_BIT if bool(pbvh.rows[0, 14] > 0.5) else 0
    max_steps = None if max_iters is None else max(max_iters, 0) * unroll
    c = torch.full((lanes,), -1, dtype=torch.int32, device=active.device)
    if max_steps != 0:
        c[:active.shape[0]] = torch.where(active, root, -1).to(torch.int32)
    left = None if max_steps is None else torch.full(
        (lanes,), max_steps, dtype=torch.int64, device=active.device)
    return c, left


@torch.no_grad()
def traverse_split(pbvh: PackedLBVH, ro: torch.Tensor, rd: torch.Tensor,
                   t0: torch.Tensor, active: torch.Tensor,
                   max_iters: int | None = None, unroll: int = 8,
                   trace: list | None = None):
    """The kernel's walk: traverse_wavefront's contract and result over
    the split table, each ray's steps counted down from its cap as the
    kernel counts them. Every iteration each ray whose walk goes on
    takes one step of its own row's kind, as a thread of the kernel
    does. Each ray reads the rows traverse_wavefront reads in the same
    order, so the result is the same bit for bit. `trace`: split_steps'
    record."""
    table = split_table(pbvh.rows)
    c, left = split_start(pbvh, active, ro.shape[0], max_iters, unroll)
    inv = safe_reciprocal(rd)
    t_best = t0.clone()
    face = torch.full((ro.shape[0],), -1, dtype=torch.int32, device=ro.device)
    while bool((c != -1).any()):
        split_steps(table, c, torch.nonzero(c >= 0).flatten(),
                    torch.nonzero(c < -1).flatten(), ro, rd, inv, t_best,
                    face, left, trace)
    return t_best, face


def octant_order(rd: torch.Tensor, active: torch.Tensor,
                 block: int) -> torch.Tensor:
    """The ray each thread walks where the kernel's blocks of `block`
    threads hand their rays out by direction octant (csrc/packed_walk.cuh:
    sorted_ray): (lanes,) int64 for the wavefront padded to whole blocks,
    in each block a stable sort of its rays on the key octant (bit k set
    where direction component k < 0) for a live ray and 8 for a dead one,
    the padding (index >= R) last."""
    r = rd.shape[0]
    lanes = -(-r // block) * block
    neg = (rd < 0).long()
    key = torch.full((lanes,), 8, dtype=torch.int64, device=rd.device)
    key[:r] = torch.where(active, neg[:, 0] | (neg[:, 1] << 1)
                          | (neg[:, 2] << 2), 8)
    lane = torch.arange(lanes, device=rd.device)
    return torch.argsort((lane // block) * 16 + key, stable=True)


def _warp_steps(record, kind=None):
    """Per record entry, the warps (of WARP consecutive rays) that took a
    step, counted (of the given kind only, when given)."""
    out = []
    for lanes, _, leaf in record:
        w = lanes // WARP
        if kind is not None:
            w = w[leaf == kind]
        out.append(torch.unique(w))
    return out


def simd_efficiency(record) -> float:
    """Steps taken over the lane slots of the warp steps that took them,
    sum(steps(ray)) / (32 * warp steps), from a `steps` or `trace`
    record. For traverse_wavefront's record (one thread a ray in launch
    order) the warp steps are each warp's longest walk, summed."""
    steps = sum(lanes.numel() for lanes, _, _ in record)
    warp = sum(w.numel() for w in _warp_steps(record))
    return steps / max(WARP * warp, 1)


def mixed_share(record) -> float:
    """The share of warp steps whose lanes read both kinds of row (they
    run both the slab and the leaf test), from a `steps` or `trace`
    record."""
    both = sum(int(torch.isin(a, b).sum()) for a, b in
               zip(_warp_steps(record, False), _warp_steps(record, True)))
    warp = sum(w.numel() for w in _warp_steps(record))
    return both / max(warp, 1)
