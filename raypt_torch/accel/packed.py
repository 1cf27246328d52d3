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
rays' order) for the CPU tests and the design sweep; `slot_table` and
`traverse_slots` model the other layouts' kernels' split tables and
walks (`csrc/packed_layouts.cuh`).

The table's other layouts (`raypt/accel/packed.py:170-849`): the
cherry-merged 32-wide table (`Packed2LBVH`, `pack_cherries`), the
16-wide lookahead table (`PackedLALBVH`, `pack_lookahead`) and the
quad-collapsed 64-wide table (`Packed4LBVH`, `pack_quads`, with plain or
lookahead internal rows), with their plain walks
(`traverse_wavefront2`, `_la`, `4`) and the compacting walk
(`traverse_wavefront_compact`) over any of the four tables; their
kernels are `csrc/packed_layouts.cu`. `LAYOUTS` holds each layout's
table type, row width, step and columns, by the name its table reports
(`layout_of`); `walk_layout` is the plain walk of every table,
traverse_wavefront's and the other three walks' loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..core.math3d import BIG, EPS, cross, dot
from ..core.types import TensorTree

ROW = 16
ROW2 = 32
ROW4 = 64


@dataclasses.dataclass
class PackedLBVH(TensorTree):
    rows: torch.Tensor   # (2N-1, 16) f32
    layout = "one"       # its name in LAYOUTS

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
    empty (min / max propagate NaN, so a NaN misses). Boxes (..., 3),
    the axes last."""
    tn1 = (bmin - o) * iv
    tn2 = (bmax - o) * iv
    lo = torch.minimum(tn1, tn2)
    hi = torch.maximum(tn1, tn2)
    tnear = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tfar = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    nonempty = ((bmin[..., 0] <= bmax[..., 0]) & (bmin[..., 1] <= bmax[..., 1])
                & (bmin[..., 2] <= bmax[..., 2]))
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
    t_best; then skip). The walk ends at node -1 (`walk_layout`, the
    walk of every table).

    `unroll` is the JAX loop's steps per iteration and changes no
    result. `max_iters`, when given, cuts each ray's walk after
    max_iters * unroll steps, as the JAX loop does; no finder passes it.
    `visits` and `steps`: walk_layout's records."""
    return walk_layout(_expect(pbvh, PackedLBVH), ro, rd, t0, active,
                       None if max_iters is None else max_iters * unroll,
                       visits, steps)


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
    inner = _split_inner(bits, is_leaf, 12, 13)
    leaves = torch.zeros((rows.shape[0], 12), dtype=torch.int32,
                         device=rows.device)
    leaves[:, 0:9] = bits[:, 0:9]
    leaves[:, 9] = bits[:, 12]
    leaves[:, 10] = _codes(bits[:, 13], is_leaf)
    leaves[~is_leaf] = 0
    return inner.view(torch.float32), leaves.view(torch.float32)


def _codes(s, is_leaf, scale=1, inner=1):
    """The split codes of links s (int32) into rows of kind is_leaf: -1
    for s < 0, inner * s for an internal row (its first 32-byte row
    where an internal row has `inner` of them), scale * s | LEAF_BIT for
    a leaf row (its first entry where a leaf row has `scale` of them)."""
    ok = s >= 0
    leaf = is_leaf[s.clamp(0, is_leaf.shape[0] - 1).long()] & ok
    return torch.where(ok, torch.where(leaf, s * scale | LEAF_BIT, s * inner),
                       torch.full_like(s, -1))


def _split_inner(bits, is_leaf, left, skip, scale=1, right=None):
    """A split table's internal rows from the rows' bits, zeros on leaf
    rows, links as codes (_codes with `scale`) from the columns left,
    skip and, for lookahead rows, right: (N, 8) int32 [bmin, bmax,
    code(left), code(skip)], or with `right` (N, 16), two 32-byte rows of
    that form, sectors A = [lmin, lmax, code(left), 2 n + 1] and B =
    [rmin, rmax, code(right), code(skip)], an internal row s's code 2 s
    (its sector A)."""
    n = bits.shape[0]
    inner = torch.zeros((n, 8 if right is None else 16), dtype=torch.int32,
                        device=bits.device)
    sectors = 1 if right is None else 2   # 32-byte rows an internal row

    def codes(col):
        return _codes(bits[:, col], is_leaf, scale, sectors)
    inner[:, 0:6] = bits[:, 0:6]
    inner[:, 6] = codes(left)
    if right is None:
        inner[:, 7] = codes(skip)
    else:
        inner[:, 7] = 2 * torch.arange(n, dtype=torch.int32,
                                       device=bits.device) + 1
        inner[:, 8:14] = bits[:, 6:12]
        inner[:, 14] = codes(right)
        inner[:, 15] = codes(skip)
    inner[is_leaf] = 0
    return inner


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


class SlotLayout(NamedTuple):
    """A layout whose kernel walks a split table of triangle slots
    (csrc/packed_layouts.cuh): its slots a leaf row, the columns of an
    internal row's left and skip links and, where its internal rows
    hold both children's boxes (lookahead), of the right link."""
    slots: int
    left: int
    skip: int
    right: int | None = None


# every layout but the one-triangle table's (packed_walk.cuh's split_table)
SLOT_LAYOUTS = {"cherry": SlotLayout(2, 18, 20),
                "lookahead": SlotLayout(1, 12, 13, 15),
                "quad": SlotLayout(4, 48, 49),
                "quad_la": SlotLayout(4, 48, 49, 51)}
SLOT = 12   # floats a slot entry: p0, e1, e2, face, next code, flag


def slot_counts(pbvh) -> torch.Tensor:
    """(N,) int32: the slots the kernel tests of each leaf row of a
    table of SLOT_LAYOUTS, one past its last slot that is not empty
    (empty: face id -1 and e1 = 0, bits of either sign; no ray hits it),
    the lookahead table's one triangle always; 0 on internal rows."""
    name = layout_of(pbvh)
    lay, k = LAYOUTS[name], SLOT_LAYOUTS[name].slots
    bits = pbvh.rows.contiguous().view(torch.int32)
    n = bits.shape[0]
    e1 = bits[:, :9 * k].reshape(n, k, 9)[..., 3:6]
    empty = (bits[:, lay.faces] == -1) & ((e1 & 0x7FFFFFFF) == 0).all(dim=2)
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=bits.device)
    count = torch.where(empty, 0, slot).amax(dim=1) if k > 1 else \
        torch.ones(n, dtype=torch.int32, device=bits.device)
    return torch.where(pbvh.rows[:, lay.leaf_col] > 0.5, count, 0)


def slot_table(pbvh):
    """csrc/packed_layouts.cuh's split table of a table of SLOT_LAYOUTS
    (its slot_build_kernel, the kept designs'): (inner (N, 8), or (N,
    16) with lookahead rows, leaves (N, 12 * slots)) f32, the rows'
    floats copied bit for bit, links as codes (_codes: a leaf row s's is
    its first slot entry, slots * s | LEAF_BIT; an internal row s's s,
    or on a lookahead table 2 s, its sector A).
      inner:  [bmin, bmax, code(left), code(skip)]         (internal rows)
              or [lmin, lmax, code(left), 2 n + 1 | rmin, rmax,
              code(right), code(skip)]                  (lookahead rows)
      leaves: entry slots * n + k at [12 k : 12 k + 12] of row n =
              [p0, e1, e2, face, next, flag] of the row's triangle k
    for k below max(count, 1) (slot_counts): next, the code of entry
    k + 1, or on the last entry the code of the row's skip; flag, 0, or
    on the last entry 2 where an empty slot follows it, else 1 (0 on the
    lookahead table's one entry: split_table's leaf row). Entries past
    those and the rows of the other kind are zeros here (the kernel
    leaves them unwritten; no walk reads them)."""
    name = layout_of(pbvh)
    lay, sl = LAYOUTS[name], SLOT_LAYOUTS[name]
    k = sl.slots
    bits = pbvh.rows.contiguous().view(torch.int32)
    n = bits.shape[0]
    is_leaf = pbvh.rows[:, lay.leaf_col] > 0.5
    inner = _split_inner(bits, is_leaf, sl.left, sl.skip, k, sl.right)
    count = slot_counts(pbvh)
    written = count.clamp(min=1)[:, None]
    slot = torch.arange(k, dtype=torch.int32, device=bits.device)[None]
    last = slot + 1 == written
    entry = k * torch.arange(n, dtype=torch.int32, device=bits.device)[:, None]
    leaves = torch.zeros((n, k, SLOT), dtype=torch.int32, device=bits.device)
    leaves[..., 0:9] = bits[:, :9 * k].reshape(n, k, 9)
    leaves[..., 9] = bits[:, lay.faces]
    sectors = 1 if sl.right is None else 2
    leaves[..., 10] = torch.where(
        last, _codes(bits[:, sl.skip], is_leaf, k, sectors)[:, None],
        (entry + slot + 1) | LEAF_BIT)
    if k > 1:
        leaves[..., 11] = torch.where(
            last, torch.where(count < k, 2, 1)[:, None], 0).to(torch.int32)
    leaves[slot.expand(n, k) >= written] = 0
    leaves[~is_leaf] = 0
    return inner.view(torch.float32), leaves.view(torch.float32).reshape(
        n, k * SLOT)


def slot_steps(table, c, si, sl, ro, rd, inv, t_best, face, m, f,
               right=None):
    """One step of the rays `si` on internal rows and `sl` on slot
    entries over a slot table (slot_table's pair), in place: their codes
    c, each ray's pick of its row so far (m, f: +inf and -1 between
    rows), and t_best and face where a row's pick is taken. An internal
    step is the slab test of a 32-byte row (an internal row, or a
    lookahead row's sector: A's left box, whose miss goes to sector B,
    the right box; `right` gets the count of B's tests appended). An
    entry's step tests its triangle: on the lookahead table's one entry,
    taken when hit strictly nearer (split_steps' leaf step); else a miss
    counts as BIG into the pick, taken when strictly less, and on the
    row's last entry the first empty slot's miss (t BIG, face -1) wins
    where an empty slot follows (flag 2) and BIG is less, the pick is
    taken when strictly nearer than t_best and is reset: the plain
    step's result, a slot at a time."""
    inner, leaves = table
    if right is not None and inner.shape[1] == 16:
        right.append(int((c[si] & 1).sum()))
    split_steps((inner.reshape(-1, 8), None), c, si, si[:0], ro, rd, inv,
                t_best, face)
    if not sl.numel():
        return
    if leaves.shape[1] == SLOT:
        split_steps((None, leaves), c, sl[:0], sl, ro, rd, inv, t_best, face)
        return
    row = leaves.reshape(-1, SLOT)[(c[sl] & ~LEAF_BIT).long()]
    bits = row.view(torch.int32)
    hit, t = leaf_hit(row[:, 0:3], row[:, 3:6], row[:, 6:9], ro[sl], rd[sl],
                      t_best[sl])
    tk = torch.where(hit, t, torch.full_like(t, BIG))
    ms, fs = m[sl], f[sl]
    better = tk < ms
    ms = torch.where(better, tk, ms)
    fs = torch.where(better, bits[:, 9], fs)
    flag = bits[:, 11]
    empty_wins = (flag == 2) & (BIG < ms)
    ms = torch.where(empty_wins, torch.full_like(ms, BIG), ms)
    fs = torch.where(empty_wins, torch.full_like(fs, -1), fs)
    take = (flag != 0) & (ms < t_best[sl])
    t_best[sl] = torch.where(take, ms, t_best[sl])
    face[sl] = torch.where(take, fs, face[sl])
    m[sl] = torch.where(flag != 0, torch.full_like(ms, float("inf")), ms)
    f[sl] = torch.where(flag != 0, torch.full_like(fs, -1), fs)
    c[sl] = bits[:, 10]


@torch.no_grad()
def traverse_slots(pbvh, ro: torch.Tensor, rd: torch.Tensor,
                   t0: torch.Tensor, active: torch.Tensor,
                   right: list | None = None):
    """The kernels of csrc/packed_layouts.cu: walk_layout's contract and
    result over slot_table's split table, every iteration each ray whose
    walk goes on taking one step of its own code's kind (slot_steps: the
    slab test of an internal row or of a lookahead row's sector, or one
    slot's triangle test), as a thread of the kernel does. Each ray
    reads the rows walk_layout reads in the same order, each leaf row a
    slot at a time, so the result is the same bit for bit. `right`: a
    list that gets each step's right-box tests."""
    name = layout_of(pbvh)
    table = slot_table(pbvh)
    # row 0's code: its first entry, 0, when it is a leaf row
    root = LEAF_BIT if bool(pbvh.rows[0, LAYOUTS[name].leaf_col] > 0.5) else 0
    c = torch.where(active, root, -1).to(torch.int32)
    inv = safe_reciprocal(rd)
    t_best = t0.clone()
    face = torch.full((ro.shape[0],), -1, dtype=torch.int32, device=ro.device)
    m = torch.full_like(t_best, float("inf"))
    f = torch.full_like(face, -1)
    while bool((c != -1).any()):
        slot_steps(table, c, torch.nonzero(c >= 0).flatten(),
                   torch.nonzero(c < -1).flatten(), ro, rd, inv, t_best, face,
                   m, f, right)
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


# ---------------------------------------------------------------------------
# The table's other layouts (raypt/accel/packed.py:170-849)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Packed2LBVH(TensorTree):
    """The cherry-merged table: every internal node whose two children
    are both leaves is rewritten in place as a two-triangle leaf row. Its
    children stay in the table, unreachable: no renumbering, skip links
    unchanged.

    Row layout (32 x f32):
      internal: [0:3]=bmin [3:6]=bmax [18]=left [20]=skip [21]=0
      leaf:     [0:3]=p0a [3:6]=e1a [6:9]=e2a [9:12]=p0b [12:15]=e1b
                [15:18]=e2b [18]=face_a [19]=face_b [20]=skip [21]=1
    A singleton leaf keeps a degenerate second triangle (e1b = e2b = 0,
    face_b = -1), never hit."""
    rows: torch.Tensor   # (2N-1, 32) f32
    layout = "cherry"

    @property
    def num_nodes(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass
class PackedLALBVH(TensorTree):
    """The 16-wide lookahead table: an internal row carries both
    children's boxes and all three links, so one row read culls both
    children. A ray arriving at a right child through a skip link after
    its parent rejected that child's box misses it again: the children's
    boxes lie inside the parent's.

    Row layout (16 x f32):
      internal: [0:3]=lmin [3:6]=lmax [6:9]=rmin [9:12]=rmax
                [12]=left [13]=skip [14]=0 [15]=right
      leaf:     [0:3]=p0 [3:6]=e1 [6:9]=e2 [12]=face [13]=skip [14]=1"""
    rows: torch.Tensor   # (2N-1, 16) f32
    layout = "lookahead"

    @property
    def num_nodes(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass
class Packed4LBVH(TensorTree):
    """The quad-collapsed table: every node whose subtree holds at most
    4 triangles is rewritten in place as a leaf row carrying all of them
    (internal nodes too, whose descendants stay in the table,
    unreachable).

    Row layout (64 x f32):
      internal: [0:3]=bmin [3:6]=bmax [48]=left [49]=skip [50]=0
      leaf:     [9k:9k+9] = (p0, e1, e2) of triangle k, k in 0..3;
                [44:48] = face ids (-1 = empty slot: zero edges)
                [49]=skip [50]=1
      [51] = right child on every row.
    With lookahead, internal rows carry both children's boxes instead
    ([0:3]=lmin [3:6]=lmax [6:9]=rmin [9:12]=rmax)."""
    rows: torch.Tensor   # (2N-1, 64) f32
    lookahead: bool = False

    @property
    def layout(self) -> str:
        return "quad_la" if self.lookahead else "quad"

    @property
    def num_nodes(self) -> int:
        return self.rows.shape[0]


def _tree_inputs(bvh, positions, faces, face_valid):
    """The tree's tensors and the mesh on the positions' device."""
    dev = positions.device
    return (bvh.tensors(dev), positions.detach(), faces.to(dev, torch.int64),
            face_valid.to(dev))


def _tris(positions, faces, face_valid, fid):
    """(p0, e1, e2) of the faces fid (any shape), edges zero where the
    face is invalid."""
    f = faces[fid]
    ok = face_valid[fid][..., None]
    p0 = positions[f[..., 0]]
    zero = torch.zeros_like(p0)
    return (p0, torch.where(ok, positions[f[..., 1]] - p0, zero),
            torch.where(ok, positions[f[..., 2]] - p0, zero))


@torch.no_grad()
def pack_cherries(bvh, positions: torch.Tensor, faces: torch.Tensor,
                  face_valid: torch.Tensor) -> Packed2LBVH:
    """The cherry-merged table of an LBVH or its `LBVHTensors`, on the
    positions' device (`pack`'s contract). A node's right child is the
    skip link of its left child."""
    tree, positions, faces, face_valid = _tree_inputs(bvh, positions, faces,
                                                      face_valid)
    n = tree.num_leaves
    ni = n - 1
    total = tree.num_nodes
    lf, skip = tree.leaf_face, tree.skip
    left = tree.left[:ni]
    right = skip[left.clamp(0, total - 1)]
    cherry = (left >= ni) & (right >= ni)
    fa = lf[(left - ni).clamp(0, n - 1)]
    fb = lf[(right - ni).clamp(0, n - 1)]
    p0a, e1a, e2a = _tris(positions, faces, face_valid, fa)
    p0b, e1b, e2b = _tris(positions, faces, face_valid, fb)
    c = cherry[:, None]
    zero = torch.zeros_like(p0a)
    rows = torch.zeros((total, ROW2), dtype=torch.float32,
                       device=positions.device)
    rows[:ni, 0:3] = torch.where(c, p0a, tree.bmin[:ni])
    rows[:ni, 3:6] = torch.where(c, e1a, tree.bmax[:ni])
    rows[:ni, 6:9] = torch.where(c, e2a, zero)
    rows[:ni, 9:12] = torch.where(c, p0b, zero)
    rows[:ni, 12:15] = torch.where(c, e1b, zero)
    rows[:ni, 15:18] = torch.where(c, e2b, zero)
    rows[:ni, 18] = _itof(torch.where(cherry, fa, left))
    rows[:ni, 19] = _itof(torch.where(cherry, fb, -1))
    rows[:ni, 20] = _itof(skip[:ni])
    rows[:ni, 21] = cherry.to(torch.float32)
    # singleton leaf rows, unreachable under a cherry but kept in place
    p0, e1, e2 = _tris(positions, faces, face_valid, lf)
    rows[ni:, 0:3] = p0
    rows[ni:, 3:6] = e1
    rows[ni:, 6:9] = e2
    rows[ni:, 18] = _itof(lf)
    rows[ni:, 19] = _itof(torch.full_like(lf, -1))
    rows[ni:, 20] = _itof(skip[ni:])
    rows[ni:, 21] = 1.0
    return Packed2LBVH(rows=rows)


@torch.no_grad()
def pack_lookahead(bvh, positions: torch.Tensor, faces: torch.Tensor,
                   face_valid: torch.Tensor) -> PackedLALBVH:
    """The 16-wide lookahead table of an LBVH or its `LBVHTensors`, on
    the positions' device."""
    tree, positions, faces, face_valid = _tree_inputs(bvh, positions, faces,
                                                      face_valid)
    n = tree.num_leaves
    ni = n - 1
    total = tree.num_nodes
    lc = tree.left[:ni].clamp(0, total - 1)
    rc = tree.skip[lc].clamp(0, total - 1)
    rows = torch.zeros((total, ROW), dtype=torch.float32,
                       device=positions.device)
    rows[:ni, 0:3] = tree.bmin[lc]
    rows[:ni, 3:6] = tree.bmax[lc]
    rows[:ni, 6:9] = tree.bmin[rc]
    rows[:ni, 9:12] = tree.bmax[rc]
    rows[:ni, 12] = _itof(tree.left[:ni])
    rows[:ni, 13] = _itof(tree.skip[:ni])
    rows[:ni, 15] = _itof(rc)
    lf = tree.leaf_face
    p0, e1, e2 = _tris(positions, faces, face_valid, lf)
    rows[ni:, 0:3] = p0
    rows[ni:, 3:6] = e1
    rows[ni:, 6:9] = e2
    rows[ni:, 12] = _itof(lf)
    rows[ni:, 13] = _itof(tree.skip[ni:])
    rows[ni:, 14] = 1.0
    return PackedLALBVH(rows=rows)


def _subtree_ranges(bvh):
    """(cnt, first) int32: each node's subtree leaf count and first leaf
    rank (a subtree's leaves have contiguous ranks), by exactly 64
    bottom-up rounds, as the JAX loop does: a deeper tree gets the same
    wrong counts in both packages. bvh: an LBVH or `LBVHTensors`; the
    result lies on the latter's device (the host for an LBVH)."""
    tree = bvh.tensors(bvh.left.device if isinstance(bvh.left, torch.Tensor)
                       else "cpu")
    n = tree.num_leaves
    ni = n - 1
    total = tree.num_nodes
    dev = tree.left.device
    lc = tree.left[:ni].clamp(0, total - 1)
    rc = tree.skip[lc].clamp(0, total - 1)
    cnt = torch.cat([torch.zeros(ni, dtype=torch.int32, device=dev),
                     torch.ones(n, dtype=torch.int32, device=dev)])
    first = torch.cat([torch.zeros(ni, dtype=torch.int32, device=dev),
                       torch.arange(n, dtype=torch.int32, device=dev)])
    for _ in range(64):
        cnt[:ni] = cnt[lc] + cnt[rc]
    for _ in range(64):
        first[:ni] = first[lc]
    return cnt, first


@torch.no_grad()
def pack_quads(bvh, positions: torch.Tensor, faces: torch.Tensor,
               face_valid: torch.Tensor,
               lookahead: bool = False) -> Packed4LBVH:
    """The quad-collapsed 64-wide table of an LBVH or its `LBVHTensors`,
    on the positions' device, with lookahead internal rows when
    `lookahead`."""
    k = 4
    tree, positions, faces, face_valid = _tree_inputs(bvh, positions, faces,
                                                      face_valid)
    dev = positions.device
    n = tree.num_leaves
    total = tree.num_nodes
    cnt, first = _subtree_ranges(tree)
    is_quad = cnt <= k            # every original leaf (cnt 1) included
    slot = torch.arange(k, device=dev)
    fids = tree.leaf_face[(first[:, None].long() + slot).clamp(0, n - 1)]
    slot_ok = slot[None] < cnt[:, None]
    ok = slot_ok & face_valid[fids]
    fids = torch.where(slot_ok, fids, -1)
    f = faces[fids.clamp(min=0)]                         # (total, k, 3)
    p0 = positions[f[..., 0]]
    zero = torch.zeros_like(p0)
    e1 = torch.where(ok[..., None], positions[f[..., 1]] - p0, zero)
    e2 = torch.where(ok[..., None], positions[f[..., 2]] - p0, zero)
    tri36 = torch.cat([p0, e1, e2], dim=-1).reshape(total, 9 * k)
    lc = tree.left.clamp(0, total - 1)
    rc = tree.skip[lc].clamp(0, total - 1)
    box36 = torch.zeros((total, 9 * k), dtype=torch.float32, device=dev)
    if lookahead:
        box36[:, 0:3] = tree.bmin[lc]
        box36[:, 3:6] = tree.bmax[lc]
        box36[:, 6:9] = tree.bmin[rc]
        box36[:, 9:12] = tree.bmax[rc]
    else:
        box36[:, 0:3] = tree.bmin
        box36[:, 3:6] = tree.bmax
    rows = torch.zeros((total, ROW4), dtype=torch.float32, device=dev)
    rows[:, 0:36] = torch.where(is_quad[:, None], tri36, box36)
    rows[:, 44:48] = _itof(fids)
    rows[:, 48] = _itof(tree.left)
    rows[:, 49] = _itof(tree.skip)
    rows[:, 50] = is_quad.to(torch.float32)
    rows[:, 51] = _itof(rc)
    return Packed4LBVH(rows=rows, lookahead=lookahead)


def _step2(r, is_leaf, o, d, iv, tb, fc):
    """A step over cherry rows (L, 32): the slab test of an internal
    row; a leaf row's two Moller-Trumbore tests, b replacing a only when
    strictly nearer (a miss counts as BIG), the nearer taken when
    strictly nearer than tb. Both kinds' tests run on every row, as in
    the JAX package, and the row's kind selects (on the card, fewer ops
    over the whole wavefront beat computing each kind on its own rays)."""
    hit_box = slab_hit(r[:, 0:3], r[:, 3:6], o, iv, tb)
    tris = r[:, 0:18].reshape(-1, 2, 9)          # a and b, tested as one
    hk, tk = leaf_hit(tris[..., 0:3], tris[..., 3:6], tris[..., 6:9],
                      o[:, None], d[:, None], tb[:, None])
    tk = torch.where(hk, tk, torch.full_like(tk, BIG))
    ta, tb2 = tk[:, 0], tk[:, 1]
    b_wins = tb2 < ta
    tmin = torch.where(b_wins, tb2, ta)
    fid = torch.where(b_wins, ftoi(r[:, 19]), ftoi(r[:, 18]))
    take = is_leaf & (tmin < tb)
    link, nxt_skip = ftoi(r[:, 18]), ftoi(r[:, 20])
    return (torch.where(take, tmin, tb), torch.where(take, fid, fc),
            torch.where(is_leaf | ~hit_box, nxt_skip, link))


def _child_link(r, left, right, skip, o, iv, tb):
    """The link a lookahead row's child boxes ([0:6] left, [6:12] right)
    send a ray to: left on a hit, else right on a hit, else skip (the
    two boxes tested as one)."""
    boxes = r[:, 0:12].reshape(-1, 2, 6)
    hit = slab_hit(boxes[..., 0:3], boxes[..., 3:6], o[:, None], iv[:, None],
                   tb[:, None])
    return torch.where(hit[:, 0], left, torch.where(hit[:, 1], right, skip))


def _step_la(r, is_leaf, o, d, iv, tb, fc):
    """A step over lookahead rows (L, 16): a leaf row's test first; then,
    with the t_best after it, an internal row's two child boxes."""
    hit, t = leaf_hit(r[:, 0:3], r[:, 3:6], r[:, 6:9], o, d, tb)
    take = is_leaf & hit
    tb = torch.where(take, t, tb)
    fc = torch.where(take, ftoi(r[:, 12]), fc)
    nxt_skip = ftoi(r[:, 13])
    nxt = _child_link(r, ftoi(r[:, 12]), ftoi(r[:, 15]), nxt_skip, o, iv, tb)
    return tb, fc, torch.where(is_leaf, nxt_skip, nxt)


def _quad_step(lookahead: bool):
    """A step over quad rows (L, 64): a leaf row's four tests, the lowest
    slot of the least t winning (argmin; a miss counts as BIG), taken
    when strictly nearer than tb; then, with the t_best after it, an
    internal row's box (or its two child boxes, with lookahead)."""
    def step(r, is_leaf, o, d, iv, tb, fc):
        tris = r[:, 0:36].reshape(-1, 4, 9)
        hk, tk = leaf_hit(tris[..., 0:3], tris[..., 3:6], tris[..., 6:9],
                          o[:, None], d[:, None], tb[:, None])
        tk = torch.where(hk, tk, torch.full_like(tk, BIG))
        kbest = torch.argmin(tk, dim=1, keepdim=True)
        tmin = tk.gather(1, kbest)[:, 0]
        fid = ftoi(r[:, 44:48]).gather(1, kbest)[:, 0]
        take = is_leaf & (tmin < tb)
        tb = torch.where(take, tmin, tb)
        fc = torch.where(take, fid, fc)
        left, nxt_skip = ftoi(r[:, 48]), ftoi(r[:, 49])
        if lookahead:
            nxt = _child_link(r, left, ftoi(r[:, 51]), nxt_skip, o, iv, tb)
        else:
            nxt = torch.where(slab_hit(r[:, 0:3], r[:, 3:6], o, iv, tb), left,
                              nxt_skip)
        return tb, fc, torch.where(is_leaf, nxt_skip, nxt)
    return step


def _step1(r, is_leaf, o, d, iv, tb, fc):
    """A step over one-triangle rows (L, 16): the slab test of an
    internal row (hit -> left child, else skip), the Moller-Trumbore test
    of a leaf row (taken when strictly nearer; then skip)."""
    hit_box = slab_hit(r[:, 0:3], r[:, 3:6], o, iv, tb)
    tri_hit, t = leaf_hit(r[:, 0:3], r[:, 3:6], r[:, 6:9], o, d, tb)
    take = is_leaf & tri_hit
    link, nxt_skip = ftoi(r[:, 12]), ftoi(r[:, 13])
    return (torch.where(take, t, tb), torch.where(take, link, fc),
            torch.where(is_leaf | ~hit_box, nxt_skip, link))


class Layout(NamedTuple):
    """A packed table's layout: its table type, its rows' width, its
    walk's step, step(r, is_leaf, o, d, iv, tb, fc) -> (tb, fc, next
    node) over the rows r the rays read (`_make_step` of the JAX
    package), the column of its rows' leaf flag, the columns of a leaf
    row's face ids (-1: an empty slot) and, where an internal row holds
    both children's boxes (lookahead), the column of its left link."""
    table: type
    width: int
    step: Callable
    leaf_col: int
    faces: slice
    lookahead_left: int | None = None


# every layout, by the name its table reports (`layout_of`)
LAYOUTS = {"one": Layout(PackedLBVH, ROW, _step1, 14, slice(12, 13)),
           "cherry": Layout(Packed2LBVH, ROW2, _step2, 21, slice(18, 20)),
           "lookahead": Layout(PackedLALBVH, ROW, _step_la, 14,
                               slice(12, 13), 12),
           "quad": Layout(Packed4LBVH, ROW4, _quad_step(False), 50,
                          slice(44, 48)),
           "quad_la": Layout(Packed4LBVH, ROW4, _quad_step(True), 50,
                             slice(44, 48), 48)}
PACKED_TABLES = tuple(dict.fromkeys(lay.table for lay in LAYOUTS.values()))


def layout_of(pbvh) -> str:
    """The name of a packed table's layout in LAYOUTS; TypeError for
    anything else."""
    if not isinstance(pbvh, PACKED_TABLES):
        raise TypeError(f"not a packed table: {type(pbvh).__name__}")
    return pbvh.layout


def _advance(lay: Layout, rows, live, node, t_best, face, o, d, iv,
             visits=None, steps=None):
    """One step of the rays `live` (indices of rays still walking), in
    place on node, t_best and face; returns those still walking after
    it. `visits`, `steps`: walk_layout's records."""
    r = rows[node[live].long()]
    is_leaf = r[:, lay.leaf_col] > 0.5
    if visits is not None:
        visits.append((live.numel(), int(is_leaf.sum())))
    if steps is not None:
        steps.append((live, node[live], is_leaf))
    t_best[live], face[live], nxt = lay.step(
        r, is_leaf, o[live], d[live], iv[live], t_best[live], face[live])
    node[live] = nxt
    return live[nxt >= 0]


@torch.no_grad()
def walk_layout(pbvh, ro, rd, t0, active, max_steps: int | None = None,
                visits: list | None = None, steps: list | None = None):
    """The plain skip-link walk of any of the four tables, by its layout
    (traverse_wavefront's contract and result): each step of the rays
    still walking reads their rows and takes the layout's step. Only
    those rays are computed each step; rays are independent, so that
    changes no result. `max_steps`, when given, cuts each ray's walk
    after that many steps. With a `visits` list, each step appends (rows
    read, leaf rows read), for a kernel's bound; with a `steps` list,
    (the indices of the rays that took the step (int64), the rows they
    read (int32), which of them sat on a leaf row (bool)): a record for
    `simd_efficiency` and `mixed_share`, the schedule of one thread a ray
    in launch order, and for the operations the walk needs."""
    lay = LAYOUTS[layout_of(pbvh)]
    inv = safe_reciprocal(rd)
    node = torch.where(active, 0, -1).to(torch.int32)
    t_best = t0.clone()
    face = torch.full_like(node, -1)
    live = torch.nonzero(node >= 0).flatten()
    step = 0
    while live.numel() and (max_steps is None or step < max_steps):
        live = _advance(lay, pbvh.rows, live, node, t_best, face, ro, rd, inv,
                        visits, steps)
        step += 1
    return t_best, face


def _expect(pbvh, kind):
    if not isinstance(pbvh, kind):
        raise TypeError(f"expected a {kind.__name__}, got "
                        f"{type(pbvh).__name__}")
    return pbvh


def traverse_wavefront2(pbvh: Packed2LBVH, ro, rd, t0, active):
    """The skip-link walk of the cherry table (traverse_wavefront's
    contract; the JAX walk's `unroll` schedules its loop only)."""
    return walk_layout(_expect(pbvh, Packed2LBVH), ro, rd, t0, active)


def traverse_wavefront_la(pbvh: PackedLALBVH, ro, rd, t0, active):
    """The skip-link walk of the lookahead table, as traverse_wavefront2."""
    return walk_layout(_expect(pbvh, PackedLALBVH), ro, rd, t0, active)


def traverse_wavefront4(pbvh: Packed4LBVH, ro, rd, t0, active):
    """The skip-link walk of the quad table (either kind of internal
    row), as traverse_wavefront2."""
    return walk_layout(_expect(pbvh, Packed4LBVH), ro, rd, t0, active)


PHASE_STEPS = (24, 24, 24, 32)
MIN_PREFIX = 16384


@torch.no_grad()
def traverse_wavefront_compact(pbvh, ro, rd, t0, active,
                               phase_steps=PHASE_STEPS,
                               min_prefix: int = MIN_PREFIX):
    """The compacting walk over any of the four tables (traversal_mode
    "compact" / "unrolled"), traverse_wavefront's contract and result:
    phase k takes phase_steps[k] steps of the rays in the first `prefix`
    of the wavefront; before every phase but the first, the rays still
    walking in the first 2 * prefix move to its front (a stable
    partition; `idx` keeps each slot's ray) and after every phase the
    prefix halves while it stays at least min_prefix; then the prefix,
    and last the whole wavefront, walk until no ray is left, and the
    results go back to their rays through idx. Each ray walks to its end
    whatever the schedule, so the result is traverse_wavefront's. The
    JAX package's `unroll` and its "unrolled" mode only schedule its
    loops, and change no result: no walk here takes them."""
    lay = LAYOUTS[layout_of(pbvh)]
    n = ro.shape[0]
    node = torch.where(active, 0, -1).to(torch.int32)
    t_best = t0.clone()
    face = torch.full_like(node, -1)
    idx = torch.arange(n, device=ro.device)
    o, d, iv = ro.clone(), rd.clone(), safe_reciprocal(rd)

    def run(prefix, steps=None):
        live = torch.nonzero(node[:prefix] >= 0).flatten()
        k = 0
        while live.numel() and (steps is None or k < steps):
            live = _advance(lay, pbvh.rows, live, node, t_best, face, o, d,
                            iv)
            k += 1

    prefix = n
    for k in phase_steps:
        if prefix < n:
            perm = torch.argsort((node[:2 * prefix] < 0).to(torch.int32),
                                 stable=True)
            for a in (node, t_best, face, idx, o, d, iv):
                a[:2 * prefix] = a[:2 * prefix][perm]
        run(prefix, k)
        if prefix // 2 >= min_prefix:
            prefix //= 2
    run(prefix)
    run(n)
    out_t = torch.empty_like(t_best)
    out_f = torch.empty_like(face)
    out_t[idx] = t_best
    out_f[idx] = face
    return out_t, out_f
