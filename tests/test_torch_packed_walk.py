"""The plain models of the packed walk's kernel (`csrc/packed_walk.cu`)
against the plain walk and the JAX package: the split table
(`accel.packed.split_table`), the kernel's walk over it
(`traverse_split`) and the while-while designs' 32-lane walk
(`kernels.sweep.traverse_while_while`), the kernel's ray order
(`octant_order`), the `steps` record of `traverse_wavefront` and the
schedule measures read from it (`simd_efficiency`, `mixed_share`). A
toy soup of triangles, built by the port's `lbvh.build` and packed on
the CPU; the JAX walk runs on the same rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import packed as jpacked

from raypt_torch.accel import lbvh
from raypt_torch.accel.packed import (LEAF_BIT, PackedLBVH, mixed_share, pack,
                                      simd_efficiency, split_table,
                                      traverse_split, traverse_wavefront)
from raypt_torch.core.math3d import BIG
from raypt_torch.kernels import sweep

torch.set_num_threads(2)

FACES = 200
SLOTS = 256
RAYS = 1024
COPIES = 8
# the plain walk's t against JAX's: XLA sums a dot's three products in
# its own order (test_torch_packed's tolerance; faces equal)
T_RTOL = 1e-6
KINDS = ["plain", "nan", "signed_zero", "in_plane", "seeds"]
_jax_walk = jax.jit(jpacked.traverse_wavefront)


def _rays_kind(kind, o, d, t0, a, pb):
    """Edge cases written over a block of the rays: NaN origins and
    directions, direction components of exactly +0 and -0, rays in the
    plane of the triangle they hit travelling along its edge e1, and
    seeds just above and just below a ray's hit. Returns the rays and
    the mask of those whose JAX result is compared: not the in-plane and
    seeded rays, whose outcome turns on the last bit of t or det, where
    XLA's order of a dot's sums differs from the port's."""
    r = o.shape[0]
    jax_too = np.ones(r, bool)
    if kind == "nan":
        o[0, 0] = np.nan
        d[1, 1] = np.nan
        o[2] = np.nan
    elif kind == "signed_zero":
        d[:8] = [(0.0, -0.0, 1.0), (-0.0, 0.0, -1.0), (1.0, 0.0, -0.0),
                 (-0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (-0.0, -0.0, -1.0),
                 (0.0, 1.0, 0.0), (-1.0, -0.0, -0.0)]
        o[:8] = 0.0
    elif kind in ("in_plane", "seeds"):
        t, f = traverse_wavefront(pb, *(torch.from_numpy(x) for x in
                                        (o, d, t0, a)))
        t, f = t.numpy(), f.numpy()
        hit = np.nonzero(f >= 0)[0][:r // 4]
        assert hit.size > 20
        jax_too[hit] = False
        if kind == "seeds":
            t0[hit[::2]] = np.nextafter(t[hit[::2]], np.float32(np.inf))
            t0[hit[1::2]] = np.nextafter(t[hit[1::2]], np.float32(-np.inf))
        else:
            rows = pb.rows.numpy()
            ni = (rows.shape[0] + 1) // 2 - 1
            leaf_of = {int(rows[n, 12:13].view(np.int32)[0]): n
                       for n in range(ni, rows.shape[0])}
            for i in hit:
                row = rows[leaf_of[int(f[i])]]
                e1 = row[3:6] / max(np.linalg.norm(row[3:6]), 1e-30)
                o[i] = row[0:3] + 0.3 * row[3:6] + 0.3 * row[6:9] - e1
                d[i] = e1
    return (o, d, t0, a), jax_too


@pytest.fixture(scope="module")
def soup():
    """FACES random triangles in SLOTS slots, the last COPIES of the real
    ones copies of the first COPIES (an original sorts before its copy),
    and RAYS rays aimed into the soup, a sixth of them dead, a few
    seeded with a sphere-like t0."""
    rng = np.random.default_rng(14)
    centre = rng.uniform(-1, 1, (FACES, 1, 3))
    pos = (centre + 0.25 * rng.normal(size=(FACES, 3, 3))).reshape(-1, 3)
    faces = np.arange(SLOTS * 3).reshape(SLOTS, 3) % (FACES * 3)
    faces[FACES - COPIES:FACES] = faces[:COPIES]
    valid = np.arange(SLOTS) < FACES
    pos_t = torch.from_numpy(pos.astype(np.float32))
    faces_t = torch.from_numpy(faces.astype(np.int32))
    valid_t = torch.from_numpy(valid)
    pb = pack(lbvh.build(pos_t, faces_t, valid_t), pos_t, faces_t, valid_t)
    o = rng.uniform(-2.5, 2.5, (RAYS, 3)).astype(np.float32)
    aim = rng.uniform(-0.8, 0.8, (RAYS, 3))
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t0 = np.full(RAYS, BIG, np.float32)
    t0[::17] = 2.0
    a = rng.uniform(size=RAYS) > 1 / 6
    return pb, (o, d, t0, a)


def _walks(pb, rays, batch, max_iters=None):
    """(plain walk, its steps record), (model walk, its trace) on rays:
    the kernel's walk for batch 0, else the while-while design's."""
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in rays]
    steps, trace = [], []
    plain = traverse_wavefront(pb, *args, max_iters=max_iters, unroll=1,
                               steps=steps)
    if batch:
        model = sweep.traverse_while_while(pb, *args, batch,
                                           max_iters=max_iters, unroll=1,
                                           trace=trace)
    else:
        model = traverse_split(pb, *args, max_iters=max_iters, unroll=1,
                               trace=trace)
    return (plain, steps), (model, trace)


def _visits(record, r):
    """Each ray's rows in the order it read them."""
    seq = [[] for _ in range(r)]
    for lanes, rows, _ in record:
        for i, n in zip(lanes.tolist(), rows.tolist()):
            seq[i].append(n)
    return seq


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("batch", [0, 8, 32])
def test_split_walk_bitwise(soup, kind, batch):
    """The models of the split-table walks (batch 0 the kernel's, each
    ray its own kind of step; 8 and 32 the while-while designs') against
    the plain walk, bitwise, each ray reading the same rows in the same
    order."""
    pb, rays = soup
    rays, _ = _rays_kind(kind, *(x.copy() for x in rays), pb)
    (plain, steps), (model, trace) = _walks(pb, rays, batch)
    assert torch.equal(model[0].view(torch.int32), plain[0].view(torch.int32))
    assert torch.equal(model[1], plain[1])
    assert _visits(trace, RAYS) == _visits(steps, RAYS)
    assert int((plain[1] >= 0).sum()) > 100
    if batch:
        assert mixed_share(trace) == 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_walk_edges_match_jax(soup, kind):
    """The plain walk, which the model equals bitwise, against the JAX
    package's traverse_wavefront on the same rows and rays: faces equal
    and t to T_RTOL, on the rays whose outcome no last bit decides."""
    pb, rays = soup
    rays, jax_too = _rays_kind(kind, *(x.copy() for x in rays), pb)
    pt, pf = traverse_wavefront(pb, *(torch.from_numpy(x) for x in rays))
    jt, jf = _jax_walk(jpacked.PackedLBVH(rows=jnp.asarray(pb.rows.numpy())),
                       *(jnp.asarray(x) for x in rays))
    assert jax_too.sum() >= RAYS * 3 // 4
    assert np.array_equal(pf.numpy()[jax_too], np.asarray(jf)[jax_too])
    np.testing.assert_allclose(pt.numpy()[jax_too], np.asarray(jt)[jax_too],
                               rtol=T_RTOL)


def test_copies_take_the_original(soup):
    """The copied triangles tie their originals; the walk's strict
    t < t_best keeps whichever it reads first, and the kernel's model
    (batch 0) and the while-while design's (batch 8) keep the same face
    as the plain walk on every ray."""
    pb, rays = soup
    for batch in (0, 8):
        (plain, _), (model, _) = _walks(pb, rays, batch)
        f = plain[1].numpy()
        copied = np.isin(f, np.arange(COPIES)) | (f >= FACES - COPIES)
        assert copied.sum() > 0
        assert torch.equal(model[1], plain[1])


@pytest.mark.parametrize("max_iters", [0, 3, 17])
def test_split_walk_max_iters(soup, max_iters):
    """A step cap, counted down a ray at a time as the kernel counts it,
    cuts each ray's walk after the same steps as the plain walk's, in
    the kernel's model (batch 0) and the while-while design's (16)."""
    pb, rays = soup
    for batch in (0, 16):
        (plain, steps), (model, trace) = _walks(pb, rays, batch, max_iters)
        assert torch.equal(model[0].view(torch.int32),
                           plain[0].view(torch.int32))
        assert torch.equal(model[1], plain[1])
        assert _visits(trace, RAYS) == _visits(steps, RAYS)
        assert all(len(s) <= max_iters for s in _visits(steps, RAYS))
    assert max(map(len, _visits(steps, RAYS))) == max_iters


def test_split_table_links(soup):
    """The split table copies each row's floats bit for bit and maps its
    links to codes: -1 past the end, the row number for an internal row,
    the row number with the sign bit for a leaf row."""
    pb, _ = soup
    rows = pb.rows
    inner, leaves = split_table(rows)
    bits = rows.view(torch.int32)
    ib, lb = inner.view(torch.int32), leaves.view(torch.int32)
    is_leaf = rows[:, 14] > 0.5
    assert int(is_leaf.sum()) == SLOTS and not bool(is_leaf[0])

    def decode(code):
        row = code & ~LEAF_BIT
        leaf = (code < -1)
        ok = code != -1
        assert bool((is_leaf[row[ok].long()] == leaf[ok]).all())
        return torch.where(ok, row, torch.full_like(code, -1))

    n_in = ~is_leaf
    assert torch.equal(ib[n_in, 0:6], bits[n_in, 0:6])
    assert torch.equal(decode(ib[n_in, 6]), bits[n_in, 12])
    assert torch.equal(decode(ib[n_in, 7]), bits[n_in, 13])
    assert torch.equal(lb[is_leaf, 0:9], bits[is_leaf, 0:9])
    assert torch.equal(lb[is_leaf, 9], bits[is_leaf, 12])
    assert torch.equal(decode(lb[is_leaf, 10]), bits[is_leaf, 13])
    assert bool((ib[n_in, 6] >= 0).any()) and bool((ib[n_in, 6] < -1).any())
    # a table of one row, whose root is a leaf (face 5, skip -1)
    row = torch.zeros((1, 16))
    row[0, 3], row[0, 7], row[0, 14] = 1.0, 1.0, 1.0
    row.view(torch.int32)[0, 12:14] = torch.tensor([5, -1], dtype=torch.int32)
    one = PackedLBVH(rows=row)
    assert split_table(row)[1].view(torch.int32)[0, 9:11].tolist() == [5, -1]
    o = torch.tensor([[0.2, 0.2, -1.0], [5.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t0 = torch.full((2,), BIG)
    a = torch.ones(2, dtype=torch.bool)
    want = traverse_wavefront(one, o, d, t0, a)
    assert want[1].tolist() == [5, -1]
    for got in (traverse_split(one, o, d, t0, a),
                sweep.traverse_while_while(one, o, d, t0, a, 8)):
        assert torch.equal(got[1], want[1])


def test_steps_record_sums_to_visits(soup):
    """The steps record holds every visit of the visits record: the rays
    that stepped, their rows, their leaf flags."""
    pb, rays = soup
    args = [torch.from_numpy(x) for x in rays]
    visits, steps = [], []
    traverse_wavefront(pb, *args, visits=visits, steps=steps)
    assert len(steps) == len(visits)
    for (n, n_leaf), (lanes, rows, leaf) in zip(visits, steps):
        assert lanes.numel() == rows.numel() == leaf.numel() == n
        assert int(leaf.sum()) == n_leaf
        assert bool((pb.rows[rows.long(), 14] > 0.5).eq(leaf).all())
    assert sum(n for n, _ in visits) == sum(x[0].numel() for x in steps)


def test_simd_efficiency_hand_made():
    """Two warps: in warp 0 lanes 0-3 walk 4, 2, 2 and 1 steps (lane 2's
    second and lane 0's last at a leaf), in warp 1 lane 32 walks one step
    at a leaf. Steps 10; warp steps 4 + 1 (each warp's longest walk);
    the one mixed warp step: warp 0's second (lane 2 at a leaf beside
    lanes 0 and 1 on internal rows)."""
    def step(lanes, leaf):
        lanes = torch.tensor(lanes)
        return (lanes, torch.zeros_like(lanes, dtype=torch.int32),
                torch.tensor(leaf))
    record = [step([0, 1, 2, 3, 32], [False, False, False, False, True]),
              step([0, 1, 2], [False, False, True]),
              step([0], [False]),
              step([0], [True])]
    assert simd_efficiency(record) == 10 / (32 * 5)
    assert mixed_share(record) == 1 / 5
    assert simd_efficiency([]) == 0.0 and mixed_share([]) == 0.0


def test_walk_designs_match_the_sweep():
    """The sweep's designs (PACKED_DESIGNS, read from the RK_PWALK_DESIGN
    lines of csrc/packed_walk_designs.cu) have one line each with every
    designs::Design field; the presorted variants name designs; the
    package's rk_packed_walk is called with its scratch; every header the sources include is built with them."""
    import os
    import re

    from raypt_torch.kernels._build import CSRC_DIR, KERNEL_HEADERS
    with open(os.path.join(CSRC_DIR, "packed_walk_designs.cu")) as f:
        src = f.read()
    made = re.findall(r"^RK_PWALK_DESIGN\((\w+),", src, re.M)
    assert len(made) == len(set(made)) == len(sweep.PACKED_DESIGNS) - 2
    assert all(len(sweep.PACKED_DESIGNS[n]) == 10 for n in made)
    for name in ("pr12", "lean"):
        assert sweep.PACKED_DESIGNS[name] is None
        assert f'extern "C" int rk_pwalk_{name}(' in src
    assert sweep.packed_sig(sweep._read(CSRC_DIR, "packed_walk.cu")) == "packed"
    for pre, (name, _) in sweep.PRESORTED.items():
        assert sweep.PACKED_DESIGNS[name] is not None, pre
    assert "packed_walk.cuh" in KERNEL_HEADERS
    for h in KERNEL_HEADERS:
        assert os.path.exists(os.path.join(CSRC_DIR, h))


@pytest.mark.parametrize("block", [32, 128])
def test_octant_order(soup, block):
    """The kernel's ray order (each block of `block` rays handed out by
    direction octant, live rays first, stably; the padding past the
    wavefront last) is a permutation of each block, and the plain walk
    of the rays in that order, put back, is the walk in launch order,
    bitwise."""
    from raypt_torch.accel.packed import octant_order
    pb, rays = soup
    o, d, t0, a = (torch.from_numpy(x) for x in rays)
    r = RAYS - 40      # a part-filled last block
    lane = octant_order(d[:r], a[:r], block)
    lanes = lane.numel()
    assert lanes == -(-r // block) * block
    blocks = lane.view(-1, block)
    assert torch.equal(blocks.sort(dim=1).values,
                       torch.arange(lanes).view(-1, block))
    neg = (d[:r] < 0).long()
    key = torch.full((lanes,), 8)
    key[:r] = torch.where(a[:r], neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2),
                          8)
    k = key[lane].view(-1, block)
    assert bool((k[:, 1:] >= k[:, :-1]).all())
    same = k[:, 1:] == k[:, :-1]
    assert bool((blocks[:, 1:] > blocks[:, :-1])[same].all())
    real = lane < r
    order = lane[real]
    want = traverse_wavefront(pb, o[:r], d[:r], t0[:r], a[:r])
    got = traverse_wavefront(pb, o[order], d[order], t0[order], a[order])
    back = torch.empty_like(order)
    back[order] = torch.arange(r)
    assert torch.equal(got[0][back].view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1][back], want[1])
