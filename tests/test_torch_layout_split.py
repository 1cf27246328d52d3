"""The plain models of the cherry and quad kernels (`csrc/packed_layouts.cu`
over the split tables of `csrc/packed_layouts.cuh`): `accel.packed.
slot_table` (the table a kernel builds from the rows on every call) and
`traverse_slots` (its walk, one slot a step), held bitwise against the
plain walk `walk_layout`, and against the JAX package's
`traverse_wavefront2` / `traverse_wavefront4` on the same rows; the
table's links, counts and flags on hand-made meshes (root leaf rows,
invalid faces, empty slots, an empty slot 0 and an empty middle slot
planted in a quad row); the all-miss pick with t0 above BIG; the
planted ties of `chip_smoke.layout_tie_case`; and the sweep's layout
designs (`kernels.sweep.LAYOUT_DESIGNS`) against
`csrc/packed_layouts_designs.cu`.

The soup: 240 random triangles, a tenth of them invalid, 2,048 random
rays (a fifth dead) whose t0 is BIG, +inf, 2e30 or a finite seed."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raypt.accel import packed as jp
from raypt.core.math3d import BIG as JBIG

from raypt_torch.accel import lbvh
from raypt_torch.accel import packed as tp
from raypt_torch.core.math3d import BIG
from raypt_torch.core.types import RenderConfig
from raypt_torch.render import integrator as tint

from chip_smoke import check_ties, layout_tie_case, small_lbvh, small_meshes

torch.set_num_threads(2)

LAYOUTS = {"cherry": dict(leaf_tris=2), "quad": dict(leaf_tris=4)}
JAX_WALKS = {"cherry": jp.traverse_wavefront2, "quad": jp.traverse_wavefront4}
N_TRI = 240
RAYS = 2048
# the models' t against JAX's, as tests/test_torch_layouts.py states it
# for the plain walks (XLA sums a dot's three products in its own order
# and may contract multiply-adds): measured worst here 7.8e-7 relative
# over both layouts on these rays (143 of 2,048 t differ in the last
# bits, no face), faces equal except where t ties within rtol 1e-6
T_RTOL = 5e-6
T_ATOL = 1e-6


def _table(name, bvh, pos, faces, valid):
    return tint.pack_layout(RenderConfig(backend="bvh", **LAYOUTS[name]), bvh,
                            pos, faces, valid)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _same_walk(table, *rays):
    """traverse_slots and walk_layout agree bit for bit; their result."""
    mt, mf = tp.traverse_slots(table, *rays)
    pt, pf = tp.walk_layout(table, *rays)
    assert _bits_equal(mt, pt) and torch.equal(mf, pf)
    return mt, mf


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(11)
    corners = (rng.uniform(-5, 5, (N_TRI, 1, 3))
               + rng.uniform(-1, 1, (N_TRI, 3, 3))).astype(np.float32)
    pos = torch.from_numpy(corners.reshape(-1, 3))
    faces = torch.arange(3 * N_TRI, dtype=torch.int32).reshape(N_TRI, 3)
    valid = torch.from_numpy(rng.uniform(size=N_TRI) > 0.1)
    bvh = lbvh.build(pos, faces, torch.ones_like(valid))
    ro = rng.uniform(-6, 6, (RAYS, 3)).astype(np.float32)
    rd = rng.normal(size=(RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t0 = np.choose(np.arange(RAYS) % 4,
                   [np.full(RAYS, BIG, np.float32),
                    np.full(RAYS, np.inf, np.float32),
                    np.full(RAYS, 2e30, np.float32),
                    rng.uniform(2, 12, RAYS).astype(np.float32)])
    active = rng.uniform(size=RAYS) < 0.8
    rays = tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (ro, rd, t0, active))
    tables = {name: _table(name, bvh, pos, faces, valid) for name in LAYOUTS}
    return dict(pos=pos, faces=faces, valid=valid, bvh=bvh, rays=rays,
                tables=tables)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_slot_walk_bitwise(soup, name):
    """traverse_slots is walk_layout's result bit for bit; dead rays keep
    t0 and face -1."""
    ro, rd, t0, active = soup["rays"]
    mt, mf = _same_walk(soup["tables"][name], ro, rd, t0, active)
    assert _bits_equal(mt[~active], t0[~active])
    assert bool((mf[~active] == -1).all()) and int((mf >= 0).sum()) > 300


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_slot_walk_matches_jax(soup, name):
    """traverse_slots against the JAX walk of the same rows: t within
    T_RTOL / T_ATOL, faces equal except where t ties within rtol 1e-6."""
    table = soup["tables"][name]
    rows = jnp.asarray(table.rows.numpy())
    jtable = (jp.Packed2LBVH(rows=rows) if name == "cherry"
              else jp.Packed4LBVH(rows=rows, lookahead=False))
    mt, mf = tp.traverse_slots(table, *soup["rays"])
    jt, jf = JAX_WALKS[name](jtable, *(jnp.asarray(x.numpy())
                                       for x in soup["rays"]))
    jt, jf = np.asarray(jt), np.asarray(jf)
    np.testing.assert_allclose(mt.numpy(), jt, rtol=T_RTOL, atol=T_ATOL)
    assert ((mf.numpy() == jf) | np.isclose(mt.numpy(), jt, rtol=1e-6)).all()
    assert BIG == JBIG


def _expected_codes(table, name):
    """Row by row in Python: the code of each row's left and skip links
    (-1; an internal row s; a leaf row's first entry slots * s | LEAF_BIT)
    and each row's count of slots to test."""
    lay, sl = tp.LAYOUTS[name], tp.SLOT_LAYOUTS[name]
    rows = table.rows
    bits = rows.view(torch.int32)
    k = sl.slots
    leaf = [bool(x > 0.5) for x in rows[:, lay.leaf_col]]

    def code(s):
        s = int(s)
        if s < 0:
            return -1
        return (k * s) | tp.LEAF_BIT if leaf[s] else s

    counts = []
    for n in range(rows.shape[0]):
        count = 0
        for j in range(k):
            face = int(bits[n, lay.faces][j])
            e1 = [int(x) & 0x7FFFFFFF for x in bits[n, 9 * j + 3:9 * j + 6]]
            if not (face == -1 and not any(e1)):
                count = j + 1
        counts.append(count if leaf[n] else 0)
    return leaf, code, counts


def _check_table(table, name):
    """slot_table's rows against _expected_codes: an internal row's box
    and link codes; a leaf row's entries below max(count, 1), each its
    slot's triangle and face, chained by their next codes to the row's
    skip, the last one flagged (2 where an empty slot follows)."""
    lay, sl = tp.LAYOUTS[name], tp.SLOT_LAYOUTS[name]
    k = sl.slots
    inner, leaves = (x.view(torch.int32) for x in tp.slot_table(table))
    bits = table.rows.view(torch.int32)
    leaf, code, counts = _expected_codes(table, name)
    assert torch.equal(tp.slot_counts(table), torch.tensor(counts,
                                                           dtype=torch.int32))
    entries = leaves.reshape(-1, tp.SLOT)
    for n in range(bits.shape[0]):
        if not leaf[n]:
            assert torch.equal(inner[n, 0:6], bits[n, 0:6])
            assert int(inner[n, 6]) == code(bits[n, sl.left])
            assert int(inner[n, 7]) == code(bits[n, sl.skip])
            assert not bool(leaves[n].any())
            continue
        assert not bool(inner[n].any())
        c = code(n)
        written = max(counts[n], 1)
        for j in range(written):
            e = entries[c & ~tp.LEAF_BIT]
            assert (c & ~tp.LEAF_BIT) == k * n + j
            assert torch.equal(e[0:9], bits[n, 9 * j:9 * j + 9])
            assert int(e[9]) == int(bits[n, lay.faces][j])
            last = j + 1 == written
            assert int(e[11]) == ((2 if counts[n] < k else 1) if last else 0)
            c = int(e[10])
        assert c == code(bits[n, sl.skip])
        assert not bool(leaves[n, written * tp.SLOT:].any())


def _hand_mesh(n, seed=5):
    """A mesh of n triangles in [-2, 2]^3, its last face invalid (n > 1),
    with its LBVH (chip_smoke.small_lbvh: one row for one triangle)."""
    rng = np.random.default_rng(seed + n)
    corners = (rng.uniform(-1.5, 1.5, (n, 1, 3))
               + rng.uniform(-1, 1, (n, 3, 3))).astype(np.float32)
    pos = torch.from_numpy(corners.reshape(-1, 3))
    faces = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    valid = torch.ones(n, dtype=torch.bool)
    if n > 1:
        valid[-1] = False
    return pos, faces, valid, small_lbvh(pos, faces, torch.ones_like(valid))


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9])
def test_slot_table_links_and_counts(name, n):
    """On hand-made meshes of 1-9 triangles (a root leaf row where the mesh
    fits one, an invalid face, singleton cherries and quads with empty
    slots): slot_table's codes, counts, entries and flags are those
    worked out row by row; an invalid face counts as filled; the walk is
    walk_layout's bit for bit on rays aimed at the triangles."""
    pos, faces, valid, bvh = _hand_mesh(n)
    table = _table(name, bvh, pos, faces, valid)
    _check_table(table, name)
    counts = tp.slot_counts(table)
    lay = tp.LAYOUTS[name]
    filled = (tp.ftoi(table.rows[:, lay.faces].contiguous()) >= 0).sum(1)
    leaf = table.rows[:, lay.leaf_col] > 0.5
    assert torch.equal(counts[leaf], filled[leaf].to(torch.int32))
    if n > 1:
        last = tp.ftoi(table.rows[:, lay.faces].contiguous()) == n - 1
        assert bool(last[leaf].any()), "the invalid face sits in a leaf row"
    rng = np.random.default_rng(n)
    target = pos.reshape(n, 3, 3).mean(1)[rng.integers(0, n, 512)]
    ro = torch.from_numpy(rng.uniform(-3, 3, (512, 3)).astype(np.float32))
    rd = target - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    t0 = torch.full((512,), BIG)
    _, mf = _same_walk(table, ro, rd, t0, torch.ones(512, dtype=torch.bool))
    assert int((mf >= 0).sum()) > 100
    assert not bool(valid[mf[mf >= 0].long()].logical_not().any())


@pytest.mark.parametrize("where", ["slot0", "middle"])
def test_planted_empty_slots(soup, where):
    """A quad row edited by hand so that an empty slot (face id -1, zero
    edges) comes before a filled one, which no packer makes: the count
    still ends at the last filled slot, the empty slot is tested (it
    misses), and the walk is walk_layout's bit for bit, on rays aimed at
    the row's triangles with t0 BIG, above BIG and finite."""
    table = soup["tables"]["quad"]
    steps = []
    tp.walk_layout(table, *soup["rays"], steps=steps)
    visited = torch.zeros(table.rows.shape[0], dtype=torch.bool)
    for _, nodes, leaf in steps:
        visited[nodes[leaf].long()] = True
    rows = table.rows.clone()
    bits = rows.view(torch.int32)
    lay = tp.LAYOUTS["quad"]
    n = int(torch.nonzero(visited & (tp.slot_counts(table) >= 3))[0])
    j = 0 if where == "slot0" else 1
    keep = rows[n, 9 * (j + 1):9 * (j + 1) + 9].clone()
    rows[n, 9 * j + 3:9 * j + 9] = 0.0
    bits[n, lay.faces.start + j] = -1
    edited = tp.Packed4LBVH(rows=rows)
    _check_table(edited, "quad")
    assert int(tp.slot_counts(edited)[n]) == int(tp.slot_counts(table)[n])
    rng = np.random.default_rng(3)
    p0, e1, e2 = keep[0:3], keep[3:6], keep[6:9]
    uv = torch.from_numpy(rng.uniform(0.05, 0.45, (600, 2)).astype(np.float32))
    target = p0 + uv[:, :1] * e1 + uv[:, 1:] * e2
    ro = torch.from_numpy(rng.uniform(-8, 8, (600, 3)).astype(np.float32))
    rd = target - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    t0 = torch.tensor([BIG, float("inf"), 7.0] * 200, dtype=torch.float32)
    steps = []
    mt, mf = _same_walk(edited, ro, rd, t0, torch.ones(600, dtype=torch.bool))
    tp.walk_layout(edited, ro, rd, t0, torch.ones(600, dtype=torch.bool),
                   steps=steps)
    at_row = sum(int((nodes[leaf] == n).sum()) for _, nodes, leaf in steps)
    assert at_row > 300 and int((mf >= 0).sum()) > 100


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_all_miss_above_big(soup, name):
    """The plain pick's quirk: a leaf row whose slots all miss picks BIG
    with its first slot's face, and takes it where BIG < t_best. With
    t0 +inf or 2e30, a live ray that reaches a leaf row and hits nothing
    ends at exactly BIG with a face id >= 0 (the first such row's slot
    0), in the model as in walk_layout; a ray that reaches no leaf row
    keeps t0 and face -1."""
    ro, rd, t0, active = soup["rays"]
    table = soup["tables"][name]
    t0 = torch.where(torch.arange(RAYS) % 2 == 0, float("inf"), 2e30)
    mt, mf = _same_walk(table, ro, rd, t0, active)
    steps = []
    tp.walk_layout(table, ro, rd, t0, active, steps=steps)
    reached = torch.zeros(RAYS, dtype=torch.bool)
    for lanes, _, leaf in steps:
        reached[lanes[leaf]] = True
    p = soup["pos"][soup["faces"].long()]
    ok = soup["valid"][None]
    h, _ = tp.leaf_hit(p[None, :, 0], (p[:, 1] - p[:, 0])[None],
                       (p[:, 2] - p[:, 0])[None], ro[:, None], rd[:, None],
                       t0[:, None])
    missed = ~(h & ok).any(dim=1)
    quirk = active & reached & missed
    assert int(quirk.sum()) > 100
    assert bool((mt[quirk] == BIG).all()) and bool((mf[quirk] >= 0).all())
    never = active & ~reached
    assert _bits_equal(mt[never], t0[never]) and bool((mf[never] == -1).all())


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_planted_ties_split(name):
    """chip_smoke.layout_tie_case: the model takes every tie to the
    lowest valid face id of the copies, bit for bit walk_layout's."""
    case = layout_tie_case("cpu")
    bvh = lbvh.build(case["positions"], case["faces"], case["build_valid"])
    table = _table(name, bvh, case["positions"], case["faces"], case["valid"])
    _, mf = _same_walk(table, *(case[k] for k in ("ro", "rd", "t0",
                                                  "active")))
    assert check_ties(case, mf, name) > 2000


@pytest.mark.parametrize("index", range(5))
def test_small_meshes_split(index):
    """chip_smoke.small_meshes' meshes of 1-5 triangles (root leaf rows):
    each table's links and counts as worked out row by row, and the
    model walk bit for bit walk_layout's."""
    n, bvh, pos, faces, valid, *rays = small_meshes("cpu")[index]
    for name in LAYOUTS:
        table = _table(name, bvh, pos, faces, valid)
        _check_table(table, name)
        _same_walk(table, *rays)


def test_layout_designs_match_the_sweep():
    """The sweep's layout designs (LAYOUT_DESIGNS, read from the
    RK_LWALK_DESIGN lines, the cherry and quad walks', and the
    RK_LWALK_LA_DESIGN lines, the lookahead walks', of
    csrc/packed_layouts_designs.cu) have one line each with every
    rk::lay::Design field, and walk their lines' layouts (LAYOUT_WALKS);
    pr19 is PR 19's four kernels; the design the package writes out for
    each layout is one of that layout's designs, one slot a step; each
    layout's Cols are the plain model's columns; the header the sources
    include is built with them."""
    import os
    import re

    from raypt_torch.kernels import sweep
    from raypt_torch.kernels._build import CSRC_DIR, KERNEL_HEADERS
    src = sweep._read(CSRC_DIR, "packed_layouts_designs.cu")
    made = re.findall(r"^RK_LWALK_DESIGN\((\w+),", src, re.M)
    made_la = re.findall(r"^RK_LWALK_LA_DESIGN\((\w+),", src, re.M)
    names = made + made_la
    assert len(names) == len(set(names)) == len(sweep.LAYOUT_DESIGNS) - 1
    assert made_la, "the lookahead walks' designs"
    assert all(len(sweep.LAYOUT_DESIGNS[n]) == 5 for n in names)
    assert all(sweep.LAYOUT_WALKS[n] == (0, 2) for n in made)
    assert all(sweep.LAYOUT_WALKS[n] == (1, 3) for n in made_la)
    assert sweep.LAYOUT_DESIGNS["pr19"] is None
    assert sweep.LAYOUT_WALKS["pr19"] == (0, 1, 2, 3)
    for layout in sweep.LAYOUT_CODES.values():
        assert f"RK_LWALK_PR19({layout}," in src
        assert layout in sweep.PR19_PATTERNS
    kept = sweep.layout_kept()
    assert set(kept) == set(sweep.LAYOUT_CODES.values())
    for code, layout in sweep.LAYOUT_CODES.items():
        assert any(kept[layout] == sweep.LAYOUT_DESIGNS[n]
                   and code in sweep.LAYOUT_WALKS[n] for n in names), layout
        assert kept[layout][2] == 4   # one slot a step: slot_table's
        width, slots, face0, flag, left, skip, right = \
            sweep.layout_cols()[layout]
        lay, sl = tp.LAYOUTS[layout], tp.SLOT_LAYOUTS[layout]
        assert (width, slots, face0, flag, left, skip) == (
            lay.width, sl.slots, lay.faces.start, lay.leaf_col, sl.left,
            sl.skip)
        assert right == (-1 if sl.right is None else sl.right)
    assert "packed_layouts.cuh" in KERNEL_HEADERS
    assert os.path.exists(os.path.join(CSRC_DIR, "packed_layouts.cuh"))
