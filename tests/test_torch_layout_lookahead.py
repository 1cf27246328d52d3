"""The plain models of the lookahead walks (`csrc/packed_layouts.cu`,
layouts 1 and 3, over the split tables of `csrc/packed_layouts.cuh`):
`accel.packed.slot_table` of the lookahead table and of the quad table
with lookahead internal rows (two 32-byte sectors an internal row, the
right box's read only where the left box misses; the lookahead table's
leaf a 48-byte entry, the quad table's leaf rows slot entries), and
`traverse_slots`, their walk, held bitwise against the plain walk
`walk_layout` and against the JAX package's `traverse_wavefront_la` /
`traverse_wavefront4` (lookahead rows) on the same rows; the tables'
codes worked out row by row (left, right and skip, a root leaf row, the
right child clipped as the packers clip it); planted rays at the root's
two boxes (left hit; left missed and right hit; both missed; the right
sibling reached by its skip link); empty and invalid quad slots; the
all-miss pick with t0 above BIG; and `chip_smoke.layout_tie_case` and
`small_meshes`.

The soup is tests/test_torch_layout_split.py's: 240 random triangles, a
tenth of them invalid, 2,048 random rays (a fifth dead) whose t0 is BIG,
+inf, 2e30 or a finite seed."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raypt.accel import packed as jp

from raypt_torch.accel import lbvh
from raypt_torch.accel import packed as tp
from raypt_torch.core.math3d import BIG
from raypt_torch.core.types import RenderConfig
from raypt_torch.render import integrator as tint

from chip_smoke import check_ties, layout_tie_case, small_meshes
from test_torch_layout_split import RAYS, _bits_equal, _hand_mesh, soup

torch.set_num_threads(2)

LAYOUTS = {"lookahead": dict(node_lookahead=True),
           "quad_la": dict(leaf_tris=4, node_lookahead=True)}
# the models' t against JAX's, as tests/test_torch_layout_split.py states
# it (XLA sums a dot's three products in its own order and may contract
# multiply-adds): measured worst here 7.8e-7 relative over both layouts
# on these rays (143 of 2,048 t differ in the last bits, no face); faces
# equal except where t ties within rtol 1e-6
T_RTOL = 5e-6
T_ATOL = 1e-6
PLANTED = 400   # rays of each planted kind


def _table(name, bvh, pos, faces, valid):
    return tint.pack_layout(RenderConfig(backend="bvh", **LAYOUTS[name]), bvh,
                            pos, faces, valid)


def _same_walk(table, *rays, right=None):
    """traverse_slots and walk_layout agree bit for bit; their result."""
    mt, mf = tp.traverse_slots(table, *rays, right=right)
    pt, pf = tp.walk_layout(table, *rays)
    assert _bits_equal(mt, pt) and torch.equal(mf, pf)
    return mt, mf


@pytest.fixture(scope="module")
def tables(soup):
    return {name: _table(name, soup["bvh"], soup["pos"], soup["faces"],
                         soup["valid"]) for name in LAYOUTS}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_lookahead_walk_bitwise(soup, tables, name):
    """traverse_slots is walk_layout's result bit for bit; dead rays keep
    t0 and face -1; the model tests a right box only where a left box
    missed, fewer times than it visits internal rows."""
    ro, rd, t0, active = soup["rays"]
    right, steps = [], []
    mt, mf = _same_walk(tables[name], ro, rd, t0, active, right=right)
    assert _bits_equal(mt[~active], t0[~active])
    assert bool((mf[~active] == -1).all()) and int((mf >= 0).sum()) > 250
    tp.walk_layout(tables[name], ro, rd, t0, active, steps=steps)
    inner = sum(int((~leaf).sum()) for _, _, leaf in steps)
    assert 0 < sum(right) < inner


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_lookahead_walk_matches_jax(soup, tables, name):
    """traverse_slots against the JAX walk of the same rows: t within
    T_RTOL / T_ATOL, faces equal except where t ties within rtol 1e-6."""
    table = tables[name]
    rows = jnp.asarray(table.rows.numpy())
    if name == "lookahead":
        jt, jf = jp.traverse_wavefront_la(jp.PackedLALBVH(rows=rows), *(
            jnp.asarray(x.numpy()) for x in soup["rays"]))
    else:
        jt, jf = jp.traverse_wavefront4(
            jp.Packed4LBVH(rows=rows, lookahead=True),
            *(jnp.asarray(x.numpy()) for x in soup["rays"]))
    mt, mf = tp.traverse_slots(table, *soup["rays"])
    jt, jf = np.asarray(jt), np.asarray(jf)
    np.testing.assert_allclose(mt.numpy(), jt, rtol=T_RTOL, atol=T_ATOL)
    assert ((mf.numpy() == jf) | np.isclose(mt.numpy(), jt, rtol=1e-6)).all()


def _check_table(table, name, tree=None):
    """slot_table's rows worked out row by row: an internal row n's
    sector A (the left box, code(left), 2 n + 1: its sector B's 32-byte
    row) and B (the right box, code(right), code(skip)), with -1 for a
    link < 0, 2 s for an internal row s (its sector A) and slots * s |
    LEAF_BIT for a leaf row s; the lookahead table's leaf row
    split_table's (its triangle, face, code(skip), 0); a quad leaf row's
    entries below max(count, 1), each its slot's triangle and face,
    chained by their next codes to the row's skip, the last one flagged
    (2 where an empty slot follows). With the LBVH `tree`, each internal
    row's right link is skip[left] clipped to [0, rows), as the packers
    clip it. Returns the leaf rows' counts."""
    lay, sl = tp.LAYOUTS[name], tp.SLOT_LAYOUTS[name]
    k = sl.slots
    rows = table.rows
    bits = rows.view(torch.int32)
    n_rows = rows.shape[0]
    inner, leaves = (x.view(torch.int32) for x in tp.slot_table(table))
    assert inner.shape == (n_rows, 16) and leaves.shape == (n_rows, 12 * k)
    leaf = [bool(x > 0.5) for x in rows[:, lay.leaf_col]]

    def code(s):
        s = int(s)
        if s < 0:
            return -1
        return (k * s) | tp.LEAF_BIT if leaf[s] else 2 * s

    counts = tp.slot_counts(table)
    entries = leaves.reshape(-1, tp.SLOT)
    for n in range(n_rows):
        if not leaf[n]:
            assert torch.equal(inner[n, 0:6], bits[n, 0:6])
            assert torch.equal(inner[n, 8:14], bits[n, 6:12])
            assert int(inner[n, 6]) == code(bits[n, sl.left])
            assert int(inner[n, 7]) == 2 * n + 1
            assert int(inner[n, 14]) == code(bits[n, sl.right])
            assert int(inner[n, 15]) == code(bits[n, sl.skip])
            if tree is not None:
                lc = int(tree.left[n])
                rc = min(max(int(tree.skip[lc]), 0), n_rows - 1)
                assert int(bits[n, sl.right]) == rc
            assert not bool(leaves[n].any())
            continue
        assert not bool(inner[n].any())
        if k == 1:
            assert int(counts[n]) == 1
            assert torch.equal(leaves[n, 0:9], bits[n, 0:9])
            assert int(leaves[n, 9]) == int(bits[n, 12])
            assert int(leaves[n, 10]) == code(bits[n, sl.skip])
            assert int(leaves[n, 11]) == 0
            continue
        c = code(n)
        written = max(int(counts[n]), 1)
        for j in range(written):
            assert (c & ~tp.LEAF_BIT) == k * n + j
            e = entries[c & ~tp.LEAF_BIT]
            assert torch.equal(e[0:9], bits[n, 9 * j:9 * j + 9])
            assert int(e[9]) == int(bits[n, lay.faces][j])
            last = j + 1 == written
            assert int(e[11]) == ((2 if counts[n] < k else 1) if last else 0)
            c = int(e[10])
        assert c == code(bits[n, sl.skip])
        assert not bool(leaves[n, written * tp.SLOT:].any())
    return counts


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_lookahead_table_codes(soup, tables, name):
    """On the soup's tables: the codes, sectors and entries worked out
    row by row (_check_table), the right links the clipped skip of the
    left child; the quad table holds leaf rows with empty slots and
    invalid faces (id >= 0, zero edges: tested, filled)."""
    table = tables[name]
    counts = _check_table(table, name, soup["bvh"])
    if name == "quad_la":
        lay = tp.LAYOUTS[name]
        leaf = table.rows[:, lay.leaf_col] > 0.5
        assert bool((counts[leaf] < 4).any())
        fid = tp.ftoi(table.rows[:, lay.faces].contiguous())
        assert bool((~soup["valid"][fid[leaf].clamp(min=0).long()]
                     & (fid[leaf] >= 0)).any())


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
def test_lookahead_small_tables(name, n):
    """Hand-made meshes of 1-9 triangles (one triangle: the table's one
    row a root leaf row, its code LEAF_BIT; an invalid face): the table
    worked out row by row, and the walk walk_layout's bit for bit on
    rays aimed at the triangles."""
    pos, faces, valid, bvh = _hand_mesh(n)
    table = _table(name, bvh, pos, faces, valid)
    _check_table(table, name, bvh if n > 1 else None)
    if n == 1:
        assert table.rows.shape[0] == 1
        assert bool(table.rows[0, tp.LAYOUTS[name].leaf_col] > 0.5)
    rng = np.random.default_rng(n)
    target = pos.reshape(n, 3, 3).mean(1)[rng.integers(0, n, 512)]
    ro = torch.from_numpy(rng.uniform(-3, 3, (512, 3)).astype(np.float32))
    rd = target - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    _, mf = _same_walk(table, ro, rd, torch.full((512,), BIG),
                       torch.ones(512, dtype=torch.bool))
    assert int((mf >= 0).sum()) > 100
    assert bool(valid[mf[mf >= 0].long()].all())


def _planted(table, name, seed=8):
    """Rays at the root's two child boxes, t0 BIG, in four groups of
    PLANTED: aimed inside the left box; inside the right box, missing
    the left one; outward from a sphere of radius 12 around the boxes
    (both missed); and through both boxes (the left child's subtree
    walked, then the right child reached by its skip link)."""
    sl = tp.SLOT_LAYOUTS[name]
    box = table.rows[0, 0:12].reshape(2, 2, 3)   # [left, right] x [lo, hi]
    rng = np.random.default_rng(seed)
    groups = []
    for kind in ("left", "right", "miss", "both"):
        m = 40 * PLANTED
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ro = torch.from_numpy((12 * d).astype(np.float32))
        pick = 1 if kind == "right" else 0
        lo, hi = box[pick]
        target = lo + torch.from_numpy(
            rng.uniform(0.1, 0.9, (m, 3)).astype(np.float32)) * (hi - lo)
        rd = torch.from_numpy(d.astype(np.float32)) if kind == "miss" \
            else target - ro
        rd = rd / rd.norm(dim=1, keepdim=True)
        inv = tp.safe_reciprocal(rd)
        t0 = torch.full((m,), BIG)
        hl, hr = (tp.slab_hit(box[j, 0], box[j, 1], ro, inv, t0)
                  for j in (0, 1))
        keep = {"left": hl, "right": ~hl & hr, "miss": ~hl & ~hr,
                "both": hl & hr}[kind]
        idx = torch.nonzero(keep).flatten()[:PLANTED]
        assert idx.numel() == PLANTED, kind
        groups.append((ro[idx], rd[idx]))
    ro, rd = (torch.cat(x) for x in zip(*groups))
    return ro, rd, torch.full((4 * PLANTED,), BIG), torch.ones(
        4 * PLANTED, dtype=torch.bool)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_planted_child_boxes(tables, name):
    """Planted rays at the root's child boxes: the left group goes to the
    left child, the right group to the right child, the missing group
    ends at the root's skip (-1), and of the group through both boxes
    rays reach the right child by its skip link after the left
    subtree; the model's second step tests the root's sector B (the
    right box) for exactly the rays that missed the left box, and its
    first none; bitwise walk_layout's."""
    table = tables[name]
    sl = tp.SLOT_LAYOUTS[name]
    rays = _planted(table, name)
    right, steps = [], []
    _same_walk(table, *rays, right=right)
    assert right[0] == 0 and right[1] == 2 * PLANTED
    tp.walk_layout(table, *rays, steps=steps)
    left_link = int(tp.ftoi(table.rows[0, sl.left:sl.left + 1])[0])
    right_link = int(tp.ftoi(table.rows[0, sl.right:sl.right + 1])[0])
    nxt = torch.full((4 * PLANTED,), -1, dtype=torch.int32)
    nxt[steps[1][0]] = steps[1][1]
    group = torch.arange(4 * PLANTED) // PLANTED
    assert bool((nxt[group == 0] == left_link).all())
    assert bool((nxt[group == 1] == right_link).all())
    assert bool((nxt[group == 2] == -1).all())
    assert bool((nxt[group == 3] == left_link).all())
    by_skip = torch.zeros(4 * PLANTED, dtype=torch.bool)
    for lanes, nodes, _ in steps[2:]:
        by_skip[lanes[nodes == right_link]] = True
    assert int(by_skip[group == 3].sum()) > PLANTED // 2


@pytest.mark.parametrize("where", ["slot0", "middle"])
def test_planted_empty_slots_la(soup, tables, where):
    """A quad lookahead row edited by hand so that an empty slot (face id
    -1, zero edges) comes before a filled one: the count still ends at
    the last filled slot, the empty slot is tested (it misses), and the
    walk is walk_layout's bit for bit, on rays aimed at the row's
    triangles with t0 BIG, above BIG and finite."""
    table = tables["quad_la"]
    steps = []
    tp.walk_layout(table, *soup["rays"], steps=steps)
    visited = torch.zeros(table.rows.shape[0], dtype=torch.bool)
    for _, nodes, leaf in steps:
        visited[nodes[leaf].long()] = True
    rows = table.rows.clone()
    bits = rows.view(torch.int32)
    lay = tp.LAYOUTS["quad_la"]
    n = int(torch.nonzero(visited & (tp.slot_counts(table) >= 3))[0])
    j = 0 if where == "slot0" else 1
    keep = rows[n, 9 * (j + 1):9 * (j + 1) + 9].clone()
    rows[n, 9 * j + 3:9 * j + 9] = 0.0
    bits[n, lay.faces.start + j] = -1
    edited = tp.Packed4LBVH(rows=rows, lookahead=True)
    _check_table(edited, "quad_la")
    assert int(tp.slot_counts(edited)[n]) == int(tp.slot_counts(table)[n])
    rng = np.random.default_rng(3)
    p0, e1, e2 = keep[0:3], keep[3:6], keep[6:9]
    uv = torch.from_numpy(rng.uniform(0.05, 0.45, (600, 2)).astype(np.float32))
    target = p0 + uv[:, :1] * e1 + uv[:, 1:] * e2
    ro = torch.from_numpy(rng.uniform(-8, 8, (600, 3)).astype(np.float32))
    rd = target - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    t0 = torch.tensor([BIG, float("inf"), 7.0] * 200, dtype=torch.float32)
    _, mf = _same_walk(edited, ro, rd, t0, torch.ones(600, dtype=torch.bool))
    assert int((mf >= 0).sum()) > 100


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_all_miss_above_big_la(soup, tables, name):
    """With t0 +inf or 2e30, a live ray that reaches a leaf row and hits
    nothing: on the quad table the plain pick's quirk, exactly BIG with a
    face id >= 0 (the first such row's slot 0); on the lookahead table,
    whose leaf test takes a hit only, t0 and face -1. In the model as in
    walk_layout; a ray that reaches no leaf row keeps t0 and face -1."""
    ro, rd, _, active = soup["rays"]
    table = tables[name]
    t0 = torch.where(torch.arange(RAYS) % 2 == 0, float("inf"), 2e30)
    mt, mf = _same_walk(table, ro, rd, t0, active)
    steps = []
    tp.walk_layout(table, ro, rd, t0, active, steps=steps)
    reached = torch.zeros(RAYS, dtype=torch.bool)
    for lanes, _, leaf in steps:
        reached[lanes[leaf]] = True
    p = soup["pos"][soup["faces"].long()]
    h, _ = tp.leaf_hit(p[None, :, 0], (p[:, 1] - p[:, 0])[None],
                       (p[:, 2] - p[:, 0])[None], ro[:, None], rd[:, None],
                       t0[:, None])
    missed = ~(h & soup["valid"][None]).any(dim=1)
    quirk = active & reached & missed
    assert int(quirk.sum()) > 100
    if name == "quad_la":
        assert bool((mt[quirk] == BIG).all()) and bool((mf[quirk] >= 0).all())
    else:
        assert _bits_equal(mt[quirk], t0[quirk])
        assert bool((mf[quirk] == -1).all())
    never = active & ~reached
    assert _bits_equal(mt[never], t0[never]) and bool((mf[never] == -1).all())


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_planted_ties_la(name):
    """chip_smoke.layout_tie_case: the model takes every tie to the
    lowest valid face id of the copies, bit for bit walk_layout's."""
    case = layout_tie_case("cpu")
    bvh = lbvh.build(case["positions"], case["faces"], case["build_valid"])
    table = _table(name, bvh, case["positions"], case["faces"], case["valid"])
    _, mf = _same_walk(table, *(case[k] for k in ("ro", "rd", "t0",
                                                  "active")))
    assert check_ties(case, mf, name) > 2000


@pytest.mark.parametrize("index", range(5))
def test_small_meshes_la(index):
    """chip_smoke.small_meshes' meshes of 1-5 triangles (root leaf rows):
    each table worked out row by row, and the model walk bit for bit
    walk_layout's."""
    n, bvh, pos, faces, valid, *rays = small_meshes("cpu")[index]
    for name in LAYOUTS:
        table = _table(name, bvh, pos, faces, valid)
        _check_table(table, name)
        _same_walk(table, *rays)
