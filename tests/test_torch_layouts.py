"""raypt_torch's packed-table layouts against the JAX package: the
cherry, lookahead and quad packers (`pack_cherries`, `pack_lookahead`,
`pack_quads`, `_subtree_ranges`), their plain walks
(`traverse_wavefront2` / `_la` / `4`), the compacting walk
(`traverse_wavefront_compact`, modes "compact" and "unrolled") over all
five tables, the wrappers of `kernels.packed_walk` on CPU tensors, the
planted ties and small meshes of `chip_smoke.py` phase 12, the tests
phase 12's bounds count (`chip_smoke.layout_tests`), and the native
midpoint BVH and morton order. The 16x16 render with gradients through
each layout is tests/test_torch_layouts_render.py's.

The scene is tests/test_traverse.py's: 300 random triangles and 3
spheres, 2,048 random rays, under the procedural sky. Both packages
pack and walk one LBVH (the port's build, carried across), so they are
compared independently of the build."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import lbvh as jlbvh
from raypt.accel import packed as jp
from raypt.accel import traverse as jtrav
from raypt.core.math3d import normalize as jnormalize
from raypt.core.scene import MaterialDef as JMat
from raypt.core.scene import SceneBuilder as JBuilder
from raypt.io import native as jnative

from raypt_torch.accel import packed as tp
from raypt_torch.accel import traverse as ttrav
from raypt_torch.accel import lbvh as tlbvh
from raypt_torch.core.types import RenderConfig, scene_from_numpy
from raypt_torch.io import native as tnative
from raypt_torch.kernels import packed_walk as tpw
from raypt_torch.render import integrator as tint

from chip_smoke import (check_ties, layout_tests, layout_tie_case,
                        small_meshes)
from test_torch_scene import jax_leaves

torch.set_num_threads(2)

FIELDS = ("left", "skip", "bmin", "bmax", "leaf_face")
RAYS = 2048
W = 16
# the plain walks' t against JAX's: XLA sums a dot's three products in
# its own order and may contract multiply-adds, so t may differ in the
# last bits (measured worst 1.6e-6 relative over the five tables on
# these rays and the planted ties; faces equal except where t ties); and
# 1e-6 absolute, for hits at t ~1e-4 (a stray tie-case ray: 1.3e-8
# apart, 6.7e-5 relative)
T_RTOL = 5e-6
T_ATOL = 1e-6
# the compacting walk's prefix floor in the CPU comparisons, below the
# wavefront, so that the phases partition and halve it (the finders'
# default, 16,384, leaves a 2,048-ray wavefront whole)
MIN_PREFIX = 1024

# name -> (RenderConfig flags, JAX packer, JAX table type)
LAYOUTS = {
    "one": ({}, jp.pack, jp.PackedLBVH),
    "cherry": (dict(leaf_tris=2), jp.pack_cherries, jp.Packed2LBVH),
    "lookahead": (dict(node_lookahead=True), jp.pack_lookahead,
                  jp.PackedLALBVH),
    "quad": (dict(leaf_tris=4), jp.pack_quads, jp.Packed4LBVH),
    "quad_la": (dict(leaf_tris=4, node_lookahead=True),
                partial(jp.pack_quads, lookahead=True), jp.Packed4LBVH),
}
NEW = ("cherry", "lookahead", "quad", "quad_la")
JAX_WALKS = {"one": jp.traverse_wavefront, "cherry": jp.traverse_wavefront2,
             "lookahead": jp.traverse_wavefront_la,
             "quad": jp.traverse_wavefront4,
             "quad_la": jp.traverse_wavefront4}


def _jscene(seed, ntri, nsph):
    """test_traverse.py's scene under the procedural sky, seen at W x W
    from the origin."""
    from raypt.scenes.builtin import _procedural_sky
    rng = np.random.default_rng(seed)
    b = JBuilder(env=_procedural_sky(16))
    b.camera.viewport_width = b.camera.viewport_height = W
    m0 = b.add_material(JMat(albedo=(0.5, 0.5, 0.5)))
    for _ in range(ntri):
        base = rng.uniform(-5, 5, 3)
        b.add_triangle(base, base + rng.uniform(-1, 1, 3),
                       base + rng.uniform(-1, 1, 3), m0)
    for _ in range(nsph):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.2, 1.0), m0)
    return b.freeze()


def _shared_lbvh(scene):
    """The port's LBVH of the scene and the JAX package's LBVH of the
    same arrays: both packages pack and walk the same tree, whatever
    their builds."""
    tm = scene.mesh
    bvh = tlbvh.build(tm.positions, tm.faces, tm.face_valid)
    return bvh, jlbvh.LBVH(**{k: jnp.asarray(getattr(bvh, k))
                              for k in FIELDS})


def _cfg(name, **kw):
    return RenderConfig(backend="bvh", **LAYOUTS[name][0], **kw)


def _jtable(name, jbvh, m):
    return jax.jit(LAYOUTS[name][1])(jbvh, m.positions, m.faces,
                                     m.face_valid)


def _ttable(name, bvh, m):
    return tint.pack_layout(_cfg(name), bvh, m.positions, m.faces,
                            m.face_valid)


def _to_jax(name, table):
    """A port table as the JAX package's, bit patterns kept."""
    kind = LAYOUTS[name][2]
    rows = jnp.asarray(table.rows.numpy())
    if kind is jp.Packed4LBVH:
        return kind(rows=rows, lookahead=table.lookahead)
    return kind(rows=rows)


@pytest.fixture(scope="module")
def soup():
    """The scene in both packages, the JAX LBVH and its copy in the port,
    both packages' tables of each layout, and RAYS random rays (a fifth
    dead) with the sphere pass's t."""
    jscene = _jscene(2, 300, 3)
    m = jscene.mesh
    scene = scene_from_numpy(jax_leaves(jscene), "cpu")
    bvh, jbvh = _shared_lbvh(scene)
    rng = np.random.default_rng(7)
    ro = rng.uniform(-6, 6, (RAYS, 3)).astype(np.float32)
    rd = np.asarray(jnormalize(jnp.asarray(
        rng.normal(size=(RAYS, 3)).astype(np.float32))))
    active = rng.uniform(size=RAYS) < 0.8
    t0 = ttrav._closest_sphere(scene, torch.from_numpy(ro),
                               torch.from_numpy(rd))[0].numpy()
    tm = scene.mesh
    return dict(jscene=jscene, jbvh=jbvh, scene=scene, bvh=bvh,
                jt={k: _jtable(k, jbvh, m) for k in LAYOUTS},
                tt={k: _ttable(k, bvh, tm) for k in LAYOUTS},
                rays=(ro, rd, t0, active))


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(np.asarray(a)) for a in arrays)


def _close(got_t, got_f, ref_t, ref_f):
    """t within T_RTOL / T_ATOL; faces equal except where t ties within
    rtol 1e-6 (test_traverse.py's rule)."""
    got_t, got_f, ref_t, ref_f = (np.asarray(x) for x in
                                  (got_t, got_f, ref_t, ref_f))
    np.testing.assert_allclose(got_t, ref_t, rtol=T_RTOL, atol=T_ATOL)
    assert ((got_f == ref_f) | np.isclose(got_t, ref_t, rtol=1e-6)).all()


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("name", NEW)
def test_packers_bitwise(soup, name):
    """Each packer's rows equal JAX's bit for bit on the same LBVH, from
    the LBVH and from its LBVHTensors; the quad table keeps its flag."""
    tt, jt = soup["tt"][name], soup["jt"][name]
    assert type(tt).__name__ == type(jt).__name__
    assert np.array_equal(tt.rows.numpy().view(np.int32), _bits(jt.rows))
    m = soup["scene"].mesh
    again = _ttable(name, soup["bvh"].tensors("cpu"), m)
    assert torch.equal(again.rows.view(torch.int32), tt.rows.view(torch.int32))
    if name.startswith("quad"):
        assert tt.lookahead == jt.lookahead == (name == "quad_la")


def test_subtree_ranges_bitwise(soup):
    """_subtree_ranges' (cnt, first) equal JAX's, from the LBVH and from
    its LBVHTensors; the root counts every leaf."""
    jc, jf = jp._subtree_ranges(soup["jbvh"])
    for tree in (soup["bvh"], soup["bvh"].tensors("cpu")):
        cnt, first = tp._subtree_ranges(tree)
        assert np.array_equal(cnt.numpy(), np.asarray(jc))
        assert np.array_equal(first.numpy(), np.asarray(jf))
    assert int(cnt[0]) == soup["bvh"].num_leaves and int(first[0]) == 0


@pytest.mark.parametrize("name", NEW)
def test_walks_match_jax(soup, name):
    """Each plain walk (the port's function of the JAX walk's name)
    against JAX's on the same table and rays: t to T_RTOL, faces equal
    but for ties; dead rays keep t0 and face -1, bit for bit; it is
    walk_layout's result, with or without a `visits` record."""
    ro, rd, t0, active = soup["rays"]
    walk = getattr(tp, JAX_WALKS[name].__name__)
    pt, pf = walk(soup["tt"][name], *_t(ro, rd, t0, active))
    jt, jf = JAX_WALKS[name](soup["jt"][name], *_j(ro, rd, t0, active))
    _close(pt, pf, jt, jf)
    assert np.array_equal(pt.numpy()[~active].view(np.int32),
                          t0[~active].view(np.int32))
    assert (pf.numpy()[~active] == -1).all() and (pf >= 0).sum() > 250
    visits = []
    again = tp.walk_layout(soup["tt"][name], *_t(ro, rd, t0, active),
                           visits=visits)
    assert torch.equal(again[0].view(torch.int32), pt.view(torch.int32))
    assert torch.equal(again[1], pf)
    assert sum(v[1] for v in visits) > 0 and visits[0][0] == active.sum()


@pytest.fixture(scope="module")
def jax_compact(soup):
    """JAX's find_closest_packed in mode "compact" over each table
    (jitted). JAX's "unrolled" runs the same steps with its loop unrolled
    in Python, so it is the reference of both modes (jitted, it does not
    compile in 10 minutes on the CPU)."""
    ro, rd, _, active = soup["rays"]
    find = jax.jit(partial(jtrav.find_closest_packed, soup["jscene"],
                           mode="compact"))
    return {name: find(soup["jt"][name], *_j(ro, rd, active))
            for name in LAYOUTS}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_compact_walk_bitwise(soup, name):
    """The plain compacting walk on each of the five tables at
    MIN_PREFIX (the phases partition the wavefront and halve the
    prefix): bitwise walk_layout's result."""
    ro, rd, t0, active = soup["rays"]
    tt = soup["tt"][name]
    ct, cf = tp.traverse_wavefront_compact(tt, *_t(ro, rd, t0, active),
                                           min_prefix=MIN_PREFIX)
    wt, wf = tp.walk_layout(tt, *_t(ro, rd, t0, active))
    assert torch.equal(ct.view(torch.int32), wt.view(torch.int32))
    assert torch.equal(cf, wf)


@pytest.mark.parametrize("mode", ["compact", "unrolled"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_compact_matches_jax(soup, jax_compact, name, mode):
    """find_closest_packed in each compacting mode on each of the five
    tables, at the finders' defaults: bitwise the tiled mode's result
    (tile 512, rays sorted), and against JAX's compact result."""
    ro, rd, _, active = soup["rays"]
    tt = soup["tt"][name]
    scene = soup["scene"]
    got = ttrav.find_closest_packed(scene, tt, *_t(ro, rd),
                                    torch.from_numpy(active), mode=mode)
    tiled = ttrav.find_closest_packed(scene, tt, *_t(ro, rd),
                                      torch.from_numpy(active), tile=512,
                                      sort_rays=True)
    for k in ("t", "tri", "sphere"):
        a, b = getattr(got, k), getattr(tiled, k)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
    ref = jax_compact[name]
    _close(got.t, got.tri, ref.t, ref.tri)
    assert np.array_equal(got.sphere.numpy(), np.asarray(ref.sphere))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_wrappers_on_cpu(soup, name):
    """kernels.packed_walk on CPU tensors runs the plain versions:
    walk_layout picks the table's wrapper, whose result is the plain
    walk's bit for bit, and compact_walk the plain compacting walk;
    neither launches. A table of another layout, or a quad table with
    the other flag, is a TypeError for a wrapper."""
    ro, rd, t0, active = _t(*soup["rays"])
    tt = soup["tt"][name]
    wrapper = tpw.wrapper_of(tt)
    assert tp.layout_of(tt) == name and wrapper is tpw.WALKS[name][0]
    before = wrapper.launches
    kt, kf = tpw.walk_layout(tt, ro, rd, t0, active)
    pt, pf = tp.walk_layout(tt, ro, rd, t0, active)
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(kf, pf)
    ct, cf = tpw.compact_walk(tt, ro, rd, t0, active)
    assert torch.equal(ct.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(cf, pf) and wrapper.launches == before
    others = [w for w, _ in tpw.WALKS.values() if w is not wrapper]
    assert len(others) == 4
    for other in others:
        with pytest.raises(TypeError):
            other(tt, ro, rd, t0, active)
    with pytest.raises(ValueError):
        wrapper(tt, ro[:, :2].contiguous(), rd, t0, active)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_walks_match_bruteforce(soup, name):
    """find_closest_packed over each table (tile 512) against the
    brute-force oracle, by test_traverse.py's rule: t within rtol 1e-5 /
    atol 1e-5, the same sphere, the same face where t does not tie
    within rtol 1e-6."""
    ro, rd, _, _ = soup["rays"]
    scene = soup["scene"]
    got = ttrav.find_closest_packed(scene, soup["tt"][name], *_t(ro, rd),
                                    tile=512)
    ref = ttrav.find_closest_bruteforce(scene, *_t(ro, rd))
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got.sphere, ref.sphere)
    assert ((got.tri == ref.tri).numpy()
            | np.isclose(got.t.numpy(), ref.t.numpy(), rtol=1e-6)).all()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_planted_ties(name):
    """chip_smoke.layout_tie_case on each table: every tie goes to the
    lowest valid face id of the copies (a before b in a cherry, the
    lowest slot in a quad, the first taken across rows), no invalid face
    is hit, and JAX's walk over the same rows takes the same faces; the
    compacting walk gives the tiled result."""
    from raypt_torch.accel import lbvh
    case = layout_tie_case("cpu")
    bvh = lbvh.build(case["positions"], case["faces"], case["build_valid"])
    table = tint.pack_layout(_cfg(name), bvh, case["positions"],
                             case["faces"], case["valid"])
    rays = tuple(case[k] for k in ("ro", "rd", "t0", "active"))
    pt, pf = tp.walk_layout(table, *rays)
    assert check_ties(case, pf, name) > 2000
    jt, jf = JAX_WALKS[name](_to_jax(name, table),
                             *_j(*(r.numpy() for r in rays)))
    _close(pt, pf, jt, jf)
    ct, cf = tp.traverse_wavefront_compact(table, *rays, min_prefix=512)
    assert torch.equal(ct.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(cf, pf)


@pytest.mark.parametrize("index", range(5))
def test_small_meshes(index):
    """chip_smoke.small_meshes' mesh of 1-5 triangles: each layout's
    table has 2n - 1 rows, its root a leaf row where the mesh fits one
    (one triangle; a cherry of two; a quad of up to four), and its walk
    gives every live ray the least t of a brute-force test of every
    triangle, bit for bit (dead rays keep face -1). The n = 1 tree is
    `chip_smoke.small_lbvh`'s."""
    n, bvh, pos, faces, valid, ro, rd, t0, active = small_meshes("cpu")[index]
    p = pos[faces.long()]
    h, t = tp.leaf_hit(p[None, :, 0], (p[:, 1] - p[:, 0])[None],
                       (p[:, 2] - p[:, 0])[None], ro[:, None], rd[:, None],
                       t0[:, None])
    best = torch.where(h & active[:, None], t, t0[:, None]).amin(dim=1)
    for name in LAYOUTS:
        table = tint.pack_layout(_cfg(name), bvh, pos, faces, valid)
        kind = table.rows[:, tp.LAYOUTS[name].leaf_col]
        assert table.rows.shape[0] == 2 * n - 1
        # the root is a leaf row: a one-row table, a cherry of two, a quad
        assert bool(kind[0] > 0.5) == (
            n == 1 or (name == "cherry" and n == 2)
            or (name.startswith("quad") and n <= 4))
        pt, pf = tp.walk_layout(table, ro, rd, t0, active)
        assert int((pf >= 0).sum()) > 100 and bool((pf[~active] == -1).all())
        assert torch.equal(pt.view(torch.int32), best.view(torch.int32)), name


def test_native_midpoint_and_morton():
    """build_midpoint_bvh and morton_order equal raypt.io.native's on a
    random mesh: bounds of the nodes used, meta, order, nodes_used, codes
    and order."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("the native library does not build here")
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (200, 3))
    got, want = tnative.build_midpoint_bvh(pos, faces), \
        jnative.build_midpoint_bvh(pos, faces)
    n = want["nodes_used"]
    assert got["nodes_used"] == n and 1 < n <= 2 * len(faces) - 1
    assert np.array_equal(got["bounds"][:n], want["bounds"][:n])
    for k in ("meta", "order"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    got, want = tnative.morton_order(pos), jnative.morton_order(pos)
    for k in ("codes", "order"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", NEW)
def test_layout_tests_count(soup, name):
    """chip_smoke.layout_tests, the tests phase 12's bound counts, on the
    first 512 rays: every internal visit one slab test and a lookahead
    row's a second one exactly where its left box misses (recounted here
    from the slab test of the left box at the t_best the walk had before
    that step, the walk stepped again alongside the record); every leaf
    visit its slots with a face id >= 0."""
    ro, rd, t0, active = _t(*(x[:512] for x in soup["rays"]))
    tt = soup["tt"][name]
    steps = []
    tp.walk_layout(tt, ro, rd, t0, active, steps=steps)
    inner, leaves, slabs, tris = layout_tests(tt, steps, 512)
    lay = tp.LAYOUTS[name]
    rows = tt.rows
    inv = tp.safe_reciprocal(rd)
    node = torch.where(active, 0, -1).to(torch.int32)
    tb, face = t0.clone(), torch.full_like(node, -1)
    live = torch.nonzero(active).flatten()
    want_slabs = want_tris = 0
    for lanes, nodes, leaf in steps:
        assert torch.equal(lanes, live) and torch.equal(nodes, node[live])
        r = rows[nodes.long()]
        assert torch.equal(leaf, r[:, lay.leaf_col] > 0.5)
        filled = tp.ftoi(r[:, lay.faces].contiguous())[leaf] >= 0
        want_tris += int(filled.sum())
        want_slabs += int((~leaf).sum())
        if lay.lookahead_left is not None:
            ri = r[~leaf]
            at = lanes[~leaf]
            hit = tp.slab_hit(ri[:, 0:3], ri[:, 3:6], ro[at], inv[at], tb[at])
            want_slabs += int((~hit).sum())
        live = tp._advance(lay, rows, live, node, tb, face, ro, rd, inv)
    assert live.numel() == 0
    assert inner + leaves == sum(x[0].numel() for x in steps)
    assert (slabs, tris) == (want_slabs, want_tris)
    assert inner < slabs if lay.lookahead_left is not None else \
        inner == slabs
    assert leaves < tris if name != "lookahead" else leaves == tris
