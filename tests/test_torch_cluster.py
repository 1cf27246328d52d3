"""The dense-union onehot branch and the cluster finder of raypt_torch
against the JAX package, on seeded numpy inputs over the bench scene's
stand-in bunny: the union walk, the box cull into worklists, both dense
intersections (JAX kernels in interpret mode, the port's plain versions)
and both finders end to end.

The CUDA kernels run only on the card: test_torch_gpu.py and
chip_smoke.py hold them bitwise against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import clusters as jcl
from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.host_bvh import build_sah as jax_build_sah
from raypt.accel.traverse import find_closest_cluster as jax_find_cluster
from raypt.accel.traverse import find_closest_onehot as jax_find_onehot
from raypt.core.math3d import BIG
from raypt.kernels.cluster_pallas import (pallas_cluster_intersect,
                                          pallas_cluster_intersect_mask)
from raypt.kernels.onehot_walk import pallas_topwalk_union
from raypt.scenes import builtin as jax_scenes

from raypt_torch.accel import clusters as tcl
from raypt_torch.accel.traverse import (find_closest_bruteforce,
                                        find_closest_cluster,
                                        find_closest_onehot)
from raypt_torch.core.types import scene_from_numpy
from raypt_torch.kernels import cluster_expand as tex
from raypt_torch.kernels import cluster_pallas as tdn
from raypt_torch.kernels import onehot_walk as twk

from test_torch_scene import (jax_accel_to_port, jax_clusters_to_port,
                              jax_leaves)

torch.set_num_threads(2)

R = 2048          # one walk tile, 8 union tiles
# t tolerances against XLA, which contracts multiply-adds where torch
# does not: relative 1e-5, and absolute one float32 ulp of the scene's
# coordinates (|x| < 256: 1.5e-5), which rays starting next to the
# surface need, where t is small and o - p0 keeps the coordinates'
# rounding
T_RTOL, T_ATOL = 1e-5, 2.0 ** -16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def bunny():
    """JAX bench scene, its SAH tree and the port's copy of the scene."""
    scene = jax_scenes.stanford_bunny().freeze()
    return scene, jax_build_sah(scene.mesh), scene_from_numpy(
        jax_leaves(scene), "cpu")


_ONEHOT = {}   # (scene, leaf) -> the accels: a JAX build takes seconds


def _onehot(bunny, leaf):
    """The JAX build_onehot of the bunny at `leaf` and the port's copy,
    built once a module for each scene and leaf (callers do not write
    to them)."""
    scene, bvh, _ = bunny
    if (id(scene), leaf) not in _ONEHOT:
        m = scene.mesh
        ref = jax_build_onehot(bvh, m.positions, m.faces, m.face_valid,
                               leaf=leaf)
        _ONEHOT[id(scene), leaf] = (scene, ref, jax_accel_to_port(ref))
    return _ONEHOT[id(scene), leaf][1:]


def _wavefront(rng, scene, r=R, live=0.6):
    """Rays from near mesh vertices (inside several cluster boxes, so the
    cull's clamped entry distances tie at 0) and from around the scene,
    towards points in the mesh's bounds; t0 is BIG or a random bound;
    a `live` share of rays is active."""
    pos = np.asarray(scene.mesh.positions)[:2562]
    lo, hi = pos.min(0), pos.max(0)
    target = lo + rng.random((r, 3)) * (hi - lo)
    near = pos[rng.integers(0, len(pos), r)] + rng.normal(size=(r, 3))
    far = (lo + hi) / 2 + rng.normal(size=(r, 3)) * (hi - lo)
    ro = np.where((np.arange(r) // 512 % 2 == 0)[:, None], near, far)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t0 = np.where(rng.random(r) < 0.5, BIG, rng.random(r) * 200.0)
    active = rng.random(r) < live
    return (ro.astype(np.float32), rd.astype(np.float32),
            t0.astype(np.float32), active)


def _seed(t0, active):
    return np.where(active, t0, -BIG).astype(np.float32)


@pytest.mark.parametrize("leaf,layout", [
    pytest.param(16, "random", id="16"), pytest.param(64, "random", id="64"),
    (16, "dead_tile"), (64, "dead_tile"), (16, "same_ray"), (64, "same_ray")])
def test_topwalk_union_bitwise(bunny, leaf, layout):
    """The walk's per-tile unions, with ~40% dead rays, against
    pallas_topwalk_union: bitwise (the slab test has no multiply-add to
    fuse). leaf 16: 1,026 clusters, 33 words; leaf 64: 258, 9. Also with
    the second tile's rays all dead (dead_tile: its union is empty), or
    all 256 of them one live ray (same_ray: the tile's union is that
    ray's mask)."""
    rng = np.random.default_rng(20 + leaf)
    (_, jtable), acc = _onehot(bunny, leaf)
    ro, rd, t0, active = _wavefront(rng, bunny[0])
    tile = slice(256, 512)
    if layout == "dead_tile":
        active[tile] = False
    nw = -(-acc.num_clusters // 32)
    if layout == "same_ray":   # the first ray past the tile that wants any
        wants = twk.topwalk_cm_plain(acc.table, _t(ro), _t(rd), _t(t0),
                                     _t(active), nw).any(dim=0).numpy()
        k = 512 + int(np.argmax(wants[512:]))
        ro[tile], rd[tile], t0[tile], active[tile] = ro[k], rd[k], t0[k], True
    ref = np.asarray(pallas_topwalk_union(
        jtable, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t0),
        jnp.asarray(active), nw, interpret=True))
    got = twk.topwalk_union(acc.table, _t(ro), _t(rd), _t(t0), _t(active), nw)
    assert got.shape == (R // 256, nw) and (ref != 0).sum() > R // 256
    assert np.array_equal(got.numpy(), ref)
    if layout != "random":
        assert bool(ref[1].any()) == (layout == "same_ray")


@pytest.mark.parametrize("cap", [512, 24])
def test_tile_worklists_bitwise(bunny, cap):
    """Worklist, counts and overflow bitwise against the JAX cull, on a
    wavefront where clusters tie at entry distance 0 within a tile (the
    stable sort keeps ascending id there); cap 24 overflows tiles."""
    rng = np.random.default_rng(31)
    scene, bvh, _ = bunny
    m = scene.mesh
    jc = jcl.build_clusters(bvh, m.positions, m.faces, m.face_valid, leaf=64)
    ro, rd, t0, active = _wavefront(rng, scene)
    seed = _seed(t0, active)
    ref = jcl.tile_worklists(jc, jnp.asarray(ro), jnp.asarray(rd),
                             jnp.asarray(seed), tile=256, cap=cap)
    got = tcl.tile_worklists(jax_clusters_to_port(jc), _t(ro), _t(rd),
                             _t(seed), 256, cap)
    for g, r_ in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r_))
    # ties at 0: a live origin inside two or more boxes of one tile
    bmin, bmax = np.asarray(jc.bmin), np.asarray(jc.bmax)
    inside = ((ro[:, None] >= bmin[None]) & (ro[:, None] <= bmax[None])
              ).all(-1) & active[:, None]
    assert (inside.reshape(R // 256, 256, -1).any(1).sum(1) >= 2).any()
    assert (got[2].numpy().any() == (cap < 512))


def _close(got, ref, active):
    """Faces equal on every live ray; t within T_RTOL/T_ATOL there."""
    (gt, gf), (rt, rf) = ((np.asarray(a) for a in x) for x in (got, ref))
    assert (rf[active] >= 0).sum() > active.sum() // 10
    assert np.array_equal(gf[active], rf[active])
    np.testing.assert_allclose(gt[active], rt[active], rtol=T_RTOL,
                               atol=T_ATOL)


@pytest.mark.parametrize("leaf", [16, 64])
def test_intersect_mask_close(bunny, leaf):
    """cluster_intersect_mask against pallas_cluster_intersect_mask on the
    same unions. Faces must be equal on every live ray (measured:
    equal), t within T_RTOL/T_ATOL (measured worst: 6.9e-7 absolute,
    3.1e-5 relative at t = 0.02)."""
    rng = np.random.default_rng(40 + leaf)
    (jclu, jtable), acc = _onehot(bunny, leaf)
    ro, rd, t0, active = _wavefront(rng, bunny[0])
    nw = -(-acc.num_clusters // 32)
    union = twk.topwalk_union(acc.table, _t(ro), _t(rd), _t(t0), _t(active),
                              nw)
    seed = _seed(t0, active)
    ref = pallas_cluster_intersect_mask(
        jnp.asarray(union.numpy()), jnp.transpose(jclu.tri_rows, (0, 2, 1)),
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seed), interpret=True)
    got = tdn.cluster_intersect_mask(union, acc.clusters.tri_rows, _t(ro),
                                     _t(rd), _t(seed))
    _close(got, ref, active)


def test_intersect_worklist_kernel_close(bunny):
    """cluster_intersect against pallas_cluster_intersect on the same
    worklists (leaf 64, cap 512): faces equal on every live ray, t within
    T_RTOL/T_ATOL (measured: faces equal, worst t 8.5e-8 absolute, 1.3e-5
    relative)."""
    rng = np.random.default_rng(51)
    scene, bvh, _ = bunny
    m = scene.mesh
    jc = jcl.build_clusters(bvh, m.positions, m.faces, m.face_valid, leaf=64)
    ro, rd, t0, active = _wavefront(rng, scene)
    seed = _seed(t0, active)
    wl, cnt, _ = tcl.tile_worklists(jax_clusters_to_port(jc), _t(ro), _t(rd),
                                    _t(seed), 256, 512)
    ref = pallas_cluster_intersect(
        jnp.asarray(wl.numpy()), jnp.asarray(cnt.numpy()),
        jnp.transpose(jc.tri_rows, (0, 2, 1)), jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(seed), interpret=True)
    got = tdn.cluster_intersect(wl, cnt, jax_clusters_to_port(jc).tri_rows,
                                _t(ro), _t(rd), _t(seed))
    _close(got, ref, active)


@pytest.mark.parametrize("leaf", [16, 64])
def test_mask_intersect_equals_expand(bunny, leaf):
    """The port's plain versions, bitwise: the dense test of each tile's
    union of the walk masks equals the per-ray-exact expansion of those
    masks (`tests/test_expand.py`'s property of the JAX kernels)."""
    rng = np.random.default_rng(60 + leaf)
    _, acc = _onehot(bunny, leaf)
    ro, rd, t0, active = (_t(x) for x in _wavefront(rng, bunny[0]))
    cwp = -(-acc.num_clusters // 256) * 8
    nw = -(-acc.num_clusters // 32)
    mask_cm, union_pp = twk.topwalk_cm_u(acc.table, ro, rd, t0, active, cwp)
    union, _ = tcl.tile_union_counts(mask_cm[:nw].T.contiguous(), 256)
    assert torch.equal(union, twk.topwalk_union(acc.table, ro, rd, t0, active,
                                                nw))
    seed = torch.where(active, t0, torch.full_like(t0, -BIG))
    ta, fa = tdn.cluster_intersect_mask(union, acc.clusters.tri_rows, ro, rd,
                                        seed)
    tb, fb = tex.cluster_expand(mask_cm, union_pp, acc.clusters.tri_rows, ro,
                                rd, seed)
    assert int((fa >= 0).sum()) > R // 10
    assert torch.equal(ta.view(torch.int32), tb.view(torch.int32))
    assert torch.equal(fa, fb)


def test_stray_union_bits_ignored(bunny):
    """Bits >= C in the last union word, and whole words past it, test
    nothing: the result equals that of the clean union, in the port and
    (for the last word, which its wrapper guards) in the JAX kernel."""
    rng = np.random.default_rng(70)
    (jclu, _), acc = _onehot(bunny, 64)
    ro, rd, t0, active = _wavefront(rng, bunny[0])
    c = acc.num_clusters
    nw = -(-c // 32)
    union = twk.topwalk_union(acc.table, _t(ro), _t(rd), _t(t0), _t(active),
                              nw)
    stray = union.clone()
    stray[:, -1] |= torch.tensor(-(1 << (c - 32 * (nw - 1))),
                                 dtype=torch.int32)
    seed = _t(_seed(t0, active))
    rows = acc.clusters.tri_rows
    clean = tdn.cluster_intersect_mask(union, rows, _t(ro), _t(rd), seed)
    extra = torch.cat([stray, torch.full((R // 256, 1), -1,
                                         dtype=torch.int32)], dim=1)
    for u in (stray, extra):
        got = tdn.cluster_intersect_mask(u, rows, _t(ro), _t(rd), seed)
        assert torch.equal(got[0], clean[0]) and torch.equal(got[1], clean[1])
    jrows = jnp.transpose(jclu.tri_rows, (0, 2, 1))
    args = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seed.numpy()))
    j_clean = pallas_cluster_intersect_mask(jnp.asarray(union.numpy()), jrows,
                                            *args, interpret=True)
    j_stray = pallas_cluster_intersect_mask(jnp.asarray(stray.numpy()), jrows,
                                            *args, interpret=True)
    for a, b in zip(j_clean, j_stray):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _finders_agree(got, ref, active):
    """Same sphere and face on every live ray, t within T_RTOL/T_ATOL;
    dead rays miss."""
    a = torch.from_numpy(active)
    rt, rtri, rsph = (torch.from_numpy(np.array(x)) for x in
                      (ref.t, ref.tri, ref.sphere))
    assert int((rtri[a] >= 0).sum()) > int(a.sum()) // 10
    assert torch.equal(got.sphere[a], rsph[a])
    assert torch.equal(got.tri[a], rtri[a])
    torch.testing.assert_close(got.t[a], rt[a], rtol=T_RTOL, atol=T_ATOL)
    assert bool((got.t[~a] == BIG).all() and (got.tri[~a] == -1).all())


def test_find_closest_cluster_overflow_matches_jax(bunny):
    """find_closest_cluster at cap 2, where every tile with hits
    overflows into the fallback, against the JAX finder (use_pallas=False,
    cap=2) and the brute-force oracle; R = 1,500 is padded inside. Faces
    and spheres equal on every live ray, t within T_RTOL/T_ATOL
    (measured worst 6.1e-7 absolute vs JAX; bitwise vs brute force)."""
    rng = np.random.default_rng(80)
    scene, bvh, tscene = bunny
    m = scene.mesh
    jc = jcl.build_clusters(bvh, m.positions, m.faces, m.face_valid, leaf=64)
    ro, rd, _, active = _wavefront(rng, scene, r=1500)
    args = (_t(ro), _t(rd))
    got = find_closest_cluster(tscene, jax_clusters_to_port(jc), *args,
                               active=_t(active), cap=2)
    ref = jax_find_cluster(scene, jc, jnp.asarray(ro), jnp.asarray(rd),
                           active=jnp.asarray(active), use_pallas=False,
                           cap=2)
    _finders_agree(got, ref, active)
    _finders_agree(got, find_closest_bruteforce(tscene, *args), active)


def test_dense_union_onehot_matches_jax(bunny):
    """find_closest_onehot at the JAX package's defaults (expand 0, the
    dense-union branch; leaf 128 is RenderConfig's default) against the
    JAX finder with its Pallas kernels in interpret mode; R = 3,000 is
    padded inside. Faces and spheres equal on every live ray, t within
    T_RTOL/T_ATOL (measured worst 2.3e-6 absolute at t = 0.018)."""
    rng = np.random.default_rng(90)
    scene, _, tscene = bunny
    ref_acc, acc = _onehot(bunny, 128)
    ro, rd, _, active = _wavefront(rng, scene, r=3000)
    got = find_closest_onehot(tscene, _t(ro), _t(rd), _t(active), accel=acc,
                              expand_n=0, compact_n=0)
    ref = jax_find_onehot(scene, ref_acc, jnp.asarray(ro), jnp.asarray(rd),
                          active=jnp.asarray(active))
    _finders_agree(got, ref, active)


def test_new_wrappers_dispatch_and_checks():
    """CPU tensors run the plain versions without counting a launch; the
    wrappers reject ray counts, dtypes, devices and leaf sizes they do not
    take."""
    counters = (twk.topwalk_union, tdn.cluster_intersect_mask,
                tdn.cluster_intersect)
    before = [f.launches for f in counters]
    r = 512
    ro = torch.zeros((r, 3))
    t = torch.zeros(r)
    alive = torch.ones(r, dtype=torch.bool)
    table = torch.zeros((89, 16), dtype=torch.bfloat16)
    rows = torch.zeros((8, 4, 12))
    union = torch.zeros((2, 1), dtype=torch.int32)
    wl = torch.zeros((2, 4), dtype=torch.int32)
    cnt = torch.zeros(2, dtype=torch.int32)
    twk.topwalk_union(table, ro, ro, t, alive, 1)
    tdn.cluster_intersect_mask(union, rows, ro, ro, t)
    tdn.cluster_intersect(wl, cnt, rows, ro, ro, t)
    assert before == [f.launches for f in counters]
    with pytest.raises(ValueError):
        twk.topwalk_union(table, ro[:300], ro[:300], t[:300], alive[:300], 1)
    with pytest.raises(ValueError):
        tdn.cluster_intersect_mask(union, rows, ro[:300], ro[:300], t[:300])
    with pytest.raises(ValueError):
        tdn.cluster_intersect_mask(union.long(), rows, ro, ro, t)
    with pytest.raises(ValueError):
        tdn.cluster_intersect(wl, cnt[:1], rows, ro, ro, t)
    with pytest.raises(ValueError):
        tdn.cluster_intersect(wl, cnt, rows.to("meta"), ro.to("meta"),
                              ro.to("meta"), t.to("meta"))
    with pytest.raises(ValueError):   # one staged cluster must fit
        tdn.cluster_intersect(wl, cnt, torch.zeros((8, 5000, 12)), ro, ro, t)


def test_cluster_use_pallas_false_matches_jax(bunny):
    """find_closest_cluster(use_pallas=False) at cap 24, where the main
    pass and the overflow fallback both run the worklist intersection,
    against the JAX finder with the same arguments (R = 1,500, padded
    inside): faces and spheres equal on every live ray, t within
    T_RTOL/T_ATOL (measured: faces equal; worst t 1.2e-4 absolute at
    t = 954, 3.3e-5 relative at t = 0.015). The default use_pallas=True
    finds the same faces."""
    rng = np.random.default_rng(410)
    scene, bvh, tscene = bunny
    m = scene.mesh
    jc = jcl.build_clusters(bvh, m.positions, m.faces, m.face_valid, leaf=64)
    ro, rd, _, active = _wavefront(rng, scene, r=1500)
    tc = jax_clusters_to_port(jc)
    got = find_closest_cluster(tscene, tc, _t(ro), _t(rd), _t(active),
                               use_pallas=False, cap=24)
    ref = jax_find_cluster(scene, jc, jnp.asarray(ro), jnp.asarray(rd),
                           active=jnp.asarray(active), use_pallas=False,
                           cap=24)
    _finders_agree(got, ref, active)
    other = find_closest_cluster(tscene, tc, _t(ro), _t(rd), _t(active),
                                 cap=24)
    assert torch.equal(other.tri, got.tri)
