"""raypt_torch's Woop branch of the onehot finder and its two kernels'
plain versions against the JAX package: the clusters' Woop table
(`build_woop_cm`, `build_onehot(with_woop=True)`), the Woop mask
intersection against `pallas_cluster_intersect_mask_woop` and the
grouped worklist intersection against `pallas_cluster_intersect_grouped`
(interpret mode), on tests/test_onehot.py's 300-triangle soup at leaf
16, and `find_closest_onehot` with a Woop accel against the JAX finder
with its 4-tuple accel.

The CUDA kernels run only on the card: test_torch_gpu.py and
chip_smoke.py hold them bitwise against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel.clusters import build_woop_cm as jax_build_woop_cm
from raypt.accel.clusters import worklists_from_masks
from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.ctree import walk_topwalk_jnp
from raypt.accel.host_bvh import build_sah as jax_build_sah
from raypt.accel.traverse import find_closest_onehot as jax_find_onehot
from raypt.core.math3d import BIG
from raypt.core.scene import MaterialDef, SceneBuilder
from raypt.kernels.cluster_pallas import (pallas_cluster_intersect_grouped,
                                          pallas_cluster_intersect_mask_woop)
from raypt.scenes import config4 as jc4

from raypt_torch.accel import clusters as tcl
from raypt_torch.accel import ctree as tctree
from raypt_torch.accel import traverse as ttr
from raypt_torch.core.types import scene_from_numpy
from raypt_torch.kernels import cluster_pallas as tdn

from test_torch_scene import (jax_accel_to_port, jax_clusters_to_port,
                              jax_lbvh_to_port, jax_leaves)

torch.set_num_threads(2)

R = 2048          # 8 tiles of 256 rays, as the JAX kernels require
LEAF = 16
# t against XLA's contraction, which sums the affine products in its own
# order: relative 1e-5 and one float32 ulp of the coordinates (|x| < 8)
T_RTOL, T_ATOL = 1e-5, 2.0 ** -20


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _soup(seed=0, ntri=300, nsph=0):
    """tests/test_onehot.py's scene: random triangles in [-6, 6]^3."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m0 = b.add_material(MaterialDef(albedo=(0.5, 0.5, 0.5)))
    for _ in range(ntri):
        base = rng.uniform(-5, 5, 3)
        b.add_triangle(base, base + rng.uniform(-1, 1, 3),
                       base + rng.uniform(-1, 1, 3), m0)
    for _ in range(nsph):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.2, 1.0), m0)
    return b.freeze()


def _rays(rng, n=R):
    ro = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.fixture(scope="module")
def soup():
    """The soup (with 3 spheres), its SAH tree, the JAX leaf-16 4-tuple
    accel and the port's copies of the scene and the accel."""
    scene = _soup(nsph=3)
    m = scene.mesh
    bvh = jax_build_sah(m)
    accel = jax_build_onehot(bvh, m.positions, m.faces, m.face_valid,
                             leaf=LEAF, with_woop=True)
    return (scene, bvh, accel, scene_from_numpy(jax_leaves(scene), "cpu"),
            jax_accel_to_port(accel))


def _wave(soup, seed):
    """R rays, their walk's mask, and the tile unions with a stray bit
    >= C set in the last word of every fourth tile."""
    _, _, accel, _, _ = soup
    rng = np.random.default_rng(seed)
    ro, rd = _rays(rng)
    c = accel[0].num_clusters
    nw = -(-c // 32)
    mask = np.asarray(walk_topwalk_jnp(accel[1], jnp.asarray(ro),
                                       jnp.asarray(rd), jnp.full((R,), BIG),
                                       jnp.ones((R,), bool), nw))
    union = np.asarray(tcl.tile_union_counts(_t(mask), tdn.TILE)[0])
    assert c % 32, "the stray bit needs room in the last word"
    union[::4, -1] |= np.int32(1 << (c % 32))
    return ro, rd, mask, union


@pytest.mark.parametrize("which", ["soup", "config4"])
def test_build_woop_cm_bitwise(soup, which, tmp_path):
    """build_woop_cm on the same clusters: woop_cm and fid_flat bitwise
    equal to the JAX package's (both invert in float64 numpy), for the
    soup at leaf 16 and config4 at leaf 128; degenerate and padded rows
    carry the miss encoding."""
    if which == "soup":
        clusters = soup[2][0]
    else:
        m = jc4.config4_scene(hdr_path=str(tmp_path / "s.hdr")).freeze().mesh
        clusters = jax_build_onehot(jax_build_sah(m), m.positions, m.faces,
                                    m.face_valid, leaf=128)[0]
    ref_w, ref_f = (np.asarray(x) for x in jax_build_woop_cm(clusters))
    got_w, got_f = tcl.build_woop_cm(jax_clusters_to_port(clusters))
    assert got_w.dtype == torch.float32 and got_f.dtype == torch.int32
    assert np.array_equal(got_w.numpy().view(np.int32), ref_w.view(np.int32))
    assert np.array_equal(got_f.numpy(), ref_f)
    w = ref_w.reshape(ref_w.shape[0], 4, 3, -1)    # (C, k, row, lane)
    miss = ((w[:, :3] == 0).all(axis=(1, 2)) & (w[:, 3, 0] == 0)
            & (w[:, 3, 1] == 0) & (w[:, 3, 2] == 1))
    assert miss.any(), "no padded triangle in the table"


def test_build_onehot_with_woop_bitwise(soup):
    """build_onehot(with_woop=True) over the JAX package's SAH tree:
    every array bitwise equal to the JAX 4-tuple; without with_woop
    the accel carries no table; .to() moves both tables."""
    scene, bvh, accel, tscene, _ = soup
    m = tscene.mesh
    got = tctree.build_onehot(jax_lbvh_to_port(bvh), m.positions, m.faces,
                              m.face_valid, leaf=LEAF, with_woop=True)
    ref = jax_accel_to_port(accel)
    for a, b in ((got.clusters.tri_rows, ref.clusters.tri_rows),
                 (got.table, ref.table), (got.woop_cm, ref.woop_cm),
                 (got.fid_flat, ref.fid_flat)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))
    plain = tctree.build_onehot(jax_lbvh_to_port(bvh), m.positions, m.faces,
                                m.face_valid, leaf=LEAF)
    assert plain.woop_cm is None and plain.fid_flat is None
    moved = got.to("cpu")
    assert moved.woop_cm is not None and moved.fid_flat is not None


def test_woop_intersect_plain_matches_jax(soup):
    """cluster_intersect_mask_woop_plain against the JAX kernel on the
    same unions, stray bits >= C included, with a third of the rays dead
    (seed -BIG): the hit set equal, t within T_RTOL/T_ATOL, packed equal
    where the winning t is no near-tie (measured: packed equal on all 236
    hits, worst t 2.1e-6 absolute); dead rays keep -BIG and packed -1."""
    _, _, accel, _, tacc = soup
    ro, rd, _, union = _wave(soup, 1)
    rng = np.random.default_rng(2)
    dead = rng.random(R) < 0.33
    dead[:64] = False
    t0 = np.where(dead, -BIG, BIG).astype(np.float32)
    t0[:64] = rng.uniform(1, 4, 64)           # finite seeds: strict merge
    rt, rp = (np.asarray(x) for x in pallas_cluster_intersect_mask_woop(
        jnp.asarray(union), accel[2], jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(t0), interpret=True))
    gt, gp = (x.numpy() for x in tdn.cluster_intersect_mask_woop(
        _t(union), tacc.woop_cm, _t(ro), _t(rd), _t(t0)))
    assert np.array_equal(gp >= 0, rp >= 0) and (gp >= 0).sum() > 200
    np.testing.assert_allclose(gt, rt, rtol=T_RTOL, atol=T_ATOL)
    near_tie = np.isclose(gt, rt, rtol=1e-4, atol=1e-5)
    assert ((gp == rp) | near_tie).all()
    assert (gt[dead] == -BIG).all() and (gp[dead] == -1).all()


@pytest.mark.parametrize("group", [2, 3, 4])
def test_grouped_plain_matches_jax(soup, group):
    """cluster_intersect_grouped_plain against the JAX grouped kernel for
    G = 2, 3, 4 at cap 61 (no G divides it), on worklists whose counts
    were cut below the list, so valid ids sit in slots past counts: both
    test those within the last group. Faces equal and t within
    T_RTOL/T_ATOL (measured: faces equal, worst t 1.9e-6 absolute); the
    result differs from the ungrouped worklist intersection at the cut
    counts, which skips those slots (measured: on 2, 9 and 9 rays)."""
    _, _, accel, _, tacc = soup
    ro, rd, mask, _ = _wave(soup, 3)
    cap = 61
    wl, cnt, _ = (np.asarray(x) for x in worklists_from_masks(
        jnp.asarray(mask), tdn.TILE, cap, accel[0].num_clusters))
    cut = np.maximum(cnt - np.arange(len(cnt)) % 4, 0).astype(np.int32)
    assert (cut % group).any() and (cut < cnt).any()
    t0 = np.full((R,), BIG, np.float32)
    rows_cm = jnp.transpose(accel[0].tri_rows, (0, 2, 1))
    rt, rf = (np.asarray(x) for x in pallas_cluster_intersect_grouped(
        jnp.asarray(wl), jnp.asarray(cut), rows_cm, jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(t0), interpret=True, group=group))
    args = (_t(wl), _t(cut), tacc.clusters.tri_rows, _t(ro), _t(rd), _t(t0))
    gt, gf = (x.numpy() for x in tdn.cluster_intersect_grouped(*args, group))
    assert np.array_equal(gf, rf) and (gf >= 0).sum() > 200
    np.testing.assert_allclose(gt, rt, rtol=T_RTOL, atol=T_ATOL)
    ut, uf = (x.numpy() for x in tdn.cluster_intersect(*args))
    assert not np.array_equal(uf, gf)


def test_grouped_counts_contract():
    """The slots the grouped kernel visits: min(counts, cap) rounded up
    to a multiple of the group, at most cap; group 1 is the worklist
    kernel's min(counts, cap)."""
    counts = _t(np.array([0, 1, 4, 5, 9, 12, 40], np.int32))
    assert tdn._grouped_counts(counts, 10, 4).tolist() == [0, 4, 4, 8, 10,
                                                           10, 10]
    assert tdn._grouped_counts(counts, 10, 1).tolist() == [0, 1, 4, 5, 9,
                                                           10, 10]


@pytest.mark.parametrize("kw", [dict(expand_n=256, compact_n=1024),
                                dict(expand_n=0, compact_n=0),
                                dict(expand_n=0, compact_n=0,
                                     use_pallas_intersect=False)])
def test_finder_with_woop_accel_matches_jax(soup, kw):
    """find_closest_onehot with the Woop accel against the JAX finder with
    its 4-tuple, spheres included and 40% of the rays dead: the Woop
    branch wins over the per-ray-exact and dense-union branches, and
    use_pallas_intersect=False keeps the non-fused branch, as in JAX.
    Spheres and the hit set equal, t within T_RTOL/T_ATOL, faces equal
    but at near-ties (measured: equal faces on all 281 triangle hits,
    worst t 3.8e-6 absolute, 5.7e-6 on the non-fused branch)."""
    scene, _, accel, tscene, tacc = soup
    rng = np.random.default_rng(4)
    n = 3000                       # not a multiple of the padding chunk
    ro, rd = _rays(rng, n)
    active = rng.random(n) > 0.4
    ref = jax_find_onehot(scene, accel, jnp.asarray(ro), jnp.asarray(rd),
                          active=jnp.asarray(active), **kw)
    got = ttr.find_closest_onehot(tscene, _t(ro), _t(rd), _t(active),
                                  accel=tacc, **kw)
    rt, rtri, rsph = (np.asarray(x) for x in (ref.t, ref.tri, ref.sphere))
    gt, gtri, gsph = (x.numpy() for x in (got.t, got.tri, got.sphere))
    assert np.array_equal(gsph, rsph) and np.array_equal(gtri >= 0, rtri >= 0)
    assert (gtri >= 0).sum() > 250 and (gsph >= 0).sum() > 10
    np.testing.assert_allclose(gt, rt, rtol=T_RTOL, atol=T_ATOL)
    assert ((gtri == rtri) | np.isclose(gt, rt, rtol=1e-4, atol=1e-5)).all()
    assert (gtri[~active] == -1).all() and (gt[~active] == BIG).all()


@pytest.mark.parametrize("expand_n", [0, 256])
def test_woop_branch_dispatch(soup, expand_n):
    """With a Woop table in the accel and use_pallas_intersect set, the
    finder runs the mask-only walk and the Woop intersection once each
    and no other stage, whatever expand_n; make_finder passes the accel
    through."""
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.render.integrator import make_finder
    _, _, _, tscene, tacc = soup
    calls = []

    def counted(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    ops = ttr.FinderOps(*(counted(name, fn) for name, fn in
                          zip(ttr.FinderOps._fields, ttr.PLAIN)))
    ro, rd = _rays(np.random.default_rng(5), 512)
    ttr.find_closest_onehot(tscene, _t(ro), _t(rd), accel=tacc,
                            expand_n=expand_n, compact_n=0, ops=ops)
    assert calls == ["walk_mask", "intersect_woop"]
    cfg = RenderConfig(backend="onehot", onehot_expand=expand_n)
    finder = make_finder(tscene, cfg, tacc)
    assert finder.keywords["accel"].woop_cm is tacc.woop_cm


def test_woop_wrapper_checks(soup):
    """The wrappers check shapes and the group, as the other kernels'
    wrappers do."""
    _, _, _, _, tacc = soup
    ro, rd, _, union = _wave(soup, 6)
    t0 = torch.full((R,), BIG)
    with pytest.raises(ValueError):
        tdn.cluster_intersect_mask_woop(_t(union), tacc.woop_cm[:, :3],
                                        _t(ro), _t(rd), t0)
    with pytest.raises(ValueError):
        tdn.cluster_intersect_mask_woop(_t(union), tacc.woop_cm,
                                        _t(ro[:100]), _t(rd[:100]), t0[:100])
    wl = torch.zeros((R // tdn.TILE, 4), dtype=torch.int32)
    cnt = torch.zeros((R // tdn.TILE,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tdn.cluster_intersect_grouped(wl, cnt, tacc.clusters.tri_rows, _t(ro),
                                      _t(rd), t0, group=0)


@pytest.mark.parametrize("kernel", ["mask", "woop", "worklist"])
def test_union_wrappers_check_shared_memory(kernel):
    """The union kernels (the worklist kernel among them: the union
    template's worklist instance) stage two clusters and the tile's
    packed rays in shared memory: a leaf whose two clusters do not fit
    there is refused by the wrapper (on CPU tensors too, before the plain
    version runs), one that fits by a margin is taken."""
    ro = torch.zeros((tdn.TILE, 3))
    t0 = torch.full((tdn.TILE,), -BIG)
    union = torch.zeros((1, 1), dtype=torch.int32)
    fits = (tdn.SMEM_LIMIT - tdn.UNION_SMEM) // (2 * 48)
    for leaf, ok in ((fits, True), (fits + 1, False)):
        if kernel == "mask":
            table = torch.zeros((1, leaf, 12))
            fn = tdn.cluster_intersect_mask
        elif kernel == "worklist":
            table = torch.zeros((1, leaf, 12))
            counts = torch.ones((1,), dtype=torch.int32)

            def fn(union, table, ro, rd, t0, counts=counts):
                return tdn.cluster_intersect(union, counts, table, ro, rd, t0)
        else:
            table = torch.zeros((1, 4, 3 * leaf))
            fn = tdn.cluster_intersect_mask_woop
        if ok:
            t, f = fn(union, table, ro, ro, t0)
            assert torch.equal(t, t0) and bool((f == -1).all())
        else:
            with pytest.raises(ValueError):
                fn(union, table, ro, ro, t0)


def test_sweep_sets_constants():
    """`kernels.sweep` builds the Woop kernel's variants by setting named
    constants in one scope of its source: exactly those lines change, and
    a constant the scope lacks raises."""
    import os

    from raypt_torch.kernels import sweep
    from raypt_torch.kernels._build import CSRC_DIR
    with open(os.path.join(CSRC_DIR, "cluster_intersect.cu")) as f:
        src = f.read()
    for consts in sweep.WOOP_VARIANTS.values():
        out = sweep._set(src, "struct WoopTest {", consts)
        changed = [b for a, b in zip(src.splitlines(), out.splitlines())
                   if a != b]
        assert len(out.splitlines()) == len(src.splitlines())
        for line in changed:
            name, value = line.split("constexpr int ")[1].split(" = ")
            assert consts[name] == int(value.split(";")[0])
    with pytest.raises(ValueError):
        sweep._set(src, "struct WoopTest {", {"kNoSuchConstant": 1})


@pytest.mark.parametrize("kernel", ["worklist", "dense", "union", "compact",
                                    "uncompact", "cycle"])
def test_sweep_sets_constants_of(kernel):
    """The sweep's variants of the worklist kernel (struct MtTest), of
    closest_dense, the union walk, the compaction, the uncompaction and
    the regroup probes' cycle kernel (their designs' constants):
    each sets exactly the lines of its constants in its scope, and every
    variant differs from the package's setting."""
    import os
    import re

    from raypt_torch.kernels import sweep
    from raypt_torch.kernels._build import CSRC_DIR
    source, _, scope, variants = sweep.SWEPT[kernel]
    with open(os.path.join(CSRC_DIR, source)) as f:
        src = f.read()
    block = src[src.index(scope):src.index("\n\n", src.index(scope))]
    package = {k: int(v) for k, v in
               re.findall(r"constexpr int (\w+) = (\d+);", block)}
    assert variants
    for consts in variants.values():
        assert set(consts) == set(package) and consts != package
        out = sweep._set(src, scope, consts)
        changed = [b for a, b in zip(src.splitlines(), out.splitlines())
                   if a != b]
        assert len(out.splitlines()) == len(src.splitlines())
        assert len(changed) == sum(consts[k] != package[k] for k in consts)


def test_sweep_walk_designs():
    """Each walk design the sweep times is one instance of
    `csrc/walk_designs.cu`'s template, with a C entry point of its own,
    and the sources it builds are in the checkout."""
    import os
    import re

    from raypt_torch.kernels import sweep
    from raypt_torch.kernels._build import CSRC_DIR, KERNEL_HEADERS
    with open(os.path.join(CSRC_DIR, "walk_designs.cu")) as f:
        src = f.read()
    made = re.findall(r"^RK_WALK_DESIGN\((\w+), (\d+), (\d+), (\w+)\)$", src,
                      re.M)
    assert [m[0] for m in made] == list(sweep.WALK_DESIGNS)
    for name, rays, walks, packed in made:
        assert 1 <= int(walks) <= int(rays)
        assert packed == "true" or rays == walks
    for h in KERNEL_HEADERS:
        assert os.path.exists(os.path.join(CSRC_DIR, h))
