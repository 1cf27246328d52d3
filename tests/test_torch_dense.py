"""The `pallas`, `dense` and `bruteforce` backends of raypt_torch against
the JAX package, on seeded numpy inputs: the Woop table, the dense
closest hit (the JAX Pallas kernel in interpret mode and its XLA twin
against the port's plain version), the finders, `resolve_backend`, and the bench scene's render and loss
gradients through `backend="pallas"` and `"dense"`.

The finder comparisons feed both packages the JAX package's Woop table
(`woop_from_numpy`), so they measure only the intersection. The CUDA
kernel runs only on the card: test_torch_gpu.py and chip_smoke.py hold
it bitwise against the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import clusters as jcl
from raypt.accel import lbvh as jlbvh
from raypt.accel.dense import build_woop as jax_build_woop
from raypt.accel.dense import closest_dense as jax_closest_dense
from raypt.core.scene import MaterialDef, SceneBuilder
from raypt.core.types import RenderConfig as JaxConfig
from raypt.kernels.dense_pallas import pallas_closest_dense
from raypt.kernels.dense_pallas import pick_tri_chunk as jax_pick_tri_chunk
from raypt.kernels.dense_pallas import prepare_woop_mats as jax_prepare
from raypt.render import integrator as jint

from raypt_torch.accel.clusters import Clusters
from raypt_torch.accel.ctree import OnehotAccel
from raypt_torch.accel.dense import build_woop, woop_from_numpy
from raypt_torch.accel.lbvh import LBVH
from raypt_torch.core.math3d import BIG
from raypt_torch.core.types import RenderConfig, scene_from_numpy
from raypt_torch.kernels import dense_pallas as tdp
from raypt_torch.render import integrator as tint

from test_torch_integrator import OUTSIDE_VIEW, W, run_slice
from test_torch_scene import jax_leaves, jax_lbvh_to_port

torch.set_num_threads(2)

# t tolerances against XLA, which contracts multiply-adds where torch
# does not (in the table and in the six products): relative 1e-5, and
# absolute one float32 ulp of coordinates below 256 (1.5e-5)
T_RTOL, T_ATOL = 1e-5, 2.0 ** -16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _soup(rng, ntri=100, nsph=3, dup=(), degenerate=False):
    """Random triangles and spheres (tests/test_pallas.py's scene); each
    (src, dst, n) in dup makes triangles dst..dst+n-1 copies of
    src..src+n-1; with degenerate, triangle 20 has two equal corners."""
    b = SceneBuilder()
    m0 = b.add_material(MaterialDef(albedo=(0.5, 0.5, 0.5)))
    tris = []
    for _ in range(ntri):
        base = rng.uniform(-5, 5, 3)
        tris.append((base, base + rng.uniform(-1, 1, 3),
                     base + rng.uniform(-1, 1, 3)))
    for src, dst, n in dup:
        tris[dst:dst + n] = tris[src:src + n]
    if degenerate:
        tris[20] = (tris[20][0], tris[20][0], tris[20][1])
    for tri in tris:
        b.add_triangle(*tri, m0)
    for _ in range(nsph):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.3, 1.0), m0)
    return b.freeze()


def _rays(rng, n, scene=None, aim=0):
    """Rays from around the soup in random directions; with aim > 0 the
    first n // 2 start 0.02 off the centroid of one of triangles
    0..aim-1, on either side, and point straight at it."""
    ro = rng.uniform(-6, 6, (n, 3))
    rd = rng.normal(size=(n, 3))
    if aim:
        p = np.asarray(scene.mesh.positions)[
            np.asarray(scene.mesh.faces)[rng.integers(0, aim, n // 2)]]
        nrm = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        nrm *= rng.choice([-1.0, 1.0], (n // 2, 1)) / np.linalg.norm(
            nrm, axis=1, keepdims=True)
        ro[:n // 2] = p.mean(axis=1) + 0.02 * nrm
        rd[:n // 2] = -nrm
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def _port(scene, woop):
    """The port's copy of a JAX scene and of its JAX Woop table."""
    return (scene_from_numpy(jax_leaves(scene), "cpu"),
            woop_from_numpy(woop.m, woop.c, woop.valid, "cpu"))


@pytest.mark.parametrize("which", ["soup", "bunny"])
def test_build_woop_close(which):
    """The port's host-built table against the JAX build_woop: valid
    equal; m within 1e-6 and c within 1e-5 of each triangle's largest
    entry (measured worst: m 3.2e-7, c 1.8e-6 of it). XLA contracts the
    cross products' multiply-adds, so the tables agree bitwise on only
    ~5-10% of the triangles. The determinant is not the cause of a
    difference: JAX's `jnp.linalg.det` takes 3x3 matrices by a closed
    form, not an LU factorisation, and neither that form in numpy nor
    numpy's LU `det` is bitwise equal to it (measured on the bunny:
    64% and 59% of the faces)."""
    from raypt.scenes import builtin as jax_scenes
    scene = (_soup(np.random.default_rng(1)) if which == "soup"
             else jax_scenes.stanford_bunny().freeze())
    m = scene.mesh
    ref = jax_build_woop(m.positions, m.faces, m.face_valid)
    got = build_woop(np.asarray(m.positions), np.asarray(m.faces),
                     np.asarray(m.face_valid))
    valid = np.asarray(ref.valid)
    assert np.array_equal(got.valid.numpy(), valid) and valid.sum() >= 100
    for g, r, tol in ((got.m.numpy(), np.asarray(ref.m), 1e-6),
                      (got.c.numpy(), np.asarray(ref.c), 1e-5)):
        axes = tuple(range(1, r.ndim))
        scale = np.abs(r).max(axis=axes)
        err = np.abs(g - r).max(axis=axes)
        assert (err[valid] <= tol * scale[valid]).all(), \
            (err[valid] / scale[valid]).max()
        assert not g[~valid].any()


def test_prepare_woop_mats_and_tri_chunk_exact():
    """pick_tri_chunk as tests/test_pallas.py holds it, and the six
    padded matrices bitwise equal to the JAX package's for the same
    table, padded or not."""
    for t, want in ((16, 256), (256, 256), (257, 512), (100000, 2048)):
        assert tdp.pick_tri_chunk(t) == jax_pick_tri_chunk(t) == want
    scene = _soup(np.random.default_rng(2), ntri=300)
    m = scene.mesh
    jw = jax_build_woop(m.positions, m.faces, m.face_valid)
    _, tw = _port(scene, jw)
    for chunk in (256, 384, 2048):
        for g, r in zip(tdp.prepare_woop_mats(tw, chunk),
                        jax_prepare(jw, chunk)):
            assert g.shape == r.shape and g.is_contiguous()
            assert np.array_equal(g.numpy().view(np.int32),
                                  np.asarray(r).view(np.int32))


def _all_pairs_t(woop, ro, rd):
    """numpy (R, T) hit distances of every pair (inf on a miss), for the
    runner-up test."""
    m, c = np.asarray(woop.m, np.float64), np.asarray(woop.c, np.float64)
    op = np.einsum("tij,rj->rti", m, ro) + c[None]
    dp = np.einsum("tij,rj->rti", m, rd)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -op[..., 2] / dp[..., 2]
        u = op[..., 0] + t * dp[..., 0]
        v = op[..., 1] + t * dp[..., 1]
        hit = ((np.abs(dp[..., 2]) > 1e-12) & (u >= 0) & (v >= 0)
               & (u + v <= 1) & (t > 0))
    return np.where(hit, t, np.inf)


def _faces_agree(got_f, ref_f, ref_t, pair_t):
    """Faces equal wherever the runner-up hit (the smallest t of another
    face) is not within tolerance of the winner's t."""
    r = np.arange(len(ref_f))
    others = pair_t.copy()
    others[r[ref_f >= 0], ref_f[ref_f >= 0]] = np.inf
    runner = others.min(axis=1)
    clear = np.abs(runner - ref_t) > T_RTOL * np.abs(ref_t) + T_ATOL
    assert np.array_equal(got_f[clear], ref_f[clear]), \
        np.nonzero(got_f[clear] != ref_f[clear])
    return clear


def _zero_maps(jw):
    """The JAX table with zero maps, some of them -0.0, written over every
    9th triangle, among the real ones; returns (the table, the indices
    whose maps are zero: those and the degenerate faces, which
    build_woop gives zero maps)."""
    m, c = np.array(jw.m), np.array(jw.c)
    zero = np.arange(4, m.shape[0] - 1, 9)
    m[zero], c[zero] = 0.0, 0.0
    neg = zero[::2]
    m[neg], c[neg] = -0.0, -0.0
    degenerate = np.nonzero(~np.abs(np.array(jw.m)).any(axis=(1, 2)))[0]
    assert degenerate.size, "the soup needs a degenerate face"
    return (type(jw)(m=jnp.asarray(m), c=jnp.asarray(c), valid=jw.valid),
            np.union1d(zero, degenerate))


@pytest.mark.parametrize("which", ["soup", "ties", "zero_maps"])
def test_closest_dense_matches_jax(which):
    """closest_dense_plain (the CUDA kernel's plain version, which the
    `dense` and `pallas` backends run) and the JAX closest_dense (XLA
    products) against pallas_closest_dense(interpret), all fed the JAX
    table; 512 rays, t0 BIG or a random bound. t within T_RTOL/T_ATOL of
    the Pallas kernel's (measured worst: the plain version 1.8e-6
    absolute, 5.2e-5 relative at t = 0.02), faces equal wherever the
    runner-up is not within that tolerance (measured: equal on every
    ray). "ties": 2,100 triangles in a 4,096 table
    (two 2,048 chunks) where triangles 2,048-2,099 copy 0-51 (a tie
    across chunks) and 1,000-1,051 copy 52-103 (a tie within a chunk),
    half the rays aimed at them: the lowest id wins, so no ray's face is
    a copy, in every version. "zero_maps": a face with two equal corners
    (a zero map) and zero maps (+0.0 and -0.0) over every 9th slot of the
    table, among the 300 real triangles as well as in the mesh's padding
    (the CUDA kernel never tests a triangle with a zero ww row); and rays
    whose t0 is -BIG, nan or 1e-6 (below every hit), which keep it with
    face -1 in every version (measured: faces equal on every ray, t
    within 1.4e-6 absolute, 2.9e-5 relative, of the Pallas kernel's)."""
    rng = np.random.default_rng(3)
    if which == "ties":
        scene = _soup(rng, ntri=2100, nsph=0,
                      dup=((0, 2048, 52), (52, 1000, 52)))
        ro, rd = _rays(rng, 512, scene, aim=104)
    else:
        scene = _soup(rng, ntri=300, degenerate=which == "zero_maps")
        ro, rd = _rays(rng, 512, scene, aim=300)
    t0 = np.where(rng.random(512) < 0.5, BIG, rng.random(512) * 8.0
                  ).astype(np.float32)
    m = scene.mesh
    jw = jax_build_woop(m.positions, m.faces, m.face_valid)
    fixed = np.zeros(512, bool)
    if which == "zero_maps":
        jw, zero = _zero_maps(jw)
        fixed[np.arange(0, 480, 5)] = True
        t0[fixed] = np.resize(np.array([-BIG, np.nan, 1e-6], np.float32), 96)
    _, tw = _port(scene, jw)
    chunk = tdp.pick_tri_chunk(tw.num_tris)
    jmats = jax_prepare(jw, chunk)
    rt, rf = (np.asarray(x) for x in pallas_closest_dense(
        *jmats, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t0),
        interpret=True, tri_chunk=chunk))
    xt, xf = (np.asarray(x) for x in jax_closest_dense(
        jw, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t0)))
    pair_t = _all_pairs_t(jw, ro, rd)
    assert (rf >= 0).sum() > 100
    versions = {
        "plain": tdp.closest_dense(*tdp.prepare_woop_mats(tw, chunk), _t(ro),
                                   _t(rd), _t(t0), tri_chunk=chunk),
        "jax xla": (xt, xf)}
    for name, (gt, gf) in versions.items():
        gt, gf = np.asarray(gt), np.asarray(gf)
        np.testing.assert_allclose(gt, rt, rtol=T_RTOL, atol=T_ATOL,
                                   err_msg=name)
        clear = _faces_agree(gf, rf, rt, pair_t)
        if which == "zero_maps":
            assert np.array_equal(gt[fixed].view(np.int32),
                                  t0[fixed].view(np.int32)), name
            assert (gf[fixed] == -1).all() and not np.isin(gf, zero).any()
            assert clear[~fixed].mean() > 0.95, name
        elif which == "soup":
            assert clear.mean() > 0.95, name
        else:   # the copies tie exactly, so they are not clear
            copies = ((gf >= 1000) & (gf < 1052)) | (gf >= 2048)
            assert not copies.any() and not (rf >= 2048).any(), name
            assert ((gf >= 0) & (gf < 104)).sum() > 100, name


@pytest.mark.parametrize("backend", ["pallas", "dense", "bruteforce"])
def test_finders_match_jax(backend):
    """make_finder(backend) against the JAX package's on a random soup
    with spheres (1,000 rays, padded inside; the JAX Pallas kernel in
    interpret mode), both given the JAX table where they take one:
    spheres equal, t within T_RTOL/T_ATOL (measured worst: pallas and
    dense, the port's one finder, 3.3e-6 absolute, 3.4e-5 relative at
    t = 0.02; bruteforce 1.9e-6), faces equal except at near-ties (t
    within tolerance; measured: equal on every ray)."""
    rng = np.random.default_rng(4)
    scene = _soup(rng, ntri=200, nsph=6)
    ro, rd = _rays(rng, 1000, scene, aim=200)
    m = scene.mesh
    jw = jax_build_woop(m.positions, m.faces, m.face_valid)
    tscene, tw = _port(scene, jw)
    accel = None if backend == "bruteforce" else jw
    ref = jint.make_finder(scene, JaxConfig(backend=backend), accel)(
        scene, jnp.asarray(ro), jnp.asarray(rd))
    got = tint.make_finder(tscene, RenderConfig(backend=backend),
                           None if accel is None else tw)(
        tscene, _t(ro), _t(rd), active=torch.ones(1000, dtype=torch.bool))
    rt, rtri, rsph = (np.asarray(x) for x in (ref.t, ref.tri, ref.sphere))
    assert (rtri >= 0).sum() > 300 and (rsph >= 0).sum() > 5
    assert np.array_equal(got.sphere.numpy(), rsph)
    np.testing.assert_allclose(got.t.numpy(), rt, rtol=T_RTOL, atol=T_ATOL)
    same = got.tri.numpy() == rtri
    assert (same | np.isclose(got.t.numpy(), rt, rtol=T_RTOL,
                              atol=T_ATOL)).all()
    assert same.mean() > 0.99


def test_resolve_backend_matches_jax():
    """resolve_backend returns the JAX package's string for the same
    scene and accel: a WoopTris -> "dense", an LBVH -> "bvh", and with
    no accel (or an accel "auto" does not name) the padded face capacity
    decides, at the 63/64 and 8,192/8,193 edges; other backends pass
    through."""
    scene = _soup(np.random.default_rng(5), ntri=40, nsph=1)
    tscene = scene_from_numpy(jax_leaves(scene), "cpu")
    m = scene.mesh
    jw = jax_build_woop(m.positions, m.faces, m.face_valid)
    # only the accel's type is read: trees and onehot accels of no size
    zeros = [np.zeros((1,), np.int32)] * 5
    jbvh = jlbvh.LBVH(*zeros)
    jon = (jcl.Clusters(*zeros[:4]), zeros[0])
    ton = OnehotAccel(clusters=Clusters(*map(torch.from_numpy, zeros[:4])),
                      table=torch.zeros((1, 16), dtype=torch.bfloat16))
    accels = [(None, None), (jw, _port(scene, jw)[1]),
              (jbvh, jax_lbvh_to_port(jbvh)), (jon, ton)]
    seen = set()
    for n_faces in (8, 63, 64, 65, 8192, 8193, 16384):
        js = scene.replace(mesh=scene.mesh.replace(
            faces=jnp.zeros((n_faces, 3), jnp.int32)))
        ts = tscene.replace(mesh=tscene.mesh.replace(
            faces=torch.zeros((n_faces, 3), dtype=torch.int32)))
        for ja, ta in accels:
            for backend in ("auto", "pallas", "cluster"):
                want = jint.resolve_backend(js, JaxConfig(backend=backend), ja)
                got = tint.resolve_backend(ts, RenderConfig(backend=backend),
                                           ta)
                assert got == want, (n_faces, backend, type(ta), got, want)
                seen.add(got)
    assert {"dense", "bvh", "bruteforce"} <= seen


PATHS = {b: dict(width=W, height=W, samples_per_pixel=1, num_bounces=4,
                 russian_roulette=True, backend=b)
         for b in ("pallas", "dense")}


@pytest.fixture(scope="module", params=sorted(PATHS))
def bench_run(request):
    return run_slice(cfg_kw=PATHS[request.param])


@pytest.fixture(scope="module", params=sorted(PATHS))
def outside_run(request):
    return run_slice(OUTSIDE_VIEW, cfg_kw=PATHS[request.param])


def test_bench_render_and_grads_match_jax(bench_run):
    """The bench scene at 32x32 through backend "pallas" and "dense", the
    JAX table in both packages: traced counts equal; image allclose at
    rtol 1e-4, atol 1e-5 on every pixel (measured: bitwise equal on both
    paths); loss rtol 1e-6, albedo grads within 1e-5 of their largest
    magnitude (measured: 9.9e-8 and 1.7e-7), position grads atol 1e-9 (0
    in both from the bench camera, inside the stand-in bunny)."""
    jl, jimg, jtr, jgv, jga = bench_run["jax"]
    tl, img, tr, tgv, tga = bench_run["torch"]
    assert np.array_equal(tr, jtr) and tr[0] == W * W
    assert img.shape == (W, W, 3) and np.isfinite(img).all()
    off = ~np.isclose(img, jimg, rtol=1e-4, atol=1e-5)
    assert off.mean() == 0.0, (off.mean(), np.abs(img - jimg).max())
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert np.abs(jga).max() > 0
    assert np.abs(tga - jga).max() <= 1e-5 * np.abs(jga).max()
    np.testing.assert_allclose(tgv, jgv, atol=1e-9)


def test_position_grads_match_jax(outside_run):
    """From OUTSIDE_VIEW, where the gradient w.r.t. positions is not 0:
    nonzero on the same vertices in both packages (at least 100) and
    within 1e-4 of its largest magnitude; loss and albedo grads as above.
    Measured on both paths: 312 vertex rows, worst 6.1e-6 of the
    largest; loss 8.0e-7, albedo 1.0e-6 (the image differs by 2.4e-7 at
    most)."""
    jl, _, jtr, jgv, jga = outside_run["jax"]
    tl, img, tr, tgv, tga = outside_run["torch"]
    assert np.array_equal(tr, jtr) and jtr[1] > 0
    assert np.isfinite(img).all()
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert np.abs(tga - jga).max() <= 1e-5 * np.abs(jga).max()
    big = np.abs(jgv).max()
    assert big > 0 and (np.abs(jgv).sum(axis=1) > 0).sum() >= 100
    assert np.array_equal(np.abs(tgv).sum(axis=1) > 0,
                          np.abs(jgv).sum(axis=1) > 0)
    assert np.abs(tgv - jgv).max() <= 1e-4 * big, np.abs(tgv - jgv).max() / big


def test_make_finder_builds_the_table(bench_run):
    """Without a WoopTris, make_finder builds the table from the scene on
    the host (any other accel is ignored, as in the JAX package); its
    render is allclose to the one through the JAX table (rtol 1e-4, atol
    1e-5; measured: bitwise equal)."""
    scene, cfg, skey = bench_run["scene"], bench_run["cfg"], bench_run["skey"]
    with torch.no_grad():
        img = tint.render_sample(scene, cfg, skey, tint.make_finder(scene, cfg))
        other = tint.render_sample(scene, cfg, skey, tint.make_finder(
            scene, cfg, LBVH(*[np.zeros(1)] * 5)))
    assert torch.equal(img, other)
    np.testing.assert_allclose(img.numpy(), bench_run["torch"][1], rtol=1e-4,
                               atol=1e-5)
