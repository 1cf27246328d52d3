"""raypt_torch's packed `bvh` backend against the JAX package: the plain
skip-link walk, the packed finder under its scheduling settings, the
unpacked reference walk, the `make_finder` routes that build an LBVH,
and the CLI's default scene end to end (cornell_box_with_bunny, 32x32,
1 spp, 2 bounces, backend "bvh"). The walks run on one tree, the JAX
package's build of the scene carried across (`ctree.packed_from_numpy`,
`lbvh_from_numpy`), so they are compared independently of the build."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import lbvh as jlbvh
from raypt.accel import packed as jpacked
from raypt.accel import traverse as jtrav
from raypt.core.types import RenderConfig as JaxConfig
from raypt.render import integrator as jint
from raypt.rng import frame_key, sample_key
from raypt.scenes import builtin as jax_scenes

from raypt_torch.accel import traverse as ttrav
from raypt_torch.accel.ctree import (OnehotAccel, build_onehot,
                                     lbvh_from_numpy, packed_from_numpy,
                                     table_bits)
from raypt_torch.accel.clusters import CLUSTER_LEAF, Clusters, build_clusters
from raypt_torch.accel.packed import PackedLBVH, traverse_wavefront
from raypt_torch.core.scene import MaterialDef, SceneBuilder
from raypt_torch.core.types import RenderConfig, scene_from_numpy
from raypt_torch.render import integrator as tint
from raypt_torch.rng import sampler as trng

from test_torch_scene import jax_leaves

torch.set_num_threads(2)

W = 32
RAYS = 2048
FIELDS = ("left", "skip", "bmin", "bmax", "leaf_face")
# the plain walk's t against JAX's: XLA sums the three products of a dot
# in its own order, so t may differ in the last bits (measured worst
# 3.1e-7 relative on this wavefront, faces all equal)
T_RTOL = 1e-6


@pytest.fixture(scope="module")
def box():
    """The CLI's default scene at 32x32 in both packages (4,096 vertex
    and 8,192 face slots), the JAX package's LBVH and packed table, and
    their copies in the port."""
    b = jax_scenes.cornell_box_with_bunny()
    b.camera.viewport_width = b.camera.viewport_height = W
    jscene = b.freeze()
    m = jscene.mesh
    jbvh = jlbvh.build(m.positions, m.faces, m.face_valid)
    jpb = jpacked.pack(jbvh, m.positions, m.faces, m.face_valid)
    return dict(jscene=jscene, jbvh=jbvh, jpb=jpb,
                scene=scene_from_numpy(jax_leaves(jscene), "cpu"),
                bvh=lbvh_from_numpy(*(getattr(jbvh, k) for k in FIELDS)),
                pb=packed_from_numpy(jpb.rows, "cpu"))


@pytest.fixture(scope="module")
def rays(box):
    """A seeded wavefront in and around the box: random origins and
    directions, a fifth of the rays dead, t0 from the sphere pass (239
    rays start with a sphere hit)."""
    rng = np.random.default_rng(0)
    ro = rng.uniform([-12, -12, 0], [12, 12, 24], (RAYS, 3)).astype(np.float32)
    rd = rng.normal(size=(RAYS, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    active = rng.uniform(size=RAYS) < 0.8
    t0 = ttrav._closest_sphere(box["scene"], torch.from_numpy(ro),
                               torch.from_numpy(rd))[0].numpy()
    return ro, rd, t0, active


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _hits_close(got_t, got_f, ref_t, ref_f):
    """Equal faces, t within T_RTOL."""
    assert np.array_equal(got_f, ref_f)
    np.testing.assert_allclose(got_t, ref_t, rtol=T_RTOL)


def test_walk_matches_jax(box, rays):
    """The plain walk against JAX's traverse_wavefront on one carried
    tree: live rays hit the same faces (no near-tie on this wavefront;
    1,455 hits), t within T_RTOL; dead rays keep t0 and face -1, bitwise;
    sphere-seeded rays take a triangle only when strictly nearer."""
    ro, rd, t0, active = rays
    jt, jf = jpacked.traverse_wavefront(box["jpb"], *(jnp.asarray(x) for x in
                                                      (ro, rd, t0, active)))
    pt, pf = traverse_wavefront(box["pb"], *_t(ro, rd, t0, active))
    pt, pf = pt.numpy(), pf.numpy()
    _hits_close(pt, pf, np.asarray(jt), np.asarray(jf))
    assert np.array_equal(pt[~active].view(np.int32), t0[~active].view(np.int32))
    assert (pf[~active] == -1).all() and (pf[active] >= 0).sum() > 1000
    seeded = active & (t0 < 1e30)
    assert seeded.any() and (pt[seeded] <= t0[seeded]).all()
    assert (pt[seeded & (pf >= 0)] < t0[seeded & (pf >= 0)]).all()


@pytest.mark.parametrize("max_iters,unroll", [(None, 1), (None, 3), (2, 4),
                                              (0, 8)])
def test_walk_unroll_and_max_iters(box, rays, max_iters, unroll):
    """unroll changes no result; max_iters cuts each walk after
    max_iters * unroll steps, as in the JAX package (bitwise faces and
    the same t to T_RTOL; the cut walks end early, so fewer hits)."""
    ro, rd, t0, active = rays
    full = traverse_wavefront(box["pb"], *_t(ro, rd, t0, active))
    pt, pf = traverse_wavefront(box["pb"], *_t(ro, rd, t0, active),
                                max_iters=max_iters, unroll=unroll)
    if max_iters is None:
        assert torch.equal(pt.view(torch.int32), full[0].view(torch.int32))
        assert torch.equal(pf, full[1])
        return
    jt, jf = jpacked.traverse_wavefront(
        box["jpb"], *(jnp.asarray(x) for x in (ro, rd, t0, active)),
        max_iters=max_iters, unroll=unroll)
    _hits_close(pt.numpy(), pf.numpy(), np.asarray(jt), np.asarray(jf))
    assert int((pf >= 0).sum()) < int((full[1] >= 0).sum())


@pytest.mark.parametrize("tile,sort_rays", [(0, False), (0, True),
                                            (256, False), (256, True)])
def test_find_closest_packed(box, rays, tile, sort_rays):
    """find_closest_packed: bitwise the same HitIds under every tile and
    sort_rays setting (rays are independent; the port walks the whole
    wavefront in one call), close to JAX's at the same setting."""
    ro, rd, _, active = rays
    scene, args = box["scene"], _t(ro, rd)
    got = ttrav.find_closest_packed(scene, box["pb"], *args,
                                    torch.from_numpy(active), tile=tile,
                                    sort_rays=sort_rays)
    base = ttrav.find_closest_packed(scene, box["pb"], *args,
                                     torch.from_numpy(active))
    for k in ("t", "tri", "sphere"):
        a, b = getattr(got, k), getattr(base, k)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
    ref = jtrav.find_closest_packed(box["jscene"], box["jpb"], jnp.asarray(ro),
                                    jnp.asarray(rd), jnp.asarray(active),
                                    tile=tile, sort_rays=sort_rays)
    _hits_close(got.t.numpy(), got.tri.numpy(), np.asarray(ref.t),
                np.asarray(ref.tri))
    assert np.array_equal(got.sphere.numpy(), np.asarray(ref.sphere))


def test_sort_wavefront(rays):
    """sort_wavefront: the JAX package's permutation and inverse."""
    _, rd, _, active = rays
    order, inv = ttrav.sort_wavefront(*_t(rd, active))
    jorder, jinv = jtrav.sort_wavefront(jnp.asarray(rd), jnp.asarray(active))
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    assert np.array_equal(inv.numpy(), np.asarray(jinv))


def test_find_closest_bvh(box, rays):
    """The unpacked reference walk against JAX's find_closest_bvh: same
    faces, t to T_RTOL."""
    ro, rd, _, _ = rays
    got = ttrav.find_closest_bvh(box["scene"], box["bvh"], *_t(ro, rd))
    ref = jtrav.find_closest_bvh(box["jscene"], box["jbvh"], jnp.asarray(ro),
                                 jnp.asarray(rd))
    _hits_close(got.t.numpy(), got.tri.numpy(), np.asarray(ref.t),
                np.asarray(ref.tri))
    assert np.array_equal(got.sphere.numpy(), np.asarray(ref.sphere))
    assert (got.tri >= 0).sum() > 1000


def _wavy_grid(n):
    """An n x n height-field grid (2 n^2 triangles) above a ground quad:
    no two triangles coplanar, so a random ray has no near-tie."""
    b = SceneBuilder()
    x, z = np.meshgrid(np.linspace(-4, 4, n + 1), np.linspace(-8, 0, n + 1))
    y = 0.3 * np.sin(3 * x) * np.cos(2 * z)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    k = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    faces = np.concatenate([np.stack([k, k + 1, k + n + 2], -1),
                            np.stack([k, k + n + 2, k + n + 1], -1)])
    b.add_mesh(pos, np.tile([[0, 1, 0]], (len(pos), 1)).astype(np.float32),
               faces.reshape(-1, 3), material=b.add_material(
                   MaterialDef(albedo=(0.5, 0.5, 0.5))))
    b.add_sphere((0, 2, -4), 0.5, b.add_material(MaterialDef(
        emissive=(1, 1, 1))))
    return b.freeze("cpu")


def test_make_finder_routes(box):
    """auto with an LBVH or a PackedLBVH, and auto on a mesh of more
    than 8,192 faces without an accel, resolve to "bvh"; the auto
    finder there builds its own LBVH and gives the brute-force oracle's
    faces; bvh and bvh2 take either container."""
    scene, cfg = box["scene"], RenderConfig(width=W, height=W)
    for acc in (box["bvh"], box["pb"]):
        assert tint.resolve_backend(scene, cfg, acc) == "bvh"
    grid = _wavy_grid(65)       # 8,450 triangles, 16,384 slots
    assert grid.mesh.num_faces > 8192
    assert tint.resolve_backend(grid, cfg) == "bvh"
    rng = np.random.default_rng(3)
    ro = torch.from_numpy(rng.uniform([-4, 1, -8], [4, 3, 0], (256, 3))
                          .astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    rd = rd / rd.norm(dim=1, keepdim=True)
    got = tint.make_finder(grid, cfg)(grid, ro, rd)
    ref = ttrav.find_closest_bruteforce(grid, ro, rd)
    assert torch.equal(got.tri, ref.tri) and int((got.tri >= 0).sum()) > 50
    assert torch.equal(got.sphere, ref.sphere)
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=T_RTOL)
    ro3, rd3 = (x.reshape(16, 16, 3) for x in (ro, rd))
    for backend in ("bvh", "bvh2"):
        for acc in (box["bvh"], box["pb"]):
            f = tint.make_finder(scene, cfg.replace(backend=backend), acc)
            assert isinstance(f.args[0], PackedLBVH)
            assert torch.equal(f.args[0].rows.view(torch.int32),
                               box["pb"].rows.view(torch.int32))
    assert f(scene, ro3, rd3).t.shape == (16, 16)


@pytest.mark.parametrize("backend", ["onehot", "cluster"])
def test_implicit_build_matches_jax(box, backend):
    """onehot and cluster without an accel build the LBVH themselves:
    the accel equals the JAX package's implicit build (lbvh.build, then
    build_onehot at cfg.onehot_leaf / build_clusters at CLUSTER_LEAF)
    bitwise, so the port's finders take the JAX package's hits."""
    from raypt.accel.clusters import build_clusters as jax_build_clusters
    from raypt.accel.ctree import build_onehot as jax_build_onehot
    scene, jm = box["scene"], box["jscene"].mesh
    cfg = RenderConfig(width=W, height=W, backend=backend, onehot_leaf=64)
    finder = tint.make_finder(scene, cfg)
    if backend == "onehot":
        acc = finder.keywords["accel"]
        assert isinstance(acc, OnehotAccel)
        ref = jax_build_onehot(box["jbvh"], jm.positions, jm.faces,
                               jm.face_valid, leaf=64)
        assert np.array_equal(table_bits(acc.table), np.asarray(
            jax.lax.bitcast_convert_type(ref[1], jnp.uint16)))
        clusters, ref_cl = acc.clusters, ref[0]
    else:
        clusters = finder.args[0]
        assert isinstance(clusters, Clusters)
        ref_cl = jax_build_clusters(box["jbvh"], jm.positions, jm.faces,
                                    jm.face_valid, leaf=CLUSTER_LEAF)
    for k in ("tri_rows", "bmin", "bmax", "valid"):
        a = getattr(clusters, k).numpy()
        assert np.array_equal(a.view(np.uint8),
                              np.asarray(getattr(ref_cl, k)).view(np.uint8)), k
    m = scene.mesh
    built = (build_onehot(box["bvh"], m.positions, m.faces, m.face_valid, 64)
             if backend == "onehot" else
             build_clusters(box["bvh"], m.positions, m.faces, m.face_valid,
                            CLUSTER_LEAF))
    rows = built.clusters.tri_rows if backend == "onehot" else built.tri_rows
    assert torch.equal(rows.view(torch.int32),
                       clusters.tri_rows.view(torch.int32))


def test_unported_layouts_raise(box):
    """The layouts and modes that raised until they were ported now
    route: every leaf_tris / node_lookahead combination packs its table
    type from the LBVH (bvh and bvh2; a packed table of any layout is
    walked as it is, under bvh4 too; "auto" resolves only a PackedLBVH
    to bvh, as in the JAX package), the finder runs in the mode and,
    on the CPU, gives the tiled one-triangle finder's faces where t does
    not tie; the kernel ops pick the layout's wrapper. A wrong accel type
    still raises TypeError, in make_finder and in find_closest_packed;
    bvh4 with an LBVH makes the wide finder (tests/test_torch_wide.py).
    In each traversal_mode."""
    for mode in ("tiled", "compact", "unrolled"):
        _routes(box, mode)


def _routes(box, mode):
    from raypt_torch.accel.packed import (Packed2LBVH, Packed4LBVH,
                                          PackedLALBVH)
    from raypt_torch.kernels import packed_walk as tpw
    scene = box["scene"]
    cfg = RenderConfig(width=W, height=W, backend="bvh", traversal_mode=mode)
    assert tint.make_finder(scene, cfg.replace(backend="bvh4"),
                            box["bvh"]).func is tint._wide_finder
    rng = np.random.default_rng(4)
    ro = torch.from_numpy(rng.uniform(-10, 10, (512, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32))
    rd = rd / rd.norm(dim=1, keepdim=True)
    ref = tint.make_finder(scene, cfg.replace(traversal_mode="tiled"),
                           box["bvh"])(scene, ro, rd)
    routes = {(1, False): (PackedLBVH, "packed_walk"),
              (1, True): (PackedLALBVH, "packed_walk_la"),
              (2, False): (Packed2LBVH, "packed_walk2"),
              (2, True): (Packed2LBVH, "packed_walk2"),
              (3, True): (Packed2LBVH, "packed_walk2"),
              (4, False): (Packed4LBVH, "packed_walk4"),
              (4, True): (Packed4LBVH, "packed_walk4_la"),
              (8, False): (Packed4LBVH, "packed_walk4")}
    for (leaf_tris, la), (kind, wrapper) in routes.items():
        c = cfg.replace(leaf_tris=leaf_tris, node_lookahead=la)
        for backend in ("bvh", "bvh2"):
            f = tint.make_finder(scene, c.replace(backend=backend), box["bvh"])
            assert f.func is tint._packed_finder and f.args[3] == mode
            table = f.args[0]
            assert type(table) is kind and tpw.wrapper_of(table).__name__ \
                == wrapper
            assert getattr(table, "lookahead", la) == la
        for backend in ("bvh2", "bvh4"):
            again = tint.make_finder(scene, c.replace(backend=backend),
                                     table)
            assert again.func is tint._packed_finder and \
                type(again.args[0]) is kind
            assert again.args[0].rows is table.rows
        got = f(scene, ro, rd)
        assert torch.equal(got.sphere, ref.sphere)
        assert ((got.tri == ref.tri).numpy()
                | np.isclose(got.t.numpy(), ref.t.numpy(), rtol=1e-6)).all()
    for bad in (object(), box["bvh"].tensors("cpu")):
        with pytest.raises(TypeError):
            tint.make_finder(scene, cfg, bad)
    with pytest.raises(TypeError):
        ttrav.find_closest_packed(scene, box["bvh"], ro, rd, mode=mode)


@pytest.fixture(scope="module")
def slice_run(box):
    """The bench loss (mean image) of the CLI scene with backend "bvh"
    and its gradients w.r.t. positions and albedo, in both packages: the
    JAX package from its own LBVH, the port building its own in
    make_finder."""
    jscene = box["jscene"]
    kw = dict(width=W, height=W, samples_per_pixel=1, num_bounces=2,
              backend="bvh")
    jcfg = JaxConfig(**kw)
    skey = sample_key(frame_key(jax.random.key(0), 0), 0)

    def loss(v, a):
        s = jscene.replace(mesh=jscene.mesh.replace(positions=v),
                           materials=jscene.materials.replace(albedo=a))
        img, tr = jint.render_sample(s, jcfg, skey,
                                     jint.make_finder(s, jcfg, box["jbvh"]),
                                     return_alive=True)
        return jnp.mean(img), (img, tr)

    (jl, (jimg, jtr)), jg = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(
        jscene.mesh.positions, jscene.materials.albedo)

    tscene = box["scene"]
    v = tscene.mesh.positions.clone().requires_grad_(True)
    a = tscene.materials.albedo.clone().requires_grad_(True)
    s = tscene.replace(mesh=tscene.mesh.replace(positions=v),
                       materials=tscene.materials.replace(albedo=a))
    cfg = RenderConfig(**kw)
    finder = tint.make_finder(s, cfg)
    img, tr = tint.render_sample(s, cfg, trng.sample_key(trng.frame_key(
        trng.key(0), 0), 0), finder, return_alive=True)
    img.mean().backward()
    return dict(jax=(float(jl), np.asarray(jimg), np.asarray(jtr),
                     np.asarray(jg[0]), np.asarray(jg[1])),
                torch=(float(img.mean().detach()), img.detach().numpy(),
                       tr.numpy(), v.grad.numpy(), a.grad.numpy()),
                finder=finder)


def test_slice_image_matches_jax(slice_run, box):
    """Image allclose at rtol 1e-4, atol 1e-5 with no pixel off
    (test_torch_slice2's tolerance), equal traced counts; the port's
    implicit build is the JAX tree bitwise."""
    _, jimg, jtr, _, _ = slice_run["jax"]
    _, img, tr, _, _ = slice_run["torch"]
    assert img.shape == jimg.shape == (W, W, 3) and np.isfinite(img).all()
    off = ~np.isclose(img, jimg, rtol=1e-4, atol=1e-5)
    assert off.mean() == 0.0, (off.mean(), np.abs(img - jimg).max())
    assert np.array_equal(tr, jtr) and tr[0] == W * W
    assert torch.equal(slice_run["finder"].args[0].rows.view(torch.int32),
                       box["pb"].rows.view(torch.int32))


def test_slice_grads_match_jax(slice_run):
    """Loss rtol 1e-6, albedo grads within 1e-5 of their largest
    magnitude, position grads atol 1e-9 (test_torch_slice2's tolerances
    from the bench view). The position grads are 0 in both packages
    here: the stand-in bunny, an icosphere of radius 150, encloses the
    box and the camera, so no path reaches the sky, and the radiance
    (emission times albedo products) does not depend on where a ray
    hits; test_torch_slice2 holds nonzero position grads from outside
    the mesh."""
    jl, _, _, jgv, jga = slice_run["jax"]
    tl, _, _, tgv, tga = slice_run["torch"]
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert np.abs(jga).max() > 0
    assert np.abs(tga - jga).max() <= 1e-5 * np.abs(jga).max()
    np.testing.assert_allclose(tgv, jgv, atol=1e-9)
