"""raypt_torch's differentiable hit recompute (`accel.traverse.
recompute_hit`) and primary-hit AOVs (`render.render_aovs`) against the
JAX package, values and gradients, on a toy scene the cameras see
against the sky: `_icosphere(2)` (320 faces in 512 slots) and a small
sphere under the procedural sky, 12x12, backend "bvh" over the JAX
package's LBVH carried across.

The scene helpers here are shared with tests/test_torch_diff.py."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import lbvh as jlbvh
from raypt.accel import traverse as jtrav
from raypt.core.scene import MaterialDef, SceneBuilder
from raypt.core.types import RenderConfig as JaxConfig
from raypt.render import render_aovs as jax_render_aovs
from raypt.scenes.builtin import _icosphere, _procedural_sky

from raypt_torch.accel import traverse as ttrav
from raypt_torch.core.types import CameraRays, RenderConfig, scene_from_numpy
from raypt_torch.render import render_aovs

from test_torch_scene import jax_lbvh_to_port, jax_leaves

torch.set_num_threads(2)

W = 12
DIST = 2.2
ANGLES = (0.0, 0.7)          # the views' yaws, radians
FIELDS = ("origin", "lower_left", "horizontal", "vertical")
CFG = dict(width=W, height=W, samples_per_pixel=1, num_bounces=2,
           backend="bvh", russian_roulette=False)
# recompute_hit's floats against JAX's: XLA on the CPU contracts
# multiply-adds and torch does not (ROADMAP parity rule), so the
# Moller-Trumbore t, u, v and the normals differ in the last bits
# (measured worst: t 2.1e-6 absolute / 9.7e-7 relative, position 1.9e-6,
# normal 6.6e-6 (render_aovs, second view), depth 2.9e-6 / 1.9e-6
# relative; uv and albedo equal)
HIT_RTOL = 1e-5
HIT_ATOL = 2e-5
# gradients through the recompute, as a share of the largest magnitude
# (measured worst 1.6e-5, w.r.t. positions; the mean depth's 2.3e-6)
GRAD_RTOL = 5e-5


@lru_cache(maxsize=None)
def toy_builder_views():
    """The toy scene's JAX builder frozen, and its views' JAX camera
    frames: _icosphere(2) at the origin (albedo (0.7, 0.5, 0.3), the
    bunny's specular lobe) and a sphere of radius 0.4 beside it, under
    the procedural sky at 16 texels a face (so the radiance depends on
    the shading normals); cameras at distance DIST, yaws ANGLES, looking at the
    origin."""
    mesh = _icosphere(2)
    b = SceneBuilder(env=_procedural_sky(16))
    mat = b.add_material(MaterialDef(albedo=(0.7, 0.5, 0.3),
                                     specular=(0.3, 1.0, 0.3),
                                     specular_percent=0.5, roughness=0.8))
    ball = b.add_material(MaterialDef(albedo=(0.2, 0.6, 0.9)))
    b.add_mesh(mesh["positions"], mesh["normals"], mesh["faces"],
               uvs=mesh["uvs"], material=mat)
    b.add_sphere((1.1, -0.5, 0.3), 0.4, ball)
    b.camera.viewport_width = b.camera.viewport_height = W
    views = []
    for a in ANGLES:
        b.camera.position = (DIST * np.sin(a), 0.3, DIST * np.cos(a))
        b.camera.angle_y = float(np.degrees(a))
        views.append(b.camera.rays())
    return b.freeze(), tuple(views)


def port_views(views):
    """The port's CameraRays of JAX camera frames."""
    return [CameraRays(*(torch.from_numpy(np.array(getattr(v, f)))
                         for f in FIELDS)) for v in views]


@pytest.fixture(scope="module")
def toy():
    jscene, views = toy_builder_views()
    m = jscene.mesh
    jbvh = jlbvh.build(m.positions, m.faces, m.face_valid)
    return dict(jscene=jscene, scene=scene_from_numpy(jax_leaves(jscene),
                                                      "cpu"),
                jbvh=jbvh, bvh=jax_lbvh_to_port(jbvh), views=views)


@pytest.fixture(scope="module")
def wave(toy):
    """A seeded wavefront from around the camera toward the scene, with
    JAX's brute-force hit ids: triangle hits, sphere hits and misses."""
    rng = np.random.default_rng(5)
    n = 512
    ro = rng.uniform([-0.5, -0.5, 1.8], [0.5, 0.8, 2.6], (n, 3))
    target = rng.uniform([-1.4, -1.2, -0.6], [1.6, 1.2, 0.6], (n, 3))
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = ro.astype(np.float32), rd.astype(np.float32)
    ids = jtrav.find_closest_bruteforce(toy["jscene"], jnp.asarray(ro),
                                        jnp.asarray(rd))
    tri, sph = np.asarray(ids.tri), np.asarray(ids.sphere)
    assert (tri >= 0).sum() > 100 and (sph >= 0).sum() > 20
    assert ((tri < 0) & (sph < 0)).sum() > 100
    return ro, rd, ids


def _port_ids(ids):
    return ttrav.HitIds(*(torch.from_numpy(np.array(getattr(ids, k)))
                          for k in ("t", "tri", "sphere")))


def test_recompute_hit_matches_jax(toy, wave):
    """Every Hit field against JAX's recompute_hit on the same ids: t,
    position, normal and uv to HIT_RTOL / HIT_ATOL (where the hit is
    valid; on a miss t is BIG and the position far away, in both);
    valid, mat_id and front_face exactly."""
    ro, rd, ids = wave
    ref = jtrav.recompute_hit(toy["jscene"], jnp.asarray(ro), jnp.asarray(rd),
                              ids)
    got = ttrav.recompute_hit(toy["scene"], torch.from_numpy(ro),
                              torch.from_numpy(rd), _port_ids(ids))
    for k in ("valid", "mat_id", "front_face"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(ref, k))), k
    v = np.asarray(ref.valid)
    assert got.mat_id.dtype == torch.int32
    for k in ("t", "position", "normal", "uv"):
        np.testing.assert_allclose(getattr(got, k).numpy()[v],
                                   np.asarray(getattr(ref, k))[v],
                                   rtol=HIT_RTOL, atol=HIT_ATOL, err_msg=k)
    np.testing.assert_array_equal(got.t.numpy()[~v], np.asarray(ref.t)[~v])
    n = got.normal.numpy()
    # triangle normals face the ray, sphere normals point outward
    tri = np.asarray(ids.tri) >= 0
    assert (np.einsum("ij,ij->i", n[tri], rd[tri]) < 0).all()
    assert not np.asarray(ref.front_face)[tri].all()


def test_recompute_hit_grads_match_jax(toy, wave):
    """Gradients of a seeded weighting of t, position, normal and uv (on
    valid hits) w.r.t. mesh positions, normals and uvs and the spheres'
    centres and radii: nonzero, and JAX's to GRAD_RTOL of the largest."""
    ro, rd, ids = wave
    rng = np.random.default_rng(6)
    n = ro.shape[0]
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((n,), (n, 3), (n, 3), (n, 2))]
    valid = (np.asarray(ids.tri) >= 0) | (np.asarray(ids.sphere) >= 0)
    js = toy["jscene"]

    def jf(pos, nrm, uv, c, r):
        s = js.replace(mesh=js.mesh.replace(positions=pos, normals=nrm,
                                            uvs=uv),
                       spheres=js.spheres.replace(center=c, radius=r))
        h = jtrav.recompute_hit(s, jnp.asarray(ro), jnp.asarray(rd), ids)
        out = 0.0
        for wk, x in zip(w, (h.t, h.position, h.normal, h.uv)):
            m = valid if x.ndim == 1 else valid[:, None]
            out = out + jnp.sum(jnp.where(m, wk * x, 0.0))
        return out

    args = (js.mesh.positions, js.mesh.normals, js.mesh.uvs,
            js.spheres.center, js.spheres.radius)
    ref = jax.grad(jf, argnums=tuple(range(5)))(*args)

    sc = toy["scene"]
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    s = sc.replace(mesh=sc.mesh.replace(positions=leaves[0],
                                        normals=leaves[1], uvs=leaves[2]),
                   spheres=sc.spheres.replace(center=leaves[3],
                                              radius=leaves[4]))
    h = ttrav.recompute_hit(s, torch.from_numpy(ro), torch.from_numpy(rd),
                            _port_ids(ids))
    tv = torch.from_numpy(valid)
    out = 0.0
    for wk, x in zip(w, (h.t, h.position, h.normal, h.uv)):
        m = tv if x.ndim == 1 else tv[:, None]
        out = out + torch.sum(torch.where(m, torch.from_numpy(wk) * x,
                                          torch.zeros_like(x)))
    out.backward()
    for name, leaf, r in zip(("positions", "normals", "uvs", "center",
                              "radius"), leaves, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), r,
                                   atol=GRAD_RTOL * np.abs(r).max(),
                                   err_msg=name)


def _cfgs():
    return JaxConfig(**CFG), RenderConfig(**CFG)


def test_render_aovs_matches_jax(toy):
    """render_aovs (accel=) against JAX's (bvh=) from each view: "hit"
    exactly, depth, normal and albedo to HIT_RTOL / HIT_ATOL; some
    pixels see the sky."""
    jcfg, cfg = _cfgs()
    for jv, v in zip(toy["views"], port_views(toy["views"])):
        ref = jax_render_aovs(toy["jscene"].replace(camera=jv), jcfg,
                              bvh=toy["jbvh"])
        got = render_aovs(toy["scene"].replace(camera=v), cfg,
                          accel=toy["bvh"])
        hit = np.asarray(ref["hit"])
        assert np.array_equal(got["hit"].numpy(), hit)
        assert 20 < hit.sum() < W * W
        for k in ("depth", "normal", "albedo"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=HIT_RTOL, atol=HIT_ATOL,
                                       err_msg=k)


def test_render_aovs_depth_grad_matches_jax(toy):
    """The gradient of the mean depth w.r.t. the vertex positions, taken
    as tests/test_grad.py takes it: finite, nonzero, and JAX's to
    GRAD_RTOL of its largest magnitude."""
    jcfg, cfg = _cfgs()
    js = toy["jscene"]

    def jf(positions):
        s = js.replace(mesh=js.mesh.replace(positions=positions))
        return jnp.mean(jax_render_aovs(s, jcfg, bvh=toy["jbvh"])["depth"])

    ref = np.asarray(jax.grad(jf)(js.mesh.positions))
    sc = toy["scene"]
    pos = sc.mesh.positions.clone().requires_grad_(True)
    s = sc.replace(mesh=sc.mesh.replace(positions=pos))
    render_aovs(s, cfg, accel=toy["bvh"])["depth"].mean().backward()
    g = pos.grad.numpy()
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, atol=GRAD_RTOL * np.abs(ref).max())
