"""The whole raypt_torch slice against the JAX package: the bench render
path (stanford_bunny, 1 spp, 4 bounces, roulette, onehot finder with
expansion and compaction) at 32x32 with leaf 64 and expand/compact
scaled down to 256/1024, on the same scene, accel and key; then the
bench loss's gradients, from the bench view and from one outside the
mesh where the gradient w.r.t. positions is not 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.host_bvh import build_sah as jax_build_sah
from raypt.core.types import RenderConfig as JaxConfig
from raypt.render import integrator as jint
from raypt.render.tonemap import to_display as jax_to_display
from raypt.rng import frame_key, sample_key
from raypt.scenes import builtin as jax_scenes

from raypt_torch.core.types import EnvMap, RenderConfig, scene_from_numpy
from raypt_torch.io.image import write_png
from raypt_torch.render import integrator as tint
from raypt_torch.render.tonemap import to_display, to_u8
from raypt_torch.rng import sampler as trng

from test_torch_scene import jax_accel_to_port, jax_leaves

torch.set_num_threads(2)

W = 32
CFG = dict(width=W, height=W, samples_per_pixel=1, num_bounces=4,
           backend="onehot", russian_roulette=True, onehot_leaf=64,
           onehot_expand=256, onehot_compact=1024)


# A view from outside the stand-in bunny (the 5,120-triangle icosphere,
# radius 150 about (30, -18, 20)). The bench camera sits inside that
# sphere, where no path reaches the sky and the loss's gradient w.r.t.
# positions is 0 in both packages. From here, rays that hit the mesh
# bounce off it into the sky's graded side faces, so the gradient flows
# through barycentrics, the interpolated normal, the bounce direction
# and the bilinear env lookup.
OUTSIDE_VIEW = dict(position=(30.0, -18.0, -200.0), angle_y=180.0)


def _slice(camera=None):
    """Render and differentiate the bench loss in both packages; camera
    overrides the bench view's attributes."""
    b = jax_scenes.stanford_bunny()
    b.camera.viewport_width = b.camera.viewport_height = W
    for k, val in (camera or {}).items():
        setattr(b.camera, k, val)
    scene = b.freeze()
    cfg = JaxConfig(**CFG)
    accel = jax_build_onehot(jax_build_sah(scene.mesh), scene.mesh.positions,
                             scene.mesh.faces, scene.mesh.face_valid,
                             leaf=cfg.onehot_leaf)

    def loss(v, a):
        s = scene.replace(mesh=scene.mesh.replace(positions=v),
                          materials=scene.materials.replace(albedo=a))
        img, tr = jint.render_sample(
            s, cfg, sample_key(frame_key(jax.random.key(0), 0), 0),
            jint.make_finder(s, cfg, accel), return_alive=True)
        return jnp.mean(img), (img, tr)

    (jl, (jimg, jtr)), jg = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(
        scene.mesh.positions, scene.materials.albedo)

    tscene = scene_from_numpy(jax_leaves(scene))
    tacc = jax_accel_to_port(accel)
    tcfg = RenderConfig(**CFG)
    v = tscene.mesh.positions.clone().requires_grad_(True)
    a = tscene.materials.albedo.clone().requires_grad_(True)
    s = tscene.replace(mesh=tscene.mesh.replace(positions=v),
                       materials=tscene.materials.replace(albedo=a))
    skey = trng.sample_key(trng.frame_key(trng.key(0), 0), 0)
    img, tr = tint.render_sample(s, tcfg, skey, tint.make_finder(s, tcfg, tacc),
                                 return_alive=True)
    tl = img.mean()
    tl.backward()
    return dict(jax=(float(jl), np.asarray(jimg), np.asarray(jtr),
                     np.asarray(jg[0]), np.asarray(jg[1])),
                torch=(float(tl.detach()), img.detach().numpy(), tr.numpy(),
                       v.grad.numpy(), a.grad.numpy()),
                scene=tscene, accel=tacc, cfg=tcfg, skey=skey)


@pytest.fixture(scope="module")
def slice_run():
    return _slice()


@pytest.fixture(scope="module")
def outside_run():
    return _slice(OUTSIDE_VIEW)


def test_image_matches_jax(slice_run):
    """allclose at rtol 1e-4, atol 1e-5 with no pixel off tolerance;
    the share of pixels off is what is asserted, and it must be 0
    (measured: the images are bitwise equal)."""
    _, jimg, _, _, _ = slice_run["jax"]
    _, img, _, _, _ = slice_run["torch"]
    assert img.shape == jimg.shape == (W, W, 3)
    assert np.isfinite(img).all()
    off = ~np.isclose(img, jimg, rtol=1e-4, atol=1e-5)
    assert off.mean() == 0.0, (off.mean(), np.abs(img - jimg).max())


def test_traced_per_bounce_equal(slice_run):
    """Rays alive at the start of each bounce: equal counts."""
    assert np.array_equal(slice_run["torch"][2], slice_run["jax"][2])
    assert slice_run["torch"][2][0] == W * W


def test_loss_grads_match_jax(slice_run):
    """Bench loss value and its gradients. autograd sums the gathers'
    cotangents by scatter-add, XLA by one-hot matmuls, in other orders:
    loss rtol 1e-6 (measured: equal), albedo grads allclose at rtol 1e-5
    of their largest magnitude (measured worst 1.7e-7), position grads at
    atol 1e-9: from the bench camera no path reaches the sky, so they
    are 0 in both packages (test_position_grads_match_jax holds the
    nonzero case)."""
    jl, _, _, jgv, jga = slice_run["jax"]
    tl, _, _, tgv, tga = slice_run["torch"]
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert np.abs(jga).max() > 0
    assert np.abs(tga - jga).max() <= 1e-5 * np.abs(jga).max()
    np.testing.assert_allclose(tgv, jgv, atol=1e-9)


def test_position_grads_match_jax(outside_run):
    """From OUTSIDE_VIEW the gradient w.r.t. positions is nonzero on
    hundreds of vertices (measured: 312 of the mesh's, largest 1.28e-5).
    It must be nonzero on the same vertices in both packages and agree
    to rtol 1e-4 of its largest magnitude (measured worst 6.1e-6); the
    loss and albedo grads as in test_loss_grads_match_jax."""
    jl, jimg, jtr, jgv, jga = outside_run["jax"]
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


def test_render_frame_is_mean_of_samples(slice_run):
    """render_frame at 2 spp is the mean of the two render_sample
    passes with the frame's sample keys, and accumulate is the running
    mean."""
    scene, acc = slice_run["scene"], slice_run["accel"]
    cfg = slice_run["cfg"].replace(samples_per_pixel=2)
    finder = tint.make_finder(scene, cfg, acc)
    with torch.no_grad():
        frame = tint.render_frame(scene, cfg, trng.key(3), frame_index=1,
                                  finder=finder)
        fkey = trng.frame_key(trng.key(3), 1)
        s0, s1 = (tint.render_sample(scene, cfg, trng.sample_key(fkey, i),
                                     finder) for i in range(2))
    torch.testing.assert_close(frame, (s0 + s1) / 2, rtol=0, atol=0)
    run = tint.accumulate(s0, s1, 1)
    torch.testing.assert_close(run, (s0 + s1) / 2, rtol=1e-6, atol=1e-7)
    assert torch.equal(tint.accumulate(s1, s0, 0), s0)


def test_display_and_png(slice_run, tmp_path):
    """Tonemap allclose to the JAX package's (rtol 1e-6) and a PNG of the
    right size."""
    img = torch.from_numpy(slice_run["torch"][1])
    disp = to_display(img)
    ref = np.asarray(jax_to_display(jnp.asarray(img.numpy())))
    np.testing.assert_allclose(disp.numpy(), ref, rtol=1e-6, atol=1e-7)
    u8 = to_u8(disp)
    assert u8.dtype == torch.uint8 and u8.shape == (W, W, 3)
    path = tmp_path / "slice.png"
    write_png(str(path), u8.numpy())
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == W


def test_unported_settings_raise(slice_run):
    scene, acc, cfg = slice_run["scene"], slice_run["accel"], slice_run["cfg"]
    for bad in (cfg.replace(backend="bvh"), cfg.replace(onehot_expand=0)):
        with pytest.raises(NotImplementedError):
            finder = tint.make_finder(scene, bad, acc)
            tint.render_sample(scene, bad, slice_run["skey"], finder)
    with pytest.raises(NotImplementedError):
        tint.render_sample(scene, cfg.replace(enable_refraction=True),
                           slice_run["skey"], tint.make_finder(scene, cfg, acc))
    with pytest.raises(NotImplementedError):
        tint.make_finder(scene, cfg, None)


def test_env_sampling_matches_jax():
    """Cubemap lookup of the procedural sky: sample_env and the quad-
    table path against the JAX package's, on random unit directions;
    allclose at atol 1e-6 (measured: equal)."""
    from raypt.render import envmap as jenv
    from raypt_torch.render import envmap as tenv
    rng = np.random.default_rng(9)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jsky = jax_scenes._procedural_sky(16)
    tsky = EnvMap(data=torch.from_numpy(np.array(jsky.data)))
    ref = np.asarray(jenv.sample_env(jsky, jnp.asarray(d)))
    got = tenv.sample_env(tsky, torch.from_numpy(d)).numpy()
    quads, hw = tenv.build_env_quads(tsky)
    via_quads = tenv.sample_env_quads(tsky, quads, hw,
                                      torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(via_quads, ref, atol=1e-6)
    rot = tenv.rotate_y_pi(torch.from_numpy(d)).numpy()
    assert np.array_equal(rot, np.asarray(jenv.rotate_y_pi(jnp.asarray(d))))
