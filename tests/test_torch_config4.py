"""raypt_torch's config-4 slice against the JAX package: the .hdr and glTF
loaders, the config-4 and textured_demo scenes, refraction_uniform,
refract and schlick_fresnel, albedo textures, the equirect environment,
and renders with the dielectric lobe on: config4 through the onehot
finder's Woop branch (the JAX kernels in interpret mode), textured_demo
and the glass-sphere scene of tests/test_refraction.py through the
brute-force finder, with the gradients of the config4 render's mean
w.r.t. positions and albedo."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.host_bvh import build_sah as jax_build_sah
from raypt.core import math3d as jm
from raypt.core.scene import MaterialDef as JaxMaterialDef
from raypt.core.scene import SceneBuilder as JaxSceneBuilder
from raypt.core.types import EnvMap as JaxEnvMap
from raypt.core.types import RenderConfig as JaxConfig
from raypt.io import gltf as jgltf
from raypt.io import hdr as jhdr
from raypt.render import envmap as jenv
from raypt.render import integrator as jint
from raypt.render.shading import sample_albedo_texture as jax_sample_tex
from raypt.rng import frame_key, refraction_uniform, sample_key
from raypt.scenes import builtin as jax_builtin
from raypt.scenes import config4 as jc4

from raypt_torch.core import math3d as tm
from raypt_torch.core.types import EnvMap, RenderConfig, scene_from_numpy
from raypt_torch.io import gltf as tgltf
from raypt_torch.io import hdr as thdr
from raypt_torch.render import envmap as tenv
from raypt_torch.render import integrator as tint
from raypt_torch.render.shading import sample_albedo_texture
from raypt_torch.rng import sampler as trng
from raypt_torch.scenes import builtin as tbuiltin
from raypt_torch.scenes import config4 as tc4

from test_torch_scene import jax_accel_to_port, jax_leaves

torch.set_num_threads(2)


def scene_leaves(scene) -> dict:
    """jax_leaves with the texture stack, when the scene has one."""
    out = jax_leaves(scene)
    if scene.textures is not None:
        out["textures"] = np.asarray(scene.textures)
    return out


def port_leaves(scene) -> dict:
    """The same keys from a port Scene."""
    out = {}
    for grp in ("materials", "spheres", "mesh", "camera"):
        obj = getattr(scene, grp)
        for f in dataclasses.fields(obj):
            out[f"{grp}.{f.name}"] = getattr(obj, f.name).numpy()
    out["env.data"] = scene.env.data.numpy()
    out["env.is_cube"] = scene.env.is_cube
    if scene.textures is not None:
        out["textures"] = scene.textures.numpy()
    return out


def test_hdr_roundtrip_across_packages(tmp_path):
    """Each package's write_hdr gives the same bytes, and each load_hdr
    reads either file bitwise equal to the other's (RGBE quantises, so
    the read-back is not the input)."""
    sky = jc4._sun_sky(32, 64)
    assert np.array_equal(sky, tc4._sun_sky(32, 64))
    jp, tp = str(tmp_path / "j.hdr"), str(tmp_path / "t.hdr")
    jhdr.write_hdr(jp, sky)
    thdr.write_hdr(tp, sky)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    ref = jhdr.load_hdr(jp)
    for p in (jp, tp):
        got = thdr.load_hdr(p)
        assert got.dtype == np.float32 and got.shape == (32, 64, 3)
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    assert not np.array_equal(ref, sky) and np.allclose(ref, sky, rtol=1e-2,
                                                        atol=1e-6)


def _without_normals(glb: bytes) -> bytes:
    """The GLB with every primitive's NORMAL attribute dropped, so the
    loader generates smooth normals."""
    gltf, bin_chunk = tgltf._parse_glb(glb)
    for mesh in gltf["meshes"]:
        for prim in mesh["primitives"]:
            prim["attributes"].pop("NORMAL")
    return tc4._pack_glb(gltf, bin_chunk)


@pytest.mark.parametrize("normals", [True, False])
def test_gltf_bitwise(normals):
    """author_config4_glb gives the same bytes in both packages, and
    every array and material of load_gltf on them is bitwise equal, also
    when the normals are generated."""
    glb = tc4.author_config4_glb()
    assert glb == jc4.author_config4_glb()
    if not normals:
        glb = _without_normals(glb)
    ref, got = jgltf.load_gltf(glb), tgltf.load_gltf(glb)
    assert sorted(ref) == sorted(got)
    assert ref["materials"] == got["materials"]
    for k in ("positions", "normals", "uvs", "faces", "face_materials"):
        assert ref[k].dtype == got[k].dtype and np.array_equal(ref[k], got[k])
    assert got["faces"].shape == (5120 + 2 * 1280 + 2, 3)


@pytest.mark.parametrize("name", ["config4", "textured_demo"])
def test_freeze_bitwise(name, tmp_path):
    """Every frozen leaf, the (K, TH, TW, 3) texture stack and the
    equirect environment included, is bitwise equal; scene_from_numpy
    of the JAX leaves gives the same scene."""
    if name == "config4":
        jb = jc4.config4_scene(hdr_path=str(tmp_path / "j.hdr"))
        tb = tc4.config4_scene(hdr_path=str(tmp_path / "t.hdr"))
    else:
        jb, tb = jax_builtin.textured_demo(), tbuiltin.textured_demo()
    ref = scene_leaves(jb.freeze())
    for scene in (tb.freeze("cpu"), scene_from_numpy(ref, "cpu")):
        got = port_leaves(scene)
        assert sorted(got) == sorted(ref)
        for k, r in ref.items():
            if k == "env.is_cube":
                assert got[k] is False and r is False
                continue
            assert got[k].shape == r.shape, k
            assert np.array_equal(got[k].view(np.uint8), r.view(np.uint8)), k
    assert ref["textures"].shape[0] == (2 if name == "config4" else 1)


def test_config4_default_hdr_path_is_temporary(monkeypatch, tmp_path):
    """Without hdr_path the panorama goes to the system's temporary
    directory, never into the repository."""
    monkeypatch.setattr(tc4.tempfile, "gettempdir", lambda: str(tmp_path))
    tc4.config4_scene()
    assert (tmp_path / "config4_sky.hdr").exists()


def test_refraction_uniform_bitwise():
    """refraction_uniform equals the JAX package's bit for bit."""
    ids = np.arange(0, 5000, 7, dtype=np.int32).reshape(-1, 13)
    jkey = sample_key(frame_key(jax.random.key(5), 2), 1)
    tkey = trng.sample_key(trng.frame_key(trng.key(5), 2), 1)
    for b in (0, 3):
        ref = np.asarray(refraction_uniform(jkey, b, jnp.asarray(ids)))
        got = trng.refraction_uniform(tkey, b, torch.from_numpy(ids)).numpy()
        assert got.shape == ids.shape
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_refract_and_fresnel():
    """refract (with TIR lanes) and schlick_fresnel against the JAX
    package's at atol 1e-6 (measured worst 1.2e-7 for both)."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = np.tile(np.float32([0.0, 1.0, 0.0]), (4096, 1))
    n = np.where((d @ n[0] < 0)[:, None], n, -n)
    eta = rng.choice(np.float32([1 / 1.5, 1.5, 1.0]), (4096, 1))
    ref = np.asarray(jm.refract(jnp.asarray(d), jnp.asarray(n),
                                jnp.asarray(eta)))
    got = tm.refract(torch.from_numpy(d), torch.from_numpy(n),
                     torch.from_numpy(eta)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (np.abs(got).sum(axis=1) == 0).sum() > 100      # TIR lanes
    cos_i = rng.uniform(0, 1, 4096).astype(np.float32)
    ior = rng.uniform(1.0, 2.0, 4096).astype(np.float32)
    ref = np.asarray(jm.schlick_fresnel(jnp.asarray(cos_i), 1.0,
                                        jnp.asarray(ior)))
    got = tm.schlick_fresnel(torch.from_numpy(cos_i), 1.0,
                             torch.from_numpy(ior)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_albedo_texture_matches_jax():
    """Bilinear wrapped texture samples at uvs from -2 to 3 (below 0 and
    above 1 on both axes) with tex_id -1 (untextured: 1.0), 0 and 1;
    allclose at atol 1e-6 (measured: equal)."""
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    uv = rng.uniform(-2, 3, (4096, 2)).astype(np.float32)
    tid = rng.integers(-1, 2, 4096).astype(np.int32)
    ref = np.asarray(jax_sample_tex(jnp.asarray(tex), jnp.asarray(tid),
                                    jnp.asarray(uv)))
    got = sample_albedo_texture(torch.from_numpy(tex), torch.from_numpy(tid),
                                torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (got[tid < 0] == 1.0).all() and (uv < 0).any() and (uv > 1).any()


@pytest.mark.parametrize("sky", ["config4", "noise"])
def test_equirect_env_matches_jax(sky, tmp_path):
    """sample_env and the quad-table path (F = 1, x wrapped) against the
    JAX package's on random unit directions, half of them near the +y
    pole (above the first row's centre, where the two JAX paths clamp
    differently), and on the seam (-z, where x wraps): on the config-4
    sky and on a 16x32 noise sky whose neighbouring rows differ. allclose
    at rtol 1e-4, atol 1e-5 (measured worst 8.0e-5 absolute, 4.1e-5 of
    the value, on the flank of the config-4 sun, 80x the sky; 1.4e-6 on
    the noise: atan2 and acos round differently in torch); the quad
    tables are bitwise equal."""
    rng = np.random.default_rng(8)
    if sky == "config4":
        path = str(tmp_path / "sky.hdr")
        jhdr.write_hdr(path, jc4._sun_sky())
        data = jhdr.load_hdr(path)
    else:
        data = rng.uniform(0, 1, (16, 32, 3)).astype(np.float32)
    jsky = JaxEnvMap(data=jnp.asarray(data), is_cube=False)
    tsky = EnvMap(data=torch.from_numpy(data), is_cube=False)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    d[::2, 1] = np.abs(d[::2, 1]) * 30
    d[:4] = [[0, 0, 1], [1e-7, 0, 1], [-1e-7, 0, 1], [0, 1, 0]]
    d[4:8] = [[0, -1, 0], [0.3, 0.9, 1], [-1e-3, 0.2, 1], [1e-3, -0.2, 1]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = np.asarray(jenv.sample_env(jsky, jnp.asarray(d)))
    jq, jhw = jenv.build_env_quads(jsky)
    ref_q = np.asarray(jenv.sample_env_quads(jsky, jq, jhw, jnp.asarray(d)))
    tq, thw = tenv.build_env_quads(tsky)
    assert thw == jhw and np.array_equal(tq.numpy(), np.asarray(jq))
    got = tenv.sample_env(tsky, torch.from_numpy(d)).numpy()
    got_q = tenv.sample_env_quads(tsky, tq, thw, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_q, ref_q, rtol=1e-4, atol=1e-5)


# -- renders -----------------------------------------------------------------

W4 = 16
C4_CFG = dict(width=W4, height=W4, samples_per_pixel=1, num_bounces=8,
              russian_roulette=True, enable_refraction=True, backend="onehot",
              onehot_leaf=128)


def _glass_scene():
    """tests/test_refraction.py's glass sphere under a direction-
    dependent equirect sky."""
    gy = np.linspace(0.0, 1.0, 16)[:, None, None]
    gx = np.linspace(0.0, 1.0, 32)[None, :, None]
    sky = np.broadcast_to(gy * np.ones_like(gx), (16, 32, 3)).astype(
        np.float32) + 0.1 * np.broadcast_to(gx, (16, 32, 3))
    b = JaxSceneBuilder(env=JaxEnvMap(data=jnp.asarray(sky), is_cube=False))
    glass = b.add_material(JaxMaterialDef(albedo=(1.0, 1.0, 1.0),
                                          refraction_percent=1.0, ior=1.5))
    b.add_sphere((0.0, 0.0, -3.0), 1.2, glass)
    return b


def _render_both(jb, cfg_kw, accel=None, tacc=None, grads=False):
    """Render jb's scene at cfg_kw in both packages with the same key (and
    accel); with grads also d mean / d (positions, albedo). Returns
    {"jax": (loss, img, traced, gv, ga), "torch": (...)}."""
    jb.camera.viewport_width = jb.camera.viewport_height = cfg_kw["width"]
    scene = jb.freeze()
    cfg = JaxConfig(**cfg_kw)
    skey = sample_key(frame_key(jax.random.key(1), 0), 0)

    def loss(v, a):
        s = scene.replace(mesh=scene.mesh.replace(positions=v),
                          materials=scene.materials.replace(albedo=a))
        img, tr = jint.render_sample(s, cfg, skey,
                                     jint.make_finder(s, cfg, accel),
                                     return_alive=True)
        return jnp.mean(img), (img, tr)

    args = (scene.mesh.positions, scene.materials.albedo)
    if grads:
        (jl, (jimg, jtr)), jg = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(*args)
    else:
        (jl, (jimg, jtr)), jg = loss(*args), (None, None)
    out = {"jax": (float(jl), np.asarray(jimg), np.asarray(jtr),
                   *(None if g is None else np.asarray(g) for g in jg))}

    tscene = scene_from_numpy(scene_leaves(scene), "cpu")
    tcfg = RenderConfig(**cfg_kw)
    v = tscene.mesh.positions.clone().requires_grad_(grads)
    a = tscene.materials.albedo.clone().requires_grad_(grads)
    s = tscene.replace(mesh=tscene.mesh.replace(positions=v),
                       materials=tscene.materials.replace(albedo=a))
    tkey = trng.sample_key(trng.frame_key(trng.key(1), 0), 0)
    with torch.set_grad_enabled(grads):
        img, tr = tint.render_sample(s, tcfg, tkey,
                                     tint.make_finder(s, tcfg, tacc),
                                     return_alive=True)
        tl = img.mean()
        if grads:
            tl.backward()
    out["torch"] = (float(tl.detach()), img.detach().numpy(), tr.numpy(),
                    v.grad.numpy() if grads else None,
                    a.grad.numpy() if grads else None)
    return out


@pytest.fixture(scope="module")
def config4_run(tmp_path_factory):
    """config4 at 16^2, 8 bounces, roulette and refraction through the
    Woop branch of the onehot finder, on the JAX package's leaf-128
    4-tuple accel in both packages, with gradients."""
    jb = jc4.config4_scene(hdr_path=str(tmp_path_factory.mktemp("c4")
                                        / "sky.hdr"))
    m = jb.freeze().mesh
    accel = jax_build_onehot(jax_build_sah(m), m.positions, m.faces,
                             m.face_valid, leaf=128, with_woop=True)
    tacc = jax_accel_to_port(accel)
    assert tacc.woop_cm is not None and tacc.fid_flat is not None
    return _render_both(jb, C4_CFG, accel, tacc, grads=True)


@pytest.fixture(scope="module", params=["textured_demo", "glass"])
def brute_run(request):
    """textured_demo (checker texture with uvs to 4, equirect sky) and
    the glass sphere, refraction on, through the brute-force finder."""
    jb = (jax_builtin.textured_demo() if request.param == "textured_demo"
          else _glass_scene())
    return _render_both(jb, dict(C4_CFG, width=24, height=24, num_bounces=5,
                                 backend="bruteforce"))


def test_config4_image_matches_jax(config4_run):
    """Finite, same traced counts, allclose at rtol 1e-5, atol 1e-5 on
    every pixel, loss within 1e-5 relative (measured worst 4.2e-7
    absolute, loss 2.3e-7: the Woop kernels sum their affine products in
    other orders, so t differs in the last bits)."""
    jl, jimg, jtr, _, _ = config4_run["jax"]
    tl, img, tr, _, _ = config4_run["torch"]
    assert np.isfinite(img).all() and img.shape == (W4, W4, 3)
    assert np.array_equal(tr, jtr) and tr[0] == W4 * W4 and tr[3] > 0
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-5)
    assert abs(tl - jl) <= 1e-5 * abs(jl)


def test_config4_grads_match_jax(config4_run):
    """d mean(image) / d positions and / d albedo through textures, the
    glass lobe and the HDR sky: nonzero on the same rows, within 1e-4 of
    each gradient's largest magnitude (measured worst 6.1e-6 for the 41
    nonzero position rows, 9.2e-9 for albedo)."""
    _, _, _, jgv, jga = config4_run["jax"]
    _, _, _, tgv, tga = config4_run["torch"]
    for g, r in ((tgv, jgv), (tga, jga)):
        big = np.abs(r).max()
        assert big > 0 and np.isfinite(g).all()
        assert np.abs(g - r).max() <= 1e-4 * big, np.abs(g - r).max() / big
        assert np.array_equal(np.abs(g).sum(axis=1) > 0,
                              np.abs(r).sum(axis=1) > 0)
    assert (np.abs(jgv).sum(axis=1) > 0).sum() >= 20


def test_brute_force_renders_match_jax(brute_run):
    """textured_demo and the glass sphere: same traced counts, allclose at
    rtol 1e-4, atol 1e-4 on every pixel (measured worst 6.7e-5 absolute
    on textured_demo, whose checker jumps by 1 from texel to texel, so a
    hit uv that rounds differently in the two packages moves a bilinear
    weight, and the pixel, by ~3e-5 of the sky's radiance; 7.2e-7 on the
    glass sphere)."""
    jl, jimg, jtr, _, _ = brute_run["jax"]
    tl, img, tr, _, _ = brute_run["torch"]
    assert np.isfinite(img).all() and np.array_equal(tr, jtr)
    np.testing.assert_allclose(img, jimg, rtol=1e-4, atol=1e-4)
    assert img.std() > 0
