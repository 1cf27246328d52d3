"""raypt_torch's inverse rendering (`raypt_torch.diff`) against the JAX
package's `raypt.diff`, on the toy scene of tests/test_torch_aovs.py
(`_icosphere(2)` and a sphere under the procedural sky, 12x12, 1 spp, 2
bounces, backend "bvh", 2 views): the parameters and their mapping into
the scene, the mesh priors, `render_rgbd`, three steps of
`make_fit_step` (a refit every step, the Laplacian prior, the
preconditioner as param_map, lattice 4, frozen fields), `fit` and the
optimizer.

Then each rule of the JAX step on its own: the loss includes the prior,
whose gradient is taken on the stored params; param_map runs inside the
loss; the refit reads the realized positions and moves boxes; view i
renders with fold_in(key, i), and a render with frame_key(key, 0); the
loss is the mean over the views; the finder is made once a step;
frozen fields get zero gradients, not None.

The optimizers differ: torch.optim.Adam and optax.adam differ by up to
ADAM_ATOL on the same gradients, so parameters after a fit are held to
FIT_ATOL, not bitwise. Adam's first update is lr g / (|g| + 1e-8): for
the few offsets whose gradient lies within a few eps of 0 (10 of 768
here, |g| < 1e-6 against a largest |g| of 4.5e-3) it turns the
gradients' last-bit differences into parameter differences of order lr.
So the three steps of the full fit (offsets, lattice, albedo) run under
SGD in both packages, which keeps the gradients' agreement visible, and
the Adam tests (`fit`, a frozen-then-unfrozen field) train the albedo
and the specular colour, whose gradients are far from 0 (or exactly 0,
on the padded material slots). The camera deltas get no gradient in a
fit: each view's camera replaces the scene's, in both packages."""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raypt.accel import lbvh as jlbvh
from raypt.core.types import RenderConfig as JaxConfig
from raypt.diff import inverse as jinv
from raypt.diff import params as jpar
from raypt.diff import priors as jpri
from raypt.render.integrator import make_finder as jax_make_finder

from raypt_torch.accel import lbvh as tlbvh
from raypt_torch.accel.packed import pack
from raypt_torch.core.types import RenderConfig, scene_from_numpy
from raypt_torch.diff import inverse as tinv
from raypt_torch.diff import params as tpar
from raypt_torch.diff import priors as tpri
from raypt_torch.diff import (SceneParams, apply_params, fit, freeze_except,
                              l2_image_loss, make_fit_step, stack_views,
                              view_at)
from raypt_torch.render.integrator import render_frame
from raypt_torch.rng import sampler as trng

from test_torch_aovs import CFG, port_views, toy_builder_views
from test_torch_scene import jax_lbvh_to_port, jax_leaves

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATTICE = 4
PRECOND_K = 2
LAP_W = 3.0
LR = 0.03
DEPTH_W = 0.5
TRAIN = ("albedo_logits", "lattice_scalar", "vertex_offsets")
FIT_TRAIN = ("albedo_logits", "specular_logits")
FROZEN = ("specular_logits", "emissive_raw", "roughness_logits",
          "specular_percent_logits", "cam_origin_delta", "cam_frame_delta")
STEPS = 3
# the scene's floats against JAX's (XLA contracts multiply-adds, torch
# does not; log / exp / sigmoid may round apart): measured worst 1.5e-7
# relative (init's albedo logits; apply_params' outputs 1.1e-7; a
# smoothed offset near 0, 5.1e-6 relative, is 6.0e-8 absolute)
VAL_RTOL = 2e-6
VAL_ATOL = 1e-6
# gradients, as a share of the largest magnitude (measured worst 2.4e-7,
# through apply_params; the priors' 5.2e-8)
GRAD_RTOL = 1e-5
# images (render_rgbd) and step losses (measured worst 2.3e-6 absolute on
# an image, 3.2e-7 relative on a loss)
IMG_ATOL = 1e-5
LOSS_RTOL = 5e-6
# parameters after a fit's steps under the two Adams (measured worst
# 6.1e-7, on albedo_logits), and Adam's own difference from optax on the
# same gradients (measured worst 3.3e-6 on values of order 1 over 20
# steps at lr 0.03)
FIT_ATOL = 1e-5
ADAM_ATOL = 1e-5
# a field's change after STEPS SGD steps at LR, as a share of its largest
# change (measured worst 1.0e-6, vertex_offsets), plus two ulps of its
# largest value (the stored float32 rounds the update; the inits sit an
# ulp apart)
SGD_RTOL = 1e-5


def rgbd_loss_jax(img, tgt):
    """scripts/baseline_config5.py's rgbd_loss: RGB MSE plus DEPTH_W
    times the depth MSE where both image and target hit."""
    rgb = jnp.mean((img[..., :3] - tgt[..., :3]) ** 2)
    both = (img[..., 3] > 0) & (tgt[..., 3] > 0)
    d = (jnp.sum(jnp.where(both, (img[..., 3] - tgt[..., 3]) ** 2, 0.0))
         / jnp.maximum(jnp.sum(both), 1))
    return rgb + DEPTH_W * d


def rgbd_loss(img, tgt):
    rgb = torch.mean((img[..., :3] - tgt[..., :3]) ** 2)
    both = (img[..., 3] > 0) & (tgt[..., 3] > 0)
    sq = (img[..., 3] - tgt[..., 3]) ** 2
    d = (torch.sum(torch.where(both, sq, torch.zeros_like(sq)))
         / torch.clamp(both.sum(), min=1))
    return rgb + DEPTH_W * d


def _np(x):
    return np.asarray(x)


def _jparams_dict(p) -> dict:
    return {k: (None if getattr(p, k) is None else _np(getattr(p, k)))
            for k in tpar.FIELDS}


@pytest.fixture(scope="module")
def case():
    """The true toy scene's RGB-D targets (JAX render_rgbd, key fold_in(
    key(0), k)), a corrupted copy (offsets 0.1 sin(2y + 3x) n on the real
    vertices, albedo clip(0.4 a + 0.2)) with its LBVH, in both packages."""
    jscene, views = toy_builder_views()
    jcfg = JaxConfig(**CFG)
    key = jax.random.key(0)
    m = jscene.mesh
    finder = jax_make_finder(jscene, jcfg, jlbvh.build(m.positions, m.faces,
                                                       m.face_valid))
    targets = jnp.stack([
        jinv.render_rgbd(jscene.replace(camera=v), jcfg,
                         jax.random.fold_in(key, k), finder)
        for k, v in enumerate(views)])
    p = _np(m.positions)
    n = _np(m.normals)
    nv = int(_np(m.faces)[_np(m.face_valid)].max()) + 1
    off = (0.1 * np.sin(2 * p[:, 1:2] + 3 * p[:, 0:1]) * n).astype(np.float32)
    off[nv:] = 0.0
    bad = jscene.replace(
        mesh=m.replace(positions=m.positions + off),
        materials=jscene.materials.replace(albedo=jnp.clip(
            jscene.materials.albedo * 0.4 + 0.2, 0.02, 0.98)))
    bm = bad.mesh
    jbvh = jlbvh.build(bm.positions, bm.faces, bm.face_valid)
    return dict(jcfg=jcfg, cfg=RenderConfig(**CFG), key=key, views=views,
                jstack=jinv.stack_views(views), targets=targets, jbad=bad,
                jbvh=jbvh, bad=scene_from_numpy(jax_leaves(bad), "cpu"),
                bvh=jax_lbvh_to_port(jbvh),
                tviews=stack_views(port_views(views)),
                ttargets=torch.from_numpy(np.array(targets)))


def _priors(pkg, scene):
    faces, valid = _np(scene.mesh.faces), _np(scene.mesh.face_valid)
    nv = scene.mesh.positions.shape[0]
    return (pkg.make_laplacian_reg(faces, valid, nv, weight=LAP_W),
            pkg.make_vertex_preconditioner(faces, valid, nv, k=PRECOND_K))


@pytest.fixture(scope="module")
def jax_fit(case):
    """STEPS steps of the JAX fit step under SGD at LR (bvh, refit, rgbd
    loss through render_rgbd, the Laplacian prior, the preconditioner,
    lattice LATTICE, TRAIN trainable): the loss of each step and the
    params after each."""
    reg, pmap = _priors(jpri, case["jbad"])
    opt = optax.sgd(LR)
    params = jpar.SceneParams.init(case["jbad"], lattice=LATTICE)
    state = opt.init(params)
    step = jinv.make_fit_step(case["jbad"], case["jcfg"], opt, TRAIN,
                              bvh=case["jbvh"], loss_fn=rgbd_loss_jax,
                              render_fn=jinv.render_rgbd, param_reg=reg,
                              param_map=pmap)
    losses, after = [], []
    for _ in range(STEPS):
        params, state, loss = step(params, state, case["jstack"],
                                   case["targets"], case["key"])
        losses.append(float(loss))
        after.append(_jparams_dict(params))
    return losses, after


def _port_step(case, optim=torch.optim.Adam, **kw):
    """The port's fit step over the corrupted scene with the JAX fit's
    settings (any of them replaced by kw), fresh params (lattice
    LATTICE) and an optimizer `optim` at LR."""
    reg, pmap = _priors(tpri, case["bad"])
    args = dict(bvh=case["bvh"], loss_fn=rgbd_loss, render_fn=tinv.render_rgbd,
                param_reg=reg, param_map=pmap)
    args.update(kw)
    params = SceneParams.init(case["bad"], lattice=LATTICE)
    opt = optim(params.parameters(), lr=LR)
    return params, opt, make_fit_step(case["bad"], case["cfg"], TRAIN, **args)


def _run(case, params, opt, step, n=1, key=None):
    key = key or trng.key(0)
    return [float(step(params, opt, case["tviews"], case["ttargets"], key))
            for _ in range(n)]


def test_port_imports_no_jax():
    """No module of raypt_torch, nor chip_smoke.py, imports jax or the
    JAX package (read from the sources), and importing every module of
    raypt_torch (outside its build directory: the packed layouts,
    kernels.packed_walk, diff, dist and its launcher among them) loads
    none of jax, raypt, optax or flax (the modules they add to a fresh
    interpreter)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "raypt_torch")):
        if "_build" in root:
            continue
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__") for p in files if p.endswith(".py")
        and os.path.basename(p) != "chip_smoke.py")
    assert {"raypt_torch.accel.packed", "raypt_torch.kernels.packed_walk",
            "raypt_torch.diff", "raypt_torch.dist.launcher"} <= set(modules)
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "raypt", "optax",
                                   "flax"), (path, mod)
    out = subprocess.run(
        [sys.executable, "-c", "import importlib, sys; before = "
         "set(sys.modules); [importlib.import_module(m) for m in sys.argv[1:]]; "
         "print(sorted(m for m in set(sys.modules) "
         "- before if m.split('.')[0] in ('jax', 'raypt', 'optax', "
         "'flax')))", *modules],
        cwd=REPO, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.stdout.strip() == "[]", out.stdout


def test_mesh_edges_exact(case):
    """mesh_edges: the edges and degrees equal JAX's, on the toy mesh's
    valid faces and on a small strip."""
    faces = _np(case["jbad"].mesh.faces)[_np(case["jbad"].mesh.face_valid)]
    nv = case["bad"].mesh.positions.shape[0]
    for f, n in ((faces, nv), (np.array([[0, 1, 2], [1, 2, 3]]), 5)):
        e, deg = tpri.mesh_edges(f, n)
        je, jdeg = jpri.mesh_edges(f, n)
        assert np.array_equal(e, je) and np.array_equal(deg, jdeg)
    assert deg.tolist() == [2, 3, 3, 2, 0]


@pytest.mark.parametrize("lattice", [0, LATTICE])
def test_scene_params_init(case, lattice):
    """SceneParams.init against JAX's: every field to VAL_RTOL (the zero
    fields bitwise); one nn.Parameter a field, with the JAX names;
    lattice_scalar absent (None, no parameter) when lattice is 0."""
    got = SceneParams.init(case["bad"], lattice=lattice)
    ref = _jparams_dict(jpar.SceneParams.init(case["jbad"], lattice=lattice))
    names = [n for n, _ in got.named_parameters()]
    assert names == [k for k in tpar.FIELDS if ref[k] is not None]
    assert (got.lattice_scalar is None) == (lattice == 0)
    for k in names:
        np.testing.assert_allclose(getattr(got, k).detach().numpy(), ref[k],
                                   rtol=VAL_RTOL, atol=0, err_msg=k)
    for k in ("vertex_offsets", "cam_origin_delta", "cam_frame_delta"):
        assert not getattr(got, k).detach().any()


def _random_jparams(case, seed):
    """JAX SceneParams at init plus seeded noise (lattice LATTICE)."""
    p = jpar.SceneParams.init(case["jbad"], lattice=LATTICE)
    rng = np.random.default_rng(seed)
    return p.replace(**{
        k: getattr(p, k) + jnp.asarray(
            rng.normal(0, 0.1, getattr(p, k).shape), jnp.float32)
        for k in tpar.FIELDS})


def test_params_from_numpy(case):
    """params_from_numpy carries the JAX fields across bit for bit; a
    missing lattice stays None."""
    ref = _jparams_dict(_random_jparams(case, 1))
    got = tpar.params_from_numpy(ref, "cpu")
    for k in tpar.FIELDS:
        assert np.array_equal(getattr(got, k).detach().numpy(), ref[k])
    none = tpar.params_from_numpy({**ref, "lattice_scalar": None}, "cpu")
    assert none.lattice_scalar is None


def _scene_outputs(s):
    """The parts of a scene apply_params writes."""
    m, c = s.mesh, s.camera
    return [m.positions, s.materials.albedo, s.materials.specular,
            s.materials.emissive, s.materials.roughness,
            s.materials.specular_percent, c.origin, c.lower_left,
            c.horizontal, c.vertical]


def test_apply_params_values_and_grads(case):
    """apply_params (lattice on) from seeded params: every output to
    VAL_RTOL / VAL_ATOL, and the gradients of a seeded weighting of them
    w.r.t. every field to GRAD_RTOL of the largest; the lattice's
    nonzero."""
    jp = _random_jparams(case, 2)
    rng = np.random.default_rng(3)
    ws = [rng.normal(size=np.shape(x)).astype(np.float32)
          for x in _scene_outputs(case["jbad"])]

    def jf(p):
        outs = _scene_outputs(jpar.apply_params(case["jbad"], p))
        return sum(jnp.sum(w * x) for w, x in zip(ws, outs)), outs

    (_, jouts), jg = jax.value_and_grad(jf, has_aux=True)(jp)
    tp = tpar.params_from_numpy(_jparams_dict(jp), "cpu")
    outs = _scene_outputs(apply_params(case["bad"], tp))
    for got, ref in zip(outs, jouts):
        np.testing.assert_allclose(got.detach().numpy(), _np(ref),
                                   rtol=VAL_RTOL, atol=VAL_ATOL)
    sum(torch.sum(torch.from_numpy(w) * x)
        for w, x in zip(ws, outs)).backward()
    for k in tpar.FIELDS:
        ref = _np(getattr(jg, k))
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(getattr(tp, k).grad.numpy(), ref,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=k)


def test_geometry_offsets_and_sample_lattice(case):
    """sample_lattice at seeded points, some outside the box (clamped),
    and geometry_offsets: values and lattice gradients equal JAX's to
    VAL_RTOL / GRAD_RTOL; the base positions and normals get no
    gradient (stop_gradient in the JAX package)."""
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(LATTICE,) * 3).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, (200, 3)).astype(np.float32)
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    w = rng.normal(size=200).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda l: jnp.sum(w * jpar.sample_lattice(
        l, jnp.asarray(pts), lo, hi)))(jnp.asarray(lat))
    tl = torch.from_numpy(lat).requires_grad_(True)
    tv = torch.sum(torch.from_numpy(w) * tpar.sample_lattice(
        tl, torch.from_numpy(pts), torch.from_numpy(lo), torch.from_numpy(hi)))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=VAL_RTOL)
    np.testing.assert_allclose(tl.grad.numpy(), _np(jg),
                               atol=GRAD_RTOL * np.abs(_np(jg)).max())

    jp = _random_jparams(case, 5)
    ref = jpar.geometry_offsets(case["jbad"], jp)
    tp = tpar.params_from_numpy(_jparams_dict(jp), "cpu")
    sc = case["bad"]
    pos = sc.mesh.positions.clone().requires_grad_(True)
    nrm = sc.mesh.normals.clone().requires_grad_(True)
    s = sc.replace(mesh=sc.mesh.replace(positions=pos, normals=nrm))
    got = tpar.geometry_offsets(s, tp)
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    got.sum().backward()
    assert pos.grad is None and nrm.grad is None
    assert tp.lattice_scalar.grad.abs().max() > 0


def test_priors_match_jax(case):
    """make_laplacian_reg and make_vertex_preconditioner on seeded
    offsets: the penalty and the smoothed offsets to VAL_RTOL, their
    gradients (the map's through a seeded cotangent) to GRAD_RTOL; an
    isolated (padded) vertex adds nothing and keeps its offset."""
    reg, pmap = _priors(tpri, case["bad"])
    jreg, jpmap = _priors(jpri, case["jbad"])
    nv = case["bad"].mesh.positions.shape[0]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(nv, 3)).astype(np.float32)
    cot = rng.normal(size=(nv, 3)).astype(np.float32)
    jp = jpar.SceneParams.init(case["jbad"]).replace(vertex_offsets=x)

    jr, jgr = jax.value_and_grad(lambda v: jreg(jp.replace(
        vertex_offsets=v)))(jnp.asarray(x))
    jm, jvjp = jax.vjp(lambda v: jpmap(jp.replace(
        vertex_offsets=v)).vertex_offsets, jnp.asarray(x))
    (jgm,) = jvjp(jnp.asarray(cot))

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = SceneParams.init(case["bad"]).replace(vertex_offsets=tx)
    r = reg(tp)
    r.backward()
    np.testing.assert_allclose(float(r.detach()), float(jr), rtol=VAL_RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgr),
                               atol=GRAD_RTOL * np.abs(_np(jgr)).max())
    tx.grad = None
    m = pmap(tp).vertex_offsets
    (m * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(m.detach().numpy(), _np(jm), rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgm),
                               atol=GRAD_RTOL * np.abs(_np(jgm)).max())
    # the padded vertex slots have no neighbours
    assert np.array_equal(m.detach().numpy()[-1], x[-1])
    x2 = x.copy()
    x2[-1] += 100.0
    assert float(reg(tp.replace(vertex_offsets=torch.from_numpy(x2)))) \
        == float(r.detach())


def test_render_rgbd_matches_jax(case):
    """render_rgbd of the corrupted scene from each view, through the
    packed finder over the carried LBVH: radiance and depth within
    IMG_ATOL of JAX's; the depth channel is 0 exactly where JAX's is."""
    jfinder = jax_make_finder(case["jbad"], case["jcfg"], case["jbvh"])
    finder = tinv.make_finder(case["bad"], case["cfg"], case["bvh"])
    for k, (jv, v) in enumerate(zip(case["views"],
                                    port_views(case["views"]))):
        ref = _np(jinv.render_rgbd(case["jbad"].replace(camera=jv),
                                   case["jcfg"],
                                   jax.random.fold_in(case["key"], k),
                                   jfinder))
        got = tinv.render_rgbd(case["bad"].replace(camera=v), case["cfg"],
                               trng.fold_in(trng.key(0), k), finder).numpy()
        assert got.shape == (CFG["height"], CFG["width"], 4)
        assert np.array_equal(got[..., 3] > 0, ref[..., 3] > 0)
        assert 20 < (ref[..., 3] > 0).sum() < ref[..., 3].size
        np.testing.assert_allclose(got, ref, atol=IMG_ATOL)


def test_fit_step_matches_jax(case, jax_fit):
    """STEPS steps of make_fit_step with the JAX fit's settings, under
    SGD at LR in both packages: each step's loss to LOSS_RTOL, every
    field after each step within SGD_RTOL of its largest change; the
    frozen fields never move, the trainable ones do, and the loss
    falls."""
    jl, jafter = jax_fit
    params, opt, step = _port_step(case, optim=torch.optim.SGD)
    init = {k: v.detach().clone() for k, v in params.named_parameters()}
    for i in range(STEPS):
        loss = _run(case, params, opt, step)[0]
        np.testing.assert_allclose(loss, jl[i], rtol=LOSS_RTOL)
        for k in tpar.FIELDS:
            ref = jafter[i][k]
            moved = np.abs(ref - init[k].numpy()).max()
            ulp = np.spacing(np.abs(ref).max().astype(np.float32))
            np.testing.assert_allclose(getattr(params, k).detach().numpy(),
                                       ref, rtol=0,
                                       atol=SGD_RTOL * moved + 2 * ulp,
                                       err_msg=f"step {i} {k}")
    for k in FROZEN:
        assert torch.equal(getattr(params, k), init[k]), k
    for k in TRAIN:
        assert not torch.equal(getattr(params, k), init[k]), k
    assert jl[-1] < jl[0]


@pytest.mark.parametrize("flags", [dict(leaf_tris=4),
                                   dict(node_lookahead=True)],
                         ids=["quad", "lookahead"])
def test_fit_step_layout_matches_jax(case, flags):
    """make_fit_step with leaf_tris=4 or node_lookahead=True walks the
    table those flags select, as the JAX step's make_finder does: a
    Packed4LBVH / PackedLALBVH, packed every step from the tree refitted
    to the realized positions. One step under SGD at LR in both packages
    (fault 3.8's rule): the loss to LOSS_RTOL, every field's change (the
    gradient times LR) within SGD_RTOL of its largest."""
    import dataclasses

    from raypt_torch.accel.packed import Packed4LBVH, PackedLALBVH
    from raypt_torch.render.integrator import pack_layout
    jcfg = dataclasses.replace(case["jcfg"], **flags)
    cfg = case["cfg"].replace(**flags)
    jreg, jpmap = _priors(jpri, case["jbad"])
    opt = optax.sgd(LR)
    jparams = jpar.SceneParams.init(case["jbad"], lattice=LATTICE)
    jstep = jinv.make_fit_step(case["jbad"], jcfg, opt, TRAIN,
                               bvh=case["jbvh"], loss_fn=rgbd_loss_jax,
                               render_fn=jinv.render_rgbd, param_reg=jreg,
                               param_map=jpmap)
    jafter, _, jl = jstep(jparams, opt.init(jparams), case["jstack"],
                          case["targets"], case["key"])
    jafter = _jparams_dict(jafter)

    tables = []

    def spy(scene, cfg, key, finder):
        tables.append((finder.args[0], scene.mesh.positions.detach()))
        return tinv.render_rgbd(scene, cfg, key, finder)

    reg, pmap = _priors(tpri, case["bad"])
    params = SceneParams.init(case["bad"], lattice=LATTICE)
    init = {k: v.detach().clone() for k, v in params.named_parameters()}
    step = make_fit_step(case["bad"], cfg, TRAIN, bvh=case["bvh"],
                         loss_fn=rgbd_loss, render_fn=spy, param_reg=reg,
                         param_map=pmap)
    loss = _run(case, params, torch.optim.SGD(params.parameters(), lr=LR),
                step)[0]
    table, pos = tables[0]
    assert type(table) is (Packed4LBVH if "leaf_tris" in flags
                           else PackedLALBVH)
    m = case["bad"].mesh
    want = pack_layout(cfg, tlbvh.refit(case["bvh"], pos, m.faces,
                                        m.face_valid), pos, m.faces,
                       m.face_valid)
    assert torch.equal(table.rows.view(torch.int32),
                       want.rows.view(torch.int32))
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_RTOL)
    for k in tpar.FIELDS:
        ref = jafter[k]
        if ref is None:
            continue
        moved = np.abs(ref - init[k].numpy()).max()
        ulp = np.spacing(np.abs(ref).max().astype(np.float32))
        np.testing.assert_allclose(getattr(params, k).detach().numpy(), ref,
                                   rtol=0, atol=SGD_RTOL * moved + 2 * ulp,
                                   err_msg=k)


def test_adam_matches_optax():
    """torch.optim.Adam at fit's settings against optax.adam on the same
    20 seeded gradients of 3,000 values of order 1, lr 0.03: within
    ADAM_ATOL."""
    rng = np.random.default_rng(10)
    x0 = rng.normal(size=3000).astype(np.float32)
    grads = rng.normal(size=(20, 3000)).astype(np.float32)
    opt = optax.adam(LR)
    x, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, x)
        x = optax.apply_updates(x, upd)
    t = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    topt = torch.optim.Adam([t], lr=LR)
    for g in grads:
        t.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(t.detach().numpy(), _np(x), rtol=0,
                               atol=ADAM_ATOL)


def _jax_fit_loop(case, resample, steps=2):
    return jinv.fit(case["jbad"], case["jcfg"], case["views"],
                    case["targets"][..., :3], FIT_TRAIN, steps=steps,
                    learning_rate=LR, bvh=case["jbvh"], key=case["key"],
                    resample_noise=resample)


@pytest.mark.parametrize("resample", [False, True])
def test_fit_matches_jax(case, resample):
    """fit (lattice off, the l2 loss on RGB, FIT_TRAIN trained, 2 steps)
    with resample_noise off and on: the losses to LOSS_RTOL,
    the params within FIT_ATOL; callback sees every step; resampling
    changes the second step's noise."""
    jparams, jl = _jax_fit_loop(case, resample)
    seen = []
    params, losses = fit(case["bad"], case["cfg"], port_views(case["views"]),
                         case["ttargets"][..., :3], FIT_TRAIN, steps=2,
                         learning_rate=LR, bvh=case["bvh"], key=trng.key(0),
                         resample_noise=resample,
                         callback=lambda i, p, loss: seen.append((i, loss)))
    assert seen == list(enumerate(losses))
    np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
    ref = _jparams_dict(jparams)
    assert np.abs(ref["specular_logits"] - _np(jpar.SceneParams.init(
        case["jbad"]).specular_logits)).max() > 0
    for k in tpar.FIELDS:
        if ref[k] is None:
            assert getattr(params, k) is None
            continue
        np.testing.assert_allclose(getattr(params, k).detach().numpy(),
                                   ref[k], rtol=0, atol=FIT_ATOL, err_msg=k)


def test_frozen_then_unfrozen_matches_jax(case):
    """Two steps with only albedo trainable, then one with the specular
    colour too, on one optimizer state: the params equal JAX's within
    FIT_ATOL and every field's Adam step count is 3, because frozen
    fields take zero gradients. With None in their place, torch's Adam
    skips them and starts the specular's count at 1: its first update is
    then about lr * sign(g) and lands far from JAX's."""
    jopt = optax.adam(LR)
    jp = jpar.SceneParams.init(case["jbad"])
    state = jopt.init(jp)
    jsteps = [jinv.make_fit_step(case["jbad"], case["jcfg"], jopt, train,
                                 bvh=case["jbvh"])
              for train in (FIT_TRAIN[:1], FIT_TRAIN)]
    for jstep in (jsteps[0], jsteps[0], jsteps[1]):
        jp, state, _ = jstep(jp, state, case["jstack"],
                             case["targets"][..., :3], case["key"])
    ref = _jparams_dict(jp)

    class NoneForFrozen(torch.optim.Adam):
        """Adam handed None for the gradients freeze_except zeroed."""
        def step(self, closure=None):
            for g in self.param_groups:
                for p in g["params"]:
                    if p.grad is not None and not p.grad.any():
                        p.grad = None
            return super().step(closure)

    out = {}
    for opt_cls in (torch.optim.Adam, NoneForFrozen):
        params = SceneParams.init(case["bad"])
        opt = opt_cls(params.parameters(), lr=LR)
        steps = [make_fit_step(case["bad"], case["cfg"], train,
                               bvh=case["bvh"])
                 for train in (FIT_TRAIN[:1], FIT_TRAIN)]
        for step in (steps[0], steps[0], steps[1]):
            step(params, opt, case["tviews"], case["ttargets"][..., :3],
                 trng.key(0))
        out[opt_cls] = (params, opt)
    params, opt = out[torch.optim.Adam]
    assert [int(opt.state[p]["step"]) for p in params.parameters()] == \
        [3] * len(list(params.parameters()))
    for k in ref:
        if ref[k] is not None:
            np.testing.assert_allclose(getattr(params, k).detach().numpy(),
                                       ref[k], rtol=0, atol=FIT_ATOL,
                                       err_msg=k)
    nparams, _ = out[NoneForFrozen]
    miss = np.abs(nparams.specular_logits.detach().numpy()
                  - ref["specular_logits"]).max()
    assert miss > 100 * FIT_ATOL


def test_freeze_except_zeros_not_none(case):
    """freeze_except sets frozen fields' gradients, and any field's
    missing gradient, to zero tensors; trainable gradients are kept."""
    params = SceneParams.init(case["bad"], lattice=LATTICE)
    params.albedo_logits.grad = torch.ones_like(params.albedo_logits)
    params.specular_logits.grad = torch.ones_like(params.specular_logits)
    freeze_except(params, ("albedo_logits", "vertex_offsets"))
    for k, p in params.named_parameters():
        assert p.grad is not None, k
        assert bool(p.grad.any()) == (k == "albedo_logits"), k


def test_step_loss_includes_prior(case):
    """The step's loss is the view mean plus param_reg at the params
    before the update."""
    p0, o0, s0 = _port_step(case, param_reg=None)
    p1, o1, s1 = _port_step(case)
    reg, _ = _priors(tpri, case["bad"])
    for p in (p0, p1):
        with torch.no_grad():
            p.vertex_offsets.copy_(torch.linspace(
                -0.05, 0.05, p.vertex_offsets.numel()).reshape(-1, 3))
    with torch.no_grad():
        r = reg(p1)
    assert float(r) > 0
    l0 = s0(p0, o0, case["tviews"], case["ttargets"], trng.key(0))
    l1 = s1(p1, o1, case["tviews"], case["ttargets"], trng.key(0))
    assert float(l1) == float(l0 + r)


def _sgd_delta(case, param_map=None, param_reg=None, loss_fn=rgbd_loss):
    """One step with SGD at lr 1 (so the update is minus the gradient)
    from zero offsets: the offsets' gradient."""
    params = SceneParams.init(case["bad"])
    opt = torch.optim.SGD(params.parameters(), lr=1.0)
    step = make_fit_step(case["bad"], case["cfg"], TRAIN, bvh=case["bvh"],
                         loss_fn=loss_fn, render_fn=tinv.render_rgbd,
                         param_map=param_map, param_reg=param_reg)
    step(params, opt, case["tviews"], case["ttargets"], trng.key(0))
    return -params.vertex_offsets.detach()


def _double(p):
    return p.replace(vertex_offsets=2.0 * p.vertex_offsets)


def test_prior_gradient_on_stored_params(case):
    """param_reg's gradient is taken on the stored (u-space) params:
    under a param_map that doubles the offsets, the prior c * sum(offsets)
    gives the gradient c, not 2c (the views' loss here gives none)."""
    c = 0.25
    g = _sgd_delta(case, param_map=_double,
                   param_reg=lambda p: c * p.vertex_offsets.sum(),
                   loss_fn=lambda img, tgt: 0.0 * img.sum())
    assert torch.equal(g, torch.full_like(g, c))


def test_param_map_inside_loss(case):
    """param_map runs inside the loss: a map doubling the offsets doubles
    their gradient, bit for bit (from zero offsets both renders are the
    same), and the gradient is not zero."""
    g = _sgd_delta(case)
    g2 = _sgd_delta(case, param_map=_double)
    assert g.abs().max() > 0
    assert torch.equal(g2, 2.0 * g)


def test_refit_every_step_moves_boxes(case):
    """Each step's finder walks the table of the tree refitted to that
    step's realized positions (pack(refit(bvh, positions)), bitwise);
    after the first update at least one internal box differs from step
    0's, and every valid triangle lies inside its parent's box. Without
    refit the boxes stay the build's."""
    tables, positions = [], []

    def spy(scene, cfg, key, finder):
        tables.append(finder.args[0].rows.clone())
        positions.append(scene.mesh.positions.detach().clone())
        return tinv.render_rgbd(scene, cfg, key, finder)

    params, opt, step = _port_step(case, render_fn=spy)
    _run(case, params, opt, step, n=3)
    tables, positions = tables[::2], positions[::2]   # one view a step
    m = case["bad"].mesh
    bvh = case["bvh"]
    ni = bvh.num_leaves - 1
    lf = torch.from_numpy(bvh.leaf_face.astype(np.int64))
    left = torch.from_numpy(bvh.left[:ni].astype(np.int64))
    children = (left, torch.from_numpy(bvh.skip.astype(np.int64))[left])
    for rows, pos in zip(tables, positions):
        ref = pack(tlbvh.refit(bvh, pos, m.faces, m.face_valid), pos, m.faces,
                   m.face_valid).rows
        assert torch.equal(rows.view(torch.int32), ref.view(torch.int32))
        for child in children:
            leaf = child >= ni
            face = lf[child[leaf] - ni]
            ok = m.face_valid[face]
            box = rows[:ni][leaf][ok]
            for k in range(3):
                p = pos[m.faces[face[ok], k].long()]
                assert (p >= box[:, 0:3]).all() and (p <= box[:, 3:6]).all()
    moved = [(t[:ni, 0:6] != tables[0][:ni, 0:6]).any(dim=1).sum()
             for t in tables[1:]]
    assert all(int(n) > 0 for n in moved), moved
    assert not torch.equal(positions[2], positions[0])

    tables.clear()
    params, opt, step = _port_step(case, render_fn=spy, refit=False)
    _run(case, params, opt, step, n=2)
    base = pack(bvh, m.positions, m.faces, m.face_valid).rows
    assert torch.equal(tables[2][:ni, 0:6], base[:ni, 0:6])


def test_cluster_route_refits_the_host_tree(case, monkeypatch):
    """On a route that clusters the LBVH on the host (backend
    "cluster"), each step hands make_finder the LBVH (numpy) refitted to
    that step's realized positions, as the JAX step hands its
    make_finder the refit; the boxes move after the first update."""
    seen = []
    real = tinv.make_finder

    def spy(scene, cfg, accel=None):
        seen.append((accel, scene.mesh.positions.detach().clone()))
        return real(scene, cfg, accel)

    monkeypatch.setattr(tinv, "make_finder", spy)
    params = SceneParams.init(case["bad"])
    opt = torch.optim.Adam(params.parameters(), lr=LR)
    step = make_fit_step(case["bad"], case["cfg"].replace(backend="cluster"),
                         TRAIN, bvh=case["bvh"])
    for _ in range(2):
        step(params, opt, case["tviews"], case["ttargets"][..., :3],
             trng.key(0))
    m = case["bad"].mesh
    for accel, pos in seen:
        assert isinstance(accel, tlbvh.LBVH)
        ref = tlbvh.refit(case["bvh"], pos, m.faces, m.face_valid)
        for k in ("bmin", "bmax"):
            assert np.array_equal(getattr(accel, k).view(np.int32),
                                  getattr(ref, k).view(np.int32))
    assert not np.array_equal(seen[1][0].bmin, seen[0][0].bmin)


def test_views_fold_in_the_key_and_finder_once(case, monkeypatch):
    """View i renders with fold_in(key, i), in view order, with the view's
    camera; make_finder runs once a step and every view gets its
    finder."""
    made, calls = [], []
    real = tinv.make_finder

    def counting(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    def spy(scene, cfg, key, finder):
        calls.append((key, finder, scene.camera.origin.detach().clone()))
        return tinv.render_rgbd(scene, cfg, key, finder)

    monkeypatch.setattr(tinv, "make_finder", counting)
    params, opt, step = _port_step(case, render_fn=spy)
    key = trng.key(11)
    _run(case, params, opt, step, n=2, key=key)
    assert len(made) == 2 and len(calls) == 4
    assert [c[0] for c in calls] == [trng.fold_in(key, i) for i in (0, 1)] * 2
    assert [c[1] for c in calls] == [made[0]] * 2 + [made[1]] * 2
    for i, c in enumerate(calls):
        assert torch.equal(c[2], view_at(case["tviews"], i % 2).origin)


def test_render_is_frame_0_of_the_key(case):
    """_render is frame 0 of the key, bit for bit render_frame(frame 0);
    render_rgbd's radiance is _render's."""
    sc = case["bad"].replace(camera=view_at(case["tviews"], 1))
    finder = tinv.make_finder(sc, case["cfg"], case["bvh"])
    key = trng.key(3)
    img = tinv._render(sc, case["cfg"], key, finder)
    assert torch.equal(img, render_frame(sc, case["cfg"], key, 0, finder))
    assert not torch.equal(img, render_frame(sc, case["cfg"], key, 1, finder))
    assert torch.equal(tinv.render_rgbd(sc, case["cfg"], key, finder)[..., :3],
                       img)


def test_loss_is_the_view_mean(case):
    """The step's loss is the sum of the views' losses over K."""
    t = case["ttargets"]
    params, opt, step = _port_step(
        case, param_reg=None,
        loss_fn=lambda img, tgt: tgt.sum() + 0.0 * img.sum())
    loss = _run(case, params, opt, step)[0]
    assert loss == float((0.0 + t[0].sum() + t[1].sum()) / 2)


def test_l2_image_loss_mask():
    """l2_image_loss: a (H, W) mask broadcasts over the channels, a full
    one multiplies elementwise."""
    rng = np.random.default_rng(8)
    a, b = (rng.normal(size=(4, 5, 3)).astype(np.float32) for _ in range(2))
    m2 = (rng.uniform(size=(4, 5)) < 0.5).astype(np.float32)
    m3 = rng.uniform(size=(4, 5, 3)).astype(np.float32)
    for m in (None, m2, m3):
        ref = float(jinv.l2_image_loss(a, b, None if m is None else m))
        got = float(l2_image_loss(torch.from_numpy(a), torch.from_numpy(b),
                                  None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_stack_and_view_at(case):
    """stack_views stacks each camera field on a leading axis; view_at
    takes view k back, bitwise."""
    views = port_views(case["views"])
    st = stack_views(views)
    assert st.origin.shape == (2, 3)
    for k, v in enumerate(views):
        for f in ("origin", "lower_left", "horizontal", "vertical"):
            assert torch.equal(getattr(view_at(st, k), f), getattr(v, f))


def test_sharded_routes_raise(case):
    """make_fit_step_sharded and fit(mesh=...) raise ValueError on views
    that do not divide over the mesh's ranks (the toy's 2 over 3), on a
    rank outside the mesh and on a mesh over another axis than
    "views"."""
    from raypt_torch.dist.sharding import Mesh
    with pytest.raises(ValueError, match="do not divide"):
        fit(case["bad"], case["cfg"], port_views(case["views"]),
            case["ttargets"], TRAIN, steps=1, mesh=Mesh(None, 3, 0, "views"))
    with pytest.raises(ValueError, match="not in the mesh"):
        tinv.make_fit_step_sharded(case["bad"], case["cfg"], TRAIN,
                                   mesh=Mesh(None, 1, -1, "views"))
    with pytest.raises(ValueError, match="'views' is sharded"):
        tinv.make_fit_step_sharded(case["bad"], case["cfg"], TRAIN,
                                   mesh=Mesh(None, 1, 0, "tiles"))

