"""raypt_torch.dist (the row-sharded render, sharded gradients, the
view-sharded fit step and the launcher) against the JAX package's
raypt.dist on conftest's 8-device virtual CPU mesh.

The port's ranks are processes: each group runs this file as a script
(`python tests/test_torch_dist.py WORKER spec.json rank n store out.npz`),
which imports the port only. The ranks meet over a file:// store in the
test's temporary directory (no port to collide under xdist), read their
inputs from an .npz and write their results to one; every process and
every collective has a timeout, so a hung rank fails the test. The JAX
references are computed here, in the parent, while the groups run.

Cases: the scene of tests/test_dist.py (`_scene`, 30 triangles and an
emissive sphere under a constant sky) rendered at 2 and 3 ranks at H 24
and 19 (19 pads a row at 2 ranks, two at 3) through bruteforce, and
through bvh at 2; its loss and gradients w.r.t. the albedo at 2 ranks,
with and without an onehot accel at leaf 16, and at 3 ranks (H 16 pads
two rows: the loss mask); the curved patch of tests/test_dist.py
(`_curved_patch`, a height field with varying normals under a gradient
sky) fitted by the view-sharded step over 2 ranks x 2 of 4 views under
SGD (ROADMAP fault 3.8: SGD across the packages), with the Laplacian
prior, against JAX's make_fit_step_sharded; and the launcher's render
over 2 ranks, against the one-process render's PNG."""
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "worker"
# seconds a group may take (its processes start torch, render and
# exchange results; about 10 s alone) and a rendezvous or collective may
# wait before it fails
GROUP_TIMEOUT = 240
DIST_TIMEOUT = 120
# the fit: views, steps, learning rate, prior weight (large enough that
# its gradient counted twice would move the offsets far beyond SGD_RTOL),
# trained fields, and the rgbd loss's depth weight (tests/test_dist.py's)
FIT_VIEWS = 4
FIT_STEPS = 2
FIT_LR = 1e-2
REG_W = 30.0
FIT_TRAIN = ("vertex_offsets", "albedo_logits")
DEPTH_W = 0.2
VIEW_FIELDS = ("origin", "lower_left", "horizontal", "vertical")

# images against JAX (XLA contracts multiply-adds, torch does not;
# measured worst 3.0e-8 absolute on radiance up to 5)
IMG_ATOL = 1e-5
# the sharded loss and gradients against JAX's: tests/test_dist.py's
# tolerances (measured worst: loss 2.6e-7 relative; gradients 2.4e-7
# absolute, of magnitudes up to 6.5)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
# the fit step's loss against JAX's (measured worst 1.4e-6 relative),
# and each field after a step within SGD_RTOL of its largest change plus
# two ulps of its largest value (tests/test_torch_diff.py's rule;
# measured worst 2.4e-6 of the change, vertex_offsets; the albedo's
# change is a few ulps). The prior counted twice would be 2.9e-3 of the
# offsets' change away.
STEP_LOSS_RTOL = 5e-6
SGD_RTOL = 1e-5


def _rgbd_loss(img, tgt):
    """tests/test_dist.py's rgbd_loss: RGB MSE plus DEPTH_W times the
    depth MSE where both image and target hit."""
    rgb = torch.mean((img[..., :3] - tgt[..., :3]) ** 2)
    both = (img[..., 3] > 0) & (tgt[..., 3] > 0)
    sq = (img[..., 3] - tgt[..., 3]) ** 2
    d = (torch.sum(torch.where(both, sq, torch.zeros_like(sq)))
         / torch.clamp(both.sum(), min=1))
    return rgb + DEPTH_W * d


def _albedo_loss(albedo, scene, cfg, key, pixel_ids, tgt, mask, accel=None):
    """tests/test_dist.py's slab loss: the squared error of one sample
    with the given albedo, masked by row."""
    from raypt_torch.render.integrator import make_finder, render_sample
    from raypt_torch.rng.sampler import frame_key, sample_key
    s = scene.replace(materials=scene.materials.replace(albedo=albedo))
    img = render_sample(s, cfg, sample_key(frame_key(key, 0), 0),
                        make_finder(s, cfg, accel), pixel_ids=pixel_ids)
    return torch.sum(((img - tgt) ** 2) * mask[:, None, None])


def _unpack(data, prefix):
    """The arrays of an .npz saved under "<prefix>__<name>"."""
    n = len(prefix) + 2
    return {k[n:]: data[k] for k in data.files if k.startswith(prefix + "__")}


def _port_scene(data, prefix):
    from raypt_torch.core.types import scene_from_numpy
    leaves = _unpack(data, prefix)
    leaves["env.is_cube"] = bool(leaves["env.is_cube"])
    return scene_from_numpy(leaves, "cpu")


def _port_views(data):
    from raypt_torch.core.types import CameraRays
    return CameraRays(**{f: torch.from_numpy(np.array(data[f"views__{f}"]))
                         for f in VIEW_FIELDS})


def _port_fit(data, mesh, spec, param_reg):
    """spec["fit"]'s steps of the view-sharded step over `mesh` (or of
    make_fit_step with mesh None) under SGD: the losses and each field
    after each step, as numpy."""
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.diff import SceneParams
    from raypt_torch.diff import inverse as tinv
    from raypt_torch.rng.sampler import key
    c = spec["fit"]
    bad = _port_scene(data, "bad")
    cfg = RenderConfig(**c["cfg"])
    kw = dict(loss_fn=_rgbd_loss, render_fn=tinv.render_rgbd,
              param_reg=param_reg)
    step = (tinv.make_fit_step(bad, cfg, FIT_TRAIN, **kw) if mesh is None
            else tinv.make_fit_step_sharded(bad, cfg, FIT_TRAIN, mesh, **kw))
    params = SceneParams.init(bad)
    opt = torch.optim.SGD(params.parameters(), lr=FIT_LR)
    views = _port_views(data)
    targets = torch.from_numpy(np.array(data["fit_targets"]))
    losses, after = [], []
    for _ in range(FIT_STEPS):
        losses.append(float(step(params, opt, views, targets, key(c["key"]))))
        after.append({k: v.detach().numpy().copy()
                      for k, v in params.named_parameters()})
    return losses, after


def _laplacian(data, weight):
    from raypt_torch.diff.priors import make_laplacian_reg
    faces, valid = data["bad__mesh.faces"], data["bad__mesh.face_valid"]
    nv = data["bad__mesh.positions"].shape[0]
    return make_laplacian_reg(faces, valid, nv, weight=weight)


def worker(spec_path, rank, n, store, out_path):
    """One rank of a group: every case of the spec, results to out_path."""
    torch.set_num_threads(1)
    from raypt_torch.accel.ctree import build_onehot, lbvh_from_numpy
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.dist import sharding
    from raypt_torch.rng.sampler import key
    with open(spec_path) as f:
        spec = json.load(f)
    data = np.load(spec["npz"])
    backend = sharding.init_distributed(store, n, rank, device="cpu",
                                        timeout=DIST_TIMEOUT)
    mesh = sharding.default_mesh()
    out = {"backend": np.array(backend), "mesh": np.array(
        [mesh.size, mesh.rank])}
    scene = _port_scene(data, "scene")
    m = scene.mesh
    tree = lbvh_from_numpy(*(data[f"bvh__{k}"] for k in
                             ("left", "skip", "bmin", "bmax", "leaf_face")))
    accels = {"bvh": tree, "onehot16": build_onehot(
        tree, m.positions, m.faces, m.face_valid, leaf=16)}
    for name, c in spec["renders"].items():
        out[f"render__{name}"] = sharding.render_frame_sharded(
            scene, RenderConfig(**c["cfg"]), key(c["key"]), mesh,
            bvh=accels.get(c.get("accel"))).numpy()
    for name, c in spec["grads"].items():
        loss, grad = sharding.loss_and_grad_sharded(
            _albedo_loss, scene, scene.materials.albedo,
            RenderConfig(**c["cfg"]), mesh,
            key(c["key"]), torch.from_numpy(data[f"target__{name}"]),
            bvh=accels.get(c.get("accel")))
        out[f"loss__{name}"] = loss.numpy()
        out[f"grad__{name}"] = grad.numpy()
    if "fit" in spec:
        reg = _laplacian(data, REG_W)
        losses, after = _port_fit(data, sharding.default_mesh(axis="views"),
                                  spec, reg)
        out["fit__losses"] = np.array(losses)
        for i, a in enumerate(after):
            for k, v in a.items():
                out[f"fit__{i}__{k}"] = v
    out["foreign"] = np.array(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "raypt")))
    torch.distributed.destroy_process_group()
    np.savez(out_path, **out)


def _spawn(args_of, n, tmp, env=None, name="group"):
    """Start n processes (args_of(rank) -> argv) in `tmp`; returns a
    function that waits for them (GROUP_TIMEOUT in all), kills them all
    if one fails or hangs, and raises with their output."""
    logs = [open(os.path.join(tmp, f"{name}{r}.log"), "w+") for r in range(n)]
    # one thread a rank: the groups run beside the other test workers
    procs = [subprocess.Popen(args_of(r), cwd=REPO, stdout=logs[r],
                              stderr=subprocess.STDOUT, env={
                                  **os.environ, "PYTHONPATH": REPO,
                                  "OMP_NUM_THREADS": "1",
                                  **(env(r) if env else {})})
             for r in range(n)]
    t0 = time.monotonic()

    def wait():
        try:
            for p in procs:
                p.wait(timeout=max(1.0, GROUP_TIMEOUT
                                   - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            pass
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for lg in logs:
            lg.seek(0)
            outs.append(lg.read())
            lg.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"{name}: ranks {bad} failed (rc "
                                 f"{[p.returncode for p in procs]}):\n"
                                 + "\n".join(o[-3000:] for o in outs))
        return outs

    return wait


if __name__ == "__main__":
    if sys.argv[1] != WORKER:
        raise SystemExit(f"usage: {sys.argv[0]} {WORKER} spec rank n store "
                         f"out")
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
           sys.argv[6])
    raise SystemExit(0)

# ---- the parent: the JAX package is the reference ----
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from raypt import dist as jdist  # noqa: E402
from raypt.accel import lbvh as jlbvh  # noqa: E402
from raypt.accel.ctree import build_onehot as jbuild_onehot  # noqa: E402
from raypt.core.types import RenderConfig as JaxConfig  # noqa: E402
from raypt.diff import inverse as jinv  # noqa: E402
from raypt.diff import params as jpar  # noqa: E402
from raypt.diff import priors as jpri  # noqa: E402
from raypt.render.integrator import (make_finder as jmake_finder,  # noqa: E402
                                     render_sample as jrender_sample)
from raypt.rng import frame_key as jframe_key  # noqa: E402
from raypt.rng import sample_key as jsample_key  # noqa: E402

from raypt_torch.accel.ctree import build_onehot, lbvh_from_numpy  # noqa: E402
from raypt_torch.core.types import RenderConfig, scene_from_numpy  # noqa: E402
from raypt_torch.diff import inverse as tinv  # noqa: E402
from raypt_torch.dist import launcher, sharding  # noqa: E402
from raypt_torch.render.integrator import (make_finder,  # noqa: E402
                                           render_frame)
from raypt_torch.rng import sampler as trng  # noqa: E402

from test_dist import _curved_patch, _scene  # noqa: E402
from test_torch_aovs import port_views  # noqa: E402
from test_torch_scene import jax_leaves  # noqa: E402

SCENE_SEED = 1234
BASE = dict(width=16, height=24, samples_per_pixel=1, num_bounces=2,
            backend="bruteforce", russian_roulette=True)
# name -> (ranks, cfg changes, key, accel)
RENDERS = {
    "h24": ((2, 3), {}, 5, None),
    "h19": ((2, 3), dict(height=19), 6, None),
    "bvh": ((2,), dict(backend="bvh"), 8, "bvh"),
}
GRADS = {
    "plain": ((2,), dict(width=8, height=16, russian_roulette=False), 7,
              None),
    "pad": ((3,), dict(width=8, height=16, russian_roulette=False), 9,
            None),
    "onehot": ((2,), dict(width=8, height=16, russian_roulette=False,
                          backend="onehot", onehot_expand=256,
                          onehot_compact=512), 12, "onehot16"),
}
FIT_CFG = dict(width=12, height=12, samples_per_pixel=1, num_bounces=2,
               backend="bruteforce", russian_roulette=False)
FIT_KEY = 3


def _cfg(changes):
    return {**BASE, **changes}


@pytest.fixture(scope="module")
def inputs():
    """The JAX scenes and inputs: _scene with its LBVH (the port's
    copies too) and the grads' targets (0.8 x the port's render); the
    curved patch's FIT_VIEWS views, RGB-D targets (the port's render_rgbd
    of view k with fold_in(key, k)) and corrupted scene
    (tests/test_dist.py's bump and albedo)."""
    scene = _scene(np.random.default_rng(SCENE_SEED))
    m = scene.mesh
    jbvh = jlbvh.build(m.positions, m.faces, m.face_valid)
    onehot = jbuild_onehot(jbvh, m.positions, m.faces, m.face_valid, leaf=16)
    arrays = {f"scene__{k}": np.asarray(v) for k, v in
              jax_leaves(scene).items()}
    arrays.update({f"bvh__{k}": np.asarray(getattr(jbvh, k)) for k in
                   ("left", "skip", "bmin", "bmax", "leaf_face")})
    tscene = _port_scene(_Arrays(arrays), "scene")
    tbvh = lbvh_from_numpy(*(arrays[f"bvh__{k}"] for k in
                             ("left", "skip", "bmin", "bmax", "leaf_face")))
    tm = tscene.mesh
    tonehot = build_onehot(tbvh, tm.positions, tm.faces, tm.face_valid,
                           leaf=16)
    for name, (_, ch, k, accel) in GRADS.items():
        img = render_frame(tscene, RenderConfig(**_cfg(ch)), trng.key(k),
                           accel=tonehot if accel else None)
        arrays[f"target__{name}"] = img.numpy() * np.float32(0.8)

    builder = _curved_patch()
    builder.camera.viewport_width = FIT_CFG["width"]
    builder.camera.viewport_height = FIT_CFG["height"]
    views = []
    for k in range(FIT_VIEWS):
        builder.camera.position = (0.25 * np.cos(2 * np.pi * k / FIT_VIEWS),
                                   0.25 * np.sin(2 * np.pi * k / FIT_VIEWS),
                                   0.0)
        views.append(builder.camera.rays())
    patch = builder.freeze()
    tpatch = scene_from_numpy(jax_leaves(patch), "cpu")
    cfg = RenderConfig(**FIT_CFG)
    finder = make_finder(tpatch, cfg)
    with torch.no_grad():
        targets = jnp.asarray(torch.stack([tinv.render_rgbd(
            tpatch.replace(camera=v), cfg, trng.fold_in(trng.key(FIT_KEY), k),
            finder) for k, v in enumerate(port_views(views))]).numpy())
    pw = np.asarray(patch.mesh.positions)
    bump = 0.25 * np.sin(1.7 * pw[:, 0]) * np.cos(1.3 * pw[:, 1])
    bad = patch.replace(
        mesh=patch.mesh.replace(positions=patch.mesh.positions + jnp.asarray(
            np.stack([0 * bump, 0 * bump, bump], -1), jnp.float32)),
        materials=patch.materials.replace(albedo=jnp.clip(
            patch.materials.albedo * 0.5 + 0.3, 0.02, 0.98)))
    arrays.update({f"bad__{k}": np.asarray(v) for k, v in
                   jax_leaves(bad).items()})
    stacked = jinv.stack_views(views)
    arrays.update({f"views__{f}": np.asarray(getattr(stacked, f))
                   for f in VIEW_FIELDS})
    arrays["fit_targets"] = np.asarray(targets)
    return dict(scene=scene, jbvh=jbvh, onehot=onehot, bad=bad,
                tscene=tscene, tbvh=tbvh,
                stacked=stacked, targets=targets, arrays=arrays)


@pytest.fixture(scope="module")
def groups(inputs, tmp_path_factory):
    """Start the 2-rank and 3-rank groups on their specs and the 2-rank
    launcher render; returns {name: wait()}, each wait returning the
    ranks' results (or the launcher's outputs)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    npz = os.path.join(tmp, "inputs.npz")
    np.savez(npz, **inputs["arrays"])
    waits = {}
    for n in (2, 3):
        spec = {"npz": npz,
                "renders": {k: dict(cfg=_cfg(ch), key=key, accel=acc)
                            for k, (ns, ch, key, acc) in RENDERS.items()
                            if n in ns},
                "grads": {k: dict(cfg=_cfg(ch), key=key, accel=acc)
                          for k, (ns, ch, key, acc) in GRADS.items()
                          if n in ns}}
        if n == 2:
            spec["fit"] = dict(cfg=FIT_CFG, key=FIT_KEY)
        path = os.path.join(tmp, f"spec{n}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        store = f"file://{tmp}/store{n}"
        outs = [os.path.join(tmp, f"out{n}_{r}.npz") for r in range(n)]
        wait = _spawn(lambda r, path=path, n=n, store=store, outs=outs: [
            sys.executable, os.path.abspath(__file__), WORKER, path, str(r),
            str(n), store, outs[r]], n, tmp, name=f"ranks{n}_")
        waits[n] = (wait, outs)
    png = os.path.join(tmp, "launcher.png")
    waits["launcher"] = (_spawn(
        lambda r: [sys.executable, "-m", "raypt_torch.dist.launcher",
                   "render", "--device", "cpu", "--size", "16", "-o", png],
        2, tmp, env=lambda r: {"RAYPT_COORDINATOR": f"file://{tmp}/store_l",
                               "RAYPT_NUM_PROCS": "2",
                               "RAYPT_PROC_ID": str(r)},
        name="launcher"), png)
    done = {}

    def result(name):
        if name not in done:
            wait, outs = waits[name]
            logs = wait()
            done[name] = (logs, outs) if name == "launcher" else \
                [dict(np.load(o)) for o in outs]
        return done[name]

    yield result
    for name in waits:          # a group no test waited for is still reaped
        if name not in done:
            try:
                result(name)
            except AssertionError:
                pass


def _ranks_agree(res, key):
    for r in res[1:]:
        assert np.array_equal(r[key].view(np.int32),
                              res[0][key].view(np.int32)), key


def _render_cases():
    return [(name, n) for name, (ns, _, _, _) in RENDERS.items() for n in ns]


@pytest.mark.parametrize("name,n", _render_cases())
def test_render_sharded_matches_jax(inputs, groups, name, n):
    """render_frame_sharded at n ranks: the same image on every rank,
    within IMG_ATOL of JAX's render_frame_sharded on an n-device mesh,
    and bitwise equal to the port's one-process render_frame."""
    _, ch, k, accel = RENDERS[name]
    res = groups(n)
    _ranks_agree(res, f"render__{name}")
    img = res[0][f"render__{name}"]
    cfg = _cfg(ch)
    assert img.shape == (cfg["height"], cfg["width"], 3)
    ref = np.asarray(jdist.render_frame_sharded(
        inputs["scene"], JaxConfig(**cfg), jax.random.key(k),
        jdist.default_mesh(n), bvh=inputs["jbvh"] if accel else None))
    np.testing.assert_allclose(img, ref, rtol=0, atol=IMG_ATOL)
    own = render_frame(inputs["tscene"], RenderConfig(**cfg), trng.key(k),
                       accel=inputs["tbvh"] if accel else None)
    assert np.array_equal(img.view(np.int32), own.numpy().view(np.int32))
    for r, out in enumerate(res):
        assert out["backend"] == "gloo" and out["mesh"].tolist() == [n, r]
        assert out["foreign"].size == 0, out["foreign"]


class _Arrays:
    """An .npz-like view of a dict of arrays."""

    def __init__(self, arrays):
        self._a = arrays
        self.files = list(arrays)

    def __getitem__(self, k):
        return self._a[k]


def _jax_loss_fn(albedo, scene_in, cfg_in, key_in, pixel_ids, tgt, mask,
                 accel_in=None):
    s = scene_in.replace(materials=scene_in.materials.replace(albedo=albedo))
    img = jrender_sample(s, cfg_in, jsample_key(jframe_key(key_in, 0), 0),
                         jmake_finder(s, cfg_in, accel_in),
                         pixel_ids=pixel_ids)
    return jnp.sum(((img - tgt) ** 2) * mask[:, None, None])


@pytest.mark.parametrize("name", list(GRADS))
def test_loss_and_grad_sharded_matches_jax(inputs, groups, name):
    """loss_and_grad_sharded (the albedo's gradient of the masked
    squared error) at GRADS' ranks, with the onehot accel at leaf 16 in
    "onehot": the same loss and gradients on every rank, within
    tests/test_dist.py's tolerances of JAX's loss_and_grad_sharded on a
    mesh of as many devices; nonzero gradients."""
    (n,), ch, k, accel = GRADS[name]
    res = groups(n)
    _ranks_agree(res, f"loss__{name}")
    _ranks_agree(res, f"grad__{name}")
    scene = inputs["scene"]
    # jitted: raypt.dist's loss_and_grad_sharded is not, and its
    # shard_map body then runs op by op (about 70 s a case)
    jl, jg = jax.jit(partial(jdist.loss_and_grad_sharded, _jax_loss_fn,
                             cfg=JaxConfig(**_cfg(ch)),
                             mesh=jdist.default_mesh(n)))(
        scene, scene.materials.albedo, key=jax.random.key(k),
        targets=jnp.asarray(inputs["arrays"][f"target__{name}"]),
        bvh=inputs["onehot"] if accel else None)
    loss, grad = res[0][f"loss__{name}"], res[0][f"grad__{name}"]
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert np.abs(grad).max() > 0
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.fixture(scope="module")
def jax_fit(inputs):
    """FIT_STEPS steps of JAX's make_fit_step_sharded over a 2-device
    "views" mesh under SGD at FIT_LR, with the Laplacian prior at REG_W:
    the losses and the params after each step."""
    bad = inputs["bad"]
    faces, valid = np.asarray(bad.mesh.faces), np.asarray(bad.mesh.face_valid)
    reg = jpri.make_laplacian_reg(faces, valid, bad.mesh.positions.shape[0],
                                  weight=REG_W)
    sgd = optax.sgd(FIT_LR)
    step = jinv.make_fit_step_sharded(
        bad, JaxConfig(**FIT_CFG), sgd, FIT_TRAIN,
        JaxMesh(np.array(jax.devices()[:2]), ("views",)),
        loss_fn=_jax_rgbd_loss, render_fn=jinv.render_rgbd, param_reg=reg)
    params = jpar.SceneParams.init(bad)
    state = sgd.init(params)
    losses, after = [], []
    for _ in range(FIT_STEPS):
        params, state, loss = step(params, state, inputs["stacked"],
                                   inputs["targets"],
                                   jax.random.key(FIT_KEY))
        losses.append(float(loss))
        after.append({k: np.asarray(getattr(params, k)) for k in FIT_TRAIN})
    return losses, after, {k: np.asarray(getattr(jpar.SceneParams.init(bad),
                                                  k)) for k in FIT_TRAIN}


def _jax_rgbd_loss(img, tgt):
    rgb = jnp.mean((img[..., :3] - tgt[..., :3]) ** 2)
    both = (img[..., 3] > 0) & (tgt[..., 3] > 0)
    d = (jnp.sum(jnp.where(both, (img[..., 3] - tgt[..., 3]) ** 2, 0.0))
         / jnp.maximum(jnp.sum(both), 1))
    return rgb + DEPTH_W * d


def _close_fields(got, ref, init, what):
    """Each trained field within SGD_RTOL of its largest change from
    init, plus two ulps of its largest value."""
    for k in FIT_TRAIN:
        moved = np.abs(ref[k] - init[k]).max()
        assert moved > 0, (what, k)
        ulp = np.spacing(np.abs(ref[k]).max().astype(np.float32))
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=SGD_RTOL * moved + 2 * ulp,
                                   err_msg=f"{what} {k}")


def test_fit_step_sharded_matches_jax(groups, jax_fit):
    """FIT_STEPS steps of make_fit_step_sharded over 2 ranks x 2 views
    (SGD, the Laplacian prior): every parameter bitwise equal across the
    ranks; each step's loss within STEP_LOSS_RTOL of JAX's
    make_fit_step_sharded on a 2-device mesh and the trained fields
    within SGD_RTOL of its change."""
    res = groups(2)
    jl, jafter, init = jax_fit
    for i in range(FIT_STEPS):
        for k in FIT_TRAIN:
            _ranks_agree(res, f"fit__{i}__{k}")
        got = {k: res[0][f"fit__{i}__{k}"] for k in FIT_TRAIN}
        _close_fields(got, jafter[i], init, f"step {i}")
    _ranks_agree(res, "fit__losses")
    np.testing.assert_allclose(res[0]["fit__losses"], jl,
                               rtol=STEP_LOSS_RTOL)


def test_param_reg_counted_once(inputs, groups):
    """The prior's gradient enters the two-rank step once: the step's
    parameters are within SGD_RTOL of the one-process make_fit_step's
    with the same prior, while one with the prior at twice REG_W lands
    far outside it (so counting it twice would show)."""
    res = groups(2)
    data = _Arrays(inputs["arrays"])
    spec = {"fit": dict(cfg=FIT_CFG, key=FIT_KEY)}
    _, once = _port_fit(data, None, spec, _laplacian(data, REG_W))
    _, twice = _port_fit(data, None, spec, _laplacian(data, 2 * REG_W))
    from raypt_torch.diff import SceneParams
    init = {k: v.detach().numpy() for k, v in SceneParams.init(
        _port_scene(data, "bad")).named_parameters()}
    got = {k: res[0][f"fit__{FIT_STEPS - 1}__{k}"] for k in FIT_TRAIN}
    _close_fields(got, once[-1], init, "prior once")
    with pytest.raises(AssertionError):
        _close_fields(got, twice[-1], init, "prior twice")


def test_fit_step_sharded_one_rank_bitwise(inputs):
    """On a one-process mesh the view-sharded step is make_fit_step, bit
    for bit: losses and every parameter after each step."""
    data = _Arrays(inputs["arrays"])
    spec = {"fit": dict(cfg=FIT_CFG, key=FIT_KEY)}
    reg = _laplacian(data, REG_W)
    with _deterministic():
        a = _port_fit(data, sharding.default_mesh(axis="views"), spec, reg)
        b = _port_fit(data, None, spec, reg)
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        for k in x:
            assert np.array_equal(x[k].view(np.int32), y[k].view(np.int32)), k


class _deterministic:
    """torch.use_deterministic_algorithms(True) within: the CPU's
    index_put_ accumulate (an index gather's backward) otherwise adds
    with atomics across threads, so two runs differ in the last bits."""

    def __enter__(self):
        self.was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was)


def test_fit_views_must_divide(inputs):
    """K views that do not divide over the ranks raise ValueError."""
    data = _Arrays(inputs["arrays"])
    bad = _port_scene(data, "bad")
    mesh = sharding.Mesh(None, 3, 0, "views")
    step = tinv.make_fit_step_sharded(bad, RenderConfig(**FIT_CFG),
                                      FIT_TRAIN, mesh)
    from raypt_torch.diff import SceneParams
    params = SceneParams.init(bad)
    with pytest.raises(ValueError, match="do not divide"):
        step(params, torch.optim.SGD(params.parameters(), lr=FIT_LR),
             _port_views(data),
             torch.from_numpy(np.array(data["fit_targets"])),
             trng.key(0))


def test_fit_with_mesh_one_rank_equals_fit(inputs):
    """fit(mesh=default_mesh()) on one process equals fit(): the losses
    and every parameter, bitwise."""
    data = _Arrays(inputs["arrays"])
    bad = _port_scene(data, "bad")
    views = _port_views(data)
    frames = [tinv.view_at(views, k) for k in range(FIT_VIEWS)]
    targets = torch.from_numpy(np.array(data["fit_targets"][..., :3]))
    cfg = RenderConfig(**FIT_CFG)
    with _deterministic():
        runs = [tinv.fit(bad, cfg, frames, targets, FIT_TRAIN, steps=2,
                         mesh=mesh) for mesh in (
                             sharding.default_mesh(axis="views"), None)]
    assert runs[0][1] == runs[1][1]
    for k, v in runs[0][0].named_parameters():
        assert torch.equal(v, getattr(runs[1][0], k)), k


def test_default_mesh_without_group():
    """With no process group: the one-process mesh; a larger one raises."""
    mesh = sharding.default_mesh()
    assert (mesh.group, mesh.size, mesh.rank, mesh.axis) == (None, 1, 0,
                                                             "tiles")
    assert sharding.default_mesh(axis="views").axis == "views"
    with pytest.raises(ValueError):
        sharding.default_mesh(2)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("h", [16, 19])
def test_row_perm_and_pad_bitwise(n, h):
    """_pad_rows and _strided_row_perm equal JAX's, bitwise."""
    from raypt.dist import sharding as jsh
    assert sharding._pad_rows(h, n) == jsh._pad_rows(h, n)
    hp = h + sharding._pad_rows(h, n)
    got = sharding._strided_row_perm(hp, n).numpy()
    assert np.array_equal(got, np.asarray(jsh._strided_row_perm(hp, n)))
    assert sorted(got.tolist()) == list(range(hp))


def test_pick_backend():
    """The fixed rule: NCCL with a card a rank, gloo when ranks share a
    card or the tensors lie on the CPU. Without a count of the ranks on
    this host, all of them are taken to be on it."""
    assert sharding.pick_backend("cuda", 1, 1) == "nccl"
    assert sharding.pick_backend("cuda", 4, 4) == "nccl"
    assert sharding.pick_backend("cuda", 2, 1) == "gloo"
    assert sharding.pick_backend("cuda", 16, 8) == "gloo"
    assert sharding.pick_backend("cpu", 2, 0) == "gloo"
    assert sharding.pick_backend("cpu", 1, 8) == "gloo"


@pytest.mark.parametrize("n,local,cards,want", [
    (16, 8, 8, "nccl"),      # two hosts of 8 cards, a card a rank
    (16, 4, 8, "nccl"),
    (16, 16, 8, "gloo"),     # one host: two ranks a card
    (4, 2, 1, "gloo"),       # two hosts, two ranks on each one card
])
def test_pick_backend_across_hosts(n, local, cards, want):
    """Across hosts the rule counts the ranks on this host, not the
    world: NCCL when they are no more than its cards."""
    assert sharding.pick_backend("cuda", n, cards, local) == want
    assert sharding.pick_backend("cpu", n, cards, local) == "gloo"


def test_mesh_axis_refused(inputs):
    """Each sharded function takes a mesh over its own axis only, as
    shard_map's P("tiles") and P("views") do: the render and the
    sharded gradient refuse a "views" mesh, the fit step and fit()
    refuse a "tiles" one."""
    data = _Arrays(inputs["arrays"])
    bad = _port_scene(data, "bad")
    cfg = RenderConfig(**FIT_CFG)
    views = sharding.default_mesh(axis="views")
    tiles = sharding.default_mesh()
    with pytest.raises(ValueError, match="'tiles' is sharded"):
        sharding.render_frame_sharded(bad, cfg, trng.key(0), views)
    with pytest.raises(ValueError, match="'tiles' is sharded"):
        sharding.loss_and_grad_sharded(
            _albedo_loss, bad, bad.materials.albedo, cfg, views,
            trng.key(0), torch.zeros((cfg.height, cfg.width, 3)))
    with pytest.raises(ValueError, match="'views' is sharded"):
        tinv.make_fit_step_sharded(bad, cfg, FIT_TRAIN, tiles)
    pv = _port_views(data)
    with pytest.raises(ValueError, match="'views' is sharded"):
        tinv.fit(bad, cfg, [tinv.view_at(pv, k) for k in range(FIT_VIEWS)],
                 torch.from_numpy(np.array(data["fit_targets"][..., :3])),
                 FIT_TRAIN, steps=1, mesh=tiles)


def test_init_distributed_without_coordinator():
    """No coordinator: a no-op (one process)."""
    assert sharding.init_distributed() is None
    assert not torch.distributed.is_initialized()


def test_setup_from_env_mapping(monkeypatch):
    """setup_from_env passes RAYPT_COORDINATOR, RAYPT_NUM_PROCS,
    RAYPT_PROC_ID (defaults 1 and 0), RAYPT_LOCAL_PROCS (default
    RAYPT_NUM_PROCS) and the device to init_distributed, and does
    nothing without a coordinator."""
    calls = []
    monkeypatch.setattr(sharding, "init_distributed",
                        lambda *a, **kw: calls.append((a, kw)) or "gloo")
    for k in ("RAYPT_COORDINATOR", "RAYPT_NUM_PROCS", "RAYPT_PROC_ID",
              "RAYPT_LOCAL_PROCS"):
        monkeypatch.delenv(k, raising=False)
    assert launcher.setup_from_env() is None and not calls
    monkeypatch.setenv("RAYPT_COORDINATOR", "10.0.0.1:1234")
    assert launcher.setup_from_env("cpu") == "gloo"
    monkeypatch.setenv("RAYPT_NUM_PROCS", "4")
    monkeypatch.setenv("RAYPT_PROC_ID", "3")
    launcher.setup_from_env()
    monkeypatch.setenv("RAYPT_LOCAL_PROCS", "2")
    launcher.setup_from_env()
    assert calls == [
        (("10.0.0.1:1234", 1, 0), dict(device="cpu", local_processes=1)),
        (("10.0.0.1:1234", 4, 3), dict(device="cuda", local_processes=4)),
        (("10.0.0.1:1234", 4, 3), dict(device="cuda", local_processes=2))]


def test_launcher_render_two_ranks(groups, tmp_path):
    """`python -m raypt_torch.dist.launcher render --device cpu --size
    16` over two ranks (the env's file:// store): rank 0 writes the PNG,
    byte for byte the one-process render_frame's at the launcher's
    settings (cornell_bunny, 4 spp, 4 bounces, bvh over its LBVH, key
    0); each rank logs gloo and its rank."""
    logs, png = groups("launcher")
    from raypt_torch.accel import lbvh
    from raypt_torch.io.image import write_png
    from raypt_torch.render.tonemap import to_display
    from raypt_torch.scenes.builtin import cornell_box_with_bunny
    b = cornell_box_with_bunny()
    b.camera.viewport_width = b.camera.viewport_height = 16
    scene = b.freeze("cpu")
    m = scene.mesh
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=4,
                       num_bounces=4, backend="bvh")
    img = render_frame(scene, cfg, trng.key(0),
                       accel=lbvh.build(m.positions, m.faces, m.face_valid))
    ref = str(tmp_path / "ref.png")
    write_png(ref, to_display(img))
    with open(png, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    for r, log in enumerate(logs):
        assert f"rank {r} of 2, backend gloo" in log, log
        assert f"process {r}/2" in log, log
