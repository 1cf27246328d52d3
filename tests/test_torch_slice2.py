"""The two render paths of raypt_torch's second slice against the JAX
package, as tests/test_torch_integrator.py holds the first: the bench
scene (stanford_bunny, 1 spp, 4 bounces, roulette) at 32x32 through

  * "dense_union": backend "onehot" with onehot_expand = 0 (the JAX
    package's default branch), leaf 64;
  * "cluster": backend "cluster", clusters at CLUSTER_LEAF = 64;

with the same scene, key and JAX-built accel in both packages (the JAX
kernels run in interpret mode); then the bench loss's gradients, from
the bench view and from one outside the mesh, where the gradient w.r.t.
positions is not 0."""
import numpy as np
import pytest
import torch

from raypt_torch.accel import clusters as tcl
from raypt_torch.accel import ctree as tctree
from raypt_torch.render import integrator as tint

from test_torch_integrator import OUTSIDE_VIEW, W, run_slice
from test_torch_scene import jax_lbvh_to_port

torch.set_num_threads(2)

BASE = dict(width=W, height=W, samples_per_pixel=1, num_bounces=4,
            russian_roulette=True, onehot_leaf=64)
PATHS = {"dense_union": dict(BASE, backend="onehot", onehot_expand=0,
                             onehot_compact=0),
         "cluster": dict(BASE, backend="cluster")}


@pytest.fixture(scope="module", params=sorted(PATHS))
def bench_run(request):
    return run_slice(cfg_kw=PATHS[request.param])


@pytest.fixture(scope="module", params=sorted(PATHS))
def outside_run(request):
    return run_slice(OUTSIDE_VIEW, cfg_kw=PATHS[request.param])


def test_image_matches_jax(bench_run):
    """allclose at rtol 1e-4, atol 1e-5 with no pixel off tolerance; the
    share of pixels off is what is asserted, and it must be 0 (measured:
    bitwise equal on both paths)."""
    _, jimg, _, _, _ = bench_run["jax"]
    _, img, _, _, _ = bench_run["torch"]
    assert img.shape == jimg.shape == (W, W, 3)
    assert np.isfinite(img).all()
    off = ~np.isclose(img, jimg, rtol=1e-4, atol=1e-5)
    assert off.mean() == 0.0, (off.mean(), np.abs(img - jimg).max())


def test_traced_per_bounce_equal(bench_run):
    """Rays alive at the start of each bounce: equal counts."""
    assert np.array_equal(bench_run["torch"][2], bench_run["jax"][2])
    assert bench_run["torch"][2][0] == W * W


def test_loss_grads_match_jax(bench_run):
    """Bench loss and gradients, with test_torch_integrator's tolerances:
    loss rtol 1e-6, albedo grads within 1e-5 of their largest magnitude,
    position grads atol 1e-9 (0 in both packages from the bench camera,
    inside the stand-in bunny). Measured on both paths: loss 9.9e-8
    relative, albedo 1.7e-7 of the largest, positions 0."""
    jl, _, _, jgv, jga = bench_run["jax"]
    tl, _, _, tgv, tga = bench_run["torch"]
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert np.abs(jga).max() > 0
    assert np.abs(tga - jga).max() <= 1e-5 * np.abs(jga).max()
    np.testing.assert_allclose(tgv, jgv, atol=1e-9)


def test_position_grads_match_jax(outside_run):
    """From OUTSIDE_VIEW: position grads nonzero on the same vertices in
    both packages (at least 100) and within 1e-4 of their largest
    magnitude; loss and albedo grads as above. Measured on both paths:
    312 vertex rows, worst 6.1e-6 of the largest; loss 8.0e-7, albedo
    1.0e-6 (the image differs by 2.4e-7 at most)."""
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


def test_make_finder_from_lbvh(bench_run):
    """make_finder clusters an LBVH itself (onehot at cfg.onehot_leaf,
    clusters at CLUSTER_LEAF): from the JAX package's SAH tree it builds
    the accel bitwise equal to the JAX one, so the render is bitwise the
    same as with the accel passed in."""
    from raypt.accel.host_bvh import build_sah as jax_build_sah
    from raypt.scenes import builtin as jax_scenes
    b = jax_scenes.stanford_bunny()
    b.camera.viewport_width = b.camera.viewport_height = W
    bvh = jax_lbvh_to_port(jax_build_sah(b.freeze().mesh))
    scene, cfg, skey = bench_run["scene"], bench_run["cfg"], bench_run["skey"]
    m = scene.mesh
    built = {"onehot": lambda: tctree.build_onehot(
                 bvh, m.positions, m.faces, m.face_valid, cfg.onehot_leaf),
             "cluster": lambda: tcl.build_clusters(
                 bvh, m.positions, m.faces, m.face_valid, tcl.CLUSTER_LEAF)}
    acc = built[cfg.backend]()
    rows = acc.tri_rows if cfg.backend == "cluster" else acc.clusters.tri_rows
    ref_rows = (bench_run["accel"].tri_rows if cfg.backend == "cluster"
                else bench_run["accel"].clusters.tri_rows)
    assert torch.equal(rows.view(torch.int32), ref_rows.view(torch.int32))
    with torch.no_grad():
        img = tint.render_sample(scene, cfg, skey,
                                 tint.make_finder(scene, cfg, bvh))
    assert np.array_equal(img.numpy(), bench_run["torch"][1])
