"""raypt_torch's CUDA kernels against their plain torch versions on the
card, bitwise. Marked `gpu`; skipped where torch sees no CUDA device.
This file imports no JAX, so it runs on the GPU machine with

    python -m pytest tests/test_torch_gpu.py --noconftest -o addopts='' \
        -p no:cacheprovider -q
"""
from functools import partial

import pytest
import torch

from raypt_torch.accel.ctree import build_onehot
from raypt_torch.accel.host_bvh import build_sah
from raypt_torch.accel.traverse import (KERNELS, PLAIN, find_closest_onehot,
                                        onehot_inputs)
from raypt_torch.core.math3d import BIG
from raypt_torch.core.types import RenderConfig
from raypt_torch.render.integrator import make_finder, render_sample
from raypt_torch.rng import sampler as rng
from raypt_torch.scenes.builtin import stanford_bunny

pytestmark = pytest.mark.gpu

W = 256
GROUP = 8192
CFG = RenderConfig(width=W, height=W, samples_per_pixel=1, num_bounces=3,
                   backend="onehot", onehot_leaf=384, onehot_expand=8192,
                   onehot_compact=GROUP)


@pytest.fixture(scope="module")
def gpu_scene():
    """The bench scene at 256^2 on the card, with leaf-384 and leaf-16
    accels (8 and 40 mask words)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = stanford_bunny()
    b.camera.viewport_width = b.camera.viewport_height = W
    scene = b.freeze()
    m = scene.mesh
    bvh = build_sah(m)
    accels = {leaf: build_onehot(bvh, m.positions, m.faces, m.face_valid,
                                 leaf=leaf).to("cuda") for leaf in (384, 16)}
    return scene.to("cuda"), accels


def _plain_finder(accel):
    return partial(find_closest_onehot, accel=accel, ops=PLAIN,
                   expand_n=CFG.onehot_expand, compact_n=CFG.onehot_compact)


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("leaf,bounce", [(384, 0), (384, 1), (16, 1)])
def test_stages_bitwise(gpu_scene, leaf, bounce):
    """Each stage on one bounce's wavefront, fed the kernel's outputs of
    the stage before it."""
    scene, accels = gpu_scene
    waves = []
    finder = make_finder(scene, CFG, accels[384])

    def record(s, ro, rd, active=None):
        waves.append((ro.reshape(-1, 3), rd.reshape(-1, 3),
                      active.reshape(-1)))
        return finder(s, ro, rd, active)

    with torch.no_grad():
        render_sample(scene, CFG, rng.key(1), record)
    ro, rd, active = waves[bounce]
    accel = accels[leaf]
    o, d, t, a, _, _ = onehot_inputs(scene, ro, rd, active, GROUP)
    kc = KERNELS.compact(o, d, t, a, GROUP)
    pc = PLAIN.compact(o, d, t, a, GROUP)
    assert torch.equal(kc[3], pc[3])
    for x, y in zip(kc[:3], pc[:3]):
        assert _bits_equal(x[pc[3]], y[pc[3]])
    cwp = -(-accel.num_clusters // 256) * 8
    km, ku = KERNELS.walk(accel.table, *kc, cwp)
    pm, pu = PLAIN.walk(accel.table, *kc, cwp)
    assert torch.equal(km, pm) and torch.equal(ku, pu)
    seed = torch.where(kc[3], kc[2], torch.full_like(kc[2], -BIG))
    args = (km, ku, accel.clusters.tri_rows, kc[0], kc[1], seed)
    kt, kf = KERNELS.expand(*args)
    pt, pf = PLAIN.expand(*args)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert int((kf >= 0).sum()) > 0
    kut, kuf = KERNELS.uncompact(kt, kf, a, GROUP)
    put, puf = PLAIN.uncompact(kt, kf, a, GROUP)
    assert _bits_equal(kut[a], put[a]) and torch.equal(kuf[a], puf[a])


def test_render_bitwise_vs_plain_finder(gpu_scene):
    scene, accels = gpu_scene
    with torch.no_grad():
        img_k, tr_k = render_sample(scene, CFG, rng.key(2),
                                    make_finder(scene, CFG, accels[384]),
                                    return_alive=True)
        img_p, tr_p = render_sample(scene, CFG, rng.key(2),
                                    _plain_finder(accels[384]),
                                    return_alive=True)
    assert bool(torch.isfinite(img_k).all())
    assert _bits_equal(img_k, img_p) and torch.equal(tr_k, tr_p)
