"""raypt_torch's 16x16 render with gradients through each packed-table
layout (the cherry, lookahead and quad tables, packed in make_finder
from the LBVH) against the JAX package's: tests/test_torch_layouts.py's
scene, in a file of its own so that each file's share of a parallel
test run stays short."""
import jax
import numpy as np
import pytest

from raypt.core.types import RenderConfig as JaxConfig
from raypt.render import integrator as jint
from raypt.rng import frame_key, sample_key

from raypt_torch.core.types import scene_from_numpy
from raypt_torch.render import integrator as tint
from raypt_torch.rng import sampler as trng

from test_torch_layouts import LAYOUTS, NEW, W, _cfg, _jscene, _shared_lbvh
from test_torch_scene import jax_leaves

# the render and its gradients against JAX's through the same layout
# (test_torch_wide's tolerances; measured worst 9.5e-7 absolute on the
# image, 3.0e-7 of the largest albedo gradient)
IMG_ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def soup():
    """The scene in both packages and one LBVH in both (`_shared_lbvh`)."""
    jscene = _jscene(2, 300, 3)
    scene = scene_from_numpy(jax_leaves(jscene), "cpu")
    bvh, jbvh = _shared_lbvh(scene)
    return dict(jscene=jscene, jbvh=jbvh, scene=scene, bvh=bvh)


@pytest.fixture(scope="module")
def renders(soup):
    """JAX's W x W render (1 spp, 2 bounces) of the scene and the
    gradients of its mean w.r.t. positions and albedo, through each new
    layout's table of its own LBVH."""
    jscene = soup["jscene"]
    jskey = sample_key(frame_key(jax.random.key(0), 0), 0)
    out = {}
    for name in NEW:
        jcfg = JaxConfig(width=W, height=W, samples_per_pixel=1,
                         num_bounces=2, backend="bvh", **LAYOUTS[name][0])

        def jloss(pos, alb, jcfg=jcfg):
            s = jscene.replace(mesh=jscene.mesh.replace(positions=pos),
                               materials=jscene.materials.replace(albedo=alb))
            img = jint.render_sample(s, jcfg, jskey,
                                     jint.make_finder(s, jcfg, soup["jbvh"]))
            return img.mean(), img

        (jl, jimg), grads = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jscene.mesh.positions,
                                                  jscene.materials.albedo)
        out[name] = (float(jl), np.asarray(jimg),
                     tuple(np.asarray(g) for g in grads))
    return out


@pytest.mark.parametrize("name", NEW)
def test_render_grads_match_jax(soup, renders, name):
    """The W x W render through make_finder with the layout's flags (the
    table packed here from the LBVH) and its gradients against JAX's:
    image within IMG_ATOL, loss rtol 1e-5, gradients within GRAD_RTOL of
    their largest; the finder walks the layout's table."""
    s = soup["scene"]
    cfg = _cfg(name, width=W, height=W, samples_per_pixel=1, num_bounces=2)
    finder = tint.make_finder(s, cfg, soup["bvh"])
    assert type(finder.args[0]).__name__ == LAYOUTS[name][2].__name__
    pos = s.mesh.positions.clone().requires_grad_(True)
    alb = s.materials.albedo.clone().requires_grad_(True)
    st = s.replace(mesh=s.mesh.replace(positions=pos),
                   materials=s.materials.replace(albedo=alb))
    skey = trng.sample_key(trng.frame_key(trng.key(0), 0), 0)
    img = tint.render_sample(st, cfg, skey, finder)
    jl, jimg, jgrads = renders[name]
    np.testing.assert_allclose(img.detach().numpy(), jimg, atol=IMG_ATOL)
    img.mean().backward()
    np.testing.assert_allclose(float(img.mean().detach()), jl, rtol=1e-5)
    for got, want in zip((pos.grad, alb.grad), jgrads):
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got.numpy() - want).max()) <= GRAD_RTOL * scale
    assert float(alb.grad.abs().sum()) > 0
