"""The onehot finder's ray-sort and tiling options and the cluster
finder's use_pallas of raypt_torch against the JAX package, on seeded
numpy inputs over the bench scene's stand-in bunny (leaf 128; R = 2,048
rays with ~40% dead): sort_rays ("alive", "mask", True)
on the dense-union, Woop and non-fused branches, segment_sort,
overflow_fallback, tile_b and walk_tile, each with the same arguments on
both sides (JAX kernels in interpret mode; where the JAX routing keeps
its per-ray mask walk whichever walk it takes, through its plain walk,
which tests/test_torch_worklist.py holds bitwise to the kernel). The
port's own property, that every option's result is bitwise the result
with no option, is tests/test_torch_onehot_exact.py's;
find_closest_cluster(use_pallas=False) is held against JAX in
tests/test_torch_cluster.py.

The CUDA kernels run only on the card: test_torch_gpu.py and
chip_smoke.py hold the options' renders there bitwise against the plain
versions and against no option."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.traverse import find_closest_onehot as jax_find_onehot
from raypt.core.math3d import BIG

from raypt_torch.accel.traverse import PLAIN, find_closest_onehot
from raypt_torch.kernels import cluster_pallas as tdn

from test_torch_cluster import (T_ATOL, T_RTOL, _onehot, _t, _wavefront,
                                bunny)  # noqa: F401  (bunny is a fixture)
from test_torch_scene import jax_accel_to_port

torch.set_num_threads(2)

R = 2048
# t against JAX: test_torch_cluster's T_RTOL/T_ATOL on the Moller-
# Trumbore branches; the Woop branch's t = -o'w / d'w divides sums that
# cancel, and the JAX kernel sums its affine products in another order,
# so there the finder tests' Woop tolerance (chip_smoke.WOOP_T_RTOL /
# WOOP_T_ATOL, as tests/test_onehot.py holds Woop against Moller-
# Trumbore)
WOOP_RTOL, WOOP_ATOL = 1e-3, 1e-4
_WOOP = {}


def _accel(bunny, branch):
    """(JAX accel, port accel) at leaf 128; the Woop branch's carries the
    Woop table (built once a module)."""
    if branch != "woop":
        return _onehot(bunny, 128)
    scene, bvh, _ = bunny
    if id(scene) not in _WOOP:
        m = scene.mesh
        ref = jax_build_onehot(bvh, m.positions, m.faces, m.face_valid,
                               leaf=128, with_woop=True)
        _WOOP[id(scene)] = (scene, ref, jax_accel_to_port(ref))
    return _WOOP[id(scene)][1:]


# branch -> the finder's keywords that select it (the Woop branch: its
# accel); expand_n 256 selects the per-ray-exact branch where no sort
# is asked for
BRANCHES = {"dense": dict(expand_n=0), "woop": dict(expand_n=0),
            "unfused": dict(expand_n=0, use_pallas_intersect=False),
            "expand": dict(expand_n=256)}
# (id, branch, options); "plain_walk": the JAX side may take its plain
# walk (the options route to the per-ray mask walk either way)
OPTIONS = [
    *[(f"{b}-sort-{m}", b, dict(sort_rays=m), True)
      for b in ("dense", "woop", "unfused")
      for m in ("alive", "mask", True)],
    ("dense-segment-2048", "dense", dict(segment_sort=2048), False),
    # no 1,536-ray segment divides the 2,048 rays: a no-op
    ("dense-segment-1536", "dense", dict(segment_sort=1536), False),
    ("unfused-no-fallback-cap-2", "unfused",
     dict(overflow_fallback=False, cap=2), True),
    ("dense-tile_b-128", "dense", dict(tile_b=128), False),
    ("dense-tile_b-512", "dense", dict(tile_b=512), False),
    ("expand-walk_tile-512", "expand", dict(walk_tile=512), False),
]


def _port(bunny, branch, ro, rd, active, **kw):
    _, acc = _accel(bunny, branch)
    return find_closest_onehot(bunny[2], _t(ro), _t(rd), _t(active),
                               accel=acc, compact_n=0,
                               **dict(BRANCHES[branch], **kw))


def _agree(got, ref, active, woop=False, min_hits=None):
    """Same sphere and face on every live ray, t within the branch's
    tolerance there, at least min_hits triangle hits (a tenth of the
    live rays when None); dead rays miss."""
    a = torch.from_numpy(active)
    rt, rtri, rsph = (torch.from_numpy(np.array(x)) for x in
                      (ref.t, ref.tri, ref.sphere))
    n = int(a.sum()) // 10 if min_hits is None else min_hits
    assert int((rtri[a] >= 0).sum()) > n
    assert torch.equal(got.sphere[a], rsph[a])
    assert torch.equal(got.tri[a], rtri[a])
    rtol, atol = (WOOP_RTOL, WOOP_ATOL) if woop else (T_RTOL, T_ATOL)
    torch.testing.assert_close(got.t[a], rt[a], rtol=rtol, atol=atol)
    assert bool((got.t[~a] == BIG).all() and (got.tri[~a] == -1).all())


@pytest.mark.parametrize("name,branch,opts,plain_walk", OPTIONS,
                         ids=[o[0] for o in OPTIONS])
def test_option_matches_jax(bunny, name, branch, opts, plain_walk):
    """find_closest_onehot with the option against the JAX finder with
    the same arguments. Faces and spheres equal on every live ray, t
    within T_RTOL/T_ATOL, on the Woop branch WOOP_RTOL/WOOP_ATOL
    (measured over these cases: faces equal; worst t 1.2e-3 absolute at
    t = 891, which is 1.3e-6 relative, and 1.2e-4 relative at t =
    0.0016, 1.9e-7 absolute; Woop 6.7e-4 absolute at t = 471, 4.0e-4
    relative at t = 0.090). Without the fallback at cap 2 most live
    rays miss their hit, on both sides alike."""
    rng = np.random.default_rng(200 + len(name))
    scene = bunny[0]
    ro, rd, _, active = _wavefront(rng, scene, r=R)
    ref_acc, _ = _accel(bunny, branch)
    got = _port(bunny, branch, ro, rd, active, **opts)
    jkw = dict(BRANCHES[branch], **opts)
    if plain_walk:
        jkw["use_pallas_walk"] = False
    ref = jax_find_onehot(scene, ref_acc, jnp.asarray(ro), jnp.asarray(rd),
                          active=jnp.asarray(active), **jkw)
    _agree(got, ref, active, woop=branch == "woop",
           min_hits=20 if "cap" in opts else None)


def test_option_checks(bunny):
    """sort_rays outside SORT_MODES and a tile_b that is not a power of
    two raise; the plain ops give the same sorted result as the default
    ops on the CPU."""
    rng = np.random.default_rng(400)
    ro, rd, _, active = _wavefront(rng, bunny[0], r=R)
    with pytest.raises(ValueError):
        _port(bunny, "dense", ro, rd, active, sort_rays="octant")
    with pytest.raises(ValueError):
        _port(bunny, "dense", ro, rd, active, tile_b=100)
    a = _port(bunny, "woop", ro, rd, active, sort_rays="mask")
    b = _port(bunny, "woop", ro, rd, active, sort_rays="mask", ops=PLAIN)
    assert torch.equal(a.t, b.t) and torch.equal(a.tri, b.tri)


def test_intersect_worklist_wrapper_checks():
    """CPU tensors run the plain version without counting a launch; the
    wrapper rejects ray counts, dtypes, shapes, devices and layouts it
    does not take."""
    before = tdn.intersect_worklist.launches
    r = 512
    ro = torch.zeros((r, 3))
    t = torch.full((r,), 1e30)
    rows = torch.zeros((8, 4, 12))
    wl = torch.full((2, 4), -1, dtype=torch.int32)
    t_out, f_out = tdn.intersect_worklist(wl, rows, ro, ro, t)
    assert torch.equal(t_out, t) and bool((f_out == -1).all())
    assert tdn.intersect_worklist.launches == before
    with pytest.raises(ValueError):
        tdn.intersect_worklist(wl, rows, ro[:300], ro[:300], t[:300])
    with pytest.raises(ValueError):
        tdn.intersect_worklist(wl.long(), rows, ro, ro, t)
    with pytest.raises(ValueError):
        tdn.intersect_worklist(wl[:1], rows, ro, ro, t)
    with pytest.raises(ValueError):
        tdn.intersect_worklist(torch.full((4, 2), -1, dtype=torch.int32).T,
                               rows, ro, ro, t)
    with pytest.raises(ValueError):
        tdn.intersect_worklist(wl.to("meta"), rows.to("meta"), ro.to("meta"),
                               ro.to("meta"), t.to("meta"))
    with pytest.raises(ValueError):   # one staged cluster must fit
        tdn.intersect_worklist(wl, torch.zeros((8, 5000, 12)), ro, ro, t)
