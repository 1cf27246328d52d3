"""The plain torch version of each render-path kernel against its JAX
Pallas kernel (interpret mode on the CPU), on seeded numpy inputs; and
the wrappers' dispatch and input checks.

The CUDA kernels themselves run only on the card: test_torch_gpu.py and
chip_smoke.py hold them bitwise against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.host_bvh import build_sah as jax_build_sah
from raypt.core.math3d import BIG
from raypt.kernels.cluster_expand import pallas_cluster_expand
from raypt.kernels.compact import pallas_alive_compact, pallas_alive_uncompact
from raypt.kernels.onehot_walk import pallas_topwalk_cm_u
from raypt.scenes import builtin as jax_scenes

from raypt_torch.accel.traverse import (PLAIN, find_closest_bruteforce,
                                        find_closest_onehot)
from raypt_torch.core.types import scene_from_numpy
from raypt_torch.kernels import cluster_expand as tex
from raypt_torch.kernels import compact as tcp
from raypt_torch.kernels import onehot_walk as twk

from test_torch_scene import jax_accel_to_port, jax_leaves

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _alive(rng, r, group):
    """Random alive mask with one all-dead and one all-alive group."""
    alive = rng.random(r) < 0.4
    alive[:group] = False
    alive[group:2 * group] = True
    return alive


def test_compact_bitwise_on_live_lanes():
    rng = np.random.default_rng(11)
    r, g = 4096, 1024
    ro = (rng.normal(size=(r, 3)) * 1e3).astype(np.float32)
    rd = rng.normal(size=(r, 3)).astype(np.float32)
    t0 = (rng.random(r) * 1e8).astype(np.float32)
    alive = _alive(rng, r, g)
    ref = pallas_alive_compact(jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(t0), jnp.asarray(alive), group=g,
                               interpret=True)
    got = tcp.alive_compact(_t(ro), _t(rd), _t(t0), _t(alive), group=g)
    live = np.asarray(ref[3])
    assert np.array_equal(got[3].numpy(), live)
    for a, b in zip(got[:3], ref[:3]):
        assert np.array_equal(a.numpy()[live], np.asarray(b)[live])


def test_uncompact_bitwise_on_live_lanes():
    rng = np.random.default_rng(12)
    r, g = 4096, 1024
    alive = _alive(rng, r, g)
    t = (rng.random(r) * 100).astype(np.float32)
    face = rng.integers(-1, (1 << 24) - 1, size=r).astype(np.int32)
    ref_t, ref_f = pallas_alive_uncompact(jnp.asarray(t), jnp.asarray(face),
                                          jnp.asarray(alive), group=g,
                                          interpret=True)
    got_t, got_f = tcp.alive_uncompact(_t(t), _t(face), _t(alive), group=g)
    assert np.array_equal(got_t.numpy()[alive], np.asarray(ref_t)[alive])
    assert np.array_equal(got_f.numpy()[alive], np.asarray(ref_f)[alive])
    # and it inverts compaction on live lanes
    ro = rng.normal(size=(r, 3)).astype(np.float32)
    c = tcp.alive_compact(_t(ro), _t(ro), _t(t), _t(alive), group=g)
    back_t, _ = tcp.alive_uncompact(c[2], _t(face), _t(alive), group=g)
    assert np.array_equal(back_t.numpy()[alive], t[alive])


@pytest.fixture(scope="module")
def bunny():
    """JAX bench scene and its SAH tree (the icosphere stand-in)."""
    scene = jax_scenes.stanford_bunny().freeze()
    return scene, jax_build_sah(scene.mesh)


def _wavefront(rng, scene, r):
    """Rays from around the scene towards points in the mesh's bounds;
    t0 is BIG or a random bound, 90% active."""
    pos = np.asarray(scene.mesh.positions)[:2562]
    lo, hi = pos.min(0), pos.max(0)
    target = lo + rng.random((r, 3)) * (hi - lo)
    ro = (lo + hi) / 2 + rng.normal(size=(r, 3)) * (hi - lo)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t0 = np.where(rng.random(r) < 0.5, BIG, rng.random(r) * 60.0)
    active = rng.random(r) < 0.9
    return (ro.astype(np.float32), rd.astype(np.float32),
            t0.astype(np.float32), active)


def _accels(bunny, leaf):
    scene, bvh = bunny
    m = scene.mesh
    ref = jax_build_onehot(bvh, m.positions, m.faces, m.face_valid, leaf=leaf)
    return ref, jax_accel_to_port(ref)


@pytest.mark.parametrize("leaf", [384, 16])
def test_walk_bitwise(bunny, leaf):
    """Mask and union_pp bitwise: the slab test has no multiply-add to
    fuse. leaf 16 gives 1,026 clusters, 40 mask words."""
    rng = np.random.default_rng(leaf)
    (_, jtable), acc = _accels(bunny, leaf)
    r = 4096
    ro, rd, t0, active = _wavefront(rng, bunny[0], r)
    cwp = -(-acc.num_clusters // 256) * 8
    ref_m, ref_u = pallas_topwalk_cm_u(jtable, jnp.asarray(ro),
                                       jnp.asarray(rd), jnp.asarray(t0),
                                       jnp.asarray(active), cwp,
                                       interpret=True)
    got_m, got_u = twk.topwalk_cm_u(acc.table, _t(ro), _t(rd), _t(t0),
                                    _t(active), cwp)
    assert int(np.count_nonzero(np.asarray(ref_m))) > r // 4
    assert np.array_equal(got_m.numpy(), np.asarray(ref_m))
    assert np.array_equal(got_u.numpy(), np.asarray(ref_u))


@pytest.mark.parametrize("leaf", [384, 64])
def test_expand_close(bunny, leaf):
    """XLA on the CPU contracts multiply-adds in the JAX kernel's
    triangle test and torch does not, so t and near-tie faces cannot be
    bitwise. Required: faces agree on >= 99.9% of live rays, and where
    they agree t is allclose at rtol 1e-5 (measured: faces agree on
    100% of live rays; worst relative t error 8.7e-7 at leaf 384 and
    3.3e-7 at leaf 64)."""
    rng = np.random.default_rng(100 + leaf)
    (jcl, jtable), acc = _accels(bunny, leaf)
    r = 2048
    ro, rd, t0, active = _wavefront(rng, bunny[0], r)
    cwp = -(-acc.num_clusters // 256) * 8
    mask, union = twk.topwalk_cm_u(acc.table, _t(ro), _t(rd), _t(t0),
                                   _t(active), cwp)
    seed = np.where(active, t0, -BIG).astype(np.float32)
    ref_t, ref_f = pallas_cluster_expand(
        jnp.asarray(mask.numpy()), jnp.transpose(jcl.tri_rows, (0, 2, 1)),
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seed), interpret=True,
        n_rays=256, union_pp=jnp.asarray(union.numpy()))
    got_t, got_f = tex.cluster_expand(mask, union, acc.clusters.tri_rows,
                                      _t(ro), _t(rd), _t(seed))
    ref_t, ref_f = np.asarray(ref_t), np.asarray(ref_f)
    got_t, got_f = got_t.numpy(), got_f.numpy()
    hits = active & (ref_f >= 0)
    assert hits.sum() > r // 10
    same = got_f[active] == ref_f[active]
    assert same.mean() >= 0.999
    both = active & (got_f == ref_f)
    np.testing.assert_allclose(got_t[both], ref_t[both], rtol=1e-5)


def test_onehot_finder_matches_bruteforce(bunny):
    """The port's onehot finder (plain stages) against the brute-force
    oracle on the same scene: the same closest t and sphere for every
    live ray, and the same face on >= 99.9% of them (a t shared by two
    faces may resolve to either)."""
    rng = np.random.default_rng(5)
    scene_j, _ = bunny
    (_, _), acc = _accels(bunny, 384)
    scene = scene_from_numpy(jax_leaves(scene_j))
    r = 1500                      # padded to the walk tile inside
    ro, rd, _, active = _wavefront(rng, scene_j, r)
    got = find_closest_onehot(scene, _t(ro), _t(rd), _t(active), accel=acc,
                              expand_n=256, compact_n=1024, ops=PLAIN)
    ref = find_closest_bruteforce(scene, _t(ro), _t(rd))
    a = torch.from_numpy(active)
    assert torch.equal(got.t[a], ref.t[a])
    assert torch.equal(got.sphere[a], ref.sphere[a])
    assert (got.tri[a] == ref.tri[a]).double().mean() >= 0.999
    assert bool((got.t[~a] == BIG).all() and (got.tri[~a] == -1).all())


def test_wrappers_dispatch_and_checks():
    """CPU tensors run the plain version without counting a launch; the
    wrappers reject shapes, dtypes, layouts and devices they do not
    take."""
    r, g = 2048, 1024
    ro = torch.zeros((r, 3))
    t = torch.zeros(r)
    alive = torch.ones(r, dtype=torch.bool)
    before = (tcp.alive_compact.launches, tcp.alive_uncompact.launches,
              twk.topwalk_cm_u.launches, tex.cluster_expand.launches)
    tcp.alive_compact(ro, ro, t, alive, group=g)
    assert before == (tcp.alive_compact.launches,
                      tcp.alive_uncompact.launches,
                      twk.topwalk_cm_u.launches, tex.cluster_expand.launches)
    with pytest.raises(ValueError):
        tcp.alive_compact(ro, ro, t, alive, group=1000)      # R % group
    with pytest.raises(ValueError):
        tcp.alive_compact(ro, ro, t.double(), alive, group=g)
    with pytest.raises(ValueError):
        tcp.alive_uncompact(t, torch.zeros((r,), dtype=torch.int64), alive,
                            group=g)
    with pytest.raises(ValueError):
        tcp.alive_compact(torch.zeros((3, r)).T, ro, t, alive, group=g)
    with pytest.raises(ValueError):
        tcp.alive_compact(ro.to("meta"), ro.to("meta"), t.to("meta"),
                          alive.to("meta"), group=g)
    table = torch.zeros((89, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        twk.topwalk_cm_u(table, ro[:1000], ro[:1000], t[:1000],
                         alive[:1000], 8)
    mask = torch.zeros((8, r), dtype=torch.int32)
    with pytest.raises(ValueError):     # 8 words cannot hold 300 clusters
        tex.cluster_expand(mask, torch.zeros((1, 8), dtype=torch.int32),
                           torch.zeros((300, 4, 12)), ro, ro, t)
