"""The onehot finder's non-fused branch of raypt_torch against the JAX
package, on seeded numpy inputs over the bench scene's stand-in bunny:
the mask-only walk (`topwalk_cm`, `topwalk`), the ascending-id
worklists (`worklist_slice`, `worklists_from_masks`), the ray-sort keys
(`first_wanted`, `onehot_sort_key`), the worklist intersection
(`intersect_worklist`, whose CPU path is its plain version) and the
finder with use_pallas_intersect=False, its residual rounds included
(JAX kernels in interpret mode).

The CUDA walk runs only on the card: test_torch_gpu.py and
chip_smoke.py hold it bitwise against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import clusters as jcl
from raypt.accel.traverse import find_closest_onehot as jax_find_onehot
from raypt.accel.traverse import onehot_sort_key as jax_sort_key
from raypt.kernels.onehot_walk import pallas_topwalk

from raypt_torch.accel import clusters as tcl
from raypt_torch.accel.ctree import walk_topwalk
from raypt_torch.accel.traverse import (DENSE_CHUNK, KERNELS, PLAIN,
                                        find_closest_onehot, onehot_sort_key,
                                        wavefront_inputs)
from raypt_torch.kernels import cluster_pallas as tdn
from raypt_torch.kernels import dense_pallas as tdp
from raypt_torch.kernels import onehot_walk as twk

from test_torch_cluster import (R, _finders_agree, _onehot, _t, _wavefront,
                                bunny)  # noqa: F401  (bunny is a fixture)

from chip_smoke import walk_layouts

torch.set_num_threads(2)


@pytest.mark.parametrize("leaf,blocks", [
    (16, "random"), (128, "random"), (16, "edges"), (128, "edges")],
    ids=["16", "128", "16-edges", "128-edges"])
def test_topwalk_bitwise(bunny, leaf, blocks):
    """The mask-only walk, with ~40% dead rays, against
    pallas_topwalk(interpret=True), bitwise, in both layouts: leaf 16
    has 1,026 clusters in 33 words (not a multiple of 8), leaf 128 130
    in 5. With blocks "edges", the 256-ray blocks the CUDA kernel packs
    include an all-dead one, one with a single live ray and one live
    only in its last warp (`chip_smoke.walk_layouts`): their dead rays'
    columns are all zero."""
    rng = np.random.default_rng(100 + leaf)
    (_, jtable), acc = _onehot(bunny, leaf)
    ro, rd, t0, active = _wavefront(rng, bunny[0])
    if blocks == "edges":
        active = walk_layouts(_t(active)).numpy()
    nw = -(-acc.num_clusters // 32)
    ref = np.asarray(pallas_topwalk(
        jtable, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t0),
        jnp.asarray(active), nw, interpret=True))
    args = (acc.table, _t(ro), _t(rd), _t(t0), _t(active), nw)
    assert ref.shape == (R, nw) and (ref != 0).any(axis=1).sum() > R // 4
    for fn in (twk.topwalk, walk_topwalk):
        got = fn(*args)
        assert got.is_contiguous() and np.array_equal(got.numpy(), ref)
    for fn in (twk.topwalk_cm, twk.topwalk_cm_plain):
        got = fn(*args)
        assert got.shape == (nw, R) and np.array_equal(got.numpy(), ref.T)
    if blocks == "edges":
        assert not ref[~active].any()
        assert ref[256 + 77].any() and ref[768 - 32:768].any(axis=1).sum() > 8


@pytest.mark.parametrize("cap,round_", [(512, 0), (512, 1), (8, 0), (8, 1),
                                        (8, 5)])
def test_worklist_slice_bitwise(bunny, cap, round_):
    """worklist_slice of the walk's tile unions against the JAX one
    (top_k over C - id), bitwise: ascending cluster ids, -1 padded; at
    cap 8 round 1 holds a tile's 9th-16th clusters, and round 5 is past
    every union (all -1)."""
    rng = np.random.default_rng(110)
    _, acc = _onehot(bunny, 64)
    ro, rd, t0, active = (_t(x) for x in _wavefront(rng, bunny[0]))
    c = acc.num_clusters
    mask = twk.topwalk(acc.table, ro, rd, t0, active, -(-c // 32))
    union, counts = tcl.tile_union_counts(mask, 256)
    ref = np.asarray(jcl.worklist_slice(jnp.asarray(union.numpy()), c, cap,
                                        round_))
    got = tcl.worklist_slice(union, c, cap, round_)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    filled = (ref >= 0).sum(axis=1)
    want = np.clip(counts.numpy() - round_ * cap, 0, cap)
    assert np.array_equal(filled, want)
    if (cap, round_) == (8, 1):
        assert filled.max() > 0


@pytest.mark.parametrize("ops,cap", [("kernels", 0), ("kernels", 2),
                                     ("plain", 0), ("plain", 2)])
def test_unfused_finder_matches_jax(bunny, ops, cap):
    """find_closest_onehot with use_pallas_intersect=False (expand 0,
    leaf 128, R = 3,000 padded inside) against the JAX finder at the
    same cap: ops KERNELS against the JAX walk kernel in interpret mode,
    ops PLAIN against the JAX plain walk (use_pallas_walk=False). Faces
    and spheres equal on every live ray, t within test_torch_cluster's
    T_RTOL/T_ATOL (measured: faces equal; worst t 2.4e-4 absolute at
    t = 739, 2.6e-5 relative at small t).
    At cap 2 (of the default 512), tiles whose union holds more than 2
    clusters run residual rounds; the port's result there is bitwise
    equal to its default-cap result."""
    rng = np.random.default_rng(120)
    scene, _, tscene = bunny
    ref_acc, acc = _onehot(bunny, 128)
    ro, rd, _, active = _wavefront(rng, scene, r=3000)
    kw = dict(accel=acc, expand_n=0, compact_n=0, use_pallas_intersect=False,
              ops=KERNELS if ops == "kernels" else PLAIN)
    got = find_closest_onehot(tscene, _t(ro), _t(rd), _t(active), cap=cap,
                              **kw)
    ref = jax_find_onehot(scene, ref_acc, jnp.asarray(ro), jnp.asarray(rd),
                          active=jnp.asarray(active),
                          use_pallas_walk=ops == "kernels",
                          use_pallas_intersect=False, cap=cap)
    _finders_agree(got, ref, active)
    if cap:
        full = find_closest_onehot(tscene, _t(ro), _t(rd), _t(active), **kw)
        assert torch.equal(got.t, full.t) and torch.equal(got.tri, full.tri)
        assert torch.equal(got.sphere, full.sphere)
        o, d, t, a, _, _ = wavefront_inputs(tscene, _t(ro), _t(rd),
                                            _t(active), DENSE_CHUNK)
        mask = twk.topwalk(acc.table, o, d, t, a, -(-acc.num_clusters // 32))
        assert int((tcl.tile_union_counts(mask, 256)[1] > cap).sum()) > 0


def test_unfused_ops_and_wrapper_checks(bunny):
    """The non-fused branch takes its walk from ops.walk_mask: PLAIN
    gives the same result as the default ops. CPU tensors run the plain
    versions without counting a launch; the wrappers reject ray and
    triangle counts they do not take."""
    rng = np.random.default_rng(130)
    scene, _, tscene = bunny
    _, acc = _onehot(bunny, 128)
    ro, rd, _, active = (_t(x) for x in _wavefront(rng, scene, r=1000))
    counters = (twk.topwalk_cm, tdp.closest_dense)
    before = [f.launches for f in counters]
    kw = dict(accel=acc, expand_n=0, compact_n=0, use_pallas_intersect=False)
    a = find_closest_onehot(tscene, ro, rd, active, **kw)
    b = find_closest_onehot(tscene, ro, rd, active, ops=PLAIN, **kw)
    assert torch.equal(a.t, b.t) and torch.equal(a.tri, b.tri)
    w = torch.zeros((3, 256))
    c = torch.zeros((1, 256))
    r = torch.zeros((512, 3))
    t = torch.full((512,), 1e30)
    t_out, f_out = tdp.closest_dense(w, w, w, c, c, c, r, r, t, tri_chunk=256)
    assert torch.equal(t_out, t) and bool((f_out == -1).all())
    assert before == [f.launches for f in counters]
    table = torch.zeros((89, 16), dtype=torch.bfloat16)
    alive = torch.ones(300, dtype=torch.bool)
    with pytest.raises(ValueError):
        twk.topwalk_cm(table, r[:300], r[:300], t[:300], alive, 1)
    with pytest.raises(ValueError):
        tdp.closest_dense(w, w, w, c, c, c, r[:300], r[:300], t[:300],
                          tri_chunk=256)
    with pytest.raises(ValueError):
        tdp.closest_dense(w, w, w, c, c, c, r, r, t, tri_chunk=2048)
    with pytest.raises(ValueError):
        tdp.closest_dense(w, w, w, c, c, c.double(), r, r, t, tri_chunk=256)


def _masks(bunny, leaf, seed):
    """The walk's (R, words) masks of a seeded wavefront with ~40% dead
    rays (whose rows are empty), with rows rewritten: 0-7 empty, 8-15
    only bit 31 of a word, 16-23 only the last word's low bits (the last
    word is partly filled: leaf 128 has 130 clusters, 2 bits of word 4;
    leaf 16 1,026, 2 bits of word 32), 24-31 every bit."""
    rng = np.random.default_rng(seed)
    _, acc = _onehot(bunny, leaf)
    ro, rd, t0, active = (_t(x) for x in _wavefront(rng, bunny[0]))
    nw = -(-acc.num_clusters // 32)
    mask = twk.topwalk(acc.table, ro, rd, t0, active, nw).clone()
    last = acc.num_clusters - 32 * (nw - 1)
    mask[:8] = 0
    mask[8:16] = 0
    mask[8:16, torch.arange(8) % nw] = -2 ** 31
    mask[16:24] = 0
    mask[16:24, -1] = torch.arange(1, 9, dtype=torch.int32) % (1 << last)
    mask[24:32] = -1
    assert (mask[32:] == 0).all(dim=1).sum() > 100   # dead or missing rays
    return acc, mask, active


@pytest.mark.parametrize("leaf", [16, 128])
def test_first_wanted_bitwise(bunny, leaf):
    """first_wanted against the JAX one, bitwise, on the walk's masks
    with empty rows, rows of bit 31 alone, a partly filled last word and
    full rows; and the "mask" sort's key, dead rays at 1 << 29."""
    acc, mask, active = _masks(bunny, leaf, 140 + leaf)
    ref = np.asarray(jcl.first_wanted(jnp.asarray(mask.numpy())))
    got = tcl.first_wanted(mask)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    assert (ref[:8] == 1 << 29).all() and (ref[8:16] % 32 == 31).all()
    assert (ref[24:32] == 0).all() and (ref[32:] < acc.num_clusters).any()
    key = torch.where(active, got, torch.full_like(got, 1 << 29))
    assert np.array_equal(key.numpy(), np.where(active.numpy(), ref, 1 << 29))


@pytest.mark.parametrize("tile,cap", [(256, 512), (256, 8), (128, 8),
                                      (512, 4)])
def test_worklists_from_masks_bitwise(bunny, tile, cap):
    """worklists_from_masks (worklist, clamped counts, overflow) against
    the JAX one, bitwise, at leaf 16 (1,026 clusters, 33 words)."""
    acc, mask, _ = _masks(bunny, 16, 150)
    c = acc.num_clusters
    ref = jcl.worklists_from_masks(jnp.asarray(mask.numpy()), tile, cap, c)
    got = tcl.worklists_from_masks(mask, tile, cap, c)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert bool(got[2].any()) and bool((got[0] >= 0).any())


def test_onehot_sort_key_bitwise(bunny):
    """onehot_sort_key against the JAX one, bitwise: origins inside,
    on and outside the mesh's bounds (clamped to cells 0 and 63),
    direction components of +-0 and of either sign, ~40% dead rays."""
    rng = np.random.default_rng(160)
    pos = np.asarray(bunny[0].mesh.positions)[:2562]
    bmin, bmax = pos.min(0), pos.max(0)
    ro, rd, _, active = _wavefront(rng, bunny[0])
    ro[:64] = bmin + (bmax - bmin) * rng.integers(-1, 3, (64, 3))
    rd[64:128] = rng.choice(np.float32([0.0, -0.0, 1.0, -1.0]), (64, 3))
    ref = np.asarray(jax_sort_key(jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.asarray(active), jnp.asarray(bmin),
                                  jnp.asarray(bmax)))
    got = onehot_sort_key(_t(ro), _t(rd), _t(active), _t(bmin), _t(bmax))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    live = ref[active]
    assert (ref[~active] == 1 << 30).all() and len(np.unique(live)) > 100
    assert (live & 7 == 7).any() and (live & 7 == 0).any()


@pytest.mark.parametrize("leaf,cap", [(128, 40), (16, 8)])
def test_intersect_worklist_matches_jax(bunny, leaf, cap):
    """The worklist intersection's wrapper (its plain version on the
    CPU) against intersect_worklist_jnp on the same worklists: the
    first cap clusters of each tile's union, then -1 gaps spread between
    them (every slot is scanned) and a repeated id. Faces equal on every
    live ray, t within test_torch_cluster's T_RTOL/T_ATOL (measured:
    faces equal; worst t 2.4e-4 absolute at t = 570, 1.2e-5 relative);
    gaps and repeats leave the port's result bitwise unchanged."""
    rng = np.random.default_rng(170 + leaf)
    (jclu, _), acc = _onehot(bunny, leaf)
    ro, rd, t0, active = _wavefront(rng, bunny[0])
    c = acc.num_clusters
    mask = twk.topwalk(acc.table, _t(ro), _t(rd), _t(t0), _t(active),
                       -(-c // 32))
    wl = tcl.worklists_from_masks(mask, 256, cap, c)[0]
    seed = np.where(active, t0, -1e30).astype(np.float32)
    args = (_t(ro), _t(rd), _t(seed))
    got = tdn.intersect_worklist(wl, acc.clusters.tri_rows, *args)
    ref = jcl.intersect_worklist_jnp(jclu, jnp.asarray(wl.numpy()), None,
                                     *(jnp.asarray(x) for x in (ro, rd, seed)),
                                     tile=256)
    assert (np.asarray(ref[1])[active] >= 0).sum() > 30
    assert np.array_equal(got[1].numpy()[active], np.asarray(ref[1])[active])
    np.testing.assert_allclose(got[0].numpy()[active],
                               np.asarray(ref[0])[active], rtol=1e-5,
                               atol=2.0 ** -16)
    n_tiles = wl.shape[0]
    gaps = torch.full((n_tiles, 2 * cap + 1), -1, dtype=torch.int32)
    slot = 2 * torch.arange(cap) + torch.from_numpy(
        rng.integers(0, 2, (n_tiles, cap)))
    gaps.scatter_(1, slot, wl)
    gaps[:, -1] = wl[:, 0]                   # a repeated id (or -1)
    again = tdn.intersect_worklist(gaps, acc.clusters.tri_rows, *args)
    assert torch.equal(again[0].view(torch.int32), got[0].view(torch.int32))
    assert torch.equal(again[1], got[1])
