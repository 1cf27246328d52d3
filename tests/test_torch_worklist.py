"""The onehot finder's non-fused branch of raypt_torch against the JAX
package, on seeded numpy inputs over the bench scene's stand-in bunny:
the mask-only walk (`topwalk_cm`, `topwalk`), the ascending-id
worklists (`worklist_slice`) and the finder with use_pallas_intersect
=False, its residual rounds included (JAX kernels in interpret mode).

The CUDA walk runs only on the card: test_torch_gpu.py and
chip_smoke.py hold it bitwise against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import clusters as jcl
from raypt.accel.traverse import find_closest_onehot as jax_find_onehot
from raypt.kernels.onehot_walk import pallas_topwalk

from raypt_torch.accel import clusters as tcl
from raypt_torch.accel.ctree import walk_topwalk
from raypt_torch.accel.traverse import (DENSE_CHUNK, KERNELS, PLAIN,
                                        find_closest_onehot, wavefront_inputs)
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
