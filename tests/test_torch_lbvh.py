"""raypt_torch's LBVH build, refit and packed table against the JAX
package, bitwise, on the same numpy inputs (tests/test_lbvh.py's
cases: random triangle soups with padded invalid faces, duplicate
centroids, every face invalid).

The centroid rule. The build's only rounding before the integer work
is the centroid (p0 + p1 + p2) / 3, the scene bounds and the [0, 1]
mapping. The port divides by 3 (IEEE, as torch does on the CPU and the
card). JAX run op by op, as its `make_finder`, the CLI and the fits call
`build`, divides too: its centroids are bitwise the port's. Under
`jax.jit`, XLA rewrites x / 3.0 as x * 0.333333343 (measured on 10^6
random floats: 332,580 differ by an ulp), but the Morton codes quantize
each coordinate to 1/1024 of the extent, which hides the ulp: the jitted
build gives the same tree on every case here. Both JAX runs are held
bitwise."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import lbvh as jlbvh
from raypt.accel import packed as jpacked

from raypt_torch.accel import lbvh as tlbvh
from raypt_torch.accel import packed as tpacked
from raypt_torch.accel.ctree import lbvh_from_numpy, packed_from_numpy

torch.set_num_threads(2)

FIELDS = ("left", "skip", "bmin", "bmax", "leaf_face")


def _soup(seed, ntri, cap):
    """tests/test_lbvh.py's random soup: ntri real faces in cap slots,
    the padded ones invalid."""
    rng = np.random.default_rng(seed)
    v = ntri * 3
    pos = rng.uniform(-10, 10, (v, 3)).astype(np.float32)
    faces = (np.arange(cap * 3).reshape(cap, 3) % v).astype(np.int32)
    return pos, faces, np.arange(cap) < ntri


def _duplicates():
    pos = np.tile(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                  (16, 1))
    return pos, (np.arange(48).reshape(16, 3) % 48).astype(np.int32), \
        np.ones(16, bool)


def _all_invalid():
    return (np.zeros((3, 3), np.float32), np.zeros((8, 3), np.int32),
            np.zeros(8, bool))


CASES = {"F2": lambda: _soup(1, 2, 2), "F3": lambda: _soup(2, 3, 3),
         "F64": lambda: _soup(3, 50, 64), "F1000": lambda: _soup(4, 900, 1000),
         "duplicates": _duplicates, "all_invalid": _all_invalid}


@lru_cache(maxsize=None)
def _jax_build(case):
    """The JAX package's build of a case, run op by op (each shape
    compiles its programs once, ~4 s, so the tests share it)."""
    pos, faces, valid = CASES[case]()
    return jlbvh.build(*_jax(pos, faces, valid))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, ref, fields=FIELDS):
    for k in fields:
        assert np.array_equal(_bits(getattr(got, k)), _bits(getattr(ref, k))), k


@pytest.mark.parametrize("points", ["grid", "random", "outside"])
def test_morton3d_bitwise(points):
    """morton3d on coordinates with 0, 1, bin edges and values outside
    [0, 1] (clipped), as uint32 codes."""
    rng = np.random.default_rng(7)
    if points == "grid":
        xyz = np.array(np.meshgrid(*[[0.0, 1.0, 0.5, 1 / 1024, 1023 / 1024,
                                      0.999999]] * 3)).reshape(3, -1).T
    elif points == "random":
        xyz = rng.uniform(0, 1, (4096, 3))
    else:
        xyz = rng.uniform(-3, 3, (4096, 3))
    xyz = xyz.astype(np.float32)
    ref = np.asarray(jlbvh.morton3d(jnp.asarray(xyz)))
    got = tlbvh.morton3d(torch.from_numpy(xyz)).numpy()
    assert ref.dtype == np.uint32
    assert np.array_equal(got, ref.astype(np.int64))


def test_clz32():
    """_clz32 on 0, powers of two, their neighbours and random words."""
    rng = np.random.default_rng(8)
    x = np.concatenate([[0, 1, 0xFFFFFFFF], 2 ** np.arange(32),
                        2 ** np.arange(32) - 1,
                        rng.integers(0, 2 ** 32, 1000)]).astype(np.uint32)
    ref = np.asarray(jlbvh._clz32(jnp.asarray(x)))
    got = tlbvh._clz32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_bitwise(case):
    """build: left, skip, leaf_face and the boxes' bits equal JAX's, run
    op by op."""
    pos, faces, valid = CASES[case]()
    got = tlbvh.build(*_torch(pos, faces, valid))
    _assert_same(got, _jax_build(case))
    assert got.left.dtype == got.skip.dtype == got.leaf_face.dtype == np.int32


def test_build_bitwise_jit():
    """The same against the build under jax.jit, whose centroids are
    x * 0.333333343 (a compile takes ~4 s a shape, so one case)."""
    pos, faces, valid = CASES["F1000"]()
    _assert_same(tlbvh.build(*_torch(pos, faces, valid)),
                 jax.jit(jlbvh.build)(*_jax(pos, faces, valid)))


@pytest.mark.parametrize("case", ["F64", "F1000", "duplicates"])
def test_refit_bitwise(case):
    """refit after a seeded vertex jitter: the boxes' bits equal JAX's,
    the topology is kept."""
    pos, faces, valid = CASES[case]()
    moved = pos + np.random.default_rng(9).normal(
        0, 0.5, pos.shape).astype(np.float32)
    jbvh = _jax_build(case)
    ref = jlbvh.refit(jbvh, *_jax(moved, faces, valid))
    got = tlbvh.refit(tlbvh.build(*_torch(pos, faces, valid)),
                      *_torch(moved, faces, valid))
    _assert_same(got, ref)
    assert not np.array_equal(got.bmin, np.asarray(jbvh.bmin))


@pytest.mark.parametrize("case", ["F64", "F1000", "duplicates"])
def test_refit_pack_on_device_bitwise(case, monkeypatch):
    """A fit step's route: refit and pack of the tree's tensors
    (LBVH.tensors) equal pack(refit(...)) of the numpy LBVH bit for bit,
    with nothing copied to the host between the upload and the table (no
    .cpu(), .numpy() or torch.from_numpy); the refit returns
    LBVHTensors, leaves the uploaded boxes as they were, moves boxes
    under the seeded jitter, and each valid triangle lies inside its
    leaf box."""
    pos, faces, valid = CASES[case]()
    moved = pos + np.random.default_rng(9).normal(
        0, 0.5, pos.shape).astype(np.float32)
    bvh = tlbvh.build(*_torch(pos, faces, valid))
    args = _torch(moved, faces, valid)
    ref = tpacked.pack(tlbvh.refit(bvh, *args), *args)
    tree = bvh.tensors("cpu")
    uploaded = (tree.bmin.clone(), tree.bmax.clone())

    def host_copy(*a, **kw):
        raise AssertionError("a host copy between the refit and the pack")

    for owner, name in ((torch.Tensor, "cpu"), (torch.Tensor, "numpy"),
                        (torch, "from_numpy")):
        monkeypatch.setattr(owner, name, host_copy)
    refitted = tlbvh.refit(tree, *args)
    got = tpacked.pack(refitted, *args)
    monkeypatch.undo()
    assert isinstance(refitted, tlbvh.LBVHTensors)
    assert torch.equal(got.rows.view(torch.int32), ref.rows.view(torch.int32))
    assert torch.equal(tree.bmin, uploaded[0])
    assert torch.equal(tree.bmax, uploaded[1])
    assert not torch.equal(refitted.bmin, tree.bmin)
    ni = bvh.num_leaves - 1
    lf = torch.from_numpy(bvh.leaf_face.astype(np.int64))
    ok = torch.from_numpy(valid)[lf]
    for k in range(3):
        p = args[0][args[1][lf, k].long()][ok]
        assert (p >= refitted.bmin[ni:][ok]).all()
        assert (p <= refitted.bmax[ni:][ok]).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_bitwise(case):
    """pack: the (2N-1, 16) rows viewed as int32 equal JAX's (links and
    face ids are bit patterns in float slots; invalid faces e1 = e2 =
    0); the carried-across containers hold the same bits."""
    pos, faces, valid = CASES[case]()
    jbvh = _jax_build(case)
    ref = jpacked.pack(jbvh, *_jax(pos, faces, valid))
    got = tpacked.pack(tlbvh.build(*_torch(pos, faces, valid)),
                       *_torch(pos, faces, valid))
    rows = np.asarray(ref.rows).view(np.int32)
    assert got.rows.shape == (2 * len(faces) - 1, 16)
    assert np.array_equal(got.rows.numpy().view(np.int32), rows)
    assert np.array_equal(packed_from_numpy(ref.rows, "cpu").rows.numpy()
                          .view(np.int32), rows)
    _assert_same(lbvh_from_numpy(*(getattr(jbvh, k) for k in FIELDS)), jbvh)


def test_build_needs_two_faces():
    with pytest.raises(ValueError):
        tlbvh.build(torch.zeros((3, 3)), torch.zeros((1, 3), dtype=torch.int32),
                    torch.ones(1, dtype=torch.bool))
