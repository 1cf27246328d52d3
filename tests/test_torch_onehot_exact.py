"""The port's own property of the onehot finder's options: with each
ray-sort or tiling option (sort_rays, segment_sort, overflow_fallback
at the default cap, tile_b, walk_tile) on each branch, t, face and
sphere are bitwise the result with no option, on the CPU through the
plain versions, over the bench scene's stand-in bunny (leaf 128; 2,048
seeded rays, ~40% dead). tests/test_torch_onehot_options.py holds the
options against the JAX package; test_torch_gpu.py and chip_smoke.py
hold them on the card."""
import numpy as np
import pytest
import torch

from test_torch_cluster import _wavefront, bunny  # noqa: F401  (fixture)
from test_torch_onehot_options import OPTIONS, R, _port

torch.set_num_threads(2)


_BASE = {}


def _base(bunny, branch):
    """The exactness tests' wavefront (seeded) and the branch's result on
    it with no option, computed once a module for each branch."""
    key = (id(bunny[0]), branch)
    if key not in _BASE:
        rng = np.random.default_rng(300)
        ro, rd, _, active = _wavefront(rng, bunny[0], r=R)
        _BASE[key] = (bunny[0], ro, rd, active,
                      _port(bunny, branch, ro, rd, active))
    return _BASE[key][1:]


EXACT = [o[:3] for o in OPTIONS if "cap" not in o[2]] + [
    ("unfused-no-fallback", "unfused", dict(overflow_fallback=False)),
    ("unfused-segment-1024", "unfused", dict(segment_sort=1024)),
    ("dense-walk_tile-512", "dense", dict(walk_tile=512)),
    ("dense-walk_tile-128", "dense", dict(walk_tile=128)),
    ("expand-tile_b-1024", "expand", dict(tile_b=1024)),
    ("expand-sort-alive", "expand", dict(sort_rays="alive")),
    ("expand-segment-2048", "expand", dict(segment_sort=2048))]


@pytest.mark.parametrize("name,branch,opts", EXACT,
                         ids=[e[0] for e in EXACT])
def test_option_exact(bunny, name, branch, opts):
    """The port's exactness property: with each option (and some
    combinations; on expand_n's settings a sort or a segment routes to
    the dense-union branch, and walk_tile 128 to the mask walk), t,
    face and sphere are bitwise the result with no option and the same
    other arguments: each ray's mask lies inside its tile's union, and
    every sort is undone. With the fallback off at the default cap no
    tile's union (at most 130 clusters) exceeds it."""
    ro, rd, active, base = _base(bunny, branch)
    got = _port(bunny, branch, ro, rd, active, **opts)
    assert int((base.tri >= 0).sum()) > int(active.sum()) // 10
    for what in ("t", "tri", "sphere"):
        a, b = getattr(got, what), getattr(base, what)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b), what
