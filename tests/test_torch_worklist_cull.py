"""The worklist test's cull (`csrc/worklist_cull.cuh`) through its plain
torch version, `kernels.cluster_pallas.worklist_cull_plain`, the
predicate the CUDA kernel implements: on seeded wavefronts over the
bench scene's bunny (the port's own cluster tables at leaves 64 and 128:
the rows the kernel reads) and on adversarial rays and tables, every (ray, cluster)
pair the predicate skips holds no hit that `intersect_worklist_plain`'s
merge would take, and intersecting only the kept pairs gives the plain
version's (t, face) bitwise.

The CUDA kernel runs only on the card: chip_smoke.py audits it there
(every skipped pair tested in full), holds it bitwise against
`intersect_worklist_plain`, its pre-pass's records bitwise against
`worklist_cull_prep_plain` and its kept pairs against
`intersect_worklist_culled_plain`'s count."""
import numpy as np
import pytest
import torch

from raypt_torch.accel.clusters import build_clusters
from raypt_torch.accel.host_bvh import build_sah
from raypt_torch.kernels import cluster_pallas as tdn
from raypt_torch.scenes.builtin import stanford_bunny

from test_torch_cluster import _seed, _t, _wavefront

torch.set_num_threads(2)

TILE = tdn.TILE


@pytest.fixture(scope="module")
def bunny_rows():
    """The bench scene's bunny and its cluster tables, leaf -> (C, leaf,
    12) rows (the port's builds: milliseconds on the CPU)."""
    scene = stanford_bunny().freeze("cpu")
    m = scene.mesh
    bvh = build_sah(m)
    return scene, {leaf: build_clusters(bvh, m.positions, m.faces,
                                        m.face_valid, leaf=leaf).tri_rows
                   for leaf in (64, 128)}


def _every_cluster(rng, n_tiles, c_total, gaps=True):
    """Each tile's worklist: every cluster id in a seeded order, with -1
    gaps between them."""
    cap = c_total + (c_total // 4 if gaps else 0)
    wl = np.full((n_tiles, cap), -1, dtype=np.int32)
    for k in range(n_tiles):
        slots = np.sort(rng.choice(cap, c_total, replace=False))
        wl[k, slots] = rng.permutation(c_total)
    return _t(wl)


def _audited(wl, rows, ro, rd, seed, carry=True):
    """The culled plain intersection against the plain version: bitwise
    equal, and no skipped pair held a hit the merge would take. Returns
    the audit's counts."""
    ref = tdn.intersect_worklist_plain(wl, rows, ro, rd, seed)
    t, f, (pairs, kept, bad) = tdn.intersect_worklist_culled_plain(
        wl, rows, ro, rd, seed, carry=carry)
    assert bad == 0
    assert torch.equal(t.view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(f, ref[1])
    return pairs, kept, int((ref[1] >= 0).sum())


@pytest.mark.parametrize("leaf,carry", [(64, True), (128, True),
                                        (128, False)],
                         ids=["64-carry", "128-carry", "128-box"])
def test_cull_random_wavefront(bunny_rows, leaf, carry):
    """A seeded wavefront (rays from near the mesh and from around the
    scene, ~40% dead, t0 BIG or a random bound) against every cluster of
    each tile in a seeded order with -1 gaps: the culled result is the
    plain one bitwise, no skipped pair held a taken hit, and the cull
    skips pairs (most, for the box and carry)."""
    rng = np.random.default_rng(300 + leaf + carry)
    scene, tables = bunny_rows
    rows = tables[leaf]
    tiles = 1 if leaf == 64 else 2   # leaf 64: 258 clusters
    ro, rd, t0, active = _wavefront(rng, scene, r=tiles * TILE)
    wl = _every_cluster(rng, tiles, rows.shape[0])
    pairs, kept, hits = _audited(wl, rows, _t(ro), _t(rd),
                                 _t(_seed(t0, active)), carry)
    assert hits > 100 and 0 < kept < pairs
    if carry:
        assert kept < pairs // 2


def _triangles(rows, n, rng):
    """n seeded (cluster, lane) picks of non-degenerate rows."""
    area = torch.linalg.cross(rows[..., 3:6].double(),
                              rows[..., 6:9].double()).norm(dim=-1)
    cands = torch.nonzero(area > 0).numpy()
    return cands[rng.integers(0, len(cands), n)]


def _aimed(rows, picks, bary, dist, grazing, rng):
    """Rays at the points p0 + u e1 + v e2 of the picked triangles
    (bary (n, 2)), from `dist` along the reverse direction; with
    `grazing`, the direction lies in the triangle's plane but for a
    normal part giving |det| = |d . (e1 x e2)| of 1-3 x 1e-8."""
    tri = rows[picks[:, 0], picks[:, 1]].double()
    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    b = torch.from_numpy(bary)
    x = p0 + b[:, 0:1] * e1 + b[:, 1:2] * e2
    n = torch.linalg.cross(e1, e2)
    if grazing:
        tang = torch.linalg.cross(n, torch.from_numpy(rng.normal(
            size=(len(picks), 3))))
        tang /= tang.norm(dim=1, keepdim=True)
        det = torch.from_numpy(rng.uniform(1.0, 3.0, len(picks))) * 1e-8
        d = tang + (det / n.norm(dim=1) ** 2)[:, None] * n
    else:
        d = torch.from_numpy(rng.normal(size=(len(picks), 3)))
        d = torch.where(((d * n).sum(1) > 0)[:, None], -d, d)
    d /= d.norm(dim=1, keepdim=True)
    o = x - torch.from_numpy(dist)[:, None] * d
    return o.float().contiguous(), d.float().contiguous()


@pytest.mark.parametrize("case", ["grazing", "far", "edges"])
def test_cull_adversarial_rays(bunny_rows, case):
    """Rays built to be hard on the bound, over every cluster of the
    leaf-128 table: grazing (in a triangle's plane but for |det| of 1-3 x
    1e-8, hitting it at a random point), far (origins 10^3-10^4 edge
    lengths away), edges (hits on a vertex or an edge's midpoint, from
    nearby). No skipped pair held a taken hit; bitwise equal."""
    rng = np.random.default_rng({"grazing": 41, "far": 42, "edges": 43}[case])
    rows = bunny_rows[1][128]
    r = 2 * TILE
    picks = _triangles(rows, r, rng)
    edge = rows[..., 3:6].norm(dim=-1).max()
    if case == "edges":
        bary = np.array([[0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5],
                         [0.5, 0.5]])[rng.integers(0, 6, r)]
        dist = rng.uniform(0.5, 20.0, r)
    else:
        u = rng.random((r, 2))
        bary = np.where(u.sum(1, keepdims=True) > 1, 1 - u, u)
        dist = (rng.uniform(1e3, 1e4, r) * float(edge) if case == "far"
                else rng.uniform(0.5, 20.0, r))
    ro, rd = _aimed(rows, picks, bary, dist, case == "grazing", rng)
    seed = torch.full((r,), 1e30)
    wl = _every_cluster(rng, r // TILE, rows.shape[0])
    pairs, kept, hits = _audited(wl, rows, ro, rd, seed)
    assert hits > r // 4 and kept < pairs


def _sliver_table(rng):
    """A table of 4 clusters of 8 lanes: zero rows everywhere but for a
    cluster of one triangle, a cluster of slivers (e2 a multiple of e1,
    and e2 = e1 plus 1e-7 across it) beside a normal triangle, a cluster
    of only zero rows, and a cluster of triangles of mixed orientation
    (the widest cone)."""
    rows = np.zeros((4, 8, 12), dtype=np.float32)

    def put(c, j, p0, e1, e2, fid):
        rows[c, j, 0:3], rows[c, j, 3:6], rows[c, j, 6:9] = p0, e1, e2
        rows[c, j, 9] = np.array(fid, dtype=np.int32).view(np.float32)

    put(0, 5, [0, 0, 0], [1, 0, 0], [0, 1, 0], 1)
    put(1, 0, [0, 0, 0.5], [1, 1, 0], [2, 2, 0], 2)
    put(1, 1, [0, 0, 0.25], [1, 0, 0], [1, 1e-7, 0], 3)
    put(1, 2, [0, 0, 0.75], [0.5, 0, 0], [0, 0.5, 0], 4)
    for j in range(8):
        n = rng.normal(size=3)
        e1 = np.cross(n, rng.normal(size=3))
        put(3, j, rng.uniform(-0.5, 0.5, 3), e1, np.cross(n, e1) / 3, 5 + j)
    return _t(rows)


def test_cull_degenerate_rows():
    """Zero rows, slivers, a cluster of one triangle, one of only zero
    rows (culled for every ray) and one of mixed normals, against rays
    at and around them: no skipped pair held a taken hit, bitwise equal;
    the empty cluster is skipped for every ray, the one-triangle
    cluster for the rays that pass far from it."""
    rng = np.random.default_rng(44)
    rows = _sliver_table(rng)
    rec = tdn.worklist_cull_prep_plain(rows)
    assert rec[:, tdn.STATE].tolist() == [1.0, 1.0, -1.0, 1.0]
    r = 2 * TILE
    target = torch.from_numpy(rng.uniform(-1.5, 1.5, (r, 3))).float()
    ro = torch.from_numpy(rng.normal(size=(r, 3)) * 4).float()
    rd = target - ro
    rd /= rd.norm(dim=1, keepdim=True)
    wl = _every_cluster(rng, r // TILE, 4, gaps=False)
    seed = torch.full((r,), 1e30)
    pairs, kept, hits = _audited(wl, rows, ro, rd, seed)
    assert hits > 0 and kept < pairs
    keep = tdn.worklist_cull_plain(rec[[2] * r], ro, rd, seed)
    assert not keep.any()


def test_sweep_slot_and_row_designs():
    """The sweep's intersect_worklist designs set only constants of the
    worklist test's design block, each once and each to another value
    than the package's, and each of its ray-major walk designs has its C
    entry point in `csrc/walk_designs.cu` (the sweep builds both on the
    card)."""
    import os
    import re

    from raypt_torch.kernels import sweep
    from raypt_torch.kernels._build import CSRC_DIR
    source, entry, scope, variants = sweep.SWEPT["slots"]
    with open(os.path.join(CSRC_DIR, source)) as f:
        src = f.read()
    assert f"int {entry}(" in src
    block = src[src.index(scope):src.index("\n\n", src.index(scope))]
    package = {k: int(v) for k, v in
               re.findall(r"constexpr int (\w+) = (\d+);", block)}
    assert set(package) == {"kCullCarry", "kCullRays", "kCullChunks",
                            "kCullMinBlocks"}
    for consts in variants.values():
        assert set(consts) <= set(package)
        assert all(package[k] != v for k, v in consts.items())
        out = sweep._set(src, scope, consts)
        changed = [b for a, b in zip(src.splitlines(), out.splitlines())
                   if a != b]
        assert len(changed) == len(consts)
    with open(os.path.join(CSRC_DIR, "walk_designs.cu")) as f:
        designs = f.read()
    assert sweep.ROW_DESIGNS
    for name in sweep.ROW_DESIGNS:
        assert f"int rk_walk_{name}(" in designs
    assert sweep.SWEPT["rows"][1] == "rk_topwalk_mask_rows"
