"""raypt_torch's CUDA kernels against their plain torch versions on the
card, bitwise, and each render path through the kernels against the
same render through the plain versions. Marked `gpu`; skipped where
torch sees no CUDA device.
This file imports no JAX, so it runs on the GPU machine with

    python -m pytest tests/test_torch_gpu.py --noconftest -o addopts='' \
        -p no:cacheprovider -q
"""
from functools import partial

import pytest
import torch

from raypt_torch.accel.clusters import (CLUSTER_LEAF, build_clusters,
                                        tile_union_counts, tile_worklists)
from raypt_torch.accel.ctree import build_onehot
from raypt_torch.accel.host_bvh import build_sah
from raypt_torch.accel.traverse import (DENSE_CHUNK, KERNELS, PLAIN,
                                        find_closest_cluster,
                                        find_closest_onehot, onehot_inputs,
                                        wavefront_inputs)
from raypt_torch.core.math3d import BIG
from raypt_torch.core.types import RenderConfig
from raypt_torch.kernels import cluster_expand as tex
from raypt_torch.kernels import cluster_pallas as tdn
from raypt_torch.kernels import compact as tcp
from raypt_torch.kernels import dense_pallas as tdp
from raypt_torch.kernels import onehot_walk as twk
from raypt_torch.render.integrator import make_finder, render_sample
from raypt_torch.rng import sampler as rng
from raypt_torch.scenes.builtin import stanford_bunny
from raypt_torch.scenes.config4 import config4_scene

from chip_smoke import (LAYOUT_FLAGS, MERGE_LEAVES, WL_GROUPS,
                        WOOP_ODD_LEAF, Stats, check_lbvh, check_planted,
                        check_ties, compact_layouts, layout_tie_case,
                        small_meshes,
                        config5_case, copy_most_hit, edge_seeds, fit_run,
                        deep_stack_case, merge_case, mixed_tile, same_fit,
                        walk_edges, walk_layouts, wide_edges, woop_faces,
                        woop_merge, worklist_edges, worklist_merge,
                        zero_maps_table, compare_unfused, cull_audit,
                        cull_edges)

pytestmark = pytest.mark.gpu

W = 256
GROUP = 8192
CFG = RenderConfig(width=W, height=W, samples_per_pixel=1, num_bounces=3,
                   backend="onehot", onehot_leaf=384, onehot_expand=8192,
                   onehot_compact=GROUP)
# the second slice's paths: the JAX package's onehot defaults (dense-union
# branch, leaf 128) and the cluster backend
DENSE = CFG.replace(onehot_leaf=128, onehot_expand=0, onehot_compact=0)
CLUSTER = CFG.replace(backend="cluster")
# backends "pallas" and "dense" (one finder: the Woop table built from
# the scene, closest_dense) and the onehot finder's non-fused branch at
# leaf 128
UNFUSED = dict(expand_n=0, compact_n=0, use_pallas_intersect=False)
# the config-4 path: 8 bounces, refraction, the onehot finder's Woop
# branch on a leaf-128 accel built with_woop
C4 = DENSE.replace(num_bounces=8, enable_refraction=True)


@pytest.fixture(scope="module")
def gpu_scene(tmp_path_factory):
    """The bench scene at 256^2 on the card, with leaf-384, leaf-128 and
    leaf-16 onehot accels (8, 8 and 40 mask words) and leaf-64 clusters
    (under "cluster"); under "config4", the config-4 scene at 256^2 and
    its leaf-128 accel with the Woop table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = stanford_bunny()
    b.camera.viewport_width = b.camera.viewport_height = W
    scene = b.freeze("cuda")
    m = scene.mesh
    bvh = build_sah(m)
    accels = {leaf: build_onehot(bvh, m.positions, m.faces, m.face_valid,
                                 leaf=leaf).to("cuda")
              for leaf in (384, 128, 16)}
    accels["cluster"] = build_clusters(bvh, m.positions, m.faces, m.face_valid,
                                       leaf=CLUSTER_LEAF).to("cuda")
    b4 = config4_scene(str(tmp_path_factory.mktemp("c4") / "sky.hdr"))
    b4.camera.viewport_width = b4.camera.viewport_height = W
    scene4 = b4.freeze("cuda")
    m4 = scene4.mesh
    accels["config4"] = (scene4, build_onehot(
        build_sah(m4), m4.positions, m4.faces, m4.face_valid, leaf=128,
        with_woop=True).to("cuda"))
    return scene, accels


def _plain_finder(accel, cfg=CFG):
    if cfg.backend == "cluster":
        return lambda s, ro, rd, active=None: find_closest_cluster(
            s, accel, ro, rd, active, ops=PLAIN)
    return partial(find_closest_onehot, accel=accel, ops=PLAIN,
                   expand_n=cfg.onehot_expand, compact_n=cfg.onehot_compact)


def _path(scene, accels, path):
    """(cfg, finder through the kernels, finder through the plain
    versions) of a render path."""
    if path == "unfused":
        return (DENSE, partial(find_closest_onehot, accel=accels[128],
                               **UNFUSED),
                partial(find_closest_onehot, accel=accels[128], ops=PLAIN,
                        **UNFUSED))
    if path == "config4":
        acc = accels["config4"][1]
        return (C4, make_finder(accels["config4"][0], C4, acc),
                partial(find_closest_onehot, accel=acc, ops=PLAIN,
                        expand_n=0, compact_n=0))
    if path in ("pallas", "auto", "bvh"):
        # "auto" resolves to "dense"; "bvh" builds the LBVH on the card
        cfg = CFG.replace(backend=path)
        finder = make_finder(scene, cfg)
        return cfg, finder, partial(finder, ops=PLAIN)
    cfg, accel = {"expand": (CFG, accels[384]),
                  "dense_union": (DENSE, accels[128]),
                  "cluster": (CLUSTER, accels["cluster"])}[path]
    return cfg, make_finder(scene, cfg, accel), _plain_finder(accel, cfg)


def _waves(scene, cfg, accel, key, finder=None):
    """The (ro, rd, active) wavefront of every bounce of a render."""
    waves = []
    finder = finder or make_finder(scene, cfg, accel)

    def record(s, ro, rd, active=None):
        waves.append((ro.reshape(-1, 3), rd.reshape(-1, 3),
                      active.reshape(-1)))
        return finder(s, ro, rd, active)

    with torch.no_grad():
        render_sample(scene, cfg, rng.key(key), record)
    return waves


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _expand_stages(scene, accels, leaf, bounce, group=GROUP):
    """The expand path's four stages, each fed the kernel's outputs of
    the stage before it, compacting in groups of `group` lanes; the
    uncompaction is compared on every lane (its permutation is full)."""
    ro, rd, active = _waves(scene, CFG, accels[384], 1)[bounce]
    accel = accels[leaf]
    o, d, t, a, _, _ = onehot_inputs(scene, ro, rd, active, group)
    counts = tcp.new_counts(a, group)   # the finder's flow
    kc = KERNELS.compact(o, d, t, a, group, counts)
    pc = PLAIN.compact(o, d, t, a, group)
    assert torch.equal(kc[3], pc[3])
    assert torch.equal(counts, tcp.chunk_counts(a, group))
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
    kut, kuf = KERNELS.uncompact(kt, kf, a, group, counts)
    put, puf = PLAIN.uncompact(kt, kf, a, group)
    assert _bits_equal(kut, put) and torch.equal(kuf, puf)


def _cm_u_stage(scene, accels, leaf, bounce, layout):
    """topwalk_cm_u on the expand path's wavefront: uncompacted, on a
    dead, a one-live and a last-warp-only block (`chip_smoke.walk_layouts`,
    layout "edges"); or after the compaction, on a walk tile with a live,
    a 44-live and six dead 256-ray blocks (`chip_smoke.mixed_tile`,
    layout "mixed"), whose union_pp row must not be empty."""
    ro, rd, active = _waves(scene, CFG, accels[384], 1)[bounce]
    accel = accels[leaf]
    if layout == "edges":
        o, d, t, a, _, _ = onehot_inputs(scene, ro, rd, walk_layouts(active),
                                         GROUP)
    else:
        active, tile = mixed_tile(active, GROUP)
        o, d, t, a, _, _ = onehot_inputs(scene, ro, rd, active, GROUP)
        o, d, t, a = KERNELS.compact(o, d, t, a, GROUP)
        blocks = a[tile * 2048:(tile + 1) * 2048].view(-1, 256)
        assert blocks.sum(dim=1).tolist() == [256, 44] + [0] * 6
    args = (accel.table, o, d, t, a, -(-accel.num_clusters // 256) * 8)
    km, ku = KERNELS.walk(*args)
    pm, pu = PLAIN.walk(*args)
    assert torch.equal(km, pm) and torch.equal(ku, pu) and bool(km.any())
    if layout == "mixed":
        assert bool(ku[tile].any())


def _walk_mask_stage(scene, accels, leaf, bounce, edges=False):
    """The non-fused path's mask-only walk, in both layouts; with edges,
    on a dead, a one-live and a last-warp-only block
    (`chip_smoke.walk_layouts`)."""
    cfg, finder, _ = _path(scene, accels, "unfused")
    ro, rd, active = _waves(scene, cfg, None, 5, finder)[bounce]
    if edges:
        active = walk_layouts(active)
    accel = accels[leaf]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    args = (accel.table, o, d, t, a, -(-accel.num_clusters // 32))
    km = KERNELS.walk_mask(*args)
    assert torch.equal(km, PLAIN.walk_mask(*args)) and bool(km.any())
    assert torch.equal(twk.topwalk_cm(*args), km.T)


def _closest_dense_stage(scene, accels, copies, bounce):
    """closest_dense on the pallas path (every ray, as the finder passes
    them); with copies, also on the table with copies of the most-hit
    triangles within their chunk and across chunks
    (`chip_smoke.copy_most_hit`), whose result must not change."""
    cfg, finder, _ = _path(scene, accels, "pallas")
    ro, rd, _ = _waves(scene, cfg, None, 5, finder)[bounce]
    mats, chunk = finder.args
    o, d, t, _, _, _ = wavefront_inputs(scene, ro, rd, None, tdp.RAY_TILE)
    kt, kf = KERNELS.closest_dense(*mats, o, d, t, tri_chunk=chunk)
    pt, pf = PLAIN.closest_dense(*mats, o, d, t, tri_chunk=chunk)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert int((kf >= 0).sum()) > o.shape[0] // 2
    if copies:
        dup, src = copy_most_hit(mats, chunk, kf, 16)
        dt, df = KERNELS.closest_dense(*dup, o, d, t, tri_chunk=chunk)
        assert _bits_equal(dt, kt) and torch.equal(df, kf)
        assert int(torch.isin(kf, src).sum()) > 0
        pt, pf = PLAIN.closest_dense(*dup, o, d, t, tri_chunk=chunk)
        assert _bits_equal(dt, pt) and torch.equal(df, pf)


def _woop_stage(accels, bounce):
    """The config-4 path's Woop intersection on the kernel walk's tile
    unions, with the first tile's seeds -BIG (dead rays) and a stray
    union bit >= C in every tile."""
    scene4, acc = accels["config4"]
    cfg, finder, _ = _path(None, accels, "config4")
    ro, rd, active = _waves(scene4, cfg, None, 6, finder)[bounce]
    o, d, t, a, _, _ = wavefront_inputs(scene4, ro, rd, active, DENSE_CHUNK)
    mask = KERNELS.walk_mask(acc.table, o, d, t, a, -(-acc.num_clusters // 32))
    union = tile_union_counts(mask, tdn.TILE)[0]
    if acc.num_clusters % 32:
        union[:, -1] |= 1 << (acc.num_clusters % 32)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    seed[:tdn.TILE] = -BIG
    args = (union, acc.woop_cm, o, d, seed)
    kt, kp = KERNELS.intersect_woop(*args)
    pt, pp = PLAIN.intersect_woop(*args)
    assert _bits_equal(kt, pt) and torch.equal(kp, pp)
    assert int((kp >= 0).sum()) > 0 and not bool((kp[:tdn.TILE] >= 0).any())


def _grouped_stage(scene, accels, bounce):
    """cluster_intersect_grouped for G = 2, 3, 4 on worklists 61 wide (no
    G divides it) of one bounce of the cluster render: bitwise equal to
    its plain version and to cluster_intersect; with counts cut below
    the list (valid ids past counts), to its plain version."""
    clusters = accels["cluster"]
    ro, rd, active = _waves(scene, CLUSTER, clusters, 4)[bounce]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    wl, cnt, _ = tile_worklists(clusters, o, d, seed, 256, 61)
    tiles = torch.arange(cnt.numel(), device=cnt.device)
    cut = torch.clamp(cnt - (tiles % 4).to(cnt.dtype), min=0)
    for c_ in (cnt, cut):
        args = (wl, c_, clusters.tri_rows, o, d, seed)
        ut, uf = KERNELS.intersect(*args)
        for g in (2, 3, 4):
            kt, kf = tdn.cluster_intersect_grouped(*args, group=g)
            pt, pf = tdn.cluster_intersect_grouped_plain(*args, group=g)
            assert _bits_equal(kt, pt) and torch.equal(kf, pf)
            if c_ is cnt:
                assert _bits_equal(kt, ut) and torch.equal(kf, uf)
    assert int((uf >= 0).sum()) > 0


@pytest.mark.parametrize("stage,leaf,bounce", [
    ("expand", 384, 0), ("expand", 384, 1), ("expand", 16, 1),
    ("walk_mask", 128, 1), ("walk_mask", 16, 1),
    ("walk_edges", 128, 1), ("walk_edges", 16, 1),
    ("cm_u_edges", 384, 1), ("cm_u_edges", 16, 1), ("cm_u_mixed", 384, 1),
    ("closest_dense", None, 0), ("closest_dense", None, 2),
    ("closest_dense_copies", None, 0), ("woop", None, 0), ("woop", None, 1),
    ("grouped", None, 1)])
def test_stages_bitwise(gpu_scene, stage, leaf, bounce):
    """Each kernel stage against its plain version on one bounce's
    wavefront of its render path: the expand path's four (leaf 384, and
    leaf 16 with 40 mask words), the non-fused path's mask-only walk
    (leaf 128: 5 words; leaf 16: 33, not a multiple of 8; also on a
    dead, a one-live and a last-warp-only block), topwalk_cm_u on the
    same blocks and on a compacted walk tile of live, part-live and dead
    blocks, the pallas
    path's closest_dense, also where copied triangles tie with their
    sources and the lowest id must win, the config-4 path's Woop
    intersection and the grouped worklist intersection on the cluster
    path's wavefront."""
    scene, accels = gpu_scene
    if stage == "expand":
        _expand_stages(scene, accels, leaf, bounce)
    elif stage.startswith("cm_u"):
        _cm_u_stage(scene, accels, leaf, bounce, stage[5:])
    elif stage.startswith("walk"):
        _walk_mask_stage(scene, accels, leaf, bounce, stage == "walk_edges")
    elif stage == "woop":
        _woop_stage(accels, bounce)
    elif stage == "grouped":
        _grouped_stage(scene, accels, bounce)
    else:
        _closest_dense_stage(scene, accels, stage.endswith("copies"), bounce)


@pytest.mark.parametrize("group", [100, 1536, 32768])
def test_expand_groups_bitwise(gpu_scene, group):
    """The expand path's four stages on its bounce-1 wavefront with the
    compaction and uncompaction in groups of 100 (below the 256 lanes a
    block ranks), 1,536 (six chunks) and 32,768 (bench.py's)."""
    scene, accels = gpu_scene
    _expand_stages(scene, accels, 384, 1, group)


@pytest.mark.parametrize("leaf,bounce", [(128, 0), (128, 1), (16, 1)])
def test_dense_union_stages_bitwise(gpu_scene, leaf, bounce):
    """The union walk and the mask intersection on one bounce of the
    dense-union render, the intersection fed the kernel's unions; the
    first tile's rays all dead."""
    scene, accels = gpu_scene
    ro, rd, active = _waves(scene, DENSE, accels[128], 3)[bounce]
    active = active.clone()
    active[:256] = False
    accel = accels[leaf]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    nw = -(-accel.num_clusters // 32)
    ku = KERNELS.walk_union(accel.table, o, d, t, a, nw)
    assert torch.equal(ku, PLAIN.walk_union(accel.table, o, d, t, a, nw))
    assert not bool(ku[0].any()) and bool(ku.any())
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    args = (ku, accel.clusters.tri_rows, o, d, seed)
    kt, kf = KERNELS.intersect_mask(*args)
    pt, pf = PLAIN.intersect_mask(*args)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert int((kf >= 0).sum()) > 0


@pytest.mark.parametrize("bounce", [0, 1])
def test_cluster_stages_bitwise(gpu_scene, bounce):
    """The worklist intersection on one bounce of the cluster render, and
    the whole cluster finder at cap 2, where tiles overflow into the
    fallback (primary-ray tiles see ~3 clusters), through the kernels
    against the plain versions."""
    scene, accels = gpu_scene
    clusters = accels["cluster"]
    ro, rd, active = _waves(scene, CLUSTER, clusters, 4)[bounce]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    wl, cnt, _ = tile_worklists(clusters, o, d, seed, 256)
    args = (wl, cnt, clusters.tri_rows, o, d, seed)
    kt, kf = KERNELS.intersect(*args)
    pt, pf = PLAIN.intersect(*args)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert int((kf >= 0).sum()) > 0
    assert bool(tile_worklists(clusters, o, d, seed, 256, 2)[2].any())
    k = find_closest_cluster(scene, clusters, ro, rd, active, cap=2)
    p = find_closest_cluster(scene, clusters, ro, rd, active, cap=2,
                             ops=PLAIN)
    assert _bits_equal(k.t, p.t) and torch.equal(k.tri, p.tri)
    assert torch.equal(k.sphere, p.sphere)


@pytest.mark.parametrize("leaf,bounce", [(128, 0), (128, 1), (128, 2),
                                         (16, 1)])
def test_intersect_worklist_bitwise(gpu_scene, leaf, bounce):
    """The worklist intersection (intersect_worklist_jnp's rules) on one
    bounce of the non-fused render, its worklists the first 512 clusters
    of each tile's union, against its plain version, bitwise; then
    chip_smoke.worklist_edges: -1 gaps between filled slots, a repeated
    id, an all -1 and an all-dead tile, a coincident triangle in a later
    lane (the first lane wins) and an exact tie across two slots (the
    earlier slot keeps it)."""
    scene, accels = gpu_scene
    ro, rd, active = _waves(scene, DENSE, accels[128], 5,
                            partial(find_closest_onehot, accel=accels[128],
                                    **UNFUSED))[bounce]
    stats = Stats()
    _, args = compare_unfused(stats, f"bounce {bounce}", scene, accels[leaf],
                              ro, rd, active, timed=False)
    lanes, slots = worklist_edges(stats, *args, rng_seed=leaf + bounce)
    assert lanes > 0 and slots > 0 and stats.err["intersect_worklist"] == 0


@pytest.mark.parametrize("table", ["onehot128", "cluster"])
def test_worklist_cull_edges_bitwise(gpu_scene, table):
    """chip_smoke.cull_edges on the leaf-128 clusters and on the cluster
    finder's: grazing rays (|det| of 1-3 x 1e-8), origins 10^3-10^4 edge
    lengths away, hits on vertices and edge midpoints, and a table of
    zero rows, slivers, a one-triangle, an empty and a mixed-normal
    cluster; each bitwise the plain version, and the kernel's audit finds
    no skipped pair with a taken hit."""
    _, accels = gpu_scene
    rows = (accels[128].clusters.tri_rows if table == "onehot128"
            else accels["cluster"].tri_rows)
    stats = Stats()
    cull_edges(stats, rows, "cuda", rays=1024)
    assert stats.err["intersect_worklist"] == 0


def test_cluster_fallback_cull_audit(gpu_scene):
    """The cluster finder's overflow fallback worklists at cap 2 (every
    cluster, each overflowed tile) and its nearest-first worklists with
    use_pallas=False: intersect_worklist's audit bitwise the plain
    version, no skipped pair with a taken hit, and the cull keeps fewer
    pairs than the worklists hold."""
    scene, accels = gpu_scene
    clusters = accels["cluster"]
    ro, rd, active = _waves(scene, CLUSTER, clusters, 6)[1]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    wl, _, over = tile_worklists(clusters, o, d, seed, 256, 2)
    ov = torch.nonzero(over).flatten()
    rays = (ov[:, None] * 256 + torch.arange(256, device=ov.device)).flatten()
    every = torch.arange(clusters.num_clusters, dtype=torch.int32,
                         device=ov.device).expand(ov.numel(), -1).contiguous()
    stats = Stats()
    for args in ((every, clusters.tri_rows, o[rays].contiguous(),
                  d[rays].contiguous(), seed[rays].contiguous()),
                 (tile_worklists(clusters, o, d, seed, 256)[0],
                  clusters.tri_rows, o, d, seed)):
        pairs, kept = cull_audit(stats, "fallback", args,
                                 tdn.intersect_worklist_plain(*args))
        assert 0 < kept < pairs


@pytest.mark.parametrize("bounce", [0, 2])
def test_worklist_cull_records_and_kept(gpu_scene, bounce):
    """intersect_worklist_audit on one bounce of the non-fused render:
    its pre-pass's records equal worklist_cull_prep_plain's (run on the
    CPU) value for value, its live and kept pair counts are
    intersect_worklist_culled_plain's on the same inputs (the plain
    predicate on the card), no skipped pair held a taken hit, and its
    (t, face) is the plain version's bitwise."""
    scene, accels = gpu_scene
    ro, rd, active = _waves(scene, DENSE, accels[128], 5,
                            partial(find_closest_onehot, accel=accels[128],
                                    **UNFUSED))[bounce]
    _, args = compare_unfused(Stats(), f"bounce {bounce}", scene,
                              accels[128], ro, rd, active, timed=False)
    t, f, (pairs, kept, bad), recs = tdn.intersect_worklist_audit(*args)
    assert torch.equal(recs.cpu(), tdn.worklist_cull_prep_plain(
        args[1].cpu()))
    ct, cf, counts = tdn.intersect_worklist_culled_plain(*args)
    assert counts == (pairs, kept, 0) and 0 < kept <= pairs
    if bounce:
        assert kept < pairs
    pt, pf = tdn.intersect_worklist_plain(*args)
    assert _bits_equal(t, pt) and torch.equal(f, pf)
    assert _bits_equal(ct, pt) and torch.equal(cf, pf)


def test_topwalk_rows_launch(gpu_scene):
    """topwalk launches the mask-only walk's ray-major mode itself (no
    transpose, no topwalk_cm launch): one launch counted on topwalk, its
    (R, words) mask contiguous and bitwise the plain walk's."""
    scene, accels = gpu_scene
    cfg, finder, _ = _path(scene, accels, "unfused")
    ro, rd, active = _waves(scene, cfg, None, 5, finder)[1]
    accel = accels[128]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    args = (accel.table, o, d, t, a, -(-accel.num_clusters // 32))
    before = (twk.topwalk.launches, twk.topwalk_cm.launches)
    km = twk.topwalk(*args)
    assert (twk.topwalk.launches, twk.topwalk_cm.launches) == (
        before[0] + 1, before[1])
    assert km.is_contiguous() and torch.equal(km, PLAIN.walk_mask(*args))


def test_cluster_worklist_routes_bitwise(gpu_scene):
    """find_closest_cluster(use_pallas=False) at the default cap and at
    cap 2 (whose fallback runs the worklist kernel too) through the
    kernels against PLAIN, bitwise; each launch counted once where it
    runs the kernel."""
    scene, accels = gpu_scene
    clusters = accels["cluster"]
    ro, rd, active = _waves(scene, CLUSTER, clusters, 6)[1]
    for cap in (0, 2):
        before = tdn.intersect_worklist.launches
        k = find_closest_cluster(scene, clusters, ro, rd, active,
                                 use_pallas=False, cap=cap)
        assert tdn.intersect_worklist.launches == before + (2 if cap else 1)
        p = find_closest_cluster(scene, clusters, ro, rd, active,
                                 use_pallas=False, cap=cap, ops=PLAIN)
        assert _bits_equal(k.t, p.t) and torch.equal(k.tri, p.tri)
        assert torch.equal(k.sphere, p.sphere) and bool((k.tri >= 0).any())


# the onehot finder's options (find_closest_onehot's keywords), each on
# the branch it applies to: accel key, base keywords, the option
OPTIONS = [
    ("sort-alive", 128, {}, dict(sort_rays="alive")),
    ("sort-mask", 128, {}, dict(sort_rays="mask")),
    ("sort-True", 128, {}, dict(sort_rays=True)),
    ("segment-2048", 128, {}, dict(segment_sort=2048)),
    ("segment-3000", 128, {}, dict(segment_sort=3000)),
    ("tile_b-128", 128, {}, dict(tile_b=128)),
    ("tile_b-512", 128, {}, dict(tile_b=512)),
    ("walk_tile-128", 128, {}, dict(walk_tile=128)),
    ("expand-walk_tile-512", 384, dict(expand_n=8192, compact_n=GROUP),
     dict(walk_tile=512)),
    ("expand-sort-alive", 384, dict(expand_n=8192, compact_n=GROUP),
     dict(sort_rays="alive")),
    ("woop-sort-mask", "config4", {}, dict(sort_rays="mask")),
    ("unfused-sort-alive", 128, dict(use_pallas_intersect=False),
     dict(sort_rays="alive")),
    ("unfused-segment-2048", 128, dict(use_pallas_intersect=False),
     dict(segment_sort=2048)),
    ("unfused-no-fallback", 128, dict(use_pallas_intersect=False),
     dict(overflow_fallback=False)),
]


@pytest.mark.parametrize("name,leaf,base,opts", OPTIONS,
                         ids=[o[0] for o in OPTIONS])
def test_option_render_bitwise(gpu_scene, name, leaf, base, opts):
    """A render through find_closest_onehot with the option: bitwise the
    same render through PLAIN, and bitwise the render with no option
    (each ray's mask lies inside its tile's union; every sort is
    undone)."""
    scene, accels = gpu_scene
    cfg = DENSE
    if leaf == "config4":
        scene, accel = accels["config4"]
        cfg = C4
    else:
        accel = accels[leaf]
    kw = dict(dict(expand_n=0, compact_n=0), **base)

    def render(ops=KERNELS, **more):
        with torch.no_grad():
            return render_sample(scene, cfg, rng.key(7), partial(
                find_closest_onehot, accel=accel, ops=ops, **kw, **more),
                return_alive=True)

    img, tr = render(**opts)
    img_p, tr_p = render(PLAIN, **opts)
    img_0, tr_0 = render()
    assert bool(torch.isfinite(img).all()) and int(tr[1]) > 0
    assert _bits_equal(img, img_p) and torch.equal(tr, tr_p)
    assert _bits_equal(img, img_0) and torch.equal(tr, tr_0)


@pytest.mark.parametrize("path", ["expand", "dense_union", "cluster",
                                  "pallas", "auto", "unfused", "config4",
                                  "bvh"])
def test_render_bitwise_vs_plain_finder(gpu_scene, path):
    scene, accels = gpu_scene
    cfg, finder, plain = _path(scene, accels, path)
    if path == "config4":
        scene = accels["config4"][0]
    with torch.no_grad():
        img_k, tr_k = render_sample(scene, cfg, rng.key(2), finder,
                                    return_alive=True)
        img_p, tr_p = render_sample(scene, cfg, rng.key(2), plain,
                                    return_alive=True)
    assert bool(torch.isfinite(img_k).all())
    assert _bits_equal(img_k, img_p) and torch.equal(tr_k, tr_p)


@pytest.mark.parametrize("copies", [1, 16])
@pytest.mark.parametrize("layout", ["dead_tile", "same_ray"])
@pytest.mark.parametrize("leaf", [128, 16])
def test_union_walk_edges_bitwise(gpu_scene, leaf, layout, copies):
    """The union walk against its plain version on the dense-union
    render's bounce-1 wavefront (65,536 rays, or 16 copies of it: 2^20)
    at leaf 128 and at leaf 16 (33 union words), with its first tile's
    rays all dead among live tiles (dead_tile: an empty union, stored
    without a walk), or all 256 the same live ray (same_ray: every
    thread wants the same leaves at the same steps, so every flush of a
    word contends for it)."""
    scene, accels = gpu_scene
    ro, rd, active = _waves(scene, DENSE, accels[128], 3)[1]
    ro, rd, active = (x.repeat(copies, *([1] * (x.dim() - 1)))
                      for x in (ro, rd, active))
    if layout == "dead_tile":
        active[:256] = False
    else:
        k = int(torch.nonzero(active)[0])
        ro[:256], rd[:256], active[:256] = ro[k], rd[k], True
    accel = accels[leaf]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    args = (accel.table, o, d, t, a, -(-accel.num_clusters // 32))
    ku = twk.topwalk_union(*args)
    assert torch.equal(ku, twk.topwalk_union_plain(*args))
    assert bool(ku[1:].any()) and bool(ku[0].any()) == (layout == "same_ray")


@pytest.mark.parametrize("size", ["small", "wavefront"])
@pytest.mark.parametrize("group", [100, 256, 1000, 1024, 1536, 32768])
def test_compact_edges_bitwise(group, size):
    """alive_compact and alive_uncompact against their plain versions on
    every lane (the permutation is full: dead lanes carry their own
    data), on three groups (small) or on as many whole groups as fit in
    2^20 lanes, with all lanes dead, all alive, only each group's last
    lane alive, alternating lanes and a random 60% alive
    (`chip_smoke.compact_layouts`). Group 100 is below the 256 lanes a
    block ranks, 1,000 a multiple of neither 16 lanes (the mask is read
    a byte at a time) nor the chunk (each group ends in a partial
    chunk), and 1,536 of no 1,024-lane chunk. The uncompaction runs with
    its own count pass and with the counts the compaction left."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = 3 * group if size == "small" else (1 << 20) // group * group
    gen = torch.Generator(device="cuda").manual_seed(group)
    ro = torch.randn((r, 3), device="cuda", generator=gen) * 1e3
    rd = torch.randn((r, 3), device="cuda", generator=gen)
    t0 = torch.rand((r,), device="cuda", generator=gen) * 1e8
    face = torch.arange(r, dtype=torch.int32, device="cuda")
    active = torch.rand((r,), device="cuda", generator=gen) < 0.6
    for alive in compact_layouts(r, group, active).values():
        args = (ro, rd, t0, alive, group)
        for x, y in zip(tcp.alive_compact(*args),
                        tcp.alive_compact_plain(*args)):
            assert _bits_equal(x, y)
        uargs = (t0, face, alive, group)
        want = tcp.alive_uncompact_plain(*uargs)
        counts = tcp.new_counts(alive, group)
        tcp.alive_compact(*args, counts)
        for got in (tcp.alive_uncompact(*uargs),
                    tcp.alive_uncompact(*uargs, counts)):
            for x, y in zip(got, want):
                assert _bits_equal(x, y)


@pytest.mark.parametrize("slots,rays", [(256, 256), (256, None),
                                        (8192, 256), (8192, None)])
def test_closest_dense_edges_bitwise(gpu_scene, slots, rays):
    """closest_dense against its plain version on the pallas path's
    bounce-0 rays (one tile, or all of them: rays None) with every 5th
    seed -BIG, nan or 1e-6, on the first `slots` slots of the scene's
    table (8,192: all of them, 3,070 of them padding) with zero maps, +0.0
    and -0.0, over every 9th slot among the real triangles
    (`chip_smoke.zero_maps_table`): the kernel skips them wherever they
    sit, and no fixed seed changes."""
    scene, accels = gpu_scene
    cfg, finder, _ = _path(scene, accels, "pallas")
    ro, rd, _ = _waves(scene, cfg, None, 5, finder)[0]
    o, d, t, _, _, _ = wavefront_inputs(scene, ro, rd, None, tdp.RAY_TILE)
    t, fixed = edge_seeds(t)
    r = rays or o.shape[0]
    mats, zero = zero_maps_table(finder.args[0], slots)
    chunk = tdp.pick_tri_chunk(slots)
    args = (*mats, o[:r], d[:r], t[:r])
    kt, kf = tdp.closest_dense(*args, tri_chunk=chunk)
    pt, pf = tdp.closest_dense_plain(*args, tri_chunk=chunk)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert _bits_equal(kt[fixed[:r]], t[:r][fixed[:r]])
    assert bool((kf[fixed[:r]] == -1).all())
    assert not bool(zero[kf[kf >= 0].long()].any())
    if slots == 8192 and rays is None:
        assert int((kf >= 0).sum()) > o.shape[0] // 2


@pytest.mark.parametrize("leaf,kernel", [
    (leaf, kernel) for leaf in MERGE_LEAVES
    for kernel in ("expand", "mask", "woop", "worklist")] + [
        (WOOP_ODD_LEAF, "woop")])
def test_merge_cases_bitwise(leaf, kernel):
    """cluster_expand, cluster_intersect_mask and, on the clusters' Woop
    table, cluster_intersect_mask_woop against their plain versions on
    `chip_smoke.merge_case`'s synthetic clusters: a triangle copied into
    a higher cluster with a lower face id (the lower cluster must win)
    and within its cluster (the lower id must win; Woop: the lower
    lane), a cluster that one ray of a block wants, an all-dead, a mixed
    and a one-live tile with nonzero masks, and, the second time, bits
    >= C set in every mask and union word past the clusters and
    triangles whose det reaches 2^126 and inf (the exact reciprocal's
    path). The Woop kernel also at a leaf no 4 divides, where it loads
    one lane at a time. The worklist kernel, and the grouped one at G =
    2 and 3, on the clusters as worklists (`chip_smoke.worklist_merge`:
    descending and ascending ids, counts at, above and below the lists'
    lengths, the all-dead, mixed and one-live tiles; the second time
    also ids outside [0, C) and counts above cap), where the earlier
    slot wins a tie across clusters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for stray in (False, True):
        case = merge_case(leaf, "cuda", seed=leaf, stray=stray, giant=stray)
        rays = (case["ro"], case["rd"], case["seed"])
        if kernel == "expand":
            args = (case["mask_cm"], case["union_pp"], case["tri_rows"], *rays)
            kt, kf = tex.cluster_expand(*args)
            pt, pf = tex.cluster_expand_plain(*args)
        elif kernel == "woop":
            woop_cm, fid, planted = woop_merge(case)
            args = (case["union"], woop_cm, *rays)
            kt, kf = tdn.cluster_intersect_mask_woop(*args)
            pt, pf = tdn.cluster_intersect_mask_woop_plain(*args)
        elif kernel == "worklist":
            wl, cnt, planted = worklist_merge(case, stray=stray, seed=leaf)
            args = (wl, cnt, case["tri_rows"], *rays)
            kt, kf = tdn.cluster_intersect(*args)
            pt, pf = tdn.cluster_intersect_plain(*args)
            for g in WL_GROUPS:
                gt, gf = tdn.cluster_intersect_grouped(*args, group=g)
                qt, qf = tdn.cluster_intersect_grouped_plain(*args, group=g)
                assert _bits_equal(gt, qt) and torch.equal(gf, qf)
                check_planted(planted, gf, f"{kernel} G={g}")
        else:
            args = (case["union"], case["tri_rows"], *rays)
            kt, kf = tdn.cluster_intersect_mask(*args)
            pt, pf = tdn.cluster_intersect_mask_plain(*args)
        assert _bits_equal(kt, pt) and torch.equal(kf, pf)
        if kernel == "woop":
            check_planted(planted, woop_faces(kf, fid), kernel)
        else:
            check_planted(planted if kernel == "worklist" else case, kf,
                          kernel)


def test_inv_det_sweep():
    """The kernels' 1 / det (the reciprocal's fast path, its exact path
    where the fast one asks for a redo) is bitwise the Pallas kernel's
    division of a select by a select for all 2^32 bit patterns of det,
    in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert tdn.inv_det_sweep() == (0, None)


def _probe_case(probe):
    """(kernel outputs, plain outputs) of one scripts/ probe kernel at a
    size between the CPU tests' and the script's defaults."""
    from raypt_torch.probes import (expand_debug, expand_diag2, gather,
                                    regroup, walk_spec_probe)
    from raypt_torch.probes.pallas_gather_test import inputs as gather_in
    name, _, arg = probe.partition(":")
    g = torch.Generator().manual_seed(5)

    def rows(n_rows, n, progs):
        return torch.randn((n_rows, n * progs), generator=g).to("cuda")

    if name == "gather":
        table, idx = gather_in("cuda")
        if arg == "oob":
            idx = idx.clone()
            idx[::5] = torch.tensor([-3, 32768, 40000, -1],
                                    device="cuda").repeat(52)[:idx[::5].numel()]
        clip = arg != "fill"
        return (gather.gather_rows(table, idx, clip),
                gather.gather_rows_plain(table, idx, clip))
    if name == "stages":
        wk, pages, pay, _, pages2 = expand_debug.inputs("cuda")
        m = expand_debug.stage12(wk, pages)[0]
        return ((*expand_debug.stage12(wk, pages),
                 *expand_debug.stage34(pay, m), expand_debug.stage5(wk, pages2)),
                (*expand_debug.stage12_plain(wk, pages),
                 *expand_debug.stage34_plain(pay, m),
                 expand_debug.stage5_plain(wk, pages2)))
    if name == "diag":   # [n_rays | nan]
        n = int(arg) if arg.isdigit() else 2048
        ro, rd, mask_cm, mask = expand_diag2.wavefront(
            "cuda", 128 if arg.isdigit() else 64)
        pay, otrue = expand_diag2.payload(ro, rd)
        if arg == "nan":   # NaN and inf in a few rays' truth and payload
            hit = torch.nonzero(expand_diag2.popcount(mask) > 0).flatten()
            otrue[0, hit[0::97]] = float("nan")
            otrue[4, hit[1::89]] = float("inf")
            otrue[2, hit[2::83]] = -float("inf")
            pay[3, hit[3::79]] = float("nan")
        got = expand_diag2.diag(mask_cm, pay, otrue, n)
        assert torch.equal(got[2][0].long(), expand_diag2.popcount(mask))
        if arg == "nan":
            assert bool(got[3].isnan().any()) and bool(got[1].isinf().any())
        return got, expand_diag2.diag_plain(mask_cm, pay, otrue, n)
    if name == "permute":   # mode[:n:programs:cycles]
        mode, *size = arg.split(":")
        n, progs, iters = map(int, size) if size else (8192, 8, 8)
        x = rows(8, n, progs)
        chain, fixed = mode in ("chain", "chain_fixed"), mode.endswith("fixed")
        return (regroup.permute(x, iters, n, chain, fixed),
                regroup.permute_plain(x, iters, n, chain, fixed))
    if name == "sel":   # [n:programs]
        n, progs = map(int, arg.split(":")) if arg else (2048, 8)
        x = rows(24, n, progs).to(torch.bfloat16)
        return regroup.sel(x, 16, n), regroup.sel_plain(x, 16, n)
    if name == "cycle":   # mode[:n:programs]
        mode, *size = arg.split(":")
        n, progs = map(int, size) if size else (8192, 8)
        x = rows(24, n, progs)
        return (regroup.cycle(x, 16, n, mode),
                regroup.cycle_plain(x, 16, n, mode))
    args = walk_spec_probe.wavefront("cuda", 256, int(arg))
    spec = walk_spec_probe.topwalk_spec(*args)
    return ((spec, spec), (twk.topwalk_cm(*args), twk.topwalk_cm_plain(*args)))


@pytest.mark.parametrize("probe", [
    "gather:fill", "gather:clip", "gather:oob", "stages", "diag", "permute:sum",
    "permute:sum_fixed", "permute:chain", "permute:chain_fixed", "sel",
    "sel:64:5", "sel:16384:3", "diag:1024", "diag:8192", "diag:nan"] + [
    f"permute:{mode}:{n}:3:{iters}"
    for mode in ("sum", "sum_fixed", "chain", "chain_fixed")
    for n, iters in ((100, 40), (4096, 40), (20000, 40), (8192, 300))] + [
    "cycle:full", "cycle:no_mm", "cycle:fixed_s", "walk_spec:512",
    "walk_spec:16"] + [f"cycle:{mode}:{n}:3" for mode in ("full", "no_mm",
                                                           "fixed_s")
                       for n in (128, 4096, 16384)] + [
    f"cycle:{mode}:{n}:1" for mode in ("full", "no_mm", "fixed_s")
    for n in (32768, 65536)] + ["cycle:full:300000:1"])
def test_probe_kernels_bitwise(probe):
    """Each kernel of raypt_torch/probes/ (the scripts/ probes) against its
    plain version; the speculative walk also against topwalk_cm. cycle
    also at any number of lanes a program: fixed_s restages its runs past
    32,768 lanes, full past 262,144. permute in its four modes at 100,
    4,096 and 20,000 lanes (every interested lane selected, then the scan
    stopping at the 128th) and for 300 cycles; diag at 1,024 and 8,192
    rays a program (the first kernel took at most 4,096) and with NaN and
    inf in some rays' truth and payload (merged by a max of bit patterns);
    diag's nc is every ray's popcount."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got, want = _probe_case(probe)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    assert any(bool(a.any()) for a in got) or probe.startswith("sel")


@pytest.fixture(scope="module", params=["window1024", "slot_tile"])
def permute_design(request):
    """rk_permute of regroup.cu built with its design block set: counts
    held 1,024 lanes at a time (the scans' stops past several windows) or
    the sweep's slot tile design."""
    import os

    from raypt_torch.kernels import sweep
    from raypt_torch.kernels._build import CSRC_DIR
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    consts = ({"kPermuteWindow": 1024} if request.param == "window1024"
              else sweep.PERMUTE_VARIANTS[request.param])
    with open(os.path.join(CSRC_DIR, "regroup.cu")) as f:
        text = f.read()
    path = sweep._nvcc_job(f"permute_{request.param}", "regroup.cu", sweep._set(
        text, "// The permute kernel's design", consts), CSRC_DIR)()
    return partial(sweep.CALLS["permute"],
                   sweep._loaded("permute", path, "rk_permute"))


@pytest.mark.parametrize("mode", ["sum", "sum_fixed", "chain", "chain_fixed"])
@pytest.mark.parametrize("n,progs,iters", [(8192, 3, 40), (20000, 1, 70),
                                           (100, 5, 33)])
def test_permute_designs(permute_design, mode, n, progs, iters):
    """The permute kernel's other designs, bitwise permute_plain: several
    windows of counts a program, and the slot tile design (lists of 32
    cycles at a time, so 33 and more cycles take two chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raypt_torch.probes import regroup
    g = torch.Generator().manual_seed(n + iters)
    x = torch.randn((8, n * progs), generator=g).cuda()
    chain, fixed = mode.startswith("chain"), mode.endswith("fixed")
    (got,) = permute_design(x, n, iters, chain, fixed)
    assert _bits_equal(got, regroup.permute_plain(x, iters, n, chain, fixed))


@pytest.fixture(scope="module")
def sel_wide():
    """rk_sel of regroup.cu built with a wider interest: residues below
    32 of 199 (the kernel's interest block, set by the sweep's `_set`)."""
    import os

    from raypt_torch.kernels import sweep
    from raypt_torch.kernels._build import CSRC_DIR
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(os.path.join(CSRC_DIR, "regroup.cu")) as f:
        text = f.read()
    path = sweep._nvcc_job("sel_wide", "regroup.cu", sweep._set(
        text, "// The probes' interest", {"kWidth": 32}), CSRC_DIR)()
    return partial(sweep.CALLS["sel"], sweep._loaded("sel", path, "rk_sel"))


@pytest.mark.parametrize("n,progs,iters", [(17, 3, 30), (64, 3, 5),
                                           (1000, 1, 4), (2048, 2, 3)])
def test_sel_general_path(sel_wide, n, progs, iters, monkeypatch):
    """sel_kernel with the wider interest gives lanes slots, so its
    general path runs: the ranks, the slot sums in ascending lane order,
    y and each lane's additions in cycle order, bitwise against sel_plain
    under the same interest (the probe's interest never gets there; at 17
    lanes only lane 16 can take a slot, first in cycle 23)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raypt_torch.probes import regroup
    monkeypatch.setattr(regroup, "_interest", lambda lane, c: (
        (lane * 37 + c * 131) % 199) < 32)
    g = torch.Generator().manual_seed(n)
    x = torch.randn((24, n * progs), generator=g).to(torch.bfloat16).cuda()
    want = regroup.sel_plain(x, iters, n)
    (got,) = sel_wide(x, n, iters)
    assert _bits_equal(got, want) and bool(want[:6].any())
    assert not bool(got[6:].any())


@pytest.fixture(scope="module")
def bvh_waves(gpu_scene):
    """The packed table of the bench scene's LBVH built on the card, and
    the wavefronts of a 256^2 render through it."""
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.packed import pack
    scene, _ = gpu_scene
    m = scene.mesh
    pb = pack(lbvh.build(m.positions, m.faces, m.face_valid), m.positions,
              m.faces, m.face_valid)
    return pb, _waves(scene, CFG.replace(backend="bvh"), pb, 4)


def test_lbvh_build_card_vs_cpu(gpu_scene):
    """lbvh.build, refit after a jitter and pack on the card against the
    CPU, bitwise (chip_smoke.check_lbvh raises otherwise), depth <= 64."""
    scene, _ = gpu_scene
    bvh = check_lbvh("gpu test", scene.mesh, seed=3)
    assert bvh.num_leaves == scene.mesh.num_faces


@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_packed_walk_bitwise(gpu_scene, bvh_waves, bounce):
    from raypt_torch.accel.packed import traverse_wavefront
    from raypt_torch.kernels import packed_walk as tpw
    scene, _ = gpu_scene
    pb, waves = bvh_waves
    o, d, t, a, _, _ = wavefront_inputs(scene, *waves[bounce], 1)
    kt, kf = tpw.packed_walk(pb, o, d, t, a)
    pt, pf = traverse_wavefront(pb, o, d, t, a)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert int((kf >= 0).sum()) > 0


@pytest.mark.parametrize("max_iters", [0, 3, 17])
def test_packed_walk_max_iters(gpu_scene, bvh_waves, max_iters):
    """A step cap of max_iters * unroll steps (unroll 1), which the kernel
    counts down a ray at a time, cuts each walk after the same steps as
    the plain walk's, on every bounce of the 256^2 bvh render, bitwise."""
    from raypt_torch.accel.packed import traverse_wavefront
    from raypt_torch.kernels import packed_walk as tpw
    scene, _ = gpu_scene
    pb, waves = bvh_waves
    for wave in waves:
        o, d, t, a, _, _ = wavefront_inputs(scene, *wave, 1)
        kt, kf = tpw.packed_walk(pb, o, d, t, a, max_iters, 1)
        pt, pf = traverse_wavefront(pb, o, d, t, a, max_iters, 1)
        assert _bits_equal(kt, pt) and torch.equal(kf, pf)
        assert max_iters > 0 or (_bits_equal(kt, t) and bool((kf == -1).all()))


def test_packed_walk_edges(gpu_scene, bvh_waves):
    """chip_smoke.walk_edges: dead, missing, near-seeded, signed-zero,
    NaN and in-plane rays, duplicated triangles and a table whose every
    row is walked, each bitwise against the plain walk."""
    scene, _ = gpu_scene
    pb, waves = bvh_waves
    walk_edges(Stats(), scene, pb, waves[0], waves[1])


def test_packed_walk_checks(bvh_waves):
    """The wrapper refuses a table that is not (N, 16) and rays of the
    wrong shape or type."""
    from raypt_torch.accel.packed import PackedLBVH
    from raypt_torch.kernels import packed_walk as tpw
    pb, _ = bvh_waves
    o = torch.zeros((256, 3), device="cuda")
    t = torch.full((256,), BIG, device="cuda")
    a = torch.ones(256, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        tpw.packed_walk(PackedLBVH(rows=pb.rows[:, :15].contiguous()), o, o,
                        t, a)
    with pytest.raises(ValueError):
        tpw.packed_walk(pb, o[:, :2].contiguous(), o, t, a)
    with pytest.raises(ValueError):
        tpw.packed_walk(pb, o, o, t, a.int())


@pytest.mark.parametrize("design", ["pr12", "octsort_t128"])
def test_packed_walk_designs_bitwise(gpu_scene, bvh_waves, design):
    """The first kernel (pr12) and the package kernel's design, as the sweep
    builds them from csrc/packed_walk_designs.cu, against the plain walk
    on every bounce of the 256^2 bvh render, bitwise."""
    from raypt_torch.accel.packed import traverse_wavefront
    from raypt_torch.kernels import sweep
    scene, _ = gpu_scene
    pb, waves = bvh_waves
    path, entry, sig = sweep.build_variants(["packed"], None)[("packed",
                                                                design)]
    fn = sweep._loaded(sig, path, entry)
    for wave in waves:
        o, d, t, a, _, _ = wavefront_inputs(scene, *wave, 1)
        kt, kf = sweep.CALLS[sig](fn, pb.rows, o, d, t, a)
        pt, pf = traverse_wavefront(pb, o, d, t, a)
        assert _bits_equal(kt, pt) and torch.equal(kf, pf)
        assert int((kf >= 0).sum()) > 0


def test_fit_step_kernel_vs_plain_bitwise():
    """One step of BASELINE config #5's fit (chip_smoke.fit_run: a refit
    every step, the Laplacian prior, lattice 10, render_rgbd) on a
    smaller stand-in (_icosphere(4), 32^2, 2 views): through the packed
    walk's kernel and through the plain walk, the loss and every
    parameter after the step bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = config5_case("cuda", subdiv=4, width=32, views=2)
    same_fit("the plain walk", fit_run(case, 1), fit_run(case, 1, ops=PLAIN),
             1)


@pytest.fixture(scope="module")
def wide_waves(gpu_scene):
    """The bench scene's LBVH built on the card, its wide tree collapsed
    on the card, and the wavefronts of a 256^2 bvh4 render through it."""
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.wide import collapse
    scene, _ = gpu_scene
    m = scene.mesh
    bvh = lbvh.build(m.positions, m.faces, m.face_valid)
    w = collapse(bvh, m.positions, m.faces, m.face_valid)
    return bvh, w, _waves(scene, CFG.replace(backend="bvh4"), w, 4)


def _wide_bitwise(w, o, d, t, a, stack_d):
    """wide_walk against traverse_wide, bitwise: the overflow flags."""
    from raypt_torch.accel.wide import traverse_wide
    from raypt_torch.kernels import wide_walk as tww
    kt, kf, ko = tww.wide_walk(w, o, d, t, a, stack_d)
    pt, pf, po = traverse_wide(w, o, d, t, a, stack_d)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert torch.equal(ko, po)
    return kf, ko


@pytest.mark.parametrize("stack_d", [64, 4, 2, 1, 31, 32, 33, 256])
def test_wide_walk_bitwise(gpu_scene, wide_waves, stack_d):
    """wide_walk against traverse_wide, bitwise (t, face, overflow), on
    every bounce of the 256^2 bvh4 render (at stacks of 4 and less rays
    overflow, at 64 and more none) and on deep_stack_case's wavefront,
    whose stacks reach 48 entries (rays overflow below 48, so at 31,
    32 and 33 a ray's deep slots are written and read back), with the
    retry at 4x the stack of the rays that overflowed, as
    find_closest_wide makes it."""
    scene, _ = gpu_scene
    _, w, waves = wide_waves
    overflowed = 0
    for wave in waves:
        o, d, t, a, _, _ = wavefront_inputs(scene, *wave, 1)
        kf, ko = _wide_bitwise(w, o, d, t, a, stack_d)
        assert int((kf >= 0).sum()) > 0
        overflowed += int(ko.sum())
    if stack_d <= 4 or stack_d >= 64:
        assert (overflowed > 0) == (stack_d <= 4)
    dw, do, dd, dt, da = deep_stack_case(device="cuda")
    kf, ko = _wide_bitwise(dw, do, dd, dt, da, stack_d)
    assert bool(ko.any()) == (stack_d < 3 * dw.nw_cap)
    if bool(ko.any()):
        _wide_bitwise(dw, do, dd, dt, da & ko, 4 * stack_d)


def test_wide_walk_edges(gpu_scene, wide_waves):
    """chip_smoke.wide_edges: dead, signed-zero and sub-clamp directions,
    origins in leaf boxes, NaN rays, stacks of 2 and 4, and a NaN vertex
    in the leaves and in the boxes, each bitwise against the plain
    walk."""
    scene, _ = gpu_scene
    bvh, w, waves = wide_waves
    wide_edges(Stats(), scene, bvh, w, waves[1])


def test_wide_walk_raises_not_falls_back(gpu_scene, wide_waves, monkeypatch):
    """On CUDA tensors the wrapper launches the kernel (its count rises)
    and never runs the plain walk; it refuses a table that is not
    (N, 64), rays of the wrong shape or type, a root outside the table
    and stacks outside 1 to 1,024."""
    import dataclasses
    from raypt_torch.kernels import wide_walk as tww
    scene, _ = gpu_scene
    _, w, waves = wide_waves
    o, d, t, a, _, _ = wavefront_inputs(scene, *waves[0], 1)

    def no_plain(*args, **kw):
        raise AssertionError("the plain walk ran on CUDA tensors")

    monkeypatch.setattr(tww, "traverse_wide", no_plain)
    before = tww.wide_walk.launches
    tww.wide_walk(w, o, d, t, a)
    assert tww.wide_walk.launches == before + 1
    for bad in (dict(rows=w.rows[:, :63].contiguous()), dict(root=-1),
                dict(root=w.num_rows)):
        with pytest.raises(ValueError):
            tww.wide_walk(dataclasses.replace(w, **bad), o, d, t, a)
    with pytest.raises(ValueError):
        tww.wide_walk(w, o[:, :2].contiguous(), d, t, a)
    with pytest.raises(ValueError):
        tww.wide_walk(w, o, d, t, a.int())
    for stack_d in (0, 1025):
        with pytest.raises(ValueError):
            tww.wide_walk(w, o, d, t, a, stack_d)


def test_wide_walk_counts_each_launch(gpu_scene, wide_waves):
    """The wrapper's launch count rises by exactly one a call, whichever
    compile-time stack the call takes (64, 256, 1,024 entries) and on
    the deep-stack wavefront, and not for an empty wavefront (no
    launch)."""
    from raypt_torch.kernels import wide_walk as tww
    scene, _ = gpu_scene
    _, w, waves = wide_waves
    o, d, t, a, _, _ = wavefront_inputs(scene, *waves[1], 1)
    deep = deep_stack_case(device="cuda")
    for args, stack_d in (((w, o, d, t, a), 64), ((w, o, d, t, a), 256),
                          ((w, o, d, t, a), 1024), (deep, 16), (deep, 64)):
        before = tww.wide_walk.launches
        tww.wide_walk(*args, stack_d)
        torch.cuda.synchronize()
        assert tww.wide_walk.launches == before + 1
    before = tww.wide_walk.launches
    out = tww.wide_walk(w, o[:0], d[:0], t[:0], a[:0])
    assert tww.wide_walk.launches == before and out[0].shape == (0,)


def test_bvh4_render_bitwise_vs_plain(gpu_scene, wide_waves):
    """The 256^2 bvh4 render through the kernel against the render
    through the plain walk, bitwise, with one launch a bounce."""
    from raypt_torch.kernels import wide_walk as tww
    scene, _ = gpu_scene
    _, w, _ = wide_waves
    cfg = CFG.replace(backend="bvh4")
    finder = make_finder(scene, cfg, w)
    before = tww.wide_walk.launches
    with torch.no_grad():
        img, traced = render_sample(scene, cfg, rng.key(4), finder,
                                    return_alive=True)
        plain, traced_p = render_sample(scene, cfg, rng.key(4),
                                        partial(finder, ops=PLAIN),
                                        return_alive=True)
    assert tww.wide_walk.launches == before + cfg.num_bounces
    assert _bits_equal(img, plain) and torch.equal(traced, traced_p)
    assert bool(torch.isfinite(img).all())


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank NCCL group on the card (chip_smoke.one_rank_group),
    destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import one_rank_group
    group = one_rank_group()
    yield group.__enter__()
    group.__exit__(None, None, None)


def test_sharded_render_one_rank_bitwise(gpu_scene, one_rank):
    """render_frame_sharded of the 256^2 bench scene through bvh (the
    card's LBVH, packed_walk) on a one-rank NCCL group: bitwise equal to
    render_frame with the same LBVH, one launch a bounce."""
    from raypt_torch.accel import lbvh
    from raypt_torch.dist import render_frame_sharded
    from raypt_torch.kernels import packed_walk as tpw
    from raypt_torch.render.integrator import render_frame
    scene, _ = gpu_scene
    m = scene.mesh
    tree = lbvh.build(m.positions, m.faces, m.face_valid)
    cfg = CFG.replace(backend="bvh")
    before = tpw.packed_walk.launches
    img = render_frame_sharded(scene, cfg, rng.key(6), one_rank, bvh=tree)
    assert tpw.packed_walk.launches == before + cfg.num_bounces
    with torch.no_grad():
        ref = render_frame(scene, cfg, rng.key(6), accel=tree)
    assert _bits_equal(img, ref) and bool(torch.isfinite(img).all())


def test_fit_step_sharded_one_rank_bitwise(one_rank):
    """One step of the config #5 stand-in (test_fit_step_kernel_vs_plain_
    bitwise's: _icosphere(4), 32^2, 2 views) through make_fit_step_sharded
    on a one-rank NCCL group's "views" mesh and through make_fit_step:
    the loss and every parameter after the step bitwise equal."""
    from raypt_torch.dist import default_mesh
    case = config5_case("cuda", subdiv=4, width=32, views=2)
    same_fit("the one-rank sharded step",
             fit_run(case, 1, mesh=default_mesh(axis="views")),
             fit_run(case, 1), 1)


@pytest.mark.parametrize("name", list(LAYOUT_FLAGS))
def test_layout_walk_bitwise(gpu_scene, bvh_waves, name):
    """Each kernel of csrc/packed_layouts.cu (the cherry, lookahead, quad
    and lookahead-quad walks) on its table of the card's LBVH, against
    its plain walk, bitwise: on every bounce of the 256^2 bvh render,
    on chip_smoke.layout_tie_case (whose ties keep their winners) and on
    the meshes of 1-5 triangles; compact_walk is one launch of the same
    kernel with the same result; another table type is a TypeError. Each
    kernel also against its plain models: the split table it builds
    (layout_table over a zeroed scratch) bitwise slot_table's (the
    lookahead tables' two sectors an internal row too), its results
    traverse_slots' on the same cases."""
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.packed import (slot_table, traverse_slots,
                                          traverse_wavefront_compact,
                                          walk_layout)
    from raypt_torch.kernels import packed_walk as tpw
    from raypt_torch.render.integrator import pack_layout
    scene, _ = gpu_scene
    pb, waves = bvh_waves
    m = scene.mesh
    cfg = CFG.replace(backend="bvh", **LAYOUT_FLAGS[name])
    table = pack_layout(cfg, lbvh.build(m.positions, m.faces, m.face_valid),
                        m.positions, m.faces, m.face_valid)
    wrapper = getattr(tpw, name)
    assert tpw.wrapper_of(table) is wrapper
    for got, want in zip(tpw.layout_table(table, fill=0.0),
                         slot_table(table)):
        assert _bits_equal(got, want)
    for wave in waves:
        args = (table, *wavefront_inputs(scene, *wave, 1)[:4])
        before = wrapper.launches
        kt, kf = wrapper(*args)
        assert wrapper.launches == before + 1
        pt, pf = walk_layout(*args)
        assert _bits_equal(kt, pt) and torch.equal(kf, pf)
        mt, mf = traverse_slots(*args)
        assert _bits_equal(kt, mt) and torch.equal(kf, mf)
        ct, cf = tpw.compact_walk(*args)
        assert wrapper.launches == before + 2
        assert _bits_equal(ct, kt) and torch.equal(cf, kf)
    pt, pf = traverse_wavefront_compact(*args)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    case = layout_tie_case("cuda")
    tie = pack_layout(cfg, lbvh.build(case["positions"], case["faces"],
                                      case["build_valid"]),
                      case["positions"], case["faces"], case["valid"])
    rays = tuple(case[k] for k in ("ro", "rd", "t0", "active"))
    kt, kf = wrapper(tie, *rays)
    pt, pf = walk_layout(tie, *rays)
    assert _bits_equal(kt, pt) and torch.equal(kf, pf)
    assert check_ties(case, kf, name) > 0
    mt, mf = traverse_slots(tie, *rays)
    assert _bits_equal(kt, mt) and torch.equal(kf, mf)
    for n, bvh, pos, faces, valid, *rays in small_meshes("cuda"):
        small = pack_layout(cfg, bvh, pos, faces, valid)
        kt, kf = wrapper(small, *rays)
        pt, pf = walk_layout(small, *rays)
        assert _bits_equal(kt, pt) and torch.equal(kf, pf), n
        mt, mf = traverse_slots(small, *rays)
        assert _bits_equal(kt, mt) and torch.equal(kf, mf), n
    with pytest.raises(TypeError):
        wrapper(pb, *args[1:])


@pytest.mark.parametrize("name", list(LAYOUT_FLAGS))
def test_layout_render_bitwise(gpu_scene, name):
    """The 256^2 bvh render with the layout's flags, the table packed in
    make_finder from an LBVH built there: one launch of the layout's
    kernel a bounce and none of packed_walk, in both traversal modes;
    the image bitwise the plain walk's render's and the compact mode's."""
    from raypt_torch.kernels import packed_walk as tpw
    scene, _ = gpu_scene
    wrapper = getattr(tpw, name)
    images = []
    for mode in ("tiled", "compact"):
        cfg = CFG.replace(backend="bvh", traversal_mode=mode,
                          **LAYOUT_FLAGS[name])
        finder = make_finder(scene, cfg)
        before, one = wrapper.launches, tpw.packed_walk.launches
        with torch.no_grad():
            img = render_sample(scene, cfg, rng.sample_key(rng.frame_key(
                rng.key(0), 0), 0), finder)
        assert wrapper.launches == before + cfg.num_bounces
        assert tpw.packed_walk.launches == one
        with torch.no_grad():
            ref = render_sample(scene, cfg, rng.sample_key(rng.frame_key(
                rng.key(0), 0), 0), partial(finder, ops=PLAIN))
        assert _bits_equal(img, ref) and bool(torch.isfinite(img).all())
        images.append(img)
    assert _bits_equal(*images)
