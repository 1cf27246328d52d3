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
from raypt_torch.kernels import dense_pallas as tdp
from raypt_torch.kernels import onehot_walk as twk
from raypt_torch.render.integrator import make_finder, render_sample
from raypt_torch.rng import sampler as rng
from raypt_torch.scenes.builtin import stanford_bunny
from raypt_torch.scenes.config4 import config4_scene

from chip_smoke import (MERGE_LEAVES, WL_GROUPS, WOOP_ODD_LEAF, check_planted,
                        copy_most_hit, edge_seeds, merge_case, walk_layouts,
                        woop_faces, woop_merge, worklist_merge,
                        zero_maps_table)

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
    if path in ("pallas", "auto"):
        cfg = CFG.replace(backend=path)     # "auto" resolves to "dense"
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


def _expand_stages(scene, accels, leaf, bounce):
    """The expand path's four stages, each fed the kernel's outputs of
    the stage before it."""
    ro, rd, active = _waves(scene, CFG, accels[384], 1)[bounce]
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
    ("closest_dense", None, 0), ("closest_dense", None, 2),
    ("closest_dense_copies", None, 0), ("woop", None, 0), ("woop", None, 1),
    ("grouped", None, 1)])
def test_stages_bitwise(gpu_scene, stage, leaf, bounce):
    """Each kernel stage against its plain version on one bounce's
    wavefront of its render path: the expand path's four (leaf 384, and
    leaf 16 with 40 mask words), the non-fused path's mask-only walk
    (leaf 128: 5 words; leaf 16: 33, not a multiple of 8; also on a
    dead, a one-live and a last-warp-only block), the pallas
    path's closest_dense, also where copied triangles tie with their
    sources and the lowest id must win, the config-4 path's Woop
    intersection and the grouped worklist intersection on the cluster
    path's wavefront."""
    scene, accels = gpu_scene
    if stage == "expand":
        _expand_stages(scene, accels, leaf, bounce)
    elif stage.startswith("walk"):
        _walk_mask_stage(scene, accels, leaf, bounce, stage == "walk_edges")
    elif stage == "woop":
        _woop_stage(accels, bounce)
    elif stage == "grouped":
        _grouped_stage(scene, accels, bounce)
    else:
        _closest_dense_stage(scene, accels, stage.endswith("copies"), bounce)


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


@pytest.mark.parametrize("path", ["expand", "dense_union", "cluster",
                                  "pallas", "auto", "unfused", "config4"])
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
    if name == "diag":
        ro, rd, mask_cm, _ = expand_diag2.wavefront("cuda", 64)
        pay, otrue = expand_diag2.payload(ro, rd)
        return (expand_diag2.diag(mask_cm, pay, otrue, 2048),
                expand_diag2.diag_plain(mask_cm, pay, otrue, 2048))
    if name == "permute":
        x = rows(8, 8192, 8)
        chain, fixed = arg in ("chain", "chain_fixed"), arg.endswith("fixed")
        return (regroup.permute(x, 8, 8192, chain, fixed),
                regroup.permute_plain(x, 8, 8192, chain, fixed))
    if name == "sel":
        x = rows(24, 2048, 8).to(torch.bfloat16)
        return regroup.sel(x, 16, 2048), regroup.sel_plain(x, 16, 2048)
    if name == "cycle":
        x = rows(24, 8192, 8)
        return (regroup.cycle(x, 16, 8192, arg),
                regroup.cycle_plain(x, 16, 8192, arg))
    args = walk_spec_probe.wavefront("cuda", 256, int(arg))
    spec = walk_spec_probe.topwalk_spec(*args)
    return ((spec, spec), (twk.topwalk_cm(*args), twk.topwalk_cm_plain(*args)))


@pytest.mark.parametrize("probe", [
    "gather:fill", "gather:clip", "gather:oob", "stages", "diag", "permute:sum",
    "permute:sum_fixed", "permute:chain", "permute:chain_fixed", "sel",
    "cycle:full", "cycle:no_mm", "cycle:fixed_s", "walk_spec:512",
    "walk_spec:16"])
def test_probe_kernels_bitwise(probe):
    """Each kernel of raypt_torch/probes/ (the scripts/ probes) against its
    plain version; the speculative walk also against topwalk_cm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got, want = _probe_case(probe)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    assert any(bool(a.any()) for a in got) or probe == "sel"
