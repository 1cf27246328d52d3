#!/usr/bin/env python3
"""Drive raypt_torch's render paths once on one NVIDIA GPU and
check them, phase by phase; any failure raises and the exit code is not
0. Six paths render the bench scene (stanford_bunny at 1024^2, 1 spp, 4
bounces, roulette) through:

  expand       backend "onehot", leaf 384, expand 8192, compact 32768
               (bench.py's finder): alive_compact, topwalk_cm_u,
               cluster_expand, alive_uncompact
  dense_union  backend "onehot" at the JAX package's defaults (leaf 128,
               expand 0, compact 0): topwalk_union, cluster_intersect_mask
  cluster      backend "cluster", clusters of 64 triangles:
               cluster_intersect
  pallas       backend "pallas" (the Woop table built from the scene):
               closest_dense, every ray against every triangle
  unfused      the onehot finder's non-fused branch at leaf 128
               (find_closest_onehot(..., use_pallas_intersect=False)):
               topwalk_cm, then tile unions, ascending-id worklists and
               the reference worklist intersection in torch
  auto         RenderConfig's default backend, which resolves to "dense"
               for this mesh; the port serves "dense" with the pallas
               path's finder: closest_dense

and a seventh renders the config-4 scene (scripts/baseline_config4.py:
config4_scene at 1024^2, 8 bounces, roulette, refraction, key 7):

  config4      backend "onehot" with build_onehot(build_sah(mesh),
               leaf=128, with_woop=True), the finder's Woop branch:
               topwalk_cm (then a transpose and the tile unions in
               torch), cluster_intersect_mask_woop

cluster_intersect_grouped lies on no path, as in the JAX package: phase 3
holds it on the cluster path's wavefronts against its plain version and
against cluster_intersect.

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions
  2. build the native SAH builder and the CUDA kernels from source (one
     nvcc per source, all started together)
  3. each kernel against its plain torch version on the card, bitwise,
     on the wavefronts of all four bounces of its path, with CUDA-event
     times (kernel mean of 10, plain of 2, summed over the bounces) and
     the bound of each launch; then edge cases: all-dead and all-alive
     compaction groups, a tile of dead rays, the leaf-16 accel (1,026
     clusters: 40 mask words, 33 union words) on 65,536 rays, the
     cluster finder at cap 8, where tiles overflow into its fallback
     (whose worklist intersection is also timed, with its peak memory,
     at 2^22 and at STEP_PAIRS pairs a step), a tile of rays that hit
     nothing, duplicated triangles tying within a triangle chunk and
     across chunks, tables of one chunk exactly and of a size that
     needs padding, and zero maps among the real triangles (tables of
     256 slots and of all the scene's, rays of one tile and of a whole
     wavefront, seeds -BIG, nan and below every hit: zero_maps_table,
     edge_seeds). Per bounce the log gives the share of tests the
     kernels skip: closest_dense's on zero-ww triangles, the worklist
     kernel's on dead rays. On the config-4 path: the mask-only walk and
     cluster_intersect_mask_woop on all eight bounces, both timed (the
     Woop kernel with matmul_woop, the same closest hit through torch.bmm,
     as its library yardstick, and the Moller-Trumbore
     cluster_intersect_mask on the same unions and clusters; the live rays
     a tile and the share of tests the dead rays would take); then a union
     with stray bits >= C, triangles
     turned into the miss encoding (a zero-area triangle's rows), rays
     parallel to a triangle's plane (d'_w = +-0), copies of triangles in
     a higher free lane of their cluster (the lowest lane wins) and in a
     later cluster (the strict merge keeps the first), a tile of dead
     rays, and a mixed, a one-live and a last-warp-only tile.
     cluster_intersect_grouped for G = 2, 3, 4 at cap GROUP_CAP on
     the cluster path's four wavefronts (G = 4 timed), and on worklists
     whose counts were cut below the list (valid ids past counts, tested
     within the last group: only the plain version must match).
     cluster_expand, cluster_intersect_mask and, on the clusters' Woop
     table, cluster_intersect_mask_woop on merge_case's synthetic
     clusters at leaves MERGE_LEAVES (the Woop kernel also at
     WOOP_ODD_LEAF, which no 4 divides; ties across and within clusters, a
     cluster one ray of a block wants, dead, mixed and one-live tiles,
     stray bits, triangles whose det reaches 2^126), and
     cluster_intersect and cluster_intersect_grouped (G in WL_GROUPS) on
     the same clusters as worklists (worklist_merge: lists in descending
     and ascending id, counts at, above and below their lengths, with the
     stray bits also ids outside [0, C) and counts above cap), the
     mask-only walk on a dead, a one-live and a last-warp-only block
     (walk_layouts) at leaves 128 and 16, and the kernels' 1 / det (the
     correctly rounded reciprocal) against the
     division over all 2^32 bit patterns (inv_det_sweep). The SM clock is
     sampled (nvidia-smi) while each path's kernels are timed; phase 2
     reads the instructions a triangle test takes in each intersection
     kernel's inner loop (the union template's three instances, the
     expansion, closest_dense), and a walk step in the mask-only walk's,
     from cuobjdump -sass of the built library
  4. each path's render through render_sample: every kernel of the path
     launches once per bounce and no other kernel launches, the image is
     finite and bitwise equal to the render through the plain versions
     (on the auto path, to the pallas render), with equal traced counts
  5. cross-checks on the card: bitwise, the union walk against the tile
     fold of topwalk_cm_u's masks, the dense mask intersection of those
     unions against cluster_expand of the masks on live rays, the
     dense-union render at leaf 384 against the expand render, and the
     mask-only walk against topwalk_cm_u's first words; the Woop finder
     against the Moller-Trumbore dense-union finder on the same leaf-128
     clusters, on config4's wavefronts (same hits, t within WOOP_T_RTOL /
     WOOP_T_ATOL, faces apart only at near-ties, on all but DENSE_SHARE
     of the rays, each disagreeing ray tested in float64); closest_dense
     against the torch.matmul route (matmul_closest) to DENSE_T_TOL on
     all but DENSE_SHARE of the rays, the rays where they disagree held
     against a float64 test of both faces; the non-fused finder at cap
     2, whose
     tiles overflow into residual rounds, against its kernel-free and
     default-cap results
  6. the bench loss (mean image) forward and backward w.r.t. mesh
     positions and material albedo on every path but auto (the pallas
     path's finder) and unfused (forward only there): finite grads, nonzero albedo grad, median
     seconds of 3 runs after a warm-up, and one fwd+bwd step traced with
     torch.profiler. The bench camera sits inside the stand-in bunny,
     where no path reaches the sky, so the gradient w.r.t. positions is
     about 0 there; for the expand and pallas paths, from a view outside
     the mesh (GRAD_VIEW, GRAD_WIDTH^2) it is not, and the card's
     gradients through the kernels must agree with the CPU's through the
     plain versions to GRAD_RTOL of their largest magnitude. On the
     config-4 path also the forward frame at C4_SPP samples (median of 3
     after a warm-up) with its segment rates, and the card-vs-CPU
     gradient check from the scene's own view, through textures and glass
  7. the scripts/ probes (raypt_torch/probes/, on no path): each probe
     kernel against its plain version, bitwise, at its script's default
     sizes, with CUDA-event times (kernel mean of 10, plain of 2) for
     every mode and cycle count the script runs; the speculative walk
     also against topwalk_cm (timed beside it), the gathers beside
     torch.index_select (their library_ms), and the expansion
     diagnostics' v1/v2/v3 maxima and rays whose cluster count is not
     their mask's popcount (which fails the phase)

The last line is {"ok": true, "device": {...}}; the line before it is
the per-kernel JSON summary: "ms", "plain_ms" and "bound_ms" are summed
over the bounce wavefronts of the kernel's paths (one frame's worth of
launches of each: four, eight on config4; topwalk_cm's over the unfused
path's four and config4's eight, which the log also gives apart; the
grouped kernel's on the cluster path's four), "launches" are counted in
those paths' renders of phase 4 (0 for cluster_intersect_grouped, which
no path runs); closest_dense's
"library_ms" is matmul_closest, the same closest hit through
torch.matmul, and cluster_intersect_mask_woop's is matmul_woop, through
torch.bmm, on the same wavefronts (several calls each: no one torch
call computes either). A probe's "ms", "plain_ms", "bound_ms" and
"library_ms" are summed over the modes and cycle counts of phase 7, its
"launches" are 0 (no render path runs it). Times are given to six
significant digits.
Run: python3 chip_smoke.py
"""
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

WIDTH = HEIGHT = 1024
BOUNCES = 4
LEAF = 384
EXPAND_N = 8192
COMPACT_N = 32768
DENSE_LEAF = 128          # RenderConfig's default onehot_leaf
MULTIWORD_LEAF = 16
MULTIWORD_RAYS = 65536
OVERFLOW_CAP = 8
UNFUSED_CAP = 2           # the non-fused finder's forced residual rounds
# closest_dense vs matmul_closest: a ray agrees when both pick the same
# face and their t are within DENSE_T_TOL * (1 + |t|)
# (tests/test_pallas.py's tolerance against the brute-force oracle;
# cuBLAS sums the products in its own order). Near-grazing rays, where
# t = -o'_w / d'_w divides by a small d'_w, and near-ties may disagree:
# at most DENSE_SHARE of a wavefront's rays, and phase 5 holds each such
# ray against a float64 test of both faces.
DENSE_T_TOL = 2e-4
DENSE_SHARE = 1e-4
GRAD_VIEW = dict(position=(30.0, -18.0, -200.0), angle_y=180.0)
GRAD_WIDTH = 128
GRAD_RTOL = 1e-3

# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores. The f32
# peak counts a fused multiply-add as two operations; the kernels are
# built with -fmad=false and issue none, so their own ceiling is half
# of it and an operations bound below is a floor they cannot reach.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of one walk step (12 slab sub/mul, 10 min/max, 8
# compares, 15 for the three link/id decodes) and of one ray-triangle
# Moller-Trumbore test with its merge (cluster_test.cuh: 50 arithmetic,
# 7 compares and selects). Only live rays need tests: a dead ray is
# seeded -BIG, so no hit can replace its result. The mask-only walk
# (mask_walk.cuh) decodes each row once a block that has a live ray, so
# its steps take WALK_OPS - ROW_DECODE_OPS each and its rows
# ROW_DECODE_OPS once a busy block.
WALK_OPS = 45
ROW_DECODE_OPS = 15
WALK_BLOCK = 256   # rays a block of the walk kernels (onehot_walk.cu kThreads)
MT_OPS = 57
# f32 operations of one Woop ray-triangle test (dense_closest.cu): six
# 3-term transforms (3 with an offset: 18 mul/add, 15 without), |d'_w|
# and its compare (2), the negation and the division (2), u and v (4),
# u + v (1), five compares (u, v, u + v, t > 0, t < best) and the
# select of the carry (2)
DENSE_OPS = 49
# f32 operations of one Woop ray-triangle test of a cluster
# (cluster_intersect.cu: test_cluster_woop): six 4-term sums (42 mul/add),
# the negation and the division (2), u and v (4), u + v (1), four
# compares (4), the miss select (1), the compare with the cluster's best
# and its two selects (3)
WOOP_OPS = 57
# f32 operations per ray-cluster round trip of the expansion diagnostics
# (csrc/expand_diag.cu): the slot's two 3-term sums of 3 rows (12) and
# their split (2 subtractions x 6), the ray's rebuilt 6 rows (12), their
# errors (6 subtractions, 6 abs), the row maxima and the two into v2/v3
# (6), and the v1 check (sub, abs, max: 3)
DIAG_OPS = 57

# the config-4 path (scripts/baseline_config4.py)
C4_BOUNCES = 8
C4_LEAF = 128
C4_SPP = 4
C4_KEY = 7
# the Woop finder vs the Moller-Trumbore dense-union finder: a ray agrees
# when both hit or both miss, t within WOOP_T_RTOL / WOOP_T_ATOL
# (tests/test_onehot.py:270-274) and the faces are equal or their t a
# near-tie; at most DENSE_SHARE of a wavefront may disagree, each such ray
# held against float64 tests of both faces
WOOP_T_RTOL, WOOP_T_ATOL = 1e-3, 1e-4
# the grouped kernel's check: worklists GROUP_CAP wide, which no G divides
GROUPS = (2, 3, 4)
GROUP_CAP = 61
COPIES = 16              # triangles copied for the Woop kernel's tie checks
# the merge-rule cases (merge_case): clusters, rays, planted ties of each
# kind, and the leaves the card checks them at
MERGE_C = 40
MERGE_RAYS = 4096
MERGE_PLANTS = 8
MERGE_LEAVES = (16, 64, 128, 384)
# and a leaf no 4 divides, where the Woop kernel loads a lane at a time
# (WoopTest<1> of csrc/cluster_intersect.cu), checked for it alone
WOOP_ODD_LEAF = 18
# slots of a merge case's worklists past the longest list
# (worklist_merge), and the groups the grouped kernel is held at there
WL_PAD = 3
WL_GROUPS = (2, 3)

KERNELS = {   # name -> (paths that launch it, source, TPU kernel it replaces)
    "alive_compact": (("expand",), "raypt_torch/csrc/compact.cu",
                      "raypt/kernels/compact.py:180"),
    "topwalk_cm_u": (("expand",), "raypt_torch/csrc/onehot_walk.cu",
                     "raypt/kernels/onehot_walk.py:252"),
    "cluster_expand": (("expand",), "raypt_torch/csrc/cluster_expand.cu",
                       "raypt/kernels/cluster_expand.py:246"),
    "alive_uncompact": (("expand",), "raypt_torch/csrc/compact.cu",
                        "raypt/kernels/compact.py:218"),
    "topwalk_union": (("dense_union",), "raypt_torch/csrc/onehot_walk.cu",
                      "raypt/kernels/onehot_walk.py:325"),
    "cluster_intersect_mask": (("dense_union",),
                               "raypt_torch/csrc/cluster_intersect.cu",
                               "raypt/kernels/cluster_pallas.py:331"),
    "cluster_intersect": (("cluster",),
                          "raypt_torch/csrc/cluster_intersect.cu",
                          "raypt/kernels/cluster_pallas.py:104"),
    "closest_dense": (("pallas",), "raypt_torch/csrc/dense_closest.cu",
                      "raypt/kernels/dense_pallas.py:84"),
    # with a transpose after it, also pallas_topwalk (onehot_walk.py:169);
    # its row's times and launches are the unfused path's and config4's
    "topwalk_cm": (("unfused", "config4"), "raypt_torch/csrc/onehot_walk.cu",
                   "raypt/kernels/onehot_walk.py:190"),
    "cluster_intersect_mask_woop": (("config4",),
                                    "raypt_torch/csrc/cluster_intersect.cu",
                                    "raypt/kernels/cluster_pallas.py:486"),
    "cluster_intersect_grouped": ((), "raypt_torch/csrc/cluster_intersect.cu",
                                  "raypt/kernels/cluster_pallas.py:183"),
    # the scripts/ probes (raypt_torch/probes/), on no path: phase 7
    "walk_spec": ((), "raypt_torch/csrc/onehot_walk.cu",
                  "scripts/tpu_walk_spec_probe.py:146"),
    "permute_probe": ((), "raypt_torch/csrc/regroup.cu",
                      "scripts/tpu_permute_probe.py:73"),
    "permute_probe2": ((), "raypt_torch/csrc/regroup.cu",
                       "scripts/tpu_permute_probe2.py:71"),
    "sel_probe": ((), "raypt_torch/csrc/regroup.cu",
                  "scripts/tpu_sel_probe.py:71"),
    "cycle_budget": ((), "raypt_torch/csrc/regroup.cu",
                     "scripts/tpu_cycle_budget.py:72"),
    "expand_debug_stage12": ((), "raypt_torch/csrc/expand_diag.cu",
                             "scripts/tpu_expand_debug.py:44"),
    "expand_debug_stage34": ((), "raypt_torch/csrc/expand_diag.cu",
                             "scripts/tpu_expand_debug.py:95"),
    "expand_debug_stage5": ((), "raypt_torch/csrc/expand_diag.cu",
                            "scripts/tpu_expand_debug.py:151"),
    "expand_diag2": ((), "raypt_torch/csrc/expand_diag.cu",
                     "scripts/tpu_expand_diag2.py:172"),
    "pallas_gather_test": ((), "raypt_torch/csrc/gather.cu",
                           "scripts/pallas_gather_test.py:17"),
    "pallas_gather_test2": ((), "raypt_torch/csrc/gather.cu",
                            "scripts/pallas_gather_test2.py:14"),
}
KERNEL_PATHS = ("expand", "dense_union", "cluster", "pallas", "unfused")
# paths that run another path's finder, and so its kernels
SAME_FINDER = {"auto": "pallas"}


def log(*a):
    print(*a, flush=True)


def bitwise_equal(a, b, where=None):
    """Equal bit patterns (floats compared as int32), optionally only
    where `where` is True; returns (equal, max_abs_err)."""
    import torch
    if where is not None:
        a, b = a[where], b[where]
    if a.dtype == torch.float32:
        eq = torch.equal(a.view(torch.int32), b.view(torch.int32))
    else:
        eq = torch.equal(a, b)
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    return eq, err


def cuda_ms(fn, reps):
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def popcounts(x):
    """Set bits of each element of an int32 tensor, as int64."""
    import torch
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(x) -> int:
    """Set bits of an int32 tensor."""
    return int(popcounts(x).sum())


def live_tests(alive, clusters_per_tile, tile) -> int:
    """Ray-cluster tests a tile kernel needs: the live rays of each tile
    times the clusters it tests for that tile."""
    live = alive.view(-1, tile).sum(dim=1)
    return int((live * clusters_per_tile.to(live.dtype)).sum())


def sig6(x: float) -> float:
    """x to six significant digits (the probes' bounds are microseconds)."""
    return float(f"{x:.6g}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Stats:
    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {k: 0.0 for k in KERNELS}
        self.plain_ms = {k: 0.0 for k in KERNELS}
        self.bound_ms = {k: 0.0 for k in KERNELS}
        self.library_ms = {k: None for k in KERNELS}
        # topwalk_cm and its transpose, per frame of each path
        self.topwalk_ms = {}
        self.bound_parts = {k: {"bytes": 0.0, "operations": 0.0}
                            for k in KERNELS}
        # the path whose wavefronts are being timed, and each kernel's
        # (ms, plain_ms, bound_ms, launches timed) per path
        self.path = None
        self.by_path = {}

    def check(self, name, what, a, b, where=None):
        eq, err = bitwise_equal(a, b, where)
        self.err[name] = max(self.err[name], err)
        if not eq:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"on {what} (max abs err {err})")

    def time(self, name, label, kernel, plain, args, moved, ops):
        """CUDA-event times of one launch of the kernel and of its plain
        version on args, and the launch's bound: the larger of `moved`
        bytes over the HBM rate and `ops` f32 operations over the peak."""
        k_ms = cuda_ms(lambda: kernel(*args), 10)
        p_ms = cuda_ms(lambda: plain(*args), 2)
        by_bytes = 1e3 * moved / HBM_BYTES_PER_S
        by_ops = 1e3 * ops / F32_OPS_PER_S
        self.ms[name] += k_ms
        self.plain_ms[name] += p_ms
        self.bound_ms[name] += max(by_bytes, by_ops)
        self.bound_parts[name]["bytes"] += by_bytes
        self.bound_parts[name]["operations"] += by_ops
        part = self.by_path.setdefault((name, self.path), [0.0, 0.0, 0.0, 0])
        for k, x in enumerate((k_ms, p_ms, max(by_bytes, by_ops), 1)):
            part[k] += x
        log(f"  {label:9s} {name:22s} kernel {k_ms:9.4f} ms   plain "
            f"{p_ms:9.3f} ms   bound {max(by_bytes, by_ops):.4g} ms")

    def time_library(self, name, label, fn, reps=2):
        """CUDA-event time of the torch yardstick of one launch."""
        ms = cuda_ms(fn, reps)
        self.library_ms[name] = (self.library_ms[name] or 0.0) + ms
        log(f"  {label:9s} {name:22s} library {ms:9.3f} ms")

    def bound_by(self, name):
        parts = self.bound_parts[name]
        return max(parts, key=parts.get)


def walk_visits(table, ro, rd, t0, active, num_words) -> int:
    """Node visits of the walk on these rays (the plain walk's count)."""
    from raypt_torch.accel.ctree import walk_topwalk
    visits = []
    walk_topwalk(table, ro, rd, t0, active, num_words, visits)
    return sum(visits)


def compare_expand(stats, label, scene, accel, ro, rd, active, timed):
    """Run the expand path's four stages on one wavefront with the
    kernels and with the plain versions, feeding both the kernel's
    outputs of the previous stage; every output must agree bitwise."""
    import torch
    from raypt_torch.accel.traverse import onehot_inputs
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_expand as ex
    from raypt_torch.kernels import compact as cp
    from raypt_torch.kernels import onehot_walk as wk

    o, d, t, a, _, _ = onehot_inputs(scene, ro, rd, active, COMPACT_N)
    args = (o, d, t, a, COMPACT_N)
    kc = cp.alive_compact(*args)
    pc = cp.alive_compact_plain(*args)
    stats.check("alive_compact", f"{label} alive", kc[3], pc[3])
    for name, x, y in zip(("ro", "rd", "t0"), kc[:3], pc[:3]):
        stats.check("alive_compact", f"{label} live {name}", x, y, where=pc[3])

    cwp = -(-accel.num_clusters // 256) * 8
    wargs = (accel.table, *kc, cwp)
    km, ku = wk.topwalk_cm_u(*wargs)
    pm, pu = wk.topwalk_cm_u_plain(*wargs)
    stats.check("topwalk_cm_u", f"{label} mask", km, pm)
    stats.check("topwalk_cm_u", f"{label} union_pp", ku, pu)

    seed = torch.where(kc[3], kc[2], torch.full_like(kc[2], -BIG))
    rows = accel.clusters.tri_rows
    eargs = (km, ku, rows, kc[0], kc[1], seed)
    kt, kf = ex.cluster_expand(*eargs)
    pt, pf = ex.cluster_expand_plain(*eargs)
    stats.check("cluster_expand", f"{label} t", kt, pt)
    stats.check("cluster_expand", f"{label} face", kf, pf)

    uargs = (kt, kf, a, COMPACT_N)
    kut, kuf = cp.alive_uncompact(*uargs)
    put, puf = cp.alive_uncompact_plain(*uargs)
    stats.check("alive_uncompact", f"{label} live t", kut, put, where=a)
    stats.check("alive_uncompact", f"{label} live face", kuf, puf, where=a)

    if timed:
        r = o.shape[0]
        leaf = rows.shape[1]
        visits = walk_visits(accel.table, *kc, cwp)
        stats.time("alive_compact", label, cp.alive_compact,
                   cp.alive_compact_plain, args, 2 * nbytes(o, d, t, a), 0)
        stats.time("topwalk_cm_u", label, wk.topwalk_cm_u,
                   wk.topwalk_cm_u_plain, wargs,
                   nbytes(accel.table, *kc[:4], km, ku), WALK_OPS * visits)
        stats.time("cluster_expand", label, ex.cluster_expand,
                   ex.cluster_expand_plain, eargs,
                   nbytes(km, ku, rows, kc[0], kc[1], seed, kt, kf),
                   MT_OPS * leaf * popcount(km))
        stats.time("alive_uncompact", label, cp.alive_uncompact,
                   cp.alive_uncompact_plain, uargs,
                   nbytes(kt, kf, a, kut, kuf), 0)
        log(f"  {label:9s} walk visits {visits}, wanted clusters per live "
            f"ray {popcount(km) / max(int(a.sum()), 1):.2f} (R = {r})")


def compare_dense_union(stats, label, scene, accel, ro, rd, active, timed):
    """The dense-union path's two stages on one wavefront, kernels
    against plain versions, the intersection fed the kernel's unions."""
    import torch
    from raypt_torch.accel.traverse import DENSE_CHUNK, wavefront_inputs
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_pallas as dn
    from raypt_torch.kernels import onehot_walk as wk

    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    nw = -(-accel.num_clusters // 32)
    wargs = (accel.table, o, d, t, a, nw)
    ku = wk.topwalk_union(*wargs)
    stats.check("topwalk_union", f"{label} union", ku,
                wk.topwalk_union_plain(*wargs))
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    rows = accel.clusters.tri_rows
    iargs = (ku, rows, o, d, seed)
    kt, kf = dn.cluster_intersect_mask(*iargs)
    pt, pf = dn.cluster_intersect_mask_plain(*iargs)
    stats.check("cluster_intersect_mask", f"{label} t", kt, pt)
    stats.check("cluster_intersect_mask", f"{label} face", kf, pf)
    if timed:
        leaf = rows.shape[1]
        visits = walk_visits(*wargs)
        stats.time("topwalk_union", label, wk.topwalk_union,
                   wk.topwalk_union_plain, wargs,
                   nbytes(accel.table, o, d, t, a, ku), WALK_OPS * visits)
        tests = live_tests(a, popcounts(ku).sum(dim=1), dn.TILE)
        stats.time("cluster_intersect_mask", label, dn.cluster_intersect_mask,
                   dn.cluster_intersect_mask_plain, iargs,
                   nbytes(ku, rows, o, d, seed, kt, kf),
                   MT_OPS * leaf * tests)
        log(f"  {label:9s} walk visits {visits}, union clusters per tile "
            f"{popcount(ku) / ku.shape[0]:.2f}, live ray-cluster tests "
            f"{tests} ({tests / max(dn.TILE * popcount(ku), 1):.4f} of all)")
    return ku


def compare_cluster(stats, label, scene, clusters, ro, rd, active, timed):
    """The cluster path's worklist intersection on one wavefront, kernel
    against plain version, on the cull's worklists."""
    import torch
    from raypt_torch.accel.clusters import WORKLIST_CAP, tile_worklists
    from raypt_torch.accel.traverse import DENSE_CHUNK, wavefront_inputs
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_pallas as dn

    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    wl, cnt, _ = tile_worklists(clusters, o, d, seed, dn.TILE, WORKLIST_CAP)
    rows = clusters.tri_rows
    iargs = (wl, cnt, rows, o, d, seed)
    kt, kf = dn.cluster_intersect(*iargs)
    pt, pf = dn.cluster_intersect_plain(*iargs)
    stats.check("cluster_intersect", f"{label} t", kt, pt)
    stats.check("cluster_intersect", f"{label} face", kf, pf)
    if timed:
        tests = live_tests(a, cnt, dn.TILE)
        stats.time("cluster_intersect", label, dn.cluster_intersect,
                   dn.cluster_intersect_plain, iargs,
                   nbytes(wl, cnt, rows, o, d, seed, kt, kf),
                   MT_OPS * rows.shape[1] * tests)
        every = dn.TILE * int(cnt.clamp(max=wl.shape[1]).sum())
        log(f"  {label:9s} worklist clusters per tile "
            f"{float(cnt.float().mean()):.2f}, max {int(cnt.max())}, live "
            f"ray-cluster tests {tests} ({tests / max(every, 1):.4f} of "
            f"all); dead rays' tests skipped: {every - tests} "
            f"({(every - tests) / max(every, 1):.4f} of all)")


def live_tris(mats) -> int:
    """Triangles of a Woop table whose map is not all zero: the only ones
    that can hit (padding and degenerate faces have zero maps)."""
    return int(((mats[0] != 0) | (mats[1] != 0) | (mats[2] != 0)).any(dim=0)
               .sum())


def zero_ww(mats) -> int:
    """Triangles of a Woop table whose ww row is all zero (either sign):
    no ray can hit one (d'_w is +-0 or nan), so closest_dense never
    tests them."""
    return int((mats[2] == 0).all(dim=0).sum())


def matmul_closest(woop, ro, rd, t0, rows=8192, tri_chunk=2048):
    """closest_dense's result through torch.matmul, the yardstick of its
    library_ms: both transforms of a block of rows rays by tri_chunk
    triangles as two products, then elementwise tests and a
    min-reduction; the lowest id wins a tie, as in the kernel. Needs
    float32 products (no TF32, which gets u, v and t wrong)."""
    import torch
    from raypt_torch.core.math3d import BIG
    assert not torch.backends.cuda.matmul.allow_tf32
    tcount = woop.num_tris
    # (3, 3T) with [j, 3t + i] = M[t, i, j]: (rays @ w)[r, 3t + i] = (M ray)_i
    w = woop.m.permute(2, 0, 1).reshape(3, tcount * 3)
    cflat = woop.c.reshape(tcount * 3)
    tb = t0.clone()
    fb = torch.full(t0.shape, -1, dtype=torch.int32, device=t0.device)
    for r0 in range(0, ro.shape[0], rows):
        o, d = ro[r0:r0 + rows], rd[r0:r0 + rows]
        cur = slice(r0, r0 + o.shape[0])
        for c0 in range(0, tcount, tri_chunk):
            n = min(tri_chunk, tcount - c0)
            cols = slice(3 * c0, 3 * (c0 + n))
            o_p = (o @ w[:, cols] + cflat[cols]).view(-1, n, 3)
            d_p = (d @ w[:, cols]).view(-1, n, 3)
            dz = d_p[..., 2]
            ok = torch.abs(dz) > 1e-12
            t = torch.where(ok, -o_p[..., 2] / torch.where(
                ok, dz, torch.ones_like(dz)), torch.full_like(dz, BIG))
            u = o_p[..., 0] + t * d_p[..., 0]
            v = o_p[..., 1] + t * d_p[..., 1]
            hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
            t = torch.where(hit, t, torch.full_like(t, BIG))
            tmin, i = torch.min(t, dim=1)      # first index of the min
            better = tmin < tb[cur]
            tb[cur] = torch.where(better, tmin, tb[cur])
            fb[cur] = torch.where(better, (i + c0).to(torch.int32), fb[cur])
    return tb, fb


def copy_most_hit(mats, chunk, faces, n):
    """The six Woop matrices with copies of the n most-hit triangles of
    the chunk of the last live triangle in free slots of that chunk (a
    tie within a chunk) and of the n most-hit earlier ones in the table's
    last chunk (a tie across chunks); faces (R,) int32 are the hits on
    the table without copies. Returns (copied matrices, source ids)."""
    import torch
    n_live = live_tris(mats)
    t_all = mats[0].shape[1]
    last = (n_live - 1) // chunk       # chunk of the last live triangle
    if (last + 1) * chunk - n_live < n + 16 or t_all // chunk - 1 <= last:
        raise AssertionError("the table leaves no room for copies")
    hits = torch.bincount(faces[faces >= 0].long(), minlength=t_all)
    src = torch.cat([last * chunk + torch.topk(hits[last * chunk:n_live],
                                               n).indices,
                     torch.topk(hits[:last * chunk], n).indices])
    ar = torch.arange(n, device=faces.device)
    dst = torch.cat([n_live + 16 + ar, t_all - chunk + 16 + ar])
    dup = [x.clone() for x in mats]
    if any(bool(x[:, dst].any()) for x in dup):
        raise AssertionError("a slot for a copy holds a live triangle")
    for x in dup:
        x[:, dst] = x[:, src]
    return dup, src


def zero_maps_table(mats, n):
    """The first n slots of a Woop table's six matrices with zero maps
    written over every 9th slot from slot 4, +0.0 and -0.0 in turn, among
    the real triangles (the table's own zero slots, padding and
    degenerate faces, stay): closest_dense must skip them wherever they
    sit. Returns (the matrices, the zero slots' mask)."""
    import torch
    out = [x[:, :n].contiguous().clone() for x in mats]
    zero = torch.arange(4, n, 9, device=out[0].device)
    for x in out:
        x[:, zero] = 0.0
        x[:, zero[::2]] = -0.0
    return out, (out[2] == 0).all(dim=0)


def edge_seeds(t0):
    """t0 with every 5th ray's seed -BIG, nan or 1e-6 (below every hit) in
    turn: each of those rays keeps its seed, with face -1. Returns (the
    seeds, the mask of those rays)."""
    import torch
    from raypt_torch.core.math3d import BIG
    t = t0.clone()
    fixed = torch.zeros_like(t, dtype=torch.bool)
    fixed[::5] = True
    vals = torch.tensor([-BIG, float("nan"), 1e-6], device=t.device)
    t[fixed] = vals[torch.arange(int(fixed.sum()), device=t.device) % 3]
    return t, fixed


def merge_case(leaf, device, c_total=MERGE_C, r=MERGE_RAYS, seed=0,
               stray=False, giant=False):
    """Seeded synthetic inputs of the cluster kernels' merge rules: C
    clusters of `leaf` random triangles (face ids 1000 + c * leaf + j) and
    R rays, each aimed at one triangle and wanting its cluster and up to
    four others. Planted:
      * across: a triangle copied into a higher cluster with a lower face
        id; rays at it want both clusters, and the lower cluster must win
        (with its face id, the higher one);
      * within: a triangle copied into another slot of its cluster with a
        lower face id, which must win;
      * in rays 0-1023 one cluster is wanted by ray 7 alone (a cluster
        one ray of a cluster_expand block wants);
      * tile 1 (rays 256-511) all dead (seed -BIG) and tile 2 mixed (every
        other ray dead, seeds -BIG, 0, -0 and nan), both with nonzero
        masks; in tile 3 one ray is live;
      * with stray: bits >= C set in the last word of every mask and union,
        every padding mask word and an extra union word all ones (the JAX
        kernels guard only the last word, so only the card takes these);
      * with giant: in every fourth cluster a triangle with edges of 5e18
        or 3e19, far from the rest, whose det reaches 2^126 and inf (the
        kernels' exact reciprocal path).
    Returns a dict of tensors on `device`: tri_rows (C, L, 12), mask_cm
    (cwp, R), union_pp (R / 2048, cwp), union (R / 256, cw, or cw + 1 with
    stray), ro, rd, seed, and the planted live rays as across / within
    (n, 3) int64: ray id, the face that must win, the face it ties with."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    cw = -(-c_total // 32)
    cwp = -(-cw // 8) * 8
    p0 = rng.uniform(-8.0, 8.0, (c_total, leaf, 3))
    e1 = 0.3 * rng.normal(size=(c_total, leaf, 3))
    e2 = 0.3 * rng.normal(size=(c_total, leaf, 3))
    fid = 1000 + np.arange(c_total * leaf).reshape(c_total, leaf)
    used, across, within = set(), [], []

    def free(*slots):
        if any(s in used for s in slots) or len(set(slots)) < len(slots):
            return False
        used.update(slots)
        return True

    def copy(src, dst, face):
        for x in (p0, e1, e2):
            x[dst] = x[src]
        fid[dst] = face

    while len(across) < MERGE_PLANTS:
        a = int(rng.integers(0, c_total - 1))
        b = int(rng.integers(a + 1, c_total))
        src, dst = (a, int(rng.integers(leaf))), (b, int(rng.integers(leaf)))
        if free(src, dst):
            copy(src, dst, 10 + len(across))
            across.append((src, dst))
    while len(within) < MERGE_PLANTS:
        c = int(rng.integers(c_total))
        src, dst = (c, int(rng.integers(leaf))), (c, int(rng.integers(leaf)))
        if free(src, dst):
            copy(src, dst, 500 + len(within))
            within.append((src, dst))

    if giant:
        for k, c in enumerate(range(0, c_total, 4)):
            j = next(j for j in range(leaf) if (c, j) not in used)
            used.add((c, j))
            p0[c, j] = 1e20 + rng.uniform(-1e18, 1e18, 3)
            e1[c, j], e2[c, j] = (5e18, 3e19)[k % 2] * rng.normal(size=(2, 3))
    target = np.stack([rng.integers(0, c_total, r), rng.integers(0, leaf, r)],
                      axis=1)
    want = rng.random((r, c_total)) < 4.0 / c_total
    ids = np.arange(r)
    plant = {3: across, 11: within}
    planted = {3: [], 11: []}
    for i in ids:
        pairs = plant.get(i % 16)
        if pairs:
            src, dst = pairs[i // 16 % MERGE_PLANTS]
            target[i] = src
            want[i, dst[0]] = True
            planted[i % 16].append((i, src, dst))
    single = min(set(range(c_total)) - {x[0] for pair in across + within
                                        for x in pair})
    target[7] = (single, 0)
    want[ids, target[:, 0]] = True
    want[:1024, single] = False
    want[7, single] = True
    point = (p0[target[:, 0], target[:, 1]] + 0.25 * e1[target[:, 0], target[:, 1]]
             + 0.25 * e2[target[:, 0], target[:, 1]])
    n = rng.normal(size=(r, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    ro = (point + n * rng.uniform(0.2, 1.0, (r, 1))).astype(np.float32)
    rd = (-n).astype(np.float32)
    sd = np.where(rng.random(r) < 0.7, 1e30,
                  rng.uniform(0.1, 5.0, r)).astype(np.float32)
    sd[ids % 16 == 3] = sd[ids % 16 == 11] = np.float32(1e30)
    sd[256:512] = -1e30
    sd[512:768:2] = np.resize(np.array([-1e30, 0.0, -0.0, np.nan], np.float32),
                              128)
    sd[768:1024] = -1e30
    sd[777] = np.float32(1e30)

    bits = np.zeros((cwp, r), np.uint64)
    for c in range(c_total):
        bits[c >> 5] |= want[:, c].astype(np.uint64) << np.uint64(c & 31)
    if stray:
        if c_total % 32:
            bits[cw - 1] |= np.uint64((0xFFFFFFFF << (c_total % 32)) & 0xFFFFFFFF)
        bits[cw:] = 0xFFFFFFFF
    mask_cm = bits.astype(np.uint32).view(np.int32)
    union_pp = np.bitwise_or.reduce(mask_cm.reshape(cwp, r // 2048, 2048),
                                    axis=2).T
    union = np.bitwise_or.reduce(mask_cm[:cw].reshape(cw, r // 256, 256),
                                 axis=2).T
    if stray:
        union = np.concatenate([union, np.full((r // 256, 1), -1, np.int32)],
                               axis=1)
    rows = np.zeros((c_total, leaf, 12), np.float32)
    rows[..., 0:3], rows[..., 3:6], rows[..., 6:9] = p0, e1, e2
    rows[..., 9] = fid.astype(np.int32).view(np.float32)

    def rays(kind):   # across: the source's face wins; within: the copy's
        out = [(i, fid[src], fid[dst]) if kind == 3 else (i, fid[dst], fid[src])
               for i, src, dst in planted[kind] if sd[i] > 0]
        return torch.tensor(out, dtype=torch.int64, device=device)

    case = {"tri_rows": rows, "mask_cm": mask_cm, "union_pp": union_pp,
            "union": union, "ro": ro, "rd": rd, "seed": sd}
    case = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in case.items()}
    case["across"], case["within"] = rays(3), rays(11)
    return case


def check_planted(case, face, label):
    """The planted ties of `merge_case` resolved by the merge rules: a
    planted ray that hits one of its two tied faces has the one that must
    win, and most planted rays hit one (the rest hit another triangle
    first)."""
    for kind in ("across", "within"):
        ray, win, lose = case[kind].unbind(1)
        got = face[ray].long()
        tied = (got == win) | (got == lose)
        if bool((got[tied] != win[tied]).any()) or \
                2 * int(tied.sum()) < ray.numel():
            raise AssertionError(
                f"{label}: {kind} ties resolved wrongly ({int(tied.sum())} of "
                f"{ray.numel()} planted rays hit a tied face, "
                f"{int((got[tied] != win[tied]).sum())} with the wrong one)")


def woop_merge(case):
    """merge_case's clusters as the Woop kernel takes them: (woop_cm,
    fid_flat) from build_woop_cm, and the case with its planted ties as
    the Woop rules resolve them (check_planted's input): across clusters
    the lower cluster still wins, within a cluster the lower lane (not
    the lower face id)."""
    from types import SimpleNamespace

    import torch
    from raypt_torch.accel.clusters import build_woop_cm
    woop_cm, fid = build_woop_cm(SimpleNamespace(tri_rows=case["tri_rows"]))
    within = case["within"].clone()
    if within.numel():
        def slot(face):
            return torch.nonzero(fid[None, :].long() == face[:, None])[:, 1]
        win = within[:, 1].clone()
        swap = slot(within[:, 1]) > slot(within[:, 2])
        within[swap, 1] = within[swap, 2]
        within[swap, 2] = win[swap]
    return woop_cm, fid, dict(case, within=within)


def worklist_merge(case, stray=False, seed=0):
    """merge_case's clusters as the worklist kernels take them. Each
    tile's wanted clusters (its union's bits below C) are listed in
    descending id in even tiles and ascending id in odd ones, in a
    worklist WL_PAD slots wider than the longest list; the slots past a
    list hold random ids in [0, C). counts: the list's length, 2 more in
    tiles 4k + 1 (slots past the list are tested), 1 less in tiles 4k + 2
    (the list is cut). With stray: ids outside [0, C) inside every list
    and in the padding, and counts above cap in tiles 4k + 3. Returns
    (worklist (n_tiles, cap) int32, counts (n_tiles,) int32, the case
    with its planted ties as list order resolves them: across clusters
    the earlier slot wins, the lower cluster in odd tiles and the higher
    in even ones; within a cluster the lower face id; the planted rays of
    cut tiles are left out)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    c_total = case["tri_rows"].shape[0]
    union = case["union"].cpu().numpy().view(np.uint32)
    lists = []
    for k, words in enumerate(union):
        ids = [c for c in range(c_total) if words[c >> 5] >> (c & 31) & 1]
        ids = ids[::-1] if k % 2 == 0 else ids
        if stray:
            ids.insert(len(ids) // 2, (-1, c_total, c_total + 7, -5)[k % 4])
        lists.append(ids)
    cap = max(map(len, lists)) + WL_PAD
    wl = rng.integers(0, c_total, (len(lists), cap)).astype(np.int32)
    if stray:
        wl[:, -1] = np.resize(np.array([c_total, -1, -2**31, 2**31 - 1],
                                       np.int32), len(lists))
    counts = np.zeros(len(lists), np.int32)
    for k, ids in enumerate(lists):
        wl[k, :len(ids)] = ids
        counts[k] = len(ids) + (0, 2, -1, cap + 5 if stray else 0)[k % 4]
    dev = case["ro"].device
    planted = dict(case)
    for kind in ("across", "within"):
        rows = case[kind].clone()
        tile = rows[:, 0] // 256
        if kind == "across":
            even = tile % 2 == 0
            rows[even, 1], rows[even, 2] = case[kind][even, 2], case[kind][
                even, 1]
        planted[kind] = rows[tile % 4 != 2]
    return (torch.from_numpy(wl).to(dev), torch.from_numpy(counts).to(dev),
            planted)


def woop_faces(packed, fid):
    """The face ids of the Woop kernel's packed results (-1 stays)."""
    import torch
    return torch.where(packed >= 0, fid[packed.clamp(min=0).long()],
                       torch.full_like(packed, -1))


def walk_layouts(active):
    """active (R,) bool, R >= 768, with its first three 256-ray blocks
    rewritten: block 0 all dead, block 1 with one live ray (its ray 77),
    block 2 live only in its last warp (rays 224-255)."""
    a = active.clone()
    a[:768] = False
    a[256 + 77] = True
    a[768 - 32:768] = True
    return a


def hit64(scene, ro, rd, face):
    """Float64 Moller-Trumbore test of each ray against its face (face
    >= 0): (t, inside) with inside = u, v >= 0, u + v <= 1, t > 0."""
    import torch
    m = scene.mesh
    f = m.faces.long()[face.long()]
    p = m.positions.double()
    p0, p1, p2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    o, d = ro.double(), rd.double()
    e1, e2 = p1 - p0, p2 - p0
    pv = torch.linalg.cross(d, e2)
    det = (e1 * pv).sum(-1)
    tv = o - p0
    q = torch.linalg.cross(tv, e1)
    u = (tv * pv).sum(-1) / det
    v = (d * q).sum(-1) / det
    t = (e2 * q).sum(-1) / det
    return t, (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)


def compare_pallas(stats, label, scene, mats, chunk, ro, rd, timed,
                   woop=None):
    """The pallas path's closest_dense on one wavefront (every ray, live
    or dead, as the finder passes them), kernel against plain version;
    when timed, also matmul_closest on the same rays (woop). Returns the
    kernel's (t, face)."""
    from functools import partial
    from raypt_torch.accel.traverse import wavefront_inputs
    from raypt_torch.kernels import dense_pallas as dp

    o, d, t, _, _, _ = wavefront_inputs(scene, ro, rd, None, dp.RAY_TILE)
    args = (*mats, o, d, t)
    kernel = partial(dp.closest_dense, tri_chunk=chunk)
    plain = partial(dp.closest_dense_plain, tri_chunk=chunk)
    kt, kf = kernel(*args)
    pt, pf = plain(*args)
    stats.check("closest_dense", f"{label} t", kt, pt)
    stats.check("closest_dense", f"{label} face", kf, pf)
    if timed:
        n_tris = live_tris(mats)
        stats.time("closest_dense", label, kernel, plain, args,
                   nbytes(*args, kt, kf), DENSE_OPS * o.shape[0] * n_tris)
        stats.time_library("closest_dense", label,
                           lambda: matmul_closest(woop, o, d, t))
        zero = zero_ww(mats)
        log(f"  {label:9s} {o.shape[0]} rays x {n_tris} live triangles of "
            f"{mats[0].shape[1]}; {int((kf >= 0).sum())} triangle hits; "
            f"zero-ww triangles' tests skipped: {zero} of "
            f"{mats[0].shape[1]} triangles "
            f"({zero / mats[0].shape[1]:.4f} of all tests)")
    return kt, kf


def compare_unfused(stats, label, scene, accel, ro, rd, active, timed):
    """The non-fused path's mask-only walk on one wavefront, kernel
    against plain version, word-major and transposed (the (R, words)
    form the finder takes). Returns the kernel's (words, R) mask."""
    from raypt_torch.accel.ctree import walk_topwalk
    from raypt_torch.accel.traverse import DENSE_CHUNK, wavefront_inputs
    from raypt_torch.kernels import onehot_walk as wk

    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    nw = -(-accel.num_clusters // 32)
    wargs = (accel.table, o, d, t, a, nw)
    km = wk.topwalk_cm(*wargs)
    stats.check("topwalk_cm", f"{label} mask", km, wk.topwalk_cm_plain(*wargs))
    stats.check("topwalk_cm", f"{label} (R, words) mask", wk.topwalk(*wargs),
                walk_topwalk(*wargs))
    if timed:
        # what the function needs: the table once, a live ray's origin,
        # direction and t, every ray's flag and mask column
        visits = walk_visits(*wargs)
        live = int(a.sum())
        busy = int(a.view(-1, WALK_BLOCK).any(dim=1).sum())
        moved = (nbytes(accel.table, a, km)
                 + live * (o.shape[1] + d.shape[1] + 1) * o.element_size())
        ops = ((WALK_OPS - ROW_DECODE_OPS) * visits
               + ROW_DECODE_OPS * accel.table.shape[0] * busy)
        stats.time("topwalk_cm", label, wk.topwalk_cm, wk.topwalk_cm_plain,
                   wargs, moved, ops)
        ms = cuda_ms(lambda: wk.topwalk(*wargs), 10)
        stats.topwalk_ms[stats.path] = stats.topwalk_ms.get(stats.path,
                                                            0.0) + ms
        log(f"  {label:9s} topwalk (kernel + transpose) {ms:9.3f} ms; walk "
            f"visits {visits}, {nw} words, {busy} blocks with a live ray")
    return km


def matmul_woop(union, woop_cm, ro, rd, t0, tiles_per_call=512):
    """cluster_intersect_mask_woop's result through torch.bmm, the
    yardstick of its library_ms: the k-th cluster of every tile's union
    (ascending id), for k = 0, 1, ..., as batched products of each
    (tile, cluster) pair's (3L, 4) table by the tile's (4, 2 x 256) rays
    [o; 1 | d; 0], then the elementwise tests and the strict merge; the
    lowest lane wins a tie within a cluster, as in the kernel. Needs
    float32 products (no TF32)."""
    import torch
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels.cluster_pallas import TILE, _valid_union
    assert not torch.backends.cuda.matmul.allow_tf32
    c_total, leaf = woop_cm.shape[0], woop_cm.shape[2] // 3
    n_tiles = union.shape[0]
    cid = torch.arange(c_total, device=union.device)
    wanted = ((_valid_union(union, c_total)[:, cid >> 5] >> (cid & 31)) & 1
              ).bool()
    # the wanted ids of each tile first, in ascending order
    order = torch.sort((~wanted).to(torch.int8), dim=1, stable=True).indices
    counts = wanted.sum(dim=1)
    one = torch.ones((n_tiles, TILE, 1), device=ro.device)
    rays = torch.cat([torch.cat([ro.view(n_tiles, TILE, 3), one], -1),
                      torch.cat([rd.view(n_tiles, TILE, 3), 0 * one], -1)],
                     dim=1).transpose(1, 2)            # (n_tiles, 4, 2T)
    tab = woop_cm.transpose(1, 2)                      # (C, 3L, 4)
    tb = t0.view(n_tiles, TILE).clone()
    pb = torch.full(tb.shape, -1, dtype=torch.int32, device=t0.device)
    for k in range(int(counts.max()) if n_tiles else 0):
        live = torch.nonzero(counts > k).flatten()
        for s0 in range(0, live.numel(), tiles_per_call):
            tiles = live[s0:s0 + tiles_per_call]
            c = order[tiles, k]
            out = torch.bmm(tab[c], rays[tiles])        # (m, 3L, 2T)
            ou, du = out[:, :leaf, :TILE], out[:, :leaf, TILE:]
            ov, dv = out[:, leaf:2 * leaf, :TILE], out[:, leaf:2 * leaf, TILE:]
            ow, dw = out[:, 2 * leaf:, :TILE], out[:, 2 * leaf:, TILE:]
            tq = -ow / dw
            u = ou + tq * du
            v = ov + tq * dv
            hit = (tq > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            t = torch.where(hit, tq, torch.full_like(tq, BIG))
            tmin, lane = torch.min(t, dim=1)         # first index of the min
            better = tmin < tb[tiles]
            tb[tiles] = torch.where(better, tmin, tb[tiles])
            pb[tiles] = torch.where(better, (c[:, None] * leaf + lane).to(
                torch.int32), pb[tiles])
    return tb.view(-1), pb.view(-1)


def compare_woop(stats, label, scene, accel, ro, rd, active, timed):
    """The config-4 path's stages on one wavefront: the mask-only walk
    and cluster_intersect_mask_woop on the kernel walk's tile unions,
    kernel against plain version; when timed, both kernels (the walk's
    times are kept apart from the unfused path's as well as summed into
    its row), matmul_woop, the live rays a tile and the share of the
    tile x union tests that dead rays would take (the kernel skips them).
    Returns (union, o, d, alive, seed, t, packed) of the kernels."""
    import torch
    from raypt_torch.accel.clusters import tile_union_counts
    from raypt_torch.accel.traverse import DENSE_CHUNK, wavefront_inputs
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_pallas as dn
    mask = compare_unfused(stats, label, scene, accel, ro, rd, active,
                           timed=timed)
    union, counts = tile_union_counts(mask.T.contiguous(), dn.TILE)
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    args = (union, accel.woop_cm, o, d, seed)
    kt, kp = dn.cluster_intersect_mask_woop(*args)
    pt, pp = dn.cluster_intersect_mask_woop_plain(*args)
    stats.check("cluster_intersect_mask_woop", f"{label} t", kt, pt)
    stats.check("cluster_intersect_mask_woop", f"{label} packed", kp, pp)
    if timed:
        leaf = accel.woop_cm.shape[2] // 3
        tests = live_tests(a, counts, dn.TILE)
        stats.time("cluster_intersect_mask_woop", label,
                   dn.cluster_intersect_mask_woop,
                   dn.cluster_intersect_mask_woop_plain, args,
                   nbytes(union, accel.woop_cm, o, d, seed, kt, kp),
                   WOOP_OPS * leaf * tests)
        stats.time_library("cluster_intersect_mask_woop", label,
                           lambda: matmul_woop(*args), reps=1)
        _, mp = matmul_woop(*args)
        mt_ms = cuda_ms(lambda: dn.cluster_intersect_mask(
            union, accel.clusters.tri_rows, o, d, seed), 10)
        log(f"  {label:9s} cluster_intersect_mask (Moller-Trumbore) on the "
            f"same unions {mt_ms:9.3f} ms")
        live = a.view(-1, dn.TILE).sum(dim=1)
        busy = counts > 0
        log(f"  {label:9s} union clusters per tile "
            f"{float(counts.float().mean()):.2f}, max {int(counts.max())}, "
            f"live ray-cluster tests {tests} "
            f"({tests / max(dn.TILE * int(counts.sum()), 1):.4f} of all); "
            f"{int((kp >= 0).sum())} hits; matmul_woop's packed differs on "
            f"{int((mp != kp).sum())} rays")
        log(f"  {label:9s} live rays a tile {float(live.float().mean()):.2f} "
            f"({float(live[busy].float().mean()) if bool(busy.any()) else 0.0:.2f}"
            f" over the {int(busy.sum())} tiles with a union); tests of dead "
            f"rays skipped: "
            f"{1.0 - tests / max(dn.TILE * int(counts.sum()), 1):.4f} of all")
    return union, o, d, a, seed, kt, kp


def woop_lanes(woop_cm):
    """(C, 4, 3, L) view of a Woop table: [c, k, row, lane]."""
    return woop_cm.view(woop_cm.shape[0], 4, 3, -1)


def free_lanes(woop_cm):
    """(C, L) bool: lanes that hold the miss encoding (padding)."""
    w = woop_lanes(woop_cm)
    return ((w[:, :3] == 0).all(dim=1).all(dim=1) & (w[:, 3, 0] == 0)
            & (w[:, 3, 1] == 0) & (w[:, 3, 2] == 1))


def woop_edges(stats, accel, union, o, d, seed, kt, kp):
    """Edge cases of cluster_intersect_mask_woop on one wavefront's
    inputs and kernel result (kt, kp), each kernel against plain version:
    stray union bits >= C and an extra word of ones; the most-hit
    triangles turned into the miss encoding; a tile of rays parallel to a
    triangle's plane; copies of the most-hit triangles in a higher free
    lane of their cluster and in a free lane of a later cluster (whose
    bit is then set wherever the source's is): a copy never wins; and a
    tile of dead rays (seed -BIG) with its union kept."""
    import torch
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_pallas as dn
    c_total, leaf = accel.woop_cm.shape[0], accel.woop_cm.shape[2] // 3
    name = "cluster_intersect_mask_woop"

    def run(what, u=union, w=accel.woop_cm, oo=o, dd=d, sd=seed):
        args = (u.contiguous(), w.contiguous(), oo, dd, sd)
        t_, p_ = dn.cluster_intersect_mask_woop(*args)
        pt, pp = dn.cluster_intersect_mask_woop_plain(*args)
        stats.check(name, f"{what} t", t_, pt)
        stats.check(name, f"{what} packed", p_, pp)
        return t_, p_

    def same_as_base(what, t_, p_):
        if not (bitwise_equal(t_, kt)[0] and torch.equal(p_, kp)):
            raise AssertionError(f"{name}: {what} changed the result")

    stray = union.clone()
    if c_total % 32:
        stray[:, -1] |= 1 << (c_total % 32)
    stray = torch.cat([stray, torch.full_like(stray[:, :1], -1)], dim=1)
    same_as_base("stray bits", *run("stray bits", u=stray))

    hits = torch.bincount(kp[kp >= 0].long(), minlength=c_total * leaf)
    top = torch.topk(hits, COPIES).indices               # packed ids
    miss = accel.woop_cm.clone()
    mw = woop_lanes(miss)
    for pid in top.tolist():
        c, j = divmod(pid, leaf)
        mw[c, :, :, j] = 0.0
        mw[c, 3, 2, j] = 1.0
    _, p_ = run("miss encoding", w=miss)
    if bool(torch.isin(p_, top).any()):
        raise AssertionError(f"{name}: a triangle in the miss encoding won")

    # a tile of rays with d = (a1, -a0, 0) (or its negation) for the w row
    # (a0, a1, a2, a3) of a most-hit triangle: d'_w = +-0 exactly
    w = woop_lanes(accel.woop_cm)
    for pid in top.tolist():
        c, j = divmod(pid, leaf)
        a0, a1 = w[c, 0, 2, j], w[c, 1, 2, j]
        if bool(a0 != 0) or bool(a1 != 0):
            break
    par_d = d.clone()
    sign = torch.where(torch.arange(dn.TILE, device=d.device) % 2 == 0,
                       1.0, -1.0)
    par_d[:dn.TILE] = torch.stack([a1 * sign, -a0 * sign,
                                   torch.zeros_like(sign)], dim=-1)
    par_u = union.clone()
    par_u[0, c >> 5] |= 1 << (c & 31)
    par_s = seed.clone()
    par_s[:dn.TILE] = BIG
    _, p_ = run("parallel rays", u=par_u, dd=par_d.contiguous(), sd=par_s)
    if bool((p_[:dn.TILE] == pid).any()):
        raise AssertionError(f"{name}: a ray parallel to a triangle's plane "
                             f"hit it")

    free = free_lanes(accel.woop_cm)
    lane = torch.arange(leaf, device=free.device)
    within, across = accel.woop_cm.clone(), accel.woop_cm.clone()
    cw_, aw_ = woop_lanes(within), woop_lanes(across)
    copies_in, copies_out = [], []
    across_u = union.clone()
    for pid in top.tolist():
        c, j = divmod(pid, leaf)
        higher = torch.nonzero(free[c] & (lane > j)).flatten()
        if higher.numel():
            jj = int(higher[-1])
            free[c, jj] = False
            cw_[c, :, :, jj] = cw_[c, :, :, j]
            copies_in.append(c * leaf + jj)
        later = torch.nonzero(free[c + 1:].any(dim=1)).flatten()
        if later.numel():
            c2 = c + 1 + int(later[0])
            jj = int(torch.nonzero(free[c2]).flatten()[-1])
            free[c2, jj] = False
            aw_[c2, :, :, jj] = aw_[c, :, :, j]
            copies_out.append(c2 * leaf + jj)
            has = ((union[:, c >> 5] >> (c & 31)) & 1).bool()
            across_u[has, c2 >> 5] |= 1 << (c2 & 31)
    if not copies_in or not copies_out:
        raise AssertionError(f"{name}: no free lane for the copies")
    for what, tab, u, ids in (("copies within clusters", within, union,
                               copies_in),
                              ("copies in later clusters", across, across_u,
                               copies_out)):
        t_, p_ = run(what, u=u, w=tab)
        if bool(torch.isin(p_, torch.tensor(ids, device=p_.device)).any()):
            raise AssertionError(f"{name}: a copy won over its source "
                                 f"({what})")
        if what == "copies within clusters":
            same_as_base(what, t_, p_)
    dead = seed.clone()
    dead[:dn.TILE] = -BIG
    t_, p_ = run("dead tile", sd=dead)
    if bool((t_[:dn.TILE] != -BIG).any()) or bool((p_[:dn.TILE] != -1).any()):
        raise AssertionError(f"{name}: a dead ray took a hit")
    # tile 1 mixed (every other ray dead, seeds -BIG, 0, -0 and nan), tile
    # 2 with one live ray, tile 3 live only in its last warp: dead rays
    # keep (seed, -1) bitwise, live ones the result of the all-live tile
    lane = torch.arange(dn.TILE, device=seed.device)
    kill = torch.zeros_like(seed, dtype=torch.bool)
    kill[dn.TILE:2 * dn.TILE] = lane % 2 == 1
    kill[2 * dn.TILE:3 * dn.TILE] = lane != 77
    kill[3 * dn.TILE:4 * dn.TILE] = lane < dn.TILE - 32
    bad = torch.tensor([-BIG, 0.0, -0.0, float("nan")], device=seed.device)
    sd = torch.where(kill, bad[torch.arange(seed.numel(), device=seed.device)
                               // 2 % 4], seed)
    t_, p_ = run("mixed, one-live and last-warp tiles", sd=sd)
    keep = ~kill
    if not (bitwise_equal(t_, sd, where=kill)[0] and bool((p_[kill] == -1).all())
            and bitwise_equal(t_, kt, where=keep)[0]
            and torch.equal(p_[keep], kp[keep])):
        raise AssertionError(f"{name}: the mixed, one-live or last-warp tiles "
                             f"changed a dead ray or a live ray's result")
    log(f"  edges: stray bits (+ a word of ones) unchanged; {COPIES} "
        f"most-hit triangles in the miss encoding never win; a tile "
        f"parallel to triangle {pid}'s plane; {len(copies_in)} copies in a "
        f"higher lane of their cluster (result unchanged) and "
        f"{len(copies_out)} in a later cluster never win; a dead tile keeps "
        f"-BIG; a mixed, a one-live and a last-warp-only tile keep their dead "
        f"rays' seeds and their live rays' results; union words "
        f"{union.shape[1]}, C = {c_total}")


def compare_grouped(stats, label, scene, clusters, ro, rd, active, timed,
                    edges):
    """cluster_intersect_grouped on one wavefront of the cluster path, at
    cap WORKLIST_CAP - 1 (no G divides it; the cluster path's worklists)
    for every G in GROUPS, kernel against plain version and against
    cluster_intersect; G = 4 timed. With edges, also at GROUP_CAP (counts
    clamped, so the rounded-up slots past cap must be skipped) against
    both, and with counts cut below the list (valid ids past counts,
    tested within the last group) against the plain version only."""
    from functools import partial

    import torch
    from raypt_torch.accel.clusters import WORKLIST_CAP, tile_worklists
    from raypt_torch.accel.traverse import DENSE_CHUNK, wavefront_inputs
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_pallas as dn

    name = "cluster_intersect_grouped"
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    rows = clusters.tri_rows
    tiles = torch.arange(o.shape[0] // dn.TILE, device=o.device)
    changed = []
    for cap in (WORKLIST_CAP - 1, GROUP_CAP) if edges else (WORKLIST_CAP - 1,):
        wl, cnt, _ = tile_worklists(clusters, o, d, seed, dn.TILE, cap)
        cut = torch.clamp(cnt - (tiles % 4).to(cnt.dtype), min=0)
        variants = [("", cnt)] + ([(" cut", cut)] if edges else [])
        for what, c_ in variants:
            args = (wl, c_, rows, o, d, seed)
            ut, uf = dn.cluster_intersect(*args)
            for g in GROUPS:
                kt, kf = dn.cluster_intersect_grouped(*args, group=g)
                pt, pf = dn.cluster_intersect_grouped_plain(*args, group=g)
                tag = f"{label} cap {cap} G={g}{what}"
                stats.check(name, f"{tag} t", kt, pt)
                stats.check(name, f"{tag} face", kf, pf)
                if what:
                    changed.append(int((kf != uf).sum()))
                elif not (bitwise_equal(kt, ut)[0] and torch.equal(kf, uf)):
                    raise AssertionError(f"{name}: {tag} differs from "
                                         f"cluster_intersect")
        if cap == WORKLIST_CAP - 1 and timed:
            iargs = (wl, cnt, rows, o, d, seed)
            stats.time(name, label, partial(dn.cluster_intersect_grouped,
                                            group=4),
                       partial(dn.cluster_intersect_grouped_plain, group=4),
                       iargs, nbytes(*iargs, kt, kf),
                       MT_OPS * rows.shape[1] * live_tests(a, cnt, dn.TILE))
    log(f"  {label:9s} grouped: G {GROUPS} at cap "
        f"{(WORKLIST_CAP - 1, GROUP_CAP) if edges else WORKLIST_CAP - 1} "
        f"equal to cluster_intersect" + (
            f"; with counts cut, faces differ from cluster_intersect's at the "
            f"cut counts on {changed} rays" if edges else ""))


def compare_finders_woop_mt(scene, accel, waves):
    """The Woop finder against the Moller-Trumbore dense-union finder on
    the same clusters, on every wavefront: hits, t and faces (module
    docstring, phase 5)."""
    import torch
    from raypt_torch.accel.traverse import find_closest_onehot
    mt_accel = accel.replace(woop_cm=None, fid_flat=None)
    for b, (ro, rd, active) in enumerate(waves):
        kw = dict(expand_n=0, compact_n=0)
        w = find_closest_onehot(scene, ro, rd, active, accel=accel, **kw)
        m = find_closest_onehot(scene, ro, rd, active, accel=mt_accel, **kw)
        if not torch.equal(w.sphere, m.sphere):
            raise AssertionError(f"bounce {b}: sphere hits differ")
        wh, mh = w.tri >= 0, m.tri >= 0
        both = wh & mh
        close = torch.isclose(w.t, m.t, rtol=WOOP_T_RTOL, atol=WOOP_T_ATOL)
        hit_diff = torch.nonzero(wh != mh).flatten()
        t_diff = torch.nonzero(both & ~close).flatten()
        face_diff = torch.nonzero(both & close & (w.tri != m.tri)).flatten()
        bad = torch.cat([hit_diff, t_diff])

        def nearest64(face, idx):
            t_, inside = hit64(scene, ro[idx], rd[idx], face.clamp(min=0))
            return torch.where((face >= 0) & inside, t_,
                               torch.full_like(t_, torch.inf))

        tw, tm = nearest64(w.tri[bad], bad), nearest64(m.tri[bad], bad)
        err = (w.t - m.t).abs()[both]
        log(f"phase 5: Woop vs Moller-Trumbore finder, bounce {b}: "
            f"{int(active.sum())} live rays, {int(wh.sum())} / {int(mh.sum())}"
            f" triangle hits; hit only by one: {hit_diff.numel()}, t apart: "
            f"{t_diff.numel()} (float64 test of the two faces: the Woop "
            f"face's hit nearer {int((tw < tm).sum())}, the other's "
            f"{int((tm < tw).sum())}, equal {int((tw == tm).sum())}); faces "
            f"apart at near-ties: {face_diff.numel()}; max |dt| on shared "
            f"hits {float(err.max()) if err.numel() else 0.0:.3e}")
        if bad.numel() > DENSE_SHARE * active.numel():
            raise AssertionError(f"bounce {b}: the Woop and Moller-Trumbore "
                                 f"finders disagree on {bad.numel()} rays, "
                                 f"more than DENSE_SHARE")


def _dev_us(e, inclusive):
    """Device microseconds of a profiler key average (torch renamed the
    cuda_* fields to device_*)."""
    names = (("device_time_total", "cuda_time_total") if inclusive else
             ("self_device_time_total", "self_cuda_time_total"))
    for n in names:
        if hasattr(e, n):
            return getattr(e, n)
    raise AttributeError(f"profiler event has none of {names}")


def graph_us_per_call(fn, calls=20):
    """Device microseconds per call of `fn`, replayed from a CUDA graph of
    `calls` calls, so no host work runs between its kernels (mean of 10
    replays after a warm-up)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return 1e3 * cuda_ms(graph.replay, 10) / calls


# the inner loops read from the SASS: label -> (pattern of the kernel's
# mangled name, the instruction that marks one unit of work, the marks
# a unit). A triangle test takes one reciprocal (MUFU.RCP: __frcp_rn or
# an IEEE division); a walk step two 16-byte shared loads of its row.
SASS_LOOPS = {
    "cluster_expand_kernel": (r"\d+cluster_expand_kernelE", "MUFU.RCP", 1),
    "union_kernel<MtTest, UnionSource>": (
        r"\d+union_kernelINS_6MtTestENS_11UnionSourceE", "MUFU.RCP", 1),
    "union_kernel<MtTest, ListSource>": (
        r"\d+union_kernelINS_6MtTestENS_10ListSourceE", "MUFU.RCP", 1),
    "union_kernel<WoopTest<4>>": (r"\d+union_kernelINS_8WoopTestILi4E",
                                  "MUFU.RCP", 1),
    "closest_dense_kernel": (r"\d+closest_dense_kernelE", "MUFU.RCP", 1),
    "topwalk_mask_kernel": (r"\d+topwalk_mask_kernelE", "LDS.128", 2),
}


def sass_per_test(lib_path):
    """Instructions per unit of work (a triangle test, a walk step) in the
    inner loop of each of SASS_LOOPS, read from `cuobjdump -sass` of the
    built library: the shortest loop (a backward branch to an earlier
    instruction) that holds the unit's mark, its instruction count over
    its units (two a pass where a thread tests two rays or walks two
    rays, more where the compiler unrolled the loop). Returns label ->
    (instructions, units)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs, body = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = next((k for k, (pat, _, _) in SASS_LOOPS.items()
                         if re.search(pat, m.group(1))), None)
            body = funcs.setdefault(name, []) if name else None
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if body is not None and m:
            body.append((m.group(1), None))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if body is not None and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, body in funcs.items():
        _, mark, per_unit = SASS_LOOPS[name]
        ins, at = [], {}   # at: label or address -> instruction index
        for key, text in body:
            at[key] = len(ins)
            if text is not None:
                ins.append(text)
        best = None
        for end, text in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", text)
            if not m:
                continue
            tgt = m.group(1)
            start = at.get(int(tgt, 16) if tgt.startswith("0x") else tgt)
            if start is None or start > end:
                continue
            units = sum(mark in x for x in ins[start:end + 1]) / per_unit
            if units and (best is None or end + 1 - start < best[0]):
                best = (end + 1 - start, units)
        if best:
            out[name] = best
    return out


class SmClock:
    """The SM clock (MHz) from nvidia-smi every 250 ms while the block
    runs; `samples` after it."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "250"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        self.samples = [int(x) for x in out.split() if x.isdigit()]

    def summary(self):
        s = sorted(self.samples)
        if not s:
            return "SM clock not read"
        return (f"SM clock {s[len(s) // 2]} MHz median, {s[0]}-{s[-1]} over "
                f"{len(s)} samples")


def profile_step(label, step):
    """Trace one call of `step` and log the device time: the top kernels
    by self time and the top backward ops by inclusive time, as shares
    of the summed time of all kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    total = sum(_dev_us(e, False) for e in kernels)
    if total <= 0:
        raise AssertionError("profiler saw no device time")
    log(f"profile {label}: {total / 1e3:.3f} ms of kernel time in one "
        f"fwd+bwd step")
    for title, rows, inclusive in (
            ("kernels by device time", kernels, False),
            ("backward ops by inclusive device time",
             [e for e in ev if e.key.endswith("Backward0")], True)):
        log(f"profile {label}: {title}")
        for e in sorted(rows, key=lambda e: -_dev_us(e, inclusive))[:8]:
            us = _dev_us(e, inclusive)
            log(f"  {us / 1e3:10.3f} ms {100 * us / total:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")


def grad_check(build_scene, render, dev, view):
    """Mean-image gradients on the card through the kernels and on the
    CPU through the plain versions; build_scene() gives the scene on the
    CPU, render(scene) the image, view names the camera in the log."""
    import torch
    grads = []
    for where in (dev, torch.device("cpu")):
        scene = build_scene().to(where)
        v = scene.mesh.positions.clone().requires_grad_(True)
        a = scene.materials.albedo.clone().requires_grad_(True)
        s = scene.replace(mesh=scene.mesh.replace(positions=v),
                          materials=scene.materials.replace(albedo=a))
        img = render(s)
        img.mean().backward()
        grads.append((v.grad.cpu(), a.grad.cpu()))
    (gv, ga), (pv, pa) = grads
    for name, g, p in (("positions", gv, pv), ("albedo", ga, pa)):
        big = float(p.abs().max())
        err = float((g - p).abs().max())
        rows = int((p.abs().sum(dim=1) > 0).sum())
        log(f"phase 6: {GRAD_WIDTH}^2 {view}, grad {name}: "
            f"{rows} nonzero rows, max {big:.3e}, card vs CPU max abs err "
            f"{err:.3e} ({err / max(big, 1e-30):.2e} of max)")
        if not bool(torch.isfinite(g).all()) or big == 0.0:
            raise AssertionError(f"grad w.r.t. {name} not finite or zero")
        if err > GRAD_RTOL * big:
            raise AssertionError(f"grad w.r.t. {name}: card and CPU differ "
                                 f"by {err / big:.2e} of the largest")


def seconds(fn):
    """Host seconds of 3 calls after a warm-up, each ending in a
    synchronize."""
    import torch
    fn()
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def bench_loss(label, scene, cfg, skey, accel):
    """Phase 6 for one path: forward and fwd+bwd seconds of the bench
    loss, finite grads, a nonzero albedo grad, a profiled step. Returns
    fwd_bwd, the step."""
    import torch
    from raypt_torch.render.integrator import make_finder, render_sample
    v0 = scene.mesh.positions
    a0 = scene.materials.albedo

    def loss_fn(v, a):
        s = scene.replace(mesh=scene.mesh.replace(positions=v),
                          materials=scene.materials.replace(albedo=a))
        img_, tr = render_sample(s, cfg, skey, make_finder(s, cfg, accel),
                                 return_alive=True)
        return img_.mean(), tr

    def fwd():
        with torch.no_grad():
            loss, _ = loss_fn(v0, a0)
        return float(loss)

    def fwd_bwd():
        v = v0.clone().requires_grad_(True)
        a = a0.clone().requires_grad_(True)
        loss, tr = loss_fn(v, a)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), tr, v.grad, a.grad

    torch.cuda.reset_peak_memory_stats()
    fwd_s = seconds(fwd)
    fb_s = seconds(fwd_bwd)
    loss, tr, gv, ga = fwd_bwd()
    for name, g in (("positions", gv), ("albedo", ga)):
        if g is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: grad w.r.t. {name} is not finite")
    if not bool((ga != 0).any()):
        raise AssertionError(f"{label}: albedo grad is zero")
    segs = 2 * int(tr.sum())
    log(f"phase 6 {label}: loss {loss:.6f}, |grad positions| max "
        f"{float(gv.abs().max()):.3e}, |grad albedo| max "
        f"{float(ga.abs().max()):.3e}")
    log(f"phase 6 {label}: fwd s {[round(x, 4) for x in fwd_s]} median "
        f"{statistics.median(fwd_s):.4f}; fwd+bwd s "
        f"{[round(x, 4) for x in fb_s]} median {statistics.median(fb_s):.4f}; "
        f"traced segments fwd+bwd {segs} -> "
        f"{segs / statistics.median(fb_s) / 1e6:.3f} Mray-seg/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_step(label, fwd_bwd)


def probe_counters():
    """Each probe kernel's wrapper, whose `launches` count it (one wrapper
    serves both permute probes, one both gather probes)."""
    from raypt_torch.probes import (expand_debug, expand_diag2, gather,
                                    regroup, walk_spec_probe)
    return {"walk_spec": walk_spec_probe.topwalk_spec,
            "permute_probe": regroup.permute,
            "permute_probe2": regroup.permute,
            "sel_probe": regroup.sel,
            "cycle_budget": regroup.cycle,
            "expand_debug_stage12": expand_debug.stage12,
            "expand_debug_stage34": expand_debug.stage34,
            "expand_debug_stage5": expand_debug.stage5,
            "expand_diag2": expand_diag2.diag,
            "pallas_gather_test": gather.gather_rows,
            "pallas_gather_test2": gather.gather_rows}


def _lanes_used(per_cycle, n):
    """(lanes selected in at least one cycle, selections summed over the
    cycles) of one program, from each cycle's selected lanes."""
    import torch
    seen = torch.zeros(n, dtype=torch.bool)
    total = 0
    for lanes in per_cycle:
        seen[lanes.cpu()] = True
        total += lanes.numel()
    return int(seen.sum()), total


def probes_phase(stats):
    """Phase 7: each scripts/ probe's kernel against its plain version,
    bitwise, at the script's default sizes, timed for every mode and
    cycle count the script runs (the JSON line sums them). Bounds count
    what the run's data needs: of the lanes a probe selects at least once
    (all of x where its output carries x), the input rows its output
    depends on (cycle_budget: row 0; the split3 payloads: 18 of 24 rows;
    the diagnostics: rays with a wanted cluster, the unpadded mask),
    every output, and the f32 operations on the selected lanes and used
    slots."""
    import torch
    from raypt_torch.kernels import onehot_walk as wk
    from raypt_torch.probes import (cycle_budget, expand_debug, expand_diag2,
                                    gather, pallas_gather_test,
                                    pallas_gather_test2, permute_probe,
                                    permute_probe2, regroup, sel_probe,
                                    walk_spec_probe)
    t_start = time.perf_counter()
    log("phase 7: the scripts/ probes, kernel vs plain version, bitwise, at "
        "the scripts' default sizes")

    # P1: the speculative walk on the bench wavefront (WS_SIZE, WS_LEAF)
    args = walk_spec_probe.wavefront("cuda", walk_spec_probe.SIZE,
                                     walk_spec_probe.LEAF)
    spec = walk_spec_probe.topwalk_spec(*args)
    stats.check("walk_spec", "primary-ray mask", spec,
                wk.topwalk_cm_plain(*args))
    stats.check("walk_spec", "mask vs topwalk_cm", spec, wk.topwalk_cm(*args))
    visits = walk_visits(*args)
    stats.time("walk_spec", "spec", walk_spec_probe.topwalk_spec,
               wk.topwalk_cm_plain, args, nbytes(*args[:5], spec),
               WALK_OPS * visits)
    base_ms = cuda_ms(lambda: wk.topwalk_cm(*args), 10)
    log(f"  spec      topwalk_cm on the same rays {base_ms:9.3f} ms "
        f"(speculative {stats.ms['walk_spec']:.4f} ms); {args[1].shape[0]} "
        f"rays, Nt {args[0].shape[0]} rows, {args[5]} words, {visits} node "
        f"visits")

    # P2, P3: permute, summed and chained
    n, progs = permute_probe.N, permute_probe.PROGS
    x = permute_probe.inputs("cuda")
    for name, chain, modes, cycles in (
            ("permute_probe", False, (False,), permute_probe.ITERS),
            ("permute_probe2", True, (True, False), permute_probe2.ITERS)):
        for fixed in modes:
            for iters in cycles:
                a = (x, iters, n, chain, fixed)
                what = f"{iters} cycles{' fixed' if fixed else ''}"
                stats.check(name, what, regroup.permute(*a),
                            regroup.permute_plain(*a))
                used, total = _lanes_used(
                    [regroup.permute_lanes(n, 0 if fixed else c, "cpu")
                     for c in range(iters)], n)
                x_in = nbytes(x) if chain else 4 * 8 * used * progs
                stats.time(name, what[:9], regroup.permute,
                           regroup.permute_plain, a, x_in + nbytes(x),
                           progs * 8 * total * (4 if chain else 3))

    # P4: sel (the four variants are one function)
    n = sel_probe.N
    xs = sel_probe.inputs("cuda")
    for iters in sel_probe.ITERS:
        a = (xs, iters, n)
        out = regroup.sel(*a)
        stats.check("sel_probe", f"{iters} cycles", out, regroup.sel_plain(*a))
        per, slots = [], 0
        for c in range(iters):
            rank_m = regroup.sel_slots(n, c, "cpu")
            per.append(torch.nonzero(rank_m >= 0).flatten())
            slots += int(torch.unique(rank_m[rank_m >= 0]).numel())
        used, total = _lanes_used(per, n)
        # y reads rows 0-17; per lane 18 slot adds and 6 output adds, per
        # slot the two adds of each of y's 6 rows
        stats.time("sel_probe", f"{iters} cyc", regroup.sel, regroup.sel_plain,
                   a, 2 * 18 * used * sel_probe.PROGS + nbytes(out),
                   sel_probe.PROGS * (24 * total + 12 * slots))
        log(f"  sel_probe {iters} cycles: {total} lane-slots in all (the "
            f"shifted-sum rank gives no interested lane a slot), output "
            f"{'all zero' if not bool(out.any()) else 'nonzero'}")

    # P5: cycle_budget's three modes
    n, progs = cycle_budget.N, cycle_budget.PROGS
    xc = cycle_budget.inputs("cuda")
    for mode in regroup.CYCLE_MODES:
        for iters in (16, cycle_budget.ITERS):
            a = (xc, iters, n, mode)
            out = regroup.cycle(*a)
            stats.check("cycle_budget", f"{mode} {iters} cycles", out,
                        regroup.cycle_plain(*a))
            members = [regroup.cycle_members(n, c, mode, "cpu")
                       for c in range(iters)]
            used, total = _lanes_used([m[0] for m in members], n)
            slots = sum(int(torch.unique(m[1]).numel()) for m in members)
            # the output is row 0 of z, which only row 0 of x reaches: per
            # lane one slot add and one output add, per slot y's mul, add
            x_in = 0 if mode == "no_mm" else 4 * used * progs
            ops = total if mode == "no_mm" else 2 * total + 2 * slots
            stats.time("cycle_budget", f"{mode[:5]} {iters}", regroup.cycle,
                       regroup.cycle_plain, a, x_in + nbytes(out),
                       progs * ops)

    # P6-P8: the expansion's stages
    wkt, pages, pay, _, pages2 = expand_debug.inputs("cuda")
    n = pages.shape[2]
    m, rank = expand_debug.stage12(wkt, pages)
    pm, prank = expand_debug.stage12_plain(wkt, pages)
    stats.check("expand_debug_stage12", "m", m, pm)
    stats.check("expand_debug_stage12", "rank", rank, prank)
    stats.time("expand_debug_stage12", "stage12", expand_debug.stage12,
               expand_debug.stage12_plain, (wkt, pages),
               nbytes(wkt) + 4 * n + nbytes(m, rank), n)
    go, gsel = expand_debug.stage34(pay, m)
    pgo, pgsel = expand_debug.stage34_plain(pay, m)
    stats.check("expand_debug_stage34", "go", go, pgo)
    stats.check("expand_debug_stage34", "gsel", gsel, pgsel)
    nsel = int((gsel[0] != -1).sum())
    stats.time("expand_debug_stage34", "stage34", expand_debug.stage34,
               expand_debug.stage34_plain, (pay, m),
               2 * 18 * nsel + nbytes(m, go, gsel), 36 * nsel)
    m5 = expand_debug.stage5(wkt, pages2)
    stats.check("expand_debug_stage5", "m", m5,
                expand_debug.stage5_plain(wkt, pages2))
    stats.time("expand_debug_stage5", "stage5", expand_debug.stage5,
               expand_debug.stage5_plain, (wkt, pages2),
               nbytes(wkt) + 4 * pages2.shape[2] + nbytes(m5), 0)
    log(f"  stages: {nsel} of {n} lanes selected, the payload back bitwise")

    # P9: the expansion's control flow on the 256^2 leaf-64 wavefront
    ro, rd, mask_cm, mask = expand_diag2.wavefront(
        "cuda", expand_diag2.SIZE, expand_diag2.LEAF)
    pay9, otrue = expand_diag2.payload(ro, rd)
    a = (mask_cm, pay9, otrue, expand_diag2.N)
    out = expand_diag2.diag(*a)
    for what, k_, p_ in zip(("v1", "v2", "nc", "v3"), out,
                            expand_diag2.diag_plain(*a)):
        stats.check("expand_diag2", what, k_, p_)
    pop = expand_diag2.popcount(mask)
    nc_bad = int((out[2][0].long() != pop).sum())
    pairs = int(out[2].sum())
    wanting = int((out[2] > 0).sum())   # rays with a wanted cluster
    # the unpadded mask, 18 payload rows (bf16) and 6 truth rows (f32) of
    # the rays that want a cluster, every output
    stats.time("expand_diag2", "diag", expand_diag2.diag,
               expand_diag2.diag_plain, a,
               nbytes(mask, *out) + (2 * 18 + 4 * 6) * wanting,
               DIAG_OPS * pairs)
    log(f"  diag: {ro.shape[0]} rays, {ro.shape[0] // expand_diag2.N} "
        f"programs, {mask_cm.shape[0]} words, {pairs} ray-cluster round "
        f"trips; v1 max {float(out[0].max())}, v2 max {float(out[1].max())}, "
        f"v3 max {float(out[3].max())}; nc != popcount on {nc_bad} rays")
    if nc_bad:
        raise AssertionError(f"expand_diag2: {nc_bad} rays not reached by "
                             f"every wanted cluster exactly once")

    # P10, P11: the gathers, beside torch.index_select
    table, idx = pallas_gather_test.inputs("cuda")
    moved = (nbytes(idx) + table.shape[1] * 4 * int(torch.unique(idx).numel())
             + idx.shape[0] * table.shape[1] * 4)
    for name, bodies in (("pallas_gather_test", (("index", False),)),
                         ("pallas_gather_test2", pallas_gather_test2.VARIANTS)):
        for body, clip in bodies:
            a = (table, idx, clip)
            out = gather.gather_rows(*a)
            stats.check(name, body, out, gather.gather_rows_plain(*a))
            stats.check(name, f"{body} vs index_select", out,
                        torch.index_select(table, 0, idx))
            stats.time(name, body[:9], gather.gather_rows,
                       gather.gather_rows_plain, a, moved, 0)
            stats.time_library(name, body[:9],
                               lambda: torch.index_select(table, 0, idx), 10)
    k_us = graph_us_per_call(lambda: gather.gather_rows(table, idx))
    l_us = graph_us_per_call(lambda: torch.index_select(table, 0, idx))
    log(f"  gather of {idx.numel()} rows replayed from a CUDA graph (no host "
        f"work between calls): kernel {k_us:.3f} us a call "
        f"({idx.numel() / k_us:.1f} M rows/s), index_select {l_us:.3f} us; "
        f"the CUDA-event times above include each call's host work")
    log(f"phase 7: all probe kernels bitwise equal to their plain versions "
        f"({time.perf_counter() - t_start:.1f} s)")


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on the GPU")
    import raypt_torch  # noqa: F401  (fails outside a checkout of the repo)

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 2: build
    from raypt_torch.io import native
    from raypt_torch.kernels import _build
    t0 = time.perf_counter()
    native.load()
    lib = _build.kernel_lib()
    log(f"phase 2: native SAH builder and CUDA kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        for name, (n_ins, n_units) in sass_per_test(lib._name).items():
            unit = "walk step" if "walk" in name else "triangle test"
            log(f"  SASS {name}: {n_ins / n_units:.1f} instructions a {unit} "
                f"({n_ins} in its inner loop, {n_units:g} {unit}s)")
    except (OSError, subprocess.CalledProcessError) as e:
        log(f"  SASS not read: {e}")

    from functools import partial

    from raypt_torch.accel import clusters as cl
    from raypt_torch.accel.clusters import (CLUSTER_LEAF, build_clusters,
                                            intersect_worklist,
                                            tile_union_counts, tile_worklists)
    from raypt_torch.accel.ctree import build_onehot
    from raypt_torch.accel.dense import WoopTris, build_woop
    from raypt_torch.accel.host_bvh import build_sah
    from raypt_torch.accel.traverse import (DENSE_CHUNK, KERNELS as KOPS,
                                            PLAIN, find_closest_cluster,
                                            find_closest_onehot,
                                            wavefront_inputs)
    from raypt_torch.core.math3d import BIG
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.kernels import cluster_expand as ex
    from raypt_torch.kernels import cluster_pallas as dn
    from raypt_torch.kernels import compact as cp
    from raypt_torch.kernels import dense_pallas as dp
    from raypt_torch.kernels import onehot_walk as wk
    from raypt_torch.render.integrator import (make_finder, render_frame,
                                               render_sample, resolve_backend)
    from raypt_torch.rng.sampler import frame_key, key, sample_key
    from raypt_torch.scenes.builtin import stanford_bunny
    from raypt_torch.scenes.config4 import config4_scene

    builder = stanford_bunny()
    builder.camera.viewport_width = WIDTH
    builder.camera.viewport_height = HEIGHT
    scene = builder.freeze(dev)
    base = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=1,
                        num_bounces=BOUNCES, russian_roulette=True)
    cfgs = {"expand": base.replace(backend="onehot", onehot_leaf=LEAF,
                                   onehot_expand=EXPAND_N,
                                   onehot_compact=COMPACT_N),
            "dense_union": base.replace(backend="onehot",
                                        onehot_leaf=DENSE_LEAF),
            "cluster": base.replace(backend="cluster"),
            "pallas": base.replace(backend="pallas"),
            "unfused": base.replace(backend="onehot", onehot_leaf=DENSE_LEAF),
            "auto": base}
    t0 = time.perf_counter()
    m = scene.mesh
    bvh = build_sah(m)
    accels = {"expand": build_onehot(bvh, m.positions, m.faces, m.face_valid,
                                     leaf=LEAF).to(dev),
              "dense_union": build_onehot(bvh, m.positions, m.faces,
                                          m.face_valid,
                                          leaf=DENSE_LEAF).to(dev),
              "cluster": build_clusters(bvh, m.positions, m.faces,
                                        m.face_valid,
                                        leaf=CLUSTER_LEAF).to(dev)}
    accels["unfused"] = accels["dense_union"]
    accel16 = build_onehot(bvh, m.positions, m.faces, m.face_valid,
                           leaf=MULTIWORD_LEAF).to(dev)
    woop = build_woop(m.positions, m.faces, m.face_valid).to(dev)
    log(f"scene: {int(m.face_valid.sum())} faces (padded {m.num_faces}); "
        f"C = {accels['expand'].num_clusters} / "
        f"{accels['dense_union'].num_clusters} / "
        f"{accels['cluster'].num_clusters} clusters at leaf {LEAF} / "
        f"{DENSE_LEAF} / {CLUSTER_LEAF} ({accel16.num_clusters} at leaf "
        f"{MULTIWORD_LEAF}); Nt = {accels['expand'].table.shape[0]} / "
        f"{accels['dense_union'].table.shape[0]} top rows; "
        f"{int(woop.valid.sum())} Woop triangles of {woop.num_tris}; host "
        f"accel builds {time.perf_counter() - t0:.2f} s")
    skey = sample_key(frame_key(key(0), 0), 0)
    unfused_kw = dict(accel=accels["unfused"], expand_n=0, compact_n=0,
                      use_pallas_intersect=False)

    c4b = config4_scene()
    c4b.camera.viewport_width = WIDTH
    c4b.camera.viewport_height = HEIGHT
    scene4 = c4b.freeze(dev)
    m4 = scene4.mesh
    t0 = time.perf_counter()
    accel4 = build_onehot(build_sah(m4), m4.positions, m4.faces,
                          m4.face_valid, leaf=C4_LEAF, with_woop=True).to(dev)
    log(f"config4: {int(m4.face_valid.sum())} faces (padded {m4.num_faces}), "
        f"textures {tuple(scene4.textures.shape)}, equirect env "
        f"{tuple(scene4.env.data.shape)}; C = {accel4.num_clusters} clusters "
        f"at leaf {C4_LEAF}, Nt = {accel4.table.shape[0]} top rows, Woop "
        f"table {tuple(accel4.woop_cm.shape)}; host accel build "
        f"{time.perf_counter() - t0:.2f} s")
    cfgs["config4"] = RenderConfig(
        width=WIDTH, height=HEIGHT, samples_per_pixel=1,
        num_bounces=C4_BOUNCES, russian_roulette=True, enable_refraction=True,
        backend="onehot", onehot_leaf=C4_LEAF)
    accels["config4"] = accel4
    scenes = {path: scene for path in cfgs}
    scenes["config4"] = scene4
    skeys = {path: skey for path in cfgs}
    skeys["config4"] = sample_key(frame_key(key(C4_KEY), 0), 0)
    bounces = {path: cfg.num_bounces for path, cfg in cfgs.items()}

    def finder_of(path, ops=KOPS):
        """The path's finder over the scene, through the kernels or, with
        ops=PLAIN, through the plain versions."""
        if path == "unfused":
            return partial(find_closest_onehot, ops=ops, **unfused_kw)
        finder = make_finder(scenes[path], cfgs[path], accels.get(path))
        if ops is KOPS:
            return finder
        if path in ("pallas", "auto"):
            return partial(finder, ops=ops)
        if path == "cluster":
            return lambda s, ro, rd, active=None: find_closest_cluster(
                s, accels[path], ro, rd, active, ops=ops)
        cfg = cfgs[path]
        return partial(find_closest_onehot, accel=accels[path], ops=ops,
                       expand_n=cfg.onehot_expand,
                       compact_n=cfg.onehot_compact)

    pallas_mats, pallas_chunk = finder_of("pallas").args

    # phase 3: kernels vs plain versions on each path's wavefronts
    waves = {}
    for path in KERNEL_PATHS + ("config4",):
        finder = finder_of(path)
        rec = waves[path] = []

        def recording_finder(s, ro, rd, active=None, finder=finder, rec=rec):
            rec.append((ro.reshape(-1, 3).clone(), rd.reshape(-1, 3).clone(),
                        active.reshape(-1).clone()))
            return finder(s, ro, rd, active)

        with torch.no_grad():
            render_sample(scenes[path], cfgs[path], skeys[path],
                          recording_finder)
    stats = Stats()
    compare = {"expand": compare_expand, "dense_union": compare_dense_union,
               "cluster": compare_cluster, "unfused": compare_unfused,
               "config4": compare_woop,
               "pallas": lambda st, label, sc, _, ro, rd, active, timed:
               compare_pallas(st, label, sc, pallas_mats, pallas_chunk, ro,
                              rd, timed, woop)}
    for path in KERNEL_PATHS + ("config4",):
        log(f"phase 3 {path}: kernel vs plain, bitwise, per bounce wavefront")
        stats.path = path
        with SmClock() as clock:
            for b, (ro, rd, active) in enumerate(waves[path]):
                log(f"  bounce {b}: {int(active.sum())} live rays of "
                    f"{active.numel()}")
                compare[path](stats, f"bounce {b}", scenes[path],
                              accels.get(path), ro, rd, active, timed=True)
        log(f"  {path}: {clock.summary()}")
    stats.path = None
    log("phase 3 grouped: cluster_intersect_grouped on the cluster path's "
        "wavefronts")
    for b, (ro, rd, active) in enumerate(waves["cluster"]):
        compare_grouped(stats, f"bounce {b}", scene, accels["cluster"], ro, rd,
                        active, timed=True, edges=b == 1)
    log("phase 3 config4 edges: cluster_intersect_mask_woop on the bounce-0 "
        "wavefront")
    union, o, d, _, seed, kt, kp = compare_woop(
        stats, "c4 edges", scene4, accel4, *waves["config4"][0], timed=False)
    woop_edges(stats, accel4, union, o, d, seed, kt, kp)
    log("phase 3 merge rules: cluster_expand, cluster_intersect_mask and "
        "cluster_intersect_mask_woop on merge_case's synthetic clusters")
    for leaf in MERGE_LEAVES + (WOOP_ODD_LEAF,):
        for stray in (False, True):
            case = merge_case(leaf, dev, seed=leaf, stray=stray, giant=stray)
            rays = (case["ro"], case["rd"], case["seed"])
            woop_cm, fid, woop_case = woop_merge(case)
            wl, wcnt, wl_case = worklist_merge(case, stray=stray, seed=leaf)
            wargs = (wl, wcnt, case["tri_rows"], *rays)
            label = f"merge leaf {leaf}{' stray, giant' if stray else ''}"
            # name, kernel, plain version, args, planted ties, face of id
            cases = [
                ("cluster_expand", ex.cluster_expand, ex.cluster_expand_plain,
                 (case["mask_cm"], case["union_pp"], case["tri_rows"], *rays),
                 case, None),
                ("cluster_intersect_mask", dn.cluster_intersect_mask,
                 dn.cluster_intersect_mask_plain,
                 (case["union"], case["tri_rows"], *rays), case, None),
                ("cluster_intersect_mask_woop", dn.cluster_intersect_mask_woop,
                 dn.cluster_intersect_mask_woop_plain,
                 (case["union"], woop_cm, *rays), woop_case, fid),
                ("cluster_intersect", dn.cluster_intersect,
                 dn.cluster_intersect_plain, wargs, wl_case, None)]
            cases += [("cluster_intersect_grouped",
                       partial(dn.cluster_intersect_grouped, group=g),
                       partial(dn.cluster_intersect_grouped_plain, group=g),
                       wargs, wl_case, None) for g in WL_GROUPS]
            for name, kernel, plain, args, planted, ids in cases:
                if leaf == WOOP_ODD_LEAF and (
                        name != "cluster_intersect_mask_woop"):
                    continue
                kt, kf = kernel(*args)
                pt, pf = plain(*args)
                stats.check(name, f"{label} t", kt, pt)
                stats.check(name, f"{label} face", kf, pf)
                check_planted(planted, kf if ids is None else
                              woop_faces(kf, fid), f"{name} {label}")
    log(f"  leaves {MERGE_LEAVES} (the Woop kernel also {WOOP_ODD_LEAF}), "
        f"with and without stray bits and giant triangles: bitwise, the "
        f"planted ties resolved by the merge rules; the worklist kernel "
        f"(and the grouped one, G {WL_GROUPS}) on the same clusters as "
        f"worklists in descending and ascending id, with counts at, above "
        f"and below the lists' lengths, and, with the stray bits, ids "
        f"outside [0, C) and counts above cap")
    bad, first_bad = dn.inv_det_sweep()
    if bad:
        raise AssertionError(f"1 / det: the kernels' reciprocal differs from "
                             f"the division on {bad} bit patterns (first "
                             f"{first_bad:#010x})")
    log("  1 / det: the kernels' reciprocal (its fast path, __frcp_rn where "
        "|det| >= 2^126) bitwise equal to the division on all 2^32 bit "
        "patterns of det")

    # edge cases on the bounce-1 wavefronts
    ro, rd, active = waves["expand"][1]
    edge = active.clone()
    edge[:COMPACT_N] = False
    edge[COMPACT_N:2 * COMPACT_N] = True
    compare_expand(stats, "edge grps", scene, accels["expand"], ro, rd, edge,
                   timed=False)
    cwp16 = -(-accel16.num_clusters // 256) * 8
    nw16 = -(-accel16.num_clusters // 32)
    log(f"  multi-word: leaf {MULTIWORD_LEAF}, C = {accel16.num_clusters}, "
        f"cwp = {cwp16}, union and mask-only words {nw16}, Nt = "
        f"{accel16.table.shape[0]}")
    for path, cmp, acc in (("expand", compare_expand, accel16),
                           ("dense_union", compare_dense_union, accel16),
                           ("cluster", compare_cluster, accel16.clusters),
                           ("unfused", compare_unfused, accel16)):
        ro, rd, active = waves[path][1]
        cmp(stats, "multiword", scene, acc, ro[:MULTIWORD_RAYS].contiguous(),
            rd[:MULTIWORD_RAYS].contiguous(),
            active[:MULTIWORD_RAYS].contiguous(), timed=False)
    # the mask-only walk on a dead, a one-live and a last-warp-only block
    for acc, what in ((accels["unfused"], f"leaf {DENSE_LEAF}"),
                      (accel16, f"leaf {MULTIWORD_LEAF}")):
        ro, rd, active = waves["unfused"][1]
        compare_unfused(stats, "layouts", scene, acc, ro, rd,
                        walk_layouts(active), timed=False)
        log(f"  walk layouts ({what}): a dead, a one-live and a "
            f"last-warp-only block, bitwise")
    for path, cmp in (("dense_union", compare_dense_union),
                      ("cluster", compare_cluster)):
        ro, rd, active = waves[path][1]
        dead = active.clone()
        dead[:dn.TILE] = False       # the first tile: every ray dead
        out = cmp(stats, "dead tile", scene, accels[path], ro, rd, dead,
                  timed=False)
        if path == "dense_union" and bool(out[0].any()):
            raise AssertionError("a tile of dead rays has a nonzero union")
    # the cluster finder at cap 8: tiles overflow into the fallback
    ro, rd, active = waves["cluster"][1]
    clusters = accels["cluster"]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    n_over = int(tile_worklists(clusters, o, d, seed, dn.TILE,
                                OVERFLOW_CAP)[2].sum())
    if n_over == 0:
        raise AssertionError(f"no tile overflows at cap {OVERFLOW_CAP}")
    t0 = time.perf_counter()
    k = find_closest_cluster(scene, clusters, ro, rd, active, cap=OVERFLOW_CAP)
    p = find_closest_cluster(scene, clusters, ro, rd, active, cap=OVERFLOW_CAP,
                             ops=PLAIN)
    for what, x, y in (("t", k.t, p.t), ("tri", k.tri, p.tri),
                       ("sphere", k.sphere, p.sphere)):
        stats.check("cluster_intersect", f"overflow {what}", x, y)
    log(f"  overflow: cap {OVERFLOW_CAP}, {n_over} of {o.shape[0] // dn.TILE} "
        f"tiles overflow; finder through kernels and plain bitwise equal "
        f"({time.perf_counter() - t0:.1f} s for both)")
    # the fallback's worklist intersection (every ray of an overflowed
    # tile against every cluster) at 2^22 and at STEP_PAIRS pairs a step
    ov = torch.nonzero(tile_worklists(clusters, o, d, seed, dn.TILE,
                                      OVERFLOW_CAP)[2]).flatten()
    rays = (ov[:, None] * dn.TILE + torch.arange(dn.TILE, device=dev)
            ).flatten()
    every = torch.arange(clusters.num_clusters, dtype=torch.int32,
                         device=dev).expand(ov.numel(), -1)
    fb_args = (clusters, every, o[rays].contiguous(), d[rays].contiguous(),
               seed[rays].contiguous(), dn.TILE)
    step_pairs = cl.STEP_PAIRS
    fb_out = []
    for pairs in (1 << 22, step_pairs):
        cl.STEP_PAIRS = pairs
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fb_out.append(intersect_worklist(*fb_args))
        torch.cuda.synchronize()
        log(f"  overflow fallback's intersect_worklist at {pairs} pairs a "
            f"step: {time.perf_counter() - t0:.3f} s, peak "
            f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.0f} MiB "
            f"above the {held / 2**30:.2f} GiB held ({rays.numel()} rays x "
            f"{clusters.num_clusters} clusters)")
    cl.STEP_PAIRS = step_pairs
    for x, y in zip(*fb_out):
        if not bitwise_equal(x, y)[0]:
            raise AssertionError("intersect_worklist depends on its step")
    # closest_dense: a tile of rays that hit nothing (from far outside the
    # scene, pointing away)
    ro, rd, _ = waves["pallas"][1]
    away_o, away_d = ro.clone(), rd.clone()
    away_o[:dp.RAY_TILE] = 1e4
    away_d[:dp.RAY_TILE] = 3.0 ** -0.5
    kt, kf = compare_pallas(stats, "miss tile", scene, pallas_mats,
                            pallas_chunk, away_o, away_d, timed=False)
    if bool((kf[:dp.RAY_TILE] >= 0).any()) or \
            bool((kt[:dp.RAY_TILE] != BIG).any()):
        raise AssertionError("closest_dense: a ray of the miss tile hit")
    # duplicated triangles: copies of the most-hit faces in free slots of
    # the chunk of their source (a tie within a chunk) and of a later
    # chunk (a tie across chunks); the lowest id must win, so the result
    # equals the one without copies, bitwise
    ro, rd, _ = waves["pallas"][0]
    base_t, base_f = compare_pallas(stats, "no copies", scene, pallas_mats,
                                    pallas_chunk, ro, rd, timed=False)
    dup, src = copy_most_hit(pallas_mats, pallas_chunk, base_f, 32)
    dt, dfc = compare_pallas(stats, "copies", scene, dup, pallas_chunk, ro,
                             rd, timed=False)
    tied = int(torch.isin(base_f, src).sum())
    if not (torch.equal(dt.view(torch.int32), base_t.view(torch.int32))
            and torch.equal(dfc, base_f)) or tied == 0:
        raise AssertionError("closest_dense: copies of triangles changed "
                             "the result (the lowest id must win a tie)")
    log(f"  copies: 32 faces copied within their chunk, 32 into chunk "
        f"{pallas_mats[0].shape[1] // pallas_chunk - 1}; {tied} rays hit a "
        f"copied face, result unchanged")
    # tables of one chunk exactly and of a size that needs padding
    host_woop = woop.to("cpu")
    for n in (pallas_chunk, 1000):
        sub = WoopTris(m=host_woop.m[:n], c=host_woop.c[:n],
                       valid=host_woop.valid[:n]).to(dev)
        chunk = dp.pick_tri_chunk(n)
        mats = dp.prepare_woop_mats(sub, chunk)
        _, f = compare_pallas(stats, f"T={n}", scene, mats, chunk, ro, rd,
                              timed=False)
        log(f"  table of {n} triangles: chunk {chunk}, padded to "
            f"{mats[0].shape[1]}; {int((f >= 0).sum())} hits")
    # zero maps among the real triangles, at 256 slots and at all the
    # table's, on rays of one tile and of the whole bounce-0 wavefront,
    # every 5th seeded -BIG, nan or 1e-6
    o, d, t, _, _, _ = wavefront_inputs(scene, *waves["pallas"][0][:2], None,
                                        dp.RAY_TILE)
    t, fixed = edge_seeds(t)
    for n in (256, pallas_mats[0].shape[1]):
        mats, zero = zero_maps_table(pallas_mats, n)
        chunk = dp.pick_tri_chunk(n)
        for r in (dp.RAY_TILE, o.shape[0]):
            args = (*mats, o[:r], d[:r], t[:r])
            kt, kf = dp.closest_dense(*args, tri_chunk=chunk)
            pt, pf = dp.closest_dense_plain(*args, tri_chunk=chunk)
            label = f"zero maps T={n} R={r}"
            stats.check("closest_dense", f"{label} t", kt, pt)
            stats.check("closest_dense", f"{label} face", kf, pf)
            fx = fixed[:r]
            if not (bitwise_equal(kt[fx], t[:r][fx])[0]
                    and bool((kf[fx] == -1).all())) or \
                    bool(zero[kf[kf >= 0].long()].any()):
                raise AssertionError(f"closest_dense {label}: a fixed seed "
                                     f"changed or a zero map was hit")
        before = int((pallas_mats[2][:, :n] == 0).all(dim=0).sum())
        log(f"  zero maps: {int(zero.sum())} of {n} slots, "
            f"{int(zero.sum()) - before} of them written over real "
            f"triangles; rays of one tile and all {o.shape[0]}: bitwise, "
            f"fixed seeds kept")
    log("phase 3: all comparisons bitwise equal")

    # phase 4: each path through its kernels
    counters = {"alive_compact": cp.alive_compact,
                "topwalk_cm_u": wk.topwalk_cm_u,
                "cluster_expand": ex.cluster_expand,
                "alive_uncompact": cp.alive_uncompact,
                "topwalk_union": wk.topwalk_union,
                "cluster_intersect_mask": dn.cluster_intersect_mask,
                "cluster_intersect": dn.cluster_intersect,
                "closest_dense": dp.closest_dense,
                "topwalk_cm": wk.topwalk_cm,
                "cluster_intersect_mask_woop": dn.cluster_intersect_mask_woop,
                "cluster_intersect_grouped": dn.cluster_intersect_grouped,
                **probe_counters()}
    launches = {k: 0 for k in KERNELS}
    images = {}
    for path, cfg in cfgs.items():
        finder = finder_of(path)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            img, traced = render_sample(scenes[path], cfg, skeys[path], finder,
                                        return_alive=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        log(f"phase 4 {path}: launches {counts}")
        kpath = SAME_FINDER.get(path, path)
        for k, n in counts.items():
            want = bounces[path] if kpath in KERNELS[k][0] else 0
            if n != want:
                raise AssertionError(f"{path}: {k} launched {n} times, "
                                     f"expected {want}")
            if want and path in KERNELS[k][0]:
                launches[k] += n
        if not bool(torch.isfinite(img).all()) or img.shape != (HEIGHT, WIDTH,
                                                               3):
            raise AssertionError(f"{path}: bad image {tuple(img.shape)}")
        log(f"phase 4 {path}: traced_per_bounce {traced.tolist()}, image mean "
            f"{float(img.mean()):.6f} ({secs:.2f} s)")
        images[path] = (img, traced)
        if path in SAME_FINDER:
            ref = f"the {kpath} render"
            if resolve_backend(scene, cfg) != "dense":
                raise AssertionError(f"{path}: resolves to "
                                     f"{resolve_backend(scene, cfg)!r}")
            img_plain, traced_plain = images[kpath]
        else:
            ref = "the plain-finder render"
            with torch.no_grad():
                img_plain, traced_plain = render_sample(
                    scenes[path], cfg, skeys[path], finder_of(path, PLAIN),
                    return_alive=True)
        eq, err = bitwise_equal(img, img_plain)
        if not eq or not torch.equal(traced, traced_plain):
            raise AssertionError(f"{path}: render differs from {ref} (max "
                                 f"abs err {err})")
        log(f"phase 4 {path}: image bitwise equal to {ref}")

    # phase 5: cross-checks on the card
    acc = accels["dense_union"]
    nw = -(-acc.num_clusters // 32)
    cwp = -(-acc.num_clusters // 256) * 8
    for b, (ro, rd, active) in enumerate(waves["dense_union"]):
        o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
        mask_cm, union_pp = wk.topwalk_cm_u(acc.table, o, d, t, a, cwp)
        folded, _ = tile_union_counts(mask_cm[:nw].T.contiguous(), dn.TILE)
        if not torch.equal(folded, wk.topwalk_union(acc.table, o, d, t, a,
                                                    nw)):
            raise AssertionError(f"bounce {b}: topwalk_union differs from the "
                                 f"tile fold of topwalk_cm_u's masks")
        seed = torch.where(a, t, torch.full_like(t, -BIG))
        rows = acc.clusters.tri_rows
        ta, fa = dn.cluster_intersect_mask(folded, rows, o, d, seed)
        tb, fb = ex.cluster_expand(mask_cm, union_pp, rows, o, d, seed)
        for what, x, y in (("t", ta, tb), ("face", fa, fb)):
            eq, err = bitwise_equal(x, y, where=a)
            if not eq:
                raise AssertionError(f"bounce {b}: cluster_intersect_mask and "
                                     f"cluster_expand differ on live {what} "
                                     f"(max abs err {err})")
    log("phase 5: topwalk_union == fold of topwalk_cm_u's masks, and "
        "cluster_intersect_mask == cluster_expand on live rays, bitwise, "
        "on all four dense-union wavefronts")
    cfg384 = cfgs["dense_union"].replace(onehot_leaf=LEAF)
    with torch.no_grad():
        img384, tr384 = render_sample(scene, cfg384, skey,
                                      make_finder(scene, cfg384,
                                                  accels["expand"]),
                                      return_alive=True)
    eq, err = bitwise_equal(img384, images["expand"][0])
    if not eq or not torch.equal(tr384, images["expand"][1]):
        raise AssertionError(f"the dense-union render at leaf {LEAF} differs "
                             f"from the expand render (max abs err {err})")
    log(f"phase 5: dense-union render at leaf {LEAF} bitwise equal to the "
        f"expand render")
    for b, (ro, rd, active) in enumerate(waves["unfused"]):
        o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
        if not torch.equal(wk.topwalk_cm(acc.table, o, d, t, a, nw),
                           wk.topwalk_cm_u(acc.table, o, d, t, a, cwp)[0][:nw]):
            raise AssertionError(f"bounce {b}: the mask-only walk differs from "
                                 f"topwalk_cm_u's first {nw} words")
    log(f"phase 5: topwalk_cm == topwalk_cm_u's first {nw} of {cwp} words, "
        f"bitwise, on all four non-fused wavefronts")
    for b, (ro, rd, _) in enumerate(waves["pallas"]):
        o, d, t, _, _, _ = wavefront_inputs(scene, ro, rd, None, dp.RAY_TILE)
        kt, kf = dp.closest_dense(*pallas_mats, o, d, t,
                                  tri_chunk=pallas_chunk)
        mt, mf = matmul_closest(woop, o, d, t)
        same = kf == mf
        hit = same & (kf >= 0)
        err = (kt - mt).abs()
        far = hit & (err > DENSE_T_TOL * (1.0 + mt.abs()))
        # hold the rays where they disagree against float64 tests
        tr = torch.nonzero(far).flatten()
        t64 = hit64(scene, o[tr], d[tr], kf[tr])[0]
        k_err = (kt[tr].double() - t64).abs()
        m_err = (mt[tr].double() - t64).abs()
        fr = torch.nonzero(~same).flatten()

        def nearest64(face, fr=fr, o=o, d=d):
            t_, inside = hit64(scene, o[fr], d[fr], face.clamp(min=0))
            return torch.where((face >= 0) & inside, t_,
                               torch.full_like(t_, torch.inf))

        tk, tm = nearest64(kf[fr]), nearest64(mf[fr])
        log(f"phase 5: closest_dense vs matmul_closest, bounce {b}: faces "
            f"differ on {fr.numel()} of {same.numel()} rays (float64 test: "
            f"nearer hit on the kernel's face {int((tk < tm).sum())}, on the "
            f"matmul's {int((tm < tk).sum())}, neither "
            f"{int((tk == tm).sum())}); same face, t beyond DENSE_T_TOL on "
            f"{tr.numel()} (nearer the float64 t: the kernel's "
            f"{int((k_err < m_err).sum())}, the matmul's "
            f"{int((m_err < k_err).sum())}; largest |t - t64| kernel "
            f"{float(k_err.max()) if tr.numel() else 0.0:.3e}, matmul "
            f"{float(m_err.max()) if tr.numel() else 0.0:.3e}); on equal "
            f"faces max |dt| {float(err[hit].max()):.3e}, max |dt| / "
            f"(1 + |t|) {float((err / (1.0 + mt.abs()))[hit].max()):.3e}")
        if fr.numel() + tr.numel() > DENSE_SHARE * same.numel():
            raise AssertionError(f"bounce {b}: closest_dense and "
                                 f"matmul_closest disagree on "
                                 f"{fr.numel() + tr.numel()} rays, more than "
                                 f"DENSE_SHARE")
    ro, rd, active = (x[:MULTIWORD_RAYS].contiguous()
                      for x in waves["unfused"][1])
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    counts = tile_union_counts(wk.topwalk(acc.table, o, d, t, a, nw),
                               dn.TILE)[1]
    n_over = int((counts > UNFUSED_CAP).sum())
    if n_over == 0:
        raise AssertionError(f"no tile's union exceeds cap {UNFUSED_CAP}")
    t0 = time.perf_counter()
    results = [find_closest_onehot(scene, ro, rd, active, ops=ops,
                                   **dict(unfused_kw, cap=cap))
               for ops, cap in ((KOPS, UNFUSED_CAP), (PLAIN, UNFUSED_CAP),
                                (KOPS, 0))]
    for other in results[1:]:
        for what in ("t", "tri", "sphere"):
            eq, err = bitwise_equal(getattr(results[0], what),
                                    getattr(other, what))
            if not eq:
                raise AssertionError(f"non-fused finder at cap {UNFUSED_CAP}: "
                                     f"{what} differs (max abs err {err})")
    log(f"phase 5: non-fused finder at cap {UNFUSED_CAP} on {MULTIWORD_RAYS} "
        f"bounce-1 rays: {n_over} of {counts.numel()} tiles overflow (largest "
        f"union {int(counts.max())}, {-(-int(counts.max()) // UNFUSED_CAP)} "
        f"rounds); bitwise equal through kernels and plain versions and to "
        f"the default cap ({time.perf_counter() - t0:.1f} s for the three)")
    compare_finders_woop_mt(scene4, accel4, waves["config4"])

    # phase 6: the bench loss forward and backward; forward only on the
    # non-fused path, whose worklist intersection is plain torch (the auto
    # path runs the pallas path's finder)
    for path in ("expand", "dense_union", "cluster", "pallas", "config4"):
        bench_loss(path, scenes[path], cfgs[path], skeys[path],
                   accels.get(path))

    # the config-4 frame: C4_SPP samples through render_frame, as
    # scripts/baseline_config4.py renders it
    cfg4f = cfgs["config4"].replace(samples_per_pixel=C4_SPP)
    finder4 = make_finder(scene4, cfg4f, accel4)

    def frame():
        with torch.no_grad():
            return render_frame(scene4, cfg4f, key(C4_KEY), finder=finder4)

    frame_s = seconds(frame)
    img = frame()
    traced = 0
    with torch.no_grad():
        for i in range(C4_SPP):
            traced += int(render_sample(
                scene4, cfg4f, sample_key(frame_key(key(C4_KEY), 0), i),
                finder4, return_alive=True)[1].sum())
    med = statistics.median(frame_s)
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("config4: the frame is not finite")
    log(f"phase 6 config4 frame: {C4_SPP} spp, {C4_BOUNCES} bounces, s "
        f"{[round(x, 4) for x in frame_s]} median {med:.4f}; upper-bound "
        f"rate {WIDTH * HEIGHT * C4_SPP * C4_BOUNCES / med / 1e6:.3f} "
        f"Mray-seg/s; traced segments {traced} -> {traced / med / 1e6:.3f} "
        f"Mray-seg/s; image mean {float(img.mean()):.6f}")

    def fwd():
        with torch.no_grad():
            return float(render_sample(scene, cfgs["unfused"], skey,
                                       finder_of("unfused")).mean())

    fwd_s = seconds(fwd)
    log(f"phase 6 unfused: forward only, fwd s {[round(x, 4) for x in fwd_s]} "
        f"median {statistics.median(fwd_s):.4f}")

    def outside_scene():
        b = stanford_bunny()
        b.camera.viewport_width = b.camera.viewport_height = GRAD_WIDTH
        for k, val in GRAD_VIEW.items():
            setattr(b.camera, k, val)
        return b.freeze("cpu")

    def config4_view():
        b = config4_scene()
        b.camera.viewport_width = b.camera.viewport_height = GRAD_WIDTH
        return b.freeze("cpu")

    for path, build in (("expand", outside_scene), ("pallas", outside_scene),
                        ("config4", config4_view)):
        gcfg = cfgs[path].replace(width=GRAD_WIDTH, height=GRAD_WIDTH)
        log(f"phase 6: card vs CPU gradients, {path} path")
        grad_check(build,
                   lambda s, gcfg=gcfg, acc=accels.get(path),
                   k=skeys[path]: render_sample(
                       s, gcfg, k, make_finder(s, gcfg, acc)),
                   dev, "outside view" if build is outside_scene else
                   "config4's view")

    # phase 7: the scripts/ probes
    probes_phase(stats)

    for path, ms in stats.topwalk_ms.items():
        log(f"topwalk_cm and its transpose (pallas_topwalk's counterpart), "
            f"{path}: {ms:.4f} ms per frame")
    for name, (paths, _, _) in KERNELS.items():
        if len(paths) > 1:
            for path in paths:
                k_ms, p_ms, b_ms, n = stats.by_path[(name, path)]
                log(f"{name}, {path}: {k_ms:.4f} ms per frame ({n} launches "
                    f"timed), plain {p_ms:.3f}, bound {b_ms:.4g}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": stats.err[k],
         "ms": sig6(stats.ms[k]), "plain_ms": sig6(stats.plain_ms[k]),
         "bound_ms": sig6(stats.bound_ms[k]),
         "bound_by": stats.bound_by(k),
         "library_ms": (None if stats.library_ms[k] is None
                        else sig6(stats.library_ms[k]))}
        for k, (_, src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
