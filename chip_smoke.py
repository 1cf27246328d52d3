#!/usr/bin/env python3
"""Drive raypt_torch's render paths once on one NVIDIA GPU and
check them, phase by phase; any failure raises and the exit code is not
0. Seven paths render the bench scene (stanford_bunny at 1024^2, 1 spp, 4
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
               topwalk (the mask-only walk's ray-major mode), then tile
               unions and ascending-id worklists in torch,
               intersect_worklist (the worklist test of the JAX
               package's XLA intersect_worklist_jnp, with its rules,
               behind a conservative per-ray cluster cull)
  auto         RenderConfig's default backend, which resolves to "dense"
               for this mesh; the port serves "dense" with the pallas
               path's finder: closest_dense
  bvh          backend "bvh" over the packed table of the LBVH built on
               the card (lbvh.build, pack): packed_walk, the skip-link
               walk (an XLA loop in the JAX package, not a Pallas kernel)
               over the split table it derives from the rows, with the
               SIMD efficiency and mixed warp steps of the first kernel's
               (pr12) schedule
               and of its own logged a timed bounce

and a seventh renders the config-4 scene (scripts/baseline_config4.py:
config4_scene at 1024^2, 8 bounces, roulette, refraction, key 7):

  config4      backend "onehot" with build_onehot(build_sah(mesh),
               leaf=128, with_woop=True), the finder's Woop branch:
               topwalk (then the tile unions in torch),
               cluster_intersect_mask_woop

cluster_intersect_grouped lies on no path, as in the JAX package: phase 3
holds it on the cluster path's wavefronts against its plain version and
against cluster_intersect.

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions
  2. build the native SAH builder and the CUDA kernels from source (one
     nvcc per source, all started together); then the LBVH build on the
     card against the build on the CPU, bitwise (left, skip, leaf_face,
     boxes), and so refit after a seeded jitter and pack (check_lbvh, on
     the bench mesh here and on phase 8's meshes), with the card's build
     seconds and the tree's depth (at most 64)
  3. each kernel against its plain torch version on the card, bitwise,
     on the wavefronts of all four bounces of its path, with CUDA-event
     times (kernel mean of 10, plain of 2, summed over the bounces; the
     expand path's compaction, walk and uncompaction and the union walk
     also replayed from CUDA graphs, their device time without the
     wrappers' host work) and the bound of each launch; then edge cases:
     all-dead and all-alive compaction groups, compaction and
     uncompaction at the groups of COMPACT_EDGE_GROUPS (one below the
     kernel's chunk, one a multiple of neither 16 lanes nor the chunk)
     with all lanes dead, all alive, only each group's
     last lane alive, alternating lanes and the wavefront's own, and from
     a mask that is not 16-byte aligned, a tile of dead rays and a tile
     of one repeated ray for the union walk, the leaf-16 accel (1,026
     clusters: 40 mask words, 33 union words) on 65,536 rays, the
     cluster finder at cap 8, where tiles overflow into its fallback
     (intersect_worklist's kernel, held on the overflowed tiles against
     its plain version, which is also timed, with its peak memory, at
     2^22 and at STEP_PAIRS pairs a step), intersect_worklist on
     worklist_edges' cases (-1 gaps, a repeated id, an all -1 and an
     all-dead tile, a coincident triangle in a later lane, a tie across
     two slots) on 65,536 rays of the unfused path and on cull_edges'
     (rays grazing a triangle at |det| of 1-3 x 1e-8, origins 10^3-10^4
     edge lengths away, hits on vertices and edge midpoints, a table of
     zero rows, slivers, a one-triangle, an empty and a mixed-normal
     cluster). Wherever intersect_worklist is checked (the unfused
     wavefronts, the fallback, these cases, phase 5's use_pallas=False)
     it also runs in its audit mode (cull_audit): every (ray, cluster)
     pair its cull skipped is tested in full, and a skipped pair whose
     hit the merge would have taken fails the phase, as do pre-pass
     records that differ from worklist_cull_prep_plain's and live or
     kept pair counts that differ from intersect_worklist_culled_plain's
     on the same inputs; the log gives the pairs the cull kept. The
     kernel's bound counts the kept pairs' tests, the cull of every live
     pair and the pre-pass; the log gives, as information, the bound had
     every live pair been tested. A tile of rays that hit
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
     (walk_layouts) at leaves 128 and 16, topwalk_cm_u on the same
     blocks at leaves 384 and 16 and on a compacted wavefront whose
     walk tile mixes live, part-live and dead 256-ray blocks
     (mixed_tile), packed_walk on walk_edges' cases (dead rays, rays
     that hit nothing, seeds nearer than every triangle, direction
     components of +-0, NaN rays, rays in a triangle's plane, step
     caps of 0, 3, 17 and 32 steps, 32 triangles copied into padded
     slots, and a toy table whose internal
     boxes are all (-BIG, BIG), so every ray walks every row, padded
     degenerate leaves included), and the kernels' 1 / det (the
     correctly rounded reciprocal) against the
     division over all 2^32 bit patterns (inv_det_sweep). The SM clock is
     sampled (nvidia-smi) while each path's kernels are timed; phase 2
     reads the instructions a triangle test takes in each intersection
     kernel's inner loop (the union template's four instances, the
     expansion, closest_dense), and a walk step in the mask-only,
     union, mask-and-union and packed walks', from cuobjdump -sass of the
     built library, and the packed walk's registers and resident warps
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
     default-cap results; then options_phase: the onehot finder's
     options (sort_rays "alive", "mask", True; segment_sort 2048 and a
     non-divisor; tile_b 128 and 512; walk_tile 512 and 128;
     overflow_fallback off on the non-fused branch) on the dense-union
     path's bounce-1 wavefront, each bitwise the result without it,
     with its launches and its forward ms beside the default's, and the
     dense-union forward frame with it (bitwise the default frame, its
     median seconds beside the default's); the
     compaction at one group of all 2^20 lanes against its plain
     version; and find_closest_cluster(use_pallas=False) through the
     kernel against PLAIN, timed beside use_pallas=True
  6. the bench loss (mean image) forward and backward w.r.t. mesh
     positions and material albedo on every path but auto (the pallas
     path's finder) and unfused (forward only there, through
     intersect_worklist's kernel), on the bvh path
     with the grads through the kernel and plain finders bitwise equal:
     finite grads, nonzero albedo grad, median
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
     torch.index_select (their library_ms; both also replayed from CUDA
     graphs, the device time without the host work), cycle_budget,
     sel_probe, both permute probes and the expansion diagnostics also
     from CUDA graphs (every call; sel_probe's and the permute probes'
     bounds with and without their ranks' integer operations), and the
     expansion diagnostics' v1/v2/v3 maxima and rays whose cluster count
     is not their mask's popcount (which fails the phase)
  8. the bvh backend beyond the bench path, each render with the launch
     counts set to 0 before it and read after it, and bitwise against
     the same render through the plain finder: cli_default, the CLI's
     default render through the API (cornell_box_with_bunny at 512^2,
     5 spp, 6 bounces, "auto" with the card's LBVH passed in, which
     resolves to "bvh": 30 packed_walk launches a frame); bvh_large, the
     bench scene with _icosphere(6) (81,922 faces in 90,112 slots) in
     place of the 5,120-triangle stand-in, "auto" with no accel (so
     "bvh" by face count; make_finder builds the LBVH on the card), at
     1024^2, 1 spp, 4 bounces; and make_finder with "onehot" (leaf 128,
     expand 0) and "cluster" given no accel, which build the LBVH on the
     card, bounce 0 through their kernels
  9. fit: BASELINE config #5's fit step (scripts/baseline_config5.py's
     final phase on one card: 80^2, 1 spp, 2 bounces, bvh, 16 orbit
     views, lattice 10, the Laplacian prior at 3.0, the rgbd loss, Adam
     at 0.03) through raypt_torch.diff.make_fit_step with a refit every
     step, on _icosphere(6) (81,920 faces in 81,920 slots: no ground)
     placed where the bunny stands: five steps through the packed walk's kernel, each
     with its seconds and exactly 48 packed_walk launches (16 views x 3:
     2 bounces and render_rgbd's depth pass); the loss falls; the first
     two steps through the plain walk and a second five-step run are
     bitwise equal to it (losses and every parameter); each step's
     table is pack(refit(...)) of its positions, every triangle lies in
     its leaf box and the boxes moved; then raypt_torch.diff.fit, the
     loop's entry point, for two steps at its defaults (32 launches a
     step, a second call bitwise equal); refit + pack timed alone and
     one step traced with torch.profiler
 10. the CLI and bvh4: the bench scene's LBVH collapsed on the card into
     the 4-wide tree (accel.wide.collapse); wide_walk, the ordered-stack
     walk (csrc/wide_walk.cu, an XLA loop in the JAX package), against
     its plain version, bitwise (t, face, overflow), on the bench
     render's four bvh4 wavefronts (timed through the wrapper and from
     CUDA graphs, with its bound from the visits the plain walk counts),
     on bvh_large's four (its LBVH built and collapsed on the card; the
     kernel timed through the wrapper and from graphs, the plain walk
     only checked), on wide_edges' (dead rays, signed-zero and sub-clamp
     directions, origins in leaf boxes, NaN rays, a NaN vertex in the
     leaves and in the boxes, stacks of 2 and 4, where rays overflow) and
     on deep_stack_case's, whose stacks the plain walk's record shows
     deeper than 32 entries, also at stacks of DEEP_STACKS (31, 32 and
     33) entries;
     find_closest_wide at a stack of 2 (its
     retry: two launches) against the plain finder; the bench render
     with backend "bvh4" (one launch a bounce) bitwise against the plain
     walk's. Then raypt_torch.app.cli.main in-process on the card:
     render at the CLI's defaults (cornell_bunny, 512^2, 5 spp, 6
     bounces, auto with the LBVH: 30 packed_walk launches) bitwise
     against render_frame with the same accel, --backend bvh4 (30
     wide_walk launches) likewise, --backend onehot (the bench path's
     four kernels, 30 launches each), --frames 1 --checkpoint twice
     against --frames 2, --aovs --check (the default's image), inverse
     on cornell_bunny at 32^2 for 3 steps (bvh: 8 packed_walk
     launches), and bench, which exits non-zero naming its ROADMAP item
 11. dist (raypt_torch.dist): (a) in this process on a one-rank NCCL
     group, render_frame_sharded of the bench scene at 1024^2 through bvh
     (the card's LBVH: 4 packed_walk launches) and through the expand
     path's onehot accel (its four kernels, 4 launches each), bitwise
     against render_frame with the same accel; loss_and_grad_sharded
     (positions and albedo, bvh) bitwise against plain autograd of the
     same loss; two make_fit_step_sharded steps bitwise against phase
     9's make_fit_step (48 launches a step). (b) Two rank processes
     sharing the card over gloo with the launcher's env (dist_rank):
     the launcher's render at its defaults (cornell_bunny, 512^2, 4 spp,
     4 bounces, bvh: 16 packed_walk launches a rank) bitwise against
     render_frame on both ranks; its bench (Mray-seg/s); three view-
     sharded fit steps of config #5 over 2 ranks x 8 views (24 launches
     a rank a step), each step's loss and summed gradients within
     DIST_LOSS_RTOL / DIST_GRAD_RTOL of the one-process step from the
     same parameters and Adam state, the parameters bitwise equal across
     the ranks and a second run bitwise equal; a rank that fails or
     outlasts DIST_PROC_TIMEOUT fails the phase
 12. layouts: the packed table's other layouts, each walked by its
     kernel of csrc/packed_layouts.cu (XLA loops in the JAX package):
     packed_walk2 (leaf_tris=2, the cherry table), packed_walk_la
     (node_lookahead, the lookahead table), packed_walk4 and
     packed_walk4_la (leaf_tris=4, the quad table, plain or lookahead
     internal rows), on their tables of the card's LBVH: against their
     plain walks, bitwise, on the bvh path's four wavefronts (timed,
     also from graphs, with the bound, the kernels' registers and the
     SASS of their walks; each kernel's split-table build timed apart,
     from graphs, and held bitwise against its plain model
     accel.packed.slot_table, its walk against traverse_slots on
     bounce 1), on bvh_large's four (timed), on edge cases
     (layout_edges: dead, missing, near-seeded, signed-zero, NaN and
     in-plane rays, a NaN vertex, planted ties with their winners,
     invalid faces, meshes of 1-5 triangles); the bench render with each layout's flags (4
     launches of its kernel, bitwise the plain walk's render, the hits
     within the JAX tests' rule of packed_walk's); traversal_mode
     "compact" on the five tables (one launch a bounce, bitwise the
     tiled render; the plain compacting walk bitwise the kernel); and
     one config #5 fit step with leaf_tris=4 (48 packed_walk4 launches)

The last line is {"ok": true, "device": {...}}; the line before it is
the per-kernel JSON summary: "ms", "plain_ms" and "bound_ms" are summed
over the bounce wavefronts of the kernel's paths (one frame's worth of
launches of each: four, eight on config4; topwalk's (and topwalk_cm's,
which no path launches) over the unfused path's four and
config4's eight, which the log also gives apart; the
grouped kernel's on the cluster path's four), "launches" are counted in
those paths' renders of phase 4 (0 for cluster_intersect_grouped, which
no path runs; wide_walk's in phase 10's bvh4 render; the layout walks'
in phase 12's renders, their times on the bvh path's wavefronts);
closest_dense's
"library_ms" is matmul_closest, the same closest hit through
torch.matmul, and cluster_intersect_mask_woop's is matmul_woop, through
torch.bmm, on the same wavefronts (several calls each: no one torch
call computes either). A probe's "ms", "plain_ms", "bound_ms" and
"library_ms" are summed over the modes and cycle counts of phase 7, its
"launches" are 0 (no render path runs it). Times are given to six
significant digits.
Run: python3 chip_smoke.py
"""
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
from functools import partial

WIDTH = HEIGHT = 1024
BOUNCES = 4
LEAF = 384
EXPAND_N = 8192
COMPACT_N = 32768
DENSE_LEAF = 128          # RenderConfig's default onehot_leaf
MULTIWORD_LEAF = 16
MULTIWORD_RAYS = 65536
CULL_EDGE_RAYS = 4096     # rays of each of cull_edges' cases
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
# float64 operations/s outside the tensor cores (the same data sheet;
# the on-chip guide's table has no f64 row): the worklist cull's slab
# test and its pre-pass run in f64
F64_OPS_PER_S = 34e12
# int32 operations/s outside the tensor cores (the H100 SXM's INT32 peak,
# NVIDIA's Hopper architecture white paper: half the f32 rate, 64 INT32
# lanes an SM against 128 FP32); like the f32 peak it counts a
# multiply-add as two, so it is a floor for adds and compares. sel_probe's
# rank is integer work
INT32_OPS_PER_S = 33.5e12
# f32 operations of one walk step (12 slab sub/mul, 10 min/max, 8
# compares, 15 for the three link/id decodes) and of one ray-triangle
# Moller-Trumbore test with its merge (cluster_test.cuh: 50 arithmetic,
# 7 compares and selects). Only live rays need tests: a dead ray is
# seeded -BIG, so no hit can replace its result. The mask-only and
# union walks (mask_walk.cuh) decode each row once a block that has a
# live ray, so their steps take WALK_OPS - ROW_DECODE_OPS each and their
# rows ROW_DECODE_OPS once a busy block.
WALK_OPS = 45
ROW_DECODE_OPS = 15
WALK_BLOCK = 256   # rays a block of the walk kernels (onehot_walk.cu kThreads)
MT_OPS = 57
# The worklist cull (csrc/worklist_cull.cuh: rk::cull::keep_pair) for a
# (live ray, cluster) pair on its full path: f32 the cone (the axis dot
# 6, cos and sin of beta 9, cos(beta + alpha) 5, g 3), the threshold
# bound (10), rho (4), the origin's far distance (19), delta (12), the
# slab's grown bounds and axis flags (12), the state and ray flags (3):
# 84; f64 the slab's three axes (8 each) and its emptiness test (6): 30.
# Once a live ray a tile (rk::cull::ray_data): |d|, its reciprocal, the
# three clamped 1 / d_i and the range checks, 34 f32. The pre-pass
# (cull_prep_kernel) once a row: the f64 normal, three lengths, the
# |det| reach, side, unit normal and sums, s_min, E, E2 and the cone's
# cosine (65), f32 the box and range checks (42). Its records, C x 64
# bytes, are written once and read once.
CULL_OPS, CULL_OPS_F64, CULL_RAY_OPS = 84, 30, 34
PREP_OPS, PREP_OPS_F64, CULL_REC_BYTES = 42, 65, 64
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
# integer operations of sel_probe's rank (regroup.cu's sel_kernel): one
# interest test per (lane, cycle) (the residue's step to the next cycle,
# its wrap, the test against the lane's residue mask: 3) and, once a
# lane, one shifted term per shift k <= lane into that mask (the window's
# two compares, its bits, the next shift's residue: 4)
SEL_TEST_OPS, SEL_TERM_OPS = 3, 4
# integer operations of permute's rank (regroup.cu's rank_cycle) per lane
# a cycle's scan tests: the residue's step to the lane 32 on, its wrap,
# the interest test (3); the scan needs the lanes up to its cycle's 128th
# interested lane (all n where fewer are interested)
PERMUTE_RANK_OPS = 3

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

# the bvh paths (the packed skip-link walk, csrc/packed_walk.cu): the
# CLI's default render (raypt/app/cli.py: --size 512 --spp 5 --bounces 6),
# the stand-in of the real bunny's size (_icosphere(6): 81,920 triangles)
CLI_WIDTH = 512
CLI_SPP = 5
CLI_BOUNCES = 6
LARGE_SUBDIV = 6
# the fit path: BASELINE config #5 (scripts/baseline_config5.py) on one
# card, its final phase: 80^2, 1 spp, 2 bounces, bvh, no roulette, 16
# orbit views, lattice 10, the Laplacian prior at 3.0, Adam at 0.03, the
# rgbd loss with depth weight 0.5. The mesh is the real-size stand-in
# _icosphere(LARGE_SUBDIV), placed where the bunny stands: the unit
# sphere's positions FIT_SCALE * p + FIT_SHIFT become, under
# _bunny_transform, a sphere of radius 12 about the orbit's centre.
FIT_WIDTH = 80
FIT_BOUNCES = 2
FIT_VIEWS = 16
FIT_ORBIT = (32.5, -1.5, 20.0, 22.0)     # centre x, y, z and radius
FIT_SCALE = 0.08
FIT_SHIFT = (-0.0167, 0.11, 0.0)
FIT_LATTICE = 10
FIT_LAP_W = 3.0
FIT_LR = 0.03
FIT_DEPTH_W = 0.5
FIT_TRAIN = ("albedo_logits", "lattice_scalar", "vertex_offsets")
FIT_STEPS = 5
FIT_PLAIN_STEPS = 2
FIT_LOOP_STEPS = 2       # raypt_torch.diff.fit, the loop's entry point
# phase 11, raypt_torch.dist: two ranks sharing the card over gloo (the
# stand-in for config #5's 8-device mesh), the launcher's render defaults
# (cornell_bunny, 512^2, 4 spp, 4 bounces, bvh: 16 packed_walk launches a
# rank), and three view-sharded fit steps (8 views a rank: 24 launches a
# rank a step); seconds a rendezvous or collective may wait, and a rank
# process may run. The two ranks' partial sums add in another order than
# one process's running sum: each step's loss is held to DIST_LOSS_RTOL
# and its summed gradients to DIST_GRAD_RTOL of the largest |g| against
# the one-process step from the same parameters and Adam state.
DIST_RANKS = 2
DIST_SIZE = 512
DIST_SPP = 4
DIST_BOUNCES = 4
DIST_FIT_STEPS = 3
DIST_TIMEOUT = 300
DIST_PROC_TIMEOUT = 420
DIST_LOSS_RTOL = 1e-5
DIST_GRAD_RTOL = 1e-5
DIST_SUM_REPS = 20         # sum_over_mesh timed alone, mean of these

# the wide walk (phase 10, csrc/wide_walk.cu): the stacks that overflow
# on the bench scene's wavefronts (find_closest_wide then walks the
# flagged rays again at 4x), the rows of a visit the kernel reads (an
# internal row's four boxes and ids, seven 16-byte loads; a leaf row's
# four triangles, twelve), and the f32 operations of a visit: an internal
# row's four slab tests (6 sub/mul pairs, 3 min and 3 max, 2 + 2 for the
# near / far reductions, 6 compares, the clamp at 0 and the select: 30
# each), the five exchanges of the sort (a compare and 4 selects each)
# and the three push tests (3); a leaf row's four Moller-Trumbore tests
# and merges (PACKED_LEAF_OPS less its leaf flag: 57 each); each live
# ray's clamped reciprocal and its t0 + rd.x * 0 (14)
WIDE_STACKS = (2, 4)
# the deep-stack wavefront (deep_stack_case): internal rows of its chain
# (a walk's stack reaches 3 entries a row: 48, above 32 and below
# STACK_D), its rays, and the stacks it is also walked at (rays
# overflow at each)
DEEP_LEVELS = 16
DEEP_RAYS = 65536
DEEP_STACKS = (31, 32, 33)
WIDE_INTERNAL_BYTES = 112
WIDE_LEAF_BYTES = 192
WIDE_INTERNAL_OPS = 4 * 30 + 5 * 5 + 3
WIDE_LEAF_OPS = 4 * 57
WIDE_RAY_OPS = 14

# the packed walk's rows (64 bytes a node visit) and f32 operations: an
# internal row's slab test (12 sub/mul, 10 min/max, 6 compares, the leaf
# flag and the link select), a leaf row's Moller-Trumbore test and merge
# (18 for the two cross products, 15 for the four dots' sums and the
# three scalings, the abs, 3 subs, 2 selects and the division for
# inv_det, 7 compares and the u + v add, the leaf flag and 2 selects),
# and each live ray's clamped reciprocal (3 abs, 6 compares, 3 divisions)
ROW_BYTES = 64
SPLIT_INNER_BYTES = 32     # the kernel's split table (csrc/packed_walk.cuh)
SPLIT_LEAF_BYTES = 48
PACKED_INTERNAL_OPS = 30
PACKED_LEAF_OPS = 58
PACKED_RAY_OPS = 12
# the walk's edge cases (walk_edge_wave): rays a block, triangles copied,
# and unit directions with components of exactly +0 and -0
EDGE_BLOCK = 4096
EDGE_COPIES = 32
# walk_edges' step caps of the packed walk: (max_iters, unroll)
WALK_CAPS = ((0, 1), (3, 1), (17, 1), (4, 8))
SIGNED_ZERO_DIRS = ((0.0, -0.0, 1.0), (-0.0, 0.0, -1.0), (1.0, 0.0, -0.0),
                    (-1.0, -0.0, 0.0), (0.0, 1.0, 0.0), (-0.0, -1.0, -0.0),
                    (0.6, -0.0, 0.8), (-0.0, 0.8, -0.6))

# phase 12, the packed table's other layouts (csrc/packed_layouts.cu):
# each kernel's RenderConfig flags; the planted ties (layout_tie_case):
# triangles copied 1-4 times, invalid triangles, rays; the small meshes'
# triangle counts (small_meshes)
LAYOUT_FLAGS = {"packed_walk2": dict(leaf_tris=2),
                "packed_walk_la": dict(node_lookahead=True),
                "packed_walk4": dict(leaf_tris=4),
                "packed_walk4_la": dict(leaf_tris=4, node_lookahead=True)}
TIE_GROUPS = 48
TIE_INVALID = 12
TIE_RAYS = 8192
SMALL_MESHES = (1, 2, 3, 4, 5)

# phase 12's bounds: f32 operations of the tests each wavefront's walk
# needs, from the packed walk's counts: a slab test 28 (12 sub / mul, 10
# min / max, 6 compares) for every internal visit, and a second one for
# a lookahead row's right box only where its left box missed; a
# Moller-Trumbore test 55 for every filled slot of a visited leaf row
# (face id >= 0: a singleton cherry's second slot and a quad's empty
# ones need none). Beside the tests, each visit's own, (internal, leaf):
# the leaf flag and the link select (a lookahead row two link selects);
# a cherry leaf two BIG selects, a compare and two selects for the pick
# and a compare and two selects to take it; a quad leaf four BIG
# selects, three compares for the argmin and three to take it; a
# lookahead leaf the take's compare and two selects. The bytes the
# kernels read, for the log: every kernel reads its split table, a
# 32-byte sector (SPLIT_INNER_BYTES) a slab test (a lookahead row's
# second sector only where its left box missed) and a 48-byte entry
# (SPLIT_LEAF_BYTES) a tested slot. The tables stay in the 50 MB L2, so
# the bound counts each table once.
SLAB_OPS = PACKED_INTERNAL_OPS - 2
TRI_OPS = PACKED_LEAF_OPS - 3
LAYOUT_OPS = {"packed_walk2": (2, 1 + 7), "packed_walk_la": (3, 3),
              "packed_walk4": (2, 1 + 10), "packed_walk4_la": (3, 1 + 10)}
EDGE_NAN_RAYS = 65536

# the compaction's edge groups: one below the 256-lane chunk a block
# ranks (compact.cu kChunk), one a multiple of neither 16 lanes (byte
# loads of the mask) nor the chunk (a partial chunk a group), and one
# that no 1,024-lane chunk divides
COMPACT_EDGE_GROUPS = (100, 256, 1000, 1024, 1536, COMPACT_N)

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
    # the mask-only walk's word-major mode: no path takes it since the
    # finders take its ray-major mode (topwalk); phase 3 times it on the
    # unfused and config4 wavefronts
    "topwalk_cm": ((), "raypt_torch/csrc/onehot_walk.cu",
                   "raypt/kernels/onehot_walk.py:190"),
    # the same walk's ray-major mode (rk_topwalk_mask_rows): the (R,
    # words) mask of the non-fused and Woop branches
    "topwalk": (("unfused", "config4"), "raypt_torch/csrc/onehot_walk.cu",
                "raypt/kernels/onehot_walk.py:169"),
    "cluster_intersect_mask_woop": (("config4",),
                                    "raypt_torch/csrc/cluster_intersect.cu",
                                    "raypt/kernels/cluster_pallas.py:486"),
    "cluster_intersect_grouped": ((), "raypt_torch/csrc/cluster_intersect.cu",
                                  "raypt/kernels/cluster_pallas.py:183"),
    # intersect_worklist_jnp, an XLA function in the JAX package: the
    # non-fused path's worklist test (also the cluster finder's overflow
    # fallback and use_pallas=False, phase 3 and 5)
    "intersect_worklist": (("unfused",),
                           "raypt_torch/csrc/cluster_intersect.cu",
                           "raypt/accel/clusters.py:318"),
    # an XLA while_loop in the JAX package, not a Pallas kernel
    "packed_walk": (("bvh",), "raypt_torch/csrc/packed_walk.cu",
                    "raypt/accel/packed.py:85"),
    # an XLA while_loop in the JAX package too: the bvh4 backend (phase 10)
    "wide_walk": (("bvh4",), "raypt_torch/csrc/wide_walk.cu",
                  "raypt/accel/wide.py:186"),
    # XLA while_loops too: the packed table's other layouts (phase 12),
    # and in one launch traverse_wavefront_compact (packed.py:740)
    "packed_walk2": (("bvh_cherry",), "raypt_torch/csrc/packed_layouts.cu",
                     "raypt/accel/packed.py:577"),
    "packed_walk_la": (("bvh_lookahead",),
                       "raypt_torch/csrc/packed_layouts.cu",
                       "raypt/accel/packed.py:328"),
    "packed_walk4": (("bvh_quad",), "raypt_torch/csrc/packed_layouts.cu",
                     "raypt/accel/packed.py:497"),
    "packed_walk4_la": (("bvh_quad_lookahead",),
                        "raypt_torch/csrc/packed_layouts.cu",
                        "raypt/accel/packed.py:497"),
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
KERNEL_PATHS = ("expand", "dense_union", "cluster", "pallas", "unfused",
                "bvh")
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
        # the worklist cull's (live ray-cluster pairs, pairs kept), per
        # frame of each path
        self.cull = {}
        # device time from CUDA graph replay (no host work between
        # calls), summed over the timed wavefronts: name -> ms
        self.graph_ms = {}
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

    def time(self, name, label, kernel, plain, args, moved, ops,
             plain_ms=None, ops_f64=0, ops_i32=0):
        """CUDA-event times of one launch of the kernel and of its plain
        version on args (mean of 2 after a warm-up, or `plain_ms` where
        the caller timed it), and the launch's bound: the larger of
        `moved` bytes over the HBM rate and `ops` f32 operations over the
        f32 peak plus `ops_f64` f64 operations over the f64 peak and
        `ops_i32` int32 operations over the int32 peak."""
        k_ms = cuda_ms(lambda: kernel(*args), 10)
        p_ms = (cuda_ms(lambda: plain(*args), 2) if plain_ms is None
                else plain_ms)
        by_bytes = 1e3 * moved / HBM_BYTES_PER_S
        by_ops = 1e3 * (ops / F32_OPS_PER_S + ops_f64 / F64_OPS_PER_S
                        + ops_i32 / INT32_OPS_PER_S)
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

    def time_graph(self, name, label, kernel, args):
        """Device time of one launch replayed from a CUDA graph."""
        ms = graph_us_per_call(lambda: kernel(*args)) / 1e3
        self.graph_ms[name] = self.graph_ms.get(name, 0.0) + ms
        log(f"  {label:9s} {name:22s} graph   {ms:9.4f} ms (device, no host "
            f"work between calls)")

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
    # the finder's flow: the compaction leaves its chunk counts for the
    # uncompaction
    counts = cp.new_counts(a, COMPACT_N)
    kc = cp.alive_compact(*args, counts)
    pc = cp.alive_compact_plain(*args)
    stats.check("alive_compact", f"{label} alive", kc[3], pc[3])
    stats.check("alive_compact", f"{label} counts", counts,
                cp.chunk_counts(a, COMPACT_N))
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

    # the permutation is full: dead lanes are compared too
    uargs = (kt, kf, a, COMPACT_N, counts)
    kut, kuf = cp.alive_uncompact(*uargs)
    put, puf = cp.alive_uncompact_plain(*uargs)
    stats.check("alive_uncompact", f"{label} t", kut, put)
    stats.check("alive_uncompact", f"{label} face", kuf, puf)

    if timed:
        r = o.shape[0]
        leaf = rows.shape[1]
        visits = walk_visits(accel.table, *kc, cwp)
        stats.time("alive_compact", label, cp.alive_compact,
                   cp.alive_compact_plain, args, 2 * nbytes(o, d, t, a), 0)
        # what the walk needs (counted as for the mask-only walk in
        # compare_unfused): the table once, a live ray's origin, direction
        # and t, every ray's flag, the whole mask written once, union_pp;
        # a visit's step, and each row's decode once a block with a live
        # ray
        live = int(kc[3].sum())
        busy = int(kc[3].view(-1, WALK_BLOCK).any(dim=1).sum())
        stats.time("topwalk_cm_u", label, wk.topwalk_cm_u,
                   wk.topwalk_cm_u_plain, wargs,
                   nbytes(accel.table, kc[3], km, ku)
                   + live * (o.shape[1] + d.shape[1] + 1) * o.element_size(),
                   (WALK_OPS - ROW_DECODE_OPS) * visits
                   + ROW_DECODE_OPS * accel.table.shape[0] * busy)
        stats.time("cluster_expand", label, ex.cluster_expand,
                   ex.cluster_expand_plain, eargs,
                   nbytes(km, ku, rows, kc[0], kc[1], seed, kt, kf),
                   MT_OPS * leaf * popcount(km))
        stats.time("alive_uncompact", label, cp.alive_uncompact,
                   cp.alive_uncompact_plain, uargs,
                   nbytes(kt, kf, a, kut, kuf), 0)
        for name, kernel, kargs in (
                ("alive_compact", cp.alive_compact, args),
                ("topwalk_cm_u", wk.topwalk_cm_u, wargs),
                ("alive_uncompact", cp.alive_uncompact, uargs)):
            stats.time_graph(name, label, kernel, kargs)
        log(f"  {label:9s} walk visits {visits}, wanted clusters per live "
            f"ray {popcount(km) / max(live, 1):.2f} (R = {r}), {busy} of "
            f"{r // WALK_BLOCK} walk blocks with a live ray")
    return kc[3], ku


def compare_cm_u(stats, label, scene, accel, ro, rd, active):
    """topwalk_cm_u alone on one wavefront, uncompacted (so a layout of
    `active` reaches the walk as it is), mask and union_pp bitwise."""
    from raypt_torch.accel.traverse import onehot_inputs
    from raypt_torch.kernels import onehot_walk as wk

    o, d, t, a, _, _ = onehot_inputs(scene, ro, rd, active, COMPACT_N)
    wargs = (accel.table, o, d, t, a, -(-accel.num_clusters // 256) * 8)
    km, ku = wk.topwalk_cm_u(*wargs)
    pm, pu = wk.topwalk_cm_u_plain(*wargs)
    stats.check("topwalk_cm_u", f"{label} mask", km, pm)
    stats.check("topwalk_cm_u", f"{label} union_pp", ku, pu)
    if not bool(km.any()):
        raise AssertionError(f"topwalk_cm_u {label}: no ray wants a cluster")


def mixed_tile(active, group):
    """active with its first group cut to keep = 300 + a multiple of
    2,048 live rays (its first ones), so that after the compaction the
    walk tile at lane keep - 300 holds one whole live 256-ray block, one
    with 44 live rays and six dead blocks: that tile's union_pp row
    gathers the atomics of live blocks among dead ones. Returns (active,
    the tile's index)."""
    import torch
    a = active.clone()
    live = torch.nonzero(a[:group]).flatten()
    keep = max(live.numel() - live.numel() % 2048 - 2048, 0) + 300
    if live.numel() < keep:
        raise AssertionError(f"mixed_tile: {live.numel()} live rays in the "
                             f"first group, {keep} needed")
    a[live[keep:]] = False
    return a, (keep - 300) // 2048


def compact_layouts(r, group, active):
    """name -> (r,) bool alive mask: all dead, all alive, alive only in
    each group's last lane, alternating lanes, and the wavefront's own."""
    import torch
    lane = torch.arange(r, device=active.device)
    return {"all dead": torch.zeros_like(active[:r]),
            "all alive": torch.ones_like(active[:r]),
            "last lane": lane % group == group - 1,
            "alternating": lane % 2 == 1,
            "wavefront": active[:r].clone()}


def compare_compact_edges(stats, scene, ro, rd, active):
    """alive_compact and alive_uncompact, kernel against plain version on
    every lane (the permutation is full: dead lanes carry their own data),
    on the first R - R % group lanes of a wavefront for each group of
    COMPACT_EDGE_GROUPS and each layout of compact_layouts; and on
    tensors that start one lane into their storage (a mask that is not
    16-byte aligned, so the byte loads)."""
    import torch
    from raypt_torch.accel.traverse import onehot_inputs
    from raypt_torch.kernels import compact as cp

    o, d, t, a, _, _ = onehot_inputs(scene, ro, rd, active, COMPACT_N)
    cases = []
    for group in COMPACT_EDGE_GROUPS:
        r = o.shape[0] // group * group
        for what, alive in compact_layouts(r, group, a).items():
            cases.append((f"group {group} {what}", (o[:r], d[:r], t[:r],
                                                     alive, group)))
    r = (o.shape[0] - 1) // 1024 * 1024
    cases.append(("group 1024 offset", (o[1:r + 1], d[1:r + 1], t[1:r + 1],
                                        a.clone()[1:r + 1], 1024)))
    for what, args in cases:
        kc = cp.alive_compact(*args)
        for name, x, y in zip(("ro", "rd", "t0", "alive"), kc,
                              cp.alive_compact_plain(*args)):
            stats.check("alive_compact", f"{what} {name}", x, y)
        face = torch.arange(args[0].shape[0], dtype=torch.int32,
                            device=o.device)
        uargs = (kc[2], face, args[3], args[4])
        want = cp.alive_uncompact_plain(*uargs)
        # with its own count pass, and with the compaction's counts
        counts = cp.new_counts(args[3], args[4])
        cp.alive_compact(*args, counts)
        for how, got in (("own count", cp.alive_uncompact(*uargs)),
                         ("given counts", cp.alive_uncompact(*uargs,
                                                             counts))):
            for name, x, y in zip(("t", "face"), got, want):
                stats.check("alive_uncompact", f"{what} {name} ({how})", x,
                            y)
    log(f"  compaction edges: groups {COMPACT_EDGE_GROUPS} x "
        f"{tuple(compact_layouts(1, 1, a))}, and group 1024 one lane into "
        f"the storage: compact and uncompact (counting itself, and with "
        f"the compaction's counts) bitwise on every lane")


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
        # what the function needs (counted as for the mask-only walk in
        # compare_unfused): the table once, a live ray's origin, direction
        # and t, every ray's flag, the unions; a visit's step, and each
        # row's decode once a tile with a live ray
        live = int(a.sum())
        busy = int(a.view(-1, WALK_BLOCK).any(dim=1).sum())
        moved = (nbytes(accel.table, a, ku)
                 + live * (o.shape[1] + d.shape[1] + 1) * o.element_size())
        ops = ((WALK_OPS - ROW_DECODE_OPS) * visits
               + ROW_DECODE_OPS * accel.table.shape[0] * busy)
        stats.time("topwalk_union", label, wk.topwalk_union,
                   wk.topwalk_union_plain, wargs, moved, ops)
        stats.time_graph("topwalk_union", label, wk.topwalk_union, wargs)
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


def compare_unfused(stats, label, scene, accel, ro, rd, active, timed,
                    worklist=True):
    """The non-fused path's stages on one wavefront, kernels against
    plain versions: the mask-only walk, word-major (topwalk_cm) and
    ray-major (topwalk, the (R, words) form the finder takes, written so
    by the kernel), and, with `worklist`, the worklist intersection of
    the first WORKLIST_CAP clusters of each tile's union (the finder's
    first round; its plain version timed once, by the run checked, where
    timed), also through the kernel's audit (`cull_audit`). Returns the
    kernel's (words, R) mask, and with `worklist` the intersection's
    (worklist, rows, o, d, seed)."""
    import torch
    from raypt_torch.accel.clusters import (WORKLIST_CAP, tile_union_counts,
                                            worklist_slice)
    from raypt_torch.accel.ctree import walk_topwalk
    from raypt_torch.accel.traverse import DENSE_CHUNK, wavefront_inputs
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_pallas as dn
    from raypt_torch.kernels import onehot_walk as wk

    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    nw = -(-accel.num_clusters // 32)
    wargs = (accel.table, o, d, t, a, nw)
    km = wk.topwalk_cm(*wargs)
    stats.check("topwalk_cm", f"{label} mask", km, wk.topwalk_cm_plain(*wargs))
    stats.check("topwalk", f"{label} (R, words) mask", wk.topwalk(*wargs),
                walk_topwalk(*wargs))
    if worklist:
        union, counts = tile_union_counts(km.T.contiguous(), dn.TILE)
        wl = worklist_slice(union, accel.num_clusters, WORKLIST_CAP)
        seed = torch.where(a, t, torch.full_like(t, -BIG))
        rows = accel.clusters.tri_rows
        iargs = (wl, rows, o, d, seed)
        kt, kf = dn.intersect_worklist(*iargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pt, pf = dn.intersect_worklist_plain(*iargs)
        end.record()
        torch.cuda.synchronize()
        stats.check("intersect_worklist", f"{label} t", kt, pt)
        stats.check("intersect_worklist", f"{label} face", kf, pf)
        pairs, kept = cull_audit(stats, label, iargs, (pt, pf))
        if timed:
            n = counts.clamp(max=WORKLIST_CAP)
            tests = live_tests(a, n, dn.TILE)
            if tests != pairs:
                raise AssertionError(f"intersect_worklist {label}: the audit "
                                     f"counted {pairs} live pairs, the "
                                     f"union {tests}")
            # the work this run's data needs: the kept pairs' tests, the
            # cull of every live pair, each live ray's cull data and the
            # pre-pass over the rows; the records written and read once
            c_rows = rows.shape[0] * rows.shape[1]
            live = int((seed > 0).sum())
            stats.time("intersect_worklist", label, dn.intersect_worklist,
                       dn.intersect_worklist_plain, iargs,
                       nbytes(wl, rows, o, d, seed, kt, kf)
                       + 2 * CULL_REC_BYTES * rows.shape[0],
                       MT_OPS * rows.shape[1] * kept + CULL_OPS * pairs
                       + CULL_RAY_OPS * live + PREP_OPS * c_rows,
                       plain_ms=start.elapsed_time(end),
                       ops_f64=CULL_OPS_F64 * pairs + PREP_OPS_F64 * c_rows)
            union_ms = 1e3 * MT_OPS * rows.shape[1] * tests / F32_OPS_PER_S
            stats.cull[stats.path] = [x + y for x, y in zip(
                stats.cull.get(stats.path, (0, 0, 0.0)),
                (pairs, kept, union_ms))]
            every = dn.TILE * int(n.sum())
            log(f"  {label:9s} worklist clusters per tile "
                f"{float(n.float().mean()):.2f}, max {int(n.max())} of "
                f"{WORKLIST_CAP} slots; live ray-cluster tests {tests} "
                f"({tests / max(every, 1):.4f} of all); the cull kept "
                f"{kept} ({kept / max(pairs, 1):.4f}), which the bound "
                f"counts; testing every live pair would take {union_ms:.4f} "
                f"ms at the f32 peak (information)")
    if timed:
        # what the function needs: the table once, a live ray's origin,
        # direction and t, every ray's flag and mask words (either layout)
        visits = walk_visits(*wargs)
        live = int(a.sum())
        busy = int(a.view(-1, WALK_BLOCK).any(dim=1).sum())
        moved = (nbytes(accel.table, a, km)
                 + live * (o.shape[1] + d.shape[1] + 1) * o.element_size())
        ops = ((WALK_OPS - ROW_DECODE_OPS) * visits
               + ROW_DECODE_OPS * accel.table.shape[0] * busy)
        stats.time("topwalk_cm", label, wk.topwalk_cm, wk.topwalk_cm_plain,
                   wargs, moved, ops)
        stats.time("topwalk", label, wk.topwalk, walk_topwalk, wargs, moved,
                   ops)
        log(f"  {label:9s} walk visits {visits}, {nw} words, {busy} blocks "
            f"with a live ray")
    return (km, iargs) if worklist else km


def cull_audit(stats, label, iargs, plain):
    """intersect_worklist through its audit mode: (t, face) bitwise the
    plain version's; no pair the cull skipped holds a hit the merge would
    have taken (the kernel tests every skipped pair in full); the
    pre-pass's records equal, value for value, worklist_cull_prep_plain's
    on the CPU (the sign of a zero aside, which no decision reads); and
    the kernel's counts of live and kept pairs are those of
    intersect_worklist_culled_plain on the same inputs (the plain
    predicate, run on the card), whose (t, face) is the plain version's
    too. Returns (live ray-cluster pairs, pairs kept)."""
    import torch
    from raypt_torch.kernels import cluster_pallas as dn
    at, af, (pairs, kept, bad), recs = dn.intersect_worklist_audit(*iargs)
    stats.check("intersect_worklist", f"{label} audit t", at, plain[0])
    stats.check("intersect_worklist", f"{label} audit face", af, plain[1])
    if bad:
        raise AssertionError(f"intersect_worklist {label}: the cull skipped "
                             f"{bad} pairs whose hit the merge would take")
    want = dn.worklist_cull_prep_plain(iargs[1].cpu())
    differ = (recs.cpu() != want).any(dim=1)
    if differ.any():
        c = int(torch.nonzero(differ)[0])
        raise AssertionError(
            f"intersect_worklist {label}: the pre-pass's records differ from "
            f"worklist_cull_prep_plain's in {int(differ.sum())} clusters; "
            f"cluster {c}: {recs[c].tolist()} against {want[c].tolist()}")
    ct, cf, counts = dn.intersect_worklist_culled_plain(*iargs)
    stats.check("intersect_worklist", f"{label} culled plain t", ct, plain[0])
    stats.check("intersect_worklist", f"{label} culled plain face", cf,
                plain[1])
    if counts != (pairs, kept, 0):
        raise AssertionError(f"intersect_worklist {label}: the kernel's audit "
                             f"counted (live, kept) pairs {(pairs, kept)}, the "
                             f"plain predicate {counts[:2]}")
    return pairs, kept


def worklist_edges(stats, wl, rows, o, d, seed, rng_seed=7):
    """intersect_worklist against its plain version, bitwise, on edge
    cases built from one wavefront's (worklist, rows, o, d, seed), each
    also held to what the rules say it must give: the worklist's entries
    spread over twice the slots with -1 gaps between them (seeded) and
    with each list's first id repeated at its end (both: the result
    unchanged); tile 0's slots all -1 and tile 1's rays dead (their
    seeds and face -1 kept, the other tiles unchanged); a copy of the
    most-hit triangle in the last lane of its cluster, under another
    face id (the first lane wins: the rays that hit it keep it); and a
    copy of that cluster under other face ids as cluster C, in a slot
    after each list (the earlier slot keeps the tie: unchanged) and
    before it (the copy wins: those rays' faces move to the copy's, t
    unchanged). Returns the number of rays each planted tie decided."""
    import torch
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import cluster_pallas as dn

    def both(label, w, r=rows, s=seed):
        args = (w.contiguous(), r.contiguous(), o, d, s.contiguous())
        kt, kf = dn.intersect_worklist(*args)
        pt, pf = dn.intersect_worklist_plain(*args)
        stats.check("intersect_worklist", f"edges {label} t", kt, pt)
        stats.check("intersect_worklist", f"edges {label} face", kf, pf)
        return kt, kf

    def same(label, a, b, where=None):
        for x, y in zip(a, b):
            if not bitwise_equal(x, y, where)[0]:
                raise AssertionError(f"intersect_worklist edges: {label} "
                                     f"changed the result")

    base = both("base", wl)
    n_tiles, cap = wl.shape
    dev = wl.device
    gen = torch.Generator().manual_seed(rng_seed)
    gaps = torch.full((n_tiles, 2 * cap), -1, dtype=torch.int32, device=dev)
    slot = 2 * torch.arange(cap) + torch.randint(0, 2, (n_tiles, cap),
                                                 generator=gen)
    gaps.scatter_(1, slot.to(dev), wl)
    same("-1 gaps", both("gaps", gaps), base)
    same("a repeated id", both("repeat", torch.cat([wl, wl[:, :1]], 1)), base)
    empty = wl.clone()
    empty[0] = -1
    dead = seed.clone()
    dead[dn.TILE:2 * dn.TILE] = -BIG
    t, f = both("empty and dead tiles", empty, s=dead)
    first = slice(0, 2 * dn.TILE)
    if not (bitwise_equal(t[first], dead[first])[0]
            and bool((f[first] == -1).all())):
        raise AssertionError("intersect_worklist edges: an all -1 or all-dead "
                             "tile changed its rays")
    same("an empty and a dead tile", (t[2 * dn.TILE:], f[2 * dn.TILE:]),
         (base[0][2 * dn.TILE:], base[1][2 * dn.TILE:]))
    # the most-hit face (not 0, the padded lanes' id) in a lane below the
    # last of its cluster
    leaf = rows.shape[1]
    fids = rows[..., 9].contiguous().view(torch.int32)
    hits = base[1][base[1] > 0]
    order = torch.bincount(hits.long()).argsort(descending=True)
    for f0 in order.tolist():
        at = torch.nonzero(fids == f0)
        if at.shape[0] == 1 and int(at[0, 1]) < leaf - 1:
            c, j = (int(x) for x in at[0])
            break
    else:
        raise AssertionError("intersect_worklist edges: no hit face to copy")
    off = 1 << 24
    lanes = rows.clone()
    lanes[c, leaf - 1, :9] = rows[c, j, :9]
    lanes[c, leaf - 1, 9] = torch.tensor(f0 + off, dtype=torch.int32,
                                         device=dev).view(torch.float32)
    on_f0 = base[1] == f0
    same("a coincident triangle in a later lane", both("lanes", wl, lanes),
         base, on_f0)
    copy = torch.cat([rows, rows[c:c + 1]])
    copy[-1, :, 9] = (fids[c] + off).view(torch.float32)
    has_c = (wl == c).any(dim=1, keepdim=True)
    extra = torch.where(has_c, rows.shape[0], -1).to(torch.int32)
    same("a tie with an earlier slot", both("after", torch.cat([wl, extra], 1),
                                            copy), base)
    kt, kf = both("before", torch.cat([extra, wl], 1), copy)
    in_c = torch.isin(base[1], fids[c][fids[c] > 0])
    if not (bitwise_equal(kt, base[0])[0]
            and torch.equal(kf[in_c], base[1][in_c] + off)
            and torch.equal(kf[~in_c], base[1][~in_c])):
        raise AssertionError("intersect_worklist edges: the copy in the "
                             "earlier slot did not take its cluster's hits")
    return int(on_f0.sum()), int(in_c.sum())


def cull_rays(rows, picks, bary, dist, grazing, gen):
    """Rays at the points p0 + u e1 + v e2 of the picked (cluster, lane)
    rows (bary (n, 2)) from `dist` back along the direction; with
    `grazing`, the direction lies in the triangle's plane but for a
    normal part giving |det| = |d . (e1 x e2)| of 1-3 x 1e-8 (f64, then
    f32)."""
    import torch
    tri = rows[picks[:, 0], picks[:, 1]].double()
    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    x = p0 + bary[:, 0:1] * e1 + bary[:, 1:2] * e2
    n = torch.linalg.cross(e1, e2)
    rnd = torch.randn(picks.shape[0], 3, generator=gen, dtype=torch.float64
                      ).to(rows.device)
    if grazing:
        tang = torch.linalg.cross(n, rnd)
        tang /= tang.norm(dim=1, keepdim=True)
        det = (1.0 + 2.0 * torch.rand(picks.shape[0], generator=gen,
                                      dtype=torch.float64).to(rows.device))
        d = tang + (det * 1e-8 / n.norm(dim=1) ** 2)[:, None] * n
    else:
        d = torch.where(((rnd * n).sum(1) > 0)[:, None], -rnd, rnd)
    d /= d.norm(dim=1, keepdim=True)
    o = x - dist[:, None] * d
    return o.float().contiguous(), d.float().contiguous()


def cull_edges(stats, rows, dev, rays=CULL_EDGE_RAYS, seed=8):
    """intersect_worklist on the cull's adversarial cases, built on the
    card, over every cluster of `rows` in a seeded order with -1 gaps:
    rays grazing a triangle (|det| of 1-3 x 1e-8), from 10^3-10^4 edge
    lengths away, and at vertices and edge midpoints; and a table of zero
    rows, slivers, a one-triangle cluster, an empty cluster and a cluster
    of mixed normals against rays around it. Each bitwise the plain
    version, and the audit finds no skipped pair with a taken hit."""
    import torch
    from raypt_torch.kernels import cluster_pallas as dn
    gen = torch.Generator().manual_seed(seed)

    def every(c_total, n_tiles):
        cap = c_total + c_total // 4
        keys = torch.rand(n_tiles, cap, generator=gen).argsort(dim=1)
        ids = torch.where(keys < c_total, keys, -1)
        return ids.to(torch.int32).to(dev).contiguous()

    def run(label, table, o, d):
        s = torch.full((o.shape[0],), 1e30, device=dev)
        args = (every(table.shape[0], o.shape[0] // dn.TILE), table, o, d, s)
        kt, kf = dn.intersect_worklist(*args)
        pt, pf = dn.intersect_worklist_plain(*args)
        stats.check("intersect_worklist", f"cull {label} t", kt, pt)
        stats.check("intersect_worklist", f"cull {label} face", kf, pf)
        pairs, kept = cull_audit(stats, f"cull {label}", args, (pt, pf))
        log(f"  cull edges {label:8s}: {int((pf >= 0).sum())} hits, kept "
            f"{kept} of {pairs} pairs, bitwise, no skipped pair held a "
            f"taken hit")

    area = torch.linalg.cross(rows[..., 3:6], rows[..., 6:9]).norm(dim=-1)
    cands = torch.nonzero(area > 0)
    edge = float(rows[..., 3:6].norm(dim=-1).max())
    for case in ("grazing", "far", "edges"):
        picks = cands[torch.randint(0, cands.shape[0], (rays,), generator=gen
                                    ).to(dev)]
        if case == "edges":
            corners = torch.tensor([[0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5],
                                    [0.5, 0.5]], dtype=torch.float64)
            bary = corners[torch.randint(0, 6, (rays,), generator=gen)]
        else:
            u = torch.rand(rays, 2, generator=gen, dtype=torch.float64)
            bary = torch.where(u.sum(1, keepdim=True) > 1, 1 - u, u)
        span = (1e3 * edge, 1e4 * edge) if case == "far" else (0.5, 20.0)
        dist = span[0] + (span[1] - span[0]) * torch.rand(
            rays, generator=gen, dtype=torch.float64)
        o, d = cull_rays(rows, picks, bary.to(dev), dist.to(dev),
                         case == "grazing", gen)
        run(case, rows, o, d)
    table = torch.zeros((4, 8, 12), dtype=torch.float32)
    fid = torch.arange(16, dtype=torch.int32).view(torch.float32)
    table[0, 5, :10] = torch.tensor([0, 0, 0, 1, 0, 0, 0, 1, 0, fid[1]])
    table[1, 0, :10] = torch.tensor([0, 0, 0.5, 1, 1, 0, 2, 2, 0, fid[2]])
    table[1, 1, :10] = torch.tensor([0, 0, 0.25, 1, 0, 0, 1, 1e-7, 0, fid[3]])
    table[1, 2, :10] = torch.tensor([0, 0, 0.75, 0.5, 0, 0, 0, 0.5, 0,
                                     fid[4]])
    for j in range(8):
        n = torch.randn(3, generator=gen)
        e1 = torch.linalg.cross(n, torch.randn(3, generator=gen))
        table[3, j, 0:3] = torch.rand(3, generator=gen) - 0.5
        table[3, j, 3:6] = e1
        table[3, j, 6:9] = torch.linalg.cross(n, e1) / 3
        table[3, j, 9] = fid[5 + j]
    target = torch.rand(rays, 3, generator=gen) * 3 - 1.5
    o = torch.randn(rays, 3, generator=gen) * 4
    d = target - o
    d /= d.norm(dim=1, keepdim=True)
    run("slivers", table.to(dev), o.to(dev).contiguous(),
        d.to(dev).contiguous())


def options_phase(stats, counters, scene, accels, waves, cfg, skey):
    """The onehot finder's options and the cluster finder's use_pallas on
    the card (phase 5): on the dense-union path's bounce-1 wavefront
    (2^20 rays), each option's result bitwise the default's, with the
    launches it makes (a sort or a segment: one compaction and one
    uncompaction), timed (CUDA events, mean of 3 after a warm-up) beside
    the default, and the dense-union path's forward frame (`cfg`, `skey`)
    with the option, bitwise the default's image and traced counts
    (seconds: median of 3 after a warm-up); alive_compact and its
    inverse at a group of the whole
    wavefront bitwise against their plain versions; overflow_fallback
    off on the non-fused branch at the default cap (no union exceeds
    it); and find_closest_cluster(use_pallas=False) on the cluster
    path's bounce-1 wavefront against the same finder through PLAIN,
    timed beside use_pallas=True."""
    import torch
    from raypt_torch.accel.clusters import tile_worklists
    from raypt_torch.accel.traverse import (DENSE_CHUNK, PLAIN,
                                            find_closest_cluster,
                                            find_closest_onehot,
                                            wavefront_inputs)
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import compact as cp
    from raypt_torch.kernels.cluster_pallas import (TILE, intersect_worklist,
                                                    intersect_worklist_plain)
    from raypt_torch.render.integrator import render_sample

    ro, rd, active = waves["dense_union"][1]
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    r = o.shape[0]
    counts = cp.new_counts(a, r)
    k_out = cp.alive_compact(o, d, t, a, r, counts)
    p_out = cp.alive_compact_plain(o, d, t, a, r)
    for what, x, y in zip(("ro", "rd", "t0", "alive"), k_out, p_out):
        if not bitwise_equal(x, y)[0]:
            raise AssertionError(f"alive_compact at group {r}: {what} differs "
                                 f"from its plain version")
    face = torch.arange(r, dtype=torch.int32, device=o.device)
    for x, y in zip(cp.alive_uncompact(t, face, a, r, counts),
                    cp.alive_uncompact_plain(t, face, a, r)):
        if not bitwise_equal(x, y)[0]:
            raise AssertionError(f"alive_uncompact at group {r} differs from "
                                 f"its plain version")
    log(f"phase 5 options: alive_compact and alive_uncompact at one group of "
        f"{r} lanes bitwise equal to their plain versions")
    base_kw = dict(accel=accels["dense_union"], expand_n=0, compact_n=0)
    unfused_kw = dict(base_kw, use_pallas_intersect=False)
    sort = {"alive_compact": 1, "alive_uncompact": 1}
    union = {"topwalk_union": 1, "cluster_intersect_mask": 1}
    masked = {"topwalk": 1, "cluster_intersect_mask": 1}
    cases = [  # label, keywords, launches
        ("none", base_kw, union),
        ("sort_rays alive", dict(base_kw, sort_rays="alive"),
         dict(masked, **sort)),
        ("sort_rays mask", dict(base_kw, sort_rays="mask"),
         dict(masked, **sort)),
        ("sort_rays True", dict(base_kw, sort_rays=True), dict(masked, **sort)),
        ("segment_sort 2048", dict(base_kw, segment_sort=2048),
         dict(union, **sort)),
        ("segment_sort 3000 (no-op)", dict(base_kw, segment_sort=3000), union),
        ("tile_b 128", dict(base_kw, tile_b=128), union),
        ("tile_b 512", dict(base_kw, tile_b=512), union),
        ("walk_tile 512", dict(base_kw, walk_tile=512), union),
        ("walk_tile 128", dict(base_kw, walk_tile=128), masked),
        ("unfused", unfused_kw, {"topwalk": 1, "intersect_worklist": 1}),
        ("unfused, overflow_fallback off",
         dict(unfused_kw, overflow_fallback=False),
         {"topwalk": 1, "intersect_worklist": 1}),
    ]
    ref, frames = {}, {}
    for label, kw, expect in cases:
        def run(kw=kw):
            return find_closest_onehot(scene, ro, rd, active, **kw)

        def frame(kw=kw):
            with torch.no_grad():
                return render_sample(scene, cfg, skey,
                                     partial(find_closest_onehot, **kw),
                                     return_alive=True)
        out, _ = counted(counters, expect, run)
        ms = cuda_ms(run, 3)
        key = "unfused" if label.startswith("unfused") else "none"
        ref.setdefault(key, out)
        frames.setdefault(key, frame())
        for what in ("t", "tri", "sphere"):
            eq, err = bitwise_equal(getattr(out, what), getattr(ref[key], what))
            if not eq:
                raise AssertionError(f"option {label}: {what} differs from "
                                     f"{key} (max abs err {err})")
        img, traced = frame()
        if not (bitwise_equal(img, frames[key][0])[0]
                and torch.equal(traced, frames[key][1])):
            raise AssertionError(f"option {label}: the frame differs from "
                                 f"{key}'s")
        secs = statistics.median(seconds(frame))
        log(f"  option {label:30s} bounce 1 {ms:9.3f} ms, frame fwd "
            f"{secs:.4f} s, bitwise equal to {key}; launches {expect}")
    ro, rd, active = waves["cluster"][1]
    clusters = accels["cluster"]
    outs = {}
    for use_pallas in (True, False):
        def run(use_pallas=use_pallas):
            return find_closest_cluster(scene, clusters, ro, rd, active,
                                        use_pallas=use_pallas)
        expect = ({"cluster_intersect": 1} if use_pallas
                  else {"intersect_worklist": 1})
        outs[use_pallas], _ = counted(counters, expect, run)
        log(f"  cluster finder use_pallas={use_pallas}: forward "
            f"{cuda_ms(run, 3):9.3f} ms; launches {expect}")
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, DENSE_CHUNK)
    seed = torch.where(a, t, torch.full_like(t, -BIG))
    wl = tile_worklists(clusters, o, d, seed, TILE)[0]
    iargs = (wl, clusters.tri_rows, o, d, seed)
    pairs, kept = cull_audit(stats, "use_pallas=False", iargs,
                             intersect_worklist_plain(*iargs))
    log(f"  cluster finder use_pallas=False: the cull kept {kept} of {pairs} "
        f"live ray-cluster pairs ({kept / max(pairs, 1):.4f}) of the "
        f"nearest-first worklists, none skipped held a taken hit; "
        f"intersect_worklist {cuda_ms(lambda: intersect_worklist(*iargs), 3):.3f}"
        f" ms")
    t0 = time.perf_counter()
    plain = find_closest_cluster(scene, clusters, ro, rd, active,
                                 use_pallas=False, ops=PLAIN)
    torch.cuda.synchronize()
    for what in ("t", "tri", "sphere"):
        eq, err = bitwise_equal(getattr(outs[False], what),
                                getattr(plain, what))
        if not eq:
            raise AssertionError(f"cluster finder use_pallas=False: {what} "
                                 f"differs through PLAIN (max abs err {err})")
    same = int((outs[False].tri == outs[True].tri).sum())
    log(f"  cluster finder use_pallas=False bitwise equal through PLAIN "
        f"({time.perf_counter() - t0:.2f} s plain); faces equal to "
        f"use_pallas=True on {same} of {plain.tri.numel()} rays")


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
                           timed=timed, worklist=False)
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
# an IEEE division); a walk step two 16-byte shared loads of its row; the
# packed walk's loop (its uncapped instance) is one step of either kind
# of row, the shortest loop with a 16-byte global load.
SASS_LOOPS = {
    "cluster_expand_kernel": (r"\d+cluster_expand_kernelE", "MUFU.RCP", 1),
    "union_kernel<MtTest, UnionSource>": (
        r"\d+union_kernelINS_6MtTestENS_11UnionSourceE", "MUFU.RCP", 1),
    "union_kernel<MtTest, ListSource>": (
        r"\d+union_kernelINS_6MtTestENS_10ListSourceE", "MUFU.RCP", 1),
    "union_kernel<WoopTest<4>>": (r"\d+union_kernelINS_8WoopTestILi4E",
                                  "MUFU.RCP", 1),
    "worklist_cull_kernel (intersect_worklist)": (
        r"\d+worklist_cull_kernelILb\dELb0E", "MUFU.RCP", 1),
    "closest_dense_kernel": (r"\d+closest_dense_kernelE", "MUFU.RCP", 1),
    "topwalk_mask_kernel<false>": (r"\d+topwalk_mask_kernelILb0E", "LDS.128",
                                   2),
    "topwalk_mask_kernel<true> (topwalk)": (r"\d+topwalk_mask_kernelILb1E",
                                            "LDS.128", 2),
    "topwalk_union_kernel": (r"\d+topwalk_union_kernelE", "LDS.128", 2),
    "topwalk_cm_u_kernel": (r"\d+topwalk_cm_u_kernelE", "LDS.128", 2),
    "split_walk_kernel (packed_walk)": (r"split_walk_kernelILb0E", "LDG.E.128",
                                        0),
}


def sass_per_test(lib_path):
    """Instructions per unit of work (a triangle test, a walk step) in the
    inner loop of each of SASS_LOOPS (`kernels.sass.loop_sizes`).
    Returns label -> (instructions, units)."""
    from raypt_torch.kernels.sass import loop_sizes
    return loop_sizes(lib_path, SASS_LOOPS)


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
    of the summed time of all kernels. Returns that sum, in ms."""
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
    return total / 1e3


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
    every output, the f32 operations on the selected lanes and used
    slots, and the int32 operations of sel's and permute's ranks."""
    import torch
    from raypt_torch.kernels import onehot_walk as wk
    from raypt_torch.probes import (cycle_budget, expand_debug, expand_diag2,
                                    gather, pallas_gather_test,
                                    pallas_gather_test2, permute_probe,
                                    permute_probe2, regroup, sel_probe,
                                    walk_spec_probe)
    from raypt_torch.probes._common import SLOTS
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
        old_bound = 0.0
        for fixed in modes:
            for iters in cycles:
                a = (x, iters, n, chain, fixed)
                what = f"{iters} cycles{' fixed' if fixed else ''}"
                stats.check(name, what, regroup.permute(*a),
                            regroup.permute_plain(*a))
                per = [regroup.permute_lanes(n, 0 if fixed else c, "cpu")
                       for c in range(iters)]
                used, total = _lanes_used(per, n)
                # the rank scans each ranked cycle (fixed_s: cycle 0 alone)
                # up to its 128th interested lane
                scanned = sum(int(lanes[-1]) + 1
                              if lanes.numel() == SLOTS else n
                              for lanes in per[:1 if fixed else iters])
                x_in = nbytes(x) if chain else 4 * 8 * used * progs
                ops = progs * 8 * total * (4 if chain else 3)
                old_bound += max(1e3 * (x_in + nbytes(x)) / HBM_BYTES_PER_S,
                                 1e3 * ops / F32_OPS_PER_S)
                stats.time(name, what[:9], regroup.permute,
                           regroup.permute_plain, a, x_in + nbytes(x), ops,
                           ops_i32=progs * PERMUTE_RANK_OPS * scanned)
                stats.time_graph(name, what[:9], regroup.permute, a)
        log(f"  {name}: bound {stats.bound_ms[name]:.4g} ms with the rank's "
            f"int32 operations ({stats.bound_by(name)}), {old_bound:.4g} ms "
            f"without them")

    # P4: sel (the four variants are one function)
    n = sel_probe.N
    xs = sel_probe.inputs("cuda")
    lane = torch.arange(n)
    shifts = [k for k in (2 ** j for j in range(32)) if k < n]
    terms = sum(n - k for k in shifts)   # shifts k <= lane, over the lanes
    old_bound, first_bound = 0.0, 0.0
    for iters in sel_probe.ITERS:
        a = (xs, iters, n)
        out = regroup.sel(*a)
        stats.check("sel_probe", f"{iters} cycles", out, regroup.sel_plain(*a))
        per, slots, pair_terms = [], 0, 0
        for c in range(iters):
            rank_m = regroup.sel_slots(n, c, "cpu")
            per.append(torch.nonzero(rank_m >= 0).flatten())
            slots += int(torch.unique(rank_m[rank_m >= 0]).numel())
            m = regroup._interest(lane, c)
            pair_terms += sum(int((m & (lane >= k)).sum()) for k in shifts)
        used, total = _lanes_used(per, n)
        # y reads rows 0-17; per lane 18 slot adds and 6 output adds, per
        # slot the two adds of each of y's 6 rows; and the rank, in int32:
        # an interest test per (lane, cycle), each lane's shifted terms
        # once
        moved = 2 * 18 * used * sel_probe.PROGS + nbytes(out)
        ops = sel_probe.PROGS * (24 * total + 12 * slots)
        rank_ops = sel_probe.PROGS * (SEL_TEST_OPS * n * iters
                                      + SEL_TERM_OPS * terms)
        by_bytes = 1e3 * moved / HBM_BYTES_PER_S
        old = max(by_bytes, 1e3 * ops / F32_OPS_PER_S)
        old_bound += old
        # the first count with the rank: the shifted terms of every
        # interested (lane, cycle), at the f32 rate
        first_bound += max(by_bytes, 1e3 * (ops + sel_probe.PROGS * (
            SEL_TEST_OPS * n * iters + SEL_TERM_OPS * pair_terms))
            / F32_OPS_PER_S)
        stats.time("sel_probe", f"{iters} cyc", regroup.sel, regroup.sel_plain,
                   a, moved, ops, ops_i32=rank_ops)
        stats.time_graph("sel_probe", f"{iters} cyc", regroup.sel, a)
        log(f"  sel_probe {iters} cycles: {total} lane-slots in all (the "
            f"shifted-sum rank gives no interested lane a slot), output "
            f"{'all zero' if not bool(out.any()) else 'nonzero'}; "
            f"{n * iters * sel_probe.PROGS} interest tests, "
            f"{terms * sel_probe.PROGS} shifted terms (once a lane); bound "
            f"without the rank (the count before it held the rank) "
            f"{old:.4g} ms")
    log(f"  sel_probe: bound {stats.bound_ms['sel_probe']:.4g} ms over its "
        f"{len(sel_probe.ITERS)} calls with the rank's int32 operations "
        f"({stats.bound_by('sel_probe')}); {old_bound:.4g} ms without the "
        f"rank, {first_bound:.4g} ms with every interested (lane, cycle)'s "
        f"shifted terms at the f32 rate (the count this one corrects)")

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
            stats.time_graph("cycle_budget", f"{mode[:5]} {iters}",
                             regroup.cycle, a)

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
    stats.time_graph("expand_diag2", "diag", expand_diag2.diag, a)
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
    for name, bodies in (("pallas_gather_test", (("index", False),)),
                         ("pallas_gather_test2", pallas_gather_test2.VARIANTS)):
        k_us = [graph_us_per_call(
            lambda c=clip: gather.gather_rows(table, idx, c))
            for _, clip in bodies]
        l_us = graph_us_per_call(lambda: torch.index_select(table, 0, idx))
        each = ", ".join(f"{u:.4f}" for u in k_us)
        log(f"  {name}: gather of {idx.numel()} rows replayed from a CUDA "
            f"graph (no host work between calls): kernel {sum(k_us):.4f} us "
            f"over its {len(bodies)} bodies ({each}), index_select "
            f"{l_us * len(bodies):.4f} us for as many calls ({l_us:.4f} a "
            f"call); the CUDA-event times above include each call's host "
            f"work")
    log(f"phase 7: all probe kernels bitwise equal to their plain versions "
        f"({time.perf_counter() - t_start:.1f} s)")


def tree_depth(bvh) -> int:
    """Levels of an LBVH: the longest root-to-leaf path, counted in
    nodes below the root."""
    import numpy as np
    ni = bvh.num_leaves - 1
    right = np.where(bvh.left >= 0, bvh.skip[np.clip(bvh.left, 0, None)], -1)
    frontier, depth = np.array([0]), 0
    while frontier.size:
        kids = np.concatenate([bvh.left[frontier], right[frontier]])
        frontier = kids[(kids >= 0) & (kids < ni)]
        depth += 1
    return depth


def check_lbvh(label, mesh, seed):
    """The LBVH build on the card against the build on the CPU, bitwise
    (left, skip, leaf_face, and the boxes' bits), then refit after a
    seeded vertex jitter and pack's rows viewed as int32, both also
    bitwise; logs the card's build seconds (after a warm-up) and the
    depth, which must be at most 64 (the build's 64 refit and skip-link
    rounds). Returns the card's LBVH."""
    import numpy as np
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.packed import pack
    cpu = mesh.to("cpu")
    args = (mesh.positions, mesh.faces, mesh.face_valid)
    lbvh.build(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = lbvh.build(*args)     # returns on the host: includes the copy
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = lbvh.build(cpu.positions, cpu.faces, cpu.face_valid)
    cpu_secs = time.perf_counter() - t0

    def same(a, b, what, fields=("left", "skip", "leaf_face", "bmin",
                                 "bmax")):
        for k in fields:
            if not np.array_equal(getattr(a, k).view(np.int32),
                                  getattr(b, k).view(np.int32)):
                raise AssertionError(f"LBVH {label}: {what} {k} differs "
                                     f"between the card and the CPU")

    same(card, host, "build")
    gen = torch.Generator().manual_seed(seed)
    moved = cpu.positions + 0.5 * torch.randn(cpu.positions.shape,
                                              generator=gen)
    r_card = lbvh.refit(card, moved.to(mesh.positions.device), mesh.faces,
                        mesh.face_valid)
    r_host = lbvh.refit(host, moved, cpu.faces, cpu.face_valid)
    same(r_card, r_host, "refit")
    if np.array_equal(r_card.bmin, card.bmin):
        raise AssertionError(f"LBVH {label}: refit left the boxes as they "
                             f"were")
    p_card = pack(card, *args).rows.view(torch.int32).cpu()
    p_host = pack(host, cpu.positions, cpu.faces, cpu.face_valid).rows
    if not torch.equal(p_card, p_host.view(torch.int32)):
        raise AssertionError(f"LBVH {label}: pack differs between the card "
                             f"and the CPU")
    depth = tree_depth(card)
    log(f"LBVH {label}: {int(mesh.face_valid.sum())} faces in "
        f"{mesh.num_faces} slots, {card.num_nodes} nodes; build on the card "
        f"{secs:.4f} s (CPU {cpu_secs:.3f} s), depth {depth}; build, refit "
        f"after a jitter and pack bitwise equal to the CPU's")
    if depth > 64:
        raise AssertionError(f"LBVH {label}: depth {depth} > 64, beyond the "
                             f"build's refit and skip-link rounds")
    return card


def compare_bvh(stats, label, scene, pbvh, ro, rd, active, timed):
    """The packed walk on one wavefront (t0 from the sphere pass, as
    find_closest_packed seeds it), kernel against plain version; timed,
    also from a CUDA graph, with its bound: the table read once, the
    rays' o, d, t0 and flags in and t, face out, or the f32 operations
    of its node visits (counted by the plain walk), the larger. The log
    also gives the rows the walks read, 64 bytes a visit of the table,
    32 an internal and 48 a leaf visit of the kernel's split table: the
    tables are at most 26 MB and stay in the 50 MB L2, so that traffic is
    no floor on device-memory time; and the SIMD efficiency and the share
    of warp steps mixing leaf and internal rows (accel.packed.
    simd_efficiency, mixed_share) of the first kernel's schedule (one
    thread a ray in launch order) and of the package kernel's (its
    blocks' rays by octant, accel.packed.octant_order)."""
    import torch
    from raypt_torch.accel.packed import (mixed_share, octant_order,
                                          simd_efficiency, traverse_wavefront)
    from raypt_torch.accel.traverse import wavefront_inputs
    from raypt_torch.kernels import packed_walk as pw

    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, 1)
    args = (pbvh, o, d, t, a)
    kt, kf = pw.packed_walk(*args)
    pt, pf = traverse_wavefront(*args)
    stats.check("packed_walk", f"{label} t", kt, pt)
    stats.check("packed_walk", f"{label} face", kf, pf)
    if timed:
        steps = []
        traverse_wavefront(*args, steps=steps)
        rows = sum(x[0].numel() for x in steps)
        leaves = sum(int(x[2].sum()) for x in steps)
        longest = len(steps)
        schedules = [(simd_efficiency(steps), mixed_share(steps))]
        del steps
        _, _, _, block, octant = packed_walk_info()
        lane = (octant_order(d, a, block) if octant else
                torch.arange(o.shape[0], device=o.device))
        ok = lane < o.shape[0]
        lane = lane.clamp(max=o.shape[0] - 1)
        steps = []
        traverse_wavefront(pbvh, o[lane], d[lane], t[lane], a[lane] & ok,
                           steps=steps)
        schedules.append((simd_efficiency(steps), mixed_share(steps)))
        del steps
        live = int(a.sum())
        moved = nbytes(pbvh.rows, o, d, t, a, kt, kf)
        ops = (PACKED_INTERNAL_OPS * (rows - leaves) + PACKED_LEAF_OPS * leaves
               + PACKED_RAY_OPS * live)
        stats.time("packed_walk", label, pw.packed_walk, traverse_wavefront,
                   args, moved, ops)
        stats.time_graph("packed_walk", label, pw.packed_walk, args)
        split = SPLIT_INNER_BYTES * (rows - leaves) + SPLIT_LEAF_BYTES * leaves
        log(f"  {label:9s} node visits {rows} ({leaves} leaf rows), "
            f"{rows / max(live, 1):.1f} a live ray, longest walk {longest} "
            f"steps, hits "
            f"{int((kf >= 0).sum())}; rows read {ROW_BYTES * rows / 1e9:.3f} "
            f"GB from the table, {split / 1e9:.3f} GB from the split table "
            f"({1e3 * split / HBM_BYTES_PER_S:.4f} ms at the HBM rate); SIMD "
            f"efficiency / mixed warp steps: the first kernel's schedule "
            f"{schedules[0][0]:.4f} / {schedules[0][1]:.4f}, the kernel's "
            f"{schedules[1][0]:.4f} / {schedules[1][1]:.4f}")
    return kt, kf


def packed_walk_info():
    """The package's packed-walk kernel as its library reports it
    (rk_packed_walk_info): registers, local (spill) bytes, resident
    blocks an SM, threads a block, and 1 where a block hands its rays to
    its threads by octant (0: in launch order)."""
    from raypt_torch.kernels._build import kernel_lib
    info = (ctypes.c_int * 5)()
    if kernel_lib().rk_packed_walk_info(ctypes.cast(info, ctypes.c_void_p)):
        raise AssertionError("rk_packed_walk_info failed")
    return list(info)


def counted(counters, expect, fn):
    """fn() with every kernel's launch count set to 0 before it and read
    after it: raise unless the kernels of `expect` (name -> launches)
    launched that often and no other launched. Returns (fn's result,
    seconds)."""
    import torch
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for k, c in counters.items():
        if c.launches != expect.get(k, 0):
            raise AssertionError(f"{k} launched {c.launches} times, expected "
                                 f"{expect.get(k, 0)}")
    return out, secs


def equal_renders(what, a, b):
    """Raise unless two (image, traced) pairs are bitwise equal."""
    import torch
    eq, err = bitwise_equal(a[0], b[0])
    if not eq or not torch.equal(a[1], b[1]):
        raise AssertionError(f"{what}: the kernel and plain-finder renders "
                             f"differ (max abs err {err})")
    if not bool(torch.isfinite(a[0]).all()):
        raise AssertionError(f"{what}: the image is not finite")


def grads_bitwise(label, scene, cfg, skey, finders):
    """The bench loss's gradients w.r.t. positions and albedo through
    each finder of `finders` (the kernels', then the plain versions'):
    bitwise equal."""
    import torch
    from raypt_torch.render.integrator import render_sample
    out = []
    for finder in finders:
        v = scene.mesh.positions.clone().requires_grad_(True)
        a = scene.materials.albedo.clone().requires_grad_(True)
        s = scene.replace(mesh=scene.mesh.replace(positions=v),
                          materials=scene.materials.replace(albedo=a))
        render_sample(s, cfg, skey, finder).mean().backward()
        out.append((v.grad, a.grad))
    for name, k, p in zip(("positions", "albedo"), *out):
        eq, err = bitwise_equal(k, p)
        if not eq:
            raise AssertionError(f"{label}: grad w.r.t. {name} differs "
                                 f"between the kernel and plain finders "
                                 f"(max abs err {err})")
    log(f"phase 6 {label}: grads w.r.t. positions and albedo bitwise equal "
        f"through the kernel and plain finders")


def walk_edge_wave(scene, pbvh, ro, rd, active):
    """A wavefront of edge cases for the packed walk, built from a
    bounce's (ro, rd, active): the first EDGE_BLOCK rays dead; the next
    EDGE_BLOCK live, from far outside the scene pointing away (they hit
    nothing); every 7th ray of the next 4 blocks seeded with t0 = 1e-6,
    nearer than every triangle; then direction components of exactly +0
    and -0 (8 rays from the mesh's centre), two NaN rays (origin, then
    direction) and EDGE_BLOCK rays in the plane of a triangle their ray
    hit in the plain walk, travelling along its edge e1 (det = 0 up to
    rounding). Returns (o, d, t0, active, groups), groups naming the
    ranges of each case."""
    import torch
    from raypt_torch.accel.packed import traverse_wavefront
    from raypt_torch.accel.traverse import wavefront_inputs
    o, d, t, a, _, _ = wavefront_inputs(scene, ro, rd, active, 1)
    o, d, t, a = o.clone(), d.clone(), t.clone(), a.clone()
    n = EDGE_BLOCK
    groups = {"dead": slice(0, n), "miss": slice(n, 2 * n),
              "near seed": slice(2 * n, 6 * n, 7), "signed zero": slice(
                  6 * n, 6 * n + 8), "nan": slice(6 * n + 8, 6 * n + 10),
              "parallel": slice(7 * n, 8 * n)}
    a[groups["dead"]] = False
    a[n:] = True
    o[groups["miss"]] = 1e4
    d[groups["miss"]] = 3.0 ** -0.5
    t[groups["near seed"]] = 1e-6
    m = scene.mesh
    centre = m.positions[m.faces[m.face_valid].long().flatten()].mean(dim=0)
    zs = groups["signed zero"]
    o[zs] = centre
    d[zs] = torch.tensor(SIGNED_ZERO_DIRS, device=o.device)
    nan = float("nan")
    o[6 * n + 8, 0] = nan
    d[6 * n + 9, 1] = nan
    # the parallel rays: a hit face's leaf row from the plain walk
    pl = groups["parallel"]
    _, face = traverse_wavefront(pbvh, o[pl], d[pl], t[pl], a[pl])
    ni = (pbvh.num_nodes + 1) // 2 - 1
    leaf_of = torch.empty(ni + 1, dtype=torch.int64, device=o.device)
    leaf_of[pbvh.rows[ni:, 12].contiguous().view(torch.int32).long()] = \
        torch.arange(ni + 1, device=o.device)
    hit = face >= 0
    row = pbvh.rows[ni + leaf_of[face.clamp(min=0).long()]]
    e1 = row[:, 3:6]
    along = e1 / e1.norm(dim=1, keepdim=True).clamp(min=1e-30)
    start = row[:, 0:3] + 0.3 * row[:, 3:6] + 0.3 * row[:, 6:9] - along
    o[pl] = torch.where(hit[:, None], start, o[pl])
    d[pl] = torch.where(hit[:, None], along, d[pl])
    return o, d, t, a, groups, int(hit.sum())


def walk_edges(stats, scene, pbvh, wave0, wave1):
    """Phase 3's edge cases of the packed walk, each bitwise against the
    plain version: walk_edge_wave's dead, missing, near-seeded,
    signed-zero, NaN and parallel rays (with the results each must
    have); the same wavefront under WALK_CAPS' step caps; duplicated
    triangles (copies of the 32 most-hit faces in padded slots: the tree
    changes, a copy ties its original and the first in walk order wins
    by the strict t < t_best); and a toy table
    whose internal boxes are all (-BIG, BIG), so every ray walks every
    row, the padded, degenerate leaves (e1 = e2 = 0) included."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.packed import PackedLBVH, pack, traverse_wavefront
    from raypt_torch.accel.traverse import wavefront_inputs
    from raypt_torch.core.math3d import BIG
    from raypt_torch.kernels import packed_walk as pw

    o, d, t, a, groups, n_par = walk_edge_wave(scene, pbvh, *wave1)
    kt, kf = pw.packed_walk(pbvh, o, d, t, a)
    pt, pf = traverse_wavefront(pbvh, o, d, t, a)
    stats.check("packed_walk", "edges t", kt, pt)
    stats.check("packed_walk", "edges face", kf, pf)
    for name in ("dead", "miss", "near seed", "nan"):
        g = groups[name]
        if not (bitwise_equal(kt[g], t[g])[0] and bool((kf[g] == -1).all())):
            raise AssertionError(f"packed_walk: the {name} rays changed "
                                 f"their seed or took a face")
    log(f"  walk edges: dead, missing, near-seeded (t0 1e-6), signed-zero, "
        f"NaN and {n_par} in-plane rays bitwise; the first four kept t0 and "
        f"face -1; signed-zero rays hit "
        f"{int((kf[groups['signed zero']] >= 0).sum())} of 8, in-plane rays "
        f"{int((kf[groups['parallel']] >= 0).sum())}")

    # step caps: each walk cut after max_iters * unroll steps
    cap_hits = []
    for max_iters, unroll in WALK_CAPS:
        kt, kf = pw.packed_walk(pbvh, o, d, t, a, max_iters, unroll)
        pt, pf = traverse_wavefront(pbvh, o, d, t, a, max_iters, unroll)
        stats.check("packed_walk", f"cap {max_iters} x {unroll} t", kt, pt)
        stats.check("packed_walk", f"cap {max_iters} x {unroll} face", kf, pf)
        cap_hits.append(int((kf >= 0).sum()))
    log(f"  walk caps: max_iters x unroll {WALK_CAPS} bitwise on the edge "
        f"wavefront, hits {cap_hits}")

    # duplicated triangles
    m = scene.mesh
    o0, d0, t0, a0, _, _ = wavefront_inputs(scene, *wave0, 1)
    base_t, base_f = pw.packed_walk(pbvh, o0, d0, t0, a0)
    hits = torch.bincount(base_f[base_f >= 0].long(), minlength=m.num_faces)
    src = torch.argsort(hits, descending=True, stable=True)[:EDGE_COPIES]
    first = int(m.face_valid.sum())
    faces, valid = m.faces.clone(), m.face_valid.clone()
    faces[first:first + EDGE_COPIES] = faces[src]
    valid[first:first + EDGE_COPIES] = True
    dup = pack(lbvh.build(m.positions, faces, valid), m.positions, faces,
               valid)
    kt, kf = pw.packed_walk(dup, o0, d0, t0, a0)
    pt, pf = traverse_wavefront(dup, o0, d0, t0, a0)
    stats.check("packed_walk", "copies t", kt, pt)
    stats.check("packed_walk", "copies face", kf, pf)
    copy = (kf >= first) & (kf < first + EDGE_COPIES)
    mapped = torch.where(copy, src[(kf - first).clamp(0, EDGE_COPIES - 1)]
                         .to(kf.dtype), kf)
    log(f"  walk copies: {EDGE_COPIES} most-hit faces copied; bitwise; "
        f"{int(torch.isin(base_f, src.to(base_f.dtype)).sum())} rays hit a "
        f"copied face, {int(copy.sum())} took the copy; against the table "
        f"without copies, {int((mapped != base_f).sum())} faces (mapped to "
        f"their source) and {int((kt != base_t).sum())} t differ")

    # every row walked: a toy soup of 96 faces in 128 slots
    gen = torch.Generator().manual_seed(5)
    pos = (torch.rand((96 * 3, 3), generator=gen) * 2 - 1).to(o.device)
    faces = (torch.arange(128 * 3) % (96 * 3)).reshape(128, 3).to(o.device)
    valid = torch.arange(128, device=o.device) < 96
    toy = pack(lbvh.build(pos, faces, valid), pos, faces, valid).rows.clone()
    toy[:127, 0:3] = -BIG
    toy[:127, 3:6] = BIG
    toy = PackedLBVH(rows=toy)
    r = 4096
    ro = (torch.rand((r, 3), generator=gen) * 4 - 2).to(o.device)
    rd = torch.randn((r, 3), generator=gen).to(o.device)
    rd = rd / rd.norm(dim=1, keepdim=True)
    rd[:8] = torch.tensor(SIGNED_ZERO_DIRS)
    ro[8, 1] = float("nan")
    args = (toy, ro, rd, torch.full((r,), BIG, device=o.device),
            torch.ones(r, dtype=torch.bool, device=o.device))
    kt, kf = pw.packed_walk(*args)
    visits = []
    pt, pf = traverse_wavefront(*args, visits=visits)
    stats.check("packed_walk", "toy t", kt, pt)
    stats.check("packed_walk", "toy face", kf, pf)
    if len(visits) != toy.num_nodes:
        raise AssertionError(f"toy table: the longest walk took "
                             f"{len(visits)} steps, not {toy.num_nodes}")
    log(f"  walk toy: 96 faces in 128 slots, every internal box (-BIG, BIG): "
        f"the walks read every row (the 32 padded leaves too), "
        f"{sum(v for v, _ in visits)} visits; bitwise, "
        f"{int((kf >= 0).sum())} hits of {r}")


def layout_tie_case(device, groups=TIE_GROUPS, rays=TIE_RAYS, seed=3):
    """Phase 12's planted ties: `groups` random triangles, triangle g
    copied 1 + g % 4 times (exact copies: the same vertex indices, so a
    ray gets the same t bit for bit from each), the copies at ascending
    face ids (copy 0 of every group, then copy 1, ...). Copy 0 of every
    fifth group with copies is invalid, and TIE_INVALID more triangles
    are invalid twice over. The tree is built as if every face were
    valid (`build_valid`), so the invalid faces sit in cherries and quad
    slots beside valid ones; the tables are packed with `valid`. A walk
    visits leaves in rank order, and equal centroids sort by face id, so
    of a group's valid copies the lowest face id (`winner`) must win
    every tie: within a cherry (a before b), within a quad (the lowest
    slot) and across rows (the first taken). Rays: 7 in 8 aimed at a
    point of a valid triangle from 2-6 along its normal, on either side,
    moved up to 1 sideways (no grazing ray: those are walk_edge_wave's);
    1 in 8 from [-6, 6]^3 in a random direction; 1 in 10 dead; t0 BIG.
    Returns a dict of tensors on `device`."""
    import numpy as np
    import torch
    from raypt_torch.core.math3d import BIG
    rng = np.random.default_rng(seed)
    n_tri = groups + TIE_INVALID
    corners = (rng.uniform(-4, 4, (n_tri, 1, 3))
               + rng.uniform(-1, 1, (n_tri, 3, 3)))
    copies = 1 + np.arange(groups) % 4
    faces, group_of, valid = [], [], []
    for c in range(4):
        for g in range(groups):
            if c < copies[g]:
                faces.append(3 * g + np.arange(3))
                group_of.append(g)
                valid.append(not (c == 0 and copies[g] > 1 and g % 5 == 0))
    for g in range(groups, n_tri):
        for _ in range(2):
            faces.append(3 * g + np.arange(3))
            group_of.append(g)
            valid.append(False)
    group_of = np.array(group_of)
    valid = np.array(valid)
    winner = np.full(n_tri, -1)
    for f in range(len(faces) - 1, -1, -1):
        if valid[f]:
            winner[group_of[f]] = f
    aim = rng.choice(np.flatnonzero(valid), rays)
    uv = rng.uniform(0.05, 0.45, (rays, 2))
    tri = corners[group_of[aim]]
    target = tri[:, 0] + uv[:, :1] * (tri[:, 1] - tri[:, 0]) + \
        uv[:, 1:] * (tri[:, 2] - tri[:, 0])
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    ro = (target + rng.choice([-1.0, 1.0], (rays, 1)) * normal
          * rng.uniform(2, 6, (rays, 1)) + rng.uniform(-1, 1, (rays, 3)))
    rd = target - ro
    stray = np.arange(rays) % 8 == 7
    ro[stray] = rng.uniform(-6, 6, (int(stray.sum()), 3))
    rd[stray] = rng.normal(size=(int(stray.sum()), 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    return dict(positions=t(corners.reshape(-1, 3), torch.float32),
                faces=t(np.stack(faces), torch.int32),
                build_valid=torch.ones(len(faces), dtype=torch.bool,
                                       device=device),
                valid=t(valid, torch.bool), group_of=t(group_of, torch.int64),
                winner=t(winner, torch.int64), ro=t(ro, torch.float32),
                rd=t(rd, torch.float32),
                t0=torch.full((rays,), BIG, device=device),
                active=t(np.arange(rays) % 10 != 9, torch.bool))


def check_ties(case, face, label):
    """Raise unless every hit of `face` (a walk over layout_tie_case's
    table) is a valid face and its group's winner. Returns the hits that
    took a face of a group with copies."""
    import torch
    hit = face >= 0
    f = face[hit].long()
    if not bool(case["valid"][f].all()):
        raise AssertionError(f"{label}: an invalid face was hit")
    g = case["group_of"][f]
    if not torch.equal(f, case["winner"][g]):
        raise AssertionError(f"{label}: a tie went to another copy than the "
                             f"lowest valid face id")
    counts = torch.bincount(case["group_of"], minlength=len(case["winner"]))
    return int((counts[g] > 1).sum())


def small_lbvh(positions, faces, valid):
    """The LBVH of a mesh, `lbvh.build`'s for 2 faces or more, and for
    one face the one-leaf tree (its table has one row): no link, the
    triangle's box."""
    import numpy as np
    from raypt_torch.accel import lbvh
    if faces.shape[0] > 1:
        return lbvh.build(positions, faces, valid)
    p = positions[faces[0].long()].cpu().numpy()
    return lbvh.LBVH(left=np.array([-1], np.int32),
                     skip=np.array([-1], np.int32),
                     bmin=p.min(axis=0)[None], bmax=p.max(axis=0)[None],
                     leaf_face=np.array([0], np.int32))


def small_meshes(device, rays=1024, seed=4):
    """Phase 12's meshes of SMALL_MESHES triangles (a table whose root is
    a cherry or quad row; one row for one triangle): per mesh (n, its
    LBVH, positions, faces, valid, ro, rd, t0, active), rays from [-3,
    3]^3 aimed at the triangles (1 in 4 stray, 1 in 10 dead)."""
    import numpy as np
    import torch
    from raypt_torch.core.math3d import BIG
    rng = np.random.default_rng(seed)
    out = []
    for n in SMALL_MESHES:
        corners = (rng.uniform(-1.5, 1.5, (n, 1, 3))
                   + rng.uniform(-1, 1, (n, 3, 3)))
        target = corners[rng.integers(0, n, rays)].mean(axis=1)
        target += rng.normal(scale=0.2, size=target.shape)
        ro = rng.uniform(-3, 3, (rays, 3))
        rd = target - ro
        rd[::4] = rng.normal(size=rd[::4].shape)
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        pos = torch.from_numpy(corners.reshape(-1, 3).astype(np.float32)).to(
            device)
        faces = torch.arange(3 * n, dtype=torch.int32,
                             device=device).reshape(n, 3)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        out.append((n, small_lbvh(pos, faces, valid), pos, faces, valid,
                    torch.from_numpy(ro.astype(np.float32)).to(device),
                    torch.from_numpy(rd.astype(np.float32)).to(device),
                    torch.full((rays,), BIG, device=device),
                    torch.from_numpy(np.arange(rays) % 10 != 9).to(device)))
    return out


def layout_info(table):
    """The walk kernel of a table's layout as its library reports it
    (rk_layout_walk_info, rk_layout_walk_scratch): registers, local
    (spill) bytes, resident blocks an SM, threads a block and the bytes
    of its scratch (its split table)."""
    from raypt_torch.accel.packed import layout_of
    from raypt_torch.kernels._build import kernel_lib
    from raypt_torch.kernels.packed_walk import WALKS
    info = (ctypes.c_int * 4)()
    code = WALKS[layout_of(table)][1]
    if kernel_lib().rk_layout_walk_info(code,
                                        ctypes.cast(info, ctypes.c_void_p)):
        raise AssertionError("rk_layout_walk_info failed")
    scratch = kernel_lib().rk_layout_walk_scratch(code, table.rows.shape[0])
    return [*info, 16 * scratch]


def layout_sass():
    """Per layout, the instructions of its walk kernel's shortest loop
    with a 16-byte global load (one step) and its longest (a pass), from
    cuobjdump -sass of the kernels' library (`kernels.sass.loop_sizes`,
    the kernel named as `kernels.sweep.slot_pattern` names it), as a
    phrase for the log; empty where the SASS cannot be read."""
    from raypt_torch.kernels._build import kernel_lib
    from raypt_torch.kernels.sass import loop_sizes
    from raypt_torch.kernels.sweep import layout_kept, slot_pattern
    loops = {lay: (slot_pattern(lay, d), "LDG.E.128", 0)
             for lay, d in layout_kept().items()}
    try:
        step, loop = (loop_sizes(kernel_lib()._name, loops, longest)
                      for longest in (False, True))
    except (OSError, subprocess.CalledProcessError) as e:
        log(f"  SASS not read: {e}")
        return {}
    return {lay: f"{step[lay][0]} instructions a step, {loop[lay][0]} a pass"
            for lay in loops if lay in step and lay in loop}


def layout_tests(table, steps, n_rays):
    """The tests a layout walk needs on a wavefront, from its plain
    walk's `steps` record: (internal visits, leaf visits, slab tests,
    triangle tests). A lookahead row (LALBVH, or a quad table's with
    lookahead) tests its right box only where its left box missed: where
    the ray's next row, in the record's next step, is not the row's left
    link. A leaf row's triangle tests are its slots with a face id >= 0."""
    import torch
    from raypt_torch.accel.packed import LAYOUTS, ftoi, layout_of
    lay = LAYOUTS[layout_of(table)]
    rows = table.rows
    left = lay.lookahead_left
    filled = (ftoi(rows[:, lay.faces].contiguous()) >= 0).sum(dim=1)
    counts = torch.zeros(4, dtype=torch.int64, device=rows.device)
    nxt = torch.full((n_rays,), -1, dtype=torch.int32, device=rows.device)
    for k, (lanes, nodes, leaf) in enumerate(steps):
        inner = ~leaf
        counts[0] += inner.sum()
        counts[1] += leaf.sum()
        counts[2] += inner.sum()
        counts[3] += filled[nodes[leaf].long()].sum()
        if left is not None:
            nxt.fill_(-1)
            if k + 1 < len(steps):
                nxt[steps[k + 1][0]] = steps[k + 1][1]
            link = ftoi(rows[nodes[inner].long(), left].contiguous())
            counts[2] += (nxt[lanes[inner]] != link).sum()
    return [int(c) for c in counts]


def compare_layout(stats, name, label, table, o, d, t, a, timed=False):
    """The layout walk `name` (a wrapper of kernels.packed_walk, the one
    of the table's layout) on one wavefront against its plain walk,
    bitwise (t, face). Timed: the kernel by CUDA events (mean of 10) and
    from a CUDA graph, the plain walk twice, with the bound: the larger
    of the table read once and the rays in and out over the HBM rate,
    and the f32 operations of the tests this wavefront's walk needs
    (layout_tests, from the plain walk's steps record) and of its visits
    (LAYOUT_OPS); the plain walk's time is the mean of the checking run
    (which records the steps) and one more, by the host clock (the plain
    walk waits for the card every step). Returns (t, face)."""
    import torch
    from raypt_torch.accel.packed import walk_layout
    from raypt_torch.kernels import packed_walk as pw
    wrapper = pw.wrapper_of(table)
    if wrapper.__name__ != name:
        raise AssertionError(f"{name}: the table's walk is "
                             f"{wrapper.__name__}")
    args = (table, o, d, t, a)
    kt, kf = wrapper(*args)
    steps = [] if timed else None
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    pt, pf = walk_layout(*args, steps=steps)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t_start)
    stats.check(name, f"{label} t", kt, pt)
    stats.check(name, f"{label} face", kf, pf)
    if timed:
        inner, leaves, slabs, tris = layout_tests(table, steps, o.shape[0])
        n_steps = len(steps)
        del steps
        live = int(a.sum())
        ops_i, ops_l = LAYOUT_OPS[name]
        t_start = time.perf_counter()
        walk_layout(*args)
        torch.cuda.synchronize()
        p_ms = (p_ms + 1e3 * (time.perf_counter() - t_start)) / 2
        stats.time(name, label, wrapper, walk_layout, args,
                   nbytes(table.rows, o, d, t, a, kt, kf),
                   SLAB_OPS * slabs + TRI_OPS * tris + ops_i * inner
                   + ops_l * leaves + PACKED_RAY_OPS * live, plain_ms=p_ms)
        stats.time_graph(name, label, wrapper, args)
        read = SPLIT_INNER_BYTES * slabs + SPLIT_LEAF_BYTES * tris
        log(f"  {label:9s} visits {inner} internal + {leaves} leaf "
            f"({(inner + leaves) / max(live, 1):.2f} a live ray, "
            f"{n_steps} plain steps), {slabs} slab and {tris} triangle "
            f"tests needed, hits {int((kf >= 0).sum())}; split table "
            f"read {read / 1e9:.3f} GB, {read / max(inner + leaves, 1):.2f} "
            f"bytes a visit ({1e3 * read / HBM_BYTES_PER_S:.4f} ms "
            f"at the HBM rate), table {table.rows.numel() * 4 / 1e6:.1f} MB")
    return kt, kf


def split_checks(stats, name, table, args, walked):
    """Phase 12's checks of a layout kernel's split table: its build
    alone (kernels.packed_walk.layout_table, over a scratch of NaN
    bits) bitwise the plain model accel.packed.slot_table on the rows it
    writes, and timed from a CUDA graph, a frame's four builds beside the
    kernel's graph time a frame (which holds them); the plain model's
    walk traverse_slots bitwise the kernel's result `walked` on the
    wavefront `args` (bounce 1)."""
    import torch
    from raypt_torch.accel.packed import (LAYOUTS, SLOT_LAYOUTS, layout_of,
                                          slot_counts, slot_table,
                                          traverse_slots)
    from raypt_torch.kernels import packed_walk as pw
    lay = layout_of(table)
    k = SLOT_LAYOUTS[lay].slots
    leaf = table.rows[:, LAYOUTS[lay].leaf_col] > 0.5
    slot = torch.arange(k, device=leaf.device)[None]
    written = leaf[:, None] & (slot < slot_counts(table).clamp(min=1)[:, None])
    (gi, gl), (wi, wl) = ((x.view(torch.int32) for x in t) for t in (
        pw.layout_table(table, fill=float("nan")), slot_table(table)))
    n = leaf.shape[0]
    if not (torch.equal(gi[~leaf], wi[~leaf])
            and torch.equal(gl.view(n, k, -1)[written],
                            wl.view(n, k, -1)[written])):
        raise AssertionError(f"{name}: the split table is not slot_table's")
    mt, mf = traverse_slots(table, *args)
    stats.check(name, "model bounce 1 t", walked[0], mt)
    stats.check(name, "model bounce 1 face", walked[1], mf)
    b_ms = 4 * graph_us_per_call(lambda: pw.layout_table(table)) / 1e3
    frame = stats.graph_ms[name]
    log(f"phase 12 {name} split table: built bitwise slot_table's "
        f"({table.rows.shape[0]} rows), traverse_slots bitwise the kernel on "
        f"bounce 1; four builds {b_ms:.4f} ms from graphs of the kernel's "
        f"{frame:.4f} ms a frame ({100 * b_ms / max(frame, 1e-9):.1f}%)")


def layout_edges(stats, scene, bvh, one, tables, cfgs, wave):
    """Phase 12's edge cases, each layout kernel bitwise against its plain
    walk: walk_edge_wave's dead, missing, near-seeded, signed-zero, NaN
    and in-plane rays (its first 8 EDGE_BLOCK rays, built on the
    one-triangle table `one`; the first four kinds keep t0 and face -1);
    a NaN vertex in the leaf rows (the tree as built) and in the boxes
    too (the tree refitted to it), on the first EDGE_NAN_RAYS rays of
    the wavefront; layout_tie_case's planted ties
    (their winners kept, no invalid face hit); and small_meshes' meshes
    of 1-5 triangles."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.traverse import wavefront_inputs
    from raypt_torch.render.integrator import pack_layout
    m = scene.mesh
    dev = m.positions.device
    o, d, t, a, groups, n_par = walk_edge_wave(scene, one, *wave)
    o, d, t, a = (x[:8 * EDGE_BLOCK].contiguous() for x in (o, d, t, a))
    for name, table in tables.items():
        kt, kf = compare_layout(stats, name, "edges", table, o, d, t, a)
        for g in ("dead", "miss", "near seed", "nan"):
            sl = groups[g]
            if not (bitwise_equal(kt[sl], t[sl])[0]
                    and bool((kf[sl] == -1).all())):
                raise AssertionError(f"{name}: the {g} rays changed their "
                                     f"seed or took a face")
    pos = m.positions.clone()
    pos[m.faces[0, 0].long()] = float("nan")
    boxes = lbvh.refit(bvh.tensors(dev), pos, m.faces, m.face_valid)
    sub = tuple(x[:EDGE_NAN_RAYS] for x in
                wavefront_inputs(scene, *wave, 1)[:4])
    for name, cfg in cfgs.items():
        for label, tree in (("nan vertex", bvh), ("nan boxes", boxes)):
            compare_layout(stats, name, label, pack_layout(
                cfg, tree, pos, m.faces, m.face_valid), *sub)
    case = layout_tie_case(dev)
    tie_tree = lbvh.build(case["positions"], case["faces"],
                          case["build_valid"])
    tied = {}
    for name, cfg in cfgs.items():
        table = pack_layout(cfg, tie_tree, case["positions"], case["faces"],
                            case["valid"])
        _, kf = compare_layout(stats, name, "ties", table, *(
            case[k] for k in ("ro", "rd", "t0", "active")))
        tied[name] = check_ties(case, kf, name)
    for n, tree, p, faces, valid, *rays in small_meshes(dev):
        for name, cfg in cfgs.items():
            compare_layout(stats, name, f"{n} tris", pack_layout(
                cfg, tree, p, faces, valid), *rays)
    log(f"phase 12 edges: every layout kernel bitwise on dead, missing, "
        f"near-seeded, signed-zero, NaN and {n_par} in-plane rays (the "
        f"first four kept t0 and face -1), a NaN vertex in the leaf rows "
        f"and in the boxes, {TIE_GROUPS} triangles copied 1-4 times with "
        f"invalid copies (hits on a tied copy, each its lowest valid face "
        f"id: {tied}) and meshes of {SMALL_MESHES} triangles")


def layouts_phase(stats, counters, launches, dev, scene, bvh, base, skey,
                  waves, large, fit_case, fit_first):
    """Phase 12: the packed table's other layouts (csrc/packed_layouts.cu)
    at the bench path's width. (1) Each kernel on its table of the card's
    LBVH (pack_layout) against its plain walk, bitwise, on the bvh
    path's four wavefronts (timed, also from graphs, with the bound, the
    kernel's registers, local bytes and the instructions of its walk's
    shortest and longest loop), its split table and walk against their
    plain models (split_checks), and on bvh_large's four (kernel timed,
    plain checked; `large` is phase 10's scene and LBVH). (2)
    layout_edges. (3) The bench render with
    each layout's flags through make_finder: BOUNCES launches of its
    kernel and none of another walk, bitwise the plain walk's render;
    the kernel's hits on (1)'s wavefronts within the JAX tests' rule of
    packed_walk's (t within rtol / atol 1e-5, the same face where t does
    not tie within rtol 1e-6). (4) traversal_mode "compact" on the five
    tables: one launch a bounce, the render bitwise the tiled one's, and
    on bounce 1 the plain traverse_wavefront_compact bitwise the
    kernel's. (5) One BASELINE config #5 fit step with leaf_tris=4:
    FIT_VIEWS * (FIT_BOUNCES + 1) launches of packed_walk4 and none of
    packed_walk, its table pack_quads(refit) of the step's positions, its
    loss and parameters logged beside phase 9's first step."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.packed import (layout_of, pack, pack_quads,
                                          traverse_wavefront_compact)
    from raypt_torch.accel.traverse import PLAIN
    from raypt_torch.kernels import packed_walk as pw
    from raypt_torch.render.integrator import (make_finder, pack_layout,
                                               render_sample)
    m = scene.mesh
    cfgs = {name: base.replace(backend="bvh", **flags)
            for name, flags in LAYOUT_FLAGS.items()}
    tables = {name: pack_layout(cfg, bvh, m.positions, m.faces, m.face_valid)
              for name, cfg in cfgs.items()}
    one = pack(bvh, m.positions, m.faces, m.face_valid)
    inputs = [wave_inputs_of(scene, w) for w in waves]

    # (1) the bench path's wavefronts, then bvh_large's
    part = [time.perf_counter()]
    results = {}
    sass = layout_sass()
    for name, table in tables.items():
        regs, local, blocks, threads, scratch = layout_info(table)
        log(f"phase 12 {name}: {type(table).__name__} rows "
            f"{tuple(table.rows.shape)}; {regs} registers, {local} local "
            f"bytes, {blocks} blocks of {threads} resident an SM, scratch "
            f"{scratch / 1e6:.3f} MB; SASS of its walk "
            f"{sass.get(layout_of(table), 'not read')}")
        stats.path = KERNELS[name][0][0]
        with SmClock() as clock:
            results[name] = [compare_layout(stats, name, f"bounce {b}", table,
                                            *args, timed=True)
                             for b, args in enumerate(inputs)]
        log(f"phase 12 {name}: bitwise on the bvh path's four wavefronts; "
            f"{clock.summary()} while timed")
        split_checks(stats, name, table, inputs[1], results[name][1])
    part.append(time.perf_counter())
    ls, ltree = large
    lm = ls.mesh
    lcfg = base.replace(backend="bvh")
    lwaves = [wave_inputs_of(ls, w) for w in record_waves(
        ls, lcfg, skey, make_finder(ls, lcfg, ltree))]
    for name, cfg in cfgs.items():
        table = pack_layout(cfg, ltree, lm.positions, lm.faces, lm.face_valid)
        wrapper = pw.wrapper_of(table)
        k_ms = g_ms = 0.0
        for b, args in enumerate(lwaves):
            compare_layout(stats, name, f"large b{b}", table, *args)
            k_ms += cuda_ms(lambda: wrapper(table, *args), 10)
            g_ms += graph_us_per_call(lambda: wrapper(table, *args)) / 1e3
        log(f"phase 12 bvh_large {name}: bitwise on its four wavefronts; "
            f"{k_ms:.4f} ms a frame through the wrapper, {g_ms:.4f} from CUDA "
            f"graphs ({int(lm.face_valid.sum())} faces, rows "
            f"{tuple(table.rows.shape)}, scratch "
            f"{layout_info(table)[4] / 1e6:.3f} MB)")

    # (2) edge cases
    part.append(time.perf_counter())
    layout_edges(stats, scene, bvh, one, tables, cfgs, waves[1])
    part.append(time.perf_counter())

    # (3) renders through make_finder, and the hits against packed_walk's
    base_hits = [pw.packed_walk(one, *args) for args in inputs]
    for name, cfg in cfgs.items():
        finder = make_finder(scene, cfg, bvh)
        if not bitwise_equal(finder.args[0].rows, tables[name].rows)[0]:
            raise AssertionError(f"{name}: make_finder's table is not "
                                 f"pack_layout's")

        def render(f=finder, cfg=cfg):
            return render_sample(scene, cfg, skey, f, return_alive=True)

        render()   # warm-up
        out, secs = counted(counters, {name: BOUNCES}, render)
        equal_renders(name, out, render(partial(finder, ops=PLAIN)))
        launches[name] = BOUNCES
        differ = 0
        for (kt, kf), (bt, bf) in zip(results[name], base_hits):
            near = torch.isclose(kt, bt, rtol=1e-5, atol=1e-5)
            same = (kf == bf) | torch.isclose(kt, bt, rtol=1e-6, atol=0.0)
            if not bool((near & same).all()):
                raise AssertionError(f"{name}: hits outside the JAX tests' "
                                     f"rule of packed_walk's")
            differ += int(((kt != bt) | (kf != bf)).sum())
        log(f"phase 12 render {name}: {secs:.4f} s through {BOUNCES} "
            f"launches, traced {out[1].tolist()}, image mean "
            f"{float(out[0].mean()):.6f}; bitwise the plain walk's render; "
            f"on the four wavefronts {differ} rays differ from packed_walk's "
            f"hits at all, all within the rule")

    # (4) the compacting mode on the five tables
    part.append(time.perf_counter())
    for name, table in (("packed_walk", one), *tables.items()):
        renders = []
        for mode in ("tiled", "compact"):
            cfg = base.replace(backend="bvh", traversal_mode=mode)
            finder = make_finder(scene, cfg, table)
            renders.append(counted(counters, {name: BOUNCES},
                                   lambda f=finder, cfg=cfg: render_sample(
                                       scene, cfg, skey, f,
                                       return_alive=True))[0])
        equal_renders(f"{name} compact", renders[1], renders[0])
        kt, kf = pw.compact_walk(table, *inputs[1])
        pt, pf = traverse_wavefront_compact(table, *inputs[1])
        stats.check(name, "compact bounce 1 t", kt, pt)
        stats.check(name, "compact bounce 1 face", kf, pf)
    log("phase 12 compact: on the five tables one launch a bounce, the "
        "render bitwise the tiled mode's, and the plain "
        "traverse_wavefront_compact bitwise the kernel on bounce 1")

    # (5) the fit step with leaf_tris=4
    part.append(time.perf_counter())
    cfg5, bad, tree5, views, targets = fit_case
    case = (cfg5.replace(leaf_tris=4), bad, tree5, views, targets)
    steps = []
    run = fit_run(case, 1, counters=counters, tables=steps,
                  walk="packed_walk4")
    _, rows, pos = steps[0]
    bm = bad.mesh
    want = pack_quads(lbvh.refit(tree5.tensors(dev), pos, bm.faces,
                                 bm.face_valid), pos, bm.faces, bm.face_valid)
    if not bitwise_equal(rows, want.rows)[0]:
        raise AssertionError("the leaf_tris=4 fit step's table is not "
                             "pack_quads of the refitted tree")
    loss = float(run[0][0])
    if not math.isfinite(loss):
        raise AssertionError(f"the leaf_tris=4 fit step's loss is {loss}")
    diff = max(float((v - fit_first[2][0][k]).abs().max())
               for k, v in run[2][0].items())
    log(f"phase 12 fit: one leaf_tris=4 step, {run[1][0]:.4f} s, "
        f"{FIT_VIEWS * (FIT_BOUNCES + 1)} packed_walk4 launches and none of "
        f"packed_walk; its table pack_quads(refit) of the step's positions; "
        f"loss {loss:.8f} (phase 9's first step {float(fit_first[0][0]):.8f}), "
        f"parameters at most {diff:.3g} from phase 9's after it")
    part.append(time.perf_counter())
    log("phase 12 parts, s: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(
            ("bench wavefronts", "bvh_large", "edges", "renders", "compact",
             "fit"), part, part[1:])))


def cli_default_path(counters, dev):
    """The CLI's default render through the API (raypt/app/cli.py:90-119):
    cornell_box_with_bunny at CLI_WIDTH^2, CLI_SPP spp, CLI_BOUNCES
    bounces, backend "auto" with the card's LBVH passed in, which
    resolves to "bvh"; render_frame through the kernel against the plain
    finder, bitwise. Returns the frame's launches of the walk."""
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.traverse import PLAIN
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.render.integrator import (make_finder, render_frame,
                                               resolve_backend)
    from raypt_torch.render.tonemap import to_display
    from raypt_torch.rng.sampler import key
    from raypt_torch.scenes.builtin import cornell_box_with_bunny

    b = cornell_box_with_bunny()
    b.camera.viewport_width = b.camera.viewport_height = CLI_WIDTH
    scene = b.freeze(dev)
    m = scene.mesh
    bvh = check_lbvh("cli_default", m, seed=13)
    cfg = RenderConfig(width=CLI_WIDTH, height=CLI_WIDTH,
                       samples_per_pixel=CLI_SPP, num_bounces=CLI_BOUNCES,
                       backend="auto")
    if resolve_backend(scene, cfg, bvh) != "bvh":
        raise AssertionError("cli_default: auto with an LBVH is not bvh")
    finder = make_finder(scene, cfg, bvh)
    want = CLI_SPP * CLI_BOUNCES

    def frame(f=finder):
        return render_frame(scene, cfg, key(0), finder=f)

    frame()    # warm-up
    img, secs = counted(counters, {"packed_walk": want}, frame)
    plain = frame(partial(finder, ops=PLAIN))
    equal_renders("cli_default", (img, img.new_zeros(0)),
                  (plain, plain.new_zeros(0)))
    log(f"path cli_default: {CLI_WIDTH}^2, {CLI_SPP} spp, {CLI_BOUNCES} "
        f"bounces, auto -> bvh; render_frame {secs:.4f} s, "
        f"packed_walk launched {want} times; mean display value "
        f"{float(to_display(img).mean()):.6f}; bitwise equal to the plain "
        f"finder's frame")
    return want


def large_path(counters, dev, skey):
    """The bench scene at the data size users mean by "the bunny": the
    69,451-triangle OBJ is absent, so stanford_bunny with _icosphere(
    LARGE_SUBDIV) (81,920 triangles) in place of the 5,120-triangle
    stand-in, 81,922 faces in 90,112 slots, at 1024^2, 1 spp, 4 bounces;
    backend "auto" with no accel resolves to "bvh" by face count alone,
    and make_finder builds the LBVH on the card. The render through the
    kernel is bitwise the plain finder's. Returns the launches."""
    import torch
    from raypt_torch.accel.traverse import PLAIN
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.render.integrator import (make_finder, render_sample,
                                               resolve_backend)
    from raypt_torch.scenes.builtin import _icosphere, stanford_bunny

    t0 = time.perf_counter()
    b = stanford_bunny(mesh=_icosphere(LARGE_SUBDIV))
    b.camera.viewport_width = b.camera.viewport_height = WIDTH
    scene = b.freeze(dev)
    m = scene.mesh
    made = time.perf_counter() - t0
    if (int(m.face_valid.sum()), m.num_faces) != (81922, 90112):
        raise AssertionError(f"bvh_large: {int(m.face_valid.sum())} faces in "
                             f"{m.num_faces} slots")
    check_lbvh("bvh_large", m, seed=14)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=1,
                       num_bounces=BOUNCES, russian_roulette=True)
    if resolve_backend(scene, cfg) != "bvh":
        raise AssertionError(f"bvh_large: auto resolves to "
                             f"{resolve_backend(scene, cfg)!r}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finder = make_finder(scene, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def render(f=finder):
        return render_sample(scene, cfg, skey, f, return_alive=True)

    render()   # warm-up
    out, secs = counted(counters, {"packed_walk": BOUNCES}, render)
    equal_renders("bvh_large", out, render(partial(finder, ops=PLAIN)))
    log(f"path bvh_large: scene built in {made:.2f} s; make_finder (LBVH "
        f"build on the card and pack) {build_s:.4f} s; render {secs:.4f} s, "
        f"traced {out[1].tolist()}, image mean {float(out[0].mean()):.6f}; "
        f"bitwise equal to the plain finder's render")
    return BOUNCES


def implicit_builds(counters, scene, base, skey):
    """make_finder with backend "onehot" (leaf DENSE_LEAF, expand 0) and
    "cluster" given no accel builds the LBVH on the card itself; bounce
    0 of the bench scene through the kernels (the dense-union branch's
    topwalk_union and cluster_intersect_mask; the cluster finder's
    cluster_intersect) against the PLAIN ops, bitwise."""
    from raypt_torch.accel.traverse import (PLAIN, find_closest_cluster,
                                            find_closest_onehot)
    from raypt_torch.render.integrator import make_finder, render_sample
    for backend, kw, want in (
            ("onehot", dict(onehot_leaf=DENSE_LEAF, onehot_expand=0),
             {"topwalk_union": 1, "cluster_intersect_mask": 1}),
            ("cluster", {}, {"cluster_intersect": 1})):
        cfg = base.replace(backend=backend, num_bounces=1, **kw)
        t0 = time.perf_counter()
        finder = make_finder(scene, cfg)
        build_s = time.perf_counter() - t0
        if backend == "onehot":
            plain = partial(find_closest_onehot, ops=PLAIN, **finder.keywords)
        else:
            clusters = finder.args[0]
            plain = (lambda s, ro, rd, active=None, c=clusters:
                     find_closest_cluster(s, c, ro, rd, active, ops=PLAIN))

        def render(f=finder, cfg=cfg):
            return render_sample(scene, cfg, skey, f, return_alive=True)

        out, secs = counted(counters, want, render)
        equal_renders(f"implicit {backend}", out, render(plain))
        log(f"implicit build, {backend}: make_finder with no accel (LBVH "
            f"on the card, clusters on the host) {build_s:.3f} s; bounce 0 "
            f"{secs:.4f} s through {sorted(want)}, bitwise equal to the PLAIN "
            f"ops")


def rgbd_loss(img, tgt):
    """scripts/baseline_config5.py's rgbd_loss: the RGB MSE plus
    FIT_DEPTH_W times the depth MSE over the pixels where both the image
    and the target hit (a hit / miss mismatch has no useful gradient)."""
    import torch
    rgb = torch.mean((img[..., :3] - tgt[..., :3]) ** 2)
    both = (img[..., 3] > 0) & (tgt[..., 3] > 0)
    sq = (img[..., 3] - tgt[..., 3]) ** 2
    d = (torch.sum(torch.where(both, sq, torch.zeros_like(sq)))
         / torch.clamp(both.sum(), min=1))
    return rgb + FIT_DEPTH_W * d


def config5_scene(dev, subdiv=LARGE_SUBDIV, width=FIT_WIDTH,
                  views=FIT_VIEWS):
    """BASELINE config #5's scene as scripts/baseline_config5.py:59-79
    builds it (one material: albedo 1, specular (0.3, 1, 0.3),
    specular_percent 0.5, roughness 0.8; the reference sky; no ground,
    no light), with _icosphere(subdiv) placed where the bunny stands in
    place of the absent OBJ; and the orbit's camera frames (FIT_ORBIT),
    on `dev`. Returns (scene, views, real vertices)."""
    import numpy as np
    from raypt_torch.core.scene import MaterialDef, SceneBuilder
    from raypt_torch.scenes.builtin import (_bunny_transform, _icosphere,
                                            load_reference_envmap)
    mesh = _icosphere(subdiv)
    b = SceneBuilder(env=load_reference_envmap())
    mat = b.add_material(MaterialDef(albedo=(1, 1, 1),
                                     specular=(0.3, 1.0, 0.3),
                                     specular_percent=0.5, roughness=0.8))
    pos = FIT_SCALE * mesh["positions"] + np.float32(FIT_SHIFT)
    b.add_mesh(pos, mesh["normals"], mesh["faces"], uvs=mesh["uvs"],
               transform=_bunny_transform(), material=mat)
    b.camera.viewport_width = b.camera.viewport_height = width
    cx, cy, cz, r = FIT_ORBIT
    frames = []
    for k in range(views):
        a = 2 * np.pi * k / views
        b.camera.position = (cx + r * np.sin(a), cy, cz - r * np.cos(a))
        b.camera.angle_y = 180.0 - np.degrees(a)
        frames.append(b.camera.rays().to(dev))
    return b.freeze(dev), frames, len(mesh["positions"])


def config5_case(dev, subdiv=LARGE_SUBDIV, width=FIT_WIDTH,
                 views=FIT_VIEWS):
    """The fit's inputs, as scripts/baseline_config5.py:113-153 makes
    them: RGB-D targets of the true scene (render_rgbd, key fold_in(
    key(0), k) for view k, through its LBVH built on the card), and the
    corrupted scene (offsets 0.8 sin(0.25 y + 0.3 x) n on the real
    vertices, albedo clip(0.4 a + 0.2, 0.02, 0.98)) with its LBVH.
    Returns (cfg, bad scene, its LBVH, stacked views, targets)."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.diff import stack_views
    from raypt_torch.diff.inverse import render_rgbd
    from raypt_torch.render.integrator import make_finder
    from raypt_torch.rng.sampler import fold_in, key
    scene, frames, nv = config5_scene(dev, subdiv, width, views)
    cfg = RenderConfig(width=width, height=width, samples_per_pixel=1,
                       num_bounces=FIT_BOUNCES, backend="bvh",
                       russian_roulette=False)
    m = scene.mesh
    finder = make_finder(scene, cfg, lbvh.build(m.positions, m.faces,
                                                m.face_valid))
    with torch.no_grad():
        targets = torch.stack([
            render_rgbd(scene.replace(camera=v), cfg, fold_in(key(0), k),
                        finder) for k, v in enumerate(frames)])
    n = m.normals / torch.clamp(torch.linalg.norm(m.normals, dim=-1,
                                                  keepdim=True), min=1e-9)
    off = 0.8 * torch.sin(0.25 * m.positions[:, 1:2]
                          + 0.3 * m.positions[:, 0:1]) * n
    off[nv:] = 0.0
    bad = scene.replace(
        mesh=m.replace(positions=m.positions + off),
        materials=scene.materials.replace(albedo=torch.clamp(
            scene.materials.albedo * 0.4 + 0.2, 0.02, 0.98)))
    bm = bad.mesh
    return (cfg, bad, lbvh.build(bm.positions, bm.faces, bm.face_valid),
            stack_views(frames), targets)


def fit_step_of(case, ops=None, tables=None, mesh=None):
    """The port's fit step with the config's settings (a refit every
    step, the Laplacian prior at FIT_LAP_W, render_rgbd, rgbd_loss):
    make_fit_step, or make_fit_step_sharded over `mesh`. ops=PLAIN
    renders through the plain walk (the finder's ops); with a `tables`
    list each step's packed table and realized positions are
    appended."""
    from raypt_torch.diff import make_fit_step
    from raypt_torch.diff.inverse import make_fit_step_sharded, render_rgbd
    from raypt_torch.diff.priors import make_laplacian_reg
    cfg, bad, bvh, _, _ = case
    m = bad.mesh
    reg = make_laplacian_reg(m.faces.cpu().numpy(),
                             m.face_valid.cpu().numpy(),
                             m.positions.shape[0], weight=FIT_LAP_W)

    def render(scene, cfg, k, finder):
        if tables is not None and (not tables or tables[-1][0] is not finder):
            tables.append((finder, finder.args[0].rows.clone(),
                           scene.mesh.positions.detach().clone()))
        return render_rgbd(scene, cfg, k,
                           finder if ops is None else partial(finder, ops=ops))

    kw = dict(bvh=bvh, loss_fn=rgbd_loss, refit=True, render_fn=render,
              param_reg=reg)
    if mesh is None:
        return make_fit_step(bad, cfg, FIT_TRAIN, **kw)
    return make_fit_step_sharded(bad, cfg, FIT_TRAIN, mesh, **kw)


def fit_params(case):
    """SceneParams.init(bad, lattice=FIT_LATTICE) and a fresh Adam."""
    import torch
    from raypt_torch.diff import SceneParams
    params = SceneParams.init(case[1], lattice=FIT_LATTICE)
    return params, torch.optim.Adam(params.parameters(), lr=FIT_LR)


def fit_run(case, steps, ops=None, counters=None, tables=None, mesh=None,
            walk="packed_walk"):
    """`steps` steps of fit_step_of(case, ops, tables, mesh) from
    fit_params(case). With counters each step runs under counted(),
    which requires FIT_BOUNCES + 1 launches of the walk `walk` (the
    kernel of the case's table layout) a view of this rank and no
    other. Returns (losses, seconds a step, the params after
    each step, their gradients in each step: the summed ones on a
    mesh)."""
    import torch
    from raypt_torch.rng.sampler import key
    views, targets = case[3], case[4]
    params, opt = fit_params(case)
    step = fit_step_of(case, ops, tables, mesh)
    k_local = targets.shape[0] // (1 if mesh is None else mesh.size)
    want = {walk: k_local * (FIT_BOUNCES + 1)}
    losses, secs, after, grads = [], [], [], []
    for _ in range(steps):
        def one():
            return step(params, opt, views, targets, key(0))
        if counters is not None:
            loss, s = counted(counters, want, one)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = one()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        losses.append(loss)
        secs.append(s)
        after.append({k: v.detach().clone()
                      for k, v in params.named_parameters()})
        grads.append({k: v.grad.detach().clone()
                      for k, v in params.named_parameters()})
    return losses, secs, after, grads


def same_fit(what, a, b, steps):
    """Raise unless two fit_run results agree bit for bit over their
    first `steps` steps: every loss and every parameter after each."""
    for i in range(steps):
        eq, err = bitwise_equal(a[0][i], b[0][i])
        if not eq:
            raise AssertionError(f"fit: {what}: step {i}'s loss differs "
                                 f"(abs err {err})")
        for k, v in a[2][i].items():
            eq, err = bitwise_equal(v, b[2][i][k])
            if not eq:
                raise AssertionError(f"fit: {what}: {k} after step {i} "
                                     f"differs (max abs err {err})")


def check_refit_tables(case, tables):
    """Each step's packed table is pack(refit(tree, positions)) of that
    step's realized positions, bitwise; every valid triangle lies inside
    its leaf's refitted box; the last step's internal boxes differ from
    the first's. Returns the boxes that moved."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.packed import pack
    _, bad, bvh, _, _ = case
    m = bad.mesh
    tree = bvh.tensors(m.positions.device)
    ni = bvh.num_leaves - 1
    valid = m.face_valid[tree.leaf_face]
    for i, (_, rows, pos) in enumerate(tables):
        fitted = lbvh.refit(tree, pos, m.faces, m.face_valid)
        ref = pack(fitted, pos, m.faces, m.face_valid).rows
        if not torch.equal(rows.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"fit: step {i}'s table is not the refit "
                                 f"of its positions")
        f = m.faces[tree.leaf_face].long()
        for k in range(3):
            p = pos[f[:, k]][valid]
            if not (bool((p >= fitted.bmin[ni:][valid]).all())
                    and bool((p <= fitted.bmax[ni:][valid]).all())):
                raise AssertionError(f"fit: step {i}: a triangle lies "
                                     f"outside its leaf box")
    moved = int((tables[-1][1][:ni, 0:6] != tables[0][1][:ni, 0:6]).any(
        dim=1).sum())
    if not moved:
        raise AssertionError("fit: the refit moved no box over the steps")
    return moved


def fit_loop(case, counters):
    """raypt_torch.diff.fit, the loop's entry point, on the same inputs
    at its defaults (SceneParams.init without a lattice, the l2 loss on
    RGB through one sample a view, Adam at FIT_LR) with the LBVH:
    FIT_LOOP_STEPS steps under counted() (FIT_VIEWS * FIT_BOUNCES
    packed_walk launches a step), finite losses, and a second call
    bitwise equal (losses and parameters). Returns its seconds."""
    import torch
    from raypt_torch.diff import fit, view_at
    cfg, bad, bvh, views, targets = case
    frames = [view_at(views, k) for k in range(targets.shape[0])]

    def loop():
        return fit(bad, cfg, frames, targets[..., :3], FIT_TRAIN[::2],
                   steps=FIT_LOOP_STEPS, learning_rate=FIT_LR, bvh=bvh)

    want = {"packed_walk": FIT_LOOP_STEPS * FIT_VIEWS * FIT_BOUNCES}
    (params, losses), secs = counted(counters, want, loop)
    params2, losses2 = loop()
    if not all(map(math.isfinite, losses)) or losses != losses2:
        raise AssertionError(f"fit(): losses {losses} then {losses2}")
    for k, v in params.named_parameters():
        eq, err = bitwise_equal(v.detach(), getattr(params2, k).detach())
        if not eq:
            raise AssertionError(f"fit(): {k} differs between two calls "
                                 f"(max abs err {err})")
    log(f"phase 9 fit(): {FIT_LOOP_STEPS} steps in {secs:.4f} s, losses "
        f"{[round(x, 6) for x in losses]}, packed_walk "
        f"{want['packed_walk']} launches; a second call bitwise equal")
    return secs


def fit_path(counters, dev):
    """BASELINE config #5's fit step on the card through make_fit_step
    (phase 9): FIT_STEPS steps through the packed walk's kernel, each
    under counted() (FIT_VIEWS * (FIT_BOUNCES + 1) launches); the loss
    must fall; the first FIT_PLAIN_STEPS again through the plain walk and
    a second kernel run, both bitwise equal to the first; each step's
    table is the refit of its positions and the boxes moved; then the
    loop entry point `fit` (fit_loop), refit + pack timed alone and one
    step profiled. Returns (the launches a step, the case, the first
    run, its median step's seconds after the first)."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.packed import pack
    from raypt_torch.accel.traverse import PLAIN
    t0 = time.perf_counter()
    case = config5_case(dev)
    cfg, bad, bvh, views, targets = case
    m = bad.mesh
    made = time.perf_counter() - t0
    hits = (targets[..., 3] > 0).float().mean(dim=(1, 2))
    if not bool(torch.isfinite(targets).all()) or float(hits.min()) <= 0 \
            or float(hits.max()) >= 1:
        raise AssertionError(f"fit: the targets are not finite, or a view "
                             f"sees no silhouette (hit shares "
                             f"{hits.tolist()})")
    tables = []
    run = fit_run(case, FIT_STEPS, counters=counters, tables=tables)
    losses = [float(x) for x in run[0]]
    log(f"phase 9 fit: {int(m.face_valid.sum())} faces in {m.num_faces} "
        f"slots, {targets.shape[0]} views of {cfg.width}^2, "
        f"{cfg.num_bounces} bounces; "
        f"scene, targets and LBVHs {made:.2f} s; hit share a view "
        f"{float(hits.min()):.3f}-{float(hits.max()):.3f}")
    for i, (loss, s) in enumerate(zip(losses, run[1])):
        log(f"phase 9 fit: step {i}: loss {loss:.6f}, {s:.4f} s")
    if not all(map(torch.isfinite, run[0])) or not losses[-1] < losses[0]:
        raise AssertionError(f"fit: the loss did not fall: {losses}")
    moved = check_refit_tables(case, tables)
    plain = fit_run(case, FIT_PLAIN_STEPS, ops=PLAIN)
    same_fit("the plain walk", run, plain, FIT_PLAIN_STEPS)
    again = fit_run(case, FIT_STEPS)
    same_fit("a second run", run, again, FIT_STEPS)
    fit_loop(case, counters)
    tree = bvh.tensors(dev)
    pos = tables[-1][2]

    def refit_pack():
        return pack(lbvh.refit(tree, pos, m.faces, m.face_valid), pos,
                    m.faces, m.face_valid)

    rp_ms = cuda_ms(refit_pack, 10)
    step_s = statistics.median(run[1][1:])
    launches = FIT_VIEWS * (FIT_BOUNCES + 1)
    busy_ms = profile_step("fit", lambda: fit_run(case, 1))
    log(f"phase 9 fit: median step {step_s:.4f} s after the first "
        f"(plain walk {statistics.median(plain[1]):.4f} s, second run "
        f"{statistics.median(again[1][1:]):.4f} s); kernel time of a "
        f"profiled step {busy_ms:.3f} ms, {100 * busy_ms / 1e3 / step_s:.1f}% "
        f"of the median step (the device's busy share); refit + pack on "
        f"the card "
        f"{rp_ms:.4f} ms ({100 * rp_ms / 1e3 / step_s:.2f}% of a step); "
        f"packed_walk {launches} launches a step; {moved} of "
        f"{tree.num_leaves - 1} internal boxes moved from step 0 to step "
        f"{FIT_STEPS - 1}; every "
        f"step's table the refit of its positions; the plain walk's "
        f"{FIT_PLAIN_STEPS} steps and a second run's {FIT_STEPS} bitwise "
        f"equal (losses and parameters); {time.perf_counter() - t0:.1f} s")
    return launches, case, run, step_s


def wide_info():
    """The wide walk's capacity-64 kernel as its library reports it
    (rk_wide_walk_info): registers, local bytes (its stack and any
    spill), resident blocks an SM and threads a block."""
    from raypt_torch.kernels._build import kernel_lib
    info = (ctypes.c_int * 4)()
    if kernel_lib().rk_wide_walk_info(ctypes.cast(info, ctypes.c_void_p)):
        raise AssertionError("rk_wide_walk_info failed")
    return list(info)


def compare_wide(stats, label, w, o, d, t, a, stack_d=None, timed=False):
    """wide_walk against traverse_wide on one wavefront, bitwise (t,
    face, overflow). Timed: also from a CUDA graph, with its bound, the
    larger of the rows once and the rays in and out over the HBM rate and
    the f32 operations of this wavefront's visits (counted by the plain
    walk). Returns (face, overflow)."""
    from raypt_torch.accel.wide import STACK_D, traverse_wide
    from raypt_torch.kernels import wide_walk as ww
    args = (w, o, d, t, a, stack_d or STACK_D)
    kt, kf, ko = ww.wide_walk(*args)
    pt, pf, po = traverse_wide(*args)
    stats.check("wide_walk", f"{label} t", kt, pt)
    stats.check("wide_walk", f"{label} face", kf, pf)
    stats.check("wide_walk", f"{label} overflow", ko, po)
    if timed:
        visits = []
        traverse_wide(*args, visits=visits)
        inner = sum(v[0] for v in visits)
        leaves = sum(v[1] for v in visits)
        live = int(a.sum())
        moved = nbytes(w.rows, o, d, t, a, kt, kf, ko)
        ops = (WIDE_INTERNAL_OPS * inner + WIDE_LEAF_OPS * leaves
               + WIDE_RAY_OPS * live)
        stats.time("wide_walk", label, ww.wide_walk, traverse_wide, args,
                   moved, ops)
        stats.time_graph("wide_walk", label, ww.wide_walk, args)
        rows = WIDE_INTERNAL_BYTES * inner + WIDE_LEAF_BYTES * leaves
        log(f"  {label:9s} visits {inner} internal + {leaves} leaf "
            f"({(inner + leaves) / max(live, 1):.1f} a live ray, "
            f"{len(visits)} plain steps), hits {int((kf >= 0).sum())}; rows read "
            f"{rows / 1e9:.3f} GB ({1e3 * rows / HBM_BYTES_PER_S:.4f} ms at "
            f"the HBM rate), table {w.rows.numel() * 4 / 1e6:.1f} MB")
    return kf, ko


def wide_edges(stats, scene, bvh, w, wave):
    """Phase 10's edge wavefronts of the wide walk, built from a bounce's
    (ro, rd, active), each bitwise against the plain walk, in blocks of
    EDGE_BLOCK rays (a quarter of a smaller wavefront): the first block
    dead and the rest live; direction components of
    exactly +-0 and of +-1e-13 (below the 1e-12 clamp) from the mesh's
    centre; origins at face centroids (inside leaf boxes) in random
    directions; two NaN rays (origin, then direction); the whole
    wavefront at stacks of WIDE_STACKS, where rays overflow; and one NaN
    vertex, in the triangles of the leaf rows (bvh, the LBVH of w,
    collapsed at the poisoned positions) and also in the boxes (the LBVH
    built from them: its boxes up to the root are NaN)."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.traverse import wavefront_inputs
    from raypt_torch.accel.wide import collapse
    o, d, t, a, _, _ = wavefront_inputs(scene, *wave, 1)
    o, d, t, a = o.clone(), d.clone(), t.clone(), a.clone()
    n = min(EDGE_BLOCK, o.shape[0] // 4)
    m = scene.mesh
    valid = m.faces[m.face_valid].long()
    centre = m.positions[valid.flatten()].mean(dim=0)
    a[:n] = False
    a[n:] = True
    axis = torch.arange(n, device=o.device)
    dirs = torch.zeros((n, 3), device=o.device)
    dirs[axis, axis % 3] = torch.where(axis % 2 == 1, 1.0, -1.0)
    dirs[::5, (1, 2)] = -0.0
    dirs[::7, 2] = 1e-13
    dirs[1::7, 0] = -1e-13
    o[n:2 * n] = centre
    d[n:2 * n] = dirs
    gen = torch.Generator(device=o.device).manual_seed(16)
    k = min(n, valid.shape[0])
    cent = m.positions[valid[:k]].mean(dim=1)
    rnd = torch.randn((k, 3), generator=gen, device=o.device)
    o[2 * n:2 * n + k] = cent
    d[2 * n:2 * n + k] = rnd / rnd.norm(dim=1, keepdim=True)
    o[3 * n, 0] = float("nan")
    d[3 * n + 1, 1] = float("nan")
    compare_wide(stats, "edges", w, o, d, t, a)
    hit = {}
    for sd in WIDE_STACKS:
        _, ovf = compare_wide(stats, f"stack {sd}", w, *wave_inputs_of(
            scene, wave), stack_d=sd)
        if not bool(ovf.any()):
            raise AssertionError(f"wide_walk: no ray overflowed a stack of "
                                 f"{sd}")
        hit[sd] = int(ovf.sum())
    pos = m.positions.clone()
    pos[valid[0, 0]] = float("nan")
    for label, tree in (("nan leaf", bvh), ("nan boxes", lbvh.build(
            pos, m.faces, m.face_valid))):
        compare_wide(stats, label, collapse(tree, pos, m.faces, m.face_valid),
                     o, d, t, a)
    log(f"phase 10 wide edges: dead, signed-zero and sub-clamp directions, "
        f"origins in leaf boxes, NaN rays, a NaN vertex's tree, and stacks "
        f"{WIDE_STACKS} ({hit} rays overflowed): bitwise equal")


def deep_stack(stats, dev):
    """wide_walk against the plain walk on deep_stack_case's wavefront,
    bitwise, at STACK_D and at stacks of DEEP_STACKS entries; the plain
    walk's record must show a stack deeper than 32 entries, so deep
    slots are written and read back, and rays must overflow the smaller
    stacks."""
    from raypt_torch.accel.wide import traverse_wide
    case = deep_stack_case(device=dev)
    depths = []
    traverse_wide(*case, depths=depths)
    deepest = max(int(x.max()) for x in depths if x.numel())
    if deepest <= max(DEEP_STACKS) - 1:
        raise AssertionError(f"deep_stack_case: the deepest stack {deepest} "
                             f"is not above {max(DEEP_STACKS) - 1}")
    compare_wide(stats, "deep stack default", *case)
    overflowed = {}
    for sd in DEEP_STACKS:
        _, ovf = compare_wide(stats, f"deep stack {sd}", *case, stack_d=sd)
        overflowed[sd] = int(ovf.sum())
        if not overflowed[sd]:
            raise AssertionError(f"deep_stack_case: no ray overflowed a "
                                 f"stack of {sd}")
    log(f"phase 10 deep stack: {case[1].shape[0]} rays through a chain of "
        f"{case[0].nw_cap} internal rows, stacks up to {deepest} entries; "
        f"bitwise equal at the default stack and at stacks {DEEP_STACKS} "
        f"({overflowed} rays overflowed)")


def deep_stack_case(levels=DEEP_LEVELS, rays=DEEP_RAYS, device="cuda",
                    seed=17):
    """A wide tree built to stack deep and a wavefront through it, as
    (WideBVH, ro, rd, t0, active). Triangles stacked along the view axis
    -z, each across it (p0 (-4, -4, z), e1 (12, 0, 0), e2 (0, 12, 0)),
    four a leaf row: leaf q (q = 0 the nearest) holds faces 4 q + k at z
    = -(1 + q + 0.2 k). A chain of `levels` internal rows: row j's
    entries are the leaves of ranks 3 (levels - 1 - j) + 1 to + 3 and,
    nearest, row j + 1 (for the last row, leaf 0), each box the hull of
    what lies under it, the four in an order rotated by j. A ray from
    the z = 0 plane heading down -z within 0.01 of the axis hits every
    box, pushes the three leaves at each row and descends, so its stack
    holds 3 (j + 1) entries after row j and 3 * levels at leaf 0, which
    it hits (t about 1); then it pops and tests every pushed leaf, 4 *
    levels + 1 visits in all. One ray in 16 is dead, one in 16 heads up
    +z (it misses the root's entries), one in 16 starts at t0 = 3.5 (it
    pushes only what starts nearer); the others start at BIG."""
    import numpy as np
    import torch
    from raypt_torch.accel.wide import ROW, WideBVH
    from raypt_torch.core.math3d import BIG
    n_leaf = 3 * levels + 1
    rows = np.zeros((levels + n_leaf + 1, ROW), np.float32)
    rows[:, 0:3], rows[:, 3:6] = BIG, -BIG
    bits = rows.view(np.int32)

    def hull(q0, q1):   # the box of leaves q0 .. q1
        return [-4.0, -4.0, -(1.6 + q1), 8.0, 8.0, -(1.0 + q0)]

    for q in range(n_leaf):
        for k in range(4):
            z = -(1.0 + q + 0.2 * k)
            rows[levels + q, 12 * k:12 * k + 9] = (-4, -4, z, 12, 0, 0, 0,
                                                  12, 0)
            bits[levels + q, 12 * k + 9] = 4 * q + k
    for j in range(levels):
        top = 3 * (levels - 1 - j)
        entries = [(hull(0, top), j + 1 if j + 1 < levels else levels)]
        entries += [(hull(q, q), levels + q) for q in range(top + 1, top + 4)]
        for e in range(4):
            box, child = entries[(e + j) % 4]
            rows[j, 6 * e:6 * e + 6] = box
            bits[j, 24 + e] = child
    rng = np.random.default_rng(seed)
    ro = np.zeros((rays, 3), np.float32)
    ro[:, :2] = rng.uniform(-1, 1, (rays, 2))
    rd = np.full((rays, 3), -1.0, np.float32)
    rd[:, :2] = rng.uniform(-0.01, 0.01, (rays, 2))
    lane = np.arange(rays) % 16
    rd[lane == 1, 2] = 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t0 = np.where(lane == 2, 3.5, BIG).astype(np.float32)
    dev = torch.device(device)
    return (WideBVH(rows=torch.from_numpy(rows).to(dev), root=0,
                    nw_cap=levels),
            *(torch.from_numpy(x).to(dev) for x in (ro, rd, t0)),
            torch.from_numpy(lane != 0).to(dev))


def wave_inputs_of(scene, wave):
    """A recorded bounce (ro, rd, active) as the finder hands it to the
    walk: (o, d, t0 from the sphere pass, active)."""
    from raypt_torch.accel.traverse import wavefront_inputs
    return wavefront_inputs(scene, *wave, 1)[:4]


def record_waves(scene, cfg, skey, finder):
    """The (ro, rd, active) each bounce of one render_sample hands the
    finder."""
    import torch
    from raypt_torch.render.integrator import render_sample
    rec = []

    def recording(s, ro, rd, active=None):
        rec.append((ro.reshape(-1, 3).clone(), rd.reshape(-1, 3).clone(),
                    active.reshape(-1).clone()))
        return finder(s, ro, rd, active)

    with torch.no_grad():
        render_sample(scene, cfg, skey, recording)
    return rec


def wide_path(stats, counters, dev, scene, bvh, base, skey):
    """Phase 10's bvh4 part: the wide tree collapsed on the card from the
    bench scene's LBVH; wide_walk against the plain walk on the four
    bounce wavefronts of the bench render (timed, also from graphs), on
    bvh_large's four (the kernel timed through the wrapper and from
    graphs), on wide_edges' and on deep_stack's; find_closest_wide
    at a stack of 2 (its retry launches the kernel twice) against the
    plain finder; then the bench render with backend "bvh4" through the
    kernel (one launch a bounce) against the plain walk's render,
    bitwise. Returns the render's launches and bvh_large's scene and
    LBVH."""
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.accel.traverse import KERNELS, PLAIN, find_closest_wide
    from raypt_torch.accel.wide import collapse
    from raypt_torch.kernels import wide_walk as ww
    from raypt_torch.render.integrator import make_finder, render_sample
    from raypt_torch.scenes.builtin import _icosphere, stanford_bunny
    m = scene.mesh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = collapse(bvh, m.positions, m.faces, m.face_valid)
    torch.cuda.synchronize()
    regs, local, blocks, threads = wide_info()
    log(f"phase 10 bvh4: collapse on the card {time.perf_counter() - t0:.4f} "
        f"s, rows {tuple(w.rows.shape)} ({w.nw_cap} internal slots), root "
        f"{w.root}; wide_walk: {regs} registers, {local} local bytes, "
        f"{blocks} blocks of {threads} resident an SM")
    cfg = base.replace(backend="bvh4")
    finder = make_finder(scene, cfg, w)
    waves = record_waves(scene, cfg, skey, finder)
    stats.path = "bvh4"
    with SmClock() as clock:
        for b, wave in enumerate(waves):
            compare_wide(stats, f"bounce {b}", w, *wave_inputs_of(scene, wave),
                         timed=True)
    log(f"phase 10 bvh4: wide_walk bitwise equal to traverse_wide on the "
        f"bench render's four wavefronts; {clock.summary()} while timed")
    large = stanford_bunny(mesh=_icosphere(LARGE_SUBDIV))
    large.camera.viewport_width = large.camera.viewport_height = WIDTH
    ls = large.freeze(dev)
    lm = ls.mesh
    ltree = lbvh.build(lm.positions, lm.faces, lm.face_valid)
    wl = collapse(ltree, lm.positions, lm.faces, lm.face_valid)
    large_ms = large_graph_ms = 0.0
    for b, wave in enumerate(record_waves(ls, cfg, skey,
                                          make_finder(ls, cfg, wl))):
        args = (wl, *wave_inputs_of(ls, wave))
        compare_wide(stats, f"large b{b}", *args)
        with SmClock() as clock:
            k_ms = cuda_ms(lambda: ww.wide_walk(*args), 10)
            g_ms = graph_us_per_call(lambda: ww.wide_walk(*args)) / 1e3
        large_ms += k_ms
        large_graph_ms += g_ms
        log(f"  large b{b} wide_walk kernel {k_ms:9.4f} ms, graph {g_ms:9.4f} "
            f"ms (device, no host work between calls); {clock.summary()}")
    log(f"phase 10 bvh_large: {int(lm.face_valid.sum())} faces, rows "
        f"{tuple(wl.rows.shape)} ({wl.rows.numel() * 4 / 1e6:.1f} MB); "
        f"four wavefronts bitwise equal; wide_walk {large_ms:.4f} ms a frame "
        f"through the wrapper, {large_graph_ms:.4f} from CUDA graphs")
    wide_edges(stats, scene, bvh, w, waves[1])
    deep_stack(stats, dev)
    ro, rd, active = waves[1]

    def retry(ops):
        return find_closest_wide(scene, w, ro, rd, active, stack_d=2, ops=ops)

    got, _ = counted(counters, {"wide_walk": 2}, lambda: retry(KERNELS))
    want = retry(PLAIN)
    for f in ("t", "tri", "sphere"):
        eq, err = bitwise_equal(getattr(got, f), getattr(want, f))
        if not eq:
            raise AssertionError(f"find_closest_wide at stack 2: {f} differs "
                                 f"from the plain finder's (max abs err "
                                 f"{err})")

    def render(f=finder):
        return render_sample(scene, cfg, skey, f, return_alive=True)

    render()   # warm-up
    out, secs = counted(counters, {"wide_walk": BOUNCES}, render)
    equal_renders("bvh4", out, render(partial(finder, ops=PLAIN)))
    log(f"path bvh4: bench render {secs:.4f} s through {BOUNCES} wide_walk "
        f"launches, traced {out[1].tolist()}, image mean "
        f"{float(out[0].mean()):.6f}; bitwise equal to the plain walk's "
        f"render; find_closest_wide at stack 2 (one retry) bitwise equal to "
        f"the plain finder's")
    return BOUNCES, (ls, ltree)


def cli_phase(counters, dev):
    """Phase 10's CLI part: raypt_torch.app.cli.main in-process on the
    card. render at its defaults (cornell_bunny, 512^2, 5 spp, 6 bounces,
    auto with the LBVH: bvh, 30 packed_walk launches), its image bitwise
    the direct render_frame's with the same accel; --backend bvh4 (30
    wide_walk launches) against render_frame through the bvh4 finder;
    --backend onehot (the bench path's four kernels, 30 launches each);
    --frames 1 --checkpoint twice against --frames 2; --aovs and --check
    (its image the default's); inverse on cornell_bunny at 32^2 for 3
    steps (bvh: 8 packed_walk launches, the target's 2 and 2 a step),
    finite losses and the saved parameters; bench exits non-zero naming
    its item."""
    import tempfile
    import torch
    from raypt_torch.app import cli
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.render.integrator import render_frame
    from raypt_torch.rng.sampler import key
    frame = CLI_SPP * CLI_BOUNCES
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "r.png")

        def run(*extra, expect=None):
            argv = ["render", "-o", out] + list(extra)
            res, secs = counted(counters, expect or {}, lambda: cli.main(argv))
            log(f"phase 10 cli: render {' '.join(extra) or '(defaults)'}: "
                f"{secs:.3f} s, launches {expect}, image mean "
                f"{float(res.mean()):.6f}")
            return res

        def direct(backend):
            b = cli._build_scene("cornell_bunny", (CLI_WIDTH, CLI_WIDTH), None)
            s = b.freeze(dev)
            cfg = RenderConfig(width=CLI_WIDTH, height=CLI_WIDTH,
                               samples_per_pixel=CLI_SPP,
                               num_bounces=CLI_BOUNCES, backend=backend)
            with torch.no_grad():
                return render_frame(s, cfg, key(0),
                                    accel=cli.render_accel(s, cfg))

        acc = run(expect={"packed_walk": frame})
        equal_renders("cli render", (acc, acc.new_zeros(0)),
                      (direct("auto"), acc.new_zeros(0)))
        acc4 = run("--backend", "bvh4", expect={"wide_walk": frame})
        equal_renders("cli render bvh4", (acc4, acc4.new_zeros(0)),
                      (direct("bvh4"), acc4.new_zeros(0)))
        run("--backend", "onehot", expect={
            k: frame for k in ("alive_compact", "topwalk_cm_u",
                               "cluster_expand", "alive_uncompact")})
        ck = os.path.join(tmp, "state.npz")
        run("--frames", "1", "--checkpoint", ck,
            expect={"packed_walk": frame})
        two = run("--frames", "1", "--checkpoint", ck,
                  expect={"packed_walk": frame})
        ref = run("--frames", "2", expect={"packed_walk": 2 * frame})
        equal_renders("cli checkpoint resume", (two, two.new_zeros(0)),
                      (ref, ref.new_zeros(0)))
        checked = run("--aovs", "--check", expect={"packed_walk": frame + 1})
        equal_renders("cli --check", (checked, checked.new_zeros(0)),
                      (acc, acc.new_zeros(0)))
        base = os.path.splitext(out)[0]
        for name in ("depth", "normal", "albedo"):
            if not os.path.getsize(f"{base}.{name}.png"):
                raise AssertionError(f"cli --aovs wrote no {name} image")
        argv = ["inverse", "--scene", "cornell_bunny", "--size", "32",
                "--steps", "3", "-o", os.path.join(tmp, "params.npz")]
        (params, losses), secs = counted(
            counters, {"packed_walk": 8}, lambda: cli.main(argv))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"cli inverse: losses {losses}")
        import numpy as np
        with np.load(os.path.join(tmp, "params.npz")) as z:
            if int(z["__step__"]) != 3 or ".albedo_logits" not in z.files:
                raise AssertionError(f"cli inverse: saved {z.files}")
        log(f"phase 10 cli: inverse cornell_bunny 32^2, 3 steps (bvh, 8 "
            f"packed_walk launches) {secs:.3f} s, losses {losses}")
        try:
            cli.main(["bench"])
        except SystemExit as e:
            if e.code in (0, None) or "Port bench" not in str(e.code):
                raise AssertionError(f"cli bench exited with {e.code!r}")
            log(f"phase 10 cli: bench exits non-zero: {e.code}")
        else:
            raise AssertionError("cli bench did not exit")


class one_rank_group:
    """A one-rank NCCL group on the card (raypt_torch.dist's
    init_distributed over a file:// store in a temporary directory),
    destroyed on exit; yields its "tiles" mesh."""

    def __enter__(self):
        import tempfile
        from raypt_torch.dist import sharding
        self.tmp = tempfile.TemporaryDirectory()
        backend = sharding.init_distributed(
            f"file://{self.tmp.name}/store", 1, 0, device="cuda",
            timeout=DIST_TIMEOUT)
        if backend != "nccl":
            raise AssertionError(f"one rank on the card: backend {backend}")
        return sharding.default_mesh()

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        self.tmp.cleanup()


def dist_loss(p, scene, cfg, k, ids, tgt, mask, accel):
    """Phase 11's slab loss: the masked squared error of one sample of
    the scene with p's positions and albedo against `tgt`."""
    import torch
    from raypt_torch.render.integrator import make_finder, render_sample
    from raypt_torch.rng.sampler import frame_key, sample_key
    s = scene.replace(mesh=scene.mesh.replace(positions=p["positions"]),
                      materials=scene.materials.replace(albedo=p["albedo"]))
    img = render_sample(s, cfg, sample_key(frame_key(k, 0), 0),
                        make_finder(s, cfg, accel), pixel_ids=ids)
    return torch.sum(((img - tgt) ** 2) * mask[:, None, None])


def dist_one_rank(counters, scene, cfgs, accels, bvh_card, fit_case,
                  fit_first):
    """Phase 11 (a), in this process on a one-rank NCCL group:
    render_frame_sharded of the bench scene through bvh (over the card's
    LBVH: packed_walk) and through the expand path's onehot accel (its
    four kernels) bitwise against render_frame with the same accel;
    loss_and_grad_sharded of dist_loss (positions and albedo, bvh)
    bitwise against plain autograd of the same loss over the whole
    image; FIT_PLAIN_STEPS steps of make_fit_step_sharded bitwise against
    phase 9's make_fit_step run. Every sharded call under counted()."""
    import torch
    from raypt_torch.dist import sharding
    from raypt_torch.render.integrator import pixel_id_grid, render_frame
    from raypt_torch.rng.sampler import key
    with one_rank_group() as mesh:
        for path, accel in (("bvh", bvh_card), ("expand", accels["expand"])):
            cfg = cfgs[path]
            want = {k: BOUNCES for k, (paths, _, _) in KERNELS.items()
                    if path in paths}
            img, secs = counted(counters, want, lambda: (
                sharding.render_frame_sharded(scene, cfg, key(0), mesh,
                                              bvh=accel)))
            with torch.no_grad():
                ref = render_frame(scene, cfg, key(0), accel=accel)
            equal_renders(f"one-rank sharded render {path}",
                          (img, img.new_zeros(0)), (ref, ref.new_zeros(0)))
            log(f"phase 11 one rank (nccl): render_frame_sharded {path} "
                f"{WIDTH}^2 bitwise equal to render_frame ({secs:.3f} s, "
                f"launches {want})")
            if path == "bvh":
                target = 0.8 * ref
        cfg, accel = cfgs["bvh"], accels["bvh"]
        m = scene.mesh
        p = {"positions": m.positions, "albedo": scene.materials.albedo}
        want = {"packed_walk": BOUNCES}
        (loss, grads), secs = counted(counters, want, lambda: (
            sharding.loss_and_grad_sharded(dist_loss, scene, p, cfg, mesh,
                                           key(0), target, bvh=accel)))
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        ref = dist_loss(leaves, scene, cfg, key(0), pixel_id_grid(
            cfg, m.positions.device), target, torch.ones(
                cfg.height, device=m.positions.device), accel)
        ref_grads = torch.autograd.grad(ref, list(leaves.values()))
        for what, x, y in [("loss", loss, ref.detach())] + [
                (k, grads[k], g) for k, g in zip(leaves, ref_grads)]:
            eq, err = bitwise_equal(x, y)
            if not eq:
                raise AssertionError(f"one-rank loss_and_grad_sharded: {what} "
                                     f"differs from plain autograd (max abs "
                                     f"err {err})")
        log(f"phase 11 one rank (nccl): loss_and_grad_sharded (positions, "
            f"albedo; bvh) bitwise equal to plain autograd: loss "
            f"{float(loss):.6f}, |grad albedo| max "
            f"{float(grads['albedo'].abs().max()):.6g} ({secs:.3f} s)")
        run = fit_run(fit_case, FIT_PLAIN_STEPS, counters=counters,
                      mesh=sharding.default_mesh(axis="views"))
        same_fit("the one-rank sharded step", run, fit_first, FIT_PLAIN_STEPS)
        log(f"phase 11 one rank (nccl): {FIT_PLAIN_STEPS} steps of "
            f"make_fit_step_sharded bitwise equal to phase 9's make_fit_step "
            f"(losses and parameters; "
            f"{FIT_VIEWS * (FIT_BOUNCES + 1)} packed_walk launches a step; "
            f"s {[round(x, 4) for x in run[1]]})")


def dist_rank(tmp):
    """One rank of phase 11 (b), started by dist_two_ranks with the
    launcher's env (RAYPT_NUM_PROCS, RAYPT_PROC_ID): the launcher's
    render at its defaults and its bench, each over its own store under
    `tmp`; then, over a third, DIST_FIT_STEPS view-sharded fit steps
    (rank 0 first takes the one-process step from the same parameters
    and Adam state; then a barrier, then the counted sharded step) and
    a second run of them. Results to tmp/rank<r>.pt."""
    import copy
    import torch
    import torch.distributed as dist
    from raypt_torch.dist import launcher, sharding
    from raypt_torch.kernels import packed_walk as pw
    from raypt_torch.rng.sampler import key
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RAYPT_PROC_ID"])
    counters = {"packed_walk": pw.packed_walk}
    out = {}

    def store(name):
        os.environ["RAYPT_COORDINATOR"] = f"file://{tmp}/store_{name}"

    store("render")
    img, out["render_s"] = counted(
        counters, {"packed_walk": DIST_SPP * DIST_BOUNCES},
        lambda: launcher.main(["render", "-o", os.path.join(tmp, "r.png")]))
    out["render"] = img.cpu()
    store("bench")
    out["bench"] = launcher.main(["bench"])
    store("fit")
    launcher.setup_from_env("cuda")
    mesh = sharding.default_mesh(axis="views")
    case = config5_case(sharding.local_device())
    views, targets = case[3], case[4]
    params, opt = fit_params(case)
    step = fit_step_of(case, mesh=mesh)
    ref_step = fit_step_of(case)
    want = {"packed_walk": FIT_VIEWS // mesh.size * (FIT_BOUNCES + 1)}

    def grads_of(ps):
        return {k: v.grad.detach().cpu() for k, v in ps.named_parameters()}

    rec = {k: [] for k in ("loss", "grads", "params", "secs", "ref_loss",
                           "ref_grads")}
    for _ in range(DIST_FIT_STEPS):
        if rank == 0:
            rp, ro = fit_params(case)
            rp.load_state_dict(params.state_dict())
            ro.load_state_dict(copy.deepcopy(opt.state_dict()))
            rec["ref_loss"].append(ref_step(rp, ro, views, targets,
                                            key(0)).cpu())
            rec["ref_grads"].append(grads_of(rp))
        dist.barrier()
        loss, secs = counted(counters, want, lambda: step(
            params, opt, views, targets, key(0)))
        rec["loss"].append(loss.cpu())
        rec["secs"].append(secs)
        rec["grads"].append(grads_of(params))
        rec["params"].append({k: v.detach().cpu()
                              for k, v in params.named_parameters()})
    # the summed buffer alone: what the step's all_reduce costs, after
    # the backward and unoverlapped with it
    grads = [v.grad for v in params.parameters()]
    loss = torch.zeros((), device=grads[0].device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_SUM_REPS):
        sharding.sum_over_mesh(mesh, loss, grads)
    torch.cuda.synchronize()
    rec["sum_ms"] = 1e3 * (time.perf_counter() - t0) / DIST_SUM_REPS
    rec["sum_bytes"] = 4 * (1 + sum(g.numel() for g in grads))
    again = fit_run(case, DIST_FIT_STEPS, mesh=mesh)
    rec["again_loss"] = [x.cpu() for x in again[0]]
    rec["again_params"] = [{k: v.cpu() for k, v in a.items()}
                           for a in again[2]]
    out["fit"] = rec
    dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def dist_two_ranks(dev, card, fit_step_s):
    """Phase 11 (b): DIST_RANKS processes on the card, each running
    dist_rank with the launcher's env; a rank that fails or outlasts
    DIST_PROC_TIMEOUT fails the phase (every rank is then killed). The
    launcher's image on every rank bitwise equal to this process's
    render_frame at its settings; its bench's rate; each fit step's loss
    and summed gradients within DIST_LOSS_RTOL and DIST_GRAD_RTOL of the
    one-process step, the parameters bitwise equal across the ranks,
    and the second run bitwise equal to the first."""
    import tempfile
    import torch
    from raypt_torch.accel import lbvh
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.render.integrator import render_frame
    from raypt_torch.rng.sampler import key
    from raypt_torch.scenes.builtin import cornell_box_with_bunny
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(DIST_RANKS)]
        env = {**os.environ, "PYTHONPATH": here,
               "RAYPT_NUM_PROCS": str(DIST_RANKS)}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.dist_rank(sys.argv[1])", tmp], cwd=here,
            env={**env, "RAYPT_PROC_ID": str(r)}, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(DIST_RANKS)]
        b = cornell_box_with_bunny()
        b.camera.viewport_width = b.camera.viewport_height = DIST_SIZE
        scene = b.freeze(dev)
        m = scene.mesh
        cfg = RenderConfig(width=DIST_SIZE, height=DIST_SIZE,
                           samples_per_pixel=DIST_SPP,
                           num_bounces=DIST_BOUNCES, backend="bvh")
        with torch.no_grad():
            ref = render_frame(scene, cfg, key(0), accel=lbvh.build(
                m.positions, m.faces, m.face_valid)).cpu()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, DIST_PROC_TIMEOUT
                                   - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for lg in logs:
            lg.seek(0)
            texts.append(lg.read())
            lg.close()
        wall = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(
                f"phase 11: rank return codes {[p.returncode for p in procs]}"
                f" after {wall:.1f} s:\n" + "\n".join(
                    f"--- rank {r}:\n{t[-4000:]}" for r, t in
                    enumerate(texts)))
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(DIST_RANKS)]
    for r, t in enumerate(texts):
        for line in t.splitlines():
            if "raypt_torch.dist:" in line or "Mray-seg/s" in line:
                log(f"  rank {r}: {line.strip()}")
    for r, out in enumerate(res):
        equal_renders(f"two-rank launcher render (rank {r})",
                      (out["render"], ref.new_zeros(0)),
                      (ref, ref.new_zeros(0)))
    log(f"phase 11 two ranks (gloo, one card): launcher render "
        f"(cornell_bunny {DIST_SIZE}^2, {DIST_SPP} spp, {DIST_BOUNCES} "
        f"bounces, bvh) bitwise equal to render_frame on both ranks; "
        f"{DIST_SPP * DIST_BOUNCES} packed_walk launches a rank; s "
        f"{[round(o['render_s'], 4) for o in res]} (start-up included)")
    log(f"phase 11 two ranks: launcher bench {DIST_SIZE}^2: "
        f"{[round(o['bench'], 4) for o in res]} Mray-seg/s a rank's view "
        f"of the mesh ({card})")
    fits = [o["fit"] for o in res]
    worst_l, worst_g = 0.0, 0.0
    for i in range(DIST_FIT_STEPS):
        for k, v in fits[0]["params"][i].items():
            for other in fits[1:]:
                if not bitwise_equal(v, other["params"][i][k])[0]:
                    raise AssertionError(f"phase 11 fit: {k} after step {i} "
                                         f"differs between the ranks")
        loss, ref_loss = fits[0]["loss"][i], fits[0]["ref_loss"][i]
        rel = abs(float(loss) / float(ref_loss) - 1.0)
        g, rg = fits[0]["grads"][i], fits[0]["ref_grads"][i]
        top = max(float(x.abs().max()) for x in rg.values())
        err = max(float((g[k] - rg[k]).abs().max()) for k in rg) / top
        worst_l, worst_g = max(worst_l, rel), max(worst_g, err)
        log(f"phase 11 fit step {i}: loss {float(loss):.6f} (one process "
            f"{float(ref_loss):.6f}, rel err {rel:.3e}); summed gradients "
            f"max abs err {err:.3e} of the largest |g| {top:.4g}; "
            f"{[round(f['secs'][i], 4) for f in fits]} s a rank")
        if rel > DIST_LOSS_RTOL or err > DIST_GRAD_RTOL:
            raise AssertionError(f"phase 11 fit step {i}: loss rel err {rel}"
                                 f" or gradient err {err} beyond "
                                 f"{DIST_LOSS_RTOL} / {DIST_GRAD_RTOL}")
    for f in fits:
        for i in range(DIST_FIT_STEPS):
            same = bitwise_equal(f["loss"][i], f["again_loss"][i])[0] and all(
                bitwise_equal(v, f["again_params"][i][k])[0]
                for k, v in f["params"][i].items())
            if not same:
                raise AssertionError(f"phase 11 fit: a second run differs "
                                     f"at step {i}")
    secs = [s for f in fits for s in f["secs"][1:]]
    log(f"phase 11 fit: {DIST_FIT_STEPS} steps over {DIST_RANKS} ranks x "
        f"{FIT_VIEWS // DIST_RANKS} views: worst loss rel err {worst_l:.3e} "
        f"(tolerance {DIST_LOSS_RTOL}), worst gradient err {worst_g:.3e} of "
        f"the largest |g| (tolerance {DIST_GRAD_RTOL}); parameters bitwise "
        f"equal across the ranks, a second run bitwise equal; median step "
        f"after the first {statistics.median(secs):.4f} s on two ranks "
        f"sharing the card, one process {fit_step_s:.4f} s (phase 9) "
        f"({card}); the summed buffer ({fits[0]['sum_bytes']} bytes, "
        f"gloo) alone {[round(f['sum_ms'], 4) for f in fits]} ms a rank; "
        f"the ranks' wall {wall:.1f} s")


def main():
    t_start = time.perf_counter()
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
    regs, local, blocks, threads, octant = packed_walk_info()
    log(f"  packed_walk: {regs} registers, {local} local (spill) bytes, "
        f"{blocks} blocks of {threads} resident an SM ({blocks * threads // 32} "
        f"warps), a block's rays {'by octant' if octant else 'in order'}")

    from raypt_torch.accel.clusters import (CLUSTER_LEAF, build_clusters,
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
    from raypt_torch.kernels import packed_walk as pw
    from raypt_torch.kernels import wide_walk as ww
    from raypt_torch.accel.packed import pack
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
    # the bvh path: the packed table of the LBVH built on the card
    bvh_card = check_lbvh("bench", m, seed=12)
    cfgs["bvh"] = base.replace(backend="bvh")
    accels["bvh"] = pack(bvh_card, m.positions, m.faces, m.face_valid)
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
        if path in ("pallas", "auto", "bvh"):
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
               "config4": compare_woop, "bvh": compare_bvh,
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
    compare_compact_edges(stats, scene, ro, rd, active)
    edge = active.clone()
    edge[:COMPACT_N] = False
    edge[COMPACT_N:2 * COMPACT_N] = True
    compare_expand(stats, "edge grps", scene, accels["expand"], ro, rd, edge,
                   timed=False)
    mixed, tile = mixed_tile(active, COMPACT_N)
    alive_c, union_pp = compare_expand(stats, "mixed", scene, accels["expand"],
                                       ro, rd, mixed, timed=False)
    blocks = alive_c[tile * 2048:(tile + 1) * 2048].view(-1, WALK_BLOCK)
    per_block = blocks.sum(dim=1).tolist()
    if per_block != [WALK_BLOCK, 44] + [0] * 6 or not bool(
            union_pp[tile].any()):
        raise AssertionError(f"mixed_tile: walk tile {tile} after the "
                             f"compaction holds {per_block} live rays a "
                             f"block, union row {union_pp[tile].tolist()}")
    log(f"  topwalk_cm_u: walk tile {tile} after the compaction with a live, "
        f"a 44-live and six dead blocks, bitwise")
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
                        walk_layouts(active), timed=False, worklist=False)
        log(f"  walk layouts ({what}): a dead, a one-live and a "
            f"last-warp-only block, bitwise")
    # and topwalk_cm_u on the same blocks of the expand path's wavefront
    for acc, what in ((accels["expand"], f"leaf {LEAF}"),
                      (accel16, f"leaf {MULTIWORD_LEAF}")):
        ro, rd, active = waves["expand"][1]
        compare_cm_u(stats, "layouts", scene, acc, ro, rd,
                     walk_layouts(active))
        log(f"  topwalk_cm_u layouts ({what}): a dead, a one-live and a "
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
    # the union walk with every ray of the first tile the same live ray:
    # all 256 want the same leaves at the same steps (the flushes of one
    # word contend), at leaf 128 and at leaf 16 (33 union words)
    ro, rd, active = waves["dense_union"][1]
    k = int(torch.nonzero(active)[0])
    same_o, same_d, same_a = ro.clone(), rd.clone(), active.clone()
    same_o[:dn.TILE], same_d[:dn.TILE], same_a[:dn.TILE] = ro[k], rd[k], True
    for acc in (accels["dense_union"], accel16):
        out = compare_dense_union(stats, "same ray", scene, acc, same_o,
                                  same_d, same_a, timed=False)
        if not bool(out[0].any()):
            raise AssertionError("the same-ray tile wants no cluster")
    log(f"  union walk: a dead tile and a tile of one repeated ray (ray {k}) "
        f"at leaves {DENSE_LEAF} and {MULTIWORD_LEAF}, bitwise")
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
        f"tiles overflow; finder through kernels (the fallback through "
        f"intersect_worklist's kernel) and plain bitwise equal "
        f"({time.perf_counter() - t0:.1f} s for both)")
    # the fallback's worklist intersection (every ray of an overflowed
    # tile against every cluster) at 2^22 and at STEP_PAIRS pairs a step
    ov = torch.nonzero(tile_worklists(clusters, o, d, seed, dn.TILE,
                                      OVERFLOW_CAP)[2]).flatten()
    rays = (ov[:, None] * dn.TILE + torch.arange(dn.TILE, device=dev)
            ).flatten()
    every = torch.arange(clusters.num_clusters, dtype=torch.int32,
                         device=dev).expand(ov.numel(), -1).contiguous()
    fb_args = (every, clusters.tri_rows, o[rays].contiguous(),
               d[rays].contiguous(), seed[rays].contiguous())
    kt, kf = dn.intersect_worklist(*fb_args)
    ms = cuda_ms(lambda: dn.intersect_worklist(*fb_args), 10)
    step_pairs = dn.STEP_PAIRS
    fb_out = []
    for pairs in (1 << 22, step_pairs):
        dn.STEP_PAIRS = pairs
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fb_out.append(dn.intersect_worklist_plain(*fb_args))
        torch.cuda.synchronize()
        log(f"  overflow fallback's plain intersect_worklist at {pairs} pairs "
            f"a step: {time.perf_counter() - t0:.3f} s, peak "
            f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.0f} MiB "
            f"above the {held / 2**30:.2f} GiB held ({rays.numel()} rays x "
            f"{clusters.num_clusters} clusters)")
    dn.STEP_PAIRS = step_pairs
    for x, y in zip(*fb_out):
        if not bitwise_equal(x, y)[0]:
            raise AssertionError("intersect_worklist depends on its step")
    stats.check("intersect_worklist", "overflowed tiles t", kt, fb_out[0][0])
    stats.check("intersect_worklist", "overflowed tiles face", kf,
                fb_out[0][1])
    pairs, kept = cull_audit(stats, "overflowed tiles", fb_args, fb_out[0])
    log(f"  overflow fallback's intersect_worklist kernel: {ms:.4f} ms on the "
        f"{ov.numel()} overflowed tiles, bitwise equal to the plain version; "
        f"the cull kept {kept} of {pairs} live ray-cluster pairs "
        f"({kept / max(pairs, 1):.4f}), none skipped held a taken hit")
    # the worklist kernel's edge cases on the non-fused path's bounce-1
    # wavefront (its first MULTIWORD_RAYS rays)
    ro, rd, active = (x[:MULTIWORD_RAYS].contiguous()
                      for x in waves["unfused"][1])
    _, wl_args = compare_unfused(stats, "wl edges", scene, accels["unfused"],
                                 ro, rd, active, timed=False)
    lanes, slots = worklist_edges(stats, *wl_args)
    log(f"  intersect_worklist edges: -1 gaps, a repeated id, an all -1 and "
        f"an all-dead tile, a coincident triangle in a later lane ({lanes} "
        f"rays: the first lane kept) and a copied cluster before and after "
        f"its original ({slots} rays: the earlier slot kept), bitwise")
    cull_edges(stats, accels["unfused"].clusters.tri_rows, dev)
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
    log("phase 3 bvh edges: packed_walk on edge-case wavefronts")
    walk_edges(stats, scene, accels["bvh"], *waves["bvh"][:2])
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
                "topwalk": wk.topwalk,
                "cluster_intersect_mask_woop": dn.cluster_intersect_mask_woop,
                "cluster_intersect_grouped": dn.cluster_intersect_grouped,
                "intersect_worklist": dn.intersect_worklist,
                "packed_walk": pw.packed_walk,
                "wide_walk": ww.wide_walk,
                **{name: getattr(pw, name) for name in LAYOUT_FLAGS},
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
    t0 = time.perf_counter()
    options_phase(stats, counters, scene, accels, waves, cfgs["dense_union"],
                  skey)
    log(f"phase 5 options: {time.perf_counter() - t0:.1f} s")

    # phase 6: the bench loss forward and backward; the non-fused path's
    # forward only (its finder is not one RenderConfig selects; the auto
    # path runs the pallas path's finder)
    for path in ("expand", "dense_union", "cluster", "pallas", "config4",
                 "bvh"):
        bench_loss(path, scenes[path], cfgs[path], skeys[path],
                   accels.get(path))
    grads_bitwise("bvh", scene, cfgs["bvh"], skey,
                  (finder_of("bvh"), finder_of("bvh", PLAIN)))

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

    # phase 8: the bvh backend beyond the bench path
    t0 = time.perf_counter()
    cli_launches = cli_default_path(counters, dev)
    large_launches = large_path(counters, dev, skey)
    implicit_builds(counters, scene, base, skey)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s; packed_walk launches a "
        f"frame: bvh {launches['packed_walk']}, cli_default {cli_launches} "
        f"({CLI_BOUNCES} a sample), bvh_large {large_launches}")

    # phase 9: BASELINE config #5's fit step
    t0 = time.perf_counter()
    fit_launches, fit_case, fit_first, fit_step_s = fit_path(counters, dev)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s; packed_walk launches a "
        f"fit step: {fit_launches}")

    # phase 10: the CLI and bvh4
    t0 = time.perf_counter()
    launches["wide_walk"], large = wide_path(stats, counters, dev, scene,
                                             bvh_card, base, skey)
    cli_phase(counters, dev)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s; wide_walk launches a "
        f"bench frame: {launches['wide_walk']}")

    # phase 11: raypt_torch.dist
    t0 = time.perf_counter()
    dist_one_rank(counters, scene, cfgs, accels, bvh_card, fit_case,
                  fit_first)
    dist_two_ranks(dev, smi[0], fit_step_s)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s; the call so far "
        f"{time.perf_counter() - t_start:.1f} s ({smi[0]})")

    # phase 12: the packed table's other layouts
    t0 = time.perf_counter()
    layouts_phase(stats, counters, launches, dev, scene, bvh_card, base, skey,
                  waves["bvh"], large, fit_case, fit_first)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s; the call so far "
        f"{time.perf_counter() - t_start:.1f} s ({smi[0]})")

    for path, (pairs, kept, union_ms) in stats.cull.items():
        log(f"intersect_worklist's cull, {path}: kept {kept} of {pairs} live "
            f"ray-cluster pairs a frame ({kept / max(pairs, 1):.4f}); bound "
            f"{stats.by_path[('intersect_worklist', path)][2]:.4f} ms on "
            f"the kept pairs and the cull, {union_ms:.4f} ms had every live "
            f"pair been tested (information)")
    for name, ms in stats.graph_ms.items():
        log(f"{name}: {ms:.4f} ms per frame replayed from CUDA graphs "
            f"(device time; {stats.ms[name]:.4f} through the wrapper)")
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
