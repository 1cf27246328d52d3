"""Design sweep of the finder kernels on the card:

    python -m raypt_torch.kernels.sweep [--against DIR] [--out FILE]
                                        [--kernels K ...]
    python -m raypt_torch.kernels.sweep --kernels regroup --against DIR
    python -m raypt_torch.kernels.sweep --kernels permute diag --against DIR

Variants of a kernel's constants are built from its source with those
constants set (`_set`), each as a library of its own:
  * woop: the Woop union kernel (`csrc/cluster_intersect.cu`, struct
    WoopTest: threads a tile `kThreads`, rays a thread `kRays`, the most
    threads that share a ray's triangles `kMaxSplit`, the launch bound's
    `kMinBlocks`); the first variant is the package's own setting;
  * worklist: the worklist kernel, the union template's ListSource
    instance (struct MtTest, the same four constants);
  * slots: intersect_worklist, the worklist test of every slot
    (`csrc/cluster_intersect.cu`, the worklist test's design block:
    `kCullCarry` 0 for the cull by the grown box alone, 1 for the box
    and the carry; `kCullRays` kept rays and one of `kCullChunks` chunks
    of the triangles an item; `kCullMinBlocks`, the launch bound), on
    the non-fused path's four wavefronts; the kernel before the cull
    (every live ray against every slot's cluster) is a parent
    checkout's, through `--against`;
  * dense: `closest_dense` (`csrc/dense_closest.cu`: threads a block
    `kThreads`, rays a thread `kRays`, triangles a stage `kStage`,
    threads sharing a group of rays `kSplit`, the pre-test `kCull`), and
    "all_tested", the package kernel on a table whose zero ww rows carry
    a 1e-13 instead (no ray can hit such a triangle either, so the
    result is the same, but the kernel tests every slot: the design
    without the skip);
  * walk: the mask-only walk, the package's kernel beside the designs of
    `csrc/walk_designs.cu` (walks a thread interleaved, live rays
    packed, threads refilled from the packed rays; that file says how),
    built as one library;
  * rows: the mask-only walk's ray-major mode (`topwalk`,
    `rk_topwalk_mask_rows`: each ray's words stored by its thread) beside
    "rows_staged" of `csrc/walk_designs.cu` (the block's rows built in
    shared memory, then stored coalesced) and "transposed" (the
    word-major mode, then `.T.contiguous()`: the route before the ray-
    major mode), on the walk's wavefronts (config4's eight, then the
    dense-union path's four, which are the non-fused path's);
  * mask: the Moller-Trumbore union kernel, the package's alone;
  * union: the union walk (`csrc/onehot_walk.cu`, the union walk's
    design block: `kUnionWarpFlush`, a warp's flushes of one word merged
    into one atomicOr or not);
  * compact: the alive compaction (`csrc/compact.cu`, the compaction's
    design block: lanes a block `kChunk`, `kTwoPass` 1 for a count pass
    and a scatter, 0 for each block recounting its group: two passes at
    128, 512 and 1,024 lanes, recounts at 256 and 1,024);
  * cm_u: the mask-and-union walk (`rk_topwalk`), the package's alone;
  * uncompact: the uncompaction (`csrc/compact.cu`, the same design
    block: `kTwoPass` 0 recounts in each block), called as the expand
    finder calls it, with the counts the compaction of the same mask
    left; and "count_pass", the package's kernel without them, so that
    it counts each chunk again first;
  * packed: the skip-link walk of the packed LBVH (`rk_packed_walk`),
    the package's kernel beside the designs of
    `csrc/packed_walk_designs.cu` (PACKED_DESIGNS: "pr12", the first
    kernel, and the designs tried since; that file says how each
    walks), built as one library, and PRESORTED: a design on the
    wavefront's live rays sorted by direction octant and / or the Morton
    code of their origin (`presort`; the sort timed apart, `sort_ms`),
    its results put back in launch order. Its wavefronts: the four of the bench
    scene's 1024^2 render through the bvh finder (the LBVH built on the
    card) and the four of bvh_large (`chip_smoke.py`'s: the icosphere
    of 81,920 triangles, `auto` -> bvh). Each line also gives the
    design's registers, local (spill) bytes and resident warps an SM,
    the instructions of its walk loop (`kernels.sass`), and per
    wavefront the SIMD efficiency and mixed-step share of its schedule
    (`accel.packed.simd_efficiency`, `mixed_share`, on the plain walk's
    record or the while-while model's, `traverse_while_while`);
  * wide: the ordered-stack walk of the 4-wide BVH (`rk_wide_walk`), the
    package's kernel beside the designs of `csrc/wide_walk_designs.cu`
    (WIDE_DESIGNS: "pr16", the first kernel, and the `designs::Design`s
    over the steps of `csrc/wide_walk.cuh`; that file says how each
    walks; KEPT is the one the package kernel writes out), built as one
    library. Its wavefronts: the four of the bench scene's 1024^2
    render through the bvh4 finder and the four of bvh_large's (each
    LBVH built and collapsed on the card). Each line also gives the
    design's registers, local bytes, resident warps an SM and shared
    stack slots, the instructions of its walk loop, and per wavefront
    the SIMD efficiency and mixed-step share of one thread a ray in the
    octant order of the design's blocks and the stack depths the walk
    reaches (`wide_schedule`: the plain walk's `steps` and `depths`
    records);
  * layouts: the walks of the packed table's other layouts
    (`rk_layout_walk`, layouts 0-3: cherry, lookahead, quad, quad_la),
    the package's kernels beside the designs of
    `csrc/packed_layouts_designs.cu` (LAYOUT_DESIGNS: "pr19", PR 19's
    kernels over the tables' own rows, all four layouts, and the
    `rk::lay::Design`s over the split tables of
    `csrc/packed_layouts.cuh`, each the cherry and quad layouts or the
    two lookahead ones (LAYOUT_WALKS); that file says how each walks; the
    package writes out `layout_kept()`), built as one library. Its
    wavefronts: the four of the bench scene's 1024^2 render through the
    bvh finder and the four of bvh_large's, each walked over the four
    tables of the same LBVH (`*_by_path`: "bvh_cherry", "bvh_lookahead",
    "bvh_quad", "bvh_quad_la" and the same of "bvh_large"); a design
    runs and is timed on its layouts' wavefronts only (its
    "ms_per_wavefront" null on the others, its "ms_per_frame" summed
    over its own). Each line also gives, per layout, the design's
    registers, local bytes and resident warps an SM, the instructions
    of its loops that hold a 16-byte load (the shortest, "sass_loop",
    and the longest, "sass_pass"), and per path the bytes a visit reads
    (`layout_bytes`, on the plain walk's record and the plain model's
    right-box tests).
  * cycle, sel, permute (`--kernels regroup`, all three): the regroup
    probes' kernels (`csrc/regroup.cu`, `probes/regroup.py`) on their
    scripts' default inputs (`probes/cycle_budget.py`: full, no_mm and
    fixed_s at 16 and 64 cycles, 8,192 lanes, 128 programs;
    `probes/sel_probe.py`: 16, 64 and 256 cycles, 2,048 lanes, 128
    programs; `probes/permute_probe.py` and `permute_probe2.py`: summed
    at 8, 32 and 128 cycles, chained with and without fixed_s at 16 and
    64), each call a wavefront.
    cycle's variants are its design block (CYCLE_VARIANTS: threads a
    block, slots a block, values staged at once; "stage256" stages
    fixed_s's runs in two chunks for each chunk of cycles); a parent
    checkout's kernels, through `--against`, may be the first ones (one
    block of 1,024 threads a program). permute's variant is its design
    block (PERMUTE_VARIANTS: "slot_tile" moves each cycle's selected
    lanes through the shared 128-slot tile and back, cycles in order,
    behind the same ballot ranks; the package keeps each lane's rows in
    registers over its selecting cycles, testing the scan's count every 8
    ballots; "rank2" and "rank4" every 2 or 4);
  * diag: the expansion diagnostics kernel (`rk_expand_diag`,
    `csrc/expand_diag.cu`, `probes/expand_diag2.py::diag`) on the
    probe's default wavefront (the bunny's 256^2 primary rays, the leaf-64
    walk's mask, programs of 2,048 rays), one call; its variants are its
    design block (DIAG_VARIANTS: the most warps a block).
With `--against`, the kernels of another checkout (DIR/raypt_torch/csrc)
join as variant "against" (a `compact.cu` without `chunk_count_kernel`,
or whose uncompaction is `for_each_destination`'s, is called with the
older signature: no scratch). Each variant is held
bitwise against the package's kernel, then all are timed in turns (CUDA
events, mean of 10 launches after a warm-up, `--rounds` rounds; union,
compact, cm_u and uncompact also replayed from a CUDA graph of 10
calls, which leaves out the host work between calls) on the wavefronts
of 1024^2 renders recorded on the card: the eight bounces of the
config-4 render (`scripts/baseline_config4.py`: leaf 128; woop and
walk), and the four of the bench scene's renders through the
dense-union finder (leaf 128: walk, union and mask), the cluster finder
(clusters of 64: worklist), the onehot finder's non-fused branch (leaf
128: slots),
the pallas finder (dense), the expand
finder (`bench.py`'s: leaf 384, groups of 32,768; compact, cm_u,
uncompact), the bvh finder (packed, with bvh_large's) and the bvh4
finder (wide, with bvh_large's), while
nvidia-smi samples the SM clock. Only the renders of the kernels asked
for are made. Prints the card's
name and power limit, then one JSON line a variant: ms per frame of
each round (summed over the wavefronts), the last round's ms per
wavefront, the same from graph replay where taken, and the SM clock.
Runs only on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import torch

from .._native_build import BUILD_DIR, build_library
from ..accel.packed import (WARP, Packed2LBVH, Packed4LBVH, PackedLALBVH,
                            PackedLBVH, safe_reciprocal, split_start,
                            split_steps, split_table)
from ._build import CSRC_DIR, KERNEL_HEADERS, NVCC_FLAGS, _nvcc, kernel_lib

WIDTH = 1024
LEAF = 128
EXPAND_LEAF = 384     # bench.py's finder
EXPAND_N = 8192
COMPACT_N = 32768
LARGE_SUBDIV = 6      # bvh_large's icosphere (81,920 triangles)
# variant name -> the constants it sets
WOOP_VARIANTS = {
    "t512_rays2_split32": dict(kThreads=512, kRays=2, kMaxSplit=32,
                               kMinBlocks=2),
    "t512_rays1_split32": dict(kThreads=512, kRays=1, kMaxSplit=32,
                               kMinBlocks=2),
    "t1024_rays2_split32": dict(kThreads=1024, kRays=2, kMaxSplit=32,
                                kMinBlocks=1),
    "t1024_rays1_split32": dict(kThreads=1024, kRays=1, kMaxSplit=32,
                                kMinBlocks=1),
    "t256_rays2_split32": dict(kThreads=256, kRays=2, kMaxSplit=32,
                               kMinBlocks=4),
    "t256_rays1_split32": dict(kThreads=256, kRays=1, kMaxSplit=32,
                               kMinBlocks=4),
    "t256_rays1_split1": dict(kThreads=256, kRays=1, kMaxSplit=1,
                              kMinBlocks=4)}
# the worklist kernel's (struct MtTest of csrc/cluster_intersect.cu; the
# package: 128 threads, two rays, launch bound 6, no split)
LIST_VARIANTS = {
    "t128_rays4_split1": dict(kThreads=128, kRays=4, kMaxSplit=1,
                              kMinBlocks=4),
    "t256_rays1_split1": dict(kThreads=256, kRays=1, kMaxSplit=1,
                              kMinBlocks=3),
    "t256_rays2_split1": dict(kThreads=256, kRays=2, kMaxSplit=1,
                              kMinBlocks=3),
    "t128_rays2_split32": dict(kThreads=128, kRays=2, kMaxSplit=32,
                               kMinBlocks=6),
    "t256_rays1_split32": dict(kThreads=256, kRays=1, kMaxSplit=32,
                               kMinBlocks=3),
    "t256_rays2_split32": dict(kThreads=256, kRays=2, kMaxSplit=32,
                               kMinBlocks=3),
    "t512_rays1_split32": dict(kThreads=512, kRays=1, kMaxSplit=32,
                               kMinBlocks=1)}
# intersect_worklist's (the worklist test's design block of
# csrc/cluster_intersect.cu; the package: the box and carry cull, items
# of one kept ray and an eighth of the triangles, launch bound 6)
SLOT_VARIANTS = {
    "box": dict(kCullCarry=0),
    "chunks4": dict(kCullChunks=4),
    "chunks16": dict(kCullChunks=16),
    "rays2": dict(kCullRays=2),
    "mb8": dict(kCullMinBlocks=8),
    "rays2_mb8": dict(kCullRays=2, kCullMinBlocks=8)}
# closest_dense's (csrc/dense_closest.cu; the package: 128 threads, four
# rays, each group of rays split over four threads, stages of 256
# triangles, no pre-test)


def _dense(threads, rays, split, stage=256, cull=0):
    return dict(kThreads=threads, kRays=rays, kStage=stage, kSplit=split,
                kCull=cull)


DENSE_VARIANTS = {
    "t128_rays1_split4": _dense(128, 1, 4),
    "t128_rays2_split4": _dense(128, 2, 4),
    "t128_rays8_split4": _dense(128, 8, 4),
    "t128_rays4_split1": _dense(128, 4, 1),
    "t128_rays4_split2": _dense(128, 4, 2),
    "t128_rays4_split8": _dense(128, 4, 8),
    "t256_rays4_split4": _dense(256, 4, 4),
    "t512_rays4_split4": _dense(512, 4, 4),
    "t128_rays4_split4_stage128": _dense(128, 4, 4, stage=128),
    "t128_rays4_split4_stage512": _dense(128, 4, 4, stage=512),
    "t256_rays1_split1": _dense(256, 1, 1),
    "t256_rays2_split1": _dense(256, 2, 1),
    "t128_rays4_split4_cull": _dense(128, 4, 4, cull=1),
    "t256_rays2_split1_cull": _dense(256, 2, 1, cull=1)}
# the union walk's (csrc/onehot_walk.cu; the package flushes a word a
# thread)
UNION_VARIANTS = {"warp_flush": dict(kUnionWarpFlush=1)}
# the compaction's (csrc/compact.cu; the package: two passes, chunks of
# 256 lanes)
COMPACT_VARIANTS = {
    f"{design}_{chunk}": dict(kChunk=chunk, kTwoPass=int(design == "twopass"))
    for design, chunks in (("twopass", (128, 512, 1024)),
                           ("recount", (256, 1024))) for chunk in chunks}
COMPACT_SCRATCH_CHUNK = 128   # the smallest kChunk of the variants
# the uncompaction's (the same block; the package: two passes, its own
# count pass)
UNCOMPACT_VARIANTS = {"recount_256": dict(kChunk=256, kTwoPass=0)}
# the cycle kernel's design block (threads a block, slots a block, values
# staged at once); the package's is kCycleThreads 128, kCycleGroup 8,
# kCycleStage 2048
CYCLE_VARIANTS = {
    name: dict(kCycleThreads=t, kCycleGroup=g, kCycleStage=st)
    for name, t, g, st in [("g16", 128, 16, 2048), ("g4", 128, 4, 2048),
                           ("t256_g16", 256, 16, 2048), ("t64", 64, 8, 2048),
                           ("stage256", 128, 8, 256)]}
# the permute kernel's design block: kPermuteSlots 1 moves each cycle's
# lanes through the slot tile (the package's is 0: rows in registers);
# kRankWords ballots a scan takes between two tests of its count
PERMUTE_VARIANTS = {"slot_tile": dict(kPermuteSlots=1),
                    "rank2": dict(kRankWords=2), "rank4": dict(kRankWords=4)}
# the diagnostics kernel's design block: the most warps a block (an item
# each at a time; the package's 16)
DIAG_VARIANTS = {"warps32": dict(kDiagWarps=32), "warps8": dict(kDiagWarps=8)}
# kernel -> (source, C entry point, scope of its constants, variants)
SWEPT = {
    "woop": ("cluster_intersect.cu", "rk_cluster_intersect_mask_woop",
             "struct WoopTest {", WOOP_VARIANTS),
    "worklist": ("cluster_intersect.cu", "rk_cluster_intersect",
                 "struct MtTest {", LIST_VARIANTS),
    "slots": ("cluster_intersect.cu", "rk_intersect_worklist",
              "// The worklist test's design", SLOT_VARIANTS),
    "dense": ("dense_closest.cu", "rk_closest_dense",
              "// The main kernel's design", DENSE_VARIANTS),
    "walk": ("onehot_walk.cu", "rk_topwalk_mask", None, {}),
    "rows": ("onehot_walk.cu", "rk_topwalk_mask_rows", None, {}),
    "mask": ("cluster_intersect.cu", "rk_cluster_intersect_mask", None, {}),
    "union": ("onehot_walk.cu", "rk_topwalk_union", "// The union walk's design",
              UNION_VARIANTS),
    "compact": ("compact.cu", "rk_alive_compact", "// The compaction's design",
                COMPACT_VARIANTS),
    "cm_u": ("onehot_walk.cu", "rk_topwalk", None, {}),
    "uncompact": ("compact.cu", "rk_alive_uncompact",
                  "// The compaction's design", UNCOMPACT_VARIANTS),
    "packed": ("packed_walk.cu", "rk_packed_walk", None, {}),
    "wide": ("wide_walk.cu", "rk_wide_walk", None, {}),
    "layouts": ("packed_layouts.cu", "rk_layout_walk", None, {}),
    "cycle": ("regroup.cu", "rk_cycle", "// The cycle kernel's design",
              CYCLE_VARIANTS),
    "sel": ("regroup.cu", "rk_sel", None, {}),
    "permute": ("regroup.cu", "rk_permute", "// The permute kernel's design",
                PERMUTE_VARIANTS),
    "diag": ("expand_diag.cu", "rk_expand_diag",
             "// The diagnostics kernel's design", DIAG_VARIANTS)}
# --kernels names that stand for several
FAMILIES = {"regroup": ("cycle", "sel", "permute")}
# timed also from CUDA graph replay: kernels of tens of microseconds,
# where a direct call's host work may outlast the kernel
GRAPHED = ("union", "compact", "cm_u", "uncompact", "packed", "wide",
           "layouts", "rows", "cycle", "sel", "permute", "diag")
# the walks whose designs --designs picks (the package's always runs)
DESIGNED = ("packed", "wide", "layouts")
# the walk's designs: entry rk_walk_<name> of csrc/walk_designs.cu
WALK_DESIGNS = ("unpacked", "interleaved2", "interleaved3",
                "packed_interleaved2", "refilled1", "refilled2")
# the ray-major walk's designs, entries of the same file
ROW_DESIGNS = ("rows_staged",)


def _packed_designs() -> dict:
    """The packed walk's designs: name -> its designs::Design (threads a
    block, while-while batch, refill threshold, launch bound's blocks an
    SM, L1 priorities, carve-out, octant sort, persistent blocks an SM,
    counting sort's bits an axis + 1, the warps' sort), read from the
    RK_PWALK_DESIGN lines of csrc/packed_walk_designs.cu (entry points
    rk_pwalk_<name>); None for pr12 and lean, the walks over the table's
    own rows, which take no scratch."""
    with open(os.path.join(CSRC_DIR, "packed_walk_designs.cu")) as f:
        made = re.findall(r"^RK_PWALK_DESIGN\((\w+), ([-\d, ]+)\)$", f.read(),
                          re.M)
    return {"pr12": None, "lean": None,
            **{n: tuple(int(x) for x in v.split(", ")) for n, v in made}}


PACKED_DESIGNS = _packed_designs()


def _wide_designs() -> dict:
    """The wide walk's designs: name -> its designs::Design (threads a
    block, shared stack slots, launch bound's blocks an SM, step form,
    while-while threshold, persistent blocks an SM, cooperative leaf and
    internal thresholds, refill threshold), read from the
    RK_WWALK_DESIGN lines of csrc/wide_walk_designs.cu (entry points
    rk_wwalk_<name>); None for pr16, the first kernel."""
    with open(os.path.join(CSRC_DIR, "wide_walk_designs.cu")) as f:
        made = re.findall(r"^RK_WWALK_DESIGN\((\w+), ([-\d, ]+)\)$", f.read(),
                          re.M)
    return {"pr16": None,
            **{n: tuple(int(x) for x in v.split(", ")) for n, v in made}}


WIDE_DESIGNS = _wide_designs()
KEPT = "coop_mb10"   # the design csrc/wide_walk.cu writes out
# the layouts swept, by rk_layout_walk's codes
LAYOUT_CODES = {0: "cherry", 1: "lookahead", 2: "quad", 3: "quad_la"}
# the layouts each kind of design line of csrc/packed_layouts_designs.cu
# walks: RK_LWALK_DESIGN the plain internal rows', RK_LWALK_LA_DESIGN the
# lookahead rows'
DESIGN_LINES = {"RK_LWALK_DESIGN": (0, 2), "RK_LWALK_LA_DESIGN": (1, 3)}


def _layout_designs() -> tuple:
    """The layout walks' designs: (name -> its rk::lay::Design (threads a
    block, launch bound's blocks an SM, slot loads, every slot tested,
    how a lookahead row's sectors are read), name -> the codes of the
    layouts it walks), read from the design lines of
    csrc/packed_layouts_designs.cu (entry points rk_lwalk_<name>_<layout>);
    None for pr19, PR 19's kernels over the rows, all four layouts."""
    src = _read(CSRC_DIR, "packed_layouts_designs.cu")
    designs, walks = {"pr19": None}, {"pr19": tuple(LAYOUT_CODES)}
    for line, codes in DESIGN_LINES.items():
        for n, v in re.findall(rf"^{line}\((\w+), ([-\d, ]+)\)$", src, re.M):
            designs[n] = tuple(int(x) for x in v.split(", "))
            walks[n] = codes
    return designs, walks


def layout_kept() -> dict:
    """The designs csrc/packed_layouts.cu writes out, by layout: its
    `Kept` (cherry, quad) and `KeptLookahead` (lookahead, quad_la)."""
    src = _read(CSRC_DIR, "packed_layouts.cu")

    def kept(name):
        m = re.search(rf"using {name} = rk::lay::Design<([-\d, ]+)>;", src)
        return tuple(int(x) for x in m.group(1).split(", "))
    plain, ahead = kept("Kept"), kept("KeptLookahead")
    return {LAYOUT_CODES[c]: ahead if c in DESIGN_LINES["RK_LWALK_LA_DESIGN"]
            else plain for c in LAYOUT_CODES}


def layout_cols() -> dict:
    """Each layout's rk::lay::Cols arguments (7 ints, the right link -1
    where its internal rows are plain), read from
    csrc/packed_layouts.cuh."""
    names = {"Cherry": "cherry", "Lookahead": "lookahead", "Quad": "quad",
             "QuadLookahead": "quad_la"}
    made = re.findall(r"^using (\w+)Cols = Cols<([-\d, ]+)>;$",
                      _read(CSRC_DIR, "packed_layouts.cuh"), re.M)
    return {names[n]: (tuple(int(x) for x in v.split(", ")) + (-1,))[:7]
            for n, v in made}


def design_pattern(design) -> str:
    """The pattern of the mangled name of a design's uncapped walk
    kernel (designs::design_walk_kernel or designs::refill_walk_kernel of
    csrc/packed_walk_designs.cu)."""
    args = "".join(f"Li{'n' if v < 0 else ''}{abs(v)}E" for v in design)
    kind = "refill" if design[2] else "design"
    return rf"{kind}_walk_kernelINS_6DesignI{args}EELb0E"


# presorted variants: name -> (the design, the sort keys of `presort`)
PRESORTED = {"presorted_split": ("split", ("octant", "morton")),
             "presorted_refill8_split": ("refill8_split", ("octant", "morton")),
             "octsorted_split_t128": ("split_t128", ("octant",)),
             "mortonsorted_split_t128": ("split_t128", ("morton",))}
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGS = {"woop": [P, I32, P, I32, I32, P, P, P, P, P, I64, P],
        "mask": [P, I32, P, I32, I32, P, P, P, P, P, I64, P],
        "worklist": [P, P, I32, I32, P, I32, I32, P, P, P, P, P, I64, P],
        # worklist, cap, rows, c_total, leaf, ro, rd, seed -> t, face;
        # the cull's records, n_tiles, stream
        "slots": [P, I32, P, I32, I32, P, P, P, P, P, P, I64, P],
        # intersect_worklist before the cull (no records)
        "slots_unscratched": [P, I32, P, I32, I32, P, P, P, P, P, I64, P],
        "dense": [P, P, P, P, P, P, I64, P, P, P, P, P, I64, P, P, P, P],
        # closest_dense before its list of the triangles that can hit
        "dense_unlisted": [P, P, P, P, P, P, I64, P, P, P, P, P, I64, P],
        "walk": [P, I32, P, P, P, P, P, I64, I32, I32, P],
        # the (R, words) mask: the same arguments; or the word-major walk
        # with a transpose after it
        "rows": [P, I32, P, P, P, P, P, I64, I32, I32, P],
        "rows_transposed": [P, I32, P, P, P, P, P, I64, I32, I32, P],
        "union": [P, I32, P, P, P, P, P, I64, I32, I32, P],
        "compact": [P, P, P, P, P, P, P, P, P, I64, I32, P],
        # alive_compact before its count pass's scratch
        "compact_unscratched": [P, P, P, P, P, P, P, P, I64, I32, P],
        "cm_u": [P, I32, P, P, P, P, P, P, I64, I32, I32, P],
        "uncompact": [P, P, P, P, P, P, I32, I64, I32, P],
        # rows, n_rows, ro, rd, t0, active -> t, face; r, max_steps,
        # scratch, stream
        "packed": [P, I64, P, P, P, P, P, P, I64, I64, P, P],
        # the packed walk before its split table's scratch
        "packed_unscratched": [P, I64, P, P, P, P, P, P, I64, I64, P],
        # rows, n_rows, root, nw_cap, ro, rd, t0, active -> t, face,
        # overflow; r, stack_d, stream
        "wide": [P, I64, I32, I64, P, P, P, P, P, P, P, I64, I32, P],
        # a wide walk design: the package's arguments, a scratch, stream
        "wide_design": [P, I64, I32, I64, P, P, P, P, P, P, P, I64, I32, P,
                        P],
        # alive_uncompact before its count pass's scratch
        "uncompact_unscratched": [P, P, P, P, P, I64, I32, P],
        # layout, rows, n_rows, ro, rd, t0, active -> t, face; r, scratch,
        # stream
        "layouts": [I32, P, I64, P, P, P, P, P, P, I64, P, P],
        # a layout design's walk of one layout: the same without the code
        "layouts_design": [P, I64, P, P, P, P, P, P, I64, P, P],
        # x -> out; len, n, iters, mode, stream
        "cycle": [P, P, I64, I32, I32, I32, P],
        # x -> out; len, n, iters, stream
        "sel": [P, P, I64, I32, I32, P],
        # x -> out; len, n, iters, chain, fixed_s, stream
        "permute": [P, P, I64, I32, I32, I32, I32, P],
        # mask, cwp, pay, otrue; r, n -> v1, v2, nc, v3; stream
        "diag": [P, I32, P, P, I64, I32, P, P, P, P, P]}


def _set(src: str, scope: str, consts: dict) -> str:
    """src with each `constexpr int <name> = <v>;` after the first match
    of `scope` (up to the next blank line) set to consts[name]."""
    at = src.index(scope)
    end = src.index("\n\n", at)
    block = src[at:end]
    for name, v in consts.items():
        block, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{v};",
                           block)
        if n != 1:
            raise ValueError(f"{name} not found once after {scope!r}")
    return src[:at] + block + src[end:]


def _nvcc_job(name: str, source: str, text: str, hdr_dir: str):
    """A build of `text` as `source` with the kernel headers of hdr_dir,
    under _build/sweep/<name>; returns a thunk giving the library path."""
    # an older checkout may lack a header
    hdrs = [h for h in KERNEL_HEADERS
            if os.path.exists(os.path.join(hdr_dir, h))]

    def build():
        d = os.path.join(BUILD_DIR, "sweep", name)
        os.makedirs(d, exist_ok=True)
        for h in hdrs:
            shutil.copy(os.path.join(hdr_dir, h), d)
        path = os.path.join(d, source)
        with open(path, "w") as f:
            f.write(text)
        return build_library(f"sweep_{name}", [_nvcc()], NVCC_FLAGS,
                             ["-shared"], [path],
                             tuple(os.path.join(d, h) for h in hdrs))
    return build


def _read(*parts) -> str:
    with open(os.path.join(*parts)) as f:
        return f.read()


LAYOUT_DESIGNS, LAYOUT_WALKS = _layout_designs()


def build_variants(kernels, against: str | None, designs=None) -> dict:
    """(kernel, variant) -> (library path, C entry point, signature key),
    every library built in parallel (one nvcc each); the package's own
    kernels come from `kernel_lib()`. With `designs`, a walk's designs
    library is built only when one of them is among its designs."""
    jobs = {}
    for kernel in kernels:
        source, entry, scope, variants = SWEPT[kernel]
        text = _read(CSRC_DIR, source)
        for name, consts in variants.items():
            jobs[(kernel, name)] = (_nvcc_job(
                f"{kernel}_{name}", source, _set(text, scope, consts),
                CSRC_DIR), entry, kernel)
    if {"walk", "rows"} & set(kernels):
        walk_lib = _nvcc_job("walk_designs", "walk_designs.cu",
                             _read(CSRC_DIR, "walk_designs.cu"), CSRC_DIR)
        if "walk" in kernels:
            for name in WALK_DESIGNS:
                jobs[("walk", name)] = (walk_lib, f"rk_walk_{name}", "walk")
        if "rows" in kernels:
            for name in ROW_DESIGNS:
                jobs[("rows", name)] = (walk_lib, f"rk_walk_{name}", "rows")
    def wanted(names):
        return designs is None or bool(set(designs) & set(names))

    if "packed" in kernels and wanted([*PACKED_DESIGNS, *PRESORTED]):
        lib = _nvcc_job("packed_walk_designs", "packed_walk_designs.cu",
                        _read(CSRC_DIR, "packed_walk_designs.cu"), CSRC_DIR)
        for name, design in PACKED_DESIGNS.items():
            jobs[("packed", name)] = (lib, f"rk_pwalk_{name}",
                                      "packed_unscratched" if design is None
                                      else "packed")
    if "layouts" in kernels and wanted(LAYOUT_DESIGNS):
        lib = _nvcc_job("packed_layouts_designs", "packed_layouts_designs.cu",
                        _read(CSRC_DIR, "packed_layouts_designs.cu"), CSRC_DIR)
        for name in LAYOUT_DESIGNS:
            jobs[("layouts", name)] = (lib, f"rk_lwalk_{name}",
                                       "layouts_design")
    if "wide" in kernels and wanted(WIDE_DESIGNS):
        lib = _nvcc_job("wide_walk_designs", "wide_walk_designs.cu",
                        _read(CSRC_DIR, "wide_walk_designs.cu"), CSRC_DIR)
        for name in WIDE_DESIGNS:
            jobs[("wide", name)] = (lib, f"rk_wwalk_{name}", "wide_design")
    if against:
        other = os.path.join(against, "raypt_torch", "csrc")
        for kernel in kernels:
            source, entry, _, _ = SWEPT[kernel]
            text = _read(other, source)
            sig = kernel
            if kernel == "dense" and "pack_live_kernel" not in text:
                sig = "dense_unlisted"
            if kernel == "compact" and "chunk_count_kernel" not in text:
                sig = "compact_unscratched"
            if kernel == "uncompact" and "for_each_destination" in text:
                sig = "uncompact_unscratched"
            if kernel == "packed":
                sig = packed_sig(text)
            if kernel == "slots" and "rk::cull" not in text:
                sig = "slots_unscratched"
            if kernel == "rows" and entry not in text:
                entry, sig = "rk_topwalk_mask", "rows_transposed"
            jobs[(kernel, "against")] = (_nvcc_job(
                f"{kernel}_against", source, text, other), entry, sig)
    thunks = list({id(b): b for b, _, _ in jobs.values()}.values())
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        built = dict(zip(map(id, thunks), pool.map(lambda b: b(), thunks)))
    return {key_: (built[id(b)], fn, sig)
            for key_, (b, fn, sig) in jobs.items()}


def packed_sig(text: str) -> str:
    """The signature of a packed_walk.cu's rk_packed_walk: with the split
    table's scratch (sized by its rk_packed_walk_scratch) or, before it,
    without."""
    return ("packed" if "rk_packed_walk_scratch" in text
            else "packed_unscratched")


def _loaded(sig: str, path: str, fn: str):
    lib = ctypes.CDLL(path)
    if sig == "layouts_design":   # layout code -> its walk, with f.scratch
        return {code: _loaded("layouts_one", path,
                              f"{fn}_{LAYOUT_CODES[code]}")
                for code in LAYOUT_WALKS[fn[len("rk_lwalk_"):]]}
    if sig == "layouts_one":
        f = getattr(lib, fn)
        f.argtypes, f.restype = SIGS["layouts_design"], ctypes.c_int
        f.scratch = getattr(lib, f"{fn}_scratch")
        f.scratch.argtypes, f.scratch.restype = [I64], I64
        return f
    f = getattr(lib, fn)
    f.argtypes, f.restype = SIGS[sig], ctypes.c_int
    if sig == "wide_design":   # f.scratch(r): bytes of its scratch
        f.scratch = getattr(lib, f"{fn}_scratch")
        f.scratch.argtypes, f.scratch.restype = [I64], I64
    if sig == "layouts":   # f.scratch(code, n_rows): float4 of its scratch
        f.scratch = lib.rk_layout_walk_scratch
        f.scratch.argtypes, f.scratch.restype = [I32, I64], I64
    if sig == "packed":   # f.scratch(n_rows, r): float4 of its scratch
        size = getattr(lib, f"{fn}_scratch")
        size.restype = I64
        if fn == "rk_packed_walk":
            size.argtypes = [I64]
            f.scratch = lambda n_rows, r, size=size: size(n_rows)
        else:
            size.argtypes = [I64, I64]
            f.scratch = size
    return f


def wavefronts(kernels=tuple(SWEPT)) -> dict:
    """kernel -> its launches' arguments on the card: config4's eight
    bounces (woop, walk), the bench scene's four through the dense-union
    finder (walk, union, mask), the cluster finder (worklist), the pallas
    finder (dense), the expand finder (compact, cm_u, uncompact: each
    stage fed the package kernels' outputs of the stage before it) and
    the bvh finder, then bvh_large's four (packed), and the bvh4
    finder's, then bvh_large's (wide). Only the renders that feed
    `kernels` are made."""
    from ..accel.clusters import (CLUSTER_LEAF, WORKLIST_CAP, build_clusters,
                                  tile_union_counts, tile_worklists,
                                  worklist_slice)
    from ..accel import lbvh
    from ..accel.ctree import build_onehot
    from ..accel.host_bvh import build_sah
    from ..accel.packed import (pack, pack_cherries, pack_lookahead,
                                pack_quads)
    from ..accel.traverse import (DENSE_CHUNK, find_closest_onehot,
                                  onehot_inputs, wavefront_inputs)
    from ..accel.wide import collapse
    from ..core.math3d import BIG
    from ..core.types import RenderConfig
    from ..render.integrator import make_finder, render_sample
    from ..rng.sampler import frame_key, key, sample_key
    from ..scenes.builtin import _icosphere, stanford_bunny
    from ..scenes.config4 import config4_scene
    from . import cluster_expand as ex
    from . import compact as cp
    from . import onehot_walk as wk
    from .cluster_pallas import TILE
    from .dense_pallas import RAY_TILE
    out = {k: [] for k in SWEPT}
    if "cycle" in kernels:   # the scripts' calls, each a wavefront
        from ..probes import cycle_budget
        from ..probes.regroup import CYCLE_MODES
        xc = cycle_budget.inputs("cuda")
        out["cycle"] = [(xc, cycle_budget.N, iters, mode)
                        for mode in CYCLE_MODES
                        for iters in (16, cycle_budget.ITERS)]
    if "sel" in kernels:
        from ..probes import sel_probe
        xs = sel_probe.inputs("cuda")
        out["sel"] = [(xs, sel_probe.N, iters) for iters in sel_probe.ITERS]
    if "permute" in kernels:   # tpu_permute_probe.py's, then probe2's
        from ..probes import permute_probe, permute_probe2
        xp = permute_probe.inputs("cuda")
        n = permute_probe.N
        out["permute"] = [(xp, n, iters, False, False)
                          for iters in permute_probe.ITERS] + [
            (xp, n, iters, True, fixed) for fixed in (True, False)
            for iters in permute_probe2.ITERS]
    if "diag" in kernels:   # tpu_expand_diag2.py's run_diag
        from ..probes import expand_diag2
        ro, rd, mask_cm, _ = expand_diag2.wavefront("cuda")
        out["diag"] = [(mask_cm, *expand_diag2.payload(ro, rd),
                        expand_diag2.N)]
    out["packed_path"] = []   # the path of each packed wavefront
    out["wide_path"] = []     # and of each wide one
    out["layouts_path"] = []  # and of each layout one
    bench = RenderConfig(width=WIDTH, height=WIDTH, samples_per_pixel=1,
                         num_bounces=4, russian_roulette=True)
    def large_bunny():
        return stanford_bunny(mesh=_icosphere(LARGE_SUBDIV))

    for build, cfg, k, feeds in (
            (config4_scene, RenderConfig(
                width=WIDTH, height=WIDTH, samples_per_pixel=1,
                num_bounces=8, russian_roulette=True,
                enable_refraction=True, backend="onehot", onehot_leaf=LEAF),
             7, ("woop", "walk", "rows")),
            (stanford_bunny, bench.replace(backend="onehot",
                                           onehot_leaf=LEAF), 0,
             ("walk", "rows", "union", "mask")),
            (stanford_bunny, bench.replace(backend="cluster"), 0,
             ("worklist",)),
            (stanford_bunny, bench.replace(backend="onehot",
                                           onehot_leaf=LEAF), 0, ("slots",)),
            (stanford_bunny, bench.replace(backend="pallas"), 0, ("dense",)),
            (stanford_bunny, bench.replace(
                backend="onehot", onehot_leaf=EXPAND_LEAF,
                onehot_expand=EXPAND_N, onehot_compact=COMPACT_N), 0,
             ("compact", "cm_u", "uncompact")),
            (stanford_bunny, bench.replace(backend="bvh"), 0,
             ("packed", "layouts")),
            (large_bunny, bench.replace(backend="bvh"), 0,
             ("packed", "layouts")),
            (stanford_bunny, bench.replace(backend="bvh4"), 0, ("wide",)),
            (large_bunny, bench.replace(backend="bvh4"), 0, ("wide",))):
        if not set(feeds) & set(kernels):
            continue
        b = build()
        b.camera.viewport_width = b.camera.viewport_height = WIDTH
        scene = b.freeze("cuda")
        m = scene.mesh
        tables = {}
        if cfg.backend == "bvh":
            tree = lbvh.build(m.positions, m.faces, m.face_valid)
            acc = pack(tree, m.positions, m.faces, m.face_valid)
            if "layouts" in kernels:
                tables = {code: packer(tree, m.positions, m.faces,
                                       m.face_valid).rows
                          for code, packer in (
                              (0, pack_cherries), (1, pack_lookahead),
                              (2, pack_quads),
                              (3, partial(pack_quads, lookahead=True)))}
        elif cfg.backend == "bvh4":
            acc = collapse(lbvh.build(m.positions, m.faces, m.face_valid),
                           m.positions, m.faces, m.face_valid)
        elif cfg.backend == "onehot":
            acc = build_onehot(build_sah(m), m.positions, m.faces,
                               m.face_valid, leaf=cfg.onehot_leaf,
                               with_woop=build is config4_scene).to("cuda")
        elif cfg.backend == "cluster":
            acc = build_clusters(build_sah(m), m.positions, m.faces,
                                 m.face_valid, leaf=CLUSTER_LEAF).to("cuda")
        else:
            acc = None
        finder = make_finder(scene, cfg, acc)
        if feeds == ("slots",):   # the non-fused branch
            finder = partial(find_closest_onehot, accel=acc, expand_n=0,
                             compact_n=0, use_pallas_intersect=False)

        def rec(s, ro, rd, active=None, finder=finder, acc=acc, cfg=cfg,
                c4=build is config4_scene, tables=tables, feeds=feeds):
            if cfg.backend == "bvh4":
                o, d, t, a, _, _ = wavefront_inputs(s, ro, rd, active, 1)
                out["wide"].append((acc.rows, acc.root, acc.nw_cap, o, d, t,
                                    a))
                out["wide_path"].append(
                    "bvh_large" if build is large_bunny else "bvh4")
                return finder(s, ro, rd, active)
            if cfg.backend == "bvh":
                o, d, t, a, _, _ = wavefront_inputs(s, ro, rd, active, 1)
                path = "bvh_large" if build is large_bunny else "bvh"
                if "packed" in kernels:
                    out["packed"].append((acc.rows, o, d, t, a))
                    out["packed_path"].append(path)
                for code, rows in tables.items():
                    out["layouts"].append((code, rows, o, d, t, a))
                    out["layouts_path"].append(
                        f"{path}_{LAYOUT_CODES[code]}")
                return finder(s, ro, rd, active)
            if cfg.backend == "pallas":
                mats = finder.args[0]
                o, d, t, _, _, _ = wavefront_inputs(s, ro, rd, None, RAY_TILE)
                out["dense"].append((*mats, o, d, t))
                return finder(s, ro, rd, active)
            if cfg.onehot_compact:
                g = cfg.onehot_compact
                o, d, t, a, _, _ = onehot_inputs(s, ro, rd, active, g)
                out["compact"].append((o, d, t, a, g))
                counts = cp.new_counts(a, g)
                kc = cp.alive_compact(o, d, t, a, g, counts)
                cwp = -(-acc.num_clusters // 256) * 8
                out["cm_u"].append((acc.table, *kc, cwp))
                km, ku = wk.topwalk_cm_u(acc.table, *kc, cwp)
                seed = torch.where(kc[3], kc[2], torch.full_like(kc[2], -BIG))
                kt, kf = ex.cluster_expand(km, ku, acc.clusters.tri_rows,
                                           kc[0], kc[1], seed)
                out["uncompact"].append((kt, kf, a, g, counts))
                return finder(s, ro, rd, active)
            o, d, t, a, _, _ = wavefront_inputs(s, ro, rd, active,
                                                DENSE_CHUNK)
            seed = torch.where(a, t, torch.full_like(t, -BIG))
            if feeds == ("slots",):
                nw = -(-acc.num_clusters // 32)
                union = tile_union_counts(wk.topwalk(acc.table, o, d, t, a,
                                                     nw), TILE)[0]
                wl = worklist_slice(union, acc.num_clusters, WORKLIST_CAP)
                out["slots"].append((wl, acc.clusters.tri_rows, o, d, seed))
                return finder(s, ro, rd, active)
            if cfg.backend == "cluster":
                wl, cnt, _ = tile_worklists(acc, o, d, seed, TILE)
                out["worklist"].append((wl, cnt, acc.tri_rows, o, d, seed))
                return finder(s, ro, rd, active)
            wargs = (acc.table, o, d, t, a, -(-acc.num_clusters // 32))
            union = tile_union_counts(wk.topwalk(*wargs), TILE)[0]
            out["walk"].append(wargs)
            out["rows"].append(wargs)
            if not c4:
                out["union"].append(wargs)
            if c4:
                out["woop"].append((union, acc.woop_cm, o, d, seed))
            else:
                out["mask"].append((union, acc.clusters.tri_rows, o, d, seed))
            return finder(s, ro, rd, active)

        with torch.no_grad():
            render_sample(scene, cfg, sample_key(frame_key(key(k), 0), 0),
                          rec)
    return out


def all_tested(wave):
    """A dense wavefront whose zero ww rows carry 1e-13 in their last
    entry: d'_w stays below 1e-12 for every unit-length direction, so no
    ray hits them and the result is the same, but every slot is tested."""
    wu, wv, ww, cu, cv, cw, o, d, t = wave
    ww = ww.clone()
    ww[2, (ww == 0).all(dim=0)] = 1e-13
    return (wu, wv, ww, cu, cv, cw, o, d, t)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(rc, what):
    if rc:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _call_union(fn, union, table, o, d, seed):
    """The union kernels (woop: table (C, 4, 3L); mask: (C, L, 12))."""
    t = torch.empty_like(seed)
    p = torch.empty(seed.shape, dtype=torch.int32, device=seed.device)
    leaf = table.shape[2] // 3 if table.shape[1] == 4 else table.shape[1]
    _check(fn(union.data_ptr(), union.shape[1], table.data_ptr(),
              table.shape[0], leaf, o.data_ptr(), d.data_ptr(),
              seed.data_ptr(), t.data_ptr(), p.data_ptr(), union.shape[0],
              _stream()), "union")
    return t, p


def _call_worklist(fn, wl, cnt, rows, o, d, seed):
    t = torch.empty_like(seed)
    f = torch.empty(seed.shape, dtype=torch.int32, device=seed.device)
    _check(fn(wl.data_ptr(), cnt.data_ptr(), wl.shape[1], 1, rows.data_ptr(),
              rows.shape[0], rows.shape[1], o.data_ptr(), d.data_ptr(),
              seed.data_ptr(), t.data_ptr(), f.data_ptr(), wl.shape[0],
              _stream()), "worklist")
    return t, f


def _call_slots(fn, wl, rows, o, d, seed, scratch=True):
    t = torch.empty_like(seed)
    f = torch.empty(seed.shape, dtype=torch.int32, device=seed.device)
    recs = torch.empty((rows.shape[0], 16), dtype=torch.float32,
                       device=seed.device)
    _check(fn(wl.data_ptr(), wl.shape[1], rows.data_ptr(), rows.shape[0],
              rows.shape[1], o.data_ptr(), d.data_ptr(), seed.data_ptr(),
              t.data_ptr(), f.data_ptr(),
              *((recs.data_ptr(),) if scratch else ()), wl.shape[0],
              _stream()), "slots")
    return t, f


def _call_dense(fn, wu, wv, ww, cu, cv, cw, o, d, t0, listed=True):
    t = torch.empty_like(t0)
    f = torch.empty(t0.shape, dtype=torch.int32, device=t0.device)
    n = wu.shape[1]
    scratch = ()
    if listed:
        rows = torch.empty((n, 12), dtype=torch.float32, device=t0.device)
        ids = torch.empty((n + 1,), dtype=torch.int32, device=t0.device)
        scratch = (rows.data_ptr(), ids.data_ptr(), ids[n:].data_ptr())
    _check(fn(wu.data_ptr(), wv.data_ptr(), ww.data_ptr(), cu.data_ptr(),
              cv.data_ptr(), cw.data_ptr(), n, o.data_ptr(), d.data_ptr(),
              t0.data_ptr(), t.data_ptr(), f.data_ptr(), o.shape[0],
              *scratch, _stream()), "dense")
    return t, f


def _call_walk(fn, table, o, d, t, a, nw):
    from ..accel.ctree import walk_max_steps
    mask = torch.empty((nw, o.shape[0]), dtype=torch.int32, device=o.device)
    _check(fn(table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
              t.data_ptr(), a.data_ptr(), mask.data_ptr(), o.shape[0], nw,
              walk_max_steps(table.shape[0]), _stream()), "walk")
    return (mask,)


def _call_rows(fn, table, o, d, t, a, nw):
    from ..accel.ctree import walk_max_steps
    mask = torch.empty((o.shape[0], nw), dtype=torch.int32, device=o.device)
    _check(fn(table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
              t.data_ptr(), a.data_ptr(), mask.data_ptr(), o.shape[0], nw,
              walk_max_steps(table.shape[0]), _stream()), "rows")
    return (mask,)


def _call_walk_union(fn, table, o, d, t, a, nw):
    from ..accel.ctree import walk_max_steps
    union = torch.empty((o.shape[0] // 256, nw), dtype=torch.int32,
                        device=o.device)
    _check(fn(table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
              t.data_ptr(), a.data_ptr(), union.data_ptr(), o.shape[0], nw,
              walk_max_steps(table.shape[0]), _stream()), "union walk")
    return (union,)


def _call_walk_cm_u(fn, table, o, d, t, a, cwp):
    from ..accel.ctree import walk_max_steps
    from .onehot_walk import RAY_TILE
    r = o.shape[0]
    mask = torch.empty((cwp, r), dtype=torch.int32, device=o.device)
    union_pp = torch.zeros((r // RAY_TILE, cwp), dtype=torch.int32,
                           device=o.device)
    _check(fn(table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
              t.data_ptr(), a.data_ptr(), mask.data_ptr(), union_pp.data_ptr(),
              r, cwp, walk_max_steps(table.shape[0]), _stream()), "cm_u walk")
    return mask, union_pp


def _call_compact(fn, o, d, t, a, group, scratch=True):
    """The permutation is full (dead lanes carry their own data), so every
    output is compared whole."""
    r = o.shape[0]
    outs = [torch.empty_like(x) for x in (o, d, t, a)]
    ptrs = [x.data_ptr() for x in (o, d, t, a, *outs)]
    if scratch:
        counts = torch.empty((r // group * -(-group // COMPACT_SCRATCH_CHUNK),),
                             dtype=torch.int32, device=o.device)
        ptrs.append(counts.data_ptr())
    _check(fn(*ptrs, r, group, _stream()), "compact")
    return tuple(outs)


def _call_uncompact(fn, t, face, a, group, counts=None, scratch=True):
    """counts: what the compaction of `a` left (the count pass is then
    skipped), else a scratch the kernel fills first; an older kernel
    (scratch=False) takes none."""
    t_out, f_out = torch.empty_like(t), torch.empty_like(face)
    ptrs = [x.data_ptr() for x in (t, face, a, t_out, f_out)]
    if scratch:
        counted = counts is not None
        if not counted:
            n = t.shape[0] // group * -(-group // COMPACT_SCRATCH_CHUNK)
            counts = torch.empty((n,), dtype=torch.int32, device=t.device)
        ptrs += [counts.data_ptr(), int(counted)]
    _check(fn(*ptrs, t.shape[0], group, _stream()), "uncompact")
    return t_out, f_out


def _call_packed(fn, rows, o, d, t, a, scratch=True):
    t_out = torch.empty_like(t)
    f_out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
    ptrs = [rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(),
            t.data_ptr(), a.data_ptr(), t_out.data_ptr(), f_out.data_ptr(),
            o.shape[0], -1]
    if scratch:
        s = torch.empty((fn.scratch(rows.shape[0], o.shape[0]), 4),
                        dtype=torch.float32, device=t.device)
        ptrs.append(s.data_ptr())
    _check(fn(*ptrs, _stream()), "packed walk")
    return t_out, f_out


def _call_wide(fn, rows, root, nw, o, d, t, a, scratch=False):
    """The wide walk at the finder's stack (STACK_D); a design
    (scratch=True) also takes a scratch of the bytes it asks."""
    from ..accel.wide import STACK_D
    r = o.shape[0]
    t_out = torch.empty_like(t)
    f_out = torch.empty((r,), dtype=torch.int32, device=t.device)
    o_out = torch.empty((r,), dtype=torch.bool, device=t.device)
    ptrs = [rows.data_ptr(), rows.shape[0], root, nw, o.data_ptr(),
            d.data_ptr(), t.data_ptr(), a.data_ptr(), t_out.data_ptr(),
            f_out.data_ptr(), o_out.data_ptr(), r, STACK_D]
    if scratch:
        size = fn.scratch(r)
        s = torch.empty((-(-size // 8),), dtype=torch.int64, device=t.device)
        ptrs.append(s.data_ptr() if size else None)
    _check(fn(*ptrs, _stream()), "wide walk")
    return t_out, f_out, o_out


def _call_layouts(fn, code, rows, o, d, t, a):
    """The walk of layout `code` of the package (fn takes the code) or of
    a design (fn: code -> its walk), with the scratch it asks."""
    f, args = (fn[code], ()) if isinstance(fn, dict) else (fn, (code,))
    n = fn.scratch(code, rows.shape[0]) if args else f.scratch(rows.shape[0])
    s = torch.empty((max(n, 1), 4), dtype=torch.float32, device=t.device)
    t_out = torch.empty_like(t)
    f_out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
    _check(f(*args, rows.data_ptr(), rows.shape[0], o.data_ptr(),
             d.data_ptr(), t.data_ptr(), a.data_ptr(), t_out.data_ptr(),
             f_out.data_ptr(), o.shape[0], s.data_ptr(), _stream()),
           "layout walk")
    return t_out, f_out


def presort(rows, o, d, t, a, keys=("octant", "morton")):
    """The wavefront with its live rays first, stably sorted by `keys`:
    "octant", the direction octant, and "morton", the Morton code of the
    origin in the root box (`lbvh.morton3d`, 10 bits an axis), the first
    key major; dead rays last: (rows, o, d, t, a, inv), inv the
    permutation back to launch order."""
    from ..accel.lbvh import morton3d
    key = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for k in keys:
        if k == "octant":
            key = (key << 3) | ((d[:, 0] < 0).long()
                                | ((d[:, 1] < 0).long() << 1)
                                | ((d[:, 2] < 0).long() << 2))
        else:
            lo, hi = rows[0, 0:3], rows[0, 3:6]
            key = (key << 30) | morton3d(
                ((o - lo) / (hi - lo).clamp(min=1e-30)).clamp(0, 1))
    key = torch.where(a, key, torch.full_like(key, 1 << 40))
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return (rows, o[order].contiguous(), d[order].contiguous(),
            t[order].contiguous(), a[order].contiguous(), inv)


def _call_cycle(fn, x, n, iters, mode):
    from ..probes.regroup import CYCLE_MODES
    out = torch.empty((1, x.shape[1]), dtype=torch.float32, device=x.device)
    _check(fn(x.data_ptr(), out.data_ptr(), x.shape[1], n, iters,
              CYCLE_MODES.index(mode), _stream()), "cycle")
    return (out,)


def _call_sel(fn, x, n, iters):
    out = torch.empty((8, x.shape[1]), dtype=torch.float32, device=x.device)
    _check(fn(x.data_ptr(), out.data_ptr(), x.shape[1], n, iters, _stream()),
           "sel")
    return (out,)


def _call_permute(fn, x, n, iters, chain, fixed_s):
    out = torch.empty_like(x)
    _check(fn(x.data_ptr(), out.data_ptr(), x.shape[1], n, iters, int(chain),
              int(fixed_s), _stream()), "permute")
    return (out,)


def _call_diag(fn, mask_cm, pay, otrue, n):
    r = mask_cm.shape[1]
    v1, v2, v3 = (torch.empty((1, r), dtype=torch.float32,
                              device=mask_cm.device) for _ in range(3))
    nc = torch.empty((1, r), dtype=torch.int32, device=mask_cm.device)
    _check(fn(mask_cm.data_ptr(), mask_cm.shape[0], pay.data_ptr(),
              otrue.data_ptr(), r, n, v1.data_ptr(), v2.data_ptr(),
              nc.data_ptr(), v3.data_ptr(), _stream()), "diag")
    return v1, v2, nc, v3


def _call_presorted(fn, rows, o, d, t, a, inv):
    t_out, f_out = _call_packed(fn, rows, o, d, t, a)
    return t_out[inv], f_out[inv]


CALLS = {"woop": _call_union, "mask": _call_union,
         "worklist": _call_worklist, "dense": _call_dense,
         "slots": _call_slots, "rows": _call_rows,
         "rows_transposed": lambda fn, *w: (_call_walk(fn, *w)[0].T
                                            .contiguous(),),
         "slots_unscratched": lambda fn, *w: _call_slots(fn, *w,
                                                         scratch=False),
         "dense_unlisted": lambda fn, *w: _call_dense(fn, *w, listed=False),
         "walk": _call_walk, "union": _call_walk_union,
         "cm_u": _call_walk_cm_u, "compact": _call_compact,
         "compact_unscratched": lambda fn, *w: _call_compact(fn, *w,
                                                              scratch=False),
         "uncompact": _call_uncompact,
         "uncompact_unscratched": lambda fn, *w: _call_uncompact(
             fn, *w, scratch=False),
         "packed": _call_packed,
         "packed_unscratched": lambda fn, *w: _call_packed(fn, *w,
                                                            scratch=False),
         "packed_presorted": _call_presorted,
         "wide": _call_wide,
         "wide_design": lambda fn, *w: _call_wide(fn, *w, scratch=True),
         "layouts": _call_layouts, "layouts_design": _call_layouts,
         "cycle": _call_cycle,
         "sel": _call_sel, "permute": _call_permute, "diag": _call_diag}


class SmClock:
    """The SM clock (MHz) from nvidia-smi every 250 ms while the block
    runs; `summary()` after it."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "250"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        self.samples = sorted(int(x) for x in out.split() if x.isdigit())

    def summary(self) -> str:
        s = self.samples
        if not s:
            return "not read"
        return f"{s[len(s) // 2]} median, {s[0]}-{s[-1]} over {len(s)} samples"


def _ms(fn, reps=10) -> float:
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


def _graph_ms(fn, calls=10) -> float:
    """ms a call of fn replayed from a CUDA graph of `calls` calls (mean
    of 10 replays after a warm-up): no host work between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _ms(graph.replay) / calls


@torch.no_grad()
def traverse_while_while(pbvh: PackedLBVH, ro, rd, t0, active, batch: int,
                         max_iters: int | None = None, unroll: int = 8,
                         trace: list | None = None):
    """The while-while designs' walk (csrc/packed_walk_designs.cu:
    warp_step with kBatch = batch) as a 32-lane simulation, ray i on
    lane i % 32 of warp i // 32. Each iteration, in each warp, the lanes
    on internal rows take their slab steps while `batch` or more of them
    are on one, or no lane sits at a leaf; else the lanes at a leaf take
    their leaf tests, and the others wait. Each ray still takes its own
    steps in its own order, so the result is traverse_wavefront's, bit
    for bit (accel.packed.traverse_split's contract; `trace`:
    accel.packed.split_steps' record)."""
    table = split_table(pbvh.rows)
    r = ro.shape[0]
    c, left = split_start(pbvh, active, -(-r // WARP) * WARP, max_iters,
                          unroll)
    inv = safe_reciprocal(rd)
    t_best = t0.clone()
    face = torch.full((r,), -1, dtype=torch.int32, device=ro.device)
    while bool((c != -1).any()):
        on_inner, on_leaf = c >= 0, c < -1
        n_inner = on_inner.view(-1, WARP).sum(1)
        n_leaf = on_leaf.view(-1, WARP).sum(1)
        slab = ((n_leaf == 0) | (n_inner >= batch)).repeat_interleave(WARP)
        split_steps(table, c, torch.nonzero(on_inner & slab).flatten(),
                    torch.nonzero(on_leaf & ~slab).flatten(), ro, rd, inv,
                    t_best, face, left, trace)
    return t_best, face


def packed_measures(built, lib, waves, designs=None) -> dict:
    """variant -> what the packed walk's designs are measured by, beside
    their times: registers, local (spill) bytes, resident blocks and
    warps an SM (the runtime's, through rk_pwalk_<name>_info), the
    instructions of the walk loop (`kernels.sass`), and per wavefront
    the SIMD efficiency and the mixed-step share of the design's
    schedule: the plain walk's record for one thread a ray (batch 0), on
    the rays in the order the threads take them
    (`accel.packed.octant_order` for the octant-sorted blocks), the
    while-while model (`traverse_while_while`) for a batch, none for
    refilled warps. The presorted designs' are on the
    presorted wavefronts."""
    from ..accel.packed import (mixed_share, octant_order, simd_efficiency,
                                traverse_wavefront)
    from .sass import loop_sizes
    out = {}
    path = built[("packed", "pr12")][0]
    # the walk loop of each kernel (the shortest loop with a row load):
    # one unit a pass, whichever kind of row it steps
    loops = {"pr12": (r"pr1218packed_walk_kernel", "LDG.E.128", 0),
             "lean": (r"lean16lean_walk_kernelILb0E", "LDG.E.128", 0)}
    for name, design in PACKED_DESIGNS.items():
        if design is not None:
            loops[name] = (design_pattern(design), "LDG.E.128", 0)
    try:
        for name, (n_ins, _) in loop_sizes(path, loops).items():
            out.setdefault(name, {})["sass_loop"] = n_ins
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"SASS not read: {e}", flush=True)
    info = (ctypes.c_int * 4)()
    lib_ = ctypes.CDLL(path)
    for name in PACKED_DESIGNS:
        f = getattr(lib_, f"rk_pwalk_{name}_info")
        f.argtypes, f.restype = [P], ctypes.c_int
        _check(f(ctypes.cast(info, P)), f"{name} info")
        regs, local, blocks, threads = list(info)
        out.setdefault(name, {}).update(
            {"registers": regs, "local_bytes": local,
             "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32})
    schedules = {}   # (sort keys, batch, block sort) -> the measures
    runs = [(name, name, ()) for name in PACKED_DESIGNS]
    runs += [(pre, name, keys) for pre, (name, keys) in PRESORTED.items()]
    for label, name, keys in runs:
        design = PACKED_DESIGNS[name] or (256, 0, 0, 1, 0, -1, 0, 0, 0, 0)
        if design[2] or design[7] or design[8] or design[9] or (
                designs and label not in designs):
            continue
        batch, block = design[1], design[0] if design[6] else 0
        key_ = (keys, batch, block)
        if key_ not in schedules:
            simd, mixed = [], []
            for w in waves["packed"]:
                rows, o, d, t, a = presort(*w, keys)[:5] if keys else w
                if block:
                    lane = octant_order(d, a, block)
                    o, d, t, a = (x[lane.clamp(max=o.shape[0] - 1)]
                                  for x in (o, d, t, a))
                    a = a & (lane < w[1].shape[0])
                rec = []
                if batch:
                    traverse_while_while(PackedLBVH(rows=rows), o, d, t, a,
                                         batch, trace=rec)
                else:
                    traverse_wavefront(PackedLBVH(rows=rows), o, d, t, a,
                                       steps=rec)
                simd.append(round(simd_efficiency(rec), 4))
                mixed.append(round(mixed_share(rec), 4))
                del rec
            schedules[key_] = {"simd_efficiency": simd, "mixed_share": mixed}
        out.setdefault(label, {}).update(schedules[key_])
    for pre, (name, keys) in PRESORTED.items():
        if designs and pre not in designs:
            continue
        out.setdefault(pre, {}).update(
            {k: v for k, v in out[name].items()
             if k not in ("simd_efficiency", "mixed_share")})
        out[pre]["sort_ms"] = [round(_ms(lambda w=w: presort(*w, keys)), 6)
                               for w in waves["packed"]]
    return out


# the mangled name of the package's capacity-64 wide walk kernel
# (wide_walk_kernel<64> in csrc/wide_walk.cu's anonymous namespace, which
# nvcc names after the file) and of pr16's
WIDE_PACKAGE_PATTERN = r"wide_walk_cu_\w+?16wide_walk_kernelILi64E"
WIDE_PR16_PATTERN = r"4pr1616wide_walk_kernelILi64E"


def wide_pattern(design) -> str:
    """The pattern of the mangled name of a wide design's capacity-64
    walk kernel (designs::walk_kernel of csrc/wide_walk_designs.cu)."""
    args = "".join(f"Li{v}E" for v in design)
    return rf"7designs11walk_kernelINS_6DesignI{args}EELi64E"


@torch.no_grad()
def wide_schedule(waves, block: int) -> dict:
    """Per wide wavefront, the schedule of one thread a ray with each
    `block`-ray block's rays handed out by octant (`accel.packed.
    octant_order`): the SIMD efficiency and mixed-step share of the
    plain walk's `steps` record on the rays in that order, and the
    stack depth each live ray reaches (its `depths` record's maximum):
    the largest, and the 50th, 90th and 99th percentiles over the rays
    that walk."""
    from ..accel.packed import mixed_share, octant_order, simd_efficiency
    from ..accel.wide import WideBVH, traverse_wide
    out = {"simd_efficiency": [], "mixed_share": [], "depth_max": [],
           "depth_p50_p90_p99": []}
    for rows, root, nw, o, d, t, a in waves:
        r = o.shape[0]
        order = octant_order(d, a, block)
        lane = order.clamp(max=r - 1)
        live = a[lane] & (order < r)
        steps, depths = [], []
        traverse_wide(WideBVH(rows=rows, root=root, nw_cap=nw), o[lane],
                      d[lane], t[lane], live, steps=steps, depths=depths)
        deepest = torch.zeros(lane.shape[0], dtype=torch.int64,
                              device=o.device)
        for (rays, _, _), dep in zip(steps, depths):
            deepest.scatter_reduce_(0, rays, dep, "amax")
        walked = deepest[live].float()
        out["simd_efficiency"].append(round(simd_efficiency(steps), 4))
        out["mixed_share"].append(round(mixed_share(steps), 4))
        out["depth_max"].append(int(walked.max()) if walked.numel() else 0)
        q = torch.tensor([0.5, 0.9, 0.99], device=o.device)
        out["depth_p50_p90_p99"].append(
            [float(x) for x in torch.quantile(walked, q)]
            if walked.numel() else [])
        del steps, depths
    return out


def wide_measures(built, lib, waves, designs=None) -> dict:
    """variant -> what the wide walk's designs are measured by, beside
    their times: registers, local bytes, resident blocks and warps an SM
    and shared stack slots (rk_wwalk_<name>_info, the package's
    rk_wide_walk_info), the instructions of its loops (`kernels.sass`)
    that hold a 16-byte global load: the shortest ("sass_loop": one step
    of either kind of row, or, with cooperative leaves, a round of the
    leaf phase's slot tests) and the longest ("sass_pass": a warp's pass,
    an internal visit and a leaf phase), and per wavefront
    `wide_schedule`'s measures for the design's
    block size (one thread a ray: while-while designs step their lanes
    otherwise, persistent ones take the same warps of rays)."""
    from .sass import loop_sizes
    out = {}
    sizes = {"package": WIDE_DESIGNS[KEPT]}
    names = [n for n in WIDE_DESIGNS if ("wide", n) in built
             and (not designs or n in designs)]

    def read(fn, name):   # the package's 4 ints, a design's 5
        info = (ctypes.c_int * 5)()
        fn.argtypes, fn.restype = [P], ctypes.c_int
        _check(fn(ctypes.cast(info, P)), f"{name} info")
        regs, local, blocks, threads, shared = list(info)
        out.setdefault(name, {}).update(
            {"registers": regs, "local_bytes": local, "blocks_per_sm": blocks,
             "warps_per_sm": blocks * threads // 32, "shared_slots": shared})

    def sass(path, loops):
        try:
            for key_, longest in (("sass_loop", False), ("sass_pass", True)):
                for name, (n_ins, _) in loop_sizes(path, loops,
                                                   longest).items():
                    out[name][key_] = n_ins
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"SASS not read: {e}", flush=True)

    read(lib.rk_wide_walk_info, "package")
    sass(lib._name, {"package": (WIDE_PACKAGE_PATTERN, "LDG.E.128", 0)})
    if names:
        path = built[("wide", names[0])][0]
        lib_ = ctypes.CDLL(path)
        for name in names:
            read(getattr(lib_, f"rk_wwalk_{name}_info"), name)
            sizes[name] = WIDE_DESIGNS[name] or (128,)
        loops = {"pr16": (WIDE_PR16_PATTERN, "LDG.E.128", 0)}
        loops.update({n: (wide_pattern(d), "LDG.E.128", 0)
                      for n, d in WIDE_DESIGNS.items() if d and n in names})
        sass(path, loops)
    schedules = {}
    for name, design in sizes.items():
        block = design[0]
        if block not in schedules:
            schedules[block] = wide_schedule(waves["wide"], block)
        out[name].update(schedules[block])
    return out


# the bytes a visit reads: PR 19's walks over the rows, (internal, leaf)
# by layout; the split walks a 32-byte sector a box tested (a lookahead
# row's sector B only where its left box misses, unless the design loads
# both sectors at once, kBoth 1) and 48 bytes a tested slot
ROW_WALK_BYTES = {"cherry": (64, 96), "lookahead": (64, 64),
                  "quad": (48, 176), "quad_la": (64, 176)}
SPLIT_INNER_BYTES = 32
SLOT_BYTES = 48
# each layout's table type, by its code
LAYOUT_TABLES = {0: Packed2LBVH, 1: PackedLALBVH, 2: Packed4LBVH,
                 3: partial(Packed4LBVH, lookahead=True)}


def _path_layout(path: str) -> str:
    """The layout of a layout wavefront's path ("bvh_quad_la" ->
    "quad_la")."""
    return max((n for n in LAYOUT_CODES.values() if path.endswith("_" + n)),
               key=len)


@torch.no_grad()
def layout_visits(waves) -> dict:
    """path -> [internal visits, leaf visits, filled slots, slots,
    right-box tests] summed over the path's layout wavefronts, from the
    plain walk's `steps` record (filled: the slots below a leaf row's
    count, `accel.packed.slot_counts`) and, for a lookahead table, the
    plain model's right-box tests (`accel.packed.traverse_slots`)."""
    from ..accel import packed
    out = {}
    for (code, rows, o, d, t, a), path in zip(waves["layouts"],
                                              waves["layouts_path"]):
        table = LAYOUT_TABLES[code](rows=rows)
        count = packed.slot_counts(table)
        steps = []
        packed.walk_layout(table, o, d, t, a, steps=steps)
        acc = out.setdefault(path, [0, 0, 0, 0, 0])
        for _, nodes, leaf in steps:
            acc[0] += int((~leaf).sum())
            acc[1] += int(leaf.sum())
            acc[2] += int(count[nodes[leaf].long()].sum())
        del steps
        acc[3] = acc[1] * packed.SLOT_LAYOUTS[LAYOUT_CODES[code]].slots
        if packed.SLOT_LAYOUTS[LAYOUT_CODES[code]].right is not None:
            right = []
            packed.traverse_slots(table, o, d, t, a, right=right)
            acc[4] += sum(right)
    return out


def layout_bytes(design, layout: str, visits) -> float:
    """The bytes a visit of a layout design (LAYOUT_DESIGNS' value; None
    for pr19) reads, from layout_visits' counts of one path."""
    inner, leaves, filled, slots, right = visits
    if design is None:
        b_i, b_l = ROW_WALK_BYTES[layout]
        read = b_i * inner + b_l * leaves
    else:
        both = design[4] == 1 and layout in ("lookahead", "quad_la")
        sectors = inner + (inner if both else right)
        read = SPLIT_INNER_BYTES * sectors + SLOT_BYTES * (
            slots if design[3] else filled)
    return read / max(inner + leaves, 1)


def slot_pattern(layout: str, design) -> str:
    """The pattern of the mangled name of a split layout walk
    (rk::lay::slot_walk_kernel, or a design's row_step_kernel) of a
    layout (by its name in LAYOUT_CODES)."""
    def args(v):
        return "".join(f"Li{'n' if x < 0 else ''}{abs(x)}E" for x in v)
    return (rf"(?:slot_walk|row_step)_kernelINS0_4ColsI"
            rf"{args(layout_cols()[layout])}EENS0_6DesignI{args(design)}EE")


# the mangled names of PR 19's walks (pr19::layout_walk_kernel<S>)
PR19_PATTERNS = {"cherry": r"pr1918layout_walk_kernelINS_6CherryE",
                 "lookahead": r"pr1918layout_walk_kernelINS_9LookaheadE",
                 "quad": r"pr1918layout_walk_kernelINS_4QuadILb0EEE",
                 "quad_la": r"pr1918layout_walk_kernelINS_4QuadILb1EEE"}


def layouts_measures(built, lib, waves, designs=None) -> dict:
    """variant -> what the layout walks' designs are measured by, beside
    their times, each per layout: registers, local bytes and resident
    warps an SM (rk_layout_walk_info, rk_lwalk_<name>_<layout>_info), the
    instructions of the shortest and the longest loop that holds a
    16-byte load (`kernels.sass`: "sass_loop", "sass_pass"), and per
    path the bytes a visit reads (`layout_bytes`)."""
    from .sass import loop_sizes
    names = [n for n in LAYOUT_DESIGNS if ("layouts", n) in built
             and (not designs or n in designs)]
    out = {}
    info = (ctypes.c_int * 4)()

    def put(name, layout, fn):
        _check(fn(ctypes.cast(info, P)), f"{name} {layout} info")
        regs, local, blocks, threads = list(info)
        d = out.setdefault(name, {})
        d.setdefault("registers", {})[layout] = regs
        d.setdefault("local_bytes", {})[layout] = local
        d.setdefault("warps_per_sm", {})[layout] = blocks * threads // 32

    def sass(path, loops):
        try:
            for key_, longest in (("sass_loop", False), ("sass_pass", True)):
                for (name, layout), (n_ins, _) in loop_sizes(
                        path, loops, longest).items():
                    out[name].setdefault(key_, {})[layout] = n_ins
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"SASS not read: {e}", flush=True)

    kept = layout_kept()
    lib.rk_layout_walk_info.argtypes = [I32, P]
    for code, layout in LAYOUT_CODES.items():
        put("package", layout,
            lambda p, code=code: lib.rk_layout_walk_info(code, p))
    sass(lib._name, {("package", lay): (slot_pattern(lay, d), "LDG.E.128", 0)
                     for lay, d in kept.items()})
    if names:
        path = built[("layouts", names[0])][0]
        lib_ = ctypes.CDLL(path)
        loops = {}
        for name in names:
            for code in LAYOUT_WALKS[name]:
                layout = LAYOUT_CODES[code]
                f = getattr(lib_, f"rk_lwalk_{name}_{layout}_info")
                f.argtypes, f.restype = [P], ctypes.c_int
                put(name, layout, f)
                design = LAYOUT_DESIGNS[name]
                loops[(name, layout)] = (
                    PR19_PATTERNS[layout] if design is None
                    else slot_pattern(layout, design), "LDG.E.128", 0)
        sass(path, loops)
    visits = layout_visits(waves)
    for name in ("package", *names):
        walked = [LAYOUT_CODES[c] for c in LAYOUT_WALKS.get(name,
                                                             LAYOUT_CODES)]
        out[name]["bytes_per_visit"] = {
            p: round(layout_bytes(kept[_path_layout(p)] if name == "package"
                                  else LAYOUT_DESIGNS[name],
                                  _path_layout(p), v), 3)
            for p, v in visits.items() if _path_layout(p) in walked}
    out["package"]["visits"] = visits
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", help="a checkout whose kernels join the sweep")
    p.add_argument("--out", help="also write the JSON lines here")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--kernels", nargs="+", choices=(*SWEPT, *FAMILIES),
                   default=list(SWEPT))
    p.add_argument("--designs", nargs="+", help="the walks' designs to "
                   "time (of PACKED_DESIGNS, PRESORTED, WIDE_DESIGNS and "
                   "LAYOUT_DESIGNS; default all)")
    args = p.parse_args(argv)
    args.kernels = list(dict.fromkeys(
        k for name in args.kernels for k in FAMILIES.get(name, (name,))))
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = kernel_lib()
    built = build_variants(args.kernels, args.against, args.designs)
    waves = wavefronts(args.kernels)
    # (kernel, variant) -> (function, its signature key, its wavefronts)
    fns = {}
    for kernel in args.kernels:
        source, entry = SWEPT[kernel][:2]
        sig0 = {"packed": packed_sig}.get(
            kernel, lambda _: kernel)(_read(CSRC_DIR, source))
        ref = _loaded(sig0, lib._name, entry)
        want = [CALLS[sig0](ref, *w) for w in waves[kernel]]
        variants = {(kernel, "package"): (ref, sig0, waves[kernel])}
        if kernel == "dense":
            variants[(kernel, "all_tested")] = (
                ref, kernel, [all_tested(w) for w in waves[kernel]])
        if kernel == "rows":   # the word-major walk, then a transpose
            variants[(kernel, "transposed")] = (
                _loaded("rows_transposed", lib._name, "rk_topwalk_mask"),
                "rows_transposed", waves[kernel])
        if kernel == "uncompact":   # without the compaction's counts
            variants[(kernel, "count_pass")] = (
                ref, kernel, [w[:4] for w in waves[kernel]])
        for (k, name), (path, fn, sig) in built.items():
            if k == kernel:
                f = _loaded(sig, path, fn)
                # a layout design walks some layouts: None for the others
                ws = [w if sig != "layouts_design" or w[0] in f else None
                      for w in waves[kernel]]
                variants[(k, name)] = (f, sig, ws)
        if kernel == "packed" and ("packed", "pr12") in built:
            for pre, (name, keys) in PRESORTED.items():
                variants[(kernel, pre)] = (
                    variants[(kernel, name)][0], "packed_presorted",
                    [presort(*w, keys) for w in waves[kernel]])
        if kernel in DESIGNED and args.designs:
            variants = {k: v for k, v in variants.items()
                        if k[1] in ("package", "against", *args.designs)}
        for (k, name), (fn, sig, ws) in variants.items():
            for w, exp in zip(ws, want):
                if w is None:
                    continue
                for x, y in zip(CALLS[sig](fn, *w), exp):
                    if x.dtype == torch.float32:
                        x, y = x.view(torch.int32), y.view(torch.int32)
                    if not torch.equal(x, y):
                        raise AssertionError(f"{kernel} {name} differs from "
                                             f"the package's kernel")
        fns.update(variants)
    times = {key_: [] for key_ in fns}
    graphed = {key_: [] for key_ in fns if key_[0] in GRAPHED}
    with SmClock() as clock:
        for _ in range(args.rounds):
            for key_, (fn, sig, ws) in fns.items():
                times[key_].append(
                    [None if w is None else _ms(lambda w=w: CALLS[sig](fn, *w))
                     for w in ws])
                if key_ in graphed:
                    graphed[key_].append(
                        [None if w is None else
                         _graph_ms(lambda w=w: CALLS[sig](fn, *w))
                         for w in ws])
    extra = {}
    if ("packed", "pr12") in built:
        extra["packed"] = packed_measures(built, lib, waves, args.designs)
    if "wide" in args.kernels:
        extra["wide"] = wide_measures(built, lib, waves, args.designs)
    if "layouts" in args.kernels:
        extra["layouts"] = layouts_measures(built, lib, waves, args.designs)
    def frame(r, paths=None, p=None):   # a round's sum (over one path's)
        return round(sum(x for x, q in zip(r, paths or r) if x is not None
                         and (p is None or q == p)), 6)

    lines = []
    for (kernel, name), rounds in times.items():
        line = {"kernel": kernel, "variant": name, "card": card,
                "sm_clock_mhz": clock.summary(),
                "ms_per_frame": [frame(r) for r in rounds],
                "ms_per_wavefront": [x if x is None else round(x, 6)
                                     for x in rounds[-1]]}
        if (kernel, name) in graphed:
            g = graphed[(kernel, name)]
            line["graph_ms_per_frame"] = [frame(r) for r in g]
            line["graph_ms_per_wavefront"] = [x if x is None else round(x, 6)
                                              for x in g[-1]]
        if kernel in DESIGNED:
            paths = waves[f"{kernel}_path"]
            walked = {q for x, q in zip(rounds[-1], paths) if x is not None}
            for key_, per in (("ms_per_frame", rounds),
                              ("graph_ms_per_frame", graphed.get(
                                  (kernel, name), []))):
                line[key_ + "_by_path"] = {
                    p: [frame(r, paths, p) for r in per]
                    for p in dict.fromkeys(paths) if p in walked}
            line.update(extra.get(kernel, {}).get(name, {}))
        lines.append(json.dumps(line))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(card + "\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
