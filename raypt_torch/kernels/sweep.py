"""Design sweep of the finder kernels on the card:

    python -m raypt_torch.kernels.sweep [--against DIR] [--out FILE]
                                        [--kernels K ...]

Variants of a kernel's constants are built from its source with those
constants set (`_set`), each as a library of its own:
  * woop: the Woop union kernel (`csrc/cluster_intersect.cu`, struct
    WoopTest: threads a tile `kThreads`, rays a thread `kRays`, the most
    threads that share a ray's triangles `kMaxSplit`, the launch bound's
    `kMinBlocks`); the first variant is the package's own setting;
  * worklist: the worklist kernel, the union template's ListSource
    instance (struct MtTest, the same four constants);
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
  * mask: the Moller-Trumbore union kernel, the package's alone.
With `--against`, the kernels of another checkout (DIR/raypt_torch/csrc)
join as variant "against". Each variant is held bitwise against the
package's kernel, then all are timed in turns (CUDA events, mean of 10
launches after a warm-up, `--rounds` rounds) on the wavefronts of
1024^2 renders recorded on the card: the eight bounces of the config-4
render (`scripts/baseline_config4.py`: leaf 128; woop and walk), and the
four of the bench scene's renders through the dense-union finder (leaf
128: walk and mask), the cluster finder (clusters of 64: worklist) and
the pallas finder (dense), while nvidia-smi samples the SM clock. Prints
the card's name and power limit, then one JSON line a variant: ms per
frame of each round (summed over the wavefronts), the last round's ms per
wavefront and the SM clock. Runs only on the card.
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

import torch

from .._native_build import BUILD_DIR, build_library
from ._build import CSRC_DIR, KERNEL_HEADERS, NVCC_FLAGS, _nvcc, kernel_lib

WIDTH = 1024
LEAF = 128
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
# kernel -> (source, C entry point, scope of its constants, variants)
SWEPT = {
    "woop": ("cluster_intersect.cu", "rk_cluster_intersect_mask_woop",
             "struct WoopTest {", WOOP_VARIANTS),
    "worklist": ("cluster_intersect.cu", "rk_cluster_intersect",
                 "struct MtTest {", LIST_VARIANTS),
    "dense": ("dense_closest.cu", "rk_closest_dense",
              "// The main kernel's design", DENSE_VARIANTS),
    "walk": ("onehot_walk.cu", "rk_topwalk_mask", None, {}),
    "mask": ("cluster_intersect.cu", "rk_cluster_intersect_mask", None, {})}
# the walk's designs: entry rk_walk_<name> of csrc/walk_designs.cu
WALK_DESIGNS = ("unpacked", "interleaved2", "interleaved3",
                "packed_interleaved2", "refilled1", "refilled2")
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGS = {"woop": [P, I32, P, I32, I32, P, P, P, P, P, I64, P],
        "mask": [P, I32, P, I32, I32, P, P, P, P, P, I64, P],
        "worklist": [P, P, I32, I32, P, I32, I32, P, P, P, P, P, I64, P],
        "dense": [P, P, P, P, P, P, I64, P, P, P, P, P, I64, P, P, P, P],
        # closest_dense before its list of the triangles that can hit
        "dense_unlisted": [P, P, P, P, P, P, I64, P, P, P, P, P, I64, P],
        "walk": [P, I32, P, P, P, P, P, I64, I32, I32, P]}


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


def build_variants(kernels, against: str | None) -> dict:
    """(kernel, variant) -> (library path, C entry point, signature key),
    every library built in parallel (one nvcc each); the package's own
    kernels come from `kernel_lib()`."""
    jobs = {}
    for kernel in kernels:
        source, entry, scope, variants = SWEPT[kernel]
        text = _read(CSRC_DIR, source)
        for name, consts in variants.items():
            jobs[(kernel, name)] = (_nvcc_job(
                f"{kernel}_{name}", source, _set(text, scope, consts),
                CSRC_DIR), entry, kernel)
    if "walk" in kernels:
        designs = _nvcc_job("walk_designs", "walk_designs.cu",
                            _read(CSRC_DIR, "walk_designs.cu"), CSRC_DIR)
        for name in WALK_DESIGNS:
            jobs[("walk", name)] = (designs, f"rk_walk_{name}", "walk")
    if against:
        other = os.path.join(against, "raypt_torch", "csrc")
        for kernel in kernels:
            source, entry, _, _ = SWEPT[kernel]
            text = _read(other, source)
            sig = kernel
            if kernel == "dense" and "pack_live_kernel" not in text:
                sig = "dense_unlisted"
            jobs[(kernel, "against")] = (_nvcc_job(
                f"{kernel}_against", source, text, other), entry, sig)
    thunks = list({id(b): b for b, _, _ in jobs.values()}.values())
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        built = dict(zip(map(id, thunks), pool.map(lambda b: b(), thunks)))
    return {key_: (built[id(b)], fn, sig)
            for key_, (b, fn, sig) in jobs.items()}


def _loaded(sig: str, path: str, fn: str):
    f = getattr(ctypes.CDLL(path), fn)
    f.argtypes, f.restype = SIGS[sig], ctypes.c_int
    return f


def wavefronts() -> dict:
    """kernel -> its launches' arguments on the card: config4's eight
    bounces (woop, walk), the bench scene's four through the dense-union
    finder (walk, mask), the cluster finder (worklist) and the pallas
    finder (dense)."""
    from ..accel.clusters import (CLUSTER_LEAF, build_clusters,
                                  tile_union_counts, tile_worklists)
    from ..accel.ctree import build_onehot
    from ..accel.host_bvh import build_sah
    from ..accel.traverse import DENSE_CHUNK, wavefront_inputs
    from ..core.math3d import BIG
    from ..core.types import RenderConfig
    from ..render.integrator import make_finder, render_sample
    from ..rng.sampler import frame_key, key, sample_key
    from ..scenes.builtin import stanford_bunny
    from ..scenes.config4 import config4_scene
    from . import onehot_walk as wk
    from .cluster_pallas import TILE
    from .dense_pallas import RAY_TILE
    out = {k: [] for k in SWEPT}
    bench = RenderConfig(width=WIDTH, height=WIDTH, samples_per_pixel=1,
                         num_bounces=4, russian_roulette=True)
    for build, cfg, k in (
            (config4_scene, RenderConfig(
                width=WIDTH, height=WIDTH, samples_per_pixel=1,
                num_bounces=8, russian_roulette=True,
                enable_refraction=True, backend="onehot", onehot_leaf=LEAF),
             7),
            (stanford_bunny, bench.replace(backend="onehot",
                                           onehot_leaf=LEAF), 0),
            (stanford_bunny, bench.replace(backend="cluster"), 0),
            (stanford_bunny, bench.replace(backend="pallas"), 0)):
        b = build()
        b.camera.viewport_width = b.camera.viewport_height = WIDTH
        scene = b.freeze("cuda")
        m = scene.mesh
        if cfg.backend == "onehot":
            acc = build_onehot(build_sah(m), m.positions, m.faces,
                               m.face_valid, leaf=LEAF,
                               with_woop=build is config4_scene).to("cuda")
        elif cfg.backend == "cluster":
            acc = build_clusters(build_sah(m), m.positions, m.faces,
                                 m.face_valid, leaf=CLUSTER_LEAF).to("cuda")
        else:
            acc = None
        finder = make_finder(scene, cfg, acc)

        def rec(s, ro, rd, active=None, finder=finder, acc=acc, cfg=cfg,
                c4=build is config4_scene):
            if cfg.backend == "pallas":
                mats = finder.args[0]
                o, d, t, _, _, _ = wavefront_inputs(s, ro, rd, None, RAY_TILE)
                out["dense"].append((*mats, o, d, t))
                return finder(s, ro, rd, active)
            o, d, t, a, _, _ = wavefront_inputs(s, ro, rd, active,
                                                DENSE_CHUNK)
            seed = torch.where(a, t, torch.full_like(t, -BIG))
            if cfg.backend == "cluster":
                wl, cnt, _ = tile_worklists(acc, o, d, seed, TILE)
                out["worklist"].append((wl, cnt, acc.tri_rows, o, d, seed))
                return finder(s, ro, rd, active)
            wargs = (acc.table, o, d, t, a, -(-acc.num_clusters // 32))
            union = tile_union_counts(wk.topwalk(*wargs), TILE)[0]
            out["walk"].append(wargs)
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


CALLS = {"woop": _call_union, "mask": _call_union,
         "worklist": _call_worklist, "dense": _call_dense,
         "dense_unlisted": lambda fn, *w: _call_dense(fn, *w, listed=False),
         "walk": _call_walk}


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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", help="a checkout whose kernels join the sweep")
    p.add_argument("--out", help="also write the JSON lines here")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--kernels", nargs="+", choices=tuple(SWEPT),
                   default=list(SWEPT))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = kernel_lib()
    built = build_variants(args.kernels, args.against)
    waves = wavefronts()
    # (kernel, variant) -> (function, its signature key, its wavefronts)
    fns = {}
    for kernel in args.kernels:
        entry = SWEPT[kernel][1]
        ref = _loaded(kernel, lib._name, entry)
        want = [CALLS[kernel](ref, *w) for w in waves[kernel]]
        variants = {(kernel, "package"): (ref, kernel, waves[kernel])}
        if kernel == "dense":
            variants[(kernel, "all_tested")] = (
                ref, kernel, [all_tested(w) for w in waves[kernel]])
        for (k, name), (path, fn, sig) in built.items():
            if k == kernel:
                variants[(k, name)] = (_loaded(sig, path, fn), sig,
                                       waves[kernel])
        for (k, name), (fn, sig, ws) in variants.items():
            for w, exp in zip(ws, want):
                for x, y in zip(CALLS[sig](fn, *w), exp):
                    if not torch.equal(x.view(torch.int32),
                                       y.view(torch.int32)):
                        raise AssertionError(f"{kernel} {name} differs from "
                                             f"the package's kernel")
        fns.update(variants)
    times = {key_: [] for key_ in fns}
    with SmClock() as clock:
        for _ in range(args.rounds):
            for key_, (fn, sig, ws) in fns.items():
                times[key_].append(
                    [_ms(lambda w=w: CALLS[sig](fn, *w)) for w in ws])
    lines = []
    for (kernel, name), rounds in times.items():
        lines.append(json.dumps({
            "kernel": kernel, "variant": name, "card": card,
            "sm_clock_mhz": clock.summary(),
            "ms_per_frame": [round(sum(r), 4) for r in rounds],
            "ms_per_wavefront": [round(x, 4) for x in rounds[-1]]}))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(card + "\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
