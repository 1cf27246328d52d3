"""Design sweep of two kernels on the card:

    python -m raypt_torch.kernels.sweep [--against DIR] [--out FILE]

The Woop union kernel: variants of the constants of
`csrc/cluster_intersect.cu` (threads a tile `kThreads`, rays a thread
`kRays`, the most threads that share a ray's triangles `kMaxSplit`, the
launch bound's `kMinBlocks`), each built as a library of its own; the
first is the package's own setting. The mask-only walk: the package's
kernel beside the designs of `csrc/walk_designs.cu` (walks a thread
interleaved, live rays packed, threads refilled from the packed rays;
that file says how), built as one library. With `--against`, the
kernels of another checkout (DIR/raypt_torch/csrc) join as variant
"against". Each variant is held bitwise against the package's kernel,
then all are timed in turns (CUDA events, mean of 10 launches after a
warm-up, `--rounds` rounds) on the eight bounce wavefronts of the
config-4 render (`scripts/baseline_config4.py`: 1024^2, leaf 128; the
Woop kernel and the walk) and on the four of the bench scene's
dense-union render (leaf 128: the wavefronts the unfused path walks),
while nvidia-smi samples the SM clock. Prints the card's name and power
limit, then one JSON line a variant: ms per frame of each round (summed
over the wavefronts), the last round's ms per wavefront (config4's,
then the bench's) and the SM clock. Runs only on the card.
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
# the walk's designs: entry rk_walk_<name> of csrc/walk_designs.cu
WALK_DESIGNS = ("unpacked", "interleaved2", "interleaved3",
                "packed_interleaved2", "refilled1", "refilled2")
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGS = {"woop": [P, I32, P, I32, I32, P, P, P, P, P, I64, P],
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


def build_variants(against: str | None) -> dict:
    """(kernel, variant) -> (library path, C entry point), every library
    built in parallel (one nvcc each); the package's own kernels come
    from `kernel_lib()`."""
    entry = {"woop": "rk_cluster_intersect_mask_woop",
             "walk": "rk_topwalk_mask"}
    woop_src = _read(CSRC_DIR, "cluster_intersect.cu")
    jobs = {("woop", name): (_nvcc_job(
                f"woop_{name}", "cluster_intersect.cu",
                _set(woop_src, "struct WoopTest {", consts), CSRC_DIR),
                entry["woop"])
            for name, consts in WOOP_VARIANTS.items()}
    designs = _nvcc_job("walk_designs", "walk_designs.cu",
                        _read(CSRC_DIR, "walk_designs.cu"), CSRC_DIR)
    for name in WALK_DESIGNS:
        jobs[("walk", name)] = (designs, f"rk_walk_{name}")
    if against:
        other = os.path.join(against, "raypt_torch", "csrc")
        for kernel, source in (("woop", "cluster_intersect.cu"),
                               ("walk", "onehot_walk.cu")):
            jobs[(kernel, "against")] = (_nvcc_job(
                f"{kernel}_against", source, _read(other, source), other),
                entry[kernel])
    thunks = list({id(b): b for b, _ in jobs.values()}.values())
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        built = dict(zip(map(id, thunks), pool.map(lambda b: b(), thunks)))
    return {key_: (built[id(b)], fn) for key_, (b, fn) in jobs.items()}


def _loaded(kernel: str, path: str, fn: str):
    f = getattr(ctypes.CDLL(path), fn)
    f.argtypes, f.restype = SIGS[kernel], ctypes.c_int
    return f


def wavefronts():
    """(config4's eight (union, woop_cm, o, d, seed, walk args), the
    bench dense-union render's four walk args), recorded on the card."""
    from ..accel.clusters import tile_union_counts
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
    out = []
    for build, cfg, k in (
            (config4_scene, RenderConfig(
                width=WIDTH, height=WIDTH, samples_per_pixel=1,
                num_bounces=8, russian_roulette=True,
                enable_refraction=True, backend="onehot", onehot_leaf=LEAF),
             7),
            (stanford_bunny, RenderConfig(
                width=WIDTH, height=WIDTH, samples_per_pixel=1,
                num_bounces=4, russian_roulette=True, backend="onehot",
                onehot_leaf=LEAF), 0)):
        b = build()
        b.camera.viewport_width = b.camera.viewport_height = WIDTH
        scene = b.freeze("cuda")
        m = scene.mesh
        acc = build_onehot(build_sah(m), m.positions, m.faces, m.face_valid,
                           leaf=LEAF, with_woop=build is config4_scene
                           ).to("cuda")
        finder = make_finder(scene, cfg, acc)
        waves = []

        def rec(s, ro, rd, active=None, finder=finder, waves=waves):
            o, d, t, a, _, _ = wavefront_inputs(s, ro, rd, active,
                                                DENSE_CHUNK)
            wargs = (acc.table, o, d, t, a, -(-acc.num_clusters // 32))
            seed = torch.where(a, t, torch.full_like(t, -BIG))
            union = tile_union_counts(wk.topwalk(*wargs), TILE)[0]
            waves.append(((union, acc.woop_cm, o, d, seed), wargs))
            return finder(s, ro, rd, active)

        with torch.no_grad():
            render_sample(scene, cfg, sample_key(frame_key(key(k), 0), 0),
                          rec)
        out.append(waves)
    return out


def _call_woop(fn, union, woop_cm, o, d, seed):
    t = torch.empty_like(seed)
    p = torch.empty(seed.shape, dtype=torch.int32, device=seed.device)
    rc = fn(union.data_ptr(), union.shape[1], woop_cm.data_ptr(),
            woop_cm.shape[0], woop_cm.shape[2] // 3, o.data_ptr(),
            d.data_ptr(), seed.data_ptr(), t.data_ptr(), p.data_ptr(),
            union.shape[0], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"woop launch failed: CUDA error {rc}")
    return t, p


def _call_walk(fn, table, o, d, t, a, nw):
    from ..accel.ctree import walk_max_steps
    mask = torch.empty((nw, o.shape[0]), dtype=torch.int32, device=o.device)
    rc = fn(table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
            t.data_ptr(), a.data_ptr(), mask.data_ptr(), o.shape[0], nw,
            walk_max_steps(table.shape[0]),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"walk launch failed: CUDA error {rc}")
    return (mask,)


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
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = kernel_lib()
    built = build_variants(args.against)
    c4, bench = wavefronts()
    runs = {"woop": ([w for w, _ in c4], _call_woop,
                     "rk_cluster_intersect_mask_woop"),
            "walk": ([a for _, a in c4] + [a for _, a in bench], _call_walk,
                     "rk_topwalk_mask")}
    fns = {}
    for kernel, (waves, call, entry) in runs.items():
        ref = _loaded(kernel, lib._name, entry)
        want = [call(ref, *w) for w in waves]
        variants = {(kernel, "package"): ref} if kernel == "walk" else {}
        for (k, name), (path, fn) in built.items():
            if k == kernel:
                variants[(k, name)] = _loaded(k, path, fn)
        for (k, name), fn in variants.items():
            for w, exp in zip(waves, want):
                for x, y in zip(call(fn, *w), exp):
                    if not torch.equal(x.view(torch.int32),
                                       y.view(torch.int32)):
                        raise AssertionError(f"{kernel} {name} differs from "
                                             f"the package's kernel")
        fns.update(variants)
    times = {key_: [] for key_ in fns}
    with SmClock() as clock:
        for _ in range(args.rounds):
            for (kernel, name), fn in fns.items():
                waves, call, _ = runs[kernel]
                times[(kernel, name)].append(
                    [_ms(lambda w=w: call(fn, *w)) for w in waves])
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
