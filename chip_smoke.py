#!/usr/bin/env python3
"""Drive raypt_torch's bench render path once on one NVIDIA GPU and
check it, phase by phase; any failure raises and the exit code is not 0.

  1. the card (nvidia-smi name and power limit), torch and CUDA versions
  2. build the native SAH builder and the four CUDA kernels from source
  3. each kernel against its plain torch version on the card, at the
     bench shapes (R = 2^20 rays, cwp = 8 mask words, compaction groups
     of 32,768), on the wavefronts of all four bounces, plus all-dead and
     all-alive compaction groups and a 40-word mask case (leaf-16 accel,
     65,536 rays); every comparison is bitwise; CUDA-event times
  4. the bench render (stanford_bunny at 1024^2, 1 spp, 4 bounces,
     roulette, leaf 384, expand 8192, compact 32768) through
     render_sample: every kernel must launch once per bounce, the image
     must be finite and bitwise equal to the render with the plain finder
  5. the bench loss (mean image) forward and backward w.r.t. mesh
     positions and material albedo: finite grads, nonzero albedo grad,
     median seconds of 3 runs after a warm-up. The bench camera sits
     inside the stand-in bunny, where no path reaches the sky, so the
     gradient w.r.t. positions is about 0 there; from a view outside the
     mesh (GRAD_VIEW, GRAD_WIDTH^2) it is not, and the card's gradients
     through the kernels must agree with the CPU's through the plain
     versions to GRAD_RTOL of their largest magnitude; then one bench
     fwd+bwd step traced with torch.profiler: the device time of the top
     kernels and backward ops

The last line is {"ok": true, "device": {...}}; the line before it is
the per-kernel JSON summary, whose "ms" and "plain_ms" are summed over
the four bounce wavefronts (one frame's worth of launches).
Run: python3 chip_smoke.py
"""
import json
import os
import statistics
import subprocess
import sys
import time

WIDTH = HEIGHT = 1024
BOUNCES = 4
LEAF = 384
EXPAND_N = 8192
COMPACT_N = 32768
MULTIWORD_LEAF = 16
MULTIWORD_RAYS = 65536
GRAD_VIEW = dict(position=(30.0, -18.0, -200.0), angle_y=180.0)
GRAD_WIDTH = 128
GRAD_RTOL = 1e-3

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "alive_compact": ("raypt_torch/csrc/compact.cu",
                      "raypt/kernels/compact.py:180"),
    "topwalk_cm_u": ("raypt_torch/csrc/onehot_walk.cu",
                     "raypt/kernels/onehot_walk.py:252"),
    "cluster_expand": ("raypt_torch/csrc/cluster_expand.cu",
                       "raypt/kernels/cluster_expand.py:246"),
    "alive_uncompact": ("raypt_torch/csrc/compact.cu",
                        "raypt/kernels/compact.py:218"),
}


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


class Stats:
    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {k: 0.0 for k in KERNELS}
        self.plain_ms = {k: 0.0 for k in KERNELS}

    def check(self, name, what, a, b, where=None):
        eq, err = bitwise_equal(a, b, where)
        self.err[name] = max(self.err[name], err)
        if not eq:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"on {what} (max abs err {err})")


def compare_stages(stats, label, scene, accel, ro, rd, active, timed):
    """Run the finder's four stages on one wavefront with the kernels and
    with the plain versions, feeding both the kernel's outputs of the
    previous stage; every output must agree bitwise."""
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
    eargs = (km, ku, accel.clusters.tri_rows, kc[0], kc[1], seed)
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
        for name, k, p, fa in (
                ("alive_compact", cp.alive_compact, cp.alive_compact_plain,
                 args),
                ("topwalk_cm_u", wk.topwalk_cm_u, wk.topwalk_cm_u_plain,
                 wargs),
                ("cluster_expand", ex.cluster_expand, ex.cluster_expand_plain,
                 eargs),
                ("alive_uncompact", cp.alive_uncompact,
                 cp.alive_uncompact_plain, uargs)):
            k_ms = cuda_ms(lambda: k(*fa), 10)
            p_ms = cuda_ms(lambda: p(*fa), 2)
            stats.ms[name] += k_ms
            stats.plain_ms[name] += p_ms
            log(f"  {label:9s} {name:16s} kernel {k_ms:9.3f} ms   "
                f"plain {p_ms:9.3f} ms")


def _dev_us(e, inclusive):
    """Device microseconds of a profiler key average (torch renamed the
    cuda_* fields to device_*)."""
    names = (("device_time_total", "cuda_time_total") if inclusive else
             ("self_device_time_total", "self_cuda_time_total"))
    for n in names:
        if hasattr(e, n):
            return getattr(e, n)
    raise AttributeError(f"profiler event has none of {names}")


def profile_step(step):
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
    log(f"profile: {total / 1e3:.3f} ms of kernel time in one fwd+bwd step")
    for title, rows, inclusive in (
            ("kernels by device time", kernels, False),
            ("backward ops by inclusive device time",
             [e for e in ev if e.key.endswith("Backward0")], True)):
        log(f"profile: {title}")
        for e in sorted(rows, key=lambda e: -_dev_us(e, inclusive))[:8]:
            us = _dev_us(e, inclusive)
            log(f"  {us / 1e3:10.3f} ms {100 * us / total:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")


def grad_check(build_scene, render, dev):
    """Bench-loss gradients from GRAD_VIEW on the card through the
    kernels and on the CPU through the plain versions; render(scene)
    gives the image."""
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
        log(f"phase 5: {GRAD_WIDTH}^2 outside view, grad {name}: "
            f"{rows} nonzero rows, max {big:.3e}, card vs CPU max abs err "
            f"{err:.3e} ({err / max(big, 1e-30):.2e} of max)")
        if not bool(torch.isfinite(g).all()) or big == 0.0:
            raise AssertionError(f"grad w.r.t. {name} not finite or zero")
        if err > GRAD_RTOL * big:
            raise AssertionError(f"grad w.r.t. {name}: card and CPU differ "
                                 f"by {err / big:.2e} of the largest")


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
    _build.kernel_lib()
    log(f"phase 2: native SAH builder and CUDA kernels built in "
        f"{time.perf_counter() - t0:.1f} s")

    from raypt_torch.accel.ctree import build_onehot
    from raypt_torch.accel.host_bvh import build_sah
    from raypt_torch.accel.traverse import PLAIN, find_closest_onehot
    from raypt_torch.core.types import RenderConfig
    from raypt_torch.kernels import cluster_expand as ex
    from raypt_torch.kernels import compact as cp
    from raypt_torch.kernels import onehot_walk as wk
    from raypt_torch.render.integrator import make_finder, render_sample
    from raypt_torch.rng.sampler import frame_key, key, sample_key
    from raypt_torch.scenes.builtin import stanford_bunny

    builder = stanford_bunny()
    builder.camera.viewport_width = WIDTH
    builder.camera.viewport_height = HEIGHT
    scene_cpu = builder.freeze()
    scene = scene_cpu.to(dev)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=1,
                       num_bounces=BOUNCES, backend="onehot",
                       russian_roulette=True, onehot_leaf=LEAF,
                       onehot_expand=EXPAND_N, onehot_compact=COMPACT_N)
    t0 = time.perf_counter()
    bvh = build_sah(scene_cpu.mesh)
    m = scene_cpu.mesh
    accel = build_onehot(bvh, m.positions, m.faces, m.face_valid, leaf=LEAF)
    log(f"scene: {int(m.face_valid.sum())} faces (padded {m.num_faces}), "
        f"C = {accel.num_clusters} clusters, Nt = {accel.table.shape[0]} "
        f"top rows; host accel build {time.perf_counter() - t0:.2f} s")
    accel = accel.to(dev)
    finder = make_finder(scene, cfg, accel)
    skey = sample_key(frame_key(key(0), 0), 0)

    # phase 3: kernels vs plain versions on the bench wavefronts
    waves = []

    def recording_finder(s, ro, rd, active=None):
        waves.append((ro.reshape(-1, 3).clone(), rd.reshape(-1, 3).clone(),
                      active.reshape(-1).clone()))
        return finder(s, ro, rd, active)

    with torch.no_grad():
        render_sample(scene, cfg, skey, recording_finder)
    stats = Stats()
    log("phase 3: kernel vs plain, bitwise, per bounce wavefront")
    for b, (ro, rd, active) in enumerate(waves):
        log(f"  bounce {b}: {int(active.sum())} live rays of {active.numel()}")
        compare_stages(stats, f"bounce {b}", scene, accel, ro, rd,
                              active, timed=True)
    # compaction with all-dead and all-alive groups (bounce-1 wavefront)
    ro, rd, active = waves[1]
    edge = active.clone()
    edge[:COMPACT_N] = False
    edge[COMPACT_N:2 * COMPACT_N] = True
    compare_stages(stats, "edge grps", scene, accel, ro, rd, edge,
                   timed=False)
    # multi-word masks: leaf-16 accel, 65,536 rays of the bounce-1 wavefront
    accel16 = build_onehot(bvh, m.positions, m.faces, m.face_valid,
                           leaf=MULTIWORD_LEAF).to(dev)
    cwp16 = -(-accel16.num_clusters // 256) * 8
    log(f"  multi-word: leaf {MULTIWORD_LEAF}, C = {accel16.num_clusters}, "
        f"cwp = {cwp16}, Nt = {accel16.table.shape[0]}")
    compare_stages(stats, "multiword", scene, accel16,
                   ro[:MULTIWORD_RAYS].contiguous(),
                   rd[:MULTIWORD_RAYS].contiguous(),
                   active[:MULTIWORD_RAYS].contiguous(), timed=False)
    log("phase 3: all comparisons bitwise equal")

    # phase 4: the main path through the kernels
    counters = {"alive_compact": cp.alive_compact,
                "topwalk_cm_u": wk.topwalk_cm_u,
                "cluster_expand": ex.cluster_expand,
                "alive_uncompact": cp.alive_uncompact}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        img, traced = render_sample(scene, cfg, skey, finder,
                                    return_alive=True)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 4: launches {launches}")
    for k, n in launches.items():
        if n != BOUNCES:
            raise AssertionError(f"{k} launched {n} times, expected "
                                 f"{BOUNCES} (once per bounce)")
    if not bool(torch.isfinite(img).all()) or img.shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"bad image {tuple(img.shape)}")
    log(f"phase 4: traced_per_bounce {traced.tolist()}, image mean "
        f"{float(img.mean()):.6f}")

    def plain_finder(s, ro_, rd_, active=None):
        return find_closest_onehot(s, ro_, rd_, active, accel=accel,
                                   expand_n=EXPAND_N, compact_n=COMPACT_N,
                                   ops=PLAIN)

    with torch.no_grad():
        img_plain, traced_plain = render_sample(scene, cfg, skey, plain_finder,
                                                return_alive=True)
    eq, err = bitwise_equal(img, img_plain)
    if not eq or not torch.equal(traced, traced_plain):
        raise AssertionError(f"kernel and plain-finder renders differ "
                             f"(max abs err {err})")
    log("phase 4: image bitwise equal to the plain-finder render")

    # phase 5: the bench loss forward and backward
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

    def seconds(fn):
        fn()
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    fwd_s = seconds(fwd)
    fb_s = seconds(fwd_bwd)
    loss, tr, gv, ga = fwd_bwd()
    for name, g in (("positions", gv), ("albedo", ga)):
        if g is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"grad w.r.t. {name} is not finite")
    if not bool((ga != 0).any()):
        raise AssertionError("albedo grad is zero")
    segs = 2 * int(tr.sum())
    log(f"phase 5: loss {loss:.6f}, |grad positions| max "
        f"{float(gv.abs().max()):.3e}, |grad albedo| max "
        f"{float(ga.abs().max()):.3e}")
    log(f"phase 5: fwd s {[round(x, 4) for x in fwd_s]} median "
        f"{statistics.median(fwd_s):.4f}; fwd+bwd s "
        f"{[round(x, 4) for x in fb_s]} median {statistics.median(fb_s):.4f}; "
        f"traced segments fwd+bwd {segs} -> "
        f"{segs / statistics.median(fb_s) / 1e6:.3f} Mray-seg/s")
    log(f"phase 5: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def outside_scene():
        b = stanford_bunny()
        b.camera.viewport_width = b.camera.viewport_height = GRAD_WIDTH
        for k, val in GRAD_VIEW.items():
            setattr(b.camera, k, val)
        return b.freeze()

    gcfg = cfg.replace(width=GRAD_WIDTH, height=GRAD_WIDTH)
    grad_check(outside_scene,
               lambda s: render_sample(s, gcfg, skey,
                                       make_finder(s, gcfg, accel)),
               dev)
    profile_step(fwd_bwd)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": stats.err[k],
         "ms": round(stats.ms[k], 4), "plain_ms": round(stats.plain_ms[k], 4)}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
