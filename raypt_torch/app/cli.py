"""Command-line interface (`raypt/app/cli.py`): offline progressive
rendering to image files, AOV dumps and the inverse-rendering demo, on
the card unless `--device cpu`.

Usage:
  python -m raypt_torch.app.cli render --scene cornell_bunny --size 512 \\
      --spp 16 --bounces 6 -o out.png [--aovs] [--checkpoint state.npz]
  python -m raypt_torch.app.cli inverse --steps 100 -o recovered.npz
  python -m raypt_torch.app.cli bench    (not ported: exits non-zero)

`main(argv)` returns what the subcommand made: render the accumulated
radiance (H, W, 3), inverse (params, losses).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

# what `bench` waits for, named by its message
BENCH_ITEM = 'ROADMAP queue 1, the "Port bench" item'


def _build_scene(name: str, size, obj: str | None):
    from ..core.scene import MaterialDef, SceneBuilder
    from ..scenes.builtin import (cornell_box, cornell_box_with_bunny,
                                  load_reference_envmap, stanford_bunny,
                                  textured_demo, triangle_ground)

    if name == "cornell":
        b = cornell_box()
    elif name == "bunny":
        b = stanford_bunny()
    elif name == "cornell_bunny":
        b = cornell_box_with_bunny()
    elif name == "triangle":
        b = triangle_ground()
    elif name == "textured":
        b = textured_demo()
    elif name == "config4":
        # BASELINE configs[3]: glTF meshes, textures, an HDR sky (render
        # with --bounces 8; cmd_render enables refraction for its glass)
        from ..scenes.config4 import config4_scene
        b = config4_scene()
    elif name == "obj":
        if not obj:
            raise SystemExit("--obj PATH required for --scene obj")
        from ..io import load_mesh
        mesh = load_mesh(obj)   # OBJ, PLY, or glTF/GLB by signature
        b = SceneBuilder(env=load_reference_envmap())
        gltf_mats = mesh.get("materials")
        if gltf_mats and mesh.get("face_materials") is not None:
            # glTF pbr materials, one add_mesh per material group
            fm = np.asarray(mesh["face_materials"])
            ids = [b.add_material(MaterialDef(
                albedo=m["albedo"], emissive=m["emissive"],
                roughness=m["roughness"])) for m in gltf_mats]
            default = b.add_material(MaterialDef(albedo=(0.8, 0.8, 0.8)))
            for mi in np.unique(fm):
                mat = ids[mi] if 0 <= mi < len(ids) else default
                b.add_mesh(mesh["positions"], mesh["normals"],
                           mesh["faces"][fm == mi], uvs=mesh["uvs"],
                           material=mat)
        else:
            mat = b.add_material(MaterialDef(albedo=(0.8, 0.8, 0.8)))
            b.add_mesh(mesh["positions"], mesh["normals"], mesh["faces"],
                       uvs=mesh["uvs"], material=mat)
        # frame the mesh: back the camera off along +z from the box
        # centre until the 90 degree frustum holds it
        lo = np.min(mesh["positions"], axis=0)
        hi = np.max(mesh["positions"], axis=0)
        center = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - lo)) / 2 or 1.0
        b.camera.position = tuple(center + np.array([0, 0, 2.2 * radius]))
        b.camera.angle_y = 0.0
    else:
        raise SystemExit(f"unknown scene {name!r}")
    b.camera.viewport_width, b.camera.viewport_height = size
    return b


def render_accel(scene, cfg):
    """The accel the CLI hands the finder: the LBVH for the "bvh*",
    "auto" and "pallas" backends (built on the scene's device; "auto"
    then resolves to "bvh", "pallas" ignores it), the onehot accel at
    cfg.onehot_leaf for "onehot", else None (make_finder builds what it
    needs)."""
    from ..accel import lbvh
    from ..accel.ctree import build_onehot
    m = scene.mesh
    if cfg.backend in ("bvh", "bvh2", "bvh4", "auto", "pallas"):
        return lbvh.build(m.positions, m.faces, m.face_valid)
    if cfg.backend == "onehot":
        return build_onehot(lbvh.build(m.positions, m.faces, m.face_valid),
                            m.positions, m.faces, m.face_valid,
                            leaf=cfg.onehot_leaf)
    return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def cmd_render(args):
    from ..core.types import RenderConfig
    from ..io import load_render_state, save_render_state, write_png
    from ..render.integrator import (accumulate, make_finder, render_aovs,
                                     render_frame)
    from ..render.tonemap import to_display
    from ..rng.sampler import key as make_key
    from .metrics import RenderMetrics, Timer

    dev = torch.device(args.device)
    size = (args.size, args.size)
    scene = _build_scene(args.scene, size, args.obj).freeze(dev)
    # the dielectric lobe only where the scene has a refractive material
    refr = bool(float(scene.materials.refraction_percent.max()) > 0.0)
    # the compaction group applies only with the expansion (fault 3.4)
    cfg = RenderConfig(width=size[0], height=size[1],
                       samples_per_pixel=args.spp, num_bounces=args.bounces,
                       backend=args.backend, enable_refraction=refr,
                       onehot_leaf=args.onehot_leaf,
                       onehot_expand=args.onehot_expand,
                       onehot_compact=(args.onehot_compact
                                       if args.onehot_expand else 0))
    accel = render_accel(scene, cfg)
    finder = make_finder(scene, cfg, accel)

    key = make_key(args.seed)
    acc, start_frame = None, 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        acc, start_frame, key = load_render_state(args.checkpoint, dev)
        print(f"resumed at frame {start_frame}", file=sys.stderr)

    timer = Timer()
    for fi in range(start_frame, start_frame + args.frames):
        if args.check:
            from .debug import checked_render_frame
            _, img = checked_render_frame(scene, cfg, key, frame_index=fi,
                                          accel=accel, throw=True)
        else:
            img = render_frame(scene, cfg, key, frame_index=fi, finder=finder)
        acc = img if acc is None else accumulate(acc, img, fi)
    _sync(dev)
    secs = timer.lap()

    m = RenderMetrics(width=size[0], height=size[1], spp=args.spp,
                      bounces=args.bounces, frames=args.frames, seconds=secs)
    m.log(scene=args.scene, backend=cfg.backend, device=str(dev))

    write_png(args.output, to_display(acc, args.exposure).cpu())
    print(f"wrote {args.output}", file=sys.stderr)
    if args.checkpoint:
        save_render_state(args.checkpoint, acc, start_frame + args.frames, key)
    if args.aovs:
        base = os.path.splitext(args.output)[0]
        aov = render_aovs(scene, cfg, finder=finder)
        d = aov["depth"].cpu().numpy()
        dmax = d.max() or 1.0
        write_png(base + ".depth.png", d / dmax)
        write_png(base + ".normal.png", aov["normal"].cpu().numpy() * 0.5 + 0.5)
        write_png(base + ".albedo.png", aov["albedo"].cpu().numpy())
        print(f"wrote {base}.{{depth,normal,albedo}}.png", file=sys.stderr)
    return acc


def cmd_bench(args):
    raise SystemExit(f"bench: the port has no benchmark yet ({BENCH_ITEM}); "
                     f"the JAX package's bench.py is not run by the port")


def cmd_inverse(args):
    from ..core.types import RenderConfig
    from ..diff import fit
    from ..io import save_pytree
    from ..render.integrator import render_frame
    from ..rng.sampler import key as make_key
    from .metrics import log_step

    dev = torch.device(args.device)
    size = (args.size, args.size)
    scene = _build_scene(args.scene, size, args.obj).freeze(dev)
    cfg = RenderConfig(width=size[0], height=size[1],
                       samples_per_pixel=args.spp, num_bounces=args.bounces,
                       backend="bruteforce" if scene.mesh.num_faces < 512
                       else "bvh", russian_roulette=False)

    # self-target demo: perturb the albedo, recover it
    key = make_key(args.seed)
    views = [scene.camera]
    with torch.no_grad():
        targets = torch.stack([render_frame(scene, cfg, key)])
    bad = scene.replace(materials=scene.materials.replace(
        albedo=torch.clamp(scene.materials.albedo + 0.3, 0.02, 0.98)))

    params, losses = fit(bad, cfg, views, targets,
                         trainable=tuple(args.trainable.split(",")),
                         steps=args.steps, learning_rate=args.lr, key=key,
                         callback=lambda i, p, l: log_step(i, l)
                         if i % 10 == 0 else None)
    save_pytree(args.output, params, step=args.steps)
    print(f"final loss {losses[-1]:.6f} -> {args.output}", file=sys.stderr)
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="raypt_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="progressive render to PNG")
    pr.add_argument("--scene", default="cornell_bunny",
                    choices=["cornell", "bunny", "cornell_bunny", "triangle",
                             "textured", "config4", "obj"])
    pr.add_argument("--obj", default=None, help="OBJ path for --scene obj")
    pr.add_argument("--size", type=int, default=512)
    pr.add_argument("--spp", type=int, default=5)
    pr.add_argument("--bounces", type=int, default=6)
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--backend", default="auto",
                    choices=["auto", "bvh", "bvh2", "bvh4", "dense",
                             "bruteforce", "pallas", "onehot", "cluster"])
    pr.add_argument("--onehot-leaf", type=int, default=384,
                    help="backend onehot: triangles a cluster (384 with "
                         "the expansion kernel; 128 for the dense-union "
                         "kernel)")
    pr.add_argument("--onehot-expand", type=int, default=8192,
                    help="backend onehot: rays a program of the per-ray-"
                         "exact expansion (0 = the dense per-tile union "
                         "kernel)")
    pr.add_argument("--onehot-compact", type=int, default=32768,
                    help="backend onehot: alive-compaction group (0 = "
                         "off); applies only with --onehot-expand")
    pr.add_argument("--exposure", type=float, default=0.5)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--aovs", action="store_true")
    pr.add_argument("--check", action="store_true",
                    help="render with finite and index checks (debug "
                         "mode, slower)")
    pr.add_argument("-o", "--output", default="render.png")
    pr.add_argument("--device", default="cuda")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="the benchmark (not ported yet)")
    pb.add_argument("--size", type=int, default=1024)
    pb.add_argument("--bounces", type=int, default=4)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("inverse", help="inverse-rendering demo")
    pi.add_argument("--scene", default="triangle")
    pi.add_argument("--obj", default=None)
    pi.add_argument("--size", type=int, default=32)
    pi.add_argument("--spp", type=int, default=1)
    pi.add_argument("--bounces", type=int, default=2)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=0.05)
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--trainable", default="albedo_logits")
    pi.add_argument("-o", "--output", default="params.npz")
    pi.add_argument("--device", default="cuda")
    pi.set_defaults(fn=cmd_inverse)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
