"""Multi-process launcher (`raypt/dist/launcher.py`; BASELINE config #5).

One process a rank; the ranks meet through the env vars, then run the
row-sharded render of `raypt_torch.dist.sharding`:

  RAYPT_COORDINATOR=127.0.0.1:29500 RAYPT_NUM_PROCS=2 RAYPT_PROC_ID=0 \\
      python -m raypt_torch.dist.launcher render --size 1024 ...

(and the same with RAYPT_PROC_ID=1 for the second rank). Across hosts,
number the ranks host by host and give each RAYPT_LOCAL_PROCS, the
ranks on its host. Each rank takes card (rank % cards) unless `--device
cpu`; the backend follows `sharding.pick_backend` (two ranks on one
card: gloo). Without RAYPT_COORDINATOR it is one process. Rank 0 writes
the PNG.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from . import sharding


def setup_from_env(device="cuda"):
    """init_distributed from RAYPT_COORDINATOR, RAYPT_NUM_PROCS (default
    1), RAYPT_PROC_ID (default 0) and RAYPT_LOCAL_PROCS, the ranks on
    this host (default RAYPT_NUM_PROCS: one host); a no-op without a
    coordinator. Returns the backend, or None."""
    coord = os.environ.get("RAYPT_COORDINATOR")
    if not coord:
        return None
    nprocs = int(os.environ.get("RAYPT_NUM_PROCS", "1"))
    pid = int(os.environ.get("RAYPT_PROC_ID", "0"))
    local = int(os.environ.get("RAYPT_LOCAL_PROCS", str(nprocs)))
    return sharding.init_distributed(coord, nprocs, pid, device=device,
                                     local_processes=local)


def main(argv=None):
    """Returns render's radiance image (every rank holds it) or bench's
    rate in Mray-seg/s."""
    ap = argparse.ArgumentParser(prog="raypt_torch.dist.launcher")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render")
    pr.add_argument("--scene", default="cornell_bunny")
    pr.add_argument("--size", type=int, default=512)
    pr.add_argument("--spp", type=int, default=4)
    pr.add_argument("--bounces", type=int, default=4)
    pr.add_argument("-o", "--output", default="render_dist.png")
    pr.add_argument("--device", default="cuda")

    pi = sub.add_parser("bench")
    pi.add_argument("--size", type=int, default=512)
    pi.add_argument("--bounces", type=int, default=4)
    pi.add_argument("--devices", type=int, default=0,
                    help="mesh size (0 = every rank)")
    pi.add_argument("--device", default="cuda")
    # bench has no --scene or --spp flag: it renders render's defaults
    pi.set_defaults(scene="cornell_bunny", spp=4)

    args = ap.parse_args(argv)
    launched = setup_from_env(args.device) is not None
    try:
        return _run(args)
    finally:
        if launched:
            dist.destroy_process_group()


def _run(args):
    from ..accel import lbvh
    from ..core.types import RenderConfig
    from ..rng.sampler import fold_in, key
    from ..scenes.builtin import cornell_box, cornell_box_with_bunny

    dev = sharding.local_device(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    print(f"process {rank}/{world}, device {dev}", file=sys.stderr)

    builder = (cornell_box_with_bunny() if args.scene == "cornell_bunny"
               else cornell_box())
    builder.camera.viewport_width = builder.camera.viewport_height = args.size
    scene = builder.freeze(dev)
    cfg = RenderConfig(width=args.size, height=args.size,
                       samples_per_pixel=args.spp, num_bounces=args.bounces,
                       backend="bvh")
    m = scene.mesh
    bvh = lbvh.build(m.positions, m.faces, m.face_valid)
    mesh = sharding.default_mesh(getattr(args, "devices", 0) or None)
    k = key(0)

    if args.cmd == "render":
        from ..io.image import write_png
        from ..render.tonemap import to_display
        img = sharding.render_frame_sharded(scene, cfg, k, mesh, bvh=bvh)
        if rank == 0:
            write_png(args.output, to_display(img).cpu())
            print(f"wrote {args.output}", file=sys.stderr)
        return img
    if mesh.rank < 0:       # outside a --devices mesh: nothing to time
        return None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sharding.render_frame_sharded(scene, cfg, k, mesh, bvh=bvh)
    sync()
    ts = []
    for i in range(3):
        t0 = time.perf_counter()
        sharding.render_frame_sharded(scene, cfg, fold_in(k, i), mesh,
                                      bvh=bvh)
        sync()
        ts.append(time.perf_counter() - t0)
    segs = args.size * args.size * args.spp * args.bounces
    rate = segs / min(ts) / 1e6
    print(f"devices={mesh.size} {rate:.2f} Mray-seg/s", file=sys.stderr)
    return rate


if __name__ == "__main__":
    main()
