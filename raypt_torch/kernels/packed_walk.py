"""Skip-link walk of the packed LBVH table over a wavefront of rays: the
`bvh` backend's finder stage. It replaces an XLA loop, the JAX package's
`raypt/accel/packed.py::traverse_wavefront`, not a Pallas kernel.

On CUDA tensors `packed_walk` launches `csrc/packed_walk.cu`: the
kernel derives the split table of `csrc/packed_walk.cuh` from the rows
into a scratch this wrapper allocates, then walks one ray a thread over
it (its plain models: `accel.packed.split_table`, `octant_order`). On
CPU tensors it runs the plain torch version,
`accel.packed.traverse_wavefront`, which the kernel equals bitwise on
the card.
"""
from __future__ import annotations

import torch

from ..accel.packed import ROW, PackedLBVH, traverse_wavefront
from ._build import kernel_lib, launch, on_cuda


def packed_walk(pbvh: PackedLBVH, ro, rd, t0, active,
                max_iters: int | None = None, unroll: int = 8):
    """`traverse_wavefront`'s contract: ro, rd (R, 3) f32, t0 (R,) f32,
    active (R,) bool -> (t_best (R,) f32, face (R,) int32, -1 = none).
    unroll changes no result; max_iters cuts each walk after
    max_iters * unroll steps."""
    rows = pbvh.rows
    r = ro.shape[0]
    if not on_cuda({"rows": (rows, (rows.shape[0], ROW), torch.float32),
                    "ro": (ro, (r, 3), torch.float32),
                    "rd": (rd, (r, 3), torch.float32),
                    "t0": (t0, (r,), torch.float32),
                    "active": (active, (r,), torch.bool)}):
        return traverse_wavefront(pbvh, ro, rd, t0, active, max_iters, unroll)
    if rows.shape[0] < 1:
        raise ValueError("the packed table has no rows")
    t_out = torch.empty_like(t0)
    f_out = torch.empty((r,), dtype=torch.int32, device=t0.device)
    scratch = torch.empty((kernel_lib().rk_packed_walk_scratch(rows.shape[0]), 4),
                          dtype=torch.float32, device=t0.device)
    max_steps = -1 if max_iters is None else max(max_iters, 0) * unroll
    launch("rk_packed_walk", rows.data_ptr(), rows.shape[0], ro.data_ptr(),
           rd.data_ptr(), t0.data_ptr(), active.data_ptr(), t_out.data_ptr(),
           f_out.data_ptr(), r, max_steps, scratch.data_ptr())
    packed_walk.launches += 1
    return t_out, f_out


packed_walk.launches = 0
