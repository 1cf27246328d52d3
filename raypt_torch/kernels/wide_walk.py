"""Ordered-stack walk of the 4-wide BVH over a wavefront of rays: the
`bvh4` backend's finder stage. It replaces an XLA loop, the JAX
package's `raypt/accel/wide.py::traverse_wide`, not a Pallas kernel.

On CUDA tensors `wide_walk` launches `csrc/wide_walk.cu` (one thread a
ray, each 128-ray block's rays handed out by direction octant, each
warp's leaf tests shared out over its lanes; the note at the head of
that source says why). On CPU tensors it runs the plain torch version,
`accel.wide.traverse_wide`, which the kernel equals bitwise on the card.
"""
from __future__ import annotations

import torch

from ..accel.wide import ROW, STACK_D, WideBVH, traverse_wide
from ._build import kernel_lib, launch, on_cuda


def wide_walk(w: WideBVH, ro, rd, t0, active, stack_d: int = STACK_D):
    """`traverse_wide`'s contract: ro, rd (R, 3) f32, t0 (R,) f32,
    active (R,) bool -> (t_best (R,) f32, face (R,) int32, -1 = none,
    overflow (R,) bool)."""
    rows = w.rows
    r = ro.shape[0]
    if not on_cuda({"rows": (rows, (rows.shape[0], ROW), torch.float32),
                    "ro": (ro, (r, 3), torch.float32),
                    "rd": (rd, (r, 3), torch.float32),
                    "t0": (t0, (r,), torch.float32),
                    "active": (active, (r,), torch.bool)}):
        return traverse_wide(w, ro, rd, t0, active, stack_d)
    n_rows = rows.shape[0]
    if not 0 <= w.root < n_rows or not 0 <= w.nw_cap <= n_rows:
        raise ValueError(f"root {w.root} / nw_cap {w.nw_cap} outside the "
                         f"table's {n_rows} rows")
    cap = kernel_lib().rk_wide_walk_max_stack()
    if not 1 <= stack_d <= cap:
        raise ValueError(f"stack_d {stack_d}: the kernel takes 1 to {cap}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    t_out = torch.empty_like(t0)
    f_out = torch.empty((r,), dtype=torch.int32, device=t0.device)
    o_out = torch.empty((r,), dtype=torch.bool, device=t0.device)
    if r == 0:   # no ray, no launch
        return t_out, f_out, o_out
    launch("rk_wide_walk", rows.data_ptr(), n_rows, w.root, w.nw_cap,
           ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), active.data_ptr(),
           t_out.data_ptr(), f_out.data_ptr(), o_out.data_ptr(), r, stack_d)
    wide_walk.launches += 1
    return t_out, f_out, o_out


wide_walk.launches = 0
