"""Skip-link walks of the packed LBVH tables over a wavefront of rays:
the `bvh` backend's finder stage. They replace XLA loops, the JAX
package's `raypt/accel/packed.py::traverse_wavefront` and, for the
table's other layouts, `traverse_wavefront2` / `_la` / `4` and
`traverse_wavefront_compact`, not Pallas kernels.

On CUDA tensors `packed_walk` launches `csrc/packed_walk.cu`: the
kernel derives the split table of `csrc/packed_walk.cuh` from the rows
into a scratch this wrapper allocates, then walks one ray a thread over
it (its plain models: `accel.packed.split_table`, `octant_order`).
`packed_walk2`, `packed_walk_la`, `packed_walk4` and `packed_walk4_la`
launch `csrc/packed_layouts.cu`'s walk of the cherry, lookahead, quad
and lookahead-quad tables: each kernel first builds its table's split
table of `csrc/packed_layouts.cuh` into a scratch this wrapper
allocates, then walks one ray a thread over it (its plain models:
`accel.packed.slot_table`, `traverse_slots`). On CPU tensors each runs
its plain torch version (`accel.packed`), which its kernel equals
bitwise on the card.

`WALKS` holds each layout's wrapper and its kernel's code in
`csrc/packed_layouts.cu`, by `accel.packed.LAYOUTS`' names;
`walk_layout` calls the wrapper of the table it is given;
`compact_walk` serves traversal_mode "compact" / "unrolled": on the card
the table's kernel over the whole wavefront, one launch (the JAX
package's phases and compaction schedule its loops and change no ray's
result), on the CPU `accel.packed.traverse_wavefront_compact`.
"""
from __future__ import annotations

import torch

from ..accel import packed
from ..accel.packed import (LAYOUTS, PackedLBVH, layout_of,
                            traverse_wavefront, traverse_wavefront_compact)
from ._build import kernel_lib, launch, on_cuda


def _specs(rows, width, ro, rd, t0, active):
    r = ro.shape[0]
    return {"rows": (rows, (rows.shape[0], width), torch.float32),
            "ro": (ro, (r, 3), torch.float32),
            "rd": (rd, (r, 3), torch.float32),
            "t0": (t0, (r,), torch.float32),
            "active": (active, (r,), torch.bool)}


def _check_layout(pbvh, name):
    """The table's layout is `name`, else TypeError."""
    got = layout_of(pbvh)
    if got != name:
        raise TypeError(f"{WALKS[name][0].__name__} walks the {name} table, "
                        f"got a {type(pbvh).__name__} of layout {got}")


def packed_walk(pbvh: PackedLBVH, ro, rd, t0, active,
                max_iters: int | None = None, unroll: int = 8):
    """`traverse_wavefront`'s contract: ro, rd (R, 3) f32, t0 (R,) f32,
    active (R,) bool -> (t_best (R,) f32, face (R,) int32, -1 = none).
    unroll changes no result; max_iters cuts each walk after
    max_iters * unroll steps."""
    _check_layout(pbvh, "one")
    rows = pbvh.rows
    r = ro.shape[0]
    if not on_cuda(_specs(rows, LAYOUTS["one"].width, ro, rd, t0, active)):
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


def _layout_walk(name, pbvh, ro, rd, t0, active):
    """The launch of layout `name`'s kernel (with the scratch of its
    split table), or its plain walk on CPU tensors. An empty wavefront
    launches nothing."""
    _check_layout(pbvh, name)
    wrapper, code = WALKS[name]
    rows = pbvh.rows
    r = ro.shape[0]
    if not on_cuda(_specs(rows, LAYOUTS[name].width, ro, rd, t0, active)):
        return packed.walk_layout(pbvh, ro, rd, t0, active)
    if rows.shape[0] < 1:
        raise ValueError("the packed table has no rows")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    t_out = torch.empty_like(t0)
    f_out = torch.empty((r,), dtype=torch.int32, device=t0.device)
    if r == 0:
        return t_out, f_out
    scratch = _scratch(code, rows)
    launch("rk_layout_walk", code, rows.data_ptr(), rows.shape[0],
           ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), active.data_ptr(),
           t_out.data_ptr(), f_out.data_ptr(), r, scratch.data_ptr())
    wrapper.launches += 1
    return t_out, f_out


def _scratch(code, rows, fill=None):
    """The scratch of layout `code`'s kernel for the table `rows` (float4
    rows, its split table), filled with `fill` where given."""
    n = kernel_lib().rk_layout_walk_scratch(code, rows.shape[0])
    if fill is None:
        return torch.empty((n, 4), dtype=torch.float32, device=rows.device)
    return torch.full((n, 4), fill, dtype=torch.float32, device=rows.device)


def layout_table(pbvh, fill=None):
    """The split table a layout's kernel builds from a table on the card
    before its walk (`accel.packed.slot_table`'s (inner, leaves) on the
    card), built alone: the walk's first launch, for its tests and
    timing. `fill`: the scratch's value before the build (the rows of
    the other kind stay as they were); counts no launch of the walk.
    The one-triangle table's split table is packed_walk's: TypeError."""
    name = layout_of(pbvh)
    if name not in packed.SLOT_LAYOUTS:
        raise TypeError(f"layout_table builds the split tables of "
                        f"{tuple(packed.SLOT_LAYOUTS)}, not the {name} "
                        f"table's")
    rows = pbvh.rows
    scratch = _scratch(WALKS[name][1], rows, fill)
    launch("rk_layout_build", WALKS[name][1], rows.data_ptr(), rows.shape[0],
           scratch.data_ptr())
    n = rows.shape[0]
    sl = packed.SLOT_LAYOUTS[name]
    width = 8 if sl.right is None else 16   # an internal row's floats
    return (scratch[:width // 4 * n].view(n, width),
            scratch[width // 4 * n:].view(n, packed.SLOT * sl.slots))


def packed_walk2(pbvh, ro, rd, t0, active):
    """`traverse_wavefront2`'s contract (the cherry table)."""
    return _layout_walk("cherry", pbvh, ro, rd, t0, active)


def packed_walk_la(pbvh, ro, rd, t0, active):
    """`traverse_wavefront_la`'s contract (the lookahead table)."""
    return _layout_walk("lookahead", pbvh, ro, rd, t0, active)


def packed_walk4(pbvh, ro, rd, t0, active):
    """`traverse_wavefront4`'s contract on a quad table with plain
    internal rows."""
    return _layout_walk("quad", pbvh, ro, rd, t0, active)


def packed_walk4_la(pbvh, ro, rd, t0, active):
    """`traverse_wavefront4`'s contract on a quad table with lookahead
    internal rows."""
    return _layout_walk("quad_la", pbvh, ro, rd, t0, active)


# each layout's wrapper and its kernel's code in csrc/packed_layouts.cu
# (the one-triangle table's kernel is csrc/packed_walk.cu)
WALKS = {"one": (packed_walk, None), "cherry": (packed_walk2, 0),
         "lookahead": (packed_walk_la, 1), "quad": (packed_walk4, 2),
         "quad_la": (packed_walk4_la, 3)}
for _w, _ in WALKS.values():
    _w.launches = 0


def wrapper_of(pbvh):
    """The walk wrapper of a packed table's layout."""
    return WALKS[layout_of(pbvh)][0]


def walk_layout(pbvh, ro, rd, t0, active):
    """The walk of the table's layout through its wrapper."""
    return wrapper_of(pbvh)(pbvh, ro, rd, t0, active)


def compact_walk(pbvh, ro, rd, t0, active):
    """traversal_mode "compact" / "unrolled" (`traverse_wavefront_compact`'s
    contract): a table on the card is walked by its kernel over the whole
    wavefront in one launch; on the CPU the plain compacting walk runs."""
    wrapper = wrapper_of(pbvh)
    if pbvh.rows.device.type == "cuda":
        return wrapper(pbvh, ro, rd, t0, active)
    return traverse_wavefront_compact(pbvh, ro, rd, t0, active)
