"""Walk of the encoded cluster top tree, per ray, emitting the
wanted-cluster bitmask word-major plus one OR-union per walk tile
(`raypt/kernels/onehot_walk.py`: `pallas_topwalk_cm_u`).

On CUDA tensors this launches `csrc/onehot_walk.cu`; on CPU tensors it
runs the plain torch version, `accel.ctree.walk_topwalk`, transposed,
with the tile unions OR-folded in torch.
"""
from __future__ import annotations

import torch

from ..accel.ctree import ROW, walk_max_steps, walk_topwalk
from ._build import launch, on_cuda

RAY_TILE = 2048   # rays per union_pp row (the JAX walk program); the
                  # kernels' kRayTile
SMEM_LIMIT = 232448   # shared memory a block may use on Hopper (227 KB)


def tile_unions(mask_cm: torch.Tensor) -> torch.Tensor:
    """(cwp, R) mask -> (R // RAY_TILE, cwp) OR over each tile's rays."""
    cwp, r = mask_cm.shape
    m = mask_cm.view(cwp, r // RAY_TILE, RAY_TILE)
    w = RAY_TILE
    while w > 1:
        h = w // 2
        m = m[:, :, :h] | m[:, :, h:w]
        w = h
    return m[:, :, 0].T.contiguous()


def topwalk_cm_u_plain(table, ro, rd, t0, active, num_words: int):
    mask_cm = walk_topwalk(table, ro, rd, t0, active, num_words).T.contiguous()
    return mask_cm, tile_unions(mask_cm)


def topwalk_cm_u(table, ro, rd, t0, active, num_words: int):
    """table (Nt, 16) bf16, ro/rd (R, 3) f32 (rd normalized), t0 (R,)
    f32 best distance so far, active (R,) bool; R % RAY_TILE == 0.
    Returns (mask_cm (num_words, R) int32, union_pp (R // RAY_TILE,
    num_words) int32)."""
    r = ro.shape[0]
    nt = table.shape[0]
    if r % RAY_TILE:
        raise ValueError(f"R={r} must be a multiple of {RAY_TILE}")
    if not on_cuda({"table": (table, (nt, ROW), torch.bfloat16),
                    "ro": (ro, (r, 3), torch.float32),
                    "rd": (rd, (r, 3), torch.float32),
                    "t0": (t0, (r,), torch.float32),
                    "active": (active, (r,), torch.bool)}):
        return topwalk_cm_u_plain(table, ro, rd, t0, active, num_words)
    if nt * 2 * ROW + num_words * 4 > SMEM_LIMIT:
        raise ValueError(f"a {nt}-row table does not fit in shared memory "
                         f"(the kernel keeps the whole table there); raise "
                         f"`leaf` in build_onehot")
    mask = torch.empty((num_words, r), dtype=torch.int32, device=ro.device)
    # zeroed: every block ORs its rays' union into its tile's row
    union_pp = torch.zeros((r // RAY_TILE, num_words), dtype=torch.int32,
                           device=ro.device)
    launch("rk_topwalk", table.data_ptr(), nt, ro.data_ptr(), rd.data_ptr(),
           t0.data_ptr(), active.data_ptr(), mask.data_ptr(),
           union_pp.data_ptr(), r, num_words, walk_max_steps(nt))
    topwalk_cm_u.launches += 1
    return mask, union_pp


topwalk_cm_u.launches = 0
