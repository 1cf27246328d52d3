"""Walk of the encoded cluster top tree, per ray
(`raypt/kernels/onehot_walk.py`), in three forms:
  * `topwalk_cm_u` (`pallas_topwalk_cm_u`): the wanted-cluster bitmask
    word-major plus one OR-union per 2,048-ray walk tile;
  * `topwalk_union` (`pallas_topwalk_union`): only the OR-union of each
    256-ray tile; the per-ray mask never reaches device memory;
  * `topwalk_cm` (`pallas_topwalk_cm`): only the word-major mask, for
    any word count; `topwalk` (`pallas_topwalk`): the same mask
    ray-major, (R, words), written so by the kernel.

On CUDA tensors they launch `csrc/onehot_walk.cu`; on CPU tensors they
run the plain torch version, `accel.ctree.walk_topwalk`, with the tile
unions OR-folded in torch.
"""
from __future__ import annotations

import torch

from ..accel.ctree import ROW, walk_max_steps, walk_topwalk
from ._build import SMEM_LIMIT, launch, on_cuda

RAY_TILE = 2048   # rays per union_pp row (the JAX walk program); the
                  # kernels' kRayTile


UNION_TILE = 256  # rays per topwalk_union row: one CUDA block


def tile_unions(mask_cm: torch.Tensor, tile: int = RAY_TILE) -> torch.Tensor:
    """(cwp, R) mask -> (R // tile, cwp) OR over each tile's rays."""
    cwp, r = mask_cm.shape
    m = mask_cm.view(cwp, r // tile, tile)
    w = tile
    while w > 1:
        h = w // 2
        m = m[:, :, :h] | m[:, :, h:w]
        w = h
    return m[:, :, 0].T.contiguous()


def topwalk_cm_u_plain(table, ro, rd, t0, active, num_words: int):
    mask_cm = walk_topwalk(table, ro, rd, t0, active, num_words).T.contiguous()
    return mask_cm, tile_unions(mask_cm)


def _check_table(table, num_words: int) -> None:
    if table.shape[0] * 2 * ROW + num_words * 4 > SMEM_LIMIT:
        raise ValueError(f"a {table.shape[0]}-row table does not fit in "
                         f"shared memory (the kernel keeps the whole table "
                         f"there); raise `leaf` in build_onehot")


def _walk_specs(table, ro, rd, t0, active) -> dict:
    r = ro.shape[0]
    return {"table": (table, (table.shape[0], ROW), torch.bfloat16),
            "ro": (ro, (r, 3), torch.float32),
            "rd": (rd, (r, 3), torch.float32),
            "t0": (t0, (r,), torch.float32),
            "active": (active, (r,), torch.bool)}


def topwalk_cm_u(table, ro, rd, t0, active, num_words: int):
    """table (Nt, 16) bf16, ro/rd (R, 3) f32 (rd normalized), t0 (R,)
    f32 best distance so far, active (R,) bool; R % RAY_TILE == 0.
    Returns (mask_cm (num_words, R) int32, union_pp (R // RAY_TILE,
    num_words) int32)."""
    r = ro.shape[0]
    nt = table.shape[0]
    if r % RAY_TILE:
        raise ValueError(f"R={r} must be a multiple of {RAY_TILE}")
    if not on_cuda(_walk_specs(table, ro, rd, t0, active)):
        return topwalk_cm_u_plain(table, ro, rd, t0, active, num_words)
    # beside the table and the union words, the block's packed rays and
    # its scan's 33 words
    _check_table(table, num_words + UNION_TILE + 33)
    # every word of every ray is stored by the kernel, zero or not
    mask = torch.empty((num_words, r), dtype=torch.int32, device=ro.device)
    # zeroed: every block with a live ray ORs its union into its tile's row
    union_pp = torch.zeros((r // RAY_TILE, num_words), dtype=torch.int32,
                           device=ro.device)
    launch("rk_topwalk", table.data_ptr(), nt, ro.data_ptr(), rd.data_ptr(),
           t0.data_ptr(), active.data_ptr(), mask.data_ptr(),
           union_pp.data_ptr(), r, num_words, walk_max_steps(nt))
    topwalk_cm_u.launches += 1
    return mask, union_pp


topwalk_cm_u.launches = 0


def topwalk_union_plain(table, ro, rd, t0, active, num_words: int):
    mask = walk_topwalk(table, ro, rd, t0, active, num_words)
    return tile_unions(mask.T.contiguous(), UNION_TILE)


def topwalk_union(table, ro, rd, t0, active, num_words: int):
    """The walk of topwalk_cm_u with the wanted-cluster bits OR-folded
    over each UNION_TILE-ray tile (one tile per 256-thread block):
    returns (R // UNION_TILE, num_words) int32; R % UNION_TILE == 0."""
    r = ro.shape[0]
    nt = table.shape[0]
    if r % UNION_TILE:
        raise ValueError(f"R={r} must be a multiple of {UNION_TILE}")
    if not on_cuda(_walk_specs(table, ro, rd, t0, active)):
        return topwalk_union_plain(table, ro, rd, t0, active, num_words)
    # beside the table and the union words, the block's packed rays and
    # its scan's 33 words
    _check_table(table, num_words + UNION_TILE + 33)
    # every word of every tile is stored by the kernel, zero or not
    union = torch.empty((r // UNION_TILE, num_words), dtype=torch.int32,
                        device=ro.device)
    launch("rk_topwalk_union", table.data_ptr(), nt, ro.data_ptr(),
           rd.data_ptr(), t0.data_ptr(), active.data_ptr(), union.data_ptr(),
           r, num_words, walk_max_steps(nt))
    topwalk_union.launches += 1
    return union


topwalk_union.launches = 0


def topwalk_cm_plain(table, ro, rd, t0, active, num_words: int):
    return walk_topwalk(table, ro, rd, t0, active, num_words).T.contiguous()


def topwalk_cm(table, ro, rd, t0, active, num_words: int):
    """The walk's per-ray wanted-cluster bits only: returns (num_words, R)
    int32, word-major; num_words need not be a multiple of 8, and bits of
    clusters past num_words * 32 are dropped. R % UNION_TILE == 0 (one
    256-thread block per 256 rays)."""
    r = ro.shape[0]
    nt = table.shape[0]
    if r % UNION_TILE:
        raise ValueError(f"R={r} must be a multiple of {UNION_TILE}")
    if not on_cuda(_walk_specs(table, ro, rd, t0, active)):
        return topwalk_cm_plain(table, ro, rd, t0, active, num_words)
    # beside the table, the block's packed rays and its scan's 33 words
    _check_table(table, UNION_TILE + 33)
    # every word of every ray is stored by the kernel, zero or not
    mask = torch.empty((num_words, r), dtype=torch.int32, device=ro.device)
    launch("rk_topwalk_mask", table.data_ptr(), nt, ro.data_ptr(),
           rd.data_ptr(), t0.data_ptr(), active.data_ptr(), mask.data_ptr(),
           r, num_words, walk_max_steps(nt))
    topwalk_cm.launches += 1
    return mask


topwalk_cm.launches = 0


def topwalk(table, ro, rd, t0, active, num_words: int):
    """The walk's per-ray wanted-cluster bits ray-major: (R, num_words)
    int32, contiguous (`pallas_topwalk`'s layout; the mask-only kernel's
    row mode on CUDA tensors, each ray's words stored by the thread that
    walks it). R % UNION_TILE == 0. Its plain version is
    `accel.ctree.walk_topwalk`."""
    r = ro.shape[0]
    nt = table.shape[0]
    if r % UNION_TILE:
        raise ValueError(f"R={r} must be a multiple of {UNION_TILE}")
    if not on_cuda(_walk_specs(table, ro, rd, t0, active)):
        return walk_topwalk(table, ro, rd, t0, active, num_words)
    # beside the table, the block's packed rays and its scan's 33 words
    _check_table(table, UNION_TILE + 33)
    # every word of every ray is stored by the kernel, zero or not
    mask = torch.empty((r, num_words), dtype=torch.int32, device=ro.device)
    launch("rk_topwalk_mask_rows", table.data_ptr(), nt, ro.data_ptr(),
           rd.data_ptr(), t0.data_ptr(), active.data_ptr(), mask.data_ptr(),
           r, num_words, walk_max_steps(nt))
    topwalk.launches += 1
    return mask


topwalk.launches = 0
