"""The row gather of `scripts/pallas_gather_test.py` and
`scripts/pallas_gather_test2.py`: out = table[idx], by one CUDA kernel
(`csrc/gather.cu`) for all five of the scripts' kernel bodies.

The bodies (`tab_ref[i]` in pallas_gather_test.py; k_take, k_take_clip,
k_loop and k_tal in pallas_gather_test2.py) differ only in k_take_clip
clamping the index into the table: `clip=True`. Without it the indices
are in range in every probe, and an index outside the table gives a row
of NaN (jnp.take's default fill). On CPU tensors the wrapper runs the
plain version, `gather_rows_plain`.
"""
from __future__ import annotations

import torch

from ..kernels._build import launch, on_cuda


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      clip: bool = False) -> torch.Tensor:
    n = table.shape[0]
    safe = idx.clamp(0, n - 1).long()
    out = table[safe]
    if not clip:
        bad = (idx < 0) | (idx >= n)
        out = torch.where(bad[:, None], torch.full_like(out, float("nan")),
                          out)
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                clip: bool = False) -> torch.Tensor:
    """table (n, w) f32 with w a multiple of 4, idx (R,) int32 -> (R, w)
    f32, row r = table[idx[r]] (clip: the index clamped into the table)."""
    n, w = table.shape
    if w % 4:
        raise ValueError(f"row width {w} must be a multiple of 4")
    specs = {"table": (table, (n, w), torch.float32),
             "idx": (idx, (idx.shape[0],), torch.int32)}
    if not on_cuda(specs):
        return gather_rows_plain(table, idx, clip)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    out = torch.empty((idx.shape[0], w), dtype=torch.float32,
                      device=table.device)
    launch("rk_gather_rows", table.data_ptr(), n, w, idx.data_ptr(),
           out.data_ptr(), idx.shape[0], int(clip))
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
