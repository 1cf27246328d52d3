"""Exposure then ACES filmic, the reference present path
(`raypt/render/tonemap.py`)."""
from __future__ import annotations

import torch

from ..core.math3d import tonemap as _tonemap


def to_display(hdr: torch.Tensor, exposure: float = 0.5) -> torch.Tensor:
    """Linear HDR (H, W, 3) -> display-referred [0, 1] (H, W, 3)."""
    return _tonemap(hdr, exposure)


def to_u8(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8 with rounding."""
    return torch.clamp(img01 * 255.0 + 0.5, 0, 255).to(torch.uint8)
