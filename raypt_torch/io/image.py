"""PNG export with the stdlib only (a copy of `raypt/io/image.py`'s
`write_png`)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def write_png(path: str, img) -> None:
    """img: (H, W, 3|4) uint8 or float in [0,1] (numpy, or a CPU tensor)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(np.asarray(a, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = a[..., None].repeat(3, axis=-1)
    h, w, c = a.shape
    if c not in (3, 4):
        raise ValueError(f"PNG needs 3 or 4 channels, got {c}")
    color_type = 2 if c == 3 else 6
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
