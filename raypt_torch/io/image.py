"""Framebuffer export, PNG / PPM / NPY (a copy of `raypt/io/image.py`):
the same bytes as the JAX package's writers. PNG is written with the
stdlib only (zlib deflate and chunk CRCs)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def write_png(path: str, img) -> None:
    """img: (H, W, 3|4) uint8 or float in [0,1] (numpy, or a CPU tensor)."""
    a = _to_u8(img)
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


def _to_u8(img) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(np.asarray(a, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return a


def write_ppm(path: str, img) -> None:
    """Binary P6 PPM of (H, W, 3+) uint8 or float in [0, 1] (the first
    three channels)."""
    a = _to_u8(img)
    h, w = a.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(a[..., :3].tobytes())


def read_ppm(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a binary P6 PPM."""
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(maxsplit=4)
    if len(parts) < 5 or parts[0] != b"P6":
        raise ValueError(f"{path}: not a binary P6 PPM")
    w, h = int(parts[1]), int(parts[2])
    return np.frombuffer(parts[4][: w * h * 3], np.uint8).reshape(h, w, 3)


def write_npy(path: str, img) -> None:
    """np.save of the image (a numpy array or a CPU tensor)."""
    np.save(path, np.asarray(img))
