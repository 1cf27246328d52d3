"""Radiance RGBE (.hdr) panorama loader and writer (numpy; a copy of
`raypt/io/hdr.py`): the HDR equirect environment of the config-4 scene
is written and read back through it.
"""
from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Returns (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    # header ends at blank line; next line is the resolution string
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("malformed HDR header")
    pos += 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res}")
    h, w = int(res[1]), int(res[3])
    pos = eol + 1

    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        # new-style RLE scanline: 0x02 0x02 hi lo
        if (pos + 4 <= len(data) and buf[pos] == 2 and buf[pos + 1] == 2
                and ((int(buf[pos + 2]) << 8) | int(buf[pos + 3])) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = int(buf[pos]); pos += 1
                    if n > 128:  # run
                        rgbe[y, x:x + n - 128, c] = buf[pos]
                        pos += 1
                        x += n - 128
                    else:       # literal
                        rgbe[y, x:x + n, c] = buf[pos:pos + n]
                        pos += n
                        x += n
        else:  # flat scanline
            row = buf[pos:pos + w * 4].reshape(w, 4)
            rgbe[y] = row
            pos += w * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 as flat (non-RLE) RGBE."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    exp[nz] = np.frexp(maxc[nz])[1]
    scale = np.zeros((h, w), np.float32)
    scale[nz] = np.ldexp(1.0, 8 - exp[nz])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
