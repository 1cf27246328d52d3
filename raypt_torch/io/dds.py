"""DDS image and cubemap loader (numpy; a copy of `raypt/io/dds.py`):
parses the legacy DDS header and the DX10 extension, walks face-major
mip chains and returns float32 RGBA data. It reads the sunset cubemap
that `scenes.builtin.load_reference_envmap` binds as the environment.

Formats: D3DFMT 116 (A32B32G32R32F, the sunset map) and 113
(A16B16G16R16F); 32-bit RGBA/BGRA uint8; the DX10 DXGI float and unorm
variants of those; BC1/BC2/BC3 (DXT1/3/5) decoded here (`_decode_bc`);
BC4/BC5/BC6H/BC7 decoded by `io.bcn`.
"""
from __future__ import annotations

import struct

import numpy as np

DDS_MAGIC = b"DDS "
DDSCAPS2_CUBEMAP = 0x200
DDPF_FOURCC = 0x4
DDPF_RGB = 0x40

_FOURCC_D3D = {113: ("f2", 4), 116: ("f4", 4)}  # D3DFMT -> (numpy kind, channels)
_FOURCC_BC = {b"DXT1": "bc1", b"DXT3": "bc2", b"DXT5": "bc3"}
_DXGI = {
    2: ("f4", 4),    # R32G32B32A32_FLOAT
    10: ("f2", 4),   # R16G16B16A16_FLOAT
    28: ("u1", 4),   # R8G8B8A8_UNORM
    29: ("u1", 4),   # R8G8B8A8_UNORM_SRGB
    87: ("u1b", 4),  # B8G8R8A8_UNORM
    91: ("u1b", 4),  # B8G8R8A8_UNORM_SRGB
}
_DXGI_BC = {71: "bc1", 72: "bc1", 74: "bc2", 75: "bc2", 77: "bc3",
            78: "bc3", 80: "bc4", 81: "bc4s", 83: "bc5", 84: "bc5s",
            95: "bc6h", 96: "bc6hs", 98: "bc7", 99: "bc7"}
_FOURCC_BC45 = {b"ATI1": "bc4", b"BC4U": "bc4", b"BC4S": "bc4s",
                b"ATI2": "bc5", b"BC5U": "bc5", b"BC5S": "bc5s"}


def _decode_bc_colors(c0: np.ndarray, c1: np.ndarray, idx: np.ndarray,
                      opaque_only: bool):
    """Shared BC color-endpoint decode. c0/c1 (N,) uint16 RGB565,
    idx (N, 16) 2-bit selectors -> (N, 16, 4) float RGBA."""
    def rgb565(c):
        r = ((c >> 11) & 0x1F).astype(np.float32) / 31.0
        g = ((c >> 5) & 0x3F).astype(np.float32) / 63.0
        b = (c & 0x1F).astype(np.float32) / 31.0
        return np.stack([r, g, b], -1)

    p0 = rgb565(c0)
    p1 = rgb565(c1)
    four = opaque_only | (c0 > c1)          # 4-color mode
    p2 = np.where(four[:, None], (2 * p0 + p1) / 3, (p0 + p1) / 2)
    p3 = np.where(four[:, None], (p0 + 2 * p1) / 3, 0.0)
    palette = np.stack([p0, p1, p2, p3], axis=1)        # (N, 4, 3)
    rgb = np.take_along_axis(palette[:, :, None, :],
                             idx[:, None, :, None].astype(np.int64),
                             axis=1)[:, 0]              # (N, 16, 3)
    a3 = np.where(four[:, None] | (idx != 3), 1.0, 0.0)  # BC1 1-bit alpha
    return np.concatenate([rgb, a3[..., None]], -1)


def _decode_bc(data: bytes, w: int, h: int, kind: str) -> np.ndarray:
    """Software decode of BC blocks -> (h, w, 4) float32. Behavioural
    replacement for the reference's hardware decode of BC formats
    (utils/CUDATexture.cpp:30-66). BC1-3 decode inline; BC4-7 dispatch
    to io.bcn (padded to RGBA for a uniform return shape)."""
    if kind not in ("bc1", "bc2", "bc3"):
        from .bcn import decode_bc4, decode_bc5, decode_bc6h, decode_bc7
        if kind.startswith("bc4"):
            img = decode_bc4(data, w, h, signed=kind.endswith("s"))
        elif kind.startswith("bc5"):
            img = decode_bc5(data, w, h, signed=kind.endswith("s"))
        elif kind.startswith("bc6h"):
            img = decode_bc6h(data, w, h, signed=kind.endswith("s"))
        else:
            return decode_bc7(data, w, h)
        out = np.zeros(img.shape[:2] + (4,), np.float32)
        out[..., 3] = 1.0
        out[..., :img.shape[-1]] = img
        return out
    bw, bh = -(-w // 4), -(-h // 4)
    n = bw * bh
    blk = 8 if kind == "bc1" else 16
    raw = np.frombuffer(data[: n * blk], np.uint8).reshape(n, blk)
    coff = 0 if kind == "bc1" else 8
    c0 = raw[:, coff:coff + 2].view("<u2")[:, 0]
    c1 = raw[:, coff + 2:coff + 4].view("<u2")[:, 0]
    bits = raw[:, coff + 4:coff + 8].view("<u4")[:, 0]
    sel = ((bits[:, None] >> (2 * np.arange(16, dtype=np.uint32)[None, :]))
           & 3).astype(np.uint8)
    px = _decode_bc_colors(c0, c1, sel, opaque_only=(kind != "bc1"))

    if kind == "bc2":  # explicit 4-bit alpha
        a16 = raw[:, 0:8].view("<u8")[:, 0]
        av = ((a16[:, None] >> (4 * np.arange(16, dtype=np.uint64)[None, :]))
              & 0xF).astype(np.float32) / 15.0
        px[..., 3] = av
    elif kind == "bc3":  # interpolated alpha
        a0 = raw[:, 0].astype(np.float32) / 255.0
        a1 = raw[:, 1].astype(np.float32) / 255.0
        abits = np.zeros(n, np.uint64)
        for k in range(6):
            abits |= raw[:, 2 + k].astype(np.uint64) << np.uint64(8 * k)
        ai = ((abits[:, None] >> (3 * np.arange(16, dtype=np.uint64)[None, :]))
              & 7).astype(np.int64)
        pal = np.zeros((n, 8), np.float32)
        pal[:, 0] = a0
        pal[:, 1] = a1
        eight = a0 > a1
        for k in range(6):
            pal[:, 2 + k] = np.where(
                eight, ((6 - k) * a0 + (1 + k) * a1) / 7,
                0.0)
        for k in range(4):
            pal[:, 2 + k] = np.where(eight, pal[:, 2 + k],
                                     ((4 - k) * a0 + (1 + k) * a1) / 5)
        pal[:, 6] = np.where(eight, pal[:, 6], 0.0)
        pal[:, 7] = np.where(eight, pal[:, 7], 1.0)
        px[..., 3] = np.take_along_axis(pal, ai, axis=1)

    img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, 4)[:h, :w])


class DDSError(ValueError):
    pass


# DXGI formats whose texture objects the reference creates with
# cudaReadModeSRGB semantics (CUDATexture.cpp:137 sets sRGB on the
# texture description; these are the *_UNORM_SRGB ids from its
# format table, CUDATexture.cpp:9-75)
_DXGI_SRGB = {29, 91, 72, 75, 78, 99}


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode, the transform CUDA's cudaReadModeSRGB
    applies in the texture unit (reference: CUDATexture.cpp:137)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def load_dds(path_or_bytes, srgb=None):
    """Load a DDS file -> dict:
      data: float32 array, (6, H, W, 4) for cubemaps else (H, W, 4)
            (mip 0)
      mip_data: list of per-level arrays (same layout, halving sizes) —
            the full stored mip chain, matching the reference's per-mip
            upload (CUDATexture.cpp:112-172)
      is_cube: bool, mips: int, srgb: bool (whether decode was applied)
    uint8 sources are scaled to [0,1]; sRGB decode to linear is applied
    when the format is a *_SRGB DXGI variant (the reference flags those
    textures sRGB, CUDATexture.cpp:137) or when srgb=True is passed;
    srgb=False forces it off."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    if raw[:4] != DDS_MAGIC or len(raw) < 128:
        raise DDSError("not a DDS file")
    hdr = struct.unpack("<31I", raw[4:128])
    size, flags, height, width = hdr[0], hdr[1], hdr[2], hdr[3]
    mips = max(hdr[6], 1)
    pf_flags = hdr[19]
    fourcc = raw[84:88]
    caps2 = hdr[27]
    is_cube = bool(caps2 & DDSCAPS2_CUBEMAP)
    offset = 128

    fmt_srgb = False
    if pf_flags & DDPF_FOURCC and fourcc == b"DX10":
        dxgi, dim, misc, array_size, _ = struct.unpack("<5I", raw[128:148])
        offset = 148
        is_cube = is_cube or bool(misc & 0x4)
        fmt_srgb = dxgi in _DXGI_SRGB
        if dxgi in _DXGI_BC:
            kind, ch = _DXGI_BC[dxgi], 4
        elif dxgi in _DXGI:
            kind, ch = _DXGI[dxgi]
        else:
            raise DDSError(f"unsupported DXGI format {dxgi}")
    elif pf_flags & DDPF_FOURCC:
        if fourcc in _FOURCC_BC:
            kind, ch = _FOURCC_BC[fourcc], 4
        elif fourcc in _FOURCC_BC45:
            kind, ch = _FOURCC_BC45[fourcc], 4
        else:
            code = struct.unpack("<I", fourcc)[0]
            if code not in _FOURCC_D3D:
                raise DDSError(f"unsupported FourCC {fourcc!r}/{code}")
            kind, ch = _FOURCC_D3D[code]
    elif pf_flags & DDPF_RGB:
        bitcount = hdr[21]
        if bitcount != 32:
            raise DDSError(f"unsupported RGB bitcount {bitcount}")
        rmask = hdr[22]
        kind = "u1" if rmask == 0x000000FF else "u1b"
        ch = 4
    else:
        raise DDSError("unsupported pixel format")

    is_bc = kind.startswith("bc")
    bswap = kind == "u1b"
    if is_bc:
        blk = 8 if kind in ("bc1", "bc4", "bc4s") else 16
        npdtype = np.float32

        def mip_bytes(w, h):
            return -(-w // 4) * -(-h // 4) * blk
    else:
        npdtype = {"f4": np.float32, "f2": np.float16,
                   "u1": np.uint8, "u1b": np.uint8}[kind]
        bpp = np.dtype(npdtype).itemsize * ch

        def mip_bytes(w, h):
            return w * h * bpp

    faces = 6 if is_cube else 1
    out = [[] for _ in range(mips)]   # mip-major collection
    for _face in range(faces):
        w, h = width, height
        for m in range(mips):
            nbytes = mip_bytes(w, h)
            buf = raw[offset:offset + nbytes]
            if is_bc:
                img = _decode_bc(buf, w, h, kind)
            else:
                img = np.frombuffer(buf, npdtype).reshape(h, w, ch)
            out[m].append(img)
            offset += nbytes
            w = max(w // 2, 1)
            h = max(h // 2, 1)

    apply_srgb = fmt_srgb if srgb is None else bool(srgb)
    mip_data = []
    for level in out:
        arr = np.stack(level) if is_cube else level[0]
        arr = arr.astype(np.float32)
        if not is_bc and npdtype == np.uint8:
            arr = arr / 255.0
            if bswap:
                arr = arr[..., [2, 1, 0, 3]]
        if apply_srgb:
            arr = np.concatenate(
                [srgb_to_linear(arr[..., :3]), arr[..., 3:]], axis=-1)
        mip_data.append(arr)
    return {"data": mip_data[0], "mip_data": mip_data, "is_cube": is_cube,
            "mips": mips, "srgb": apply_srgb,
            "width": width, "height": height}


def load_env_cubemap(path, with_mips: bool = False):
    """Convenience: DDS -> (6, H, W, 3) float32 RGB cubemap (mip 0),
    matching what the reference binds as environment_cubemap_tex
    (Scene.cpp:40,187). With with_mips=True returns (mip0, chain) where
    chain is the STORED mip pyramid (list of (6, h, w, 3) levels, ready
    for render.envmap.sample_env_lod) — the reference uploads every
    stored level rather than regenerating them (CUDATexture.cpp:112-172)."""
    d = load_dds(path)
    if not d["is_cube"]:
        raise DDSError("expected a cubemap DDS")
    mip0 = np.ascontiguousarray(d["data"][..., :3])
    if not with_mips:
        return mip0
    chain = [np.ascontiguousarray(m[..., :3]) for m in d["mip_data"]]
    return mip0, chain
