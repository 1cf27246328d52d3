"""Software decode of BC4/BC5/BC6H/BC7 block-compressed textures
(numpy; a copy of `raypt/io/bcn.py`). BC1-3 live in `io.dds`; this
module covers the rest:

  * BC4 (single channel) / BC5 (two channel): the BC3 alpha-block
    interpolation applied to R (and G).
  * BC6H: HDR half-float RGB, 14 modes, delta-compressed endpoints,
    2-subset partitions (D3D11 functional spec 19.5).
  * BC7: LDR RGBA, 8 modes, up to 3 subsets, p-bits, rotations
    (D3D11 functional spec 19.6).

All decoders are numpy-vectorized over blocks (per-mode grouping for
BC6H/BC7). tests/test_torch_io.py holds them bitwise against the JAX
package's on random block data.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# bit plumbing: a block is a little-endian 128-bit integer held as
# (lo, hi) uint64 pairs; take_bits reads [pos, pos+n) vectorized over
# blocks with per-block positions allowed.
# ---------------------------------------------------------------------------


def _block_ints(data: bytes, nblocks: int, blk: int):
    raw = np.frombuffer(data[: nblocks * blk], np.uint8).reshape(nblocks, blk)
    if blk == 8:
        lo = raw.view("<u8")[:, 0]
        hi = np.zeros_like(lo)
    else:
        u = raw.view("<u8")
        lo, hi = u[:, 0], u[:, 1]
    return lo.astype(np.uint64), hi.astype(np.uint64)


def _take_bits(lo: np.ndarray, hi: np.ndarray, pos, n) -> np.ndarray:
    """(block >> pos) & ((1 << n) - 1), for 0 <= pos, pos + n <= 128 and
    n <= 32. pos/n may be scalars or arrays broadcastable to lo."""
    pos = np.asarray(pos, np.uint64)
    n = np.asarray(n, np.uint64)
    one = np.uint64(1)
    sixty4 = np.uint64(64)
    p_lo = np.minimum(pos, np.uint64(63))
    from_lo = np.where(pos < sixty4, lo >> p_lo, np.uint64(0))
    # bits of hi that slide down into the low word (pos in (0, 64))
    sh_up = np.minimum(sixty4 - p_lo, np.uint64(63))
    hi_spill = np.where((pos > 0) & (pos < sixty4),
                        hi << sh_up, np.uint64(0))
    p_hi = np.minimum(np.maximum(pos, sixty4) - sixty4, np.uint64(63))
    from_hi = np.where(pos >= sixty4, hi >> p_hi, np.uint64(0))
    val = from_lo | hi_spill | from_hi
    mask = np.where(n >= sixty4, ~np.uint64(0), (one << n) - one)
    return (val & mask).astype(np.uint32)


# ---------------------------------------------------------------------------
# BC4 / BC5
# ---------------------------------------------------------------------------


def _decode_alpha_block(raw8: np.ndarray, signed: bool) -> np.ndarray:
    """(N, 8) uint8 BC3-alpha-style blocks -> (N, 16) float in [0,1]
    (unorm) or [-1,1] (snorm)."""
    n = raw8.shape[0]
    if signed:
        a0i = raw8[:, 0].view(np.int8).astype(np.float32)
        a1i = raw8[:, 1].view(np.int8).astype(np.float32)
        a0 = np.maximum(a0i, -127.0) / 127.0
        a1 = np.maximum(a1i, -127.0) / 127.0
        lo_v, hi_v = -1.0, 1.0
        eight = a0i > a1i
    else:
        a0 = raw8[:, 0].astype(np.float32) / 255.0
        a1 = raw8[:, 1].astype(np.float32) / 255.0
        lo_v, hi_v = 0.0, 1.0
        eight = raw8[:, 0] > raw8[:, 1]
    bits = np.zeros(n, np.uint64)
    for k in range(6):
        bits |= raw8[:, 2 + k].astype(np.uint64) << np.uint64(8 * k)
    sel = ((bits[:, None] >> (3 * np.arange(16, dtype=np.uint64)[None, :]))
           & np.uint64(7)).astype(np.int64)
    pal = np.zeros((n, 8), np.float32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    for k in range(6):
        pal[:, 2 + k] = np.where(eight,
                                 ((6 - k) * a0 + (1 + k) * a1) / 7.0,
                                 0.0)
    for k in range(4):
        pal[:, 2 + k] = np.where(eight, pal[:, 2 + k],
                                 ((4 - k) * a0 + (1 + k) * a1) / 5.0)
    pal[:, 6] = np.where(eight, pal[:, 6], lo_v)
    pal[:, 7] = np.where(eight, pal[:, 7], hi_v)
    return np.take_along_axis(pal, sel, axis=1)


def _blocks_to_image(px: np.ndarray, w: int, h: int) -> np.ndarray:
    """(N, 16, C) block pixels -> (h, w, C)."""
    bw, bh = -(-w // 4), -(-h // 4)
    c = px.shape[-1]
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, c)[:h, :w])


def decode_bc4(data: bytes, w: int, h: int, signed: bool = False):
    """BC4 -> (h, w, 1) float32 (R channel)."""
    bw, bh = -(-w // 4), -(-h // 4)
    raw = np.frombuffer(data[: bw * bh * 8], np.uint8).reshape(-1, 8)
    r = _decode_alpha_block(raw, signed)
    return _blocks_to_image(r[..., None].astype(np.float32), w, h)


def decode_bc5(data: bytes, w: int, h: int, signed: bool = False):
    """BC5 -> (h, w, 2) float32 (RG channels)."""
    bw, bh = -(-w // 4), -(-h // 4)
    raw = np.frombuffer(data[: bw * bh * 16], np.uint8).reshape(-1, 16)
    r = _decode_alpha_block(np.ascontiguousarray(raw[:, :8]), signed)
    g = _decode_alpha_block(np.ascontiguousarray(raw[:, 8:]), signed)
    return _blocks_to_image(
        np.stack([r, g], axis=-1).astype(np.float32), w, h)


# ---------------------------------------------------------------------------
# shared BC6H/BC7 tables (D3D11 functional spec constants)
# ---------------------------------------------------------------------------

# 2-subset partition patterns, bit i = subset of pixel i (64 entries;
# BC6H uses the first 32)
_PART2_BITS = np.array([
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22,
], np.uint32)
_PART2 = ((_PART2_BITS[:, None] >> np.arange(16)[None, :]) & 1).astype(
    np.int32)                                            # (64, 16) in {0,1}

# 3-subset partition patterns (64 x 16, values 0..2)
_PART3 = np.array([
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 1, 2, 2, 2, 2],
    [0, 0, 0, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 2, 0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1],
    [0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2],
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 2, 2],
    [0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2],
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2],
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2],
    [0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2],
    [0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2],
    [0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2, 1, 2, 2, 2],
    [0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0, 2, 2, 2, 0],
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2],
    [0, 1, 1, 1, 0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0],
    [0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2],
    [0, 0, 2, 2, 0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1],
    [0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 2, 2, 2],
    [0, 0, 0, 1, 0, 0, 0, 1, 2, 2, 2, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2],
    [0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 1, 0, 2, 2, 1, 0],
    [0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1, 0, 0, 0, 0],
    [0, 0, 1, 2, 0, 0, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2],
    [0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1, 0, 1, 1, 0],
    [0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1],
    [0, 0, 2, 2, 1, 1, 0, 2, 1, 1, 0, 2, 0, 0, 2, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 2, 0, 0, 2, 2, 2, 2, 2],
    [0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1],
    [0, 0, 0, 0, 2, 0, 0, 0, 2, 2, 1, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 2, 2, 2],
    [0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 2, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 2, 2, 2],
    [0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0],
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0],
    [0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0],
    [0, 1, 2, 0, 2, 0, 1, 2, 1, 2, 0, 1, 0, 1, 2, 0],
    [0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2, 0, 0, 1, 1],
    [0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0, 1, 1],
    [0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1],
    [0, 0, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2, 1, 1, 2, 2],
    [0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1],
    [0, 2, 2, 0, 1, 2, 2, 1, 0, 2, 2, 0, 1, 2, 2, 1],
    [0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 0, 1],
    [0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1],
    [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2],
    [0, 2, 2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1],
    [0, 0, 0, 2, 1, 1, 1, 2, 0, 0, 0, 2, 1, 1, 1, 2],
    [0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2],
    [0, 2, 2, 2, 0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2],
    [0, 0, 0, 2, 1, 1, 1, 2, 1, 1, 1, 2, 0, 0, 0, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2],
    [0, 0, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2],
    [0, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1],
    [0, 2, 2, 2, 1, 2, 2, 2, 0, 2, 2, 2, 1, 2, 2, 2],
    [0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 1, 1, 1, 2, 0, 1, 1, 2, 2, 0, 1, 2, 2, 2, 0],
], np.int32)

# anchor (fix-up) index tables: index of the pixel whose index field
# drops its MSB, per partition id
_ANCHOR2 = np.array([       # second subset of 2-subset partitions
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15,  2,  8,  2,  2,  8,  8, 15,  2,  8,  2,  2,  8,  8,  2,  2,
    15, 15,  6,  8,  2,  8, 15, 15,  2,  8,  2,  2,  2, 15, 15,  6,
    6,  2,  6,  8, 15, 15,  2,  2, 15, 15, 15, 15, 15,  2,  2, 15,
], np.int32)
_ANCHOR3_2 = np.array([     # second subset of 3-subset partitions
    3,  3, 15, 15,  8,  3, 15, 15,  8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8, 15,  3,  3,  6, 10,  5,  8,  8,  6,  8,  5, 15, 15,
    8, 15,  3,  5,  6, 10,  8, 15, 15,  3, 15,  5, 15, 15, 15, 15,
    3, 15,  5,  5,  5,  8,  5, 10,  5, 10,  8, 13, 15, 12,  3,  3,
], np.int32)
_ANCHOR3_3 = np.array([     # third subset of 3-subset partitions
    15,  8,  8,  3, 15, 15,  3,  8, 15, 15, 15, 15, 15, 15, 15,  8,
    15,  8, 15,  3, 15,  8, 15,  8,  3, 15,  6, 10, 15, 15, 10,  8,
    15,  3, 15, 10, 10,  8,  9, 10,  6, 15,  8, 15,  3,  6,  6,  8,
    15,  3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,  3, 15, 15,  8,
], np.int32)

_WEIGHT2 = np.array([0, 21, 43, 64], np.int64)
_WEIGHT3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int64)
_WEIGHT4 = np.array([0, 4, 9, 13, 17, 21, 26, 30,
                     34, 38, 43, 47, 51, 55, 60, 64], np.int64)
_WEIGHTS = {2: _WEIGHT2, 3: _WEIGHT3, 4: _WEIGHT4}


# ---------------------------------------------------------------------------
# BC7
# ---------------------------------------------------------------------------

# per-mode: (subsets, partition_bits, rotation_bits, idx_sel_bits,
#            color_bits, alpha_bits, endpoint_pbits, shared_pbits,
#            index_bits, index2_bits)
_BC7_MODES = [
    (3, 4, 0, 0, 4, 0, 1, 0, 3, 0),   # mode 0
    (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),   # mode 1
    (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),   # mode 2
    (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),   # mode 3
    (1, 0, 2, 1, 5, 6, 0, 0, 2, 3),   # mode 4
    (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),   # mode 5
    (1, 0, 0, 0, 7, 7, 1, 0, 4, 0),   # mode 6
    (2, 6, 0, 0, 5, 5, 1, 0, 2, 0),   # mode 7
]


def _expand_to_8(v: np.ndarray, bits: int) -> np.ndarray:
    """Left-align a `bits`-wide endpoint into 8 bits and replicate the
    top bits into the bottom (spec endpoint dequantization)."""
    x = (v << (8 - bits)) & 0xFF
    return x | (x >> bits)


def _bc7_subset_of(part_id: np.ndarray, nsub: int) -> np.ndarray:
    """(N,) partition ids -> (N, 16) subset index per pixel."""
    if nsub == 1:
        return np.zeros((part_id.shape[0], 16), np.int32)
    if nsub == 2:
        return _PART2[part_id]
    return _PART3[part_id]


def _bc7_anchors(part_id: np.ndarray, nsub: int) -> np.ndarray:
    """(N, 16) bool: True where the pixel is an anchor (index field is
    one bit short)."""
    n = part_id.shape[0]
    anchors = np.zeros((n, 16), bool)
    anchors[:, 0] = True
    if nsub >= 2:
        a2 = _ANCHOR3_2[part_id] if nsub == 3 else _ANCHOR2[part_id]
        anchors[np.arange(n), a2] = True
    if nsub == 3:
        anchors[np.arange(n), _ANCHOR3_3[part_id]] = True
    return anchors


def _read_indices(lo, hi, start_pos, width, anchors):
    """Read 16 per-pixel indices starting at block bit `start_pos`
    (scalar), `width` bits each except anchors (width-1). Returns
    (N, 16) int. MSB of anchor indices is implicitly 0."""
    n = lo.shape[0]
    widths = np.full((n, 16), width, np.int64)
    widths[anchors] = width - 1
    offs = np.zeros((n, 16), np.int64)
    offs[:, 1:] = np.cumsum(widths[:, :-1], axis=1)
    pos = start_pos + offs
    return _take_bits(lo[:, None], hi[:, None], pos, widths).astype(np.int64)


def decode_bc7(data: bytes, w: int, h: int) -> np.ndarray:
    """BC7 -> (h, w, 4) float32 RGBA in [0, 1]."""
    bw, bh = -(-w // 4), -(-h // 4)
    n = bw * bh
    lo, hi = _block_ints(data, n, 16)
    out = np.zeros((n, 16, 4), np.float32)

    first_byte = (lo & np.uint64(0xFF)).astype(np.uint32)
    # mode = index of lowest set bit of the first byte; 8 -> invalid
    mode_of = np.full(n, 8, np.int32)
    for m in range(7, -1, -1):
        mode_of[(first_byte & ((1 << (m + 1)) - 1)) == (1 << m)] = m

    for mode in range(8):
        sel = np.nonzero(mode_of == mode)[0]
        if sel.size == 0:
            continue
        (nsub, pb, rb, isb, cb, ab, epb, spb, ib, ib2) = _BC7_MODES[mode]
        blo, bhi = lo[sel], hi[sel]
        pos = mode + 1

        part = (_take_bits(blo, bhi, pos, pb).astype(np.int64)
                if pb else np.zeros(sel.size, np.int64))
        pos += pb
        rot = (_take_bits(blo, bhi, pos, rb).astype(np.int64)
               if rb else np.zeros(sel.size, np.int64))
        pos += rb
        idx_sel = (_take_bits(blo, bhi, pos, isb).astype(np.int64)
                   if isb else np.zeros(sel.size, np.int64))
        pos += isb

        ne = 2 * nsub                                    # endpoints
        # color channels then alpha, channel-major, endpoint-minor
        eps = np.zeros((sel.size, ne, 4), np.int64)
        for c in range(3):
            for e in range(ne):
                eps[:, e, c] = _take_bits(blo, bhi, pos, cb)
                pos += cb
        if ab:
            for e in range(ne):
                eps[:, e, 3] = _take_bits(blo, bhi, pos, ab)
                pos += ab
        # p-bits (endpoint-wise or subset-shared) append as LSB
        cbits, abits = cb, ab
        if epb:
            for e in range(ne):
                p = _take_bits(blo, bhi, pos, 1).astype(np.int64)
                pos += 1
                eps[:, e, :3] = (eps[:, e, :3] << 1) | p[:, None]
                if ab:
                    eps[:, e, 3] = (eps[:, e, 3] << 1) | p
            cbits += 1
            abits += 1 if ab else 0
        elif spb:
            for s in range(nsub):
                p = _take_bits(blo, bhi, pos, 1).astype(np.int64)
                pos += 1
                for e in (2 * s, 2 * s + 1):
                    eps[:, e, :3] = (eps[:, e, :3] << 1) | p[:, None]
            cbits += 1

        rgba = np.zeros((sel.size, ne, 4), np.int64)
        rgba[..., :3] = _expand_to_8(eps[..., :3], cbits)
        rgba[..., 3] = _expand_to_8(eps[..., 3], abits) if ab else 255

        subset = _bc7_subset_of(part, nsub)
        anchors = _bc7_anchors(part, nsub)
        idx1 = _read_indices(blo, bhi, pos, ib, anchors)
        pos += 16 * ib - nsub
        if ib2:
            idx2 = _read_indices(blo, bhi, pos, ib2, anchors)
        else:
            idx2 = idx1

        cidx, aidx, cw, aw = idx1, idx2, ib, ib2 or ib
        if isb:   # mode 4 index swap
            swap = idx_sel.astype(bool)
            cidx = np.where(swap[:, None], idx2, idx1)
            aidx = np.where(swap[:, None], idx1, idx2)
            cw_arr = np.where(swap, ib2, ib)
            aw_arr = np.where(swap, ib, ib2)
        else:
            cw_arr = np.full(sel.size, cw)
            aw_arr = np.full(sel.size, aw)

        e0 = np.take_along_axis(rgba, (2 * subset)[..., None], axis=1)
        e1 = np.take_along_axis(rgba, (2 * subset + 1)[..., None], axis=1)
        px = np.zeros((sel.size, 16, 4), np.int64)
        for width in np.unique(np.concatenate([cw_arr, aw_arr])):
            wt = _WEIGHTS[int(width)]
            wc = np.where(cw_arr[:, None] == width,
                          wt[np.minimum(cidx, len(wt) - 1)], 0)
            wa = np.where(aw_arr[:, None] == width,
                          wt[np.minimum(aidx, len(wt) - 1)], 0)
            px[..., :3] += np.where(
                (cw_arr[:, None, None] == width),
                ((64 - wc)[..., None] * e0[..., :3]
                 + wc[..., None] * e1[..., :3] + 32) >> 6, 0)
            px[..., 3] += np.where(
                (aw_arr[:, None] == width),
                ((64 - wa) * e0[..., 3] + wa * e1[..., 3] + 32) >> 6, 0)

        # rotation: swap alpha with a color channel (modes 4/5)
        if rb:
            for r, ch in ((1, 0), (2, 1), (3, 2)):
                m_ = rot == r
                tmp = px[m_][..., ch].copy()
                px[m_, :, ch] = px[m_][..., 3]
                px[m_, :, 3] = tmp
        out[sel] = px.astype(np.float32) / 255.0

    return _blocks_to_image(out, w, h)


# ---------------------------------------------------------------------------
# BC6H
# ---------------------------------------------------------------------------

# field layouts, D3D11 functional spec 19.5.2. Each mode: (mode_value,
# mode_len, endpoint_bits, (delta_r, delta_g, delta_b) or None,
# fields) where fields is the bit-serial layout after the mode bits:
# a list of (name, hi, lo) meaning destination bits hi..lo (inclusive,
# MSB-first in the tuple, stored LSB-of-tuple-first in the stream when
# hi < lo). Names: rw gw bw rx gx bx ry gy by rz gz bz d.
def _f(spec: str):
    """Parse 'gy4,rw9:0,...' into (name, hi, lo) triples."""
    ops = []
    for part in spec.split(","):
        name = part[:2]
        rng = part[2:]
        if ":" in rng:
            a, b = rng.split(":")
            ops.append((name, int(a), int(b)))
        else:
            ops.append((name, int(rng), int(rng)))
    return ops


_BC6_MODES = [
    # (mode value, mode bit length, W bits, deltas (r,g,b) or None, layout)
    (0x00, 2, 10, (5, 5, 5), _f(
        "gy4,by4,bz4,rw9:0,gw9:0,bw9:0,rx4:0,gz4,gy3:0,gx4:0,bz0,gz3:0,"
        "bx4:0,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,dd4:0")),
    (0x01, 2, 7, (6, 6, 6), _f(
        "gy5,gz4,gz5,rw6:0,bz0,bz1,by4,gw6:0,by5,bz2,gy4,bw6:0,bz3,bz5,"
        "bz4,rx5:0,gy3:0,gx5:0,gz3:0,bx5:0,by3:0,ry5:0,rz5:0,dd4:0")),
    (0x02, 5, 11, (5, 4, 4), _f(
        "rw9:0,gw9:0,bw9:0,rx4:0,rw10,gy3:0,gx3:0,gw10,bz0,gz3:0,bx3:0,"
        "bw10,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,dd4:0")),
    (0x06, 5, 11, (4, 5, 4), _f(
        "rw9:0,gw9:0,bw9:0,rx3:0,rw10,gz4,gy3:0,gx4:0,gw10,gz3:0,bx3:0,"
        "bw10,bz1,by3:0,ry3:0,bz0,bz2,rz3:0,gy4,bz3,dd4:0")),
    (0x0A, 5, 11, (4, 4, 5), _f(
        "rw9:0,gw9:0,bw9:0,rx3:0,rw10,by4,gy3:0,gx3:0,gw10,bz0,gz3:0,"
        "bx4:0,bw10,by3:0,ry3:0,bz1,bz2,rz3:0,bz4,bz3,dd4:0")),
    (0x0E, 5, 9, (5, 5, 5), _f(
        "rw8:0,by4,gw8:0,gy4,bw8:0,bz4,rx4:0,gz4,gy3:0,gx4:0,bz0,gz3:0,"
        "bx4:0,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,dd4:0")),
    (0x12, 5, 8, (6, 5, 5), _f(
        "rw7:0,gz4,by4,gw7:0,bz2,gy4,bw7:0,bz3,bz4,rx5:0,gy3:0,gx4:0,"
        "bz0,gz3:0,bx4:0,bz1,by3:0,ry5:0,rz5:0,dd4:0")),
    (0x16, 5, 8, (5, 6, 5), _f(
        "rw7:0,bz0,by4,gw7:0,gy5,gy4,bw7:0,gz5,bz4,rx4:0,gz4,gy3:0,"
        "gx5:0,gz3:0,bx4:0,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,dd4:0")),
    (0x1A, 5, 8, (5, 5, 6), _f(
        "rw7:0,bz1,by4,gw7:0,by5,gy4,bw7:0,bz5,bz4,rx4:0,gz4,gy3:0,"
        "gx4:0,bz0,gz3:0,bx5:0,by3:0,ry4:0,bz2,rz4:0,bz3,dd4:0")),
    (0x1E, 5, 6, None, _f(
        "rw5:0,gz4,bz0,bz1,by4,gw5:0,gy5,by5,bz2,gy4,bw5:0,gz5,bz3,bz5,"
        "bz4,rx5:0,gy3:0,gx5:0,gz3:0,bx5:0,by3:0,ry5:0,rz5:0,dd4:0")),
    (0x03, 5, 10, None, _f(
        "rw9:0,gw9:0,bw9:0,rx9:0,gx9:0,bx9:0")),
    (0x07, 5, 11, (9, 9, 9), _f(
        "rw9:0,gw9:0,bw9:0,rx8:0,rw10,gx8:0,gw10,bx8:0,bw10")),
    (0x0B, 5, 12, (8, 8, 8), _f(   # extra W MSBs stored MSB-first
        "rw9:0,gw9:0,bw9:0,rx7:0,rw11,rw10,gx7:0,gw11,gw10,bx7:0,bw11,"
        "bw10")),
    (0x0F, 5, 16, (4, 4, 4), _f(   # extra W MSBs stored MSB-first
        "rw9:0,gw9:0,bw9:0,rx3:0,rw15,rw14,rw13,rw12,rw11,rw10,gx3:0,"
        "gw15,gw14,gw13,gw12,gw11,gw10,bx3:0,bw15,bw14,bw13,bw12,bw11,"
        "bw10")),
]
_BC6_FIELD_IDX = {name: i for i, name in enumerate(
    ["rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by",
     "rz", "gz", "bz", "dd"])}


def _bc6_unquantize(x: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    """Endpoint -> 17-bit interpolation space (int32 in/out)."""
    if signed:
        if bits >= 16:
            return x
        s = x < 0
        ax = np.abs(x)
        q = np.where(ax == 0, 0,
                     np.where(ax >= ((1 << (bits - 1)) - 1), 0x7FFF,
                              ((ax << 15) + 0x4000) >> (bits - 1)))
        return np.where(s, -q, q)
    if bits >= 15:
        return x
    return np.where(x == 0, 0,
                    np.where(x == (1 << bits) - 1, 0xFFFF,
                             ((x << 15) + 0x4000) >> (bits - 1)))


def _bc6_finish(q: np.ndarray, signed: bool) -> np.ndarray:
    """Interpolated value -> half-float bit pattern (uint16)."""
    if signed:
        s = q < 0
        v = (np.abs(q) * 31) >> 5
        return (np.where(s, v | 0x8000, v)).astype(np.uint16)
    return ((q * 31) >> 6).astype(np.uint16)


def _sign_extend(v: np.ndarray, bits: int) -> np.ndarray:
    m = 1 << (bits - 1)
    return ((v ^ m) - m).astype(np.int64)


def decode_bc6h(data: bytes, w: int, h: int,
                signed: bool = False) -> np.ndarray:
    """BC6H -> (h, w, 3) float32 HDR RGB."""
    bw_, bh_ = -(-w // 4), -(-h // 4)
    n = bw_ * bh_
    lo, hi = _block_ints(data, n, 16)
    out = np.zeros((n, 16, 3), np.float32)

    m2 = (lo & np.uint64(0x3)).astype(np.int32)
    m5 = (lo & np.uint64(0x1F)).astype(np.int32)
    mode_val = np.where(m2 < 2, m2, m5)

    for mv, mlen, epb, deltas, fields in _BC6_MODES:
        sel = np.nonzero(mode_val == mv)[0]
        if sel.size == 0:
            continue
        blo, bhi = lo[sel], hi[sel]
        two_region = not (mv in (0x03, 0x07, 0x0B, 0x0F))

        vals = np.zeros((sel.size, 13), np.int64)   # indexed by field
        pos = mlen
        for name, a, b in fields:
            nb = abs(a - b) + 1
            piece = _take_bits(blo, bhi, pos, nb).astype(np.int64)
            pos += nb
            fi = _BC6_FIELD_IDX[name]
            if a >= b:
                vals[:, fi] |= piece << b
            else:   # reversed range (MSB stored first)
                for k in range(nb):
                    vals[:, fi] |= ((piece >> k) & 1) << (a + k)

        rw, gw, bw = vals[:, 0], vals[:, 1], vals[:, 2]
        ends = {}
        names = ["rx", "gx", "bx", "ry", "gy", "by", "rz", "gz", "bz"]
        if signed:
            rw = _sign_extend(rw, epb)
            gw = _sign_extend(gw, epb)
            bw = _sign_extend(bw, epb)
        base = {"r": rw, "g": gw, "b": bw}
        for nm in names:
            v = vals[:, _BC6_FIELD_IDX[nm]]
            if deltas is not None:
                db = deltas["rgb".index(nm[0])]
                v = _sign_extend(v, db)
                v = (base[nm[0]] + v) & ((1 << epb) - 1)
                if signed:
                    v = _sign_extend(v, epb)
            elif signed:
                v = _sign_extend(v, epb)
            ends[nm] = v
        ends["rw"], ends["gw"], ends["bw"] = rw, gw, bw

        uq = {k: _bc6_unquantize(v, epb, signed) for k, v in ends.items()}
        part = vals[:, 12] & 0x1F
        if two_region:
            subset = _PART2[part]                        # (N, 16)
            anchors = np.zeros((sel.size, 16), bool)
            anchors[:, 0] = True
            anchors[np.arange(sel.size), _ANCHOR2[part]] = True
            iw = 3
        else:
            subset = np.zeros((sel.size, 16), np.int32)
            anchors = np.zeros((sel.size, 16), bool)
            anchors[:, 0] = True
            iw = 4
        idx = _read_indices(blo, bhi, pos, iw, anchors)
        wt = _WEIGHTS[iw][idx]                           # (N, 16)

        for ci, ch in enumerate("rgb"):
            e0 = np.stack([uq[ch + "w"], uq[ch + "y"]], axis=1)
            e1 = np.stack([uq[ch + "x"], uq[ch + "z"]], axis=1)
            a0 = np.take_along_axis(e0, subset, axis=1)
            a1 = np.take_along_axis(e1, subset, axis=1)
            q = ((64 - wt) * a0 + wt * a1 + 32) >> 6
            half = _bc6_finish(q, signed)
            out[sel, :, ci] = half.view(np.float16).astype(np.float32)

    return _blocks_to_image(out, w, h)
