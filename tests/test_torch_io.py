"""The port's DDS and BCn loaders (`raypt_torch/io/dds.py`, `bcn.py`)
against the JAX package's, bitwise, on synthetic files and random block
data (no asset is read or downloaded); and `load_reference_envmap` and
the asset search against the JAX package's, on a synthetic sunset
cubemap in a temporary RAYPT_DATA_DIR."""
import importlib
import os
import struct

import numpy as np
import pytest

from raypt.io import bcn as jbcn
from raypt.io import dds as jdds
from raypt.scenes import builtin as jbuiltin

from raypt_torch.io import bcn as tbcn
from raypt_torch.io import dds as tdds
from raypt_torch.scenes import builtin as tbuiltin

# (block bytes, fourcc or DXGI id) of each block-compressed format
_BLOCK = {"DXT1": 8, "DXT3": 16, "DXT5": 16, "ATI1": 8, "ATI2": 16,
          "BC4S": 8, "BC5S": 16, 71: 8, 80: 8, 81: 8, 83: 16, 84: 16,
          95: 16, 96: 16, 98: 16, 99: 16}


def _dds(w, h, payload, fourcc=None, dxgi=None, rgb_mask=None, cube=False,
         mips=1):
    """A DDS file: the legacy header with a FourCC, a DX10 header with a
    DXGI format, or a 32-bit RGB pixel format with the given red mask."""
    hdr = bytearray(148 if dxgi is not None else 128)
    hdr[0:4] = b"DDS "
    struct.pack_into("<5I", hdr, 4, 124, 0x1007, h, w, 0)
    struct.pack_into("<I", hdr, 28, mips)
    struct.pack_into("<I", hdr, 76, 32)
    if rgb_mask is not None:
        struct.pack_into("<IIII", hdr, 80, 0x40, 0, 32, rgb_mask)
    else:
        struct.pack_into("<I", hdr, 80, 0x4)
        if dxgi is not None:
            hdr[84:88] = b"DX10"
            struct.pack_into("<5I", hdr, 128, dxgi, 3, 0x4 if cube else 0, 1,
                             0)
        elif isinstance(fourcc, int):
            struct.pack_into("<I", hdr, 84, fourcc)
        else:
            hdr[84:88] = fourcc.encode()
    struct.pack_into("<I", hdr, 108, 0x1000)
    struct.pack_into("<I", hdr, 112, 0xFE00 if cube else 0)
    return bytes(hdr) + payload


def _payload(rng, fmt, w, h, faces=1, mips=1):
    """Random bytes for every face and mip level of a format: blocks for
    the BCn formats (BC7's mode bit forced, as tests/test_io.py does),
    finite halves or floats for 113 / 116, bytes for 8-bit RGBA."""
    sizes = []
    for _ in range(faces):
        mw, mh = w, h
        for _ in range(mips):
            sizes.append((mw, mh))
            mw, mh = max(mw // 2, 1), max(mh // 2, 1)
    out = []
    for mw, mh in sizes:
        if fmt in _BLOCK:
            nb = -(-mw // 4) * -(-mh // 4)
            raw = rng.integers(0, 256, (nb, _BLOCK[fmt]), dtype=np.uint8)
            if fmt in (98, 99):
                raw[:, 0] |= 1
            out.append(raw.tobytes())
        elif fmt == 113:
            out.append(rng.normal(size=mw * mh * 4).astype(np.float16)
                       .tobytes())
        elif fmt == 116:
            out.append((rng.random(mw * mh * 4) * 8).astype(np.float32)
                       .tobytes())
        else:
            out.append(rng.integers(0, 256, mw * mh * 4, dtype=np.uint8)
                       .tobytes())
    return b"".join(out)


def _file(fmt, w=16, h=12, cube=False, mips=1, seed=0):
    rng = np.random.default_rng(seed)
    faces = 6 if cube else 1
    pay = _payload(rng, fmt, w, h, faces, mips)
    if fmt in ("rgba", "bgra"):
        return _dds(w, h, pay, rgb_mask=0xFF if fmt == "rgba" else 0xFF0000,
                    cube=cube, mips=mips)
    if isinstance(fmt, int) and fmt not in (113, 116):
        return _dds(w, h, pay, dxgi=fmt, cube=cube, mips=mips)
    return _dds(w, h, pay, fourcc=fmt, cube=cube, mips=mips)


def _same(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("fmt,cube,mips", [
    ("DXT1", False, 1), ("DXT3", False, 1), ("DXT5", False, 3),
    ("ATI1", False, 1), ("ATI2", False, 1), ("BC4S", False, 1),
    ("BC5S", False, 1), (71, False, 1), (80, False, 2), (81, False, 1),
    (83, False, 1), (84, False, 1), (95, False, 1), (96, False, 1),
    (98, False, 2), (99, False, 1), (113, False, 1), (116, True, 3),
    ("rgba", False, 1), ("bgra", True, 2)])
def test_load_dds_bitwise(fmt, cube, mips):
    """load_dds of the same synthetic file: every key equal, every mip
    level bitwise (sizes not a multiple of 4 exercise the partial
    blocks)."""
    raw = _file(fmt, cube=cube, mips=mips, seed=sum(map(ord, str(fmt))))
    got, ref = tdds.load_dds(raw), jdds.load_dds(raw)
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "mip_data":
            assert len(got[k]) == len(ref[k]) == mips
            for a, b in zip(got[k], ref[k]):
                _same(a, b)
        elif k == "data":
            _same(got[k], ref[k])
        else:
            assert got[k] == ref[k]
    assert got["is_cube"] == cube


@pytest.mark.parametrize("srgb", [None, True, False])
def test_load_dds_srgb_bitwise(srgb):
    raw = _file(99, w=8, h=8)
    _same(tdds.load_dds(raw, srgb=srgb)["data"],
          jdds.load_dds(raw, srgb=srgb)["data"])


@pytest.mark.parametrize("decoder,blk,kw", [
    ("decode_bc4", 8, {}), ("decode_bc4", 8, {"signed": True}),
    ("decode_bc5", 16, {}), ("decode_bc5", 16, {"signed": True}),
    ("decode_bc6h", 16, {}), ("decode_bc6h", 16, {"signed": True}),
    ("decode_bc7", 16, {})])
def test_bcn_decoders_bitwise(decoder, blk, kw):
    """Each BCn decoder on 1,024 random blocks (every BC6H/BC7 mode and
    partition occurs), the port's against the JAX package's."""
    rng = np.random.default_rng(len(decoder) * 10 + len(kw))
    w = h = 128
    raw = rng.integers(0, 256, ((w // 4) * (h // 4), blk), dtype=np.uint8)
    if decoder == "decode_bc7":
        raw[:16, 0] = 0       # reserved blocks decode to zero
    pay = raw.tobytes()
    _same(getattr(tbcn, decoder)(pay, w, h, **kw),
          getattr(jbcn, decoder)(pay, w, h, **kw))


def test_dds_errors_match():
    for raw in (b"nope" + bytes(200), _dds(4, 4, bytes(8), fourcc="XXXX"),
                _dds(4, 4, bytes(16), dxgi=1)):
        with pytest.raises(jdds.DDSError):
            jdds.load_dds(raw)
        with pytest.raises(tdds.DDSError):
            tdds.load_dds(raw)
    flat = _file(116)
    with pytest.raises(tdds.DDSError):
        tdds.load_env_cubemap(flat)


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """Both builtin modules re-imported with RAYPT_DATA_DIR = tmp_path,
    and re-imported again without it afterwards."""
    monkeypatch.setenv("RAYPT_DATA_DIR", str(tmp_path))
    mods = [importlib.reload(m) for m in (jbuiltin, tbuiltin)]
    yield tmp_path, mods
    monkeypatch.undo()
    for m in (jbuiltin, tbuiltin):
        importlib.reload(m)


def test_asset_search_matches_jax(data_dir):
    tmp, (jb, tb) = data_dir
    norm = [tuple(os.path.normpath(d) if d else d for d in m._DATA_CANDIDATES)
            for m in (jb, tb)]
    assert norm[0] == norm[1]
    assert norm[1][0] == str(tmp)


@pytest.mark.parametrize("mips", [1, 3])
def test_reference_envmap_matches_jax(data_dir, mips):
    """A synthetic sunset cubemap (D3DFMT 116, the shipped map's format)
    in RAYPT_DATA_DIR: the port binds the same (6, H, W, 3) sky as the
    JAX package, bitwise; without the file both fall back to the same
    procedural sky."""
    tmp, (jb, tb) = data_dir
    ref, got = jb.load_reference_envmap(), tb.load_reference_envmap()
    assert got.is_cube and ref.is_cube
    _same(got.data.numpy(), np.asarray(ref.data))
    assert got.data.shape == (6, 64, 64, 3)
    (tmp / "sunset_uncompressed.dds").write_bytes(
        _file(116, w=32, h=32, cube=True, mips=mips, seed=mips))
    jb.load_reference_envmap.cache_clear()
    tb.load_reference_envmap.cache_clear()
    ref, got = jb.load_reference_envmap(), tb.load_reference_envmap()
    assert got.is_cube and ref.is_cube
    assert got.data.shape == (6, 32, 32, 3)
    _same(got.data.numpy(), np.asarray(ref.data))
