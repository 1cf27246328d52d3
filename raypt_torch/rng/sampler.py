"""Counter-based threefry-2x32 sampling, bit for bit the JAX package's
(`raypt/rng/sampler.py`, which uses `jax.random`'s threefry).

A key is an explicit `Key` object (two uint32 words held as Python
ints); `fold_in` derives keys on the host. Draws are a pure function of
(key, pixel id, draw index), so they do not depend on how rays are laid
out. torch has no uint32 add or shift, so the per-pixel blocks run in
int64 with `& 0xFFFFFFFF` after every add, on the CPU and CUDA alike.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


class Key(NamedTuple):
    k0: int
    k1: int


def key(seed: int) -> Key:
    """The key `jax.random.key(seed)` makes for 0 <= seed < 2**31."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError("seed must be in [0, 2**31)")
    return Key(0, seed)


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(k: Key, x0, x1):
    """20-round threefry-2x32 of the blocks (x0, x1) (Python ints, or
    int64 tensors holding uint32 values) -> (y0, y1)."""
    ks = (k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def fold_in(k: Key, data: int) -> Key:
    """`jax.random.fold_in`: threefry of the block (0, data)."""
    return Key(*threefry2x32(k, 0, data & MASK))


def frame_key(base_key: Key, frame_index: int) -> Key:
    return fold_in(base_key, frame_index)


def sample_key(fkey: Key, sample_index: int) -> Key:
    return fold_in(fkey, sample_index)


def _per_pixel_uniforms(k: Key, pixel_ids: torch.Tensor, n: int):
    """n iid U[0,1) per pixel id -> (*pixel_ids.shape, n) f32: the first
    output word of threefry over (0, pixel_id * n + j), top 24 bits."""
    counters = ((pixel_ids.reshape(-1).to(torch.int64)[:, None] * n
                 + torch.arange(n, device=pixel_ids.device)[None, :]) & MASK)
    bits, _ = threefry2x32(k, torch.zeros_like(counters), counters)
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return u.reshape(pixel_ids.shape + (n,))


def sample_jitter(skey: Key, pixel_ids: torch.Tensor) -> torch.Tensor:
    """Sub-pixel jitter in [0,1)^2, shape (*ids, 2)."""
    return _per_pixel_uniforms(fold_in(skey, 0xA11CE), pixel_ids, 2)


def bounce_uniforms(skey: Key, bounce: int, pixel_ids: torch.Tensor):
    """[..., 0] specular pick, [..., 1] sphere z, [..., 2] sphere angle,
    [..., 3] russian roulette."""
    return _per_pixel_uniforms(fold_in(skey, bounce), pixel_ids, 4)


def random_point_on_sphere(u_z: torch.Tensor, u_a: torch.Tensor):
    """z = 2*u1 - 1; a = 2*pi*u2; r = sqrt(1 - z^2); (r cos a, r sin a, z)."""
    z = u_z * 2.0 - 1.0
    a = u_a * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(a), r * torch.sin(a), z], dim=-1)
