"""Alive compaction of a ray wavefront and its inverse: the stable
alive-first permutation within each `group`-lane block
(`raypt/kernels/compact.py`: `pallas_alive_compact`,
`pallas_alive_uncompact`).

Lane i of a group goes to `pa(i)` when alive and to `na + pd(i)` when
dead, where pa/pd count the alive/dead lanes before i and na is the
group's alive count. The permutation is full, so dead lanes carry their
own data; the contract leaves their payload unspecified and callers
mask results by the original alive mask.

Each public function runs its CUDA kernel (`csrc/compact.cu`) on CUDA
tensors and its plain torch version on CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import launch, on_cuda

CHUNK = 256   # lanes a block of the compaction and uncompaction kernels
              # ranks (compact.cu kChunk): their count pass keeps one int a
              # chunk


def _destinations(alive: torch.Tensor, group: int) -> torch.Tensor:
    """(R,) int64 destination lane of every source lane."""
    a = alive.view(-1, group).to(torch.int64)
    pa = torch.cumsum(a, dim=1) - a
    na = a.sum(dim=1, keepdim=True)
    lane = torch.arange(group, device=alive.device)
    base = torch.arange(a.shape[0], device=alive.device)[:, None] * group
    return (torch.where(a > 0, pa, na + lane - pa) + base).view(-1)


def chunk_counts(alive: torch.Tensor, group: int) -> torch.Tensor:
    """The alive lanes of each CHUNK-lane chunk of each group (a group's
    last chunk may be partial), group-major: what alive_compact leaves in
    its `counts`."""
    cpg = -(-group // CHUNK)
    a = torch.nn.functional.pad(alive.view(-1, group).to(torch.int32),
                                (0, cpg * CHUNK - group))
    return a.view(-1, cpg, CHUNK).sum(dim=2, dtype=torch.int32).view(-1)


def _n_chunks(alive: torch.Tensor, group: int) -> int:
    return alive.shape[0] // group * -(-group // CHUNK)


def new_counts(alive: torch.Tensor, group: int) -> torch.Tensor:
    """A scratch of one int32 a chunk for alive_compact to leave its
    chunk counts in and alive_uncompact of the same mask to read."""
    return torch.empty((_n_chunks(alive, group),), dtype=torch.int32,
                       device=alive.device)


def alive_compact_plain(ro, rd, t0, alive, group: int, counts=None):
    dest = _destinations(alive, group)
    if counts is not None:
        counts.copy_(chunk_counts(alive, group))

    def scatter(x):
        return torch.empty_like(x).index_copy_(0, dest, x)

    return scatter(ro), scatter(rd), scatter(t0), scatter(alive)


def alive_uncompact_plain(t, face, alive, group: int, counts=None):
    """`counts` is not needed here; it is taken to match the kernel's."""
    dest = _destinations(alive, group)
    return t[dest], face[dest]


def _check_group(r: int, group: int) -> None:
    if group <= 0 or r % group:
        raise ValueError(f"R={r} must be a positive multiple of group={group}")


def _counts_spec(counts, alive, group: int) -> dict:
    if counts is None:
        return {}
    return {"counts": (counts, (_n_chunks(alive, group),), torch.int32)}


def alive_compact(ro, rd, t0, alive, group: int, counts=None):
    """Stable alive-first permutation of (ro (R, 3) f32, rd (R, 3) f32,
    t0 (R,) f32, alive (R,) bool) within each group; R % group == 0.
    Returns the permuted quadruple. counts: a `new_counts` scratch; the
    call leaves `chunk_counts(alive, group)` in it, for alive_uncompact of
    the same mask."""
    r = ro.shape[0]
    _check_group(r, group)
    if not on_cuda({
            "ro": (ro, (r, 3), torch.float32),
            "rd": (rd, (r, 3), torch.float32),
            "t0": (t0, (r,), torch.float32),
            "alive": (alive, (r,), torch.bool),
            **_counts_spec(counts, alive, group)}):
        return alive_compact_plain(ro, rd, t0, alive, group, counts)
    if counts is None:
        counts = new_counts(alive, group)
    outs = [torch.empty_like(x) for x in (ro, rd, t0, alive)]
    launch("rk_alive_compact", ro.data_ptr(), rd.data_ptr(), t0.data_ptr(),
           alive.data_ptr(), *(o.data_ptr() for o in outs), counts.data_ptr(),
           r, group)
    alive_compact.launches += 1
    return tuple(outs)


alive_compact.launches = 0


def alive_uncompact(t, face, alive, group: int, counts=None):
    """Inverse of alive_compact's permutation applied to the finder's
    (t (R,) f32, face (R,) int32); `alive` is the ORIGINAL mask that
    alive_compact saw. Every lane is defined; callers use live lanes.
    counts: what alive_compact left for this mask and group; without it
    the kernel counts each chunk's alive lanes again first."""
    r = t.shape[0]
    _check_group(r, group)
    if not on_cuda({
            "t": (t, (r,), torch.float32),
            "face": (face, (r,), torch.int32),
            "alive": (alive, (r,), torch.bool),
            **_counts_spec(counts, alive, group)}):
        return alive_uncompact_plain(t, face, alive, group, counts)
    counted = counts is not None
    if not counted:
        counts = new_counts(alive, group)
    t_out, f_out = torch.empty_like(t), torch.empty_like(face)
    launch("rk_alive_uncompact", t.data_ptr(), face.data_ptr(),
           alive.data_ptr(), t_out.data_ptr(), f_out.data_ptr(),
           counts.data_ptr(), int(counted), r, group)
    alive_uncompact.launches += 1
    return t_out, f_out


alive_uncompact.launches = 0
