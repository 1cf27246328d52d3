"""`scripts/tpu_expand_diag2.py` on the card: the expansion's control flow
on a real wavefront (the bunny's primary rays at 256^2, the mask of the
leaf-64 top-tree walk), with the triangle test replaced by checks of the
regrouping's invariants, in the CUDA kernel of `csrc/expand_diag.cu`
(contract there), held bitwise against its plain torch version.

The kernel runs the (program, cluster, round) items concurrently over
the card: a block for each (program, mask word) reads its rays' words
once, forms that word of the union and ranks each wanted cluster's rays
by warp ballots; each item runs on a warp's own 128-slot tile, and a
ray's outputs merge over items by integer adds (nc) and a max over bit
patterns (v1-v3, into outputs zeroed first). At most MAX_RAYS rays a
program.

Per program of DIAG_N rays: the union of their masks, its clusters in
ascending id, the rank of the rays that want each, rounds of 128 slots
and the split3 transport of each ray's origin and direction into its slot
and back. Outputs per ray: v1 (a slot that lost its ray), v2 and v3 (the
direction's and the origin's round-trip error), nc (clusters that reached
the ray, its mask's popcount when the flow is right).

    python -m raypt_torch.probes.expand_diag2 [--device cpu]
"""
from __future__ import annotations

import os
import sys

import torch

from ..kernels._build import launch, on_cuda
from ..kernels.onehot_walk import topwalk_cm
from . import walk_spec_probe
from ._common import (SLOTS, bits_equal, card_label, exclusive_rank,
                      parse_device, require, split3_bf16, time_ms)
from .expand_debug import payload_rows

N = int(os.environ.get("DIAG_N", 2048))
MAX_RAYS = 16384   # rays a program the kernel takes (kDiagMaxRays)
SIZE = 256
LEAF = 64


def payload(ro: torch.Tensor, rd: torch.Tensor):
    """(24, R) bf16 split3 payload [oh, dh, om, dm, ol, dl, 0] and the
    (6, R) f32 truth [o, d] of rays ro, rd (R, 3)."""
    truth = torch.cat([ro.T, rd.T], dim=0).contiguous()
    return payload_rows(truth).contiguous(), truth


def _rebuild(g: torch.Tensor) -> torch.Tensor:
    """Split f32 values into bf16 digits and add them back, (hi + md) + lo."""
    h, md, lo = split3_bf16(g)
    return (h.float() + md.float()) + lo.float()


def diag_plain(mask_cm, pay, otrue, n_rays: int):
    """The kernel's function on (cwp, R) masks, the payload and the truth,
    vectorised over programs, with a loop over clusters and rounds."""
    cwp, r = mask_cm.shape
    progs = r // n_rays
    dev = mask_cm.device
    m3 = mask_cm.view(cwp, progs, n_rays)
    pay3 = pay.view(24, progs, n_rays).float()[:18]
    ot3 = otrue.view(6, progs, n_rays)
    lane = torch.arange(n_rays, device=dev).expand(progs, n_rays)
    v1 = torch.zeros((progs, n_rays), dtype=torch.float32, device=dev)
    v2, v3 = torch.zeros_like(v1), torch.zeros_like(v1)
    nc = torch.zeros((progs, n_rays), dtype=torch.int32, device=dev)
    zero = torch.zeros_like(v1)
    for w in range(cwp):
        for k in range(32):
            m = (m3[w] >> k) & 1
            count = int(m.sum(dim=1).max())
            rank = exclusive_rank(m)
            for rb in range(0, count, SLOTS):
                sel = (m > 0) & (rank >= rb) & (rank < rb + SLOTS)
                slot = torch.where(sel, rank - rb,
                                   torch.full_like(rank, SLOTS)).long()
                owner = torch.full((progs, SLOTS + 1), -1, dtype=torch.long,
                                   device=dev).scatter_(1, slot, lane)
                z1 = (owner.gather(1, slot) == lane).float()
                v1 = torch.maximum(v1, torch.where(sel, (z1 - 1.0).abs(), zero))
                nc = nc + sel.to(torch.int32)
                g = torch.zeros((18, progs, SLOTS + 1), dtype=torch.float32,
                                device=dev).scatter_(
                    2, slot.expand(18, progs, n_rays), pay3)
                bo = _rebuild((g[0:3] + g[6:9]) + g[12:15])
                bd = _rebuild((g[3:6] + g[9:12]) + g[15:18])
                idx = slot.expand(3, progs, n_rays)
                dvo = (bo.gather(2, idx) - ot3[0:3]).abs().amax(dim=0)
                dvd = (bd.gather(2, idx) - ot3[3:6]).abs().amax(dim=0)
                v3 = torch.maximum(v3, torch.where(sel, dvo, zero))
                v2 = torch.maximum(v2, torch.where(sel, dvd, zero))
    return tuple(x.reshape(1, r) for x in (v1, v2, nc, v3))


def diag(mask_cm, pay, otrue, n_rays: int):
    """mask_cm (cwp, R) int32, pay (24, R) bf16, otrue (6, R) f32;
    R a multiple of n_rays <= MAX_RAYS -> (v1, v2, nc, v3), each (1, R)."""
    cwp, r = mask_cm.shape
    if r % n_rays or not 0 < n_rays <= MAX_RAYS:
        raise ValueError(f"R={r} must be a multiple of n_rays={n_rays} "
                         f"<= {MAX_RAYS}")
    if not on_cuda({"mask_cm": (mask_cm, (cwp, r), torch.int32),
                    "pay": (pay, (24, r), torch.bfloat16),
                    "otrue": (otrue, (6, r), torch.float32)}):
        return diag_plain(mask_cm, pay, otrue, n_rays)
    dev = mask_cm.device
    v1 = torch.empty((1, r), dtype=torch.float32, device=dev)
    v2, v3 = torch.empty_like(v1), torch.empty_like(v1)
    nc = torch.empty((1, r), dtype=torch.int32, device=dev)
    launch("rk_expand_diag", mask_cm.data_ptr(), cwp, pay.data_ptr(),
           otrue.data_ptr(), r, n_rays, v1.data_ptr(), v2.data_ptr(),
           nc.data_ptr(), v3.data_ptr())
    diag.launches += 1
    return v1, v2, nc, v3


diag.launches = 0


def run_diag(mask_cm, ro, rd, n_rays: int):
    """The script's run_diag: (cwp, R) mask and rays (R, 3) -> (v1, v2,
    nc, v3), through the kernel on CUDA tensors."""
    return diag(mask_cm, *payload(ro, rd), n_rays)


def wavefront(device, size: int = SIZE, leaf: int = LEAF):
    """The bunny's primary rays at size^2 in block order (ro, rd), the
    (cwp, R) mask of the leaf's top-tree walk padded to a multiple of 8
    words, and the unpadded (num_words, R) mask."""
    args = walk_spec_probe.wavefront(device, size, leaf)
    _, ro, rd, _, _, nw = args
    r = ro.shape[0]
    mask = topwalk_cm(*args)
    cwp = -(-nw // 8) * 8
    mask_cm = torch.cat([mask, torch.zeros((cwp - nw, r), dtype=torch.int32,
                                           device=device)]).contiguous()
    return ro, rd, mask_cm, mask


def popcount(mask: torch.Tensor) -> torch.Tensor:
    """Set bits of each ray's (words, R) mask column, int64 (R,)."""
    bits = torch.arange(32, device=mask.device, dtype=torch.int32)
    return ((mask[:, :, None] >> bits) & 1).sum(dim=(0, 2))


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    ro, rd, mask_cm, mask = wavefront(device, SIZE, LEAF)
    r = ro.shape[0]
    pay, otrue = payload(ro, rd)
    out = diag(mask_cm, pay, otrue, N)
    plain = diag_plain(mask_cm, pay, otrue, N)
    require(all(bits_equal(a, b) for a, b in zip(out, plain)),
            "the diagnostics kernel differs from its plain version")
    v1, v2, nc, v3 = (x[0] for x in out)
    pop = popcount(mask)
    print(f"viol1 (colsum != sel): max={float(v1.max())} "
          f"nbad={int((v1 != 0).sum())}")
    print(f"viol2 REPURPOSED = d-rows reconstruction: max={float(v2.max())} "
          f"nbad={int((v2 != 0).sum())}")
    nc_bad = torch.nonzero(nc.long() != pop).flatten()
    print(f"nclus != popcount: {nc_bad.numel()} rays")
    print(f"viol3 = o-rows reconstruction: max={float(v3.max())} "
          f"nbad={int((v3 != 0).sum())}")
    if nc_bad.numel():
        print("  first", nc_bad[:8].tolist(), "nc", nc[nc_bad[:8]].tolist(),
              "pop", pop[nc_bad[:8]].tolist())
        print("  by program:", torch.bincount(
            nc_bad // N, minlength=r // N).tolist())
    ms = time_ms(device, lambda: diag(mask_cm, pay, otrue, N), 10)
    print(f"kernel vs plain: bitwise equal; diag kernel {ms:.3f} ms on "
          f"{r} rays, {r // N} programs  [{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
