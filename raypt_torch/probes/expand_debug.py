"""`scripts/tpu_expand_debug.py` on the card: the expansion's per-cluster
cycle in stages, each a CUDA kernel of `csrc/expand_diag.cu` held against
its plain torch version.

  stage12  bit k of mask row w -> m, and m's exclusive rank
  stage34  the lanes with m and rank < 128 send their split3 payload to
           128 slots (go) and get it back (gsel, -1 off the selection)
  stage5   stage 1's m over a grid of two lane blocks

    python -m raypt_torch.probes.expand_debug [--device cpu]

On CPU tensors every wrapper runs its plain version.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels._build import launch, on_cuda
from ._common import (SLOTS, bits_equal, card_label, exclusive_rank,
                      parse_device, require, split3_bf16, time_ms)

N = 2048
CW8 = 2            # pages


def _mask_row(wk: torch.Tensor, pages: torch.Tensor):
    """(row of the (pages * 8, n) mask the probe selects, shift k), the
    page index clamped as XLA's dynamic slice clamps it."""
    w, k = (int(v) for v in wk.reshape(-1).tolist())
    p = min(max(w >> 3, 0), pages.shape[0] - 1)
    return p * 8 + (w & 7), k


def _bit(x: torch.Tensor, k: int) -> torch.Tensor:
    if not 0 <= k < 32:
        return torch.zeros_like(x)
    return (x >> k) & 1


def stage12_plain(wk, pages):
    row, k = _mask_row(wk, pages)
    m = _bit(pages.reshape(-1, pages.shape[2])[row], k)
    return m[None], exclusive_rank(m)[None]


def stage12(wk: torch.Tensor, pages: torch.Tensor):
    """wk (1, 2) int32 [[w, k]], pages (CW8, 8, n) int32, n <= 4,096 ->
    (m, rank), each (1, n) int32."""
    cw8, _, n = pages.shape
    if not on_cuda({"wk": (wk, (1, 2), torch.int32),
                    "pages": (pages, (cw8, 8, n), torch.int32)}):
        return stage12_plain(wk, pages)
    m = torch.empty((1, n), dtype=torch.int32, device=pages.device)
    rank = torch.empty_like(m)
    launch("rk_expand_stage12", wk.data_ptr(), pages.data_ptr(), cw8, n,
           m.data_ptr(), rank.data_ptr())
    stage12.launches += 1
    return m, rank


stage12.launches = 0


def stage34_plain(pay, m):
    mm = m[0]
    rank = exclusive_rank(mm)
    sel = (mm > 0) & (rank < SLOTS)
    in_slot = sel & (rank >= 0)
    slot = rank[in_slot].long()
    g = torch.zeros((24, SLOTS), dtype=torch.float32, device=pay.device)
    g[:, slot] = pay[:, in_slot].float()
    gcat = (g[0:6] + g[6:12]) + g[12:18]          # rows 0-2 o, 3-5 d
    h, md, lo = split3_bf16(gcat)
    back_slot = (h.float() + md.float()) + lo.float()
    back = torch.zeros((6, mm.shape[0]), dtype=torch.float32,
                       device=pay.device)
    back[:, in_slot] = back_slot[:, slot]
    return gcat, torch.where(sel[None], back, torch.full_like(back, -1.0))


def stage34(pay: torch.Tensor, m: torch.Tensor):
    """pay (24, n) bf16, m (1, n) int32 -> (go (6, 128) f32, gsel (6, n)
    f32); n <= 4,096."""
    n = m.shape[1]
    if not on_cuda({"pay": (pay, (24, n), torch.bfloat16),
                    "m": (m, (1, n), torch.int32)}):
        return stage34_plain(pay, m)
    go = torch.empty((6, SLOTS), dtype=torch.float32, device=m.device)
    gsel = torch.empty((6, n), dtype=torch.float32, device=m.device)
    launch("rk_expand_stage34", pay.data_ptr(), m.data_ptr(), n,
           go.data_ptr(), gsel.data_ptr())
    stage34.launches += 1
    return go, gsel


stage34.launches = 0


def stage5_plain(wk, pages2):
    return stage12_plain(wk, pages2)[0]


def stage5(wk: torch.Tensor, pages2: torch.Tensor):
    """wk (1, 2) int32, pages2 (CW8, 8, n_total) int32 -> m (1, n_total)
    int32, stage 1's bit on every lane."""
    cw8, _, n = pages2.shape
    if not on_cuda({"wk": (wk, (1, 2), torch.int32),
                    "pages2": (pages2, (cw8, 8, n), torch.int32)}):
        return stage5_plain(wk, pages2)
    m = torch.empty((1, n), dtype=torch.int32, device=pages2.device)
    launch("rk_expand_stage5", wk.data_ptr(), pages2.data_ptr(), cw8, n,
           m.data_ptr())
    stage5.launches += 1
    return m


stage5.launches = 0


def payload_rows(od: torch.Tensor) -> torch.Tensor:
    """(24, n) bf16 payload [oh, dh, om, dm, ol, dl, 0] of the split3
    digits of od (6, n) f32 (o rows 0-2, d rows 3-5)."""
    oh, om, ol = split3_bf16(od[0:3])
    dh, dm, dl = split3_bf16(od[3:6])
    return torch.cat([oh, dh, om, dm, ol, dl,
                      torch.zeros((6, od.shape[1]), dtype=torch.bfloat16,
                                  device=od.device)], dim=0)


def inputs(device, n: int = N, seed: int = 0):
    """The script's inputs from its seed: wk, pages (CW8, 8, n), the
    payload (24, n) bf16 of six rows od (6, n) f32 (o rows 0-2, d 3-5),
    and pages2 (CW8, 8, 2n)."""
    rng = np.random.default_rng(seed)
    mask_np = rng.integers(0, 2 ** 31, size=(CW8 * 8, n), dtype=np.int32)
    od = torch.from_numpy(rng.normal(size=(6, n)).astype(np.float32) * 3)
    mask2_np = rng.integers(0, 2 ** 31, size=(CW8 * 8, 2 * n), dtype=np.int32)
    pay = payload_rows(od)
    wk = torch.tensor([[11, 7]], dtype=torch.int32)
    pages = torch.from_numpy(mask_np.reshape(CW8, 8, n))
    pages2 = torch.from_numpy(mask2_np.reshape(CW8, 8, 2 * n))
    return tuple(x.contiguous().to(device)
                 for x in (wk, pages, pay, od, pages2))


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    wk, pages, pay, od, pages2 = inputs(device)
    m, rank = stage12(wk, pages)
    pm, prank = stage12_plain(wk, pages)
    ok1, ok2 = bits_equal(m, pm), bits_equal(rank, prank)
    print("stage1 m:", "OK" if ok1 else "FAIL", flush=True)
    print("stage2 rank:", "OK" if ok2 else "FAIL", flush=True)
    require(ok1 and ok2, "stage 1-2 differ from the plain version")

    go, gsel = stage34(pay, m)
    pgo, pgsel = stage34_plain(pay, m)
    sel = (m[0] > 0) & (rank[0] < SLOTS)
    nsel = int(sel.sum())
    ok3 = bits_equal(go, pgo) and torch.equal(go[:, :nsel],
                                              od[:, sel][:, :SLOTS])
    print("stage3 compact:", "OK" if ok3 else "FAIL", f"({nsel} selected)",
          flush=True)
    want = torch.where(sel[None], od, torch.full_like(od, -1.0))
    ok4 = bits_equal(gsel, pgsel) and torch.equal(gsel, want)
    print("stage4 scatter:", "OK" if ok4 else "FAIL", flush=True)
    require(ok3 and ok4, "stage 3-4 differ from the plain version or do "
            "not return the payload")

    m5 = stage5(wk, pages2)
    ok5 = bits_equal(m5, stage5_plain(wk, pages2))
    print("stage5 blocked-3D dynamic page:", "OK" if ok5 else "FAIL",
          flush=True)
    require(ok5, "stage 5 differs from the plain version")
    for name, fn in (("stage12", lambda: stage12(wk, pages)),
                     ("stage34", lambda: stage34(pay, m)),
                     ("stage5", lambda: stage5(wk, pages2))):
        print(f"{name}: {time_ms(device, fn, 10) * 1e3:.1f} us  [{card}]",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
