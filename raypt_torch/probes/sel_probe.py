"""`scripts/tpu_sel_probe.py` on the card. The script built one selection
matrix four ways to find which lowered in Mosaic; all four compute one
function, which on Hopper is one kernel (`regroup.sel`, no matrix), so
each variant name runs it. Its rank is the probe's shifted sum of the
interest bits, not a prefix sum; with the probe's interest pattern it is
-1 on every interested lane, so no lane reaches a slot and the output is
zero. The kernel tests every (lane, cycle) against the residues that
would give the lane a slot (its shifted sums, summed once a lane) and
votes once a program whether any has one: the probe times that test and
the zero output's writes. For 16, 64 and 256 cycles on (24, SP_N * 128)
bf16 rows (SP_N <= 16,384), checked bitwise against the plain version,
with the marginal time per cycle.

    SP_N=2048 python -m raypt_torch.probes.sel_probe [variant ...]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ._common import bits_equal, card_label, parse_device, require, time_ms
from .regroup import sel, sel_plain

N = int(os.environ.get("SP_N", 2048))
PROGS = 128
ITERS = (16, 64, 256)
VARIANTS = ("eq_bf16", "eq_f32_bf16", "eq_i32_bf16", "bcast_first")


def inputs(device, seed: int = 0) -> torch.Tensor:
    """The script's x: (24, N * 128) normal draws rounded to bf16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, N * PROGS)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).to(device)


def main(argv=None) -> None:
    device, rest = parse_device(argv, __doc__)
    card = card_label(device)
    x = inputs(device)
    for v in rest or VARIANTS:
        if v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}; one of {VARIANTS}")
        t0 = time.perf_counter()
        for it in ITERS:
            require(bits_equal(sel(x, it, N), sel_plain(x, it, N)),
                    f"{v}, {it} cycles: kernel and plain version differ")
        warm = time.perf_counter() - t0
        ts = {it: time_ms(device, lambda: sel(x, it, N), 3) for it in ITERS}
        per = (ts[ITERS[-1]] - ts[ITERS[0]]) * 1e6 / (
            (ITERS[-1] - ITERS[0]) * PROGS)
        print(f"{v}: OK warm {warm:.1f}s  "
              + "  ".join(f"t{i}={ts[i]:.3f}ms" for i in ITERS)
              + f"  marginal {per:.0f} ns/cycle  [{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
