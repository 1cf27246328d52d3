"""`scripts/tpu_cycle_budget.py` on the card: what one expansion
cluster-cycle spends its time on, `regroup.cycle` in three modes on
(24, CB_N * CB_PROGS) random rows for 16 and CB_ITERS cycles, each
checked bitwise against its plain version:

  full     the slot assignment, the payload into the slots, the
           stand-in test and the way back
  no_mm    the slot assignment only (nothing moves)
  fixed_s  every lane in slot lane % 128 in every cycle (each slot sums
           CB_N / 128 lanes)

The kernel runs a block for each group of 16 slots of a program (eight
groups a program at the default CB_N of 8,192, any CB_N), which computes
every cycle's slot sums, so the time a cycle is the time of the sums, y
and the way back, not of a block's barriers.

    CB_N=8192 CB_PROGS=128 CB_ITERS=64 python -m raypt_torch.probes.cycle_budget
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ._common import (bits_equal, card_label, first_call_s, parse_device,
                      require, time_ms)
from .regroup import CYCLE_MODES, cycle, cycle_plain

N = int(os.environ.get("CB_N", 8192))
PROGS = int(os.environ.get("CB_PROGS", 128))
ITERS = int(os.environ.get("CB_ITERS", 64))


def inputs(device, seed: int = 0) -> torch.Tensor:
    """The script's x: (24, N * PROGS) f32 normal draws from its seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, N * PROGS)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    x = inputs(device)
    for mode in CYCLE_MODES:
        for iters in (16, ITERS):
            def run(iters=iters, mode=mode):
                return cycle(x, iters, N, mode)

            first = first_call_s(device, run)
            require(bits_equal(run(), cycle_plain(x, iters, N, mode)),
                    f"{mode}, {iters} cycles: kernel and plain version differ")
            ms = time_ms(device, run, 3)
            per = ms * 1e6 / (iters * PROGS)
            print(f"{mode:8s} iters={iters:3d}: {ms:7.3f} ms ({per:6.0f} "
                  f"ns/cycle, first call {first:.1f}s)  [{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
