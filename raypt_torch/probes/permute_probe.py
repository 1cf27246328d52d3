"""`scripts/tpu_permute_probe.py` on the card: the cost of one regroup ->
test -> scatter cycle per cluster, `regroup.permute` on (8, N * PROGS)
random rows for 8, 32 and 128 cycles, each checked bitwise against its
plain version, with the marginal time per cluster-cycle. The kernel
(`csrc/regroup.cu`) ranks each program's cycles at once by warp ballots
and takes each lane's rows through its selecting cycles in registers,
so the marginal time is the rank's; `python -m raypt_torch.kernels.sweep
--kernels permute` times it beside the slot tile design, which moves
each cycle's lanes through the slots in order.

    PP_N=8192 PP_PROGS=128 python -m raypt_torch.probes.permute_probe
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ._common import (bits_equal, card_label, first_call_s, parse_device,
                      require, time_ms)
from .regroup import permute, permute_plain

N = int(os.environ.get("PP_N", 8192))        # rays per program
PROGS = int(os.environ.get("PP_PROGS", 128))
ITERS = (8, 32, 128)


def inputs(device, rows: int = 8, seed: int = 0) -> torch.Tensor:
    """The script's x: (rows, N * PROGS) f32 normal draws from its seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, N * PROGS)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    x = inputs(device)
    times = {}
    for iters in ITERS:
        first = first_call_s(device, lambda: permute(x, iters, N))
        require(bits_equal(permute(x, iters, N),
                           permute_plain(x, iters, N)),
                f"permute, {iters} cycles: kernel and plain version differ")
        ms = time_ms(device, lambda: permute(x, iters, N), 3)
        times[iters] = ms
        per = ms * 1e6 / (iters * PROGS)
        print(f"iters={iters:4d}: {ms:7.3f}ms ({per:6.0f} ns per "
              f"cluster-cycle per program, first call {first:.1f}s)  "
              f"[{card}]", flush=True)
    lo, hi = ITERS[0], ITERS[-1]
    slope = (times[hi] - times[lo]) * 1e6 / ((hi - lo) * PROGS)
    print(f"marginal per-cluster regroup+test+scatter: {slope:.0f} ns "
          f"(need <~1500 ns for the PLAN_R5 design to win at bounce 1)  "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
