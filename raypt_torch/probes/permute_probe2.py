"""`scripts/tpu_permute_probe2.py` on the card: the regroup cycle chained
(each cycle's scatter feeds the next cycle's x), with a fixed selection
(cycle 0's, in every cycle) against a fresh rank and selection per
cycle, for 16 and 64 cycles, each checked bitwise against its plain
version, with the marginal time per cluster-cycle. In the kernel
(`csrc/regroup.cu`) a chained lane's cycles are steps in registers, its
x read once and written once; fixed-S ranks cycle 0 once and the full
rank every cycle, at once by warp ballots.

    PP_N=8192 PP_PROGS=128 python -m raypt_torch.probes.permute_probe2
"""
from __future__ import annotations

import sys

from ._common import (bits_equal, card_label, first_call_s, parse_device,
                      require, time_ms)
from .permute_probe import N, PROGS, inputs
from .regroup import permute, permute_plain

ITERS = (16, 64)


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    x = inputs(device)
    for fixed in (True, False):
        label = "fixed-S (matmuls only)" if fixed else "full rank+select"
        prev = None
        for iters in ITERS:
            def run(iters=iters, fixed=fixed):
                return permute(x, iters, N, chain=True, fixed_s=fixed)

            first = first_call_s(device, run)
            require(bits_equal(run(), permute_plain(x, iters, N, True, fixed)),
                    f"{label}, {iters} cycles: kernel and plain version "
                    f"differ")
            ms = time_ms(device, run, 3)
            print(f"{label} iters={iters:3d}: {ms:8.3f}ms (first call "
                  f"{first:.1f}s)  [{card}]", flush=True)
            if prev is not None:
                per = (ms - prev) * 1e6 / ((iters - ITERS[0]) * PROGS)
                print(f"  -> marginal per cluster-cycle: {per:.0f} ns  "
                      f"[{card}]", flush=True)
            prev = ms


if __name__ == "__main__":
    main(sys.argv[1:])
