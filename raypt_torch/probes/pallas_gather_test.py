"""`scripts/pallas_gather_test.py` on the card: one gather of 1,024 rows
of a (32768, 16) f32 table, checked against `table[idx]` (the plain
version) and timed.

    python -m raypt_torch.probes.pallas_gather_test [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from ._common import bits_equal, card_label, parse_device, require, time_ms
from .gather import gather_rows, gather_rows_plain

N, W = 32768, 16   # table rows x width
R = 1024           # rays per tile


def inputs(device, seed: int = 0):
    """The table (N, W) f32 and R indices in [0, N), from a seed."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((N, W), generator=g, dtype=torch.float32)
    idx = torch.randint(0, N, (R,), generator=g, dtype=torch.int32)
    return table.to(device), idx.to(device)


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    table, idx = inputs(device)
    out = gather_rows(table, idx)
    ok = bits_equal(out, gather_rows_plain(table, idx))
    print("gather kernel works, correct:", ok, flush=True)
    require(ok, "the gather differs from table[idx]")
    ms = time_ms(device, lambda: gather_rows(table, idx), 5)
    print(f"{ms * 1e3:.0f}us for {R} rows  [{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
