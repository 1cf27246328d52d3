"""`scripts/pallas_gather_test2.py` on the card: the gather of
pallas_gather_test through each of the script's four kernel bodies
(jnp.take, jnp.take with clip, a scalar loop, take_along_axis), which on
Hopper are one kernel (`gather.py`), each checked against `table[idx]`
and timed, with its row rate.

    python -m raypt_torch.probes.pallas_gather_test2 [--device cpu]
"""
from __future__ import annotations

import sys

from ._common import bits_equal, card_label, parse_device, require, time_ms
from .gather import gather_rows, gather_rows_plain
from .pallas_gather_test import R, inputs

VARIANTS = (("jnp.take(loaded)", False), ("jnp.take clip", True),
            ("scalar fori", False), ("take_along_axis", False))   # name, clip


def main(argv=None) -> None:
    device, _ = parse_device(argv, __doc__)
    card = card_label(device)
    table, idx = inputs(device)
    for name, clip in VARIANTS:
        ok = bits_equal(gather_rows(table, idx, clip),
                        gather_rows_plain(table, idx, clip))
        require(ok, f"{name}: the gather differs from table[idx]")
        ms = time_ms(device, lambda: gather_rows(table, idx, clip), 5)
        print(f"{name}: OK correct={ok} {ms * 1e3:.0f}us/{R}rows -> "
              f"{R / ms / 1e3:.0f}M rows/s  [{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
