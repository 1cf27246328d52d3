"""The Pallas probes of `scripts/` as hand-written Hopper kernels.

Each probe of the JAX repository's `scripts/` asked a design question
about the kernels (the speculative walk, the cost of regrouping rays into
128 slots, the expansion's invariants, the row gather). Here each one is
a CUDA kernel in `raypt_torch/csrc/` with its plain torch version beside
it, and an entry point named after its script without `tpu_`:

    python -m raypt_torch.probes.walk_spec_probe      # P1
    python -m raypt_torch.probes.permute_probe        # P2
    python -m raypt_torch.probes.permute_probe2       # P3
    python -m raypt_torch.probes.sel_probe            # P4
    python -m raypt_torch.probes.cycle_budget         # P5
    python -m raypt_torch.probes.expand_debug         # P6-P8
    python -m raypt_torch.probes.expand_diag2         # P9
    python -m raypt_torch.probes.pallas_gather_test   # P10
    python -m raypt_torch.probes.pallas_gather_test2  # P11

Each runs on the card unless `--device cpu` is passed, reads the
script's environment variables and default sizes, prints the script's
lines with the card's name and power limit beside every time, and raises
when a build, a launch or the script's own check fails. The regroup
kernels (P2-P5) share `regroup.py`, the gathers (P10, P11) `gather.py`.
"""
