"""What the probes' entry points share: the device, the card's label, a
timer, the check that raises, and the bf16 helpers of the JAX kernels
(`split3_bf16`, the lane prefix sum) in torch."""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

SLOTS = 128   # the slot tile of the regroup and expansion probes


def parse_device(argv, description: str):
    """(device, remaining args) from `--device` (default "cuda"). A CUDA
    device without a card raises: nothing falls back to the CPU."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args, rest = p.parse_known_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe runs on the card "
                           "(pass --device cpu for its plain version)")
    return torch.device(args.device), rest


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    a note that the times are the CPU's."""
    if device.type != "cuda":
        return "cpu: plain torch versions, host times (no device time)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown card"


def time_ms(device: torch.device, fn, reps: int) -> float:
    """Mean milliseconds of `fn` over `reps` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_call_s(device: torch.device, fn) -> float:
    """Host seconds of the first call (the kernels' build included)."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bit patterns (floats compared as ints)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def require(ok: bool, what: str) -> None:
    """The probe's own check: raise when it fails."""
    if not ok:
        raise AssertionError(f"probe check failed: {what}")


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).float()


def split3_bf16(x: torch.Tensor):
    """f32 -> (hi, md, lo) bf16 with (hi + md) + lo == x for |x| above
    ~2^-102 (`raypt/kernels/cluster_expand.py::split3_bf16`): hi and md
    truncate by masking the low 16 bits, lo rounds the rest."""
    top = torch.tensor(-65536, dtype=torch.int32, device=x.device)
    hi = (x.view(torch.int32) & top).view(torch.float32)
    r1 = x - hi
    md = (r1.view(torch.int32) & top).view(torch.float32)
    lo = (r1 - md).to(torch.bfloat16)
    return hi.to(torch.bfloat16), md.to(torch.bfloat16), lo


def exclusive_rank(m: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of an integer tensor along its last axis (the
    JAX kernels' `_lane_prefix_sum(m) - m`)."""
    return torch.cumsum(m, dim=-1, dtype=m.dtype) - m
