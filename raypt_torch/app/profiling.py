"""Profiling harness (`raypt/app/profiling.py`): a `torch.profiler`
trace, wall-clock timing that waits for the card, and the segment rate
of a render."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch


def _sync() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with torch.profiler (CPU, and CUDA where torch
    sees a card) and write its Chrome trace to log_dir/trace.json
    (log_dir defaults to raypt_trace under the temporary directory).
    Yields log_dir."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "raypt_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, reps: int = 3, warmup: int = 1,
            **kwargs) -> dict:
    """Time fn(*args, **kwargs), each call ended by
    torch.cuda.synchronize() on the card: {compile_s: the first call
    (kernel builds included), best_s, mean_s: of `reps` calls after
    warmup - 1 more}."""
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    return {"compile_s": compile_s, "best_s": min(times),
            "mean_s": sum(times) / len(times)}


def rays_per_sec(cfg, seconds: float, frames: int = 1) -> float:
    """Upper-bound path-segment rate of a RenderConfig's frames."""
    segs = cfg.width * cfg.height * cfg.samples_per_pixel * \
        cfg.num_bounces * frames
    return segs / seconds
