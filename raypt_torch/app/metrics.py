"""Structured metrics and logging (`raypt/app/metrics.py`): a render's
segment rate and an optimizer step's loss, one JSON line each on
stderr."""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass


@dataclass
class RenderMetrics:
    width: int = 0
    height: int = 0
    spp: int = 0
    bounces: int = 0
    frames: int = 0
    seconds: float = 0.0

    @property
    def rays(self) -> int:
        """Upper-bound path segments: every ray traced every bounce."""
        return self.width * self.height * self.spp * self.bounces * self.frames

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0

    def log(self, stream=sys.stderr, **extra):
        rec = {"event": "render", "mrays_per_sec": round(self.mrays_per_sec, 3),
               "frames": self.frames, "spp": self.spp,
               "seconds": round(self.seconds, 3), **extra}
        print(json.dumps(rec), file=stream, flush=True)


class Timer:
    """Wall-clock lap timer."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt


def log_step(step: int, loss: float, grad_norm: float | None = None,
             stream=sys.stderr, **extra):
    rec = {"event": "opt_step", "step": step, "loss": loss, **extra}
    if grad_norm is not None:
        rec["grad_norm"] = grad_norm
    print(json.dumps(rec), file=stream, flush=True)
