"""Debug-mode numerical checks of a render (`raypt/app/debug.py`).

The JAX package runs a frame under `jax.experimental.checkify`; the
port checks explicitly, in torch, on the tensors a frame computes:
  * the scene's inputs: mesh positions, normals and uvs, every float
    material field, sphere centres and radii, the camera frame and the
    environment, all finite;
  * each bounce's ray state (origins and directions handed to the
    finder), its hit distances (BIG on a miss, so finite) and its hit
    ids, within [-1, faces) and [-1, spheres);
  * the path state at the start of each bounce (throughput and
    radiance, through `trace_paths`' check hook) and the frame, finite.
The checks record device flags and read them back once, after the
frame; the first failing check in that order is the error. The normal
path carries none of this: `render_frame` is unchanged, and
`checked_render_frame` computes the same image bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.types import RenderConfig, Scene
from ..render.integrator import make_finder, render_sample
from ..rng.sampler import Key, frame_key, sample_key


class RenderCheckError(RuntimeError):
    """A debug-mode check of a render failed."""


class CheckResult:
    """The outcome of the checks: `get()` is None when all passed, else
    the message of the first that failed."""

    def __init__(self, message: Optional[str] = None):
        self._message = message

    def get(self) -> Optional[str]:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise RenderCheckError(self._message)


class _Checks:
    """Flags on the device, in order: (message, flag) where the message
    may name a tensor whose first bad value it reports."""

    def __init__(self):
        self.items = []

    def finite(self, label: str, x: torch.Tensor) -> None:
        x = x.detach()
        self.items.append((f"{label}: nan", torch.isnan(x).any()))
        self.items.append((f"{label}: inf", torch.isinf(x).any()))

    def index(self, label: str, ids: torch.Tensor, n: int) -> None:
        bad = (ids < -1) | (ids >= n)
        self.items.append(((label, ids, bad, n), bad.any()))

    def result(self) -> CheckResult:
        if not self.items:
            return CheckResult()
        flags = torch.stack([f for _, f in self.items]).cpu()
        for (what, _), failed in zip(self.items, flags.tolist()):
            if failed:
                if isinstance(what, tuple):
                    label, ids, bad, n = what
                    first = int(ids[bad].flatten()[0])
                    what = f"{label}: index {first} out of range [-1, {n})"
                return CheckResult(what)
        return CheckResult()


def _check_scene(checks: _Checks, scene: Scene) -> None:
    m = scene.mesh
    for name in ("positions", "normals", "uvs"):
        checks.finite(f"mesh.{name}", getattr(m, name))
    for f in dataclasses.fields(scene.materials):
        v = getattr(scene.materials, f.name)
        if v.is_floating_point():
            checks.finite(f"materials.{f.name}", v)
    checks.finite("spheres.center", scene.spheres.center)
    checks.finite("spheres.radius", scene.spheres.radius)
    for f in dataclasses.fields(scene.camera):
        checks.finite(f"camera.{f.name}", getattr(scene.camera, f.name))
    checks.finite("env.data", scene.env.data)


def checked_render_frame(scene: Scene, cfg: RenderConfig, key: Key,
                         frame_index=0, accel=None, throw: bool = True):
    """render_frame with finite and index checks. Returns (err, image),
    err a CheckResult; with throw=True (the default) raises
    RenderCheckError instead when a check failed."""
    checks = _Checks()
    _check_scene(checks, scene)
    finder = make_finder(scene, cfg, accel)
    faces, spheres = scene.mesh.num_faces, scene.spheres.capacity
    bounce = [0]

    def checked_finder(s, ro, rd, active=None):
        label = f"bounce {bounce[0]}"
        checks.finite(f"ray origins, {label}", ro)
        checks.finite(f"ray directions, {label}", rd)
        ids = finder(s, ro, rd, active=active)
        checks.finite(f"hit t, {label}", ids.t)
        checks.index(f"hit triangle id, {label}", ids.tri, faces)
        checks.index(f"hit sphere id, {label}", ids.sphere, spheres)
        bounce[0] += 1
        return ids

    def check_paths(b, throughput, radiance):
        bounce[0] = b
        checks.finite(f"throughput, bounce {b}", throughput)
        checks.finite(f"radiance, bounce {b}", radiance)

    fkey = frame_key(key, frame_index)
    acc = torch.zeros((cfg.height, cfg.width, 3),
                      device=scene.mesh.positions.device)
    for s in range(cfg.samples_per_pixel):
        acc = acc + render_sample(scene, cfg, sample_key(fkey, s),
                                  checked_finder, check=check_paths)
    img = acc / cfg.samples_per_pixel
    checks.finite("image", img)
    err = checks.result()
    if throw:
        err.throw()
    return err, img
