"""Inverse rendering (`raypt/diff/inverse.py`): recover scene parameters
from target images by gradient descent (BASELINE config #5: "recover
bunny vertex offsets + albedo from 16 target views").

The render inside the loss is the forward path's integrator: the finder
runs without autograd (on the card, through the finder's kernels) and
only the hit recompute carries gradients. The optimizer is a
`torch.optim` one over `SceneParams.parameters()` in place of optax;
`fit` makes the `torch.optim.Adam` with optax's defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..accel import lbvh
from ..accel.lbvh import LBVH
from ..accel.traverse import recompute_hit
from ..core.math3d import normalize
from ..core.types import CameraRays, RenderConfig, Scene
from ..dist.sharding import Mesh, check_mesh, sum_over_mesh
from ..render.integrator import (camera_rays_for_ids, make_finder,
                                 pack_layout, pixel_id_grid, render_sample,
                                 resolve_backend)
from ..rng.sampler import Key, fold_in, frame_key, sample_key
from ..rng.sampler import key as make_key
from .params import SceneParams, apply_params, freeze_except

def stack_views(views: Sequence[CameraRays]) -> CameraRays:
    """Per-view camera frames stacked along a leading axis K."""
    return CameraRays(**{f.name: torch.stack([getattr(v, f.name)
                                              for v in views])
                         for f in dataclasses.fields(CameraRays)})


def view_at(views: CameraRays, k) -> CameraRays:
    return CameraRays(**{f.name: getattr(views, f.name)[k]
                         for f in dataclasses.fields(CameraRays)})


def l2_image_loss(img, target, mask=None):
    d = (img - target) ** 2
    if mask is not None:
        d = d * mask[..., None] if mask.ndim == d.ndim - 1 else d * mask
    return torch.mean(d)


def _fit_accel(scene: Scene, cfg: RenderConfig, bvh: LBVH, tree,
               refit: bool):
    """The accel a fit step hands make_finder for the realized scene:
    the tree refitted to its positions when `refit`. On the packed
    routes the tree's tensors are refitted and packed where they lie,
    in the layout cfg selects (`pack_layout`, as make_finder packs);
    the cluster routes read the LBVH on the host."""
    m = scene.mesh
    if resolve_backend(scene, cfg, bvh) in ("bvh", "bvh2"):
        if refit:
            tree = lbvh.refit(tree, m.positions, m.faces, m.face_valid)
        return pack_layout(cfg, tree, m.positions, m.faces, m.face_valid)
    return lbvh.refit(bvh, m.positions, m.faces, m.face_valid) if refit \
        else bvh


def make_fit_step(scene: Scene, cfg: RenderConfig, trainable: Sequence[str],
                  bvh: Optional[LBVH] = None,
                  loss_fn: Callable = l2_image_loss,
                  refit: bool = True,
                  render_fn: Callable = None,
                  param_reg: Callable = None,
                  param_map: Callable = None):
    """An optimization step over K target views:

      step(params, optimizer, views (K-stacked), targets (K, H, W, C), key)
        -> loss

    updates `params` (a SceneParams) in place through `optimizer`, made
    by the caller over `params.parameters()`, and returns the loss (a
    0-d tensor). The loss is the mean over the views of loss_fn(image,
    target), view i rendered by render_fn(scene, cfg, fold_in(key, i),
    finder), plus param_reg(params) when given.

    When `refit` and a BVH is given, its boxes are recomputed from the
    realized positions every step (topology fixed) and the finder is
    made once a step from that tree. The tree's arrays are uploaded once
    here; on the packed routes each step refits and packs them on the
    scene's device. Without a BVH, make_finder builds one every step.

    param_reg: a `params -> scalar` prior, taken on the stored params.
    param_map: a `params -> params` reparameterization applied inside
    the loss (gradients flow through it), e.g.
    priors.make_vertex_preconditioner; the stored params then live in
    its u-space: realize the scene with apply_params(scene,
    param_map(params)).
    Fields not in `trainable` get zero gradients (`freeze_except`)."""
    return _make_step(scene, cfg, trainable, None, bvh, loss_fn, refit,
                      render_fn, param_reg, param_map)


def make_fit_step_sharded(scene: Scene, cfg: RenderConfig,
                          trainable: Sequence[str], mesh: Mesh,
                          bvh: Optional[LBVH] = None,
                          loss_fn: Callable = l2_image_loss,
                          refit: bool = True,
                          render_fn: Callable = None,
                          param_reg: Callable = None,
                          param_map: Callable = None):
    """The view-sharded fit step (BASELINE config #5: 16 target views,
    gradient descent sharded over the ranks): make_fit_step's step, with
    the views as the data axis of `mesh` (`raypt_torch.dist`), which
    must be a mesh over "views".

    Every rank holds all K views and targets and takes the block [r K/n,
    (r+1) K/n) of them; it refits and packs its own copy of the tree,
    renders view i with fold_in(key, i), sums loss_fn over its views,
    divides by K and runs the backward. The loss and every parameter's
    gradient are then summed over the ranks (one all_reduce, after the
    backward: a reduction inside the differentiated loss would count a
    rank's gradient n times). Only then come param_reg (its gradient
    added once), freeze_except and optimizer.step(), so every rank holds
    the same parameters. A mesh over another axis, a rank outside the
    mesh and K not divisible by the mesh size raise ValueError."""
    return _make_step(scene, cfg, trainable, mesh, bvh, loss_fn, refit,
                      render_fn, param_reg, param_map)


def _make_step(scene, cfg, trainable, mesh, bvh, loss_fn, refit, render_fn,
               param_reg, param_map):
    """The fit step over the views of this rank of `mesh` (all of them
    when mesh is None)."""
    trainable = tuple(trainable)
    render_fn = render_fn or _render
    if mesh is not None:
        check_mesh(mesh, "views")
    tree = None if bvh is None else bvh.tensors(scene.mesh.positions.device)

    def step(params: SceneParams, optimizer: torch.optim.Optimizer,
             views: CameraRays, targets: torch.Tensor, key: Key):
        k_total = targets.shape[0]
        views_of = range(k_total)
        if mesh is not None:
            if k_total % mesh.size:
                raise ValueError(f"{k_total} views do not divide over "
                                 f"{mesh.size} ranks")
            k_local = k_total // mesh.size
            views_of = range(mesh.rank * k_local, (mesh.rank + 1) * k_local)
        optimizer.zero_grad()
        p = params if param_map is None else param_map(params)
        s = apply_params(scene, p)
        accel = None if bvh is None else _fit_accel(s, cfg, bvh, tree, refit)
        finder = make_finder(s, cfg, accel)
        total = 0.0
        for i in views_of:
            sv = s.replace(camera=view_at(views, i))
            img = render_fn(sv, cfg, fold_in(key, i), finder)
            total = total + loss_fn(img, targets[i])
        loss = total / k_total
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            ps = list(params.parameters())
            loss, grads = sum_over_mesh(mesh, loss, [
                torch.zeros_like(q) if q.grad is None else q.grad
                for q in ps])
            for q, g in zip(ps, grads):
                q.grad = g
        if param_reg is not None:
            reg = param_reg(params)
            reg.backward()
            loss = loss + reg.detach()
        freeze_except(params, trainable)
        optimizer.step()
        return loss

    return step


def _render(scene: Scene, cfg: RenderConfig, key: Key, finder):
    """Mean of cfg.samples_per_pixel passes of frame 0 of `key`."""
    fkey = frame_key(key, 0)
    acc = torch.zeros((cfg.height, cfg.width, 3),
                      device=scene.mesh.positions.device)
    for s in range(cfg.samples_per_pixel):
        acc = acc + render_sample(scene, cfg, sample_key(fkey, s), finder)
    return acc / cfg.samples_per_pixel


def render_rgbd(scene: Scene, cfg: RenderConfig, key: Key, finder):
    """(H, W, 4): radiance, then the primary-hit depth at pixel centres
    (0 on a miss). Depth is differentiable in the vertex positions
    through `recompute_hit`: the smooth channel for recovering
    geometry."""
    rgb = _render(scene, cfg, key, finder)
    dev = scene.mesh.positions.device
    jitter = torch.full((cfg.height, cfg.width, 2), 0.5, device=dev)
    ro, rd = camera_rays_for_ids(scene, cfg, pixel_id_grid(cfg, dev), jitter)
    rd = normalize(rd)
    act = torch.ones(rd.shape[:-1], dtype=torch.bool, device=dev)
    hit = recompute_hit(scene, ro, rd, finder(scene, ro, rd, active=act))
    depth = torch.where(hit.valid, hit.t, torch.zeros_like(hit.t))
    return torch.cat([rgb, depth[..., None]], dim=-1)


def fit(scene: Scene, cfg: RenderConfig, views: Sequence[CameraRays],
        targets: torch.Tensor, trainable: Sequence[str],
        steps: int = 100, learning_rate: float = 1e-2,
        bvh: Optional[LBVH] = None, key: Optional[Key] = None,
        resample_noise: bool = False, callback=None, mesh=None):
    """Run inverse rendering from SceneParams.init(scene) with
    torch.optim.Adam(lr=learning_rate) (optax's defaults: betas 0.9,
    0.999, eps 1e-8); returns (params, losses).

    resample_noise=False keeps the RNG streams fixed across steps (a zero
    loss floor when the targets were rendered with the same key); True
    folds the step index into the key for fresh noise every step.
    callback(i, params, loss) runs after each step. mesh: a
    `raypt_torch.dist` Mesh over the "views" axis shards the target
    views over its ranks (make_fit_step_sharded; BASELINE config #5)."""
    key = key if key is not None else make_key(0)
    params = SceneParams.init(scene)
    optimizer = torch.optim.Adam(params.parameters(), lr=learning_rate)
    stacked = stack_views(list(views))
    step_fn = _make_step(scene, cfg, trainable, mesh, bvh, l2_image_loss,
                         True, None, None, None)
    losses = []
    for i in range(steps):
        k = fold_in(key, i) if resample_noise else key
        loss = float(step_fn(params, optimizer, stacked, targets, k))
        losses.append(loss)
        if callback is not None:
            callback(i, params, loss)
    return params, losses
