"""The path-tracing integrator (`raypt/render/integrator.py`): one
wavefront of rays per sample advances bounce by bounce in a Python loop;
termination (roulette, miss) is an `alive` mask. The closest-hit finder
runs without autograd and shading recomputes the hit differentiably,
so `loss.backward()` of an image reaches mesh positions and materials
through the shading glue only.

The port renders `backend="onehot"` with `onehot_expand > 0`; other
backends, refraction and textures raise (ROADMAP queue 1).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from ..accel.ctree import OnehotAccel, build_onehot
from ..accel.lbvh import LBVH
from ..accel.traverse import HitIds, find_closest_onehot
from ..core.math3d import lerp, normalize, reflect
from ..core.types import RenderConfig, Scene
from ..rng.sampler import (Key, bounce_uniforms, frame_key,
                           random_point_on_sphere, sample_jitter, sample_key)
from .envmap import build_env_quads, rotate_y_pi, sample_env_quads
from .shading import build_shade_tables, recompute_hit_packed

Finder = Callable[..., HitIds]


def make_finder(scene: Scene, cfg: RenderConfig, accel=None) -> Finder:
    """The onehot finder over `accel`: an OnehotAccel, or an LBVH that is
    clustered here at cfg.onehot_leaf. Its tensors move to the scene's
    device."""
    if cfg.backend != "onehot":
        raise NotImplementedError(
            f"backend {cfg.backend!r} is not ported; the port renders "
            "backend='onehot' (ROADMAP queue 1 item 10)")
    if isinstance(accel, LBVH):
        m = scene.mesh
        accel = build_onehot(accel, m.positions, m.faces, m.face_valid,
                             leaf=cfg.onehot_leaf)
    if not isinstance(accel, OnehotAccel):
        raise NotImplementedError(
            "pass an LBVH from accel.host_bvh.build_sah or an OnehotAccel: "
            "the device LBVH build is not ported (ROADMAP queue 1)")
    accel = accel.to(scene.mesh.positions.device)
    return partial(find_closest_onehot, accel=accel,
                   expand_n=cfg.onehot_expand, compact_n=cfg.onehot_compact)


def _check_supported(scene: Scene, cfg: RenderConfig) -> None:
    if cfg.enable_refraction:
        raise NotImplementedError("the refraction lobe is not ported "
                                  "(ROADMAP queue 1 item 8)")
    if scene.textures is not None:
        raise NotImplementedError("albedo textures are not ported "
                                  "(ROADMAP queue 1 item 8)")


def trace_paths(scene: Scene, cfg: RenderConfig, skey: Key,
                ro: torch.Tensor, rd: torch.Tensor, finder: Finder,
                pixel_ids: torch.Tensor, return_alive: bool = False):
    """Trace one wavefront (rd unnormalized ok) for cfg.num_bounces
    bounces -> linear radiance (..., 3); with return_alive also the
    (num_bounces,) int32 counts of rays alive at the start of each
    bounce (the segments actually traced)."""
    _check_supported(scene, cfg)
    rd = normalize(rd)
    tables = build_shade_tables(scene)
    env_quads, env_hw = build_env_quads(scene.env)

    throughput = torch.ones_like(rd)
    radiance = torch.zeros_like(rd)
    alive = torch.ones(rd.shape[:-1], dtype=torch.bool, device=rd.device)
    env_tp = torch.zeros_like(rd)   # throughput at the first miss
    env_dir = rd                    # direction at the first miss
    traced = []
    for b in range(cfg.num_bounces):
        traced.append(alive.sum(dtype=torch.int32))
        ids = finder(scene, ro, rd, active=alive)
        hit, mp = recompute_hit_packed(tables, ro, rd, ids)
        hit_now = alive & hit.valid
        miss_now = alive & ~hit.valid
        # emissive uses the throughput before the albedo multiply
        radiance = radiance + torch.where(hit_now[..., None],
                                          throughput * mp[..., 3:6],
                                          torch.zeros_like(radiance))
        # a ray misses at most once; the environment is sampled after
        # the loop for every miss at once
        env_tp = torch.where(miss_now[..., None], throughput, env_tp)
        env_dir = torch.where(miss_now[..., None], rd, env_dir)
        alive = alive & ~miss_now
        if b == cfg.num_bounces - 1:
            break   # nothing traces the next ray

        u = bounce_uniforms(skey, b, pixel_ids)
        albedo, specular = mp[..., 0:3], mp[..., 6:9]
        roughness, spec_pct = mp[..., 9], mp[..., 10]
        do_spec = (u[..., 0] < spec_pct).to(torch.float32)[..., None]
        tp_mult = lerp(albedo, specular, do_spec)
        sph = random_point_on_sphere(u[..., 1], u[..., 2])
        diffuse_dir = normalize(hit.normal + sph)
        specular_dir = normalize(reflect(rd, hit.normal))
        specular_dir = normalize(lerp(specular_dir, diffuse_dir,
                                      (roughness * roughness)[..., None]))
        new_dir = normalize(lerp(diffuse_dir, specular_dir, do_spec))
        new_ro = hit.position + hit.normal * cfg.normal_offset

        throughput = torch.where(hit_now[..., None], throughput * tp_mult,
                                 throughput)
        ro = torch.where(hit_now[..., None], new_ro, ro)
        rd = torch.where(hit_now[..., None], new_dir, rd)
        if cfg.russian_roulette:
            p = torch.amax(throughput, dim=-1)
            die = hit_now & (u[..., 3] > p)
            boost = torch.where(hit_now & ~die,
                                1.0 / torch.clamp(p, min=1e-12),
                                torch.ones_like(p))
            throughput = throughput * boost[..., None]
            alive = alive & ~die

    env = sample_env_quads(scene.env, env_quads, env_hw,
                           rotate_y_pi(env_dir) if cfg.env_yaw_pi else env_dir)
    env = torch.clamp(env, 0.0, cfg.env_radiance_clamp)
    out = radiance + env_tp * env
    if return_alive:
        return out, torch.stack(traced)
    return out


def pixel_id_grid(cfg: RenderConfig, device="cpu") -> torch.Tensor:
    """(H, W) int32 linear pixel ids (the RNG counter per pixel)."""
    return (torch.arange(cfg.height, dtype=torch.int32, device=device)[:, None]
            * cfg.width
            + torch.arange(cfg.width, dtype=torch.int32, device=device)[None, :])


def camera_rays_for_ids(scene: Scene, cfg: RenderConfig,
                        pixel_ids: torch.Tensor, jitter: torch.Tensor):
    """Primary rays for pixel ids; image row 0 is the top row."""
    h, w = cfg.height, cfg.width
    px = (pixel_ids % w).to(torch.float32)
    py = torch.div(pixel_ids, w, rounding_mode="floor").to(torch.float32)
    u = (px + jitter[..., 0]) / w
    v = 1.0 - (py + jitter[..., 1]) / h
    return scene.camera.get_ray(u, v)


def _block_order(ids: torch.Tensor, block: int = 32):
    """Block-major order of an (H, W) grid, so consecutive rays are
    spatially coherent; returns (ids, unshuffle). Scanline order when
    the grid does not tile."""
    h, w = ids.shape
    if h % block or w % block:
        return ids, lambda x: x
    flat = ids.reshape(h // block, block, w // block, block).permute(
        0, 2, 1, 3).reshape(h, w)

    def unshuffle(x):
        y = x.reshape((h // block, w // block, block, block) + x.shape[2:])
        return y.permute(0, 2, 1, 3, *range(4, y.ndim)).reshape(x.shape)

    return flat, unshuffle


def render_sample(scene: Scene, cfg: RenderConfig, skey: Key, finder: Finder,
                  pixel_ids: Optional[torch.Tensor] = None,
                  return_alive: bool = False):
    """One sample-per-pixel pass -> (H, W, 3) radiance (or (*ids, 3) for
    given pixel ids); with return_alive also the traced counts."""
    unshuffle = None
    if pixel_ids is None:
        pixel_ids, unshuffle = _block_order(
            pixel_id_grid(cfg, scene.mesh.positions.device),
            block=cfg.pixel_block)
    jitter = sample_jitter(skey, pixel_ids)
    ro, rd = camera_rays_for_ids(scene, cfg, pixel_ids, jitter)
    out = trace_paths(scene, cfg, skey, ro, rd, finder, pixel_ids,
                      return_alive=return_alive)
    traced = None
    if return_alive:
        out, traced = out
    if unshuffle is not None:
        out = unshuffle(out)
    return (out, traced) if return_alive else out


def render_frame(scene: Scene, cfg: RenderConfig, key: Key, frame_index=0,
                 finder: Optional[Finder] = None, accel=None) -> torch.Tensor:
    """Mean of cfg.samples_per_pixel passes -> (H, W, 3) radiance."""
    if finder is None:
        finder = make_finder(scene, cfg, accel)
    fkey = frame_key(key, frame_index)
    acc = torch.zeros((cfg.height, cfg.width, 3),
                      device=scene.mesh.positions.device)
    for s in range(cfg.samples_per_pixel):
        acc = acc + render_sample(scene, cfg, sample_key(fkey, s), finder)
    return acc / cfg.samples_per_pixel


def accumulate(prev: torch.Tensor, current: torch.Tensor, frame_index: int):
    """Progressive average lerp(prev, current, 1/(frame_index + 1))."""
    t = 1.0 / (frame_index + 1.0) if frame_index > 0 else 1.0
    return lerp(prev, current, t)
