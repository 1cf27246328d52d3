"""The path-tracing integrator (`raypt/render/integrator.py`): one
wavefront of rays per sample advances bounce by bounce in a Python loop;
termination (roulette, miss) is an `alive` mask. The closest-hit finder
runs without autograd and shading recomputes the hit differentiably,
so `loss.backward()` of an image reaches mesh positions and materials
through the shading glue only.

The port renders `backend="onehot"` (its branches: `onehot_expand > 0`
per-ray-exact, `onehot_expand == 0` dense-union, and with a Woop table in
the accel the Woop branch), `"cluster"`, `"bvh"` / `"bvh2"` (the packed
skip-link walk over an LBVH), `"bvh4"` (the ordered-stack walk of the
4-wide tree collapsed from an LBVH), `"bruteforce"`, `"dense"`,
`"pallas"` and `"auto"` (`resolve_backend`), with albedo textures and,
under `cfg.enable_refraction`, the dielectric lobe. The `bvh` routes
walk the table `pack_layout` chooses by `cfg.leaf_tris` and
`cfg.node_lookahead` (one, two or four triangles a leaf row, lookahead
internal rows), in `cfg.traversal_mode`.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from ..accel.clusters import CLUSTER_LEAF, Clusters, build_clusters
from ..accel.ctree import OnehotAccel, build_onehot
from ..accel.dense import WoopTris
from ..accel import lbvh
from ..accel.lbvh import LBVH, LBVHTensors
from ..accel.packed import (PACKED_TABLES, PackedLBVH, pack, pack_cherries,
                            pack_lookahead, pack_quads)
from ..accel.traverse import (KERNELS, HitIds,
                              find_closest_bruteforce,
                              find_closest_cluster, find_closest_onehot,
                              find_closest_packed, find_closest_wide,
                              recompute_hit)
from ..accel.wide import WideBVH, collapse
from ..core.math3d import (dot, lerp, normalize, reflect, refract,
                           schlick_fresnel)
from ..core.types import RenderConfig, Scene
from ..kernels.intersect import make_pallas_finder
from ..rng.sampler import (Key, bounce_uniforms, frame_key,
                           random_point_on_sphere, refraction_uniform,
                           sample_jitter, sample_key)
from .envmap import build_env_quads, rotate_y_pi, sample_env_quads
from .shading import (build_shade_tables, recompute_hit_packed,
                      sample_albedo_texture)

Finder = Callable[..., HitIds]


def resolve_backend(scene: Scene, cfg: RenderConfig, accel=None) -> str:
    """cfg.backend, with "auto" resolved as the JAX package does: a
    WoopTris -> "dense", an LBVH, PackedLBVH or WideBVH -> "bvh"; with
    none of them, by the mesh's
    padded face capacity: "dense" from 64 to 8,192 faces, "bruteforce"
    below 64, "bvh" above 8,192."""
    backend = cfg.backend
    if backend == "auto":
        faces = scene.mesh.num_faces
        if isinstance(accel, WoopTris):
            backend = "dense"
        elif isinstance(accel, (LBVH, PackedLBVH, WideBVH)):
            backend = "bvh"
        elif faces <= 8192:
            backend = "dense" if faces >= 64 else "bruteforce"
        else:
            backend = "bvh"
    return backend


def make_finder(scene: Scene, cfg: RenderConfig, accel=None) -> Finder:
    """The finder of cfg.backend (`resolve_backend`) over `accel`, moved
    to the scene's device:
      * "bruteforce": every ray against every face; no accel;
      * "dense" and "pallas": a WoopTris, or else the table built here
        from the scene's mesh (any other accel is ignored), tested
        against every ray by the dense closest-hit kernel. The JAX
        package computes "dense" with XLA products and "pallas" with its
        kernel; both return the same closest hit, so one finder serves
        both;
      * "onehot": an OnehotAccel, or an LBVH (`host_bvh.build_sah` or
        `lbvh.build`; with no accel, `lbvh.build` here) clustered here at
        cfg.onehot_leaf (without a Woop table, as in the JAX package); an
        accel built with `with_woop=True` takes the Woop branch, whatever
        cfg.onehot_expand; otherwise cfg.onehot_expand picks the branch
        (> 0 per-ray-exact, 0 dense-union);
      * "cluster": Clusters, or an LBVH (built here when none is given)
        clustered at CLUSTER_LEAF;
      * "bvh" and "bvh2": one of the four packed tables (PACKED_TABLES),
        walked as it is, or an LBVH (built here with `lbvh.build` when
        none is given) packed here by `pack_layout`, walked by the packed
        finder with cfg.traversal_tile / ray_sort / traversal_mode
        (cfg.traversal_unroll schedules the JAX package's loop only);
      * "bvh4": an LBVH (built here when none is given) collapsed here
        into the wide tree, walked by the wide finder with
        cfg.traversal_tile. Whatever the "bvh*" backend, a WideBVH is
        walked by the wide finder and a packed table by the packed one,
        as in the JAX package."""
    m = scene.mesh
    backend = resolve_backend(scene, cfg, accel)
    if backend == "bruteforce":
        return find_closest_bruteforce
    if backend in ("dense", "pallas"):
        return make_pallas_finder(scene, cfg, accel)
    if backend in ("bvh", "bvh2", "bvh4"):
        return _make_packed_finder(scene, cfg, accel, backend)
    if backend not in ("onehot", "cluster"):
        raise ValueError(f"unknown backend {backend!r}")
    if accel is None:
        accel = lbvh.build(m.positions, m.faces, m.face_valid)
    if backend == "onehot":
        if isinstance(accel, LBVH):
            accel = build_onehot(accel, m.positions, m.faces, m.face_valid,
                                 leaf=cfg.onehot_leaf)
        kind = OnehotAccel
    else:
        if isinstance(accel, LBVH):
            accel = build_clusters(accel, m.positions, m.faces, m.face_valid,
                                   leaf=CLUSTER_LEAF)
        kind = Clusters
    if not isinstance(accel, kind):
        raise TypeError(f"backend {backend!r} takes an LBVH or a "
                        f"{kind.__name__}, not {type(accel).__name__}")
    accel = accel.to(m.positions.device)
    if kind is Clusters:
        return partial(_cluster_finder, accel)
    return partial(find_closest_onehot, accel=accel,
                   expand_n=cfg.onehot_expand, compact_n=cfg.onehot_compact)


def pack_layout(cfg: RenderConfig, bvh, positions, faces, face_valid):
    """The packed table of an LBVH (or its `LBVHTensors`) in the layout
    cfg selects (`raypt/render/integrator.py:124-133`): leaf_tris >= 4
    the quad table (lookahead internal rows when node_lookahead), >= 2
    the cherry table, else node_lookahead the lookahead table, else the
    one-triangle table; on the positions' device."""
    if cfg.leaf_tris >= 4:
        return pack_quads(bvh, positions, faces, face_valid,
                          lookahead=cfg.node_lookahead)
    if cfg.leaf_tris >= 2:
        return pack_cherries(bvh, positions, faces, face_valid)
    if cfg.node_lookahead:
        return pack_lookahead(bvh, positions, faces, face_valid)
    return pack(bvh, positions, faces, face_valid)


def _make_packed_finder(scene: Scene, cfg: RenderConfig, accel,
                        backend: str):
    """make_finder's "bvh" / "bvh2" / "bvh4" route (`raypt/render/
    integrator.py:101-140`): the wide tree, or a packed table from the
    accel or packed here (`pack_layout`) from an LBVH, built here when
    none is given."""
    m = scene.mesh
    if isinstance(accel, WideBVH) or (backend == "bvh4" and not
                                      isinstance(accel, PACKED_TABLES)):
        if not isinstance(accel, WideBVH):
            if accel is None:
                accel = lbvh.build(m.positions, m.faces, m.face_valid)
            if not isinstance(accel, (LBVH, LBVHTensors)):
                raise TypeError(f"backend 'bvh4' takes an LBVH, a WideBVH "
                                f"or a packed table, not "
                                f"{type(accel).__name__}")
            accel = collapse(accel, m.positions, m.faces, m.face_valid)
        return partial(_wide_finder, accel.to(m.positions.device),
                       cfg.traversal_tile)
    if not isinstance(accel, PACKED_TABLES):
        if accel is None:
            accel = lbvh.build(m.positions, m.faces, m.face_valid)
        if not isinstance(accel, LBVH):
            raise TypeError(f"backend {backend!r} takes an LBVH or a "
                            f"packed table, not {type(accel).__name__}")
        accel = pack_layout(cfg, accel, m.positions, m.faces, m.face_valid)
    return partial(_packed_finder, accel.to(scene.mesh.positions.device),
                   cfg.traversal_tile, cfg.ray_sort, cfg.traversal_mode)


def _packed_finder(pbvh, tile, sort_rays, mode, scene: Scene, ro, rd,
                   active=None, ops=KERNELS):
    return find_closest_packed(scene, pbvh, ro, rd, active=active, tile=tile,
                               sort_rays=sort_rays, mode=mode, ops=ops)


def _wide_finder(wbvh: WideBVH, tile, scene: Scene, ro, rd, active=None,
                 ops=KERNELS):
    return find_closest_wide(scene, wbvh, ro, rd, active=active, tile=tile,
                             ops=ops)


def _cluster_finder(clusters: Clusters, scene: Scene, ro, rd, active=None):
    return find_closest_cluster(scene, clusters, ro, rd, active=active)


def trace_paths(scene: Scene, cfg: RenderConfig, skey: Key,
                ro: torch.Tensor, rd: torch.Tensor, finder: Finder,
                pixel_ids: torch.Tensor, return_alive: bool = False,
                check: Optional[Callable] = None):
    """Trace one wavefront (rd unnormalized ok) for cfg.num_bounces
    bounces -> linear radiance (..., 3); with return_alive also the
    (num_bounces,) int32 counts of rays alive at the start of each
    bounce (the segments actually traced). check(b, throughput,
    radiance), when given, sees the path state at the start of each
    bounce b (`app.debug`); it changes nothing."""
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
        if check is not None:
            check(b, throughput, radiance)
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
        if scene.textures is not None:
            tex_id = torch.round(mp[..., 11]).to(torch.int32)
            albedo = albedo * sample_albedo_texture(scene.textures, tex_id,
                                                    hit.uv)
        do_spec = (u[..., 0] < spec_pct).to(torch.float32)[..., None]
        tp_mult = lerp(albedo, specular, do_spec)
        sph = random_point_on_sphere(u[..., 1], u[..., 2])
        diffuse_dir = normalize(hit.normal + sph)
        specular_dir = normalize(reflect(rd, hit.normal))
        specular_dir = normalize(lerp(specular_dir, diffuse_dir,
                                      (roughness * roughness)[..., None]))
        new_dir = normalize(lerp(diffuse_dir, specular_dir, do_spec))
        new_ro = hit.position + hit.normal * cfg.normal_offset
        if cfg.enable_refraction:
            # dielectric lobe: reflect with Schlick probability or on
            # total internal reflection, else refract; the albedo tints
            # the path. The geometry uses a normal facing the ray
            # (sphere normals point outward).
            refr_pct = mp[..., 12]
            ior = torch.clamp(mp[..., 13], min=1.0 + 1e-6)
            do_refr = (u[..., 0] >= spec_pct) & (u[..., 0]
                                                 < spec_pct + refr_pct)
            entering = dot(rd, hit.normal) < 0.0
            n_face = torch.where(entering[..., None], hit.normal,
                                 -hit.normal)
            eta = torch.where(hit.front_face, 1.0 / ior, ior)
            cos_i = torch.clamp(-dot(rd, n_face), 0.0, 1.0)
            tir = 1.0 - eta * eta * (1.0 - cos_i * cos_i) < 0.0
            fres = schlick_fresnel(cos_i, 1.0, ior)
            u_f = refraction_uniform(skey, b, pixel_ids)
            do_reflect = tir | (u_f < fres)
            trans_dir = normalize(refract(rd, n_face, eta[..., None]))
            glass_dir = torch.where(do_reflect[..., None],
                                    normalize(reflect(rd, n_face)), trans_dir)
            new_dir = torch.where(do_refr[..., None], glass_dir, new_dir)
            tp_mult = torch.where(do_refr[..., None], albedo, tp_mult)
            # a reflected ray stays on the incident side; a transmitted
            # one steps through the surface
            off = torch.full_like(cos_i, cfg.normal_offset)
            side = torch.where(do_reflect, off, -off)
            new_ro = torch.where(do_refr[..., None],
                                 hit.position + n_face * side[..., None],
                                 new_ro)

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


def pixel_id_grid(cfg: RenderConfig, device) -> torch.Tensor:
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
                  return_alive: bool = False,
                  check: Optional[Callable] = None):
    """One sample-per-pixel pass -> (H, W, 3) radiance (or (*ids, 3) for
    given pixel ids); with return_alive also the traced counts. check
    goes to trace_paths."""
    unshuffle = None
    if pixel_ids is None:
        pixel_ids, unshuffle = _block_order(
            pixel_id_grid(cfg, scene.mesh.positions.device),
            block=cfg.pixel_block)
    jitter = sample_jitter(skey, pixel_ids)
    ro, rd = camera_rays_for_ids(scene, cfg, pixel_ids, jitter)
    out = trace_paths(scene, cfg, skey, ro, rd, finder, pixel_ids,
                      return_alive=return_alive, check=check)
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


def render_aovs(scene: Scene, cfg: RenderConfig,
                finder: Optional[Finder] = None, accel=None) -> dict:
    """Primary-hit AOVs at pixel centres (`integrator.py:431-451`):
    "depth" (H, W), "normal" and "albedo" (H, W, 3), zero where the ray
    misses, and the "hit" mask; differentiable through `recompute_hit`.
    With no finder, make_finder's over `accel`."""
    if finder is None:
        finder = make_finder(scene, cfg, accel)
    dev = scene.mesh.positions.device
    jitter = torch.full((cfg.height, cfg.width, 2), 0.5, device=dev)
    ro, rd = camera_rays_for_ids(scene, cfg, pixel_id_grid(cfg, dev), jitter)
    rd = normalize(rd)
    ids = finder(scene, ro, rd)
    hit = recompute_hit(scene, ro, rd, ids)
    albedo = scene.materials.albedo[hit.mat_id.long()]
    v3 = hit.valid[..., None]
    return {
        "depth": torch.where(hit.valid, hit.t, torch.zeros_like(hit.t)),
        "normal": torch.where(v3, hit.normal, torch.zeros_like(hit.normal)),
        "albedo": torch.where(v3, albedo, torch.zeros_like(albedo)),
        "hit": hit.valid,
    }
