"""Closest-hit finders (`raypt/accel/traverse.py`): the brute-force toy
oracle; the packed skip-link finder of the `bvh` backends
(`find_closest_packed`, over any of the four packed tables), the wide
ordered-stack finder of `bvh4`
(`find_closest_wide`) and the unpacked reference walk
(`find_closest_bvh`); the onehot finder, in its per-ray-exact branch (alive
compaction, top-tree walk, cluster expansion, uncompaction), its
dense-union branch (walk to per-tile unions, dense tile x cluster
intersection), its Woop branch (walk to per-ray masks, tile unions,
dense tile x cluster intersection with the Woop test) and its non-fused
branch (walk to per-ray masks, tile unions, ascending-id worklists, the
worklist intersection of the JAX package's XLA reference and its
residual rounds), with the options that sort the rays before or after
the walk (`sort_rays`, `segment_sort`, `onehot_sort_key`); and the
cluster finder (dense box cull into per-tile worklists, worklist
intersection, overflow fallback).

Finders return only discrete results and run without autograd; shading
recomputes the chosen hit differentiably (`render.shading` in the
integrator, `recompute_hit` for primary-hit AOVs and depth). A triangle
wins over a sphere only when strictly closer: the cluster pass is seeded
with the sphere distance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..core.math3d import (BIG, STEP_PAIRS, dot, intersect_aabb,
                           intersect_sphere, intersect_triangle, normalize)
from ..core.types import Scene
from ..kernels import cluster_expand as _expand
from ..kernels import cluster_pallas as _dense
from ..kernels import compact as _compact
from ..kernels import dense_pallas as _woop_kernel
from ..kernels import onehot_walk as _walk
from ..kernels import packed_walk as _packed
from ..kernels import wide_walk as _wide
from .clusters import (WORKLIST_CAP, Clusters, first_wanted,
                       tile_union_counts, tile_worklists, worklist_slice)
from .ctree import OnehotAccel, walk_topwalk
from .lbvh import LBVH
from .packed import (safe_reciprocal, traverse_wavefront_compact,
                     walk_layout)
from .wide import STACK_D, WideBVH, traverse_wide


@dataclasses.dataclass
class HitIds:
    """Discrete closest-hit result."""
    t: torch.Tensor        # (...,) f32 closest distance (BIG = miss)
    tri: torch.Tensor      # (...,) int32 face id, -1 if not a triangle hit
    sphere: torch.Tensor   # (...,) int32 sphere id, -1 if not a sphere hit

    @property
    def valid(self) -> torch.Tensor:
        return self.t < BIG


@dataclasses.dataclass
class Hit:
    """Differentiable hit attributes."""
    valid: torch.Tensor
    t: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor       # shading normal, faces the ray for triangles
    uv: torch.Tensor
    mat_id: torch.Tensor
    front_face: torch.Tensor


def recompute_hit(scene: Scene, ro, rd, ids: HitIds) -> Hit:
    """The chosen primitive's intersection, recomputed differentiably in
    positions, normals, uvs and sphere centres and radii
    (`traverse.py:855-903`). A triangle's shading normal is
    (1-u-v) n0 + u n1 + v n2, normalized, then flipped to face the ray;
    a sphere's is (p - centre) / radius, not flipped."""
    m = scene.mesh
    sp = scene.spheres
    is_tri = ids.tri >= 0
    is_sph = ids.sphere >= 0

    fi = torch.clamp(ids.tri, min=0).long()
    f = m.faces[fi].long()
    v0, v1, v2 = (m.positions[f[..., k]] for k in range(3))
    n0, n1, n2 = (m.normals[f[..., k]] for k in range(3))
    t0, t1, t2 = (m.uvs[f[..., k]] for k in range(3))
    _, tt, u, v = intersect_triangle(ro, rd, v0, v1, v2)
    w = 1.0 - u - v
    tri_n = normalize(w[..., None] * n0 + u[..., None] * n1
                      + v[..., None] * n2)
    backface = dot(rd, tri_n) >= 0.0
    tri_n = torch.where(backface[..., None], -tri_n, tri_n)
    tri_uv = w[..., None] * t0 + u[..., None] * t1 + v[..., None] * t2
    tri_mat = m.face_material[fi]

    si = torch.clamp(ids.sphere, min=0).long()
    c = sp.center[si]
    r = sp.radius[si]
    _, st = intersect_sphere(ro, rd, c, r)
    sph_mat = sp.material[si]

    big = torch.full_like(tt, BIG)
    t = torch.where(is_tri, tt, torch.where(is_sph, st, big))
    pos = ro + rd * t[..., None]
    sph_n = (pos - c) / torch.clamp(r, min=1e-12)[..., None]
    normal = torch.where(is_tri[..., None], tri_n,
                         torch.where(is_sph[..., None], sph_n,
                                     torch.zeros_like(sph_n)))
    uv = torch.where(is_tri[..., None], tri_uv, torch.zeros_like(tri_uv))
    mat = torch.where(is_tri, tri_mat,
                      torch.where(is_sph, sph_mat, torch.zeros_like(sph_mat)))
    front = torch.where(is_tri, ~backface, is_sph & (dot(rd, sph_n) < 0.0))
    return Hit(valid=is_tri | is_sph, t=t, position=pos, normal=normal, uv=uv,
               mat_id=mat.to(torch.int32), front_face=front)


def _closest_sphere(scene: Scene, ro, rd):
    """(t, sphere id) of the closest valid sphere, (BIG, -1) on a miss;
    the lowest id wins a tie."""
    sp = scene.spheres
    hit, t = intersect_sphere(ro.reshape(-1, 1, 3), rd.reshape(-1, 1, 3),
                              sp.center[None], sp.radius[None])
    t = torch.where(hit & sp.valid[None], t, torch.full_like(t, BIG))
    tmin = torch.amin(t, dim=1)
    col = torch.arange(t.shape[1], dtype=torch.int32,
                       device=t.device).expand(t.shape)
    imin = torch.amin(torch.where(t <= tmin[:, None], col,
                                  torch.full_like(col, 2 ** 30)), dim=1)
    i = torch.where(tmin < BIG, imin, torch.full_like(imin, -1))
    return tmin.reshape(ro.shape[:-1]), i.reshape(ro.shape[:-1])


@torch.no_grad()
def find_closest_bruteforce(scene: Scene, ro, rd, active=None) -> HitIds:
    """Every ray against every face: a toy-size oracle. rd normalized.
    Rays go in chunks of about STEP_PAIRS pairs, so that no (R, F)
    temporary is built; rays are independent, so chunking changes no
    result."""
    ts, si = _closest_sphere(scene, ro, rd)
    m = scene.mesh
    f = m.faces.long()
    p0, p1, p2 = (m.positions[f[:, k]][None] for k in range(3))
    flat_o = ro.reshape(-1, 1, 3)
    flat_d = rd.reshape(-1, 1, 3)
    step = max(1, STEP_PAIRS // max(f.shape[0], 1))
    tts, tis = [], []
    for r0 in range(0, flat_o.shape[0], step):
        hit, t, _, _ = intersect_triangle(flat_o[r0:r0 + step],
                                          flat_d[r0:r0 + step], p0, p1, p2)
        t = torch.where(hit & m.face_valid[None], t, torch.full_like(t, BIG))
        tt, ti = torch.min(t, dim=1)      # first index of the minimum
        tts.append(tt)
        tis.append(torch.where(tt < BIG, ti.to(torch.int32),
                               torch.full_like(ti, -1, dtype=torch.int32)))
    tt = torch.cat(tts).reshape(ts.shape)
    ti = torch.cat(tis).reshape(ts.shape)
    tri_wins = tt < ts
    minus1 = torch.full_like(si, -1)
    return HitIds(t=torch.minimum(ts, tt),
                  tri=torch.where(tri_wins, ti, minus1),
                  sphere=torch.where(~tri_wins & (ts < BIG), si, minus1))


class FinderOps(NamedTuple):
    """The kernel stages of the finders. KERNELS dispatches on the
    tensors' device (CUDA kernel or plain version); PLAIN always runs the
    plain torch versions, to hold the kernels against on the card.
    compact leaves its chunk counts in a scratch
    (`kernels.compact.new_counts`) that uncompact of the same mask reads."""
    compact: Callable          # onehot, per-ray-exact branch
    walk: Callable
    expand: Callable
    uncompact: Callable
    walk_union: Callable       # onehot, dense-union branch
    intersect_mask: Callable
    intersect: Callable        # cluster finder
    walk_mask: Callable        # onehot, non-fused and Woop branches
    closest_dense: Callable    # dense and pallas (kernels/intersect.py)
    intersect_woop: Callable   # onehot, Woop branch
    packed_walk: Callable      # bvh and bvh2: the table's layout's walk
    wide_walk: Callable        # bvh4
    compact_walk: Callable     # bvh, traversal_mode "compact" / "unrolled"
    # onehot, non-fused branch; cluster finder, overflow fallback and
    # use_pallas=False (intersect_worklist_jnp's rules)
    intersect_worklist: Callable


KERNELS = FinderOps(_compact.alive_compact, _walk.topwalk_cm_u,
                    _expand.cluster_expand, _compact.alive_uncompact,
                    _walk.topwalk_union, _dense.cluster_intersect_mask,
                    _dense.cluster_intersect, _walk.topwalk,
                    _woop_kernel.closest_dense,
                    _dense.cluster_intersect_mask_woop, _packed.walk_layout,
                    _wide.wide_walk, _packed.compact_walk,
                    _dense.intersect_worklist)
PLAIN = FinderOps(_compact.alive_compact_plain, _walk.topwalk_cm_u_plain,
                  _expand.cluster_expand_plain, _compact.alive_uncompact_plain,
                  _walk.topwalk_union_plain,
                  _dense.cluster_intersect_mask_plain,
                  _dense.cluster_intersect_plain, walk_topwalk,
                  _woop_kernel.closest_dense_plain,
                  _dense.cluster_intersect_mask_woop_plain, walk_layout,
                  traverse_wide, traverse_wavefront_compact,
                  _dense.intersect_worklist_plain)

# rays per padding chunk of the dense-union branch and the cluster
# finder: 8 tiles (`max(8 * TILE, RAY_TILE)` in the JAX package)
DENSE_CHUNK = max(8 * _dense.TILE, _walk.RAY_TILE)


def wavefront_inputs(scene: Scene, ro, rd, active, chunk: int):
    """Sphere pass and the flat wavefront the stages consume, padded with
    dead rays to a multiple of chunk: (flat_o, flat_d, flat_t, flat_a,
    ts, si)."""
    ts, si = _closest_sphere(scene, ro, rd)
    flat_o = ro.reshape(-1, 3)
    flat_d = rd.reshape(-1, 3)
    flat_t = ts.reshape(-1)
    flat_a = (torch.ones_like(flat_t, dtype=torch.bool) if active is None
              else active.reshape(-1))
    pad = (-flat_o.shape[0]) % chunk
    if pad:
        dev = flat_o.device
        flat_o = torch.cat([flat_o, torch.zeros((pad, 3), device=dev)])
        flat_d = torch.cat([flat_d, torch.tensor([0.0, 0.0, 1.0], device=dev)
                            .expand(pad, 3)])
        flat_t = torch.cat([flat_t, torch.full((pad,), BIG, device=dev)])
        flat_a = torch.cat([flat_a, torch.zeros((pad,), dtype=torch.bool,
                                                device=dev)])
    return (flat_o.contiguous(), flat_d.contiguous(), flat_t.contiguous(),
            flat_a.contiguous(), ts, si)


def expand_chunk(compact_n: int) -> int:
    """The per-ray-exact branch's padding chunk: a multiple of the walk
    tile and of compact_n (so compaction never switches itself off)."""
    return math.lcm(_walk.RAY_TILE, compact_n or 1)


def onehot_inputs(scene: Scene, ro, rd, active, compact_n: int):
    """wavefront_inputs of the per-ray-exact branch, padded to
    expand_chunk(compact_n)."""
    return wavefront_inputs(scene, ro, rd, active, expand_chunk(compact_n))


def _hit_ids(t_best, face, alive, n: int, ts, si) -> HitIds:
    """HitIds of the first n lanes; dead lanes miss (BIG, -1), and a
    sphere wins where no triangle did."""
    t_best = torch.where(alive, t_best, torch.full_like(t_best, BIG))[:n]
    face = torch.where(alive, face, torch.full_like(face, -1))[:n]
    t_best, face = t_best.reshape(ts.shape), face.reshape(ts.shape)
    tri_wins = face >= 0
    minus1 = torch.full_like(si, -1)
    return HitIds(t=t_best, tri=torch.where(tri_wins, face, minus1),
                  sphere=torch.where(~tri_wins & (ts < BIG), si, minus1))


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """The low 7 bits of int32 x spread to every third bit: bit k -> bit
    3k (the Morton helper of `onehot_sort_key`)."""
    x = x & 0x7F
    x = (x | (x << 8)) & 0x0100F00F
    x = (x | (x << 4)) & 0x010C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def onehot_sort_key(flat_o, flat_d, flat_a, bmin, bmax) -> torch.Tensor:
    """The onehot finder's ray-binning key (`onehot_sort_key`): dead rays
    last (1 << 30), else the 6-bit-per-axis Morton code of the origin in
    the box [bmin, bmax] (each extent at least 1e-6), then the direction
    octant (x < 0: 4, y < 0: 2, z < 0: 1). (R,) int32. As in the JAX
    package, no finder calls it."""
    ext = torch.clamp(bmax - bmin, min=1e-6)
    q = torch.clamp(((flat_o - bmin) / ext) * 64.0, 0.0, 63.0).to(torch.int32)
    m = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
         | (_spread3(q[:, 2]) << 2))
    octant = ((flat_d[:, 0] < 0).to(torch.int32) * 4
              + (flat_d[:, 1] < 0).to(torch.int32) * 2
              + (flat_d[:, 2] < 0).to(torch.int32))
    key = (m << 3) | octant
    return torch.where(flat_a, key, torch.full_like(key, 1 << 30))


SORT_MODES = ("none", "alive", "mask")


def _sort_mode(sort_rays) -> str:
    """sort_rays as a mode: False -> "none", True -> "mask" (the JAX
    package's mapping), or one of SORT_MODES; anything else raises (the
    JAX package would permute the rays and never restore them)."""
    mode = {False: "none", True: "mask"}.get(sort_rays, sort_rays)
    if mode not in SORT_MODES:
        raise ValueError(f"sort_rays must be a bool or one of {SORT_MODES}, "
                         f"got {sort_rays!r}")
    return mode


def _jax_chunk(tile_b: int, walk_tile: int, expand_n: int,
               compact_n: int) -> int:
    """The JAX package's padding chunk for these options
    (`traverse.py:556-560`)."""
    chunk = max(8 * tile_b, _walk.RAY_TILE)
    if expand_n:
        chunk = max(chunk, 8 * expand_n, walk_tile or _walk.RAY_TILE)
    if compact_n:
        chunk = max(chunk, compact_n)
    return chunk


@torch.no_grad()
def find_closest_onehot(scene: Scene, ro, rd, active=None, *,
                        accel: OnehotAccel, expand_n: int, compact_n: int,
                        use_pallas_intersect: bool = True, cap: int = 0,
                        overflow_fallback: bool = True, sort_rays="none",
                        tile_b: int = 0, segment_sort: int = 0,
                        walk_tile: int = 0,
                        ops: FinderOps = KERNELS) -> HitIds:
    """The onehot finder, routed as the JAX package routes it
    (`traverse.py:553-797`). Branches:
    - per-ray-exact (`_onehot_expand`): expand_n > 0, use_pallas_intersect,
      no Woop table, sort_rays "none" and segment_sort 0. Compact live
      rays to the front of each compact_n group (when compact_n > 0),
      walk the top tree to per-ray masks, test each ray's wanted clusters,
      restore the ray order; the CUDA expansion runs one thread per ray,
      so expand_n's value shapes nothing else.
    - otherwise the rays are sorted as asked (below), then walked: to the
      union of each 256-ray tile's wanted clusters in the walk kernel
      (ops.walk_union) when use_pallas_intersect, sort_rays "none", no
      Woop table and (walk_tile or RAY_TILE) % tile_b == 0, else to
      per-ray masks (ops.walk_mask) folded into the tiles' unions. Then
      the Woop branch (a Woop table and use_pallas_intersect: every ray
      of a tile against every cluster of its union with the Woop test),
      the dense-union branch (use_pallas_intersect: the same with the
      Moller-Trumbore test) or the non-fused branch
      (use_pallas_intersect=False: the union's first cap clusters in
      ascending id through the worklist kernel, cap WORKLIST_CAP when 0;
      with overflow_fallback, residual rounds while a tile's union holds
      more; without, a tile whose union exceeds cap may miss its hit).
      compact_n is not applied there, as in the JAX package.

    Sorting, each undone before the result is returned, so exactness is
    unaffected (each ray's mask lies inside its tile's union):
    - sort_rays "alive" (when the padded wavefront holds more than tile_b
      rays): live rays first, stably, over the whole wavefront, before
      the walk; "mask" (or True) also sorts the rays stably by
      `first_wanted` of their masks after the walk (dead rays last).
      False means "none".
    - segment_sort = g > 0, without a sort_rays sort and where g divides
      the padded wavefront: live rays first, stably, within each g-ray
      group, before the walk.
    Both partitions are `alive_compact` with group R or g (ops.compact;
    one kernel launch on the card) and are undone by ops.uncompact; the
    "mask" sort and its inverse are torch argsort and gathers.

    tile_b (a power of two, TILE when 0) and walk_tile size the TPU's
    programs in the JAX package; here they enter only the routing above,
    the "alive" threshold and the padding: with tile_b, walk_tile or
    segment_sort set, the wavefront is also padded to a multiple of the
    JAX package's chunk, so segment_sort applies where it does there. The
    CUDA blocks stay 256 rays, and no result depends on either, except
    with overflow_fallback=False, where a truncated worklist belongs to
    a 256-ray tile here and to a tile_b-ray tile there.

    The JAX package's use_pallas_walk is not taken: `ops` alone chooses
    between a kernel and its plain version (PLAIN.walk_mask is the plain
    walk that flag selects there)."""
    mode = _sort_mode(sort_rays)
    if tile_b < 0 or tile_b & (tile_b - 1):
        raise ValueError(f"tile_b must be a power of two, got {tile_b}")
    woop = accel.woop_cm is not None
    expand = (bool(expand_n) and use_pallas_intersect and not woop
              and mode == "none" and not segment_sort)
    chunk = expand_chunk(compact_n) if expand else DENSE_CHUNK
    if tile_b or walk_tile or segment_sort:
        chunk = math.lcm(chunk, _jax_chunk(tile_b or _dense.TILE, walk_tile,
                                           expand_n, compact_n))
    tile_b = tile_b or _dense.TILE
    wave = wavefront_inputs(scene, ro, rd, active, chunk)
    n = ro.reshape(-1, 3).shape[0]
    if expand:
        return _onehot_expand(scene, wave, n, accel, compact_n, ops)
    flat_o, flat_d, flat_t, flat_a, ts, si = wave
    r = flat_o.shape[0]
    do_sort = mode != "none" and r > tile_b
    group = r if do_sort else (
        segment_sort if segment_sort and r % segment_sort == 0 else 0)
    orig_a, counts = flat_a, None
    if group:   # the compaction's chunk counts, for the uncompaction
        counts = _compact.new_counts(flat_a, group)
        flat_o, flat_d, flat_t, flat_a = ops.compact(
            flat_o, flat_d, flat_t, flat_a, group, counts)
    c_total = accel.num_clusters
    num_words = -(-c_total // 32)
    inv2 = None
    if (use_pallas_intersect and mode == "none" and not woop
            and (walk_tile or _walk.RAY_TILE) % tile_b == 0):
        union = ops.walk_union(accel.table, flat_o, flat_d, flat_t, flat_a,
                               num_words)
    else:
        mask = ops.walk_mask(accel.table, flat_o, flat_d, flat_t, flat_a,
                             num_words)
        if do_sort and mode == "mask":
            skey = torch.where(flat_a, first_wanted(mask),
                               torch.full((r,), 1 << 29, dtype=torch.int32,
                                          device=mask.device))
            order2 = torch.argsort(skey, stable=True)
            inv2 = torch.empty_like(order2)
            inv2[order2] = torch.arange(r, device=order2.device)
            mask, flat_o, flat_d, flat_t, flat_a = (
                x[order2].contiguous()
                for x in (mask, flat_o, flat_d, flat_t, flat_a))
        union, union_counts = tile_union_counts(mask, _dense.TILE)
    seed = torch.where(flat_a, flat_t, torch.full_like(flat_t, -BIG))
    if use_pallas_intersect and woop:
        t_best, packed = ops.intersect_woop(union, accel.woop_cm, flat_o,
                                            flat_d, seed)
        face = torch.where(packed >= 0,
                           accel.fid_flat[torch.clamp(packed, min=0).long()],
                           torch.full_like(packed, -1))
    elif use_pallas_intersect:
        t_best, face = ops.intersect_mask(union, accel.clusters.tri_rows,
                                          flat_o, flat_d, seed)
    else:
        t_best, face = _onehot_unfused(accel, union, union_counts, flat_o,
                                       flat_d, seed, cap or WORKLIST_CAP,
                                       overflow_fallback, ops)
    if inv2 is not None:
        t_best, face = t_best[inv2], face[inv2]
    if group:
        t_best, face = ops.uncompact(t_best, face, orig_a, group, counts)
    return _hit_ids(t_best, face, orig_a, n, ts, si)


def _onehot_expand(scene: Scene, wave, n: int, accel: OnehotAccel,
                   compact_n: int, ops: FinderOps) -> HitIds:
    """The per-ray-exact branch (`traverse.py:619-667`) on the padded
    wavefront (a multiple of the walk tile and of compact_n, so
    compaction never switches itself off): mask words padded to 8, dead
    rays seed -BIG."""
    if scene.mesh.num_faces >= 1 << 24:
        raise ValueError("face ids must stay below 2^24")
    flat_o, flat_d, flat_t, flat_a, ts, si = wave
    orig_a = flat_a
    counts = None   # the compaction's chunk counts, for the uncompaction
    if compact_n:
        counts = _compact.new_counts(flat_a, compact_n)
        flat_o, flat_d, flat_t, flat_a = ops.compact(
            flat_o, flat_d, flat_t, flat_a, compact_n, counts)
    cwp = -(-accel.num_clusters // 256) * 8     # words, padded to 8
    mask_cm, union_pp = ops.walk(accel.table, flat_o, flat_d, flat_t, flat_a,
                                 cwp)
    seed = torch.where(flat_a, flat_t, torch.full_like(flat_t, -BIG))
    t_best, face = ops.expand(mask_cm, union_pp, accel.clusters.tri_rows,
                              flat_o, flat_d, seed)
    if compact_n:
        t_best, face = ops.uncompact(t_best, face, orig_a, compact_n, counts)
    return _hit_ids(t_best, face, orig_a, n, ts, si)


def _onehot_unfused(accel: OnehotAccel, union, counts, flat_o, flat_d, seed,
                    cap: int, overflow_fallback: bool, ops: FinderOps):
    """The non-fused branch's intersection (`traverse.py:730-782`): the
    first cap clusters of each 256-ray tile's union in ascending id
    through ops.intersect_worklist; with overflow_fallback, where C > cap
    and a tile's union holds more than cap clusters (deciding costs one
    host read of the largest count), bounded residual rounds take the
    next cap each, seeded with the result so far, until the largest
    union is covered; a round's result replaces the carry only where it
    found a face. Returns (t, face) of the wavefront."""
    c_total = accel.num_clusters
    rows = accel.clusters.tri_rows

    def isect(round_, t_in):
        return ops.intersect_worklist(
            worklist_slice(union, c_total, cap, round_), rows, flat_o, flat_d,
            t_in)

    t_best, face = isect(0, seed)
    if not overflow_fallback or c_total <= cap:
        return t_best, face
    for r in range(1, -(-int(counts.max()) // cap)):
        t_r, f_r = isect(r, t_best)
        keep = f_r >= 0
        t_best = torch.where(keep, t_r, t_best)
        face = torch.where(keep, f_r, face)
    return t_best, face


@torch.no_grad()
def find_closest_cluster(scene: Scene, clusters: Clusters, ro, rd,
                         active=None, use_pallas: bool = True, cap: int = 0,
                         ops: FinderOps = KERNELS) -> HitIds:
    """The two-level cluster finder (`traverse.py:361-430`): a dense box
    cull gives each 256-ray tile a nearest-first worklist of at most cap
    clusters (WORKLIST_CAP when 0); the worklist kernel tests every ray
    of the tile against them (ops.intersect; with use_pallas=False,
    ops.intersect_worklist, the JAX package's XLA reference and its tie
    rule, over every slot), and a tile whose cull found more than cap
    clusters is re-intersected against every cluster with
    ops.intersect_worklist (the JAX package's lax.cond fallback).
    Deciding whether to run the fallback reads one flag back to the
    host."""
    cap = cap or WORKLIST_CAP
    tile = _dense.TILE
    flat_o, flat_d, flat_t, flat_a, ts, si = wavefront_inputs(
        scene, ro, rd, active, DENSE_CHUNK)
    # dead rays contribute no clusters and accept no hits
    seed = torch.where(flat_a, flat_t, torch.full_like(flat_t, -BIG))
    wl, cnt, overflow = tile_worklists(clusters, flat_o, flat_d, seed, tile,
                                       cap)
    rows = clusters.tri_rows
    if use_pallas:
        t_best, face = ops.intersect(wl, cnt, rows, flat_o, flat_d, seed)
    else:
        t_best, face = ops.intersect_worklist(wl, rows, flat_o, flat_d, seed)
    if bool(overflow.any()):
        ov = torch.nonzero(overflow).flatten()
        rays = (ov[:, None] * tile + torch.arange(tile, device=ov.device)
                ).flatten()
        c_total = clusters.num_clusters
        every = torch.arange(c_total, dtype=torch.int32, device=ov.device
                             ).expand(ov.numel(), c_total).contiguous()
        t_fb, f_fb = ops.intersect_worklist(
            every, rows, flat_o[rays].contiguous(), flat_d[rays].contiguous(),
            seed[rays].contiguous())
        t_best = t_best.index_copy(0, rays, t_fb)
        face = face.index_copy(0, rays, f_fb)
    return _hit_ids(t_best, face, flat_a, ro.reshape(-1, 3).shape[0], ts, si)


def sort_wavefront(flat_d: torch.Tensor, flat_a: torch.Tensor):
    """Stable permutation putting live rays first, in their order, and
    dead rays last: (order, inv). flat_d is not part of the key; the
    JAX package keeps it in the signature."""
    del flat_d
    order = torch.argsort((~flat_a).to(torch.int32), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return order, inv


def _walk_hit_ids(t_best, face, ts, si) -> HitIds:
    """HitIds of a walk seeded with the sphere pass (ts, si): the walk's
    t, its face where it found one, else the sphere where one was hit.
    Dead rays keep the sphere's t."""
    t_best, face = t_best.reshape(ts.shape), face.reshape(ts.shape)
    tri_wins = face >= 0
    minus1 = torch.full_like(si, -1)
    return HitIds(t=t_best, tri=torch.where(tri_wins, face, minus1),
                  sphere=torch.where(~tri_wins & (ts < BIG), si, minus1))


def _pad_rays(flat_o, flat_d, flat_t, flat_a, tile: int):
    """The flat wavefront padded with dead rays (origin 0, direction +z,
    t BIG) to a multiple of tile, when tile is set and below its length,
    as the JAX finders pad for their tiled loops."""
    n = flat_o.shape[0]
    pad = (-n) % tile if tile and n > tile else 0
    if pad:
        dev = flat_o.device
        flat_o = torch.cat([flat_o, torch.zeros((pad, 3), device=dev)])
        flat_d = torch.cat([flat_d, torch.tensor(
            [0.0, 0.0, 1.0], device=dev).expand(pad, 3)])
        flat_t = torch.cat([flat_t, torch.full((pad,), BIG, device=dev)])
        flat_a = torch.cat([flat_a, torch.zeros((pad,), dtype=torch.bool,
                                                device=dev)])
    return (flat_o.contiguous(), flat_d.contiguous(), flat_t.contiguous(),
            flat_a.contiguous())


@torch.no_grad()
def find_closest_packed(scene: Scene, pbvh, ro, rd, active=None,
                        tile: int = 0, sort_rays: bool = False,
                        mode: str = "tiled",
                        ops: FinderOps = KERNELS) -> HitIds:
    """The packed finder (`traverse.py:195-277`) over a PackedLBVH,
    Packed2LBVH, PackedLALBVH or Packed4LBVH: spheres first, then one
    skip-link walk of the table's layout seeded with the sphere t, so a
    triangle wins only when strictly closer. Dead rays (`active`) keep
    the sphere's t and take no triangle.

    Mode "compact" / "unrolled": ops.compact_walk (the plain compacting
    walk, or on the card the table's kernel, one launch), without sort
    or tile, as in the JAX package. Any other mode is "tiled": sort_rays
    puts live rays first (`sort_wavefront`) and tile pads the wavefront
    with dead rays (origin 0, direction +z, t BIG) to a multiple of tile,
    as the JAX package does; both only schedule its XLA loop, as its
    `unroll` does (which no walk here takes). The whole wavefront goes to
    ops.packed_walk in one call (one kernel launch on the card). Rays
    are independent, so every mode and setting gives the same result."""
    ts, si = _closest_sphere(scene, ro, rd)
    flat_o = ro.reshape(-1, 3)
    flat_d = rd.reshape(-1, 3)
    flat_t = ts.reshape(-1)
    flat_a = (torch.ones_like(flat_t, dtype=torch.bool) if active is None
              else active.reshape(-1))
    n = flat_o.shape[0]
    if mode in ("compact", "unrolled"):
        t_best, face = ops.compact_walk(
            pbvh, *_pad_rays(flat_o, flat_d, flat_t, flat_a, 0))
        return _walk_hit_ids(t_best, face, ts, si)
    inv = None
    if sort_rays and n > 1:
        order, inv = sort_wavefront(flat_d, flat_a)
        flat_o, flat_d, flat_t, flat_a = (x[order] for x in
                                          (flat_o, flat_d, flat_t, flat_a))
    t_best, face = ops.packed_walk(
        pbvh, *_pad_rays(flat_o, flat_d, flat_t, flat_a, tile))
    t_best, face = t_best[:n], face[:n]
    if inv is not None:
        t_best, face = t_best[inv], face[inv]
    return _walk_hit_ids(t_best, face, ts, si)


@torch.no_grad()
def find_closest_wide(scene: Scene, wbvh: WideBVH, ro, rd, active=None,
                      tile: int = 0, stack_d: int = 0,
                      ops: FinderOps = KERNELS) -> HitIds:
    """The wide finder (`traverse.py:280-336`): spheres first, then one
    ordered-stack walk of the whole wavefront (one kernel launch on the
    card) seeded with the sphere t, so a triangle wins only when
    strictly closer; dead rays keep the sphere's t and take no triangle.
    tile pads the wavefront with dead rays to a multiple of tile and
    changes no result (rays are independent). Rays whose stack of
    stack_d entries (STACK_D when 0) overflowed are walked again, alone,
    with a stack 4x deeper, and take that result; every other ray keeps
    its first one. Deciding whether to retry reads one flag back to the
    host (the JAX package's lax.cond)."""
    stack_d = stack_d or STACK_D
    ts, si = _closest_sphere(scene, ro, rd)
    flat_a = (torch.ones(ts.numel(), dtype=torch.bool, device=ts.device)
              if active is None else active.reshape(-1))
    n = flat_a.shape[0]
    flat_o, flat_d, flat_t, flat_a = _pad_rays(
        ro.reshape(-1, 3), rd.reshape(-1, 3), ts.reshape(-1), flat_a, tile)
    t_best, face, ovf = ops.wide_walk(wbvh, flat_o, flat_d, flat_t, flat_a,
                                      stack_d)
    if bool(ovf.any()):
        t2, f2, _ = ops.wide_walk(wbvh, flat_o, flat_d, flat_t,
                                  flat_a & ovf, 4 * stack_d)
        t_best = torch.where(ovf, t2, t_best)
        face = torch.where(ovf, f2, face)
    return _walk_hit_ids(t_best[:n], face[:n], ts, si)


def _traverse_one(bvh: LBVH, p0, p1, p2, face_valid, o, d, t0):
    """The unpacked skip-link walk (`traverse.py:158-192`) of a batch of
    rays o, d (R, 3) from t0 (R,) (the JAX package vmaps it over single
    rays): every node, leaves too, is box-tested first, a leaf's
    triangle (p0/p1/p2/face_valid in leaf order) is taken when strictly
    nearer. Returns (t_best, best leaf, -1 = none)."""
    dev = o.device
    n_leaf = bvh.num_leaves
    leaf_base = n_leaf - 1
    left, skip = (torch.from_numpy(a.astype("int64")).to(dev)
                  for a in (bvh.left, bvh.skip))
    bmin, bmax = (torch.from_numpy(a).to(dev) for a in (bvh.bmin, bvh.bmax))
    inv_d = safe_reciprocal(d)
    node = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
    t_best = t0.clone()
    best_leaf = torch.full_like(node, -1)
    live = torch.arange(o.shape[0], device=dev)
    while live.numel():
        nd = node[live]
        ol, dl, tb = o[live], d[live], t_best[live]
        hit_box = intersect_aabb(ol, inv_d[live], bmin[nd], bmax[nd], tb)
        is_leaf = nd >= leaf_base
        leaf = torch.clamp(nd - leaf_base, 0, n_leaf - 1)
        h, t, _, _ = intersect_triangle(ol, dl, p0[leaf], p1[leaf], p2[leaf])
        take = is_leaf & hit_box & h & face_valid[leaf] & (t < tb)
        t_best[live] = torch.where(take, t, tb)
        best_leaf[live] = torch.where(take, leaf, best_leaf[live])
        nxt = torch.where(hit_box & ~is_leaf, left[nd], skip[nd])
        node[live] = nxt
        live = live[nxt >= 0]
    return t_best, best_leaf


@torch.no_grad()
def find_closest_bvh(scene: Scene, bvh: LBVH, ro, rd,
                     tile: int = 4096) -> HitIds:
    """The unpacked reference walk (`traverse.py:805-849`) over an LBVH,
    in plain torch: the oracle the packed finder is tested against. No
    `make_finder` route reaches it, in either package, so it has no
    kernel. tile only schedules the JAX package's loops and changes no
    result."""
    del tile
    m = scene.mesh
    dev = ro.device
    lf = torch.from_numpy(bvh.leaf_face.astype("int64")).to(dev)
    f = m.faces.long()[lf]
    p0, p1, p2 = (m.positions[f[:, k]] for k in range(3))
    ts, si = _closest_sphere(scene, ro, rd)
    t_best, best_leaf = _traverse_one(bvh, p0, p1, p2, m.face_valid[lf],
                                      ro.reshape(-1, 3), rd.reshape(-1, 3),
                                      ts.reshape(-1))
    t_best = t_best.reshape(ts.shape)
    best_leaf = best_leaf.reshape(ts.shape)
    tri_wins = best_leaf >= 0
    minus1 = torch.full_like(si, -1)
    tri = torch.where(tri_wins, lf[torch.clamp(best_leaf, min=0)].to(
        torch.int32), minus1)
    return HitIds(t=t_best, tri=tri,
                  sphere=torch.where(~tri_wins & (ts < BIG), si, minus1))

