"""Row-sharded rendering and gradient reduction over torch.distributed
(`raypt/dist/sharding.py`).

The JAX package shards inside one process, with `shard_map` over a
device mesh and `psum`. Here every rank is a process of its own: it
renders its slab of the image, or differentiates its slab's loss, and
the ranks meet in collectives of a process group.

  * Rows are the shard axis. H is padded to a multiple of the mesh size
    with duplicate pixel ids; rank s renders the INTERLEAVED rows {s,
    s+n, s+2n, ...} (`_strided_row_perm`), and the padded rows are
    dropped after the gather. RNG is pixel-id keyed, so the sharded
    image is bitwise equal to the one-process `render_frame` on every
    finder that is exact per ray. A loss over a slab must be invariant
    to a permutation of its rows.
  * Gradients are summed over the ranks AFTER the backward, as one
    flattened buffer in a fixed order: the loss first, then each
    gradient in the order of the parameters.
  * The backend is a fixed rule (`pick_backend`): NCCL where every rank
    on a host has a card of its own, gloo where ranks share one card or
    the tensors lie on the CPU (NCCL refuses two ranks on one card).
    Gloo's all_reduce and all_gather take CUDA tensors, so no collective
    is staged through the host.
  * A mesh carries its axis name, and each sharded function takes only
    its own, as shard_map's partition specs do: the renders and
    `loss_and_grad_sharded` shard "tiles", the fit step "views".
"""
from __future__ import annotations

import dataclasses
import datetime
import sys
from typing import Optional

import torch
import torch.distributed as dist

from ..accel import lbvh
from ..accel.ctree import OnehotAccel, build_onehot
from ..core.types import RenderConfig, Scene
from ..render.integrator import (make_finder, pixel_id_grid, render_sample,
                                 resolve_backend)
from ..rng.sampler import Key, frame_key, sample_key

# seconds a rendezvous or a collective may wait before it fails
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that shard one computation (`jax.sharding.Mesh` with one
    axis): the process group (None on a one-process mesh, which runs no
    collective), its size, this process's rank in it (-1 outside it)
    and the axis name ("tiles" or "views")."""
    group: Optional[object]
    size: int
    rank: int
    axis: str = "tiles"


def pick_backend(device, num_processes: int, num_cards: int,
                 local_processes: Optional[int] = None) -> str:
    """NCCL where every rank has a card of its own: the ranks on this
    host (`local_processes`; all `num_processes` ranks when None, one
    host) are no more than its `num_cards` cards. Gloo where ranks share
    a card or the tensors lie on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = num_processes if local_processes is None else local_processes
    return "nccl" if num_cards >= local else "gloo"


def local_device(device="cuda") -> torch.device:
    """This process's device: for "cuda", card (rank % cards) of the
    host, the rank being the default group's (0 with none)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     timeout: float = TIMEOUT_S,
                     local_processes: Optional[int] = None) -> Optional[str]:
    """Join the default process group (`jax.distributed.initialize`):
    `coordinator` is "host:port" (tcp://) or an init URL such as
    file:///path. No coordinator: a no-op, one process (returns None).
    Otherwise returns the backend, picked by `pick_backend` for
    `device` and the ranks on this host (`local_processes`, all of them
    when None), logged on stderr. Ranks are numbered host by host. A
    rendezvous or collective that waits longer than `timeout` seconds
    fails; nothing is swallowed."""
    if coordinator is None:
        return None
    n = num_processes or 1
    rank = process_id or 0
    local = local_processes or n
    cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    backend = pick_backend(device, n, cards, local)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    share = "one card a rank" if backend == "nccl" else "ranks share a card"
    why = (f"{local} of {n} ranks on this host's {cards} card(s): {share}"
           if cuda else "tensors on the CPU")
    print(f"raypt_torch.dist: rank {rank} of {n}, backend {backend} ({why})",
          file=sys.stderr, flush=True)
    if cuda:
        torch.cuda.set_device(rank % cards)
    dist.init_process_group(backend, init_method=url, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return backend


def default_mesh(n: Optional[int] = None, axis: str = "tiles") -> Mesh:
    """A mesh over the first n ranks of the default group (all of them
    when n is None or 0); every rank of the group must call it. With no
    group initialised, the one-process mesh."""
    if not dist.is_initialized():
        if n not in (None, 0, 1):
            raise ValueError(f"a mesh of {n} ranks needs a process group")
        return Mesh(None, 1, 0, axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(group, n, rank if rank < n else -1, axis)


def _pad_rows(h: int, n: int) -> int:
    return (-h) % n


def _strided_row_perm(h_padded: int, n: int, device=None) -> torch.Tensor:
    """Row permutation giving shard s the INTERLEAVED rows {s, s+n, ...}:
    adjacent rows carry near-identical work, so striding balances the
    shards (a contiguous band does not: the subject sits mid-frame)."""
    rows_per = h_padded // n
    return (torch.arange(n, device=device)[:, None]
            + n * torch.arange(rows_per, device=device)[None, :]).reshape(-1)


def _prep_backend(scene: Scene, cfg: RenderConfig, bvh):
    """The resolved backend and its accel, built once before the shards:
    the LBVH for "bvh" when none is given, the onehot accel at
    cfg.onehot_leaf for "onehot" when given no OnehotAccel."""
    backend = resolve_backend(scene, cfg, bvh)
    m = scene.mesh
    if backend == "bvh" and bvh is None:
        bvh = lbvh.build(m.positions, m.faces, m.face_valid)
    elif backend == "onehot" and not isinstance(bvh, OnehotAccel):
        the_bvh = bvh if isinstance(bvh, lbvh.LBVH) else \
            lbvh.build(m.positions, m.faces, m.face_valid)
        bvh = build_onehot(the_bvh, m.positions, m.faces, m.face_valid,
                           leaf=cfg.onehot_leaf)
    return backend, bvh


def check_mesh(mesh: Mesh, axis: str) -> None:
    """Raise ValueError unless this rank is in `mesh` and the mesh
    shards `axis` (shard_map's P(axis) needs a mesh with that axis)."""
    if mesh.axis != axis:
        raise ValueError(f"a mesh over {mesh.axis!r}, where {axis!r} is "
                         f"sharded")
    if mesh.rank < 0:
        raise ValueError("this rank is not in the mesh")


def _shard_rows(cfg: RenderConfig, mesh: Mesh, device):
    """(the pixel ids, padded to a multiple of the mesh size with
    duplicate ids, the row permutation, this rank's rows of it)."""
    ids = pixel_id_grid(cfg, device)
    pad = _pad_rows(cfg.height, mesh.size)
    if pad:
        ids = torch.cat([ids, ids[:pad]], dim=0)
    perm = _strided_row_perm(ids.shape[0], mesh.size, device)
    rows = ids.shape[0] // mesh.size
    return ids, perm, perm[mesh.rank * rows:(mesh.rank + 1) * rows]


def _all_gather(mesh: Mesh, slab: torch.Tensor) -> torch.Tensor:
    """(mesh.size, *slab.shape): every rank's slab, in rank order."""
    if mesh.group is None:
        return slab[None]
    parts = [torch.empty_like(slab) for _ in range(mesh.size)]
    dist.all_gather(parts, slab.contiguous(), group=mesh.group)
    return torch.stack(parts)


def sum_over_mesh(mesh: Mesh, loss: torch.Tensor, grads):
    """The loss and the gradients (a list of tensors) summed over the
    mesh's ranks with one all_reduce of a flattened buffer, the loss
    first and the gradients in their order. On a one-process mesh they
    come back as they are."""
    if mesh.group is None:
        return loss, list(grads)
    flat = torch.cat([loss.detach().reshape(1)]
                     + [g.detach().reshape(-1).to(loss.dtype) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    parts = torch.split(flat, [1] + [g.numel() for g in grads])
    return (parts[0].reshape(loss.shape),
            [p.view_as(g).to(g.dtype) for p, g in zip(parts[1:], grads)])


def render_frame_sharded(scene: Scene, cfg: RenderConfig, key: Key,
                         mesh: Mesh, frame_index=0,
                         bvh=None) -> torch.Tensor:
    """One progressive frame with rows sharded over the mesh's ranks:
    each rank renders its slab (cfg.samples_per_pixel passes, then the
    mean), the slabs are gathered, the row striding undone and the
    padding dropped. Returns the full (H, W, 3) radiance image on every
    rank, without gradient: bitwise equal to `render_frame`."""
    check_mesh(mesh, "tiles")
    backend, bvh = _prep_backend(scene, cfg, bvh)
    dev = scene.mesh.positions.device
    ids, perm, mine = _shard_rows(cfg, mesh, dev)
    ids_slab = ids[mine]
    cfg_local = cfg.replace(backend=backend)
    finder = make_finder(scene, cfg_local, bvh)
    fkey = frame_key(key, frame_index)
    with torch.no_grad():
        acc = torch.zeros(ids_slab.shape + (3,), device=dev)
        for s in range(cfg.samples_per_pixel):
            acc = acc + render_sample(scene, cfg_local, sample_key(fkey, s),
                                      finder, pixel_ids=ids_slab)
        slab = acc / cfg.samples_per_pixel
    img = _all_gather(mesh, slab).reshape(ids.shape + (3,))
    out = torch.empty_like(img)
    out[perm] = img                      # undo the row striding
    return out[:cfg.height]              # drop the padded rows


def _leaves(params):
    """(list of tensors, rebuild) for a tensor, a list / tuple or a dict
    of tensors."""
    if isinstance(params, torch.Tensor):
        return [params], lambda xs: xs[0]
    if isinstance(params, dict):
        keys = list(params)
        return [params[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(params, (list, tuple)):
        kind = type(params)
        return list(params), lambda xs: kind(xs)
    raise TypeError(f"params: a tensor, a list or a dict of tensors, not "
                    f"{type(params).__name__}")


def loss_and_grad_sharded(loss_fn, scene: Scene, params, cfg: RenderConfig,
                          mesh: Mesh, key: Key, targets: torch.Tensor,
                          bvh=None):
    """Differentiate a per-pixel loss over a row-sharded render.

    loss_fn(params, scene, cfg, key, pixel_ids, target_slab, mask_slab)
    -> a scalar sum-loss over the slab, differentiable w.r.t. params (a
    tensor, or a list or dict of tensors); mask_slab (rows,) is 0 on the
    padded rows. With a prebuilt accel `bvh` (an LBVH, a PackedLBVH or
    an OnehotAccel) loss_fn gets it as an 8th positional argument. A
    slab's rows are INTERLEAVED image rows, so loss_fn must be invariant
    to a permutation of rows (per-pixel losses are).

    Each rank takes torch.autograd.grad of its slab loss; the loss and
    the gradients are then summed over the ranks (`sum_over_mesh`).
    Returns (loss, grads), grads shaped as params, the same on every
    rank."""
    check_mesh(mesh, "tiles")
    if bvh is not None:
        _, bvh = _prep_backend(scene, cfg, bvh)
    dev = scene.mesh.positions.device
    ids, _, mine = _shard_rows(cfg, mesh, dev)
    mask = torch.ones((cfg.height,), dtype=torch.float32, device=dev)
    pad = ids.shape[0] - cfg.height
    if pad:
        targets = torch.cat([targets, targets.new_zeros(
            (pad,) + tuple(targets.shape[1:]))], dim=0)
        mask = torch.cat([mask, mask.new_zeros(pad)])
    leaves, rebuild = _leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    args = (rebuild(leaves), scene, cfg, key, ids[mine], targets[mine],
            mask[mine])
    loss = loss_fn(*args) if bvh is None else loss_fn(*args, bvh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    loss, grads = sum_over_mesh(mesh, loss.detach(), grads)
    return loss, rebuild(grads)
