"""Parameter-space priors for inverse rendering (`raypt/diff/priors.py`):
the uniform mesh-Laplacian smoothness penalty and the Laplacian-smoothing
preconditioner ("Large Steps in Inverse Rendering of Geometry", Nicolet
et al. 2021).

The JAX package sums neighbours with a scatter-add (`.at[e0].add`). A
float scatter-add on CUDA (`index_add_`, `scatter_add_`, and the
backwards of `torch.gather` and `index_select`) adds with atomics, in no
fixed order, and a fit's gradients must be the same bit for bit from run
to run. So each vertex's neighbours go into a padded table built once on
the host, are read with an index gather (whose backward is the
sort-based accumulate of `index_put_`) and are summed column by column,
in the scatter's order: the edges where the vertex comes first, then
those where it comes second.
"""
from __future__ import annotations

import numpy as np
import torch


def mesh_edges(faces: np.ndarray, num_vertices: int):
    """Unique undirected edges (E, 2) + per-vertex degree (V,) from an
    (F, 3) int face array (invalid/padded faces should be pre-filtered
    by the caller)."""
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    deg = np.zeros(num_vertices, np.int64)
    np.add.at(deg, e[:, 0], 1)
    np.add.at(deg, e[:, 1], 1)
    return e, deg


def _neighbours(faces, face_valid, num_vertices: int):
    """The valid faces' neighbour table (V, max degree) int64, padded with
    the index V (a zero row the caller appends), each row in the order
    the JAX scatter adds: the edges (in edge order) where the vertex is
    e0, then those where it is e1; and the degree (V,)."""
    f = np.asarray(faces)
    edges, deg = mesh_edges(f[np.asarray(face_valid).astype(bool)],
                            num_vertices)
    # each edge adds x[e1] to e0, then each adds x[e0] to e1
    dst = np.concatenate([edges[:, 0], edges[:, 1]])
    src = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    width = max(int(deg.max()) if deg.size else 0, 1)
    table = np.full((num_vertices, width), num_vertices, np.int64)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    table[dst, np.arange(dst.size) - start[dst]] = src
    return table, deg


class _NeighbourSum:
    """x (V, 3) -> the sum of each vertex's neighbours' rows, in a fixed
    order, on x's device (the table is moved once a device)."""

    def __init__(self, faces, face_valid, num_vertices: int):
        table, deg = _neighbours(faces, face_valid, num_vertices)
        self.table = torch.from_numpy(table)
        self.degree = torch.from_numpy(np.maximum(deg, 1).astype(
            np.float32))[:, None]
        self.has_nbrs = torch.from_numpy(deg > 0)[:, None]

    def on(self, device):
        if self.table.device != torch.device(device):
            self.table = self.table.to(device)
            self.degree = self.degree.to(device)
            self.has_nbrs = self.has_nbrs.to(device)
        return self

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.on(x.device)
        g = torch.cat([x, torch.zeros_like(x[:1])])[self.table]
        acc = torch.zeros_like(x)
        for j in range(g.shape[1]):
            acc = acc + g[:, j]
        return acc


def make_laplacian_reg(faces, face_valid, num_vertices: int,
                       weight: float, field: str = "vertex_offsets"):
    """`params -> scalar`: uniform-Laplacian smoothness penalty
    weight * sum(||x_i - mean_{j~i} x_j||^2) / (vertices with
    neighbours), on `params.<field>` (V, 3). The neighbour table is
    built once on the host."""
    nb = _NeighbourSum(faces, face_valid, num_vertices)
    n_active = max(int(nb.has_nbrs.sum()), 1)

    def reg(params):
        x = getattr(params, field)
        nb_sum = nb(x)
        lap = torch.where(nb.has_nbrs, x - nb_sum / nb.degree,
                          torch.zeros_like(x))
        return weight * torch.sum(lap * lap) / n_active

    return reg


def make_vertex_preconditioner(faces, face_valid, num_vertices: int,
                               k: int = 10, alpha: float = 0.7,
                               field: str = "vertex_offsets"):
    """`params -> params` for make_fit_step(param_map=...): the stored
    variable u is mapped to vertex offsets through k Jacobi diffusion
    steps x <- (1 - alpha) x + alpha * neighbour_mean(x) (vertices
    without neighbours keep x), a polynomial stand-in for Nicolet et
    al.'s (I + lambda L)^-1 solve. The stored params then live in
    u-space; the realized offsets are the map applied once."""
    nb = _NeighbourSum(faces, face_valid, num_vertices)

    def smooth(x):
        for _ in range(k):
            x = torch.where(nb.has_nbrs,
                            (1.0 - alpha) * x + alpha * nb(x) / nb.degree, x)
        return x

    def pmap(params):
        return params.replace(**{field: smooth(getattr(params, field))})

    return pmap
