"""Closest hit of every ray against every triangle in Woop form
(`raypt/kernels/dense_pallas.py`, `pallas_closest_dense`): the kernel of
the `pallas` backend.

For each ray, o' = M o + c and d' = M d for every triangle; t = -o'_w /
d'_w where |d'_w| > 1e-12; a hit needs u, v >= 0, u + v <= 1, t > 0,
and t strictly below the ray's seed t0. Among the hits the smallest t
wins, and at equal t the lowest face id; face -1 on a miss. The Pallas
kernel reaches that rule chunk by chunk (the smallest t and lowest index
within a chunk of tri_chunk triangles, strictly smaller across chunks);
one ascending scan with a strict `<` gives the same result.

`closest_dense_plain` repeats the Pallas kernel's arithmetic as separate
elementwise ops in its order, ou = ((o0 wu0 + o1 wu1) + o2 wu2) + cu,
and so on, so that the CUDA kernel, built with -fmad=false, matches it
bit for bit. On CUDA tensors `closest_dense` launches
`csrc/dense_closest.cu`; on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import torch

from ..core.math3d import BIG, STEP_PAIRS
from ._build import launch, on_cuda

RAY_TILE = 256      # rays per padding unit (the Pallas grid step; one
                    # CUDA block)
TRI_CHUNK = 2048
BIG_I = 2 ** 30


def pick_tri_chunk(t: int) -> int:
    """Chunk = smallest multiple of 256 covering t, capped at TRI_CHUNK."""
    return min(TRI_CHUNK, max(256, -(-t // 256) * 256))


def prepare_woop_mats(woop, tri_chunk: int = TRI_CHUNK):
    """Split WoopTris (T, 3, 3) + (T, 3) into the kernel's six matrices,
    wu/wv/ww (3, T') and cu/cv/cw (1, T'), T' = T padded with zero maps
    to a multiple of tri_chunk."""
    t = woop.num_tris
    pad = (-t) % tri_chunk
    m, c = woop.m, woop.c
    if pad:
        m = torch.cat([m, torch.zeros((pad, 3, 3), device=m.device)])
        c = torch.cat([c, torch.zeros((pad, 3), device=c.device)])
    # m[t, i, j]: output component i from input component j
    wu, wv, ww = (m[:, i, :].T.contiguous() for i in range(3))
    cu, cv, cw = (c[:, i].reshape(1, -1).contiguous() for i in range(3))
    return wu, wv, ww, cu, cv, cw


def closest_dense_plain(wu, wv, ww, cu, cv, cw, ro, rd, t0,
                        tri_chunk: int = TRI_CHUNK):
    """The Pallas kernel's body in torch: rays in blocks, triangles in
    chunks of tri_chunk, the chunk merge as in the kernel."""
    r, t_all = ro.shape[0], wu.shape[1]
    tb = t0.clone()
    fb = torch.full_like(t0, -1, dtype=torch.int32)
    rows = max(1, STEP_PAIRS // tri_chunk)
    for r0 in range(0, r, rows):
        o = [ro[r0:r0 + rows, k:k + 1] for k in range(3)]
        d = [rd[r0:r0 + rows, k:k + 1] for k in range(3)]
        for c0 in range(0, t_all, tri_chunk):
            sl = slice(c0, c0 + tri_chunk)

            def tr(w, x, c=None):
                y = (x[0] * w[0:1, sl] + x[1] * w[1:2, sl]) + x[2] * w[2:3, sl]
                return y if c is None else y + c[:, sl]

            ou, ov, ow = tr(wu, o, cu), tr(wv, o, cv), tr(ww, o, cw)
            du, dv, dw = tr(wu, d), tr(wv, d), tr(ww, d)
            ok = torch.abs(dw) > 1e-12
            t = torch.where(ok, -ow / torch.where(ok, dw, torch.ones_like(dw)),
                            torch.full_like(dw, BIG))
            u = ou + t * du
            v = ov + t * dv
            hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
            t = torch.where(hit, t, torch.full_like(t, BIG))
            tmin = torch.amin(t, dim=1)
            col = torch.arange(t.shape[1], dtype=torch.int32,
                               device=t.device).expand(t.shape)
            imin = torch.amin(torch.where(t <= tmin[:, None], col,
                                          torch.full_like(col, BIG_I)), dim=1)
            cur = slice(r0, r0 + rows)
            better = tmin < tb[cur]
            tb[cur] = torch.where(better, tmin, tb[cur])
            fb[cur] = torch.where(better, imin + c0, fb[cur])
    return tb, fb


def closest_dense(wu, wv, ww, cu, cv, cw, ro, rd, t0,
                  tri_chunk: int = TRI_CHUNK):
    """wu/wv/ww (3, T) f32, cu/cv/cw (1, T) f32 with T % tri_chunk == 0,
    ro/rd (R, 3) f32 (rd normalized) with R % RAY_TILE == 0, t0 (R,) f32
    seed. Returns (t (R,) f32, face (R,) int32, -1 = miss)."""
    r, t_all = ro.shape[0], wu.shape[1]
    if r % RAY_TILE:
        raise ValueError(f"R={r} must be a multiple of {RAY_TILE}")
    if t_all % tri_chunk:
        raise ValueError(f"T={t_all} must be a multiple of tri_chunk="
                         f"{tri_chunk}")
    specs = {name: (x, (3, t_all), torch.float32)
             for name, x in (("wu", wu), ("wv", wv), ("ww", ww))}
    specs.update({name: (x, (1, t_all), torch.float32)
                  for name, x in (("cu", cu), ("cv", cv), ("cw", cw))})
    specs.update(ro=(ro, (r, 3), torch.float32), rd=(rd, (r, 3), torch.float32),
                 t0=(t0, (r,), torch.float32))
    if not on_cuda(specs):
        return closest_dense_plain(wu, wv, ww, cu, cv, cw, ro, rd, t0,
                                   tri_chunk)
    t_out = torch.empty_like(t0)
    f_out = torch.empty((r,), dtype=torch.int32, device=ro.device)
    launch("rk_closest_dense", wu.data_ptr(), wv.data_ptr(), ww.data_ptr(),
           cu.data_ptr(), cv.data_ptr(), cw.data_ptr(), t_all, ro.data_ptr(),
           rd.data_ptr(), t0.data_ptr(), t_out.data_ptr(), f_out.data_ptr(), r)
    closest_dense.launches += 1
    return t_out, f_out


closest_dense.launches = 0
