"""The merge rules of the cluster kernels, on synthetic clusters with
planted ties (`chip_smoke.merge_case`): a triangle copied into a higher
cluster with a lower face id, where the lower cluster must win because a
cluster replaces a ray's carry only when strictly nearer, and a triangle
copied within its cluster, where the lower face id must win. The JAX
kernels in interpret mode and the port's plain versions must agree on
both, on every live ray, and leave every ray whose seed is not > 0 at
(seed, -1). The Woop kernel takes the same clusters as its (C, 4, 3L)
table, which each package builds with its own `build_woop_cm` (float64
on the host in both, so the tables are bitwise equal); its rules keep
the lower cluster across clusters and take the lower lane within one
(`chip_smoke.woop_merge`). The worklist kernel takes the same clusters
as worklists (`chip_smoke.worklist_merge`: each tile's wanted clusters
in descending or ascending id, counts at, above and below the list's
length), where the earlier slot wins a tie across clusters.
test_torch_gpu.py holds the CUDA kernels against the plain versions on
the same inputs."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel.clusters import build_woop_cm as jax_build_woop_cm
from raypt.kernels.cluster_expand import pallas_cluster_expand
from raypt.kernels.cluster_pallas import (pallas_cluster_intersect,
                                          pallas_cluster_intersect_mask,
                                          pallas_cluster_intersect_mask_woop)

from raypt_torch.kernels import cluster_expand as tex
from raypt_torch.kernels import cluster_pallas as tdn

from chip_smoke import (WOOP_ODD_LEAF, check_planted, merge_case, woop_faces,
                        woop_merge, worklist_merge)

torch.set_num_threads(2)


def _jax_run(kernel, case):
    j = {k: jnp.asarray(case[k].numpy()) for k in
         ("mask_cm", "union_pp", "union", "ro", "rd", "seed")}
    rows = jnp.transpose(jnp.asarray(case["tri_rows"].numpy()), (0, 2, 1))
    if kernel == "expand":
        out = pallas_cluster_expand(j["mask_cm"], rows, j["ro"], j["rd"],
                                    j["seed"], interpret=True, n_rays=256,
                                    union_pp=j["union_pp"])
    elif kernel == "woop":
        # the JAX kernel guards only the last union word: without the
        # extra word of ones
        woop_cm, _ = jax_build_woop_cm(SimpleNamespace(
            tri_rows=jnp.asarray(case["tri_rows"].numpy())))
        cw = -(-case["tri_rows"].shape[0] // 32)
        out = pallas_cluster_intersect_mask_woop(
            j["union"][:, :cw], woop_cm, j["ro"], j["rd"], j["seed"],
            interpret=True)
    elif kernel == "worklist":
        wl, counts, _ = worklist_merge(case, seed=1)
        out = pallas_cluster_intersect(jnp.asarray(wl.numpy()),
                                       jnp.asarray(counts.numpy()), rows,
                                       j["ro"], j["rd"], j["seed"],
                                       interpret=True)
    else:
        out = pallas_cluster_intersect_mask(j["union"], rows, j["ro"], j["rd"],
                                            j["seed"], interpret=True)
    return tuple(torch.from_numpy(np.array(x)) for x in out)


def _woop_slack(case, packed):
    """Per ray, the float32 rounding bound of the gap between two orders
    of evaluating its winning triangle's t = -o'w / d'w (the JAX kernel's
    product, the port's left-to-right sums): each 4-term sum is off by at
    most 4 eps of its terms' magnitudes, so two orders by 8 eps, and t by
    8 eps (S_o + |t| S_d) / |d'w|. It matters only for rays nearly
    parallel to the triangle's plane (d'w small against its terms); 0
    where no triangle won."""
    woop_cm = woop_merge(case)[0].double().numpy()
    leaf = woop_cm.shape[2] // 3
    p = packed.numpy()
    hit = p >= 0
    c, j = np.divmod(np.where(hit, p, 0), leaf)
    a = woop_cm[c, :, 2 * leaf + j]                # (R, 4): the w row
    o = case["ro"].double().numpy()
    d = case["rd"].double().numpy()
    s_o = np.abs(a[:, :3] * o).sum(1) + np.abs(a[:, 3])
    s_d = np.abs(a[:, :3] * d).sum(1)
    dw = (a[:, :3] * d).sum(1)
    t = -((a[:, :3] * o).sum(1) + a[:, 3]) / np.where(hit, dw, 1.0)
    eps = 2.0 ** -24
    slack = 8 * eps * (s_o + np.abs(t) * s_d) / np.abs(np.where(hit, dw, 1.0))
    return torch.from_numpy(np.where(hit, slack, 0.0))


def _port_run(kernel, case):
    rays = (case["ro"], case["rd"], case["seed"])
    if kernel == "expand":
        return tex.cluster_expand(case["mask_cm"], case["union_pp"],
                                  case["tri_rows"], *rays)
    if kernel == "woop":
        return tdn.cluster_intersect_mask_woop(case["union"],
                                               woop_merge(case)[0], *rays)
    if kernel == "worklist":
        wl, counts, _ = worklist_merge(case, seed=1)
        return tdn.cluster_intersect(wl, counts, case["tri_rows"], *rays)
    return tdn.cluster_intersect_mask(case["union"], case["tri_rows"], *rays)


@pytest.mark.parametrize("leaf,kernel", [
    (leaf, kernel) for leaf in (16, 64)
    for kernel in ("expand", "mask", "woop", "worklist")] + [
        (WOOP_ODD_LEAF, "woop")])
def test_merge_rules_match_jax(leaf, kernel):
    """Faces equal on every live ray and t within rtol 1e-3: XLA on the
    CPU contracts multiply-adds and torch does not, and the random ray
    directions include grazing ones, whose small det amplifies that
    rounding (measured: faces equal, t within 4.2e-4 relative at leaf 16,
    1.2e-4 at 64). The Woop kernel (packed ids compared as faces) gets
    bits >= C in the last union word, and the port an extra word of
    ones; its t = -o'w / d'w is held to rtol 1e-3 plus the float32
    rounding bound of the two orders of its sums (`_woop_slack`), which
    only rays nearly parallel to the triangle's plane need (measured:
    faces equal; t within 3.5e-3 relative at leaf 16, on one ray with
    d'w = 2.1e-4 against terms of 0.4, 0.15 of its bound; within 7.1e-4
    on every other ray, 5.7e-4 at leaf 64, 1.2e-3 at leaf 18, which no
    4 divides, so the card's kernel loads a lane at a time). The worklist
    kernel (`pallas_cluster_intersect`) on the clusters as worklists,
    with ids in [0, C) and counts at most cap (the JAX kernel reads both
    unguarded): faces equal, t within rtol 1e-3 (measured: faces equal,
    t within 3.8e-4 relative at leaf 16, 1.2e-4 at 64). The
    planted ties resolved by the rules in both; rays whose seed is not >
    0 (-BIG, 0, -0, nan) keep it, bitwise, with face -1."""
    case = merge_case(leaf, "cpu", seed=leaf, stray=kernel == "woop")
    ref_t, ref_f = _jax_run(kernel, case)
    got_t, got_f = _port_run(kernel, case)
    if kernel == "woop":
        _, fid, planted = woop_merge(case)
        got_p = got_f
        ref_f, got_f = woop_faces(ref_f, fid), woop_faces(got_f, fid)
    elif kernel == "worklist":
        planted = worklist_merge(case, seed=1)[2]
    else:
        planted = case
    for face in (ref_f, got_f):
        check_planted(planted, face, kernel)
    live = case["seed"] > 0
    assert int((got_f[live] >= 0).sum()) > int(live.sum()) * 9 // 10
    assert torch.equal(got_f[live], ref_f[live])
    if kernel == "woop":
        gap = (got_t.double() - ref_t.double()).abs()
        tol = 1e-3 * ref_t.double().abs() + _woop_slack(case, got_p)
        assert bool((gap[live] <= tol[live]).all())
    else:
        torch.testing.assert_close(got_t[live], ref_t[live], rtol=1e-3,
                                   atol=0)
    dead = ~live
    for t, f in ((got_t, got_f), (ref_t, ref_f)):
        assert torch.equal(t[dead].view(torch.int32),
                           case["seed"][dead].view(torch.int32))
        assert bool((f[dead] == -1).all())
