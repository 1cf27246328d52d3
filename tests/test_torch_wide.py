"""raypt_torch's `bvh4` backend against the JAX package: the collapse of
an LBVH into the 4-wide tree, the plain ordered-stack walk (the model
`csrc/wide_walk.cu` is held against on the card), the wide finder with
its deeper-stack retry, the `make_finder` routes and a 16x16 render
with its gradients. The walks run on one tree, the JAX package's
collapse of its own LBVH carried across (`wide_from_numpy`), so they are
compared independently of the build; `collapse` is compared on one LBVH
carried across (`lbvh_from_numpy`). Also an AST check that the modules
this slice adds import neither JAX nor the JAX package."""
import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel import build as jbuild
from raypt.accel import traverse as jtrav
from raypt.accel import wide as jwide
from raypt.core.math3d import BIG as JBIG
from raypt.core.math3d import normalize as jnormalize
from raypt.core.scene import MaterialDef as JMat
from raypt.core.scene import SceneBuilder as JBuilder
from raypt.core.types import RenderConfig as JaxConfig
from raypt.render import integrator as jint
from raypt.rng import frame_key, sample_key

from raypt_torch.accel import traverse as ttrav
from raypt_torch.accel.ctree import lbvh_from_numpy
from raypt_torch.accel.lbvh import LBVH
from raypt_torch.accel.packed import (PackedLBVH, pack, pack_cherries,
                                      pack_lookahead, pack_quads)
from raypt_torch.accel.wide import (STACK_D, WideBVH, collapse,
                                    traverse_wide, wide_from_numpy)
from raypt_torch.core.math3d import BIG
from raypt_torch.core.types import RenderConfig, scene_from_numpy
from raypt_torch.kernels import wide_walk as tww
from raypt_torch.render import integrator as tint
from raypt_torch.rng import sampler as trng

from test_torch_scene import jax_leaves

torch.set_num_threads(2)

FIELDS = ("left", "skip", "bmin", "bmax", "leaf_face")
RAYS = 1024
W = 16
# the plain walk's t against JAX's: XLA sums a dot's three products in
# its own order and may contract multiply-adds, so t may differ in the
# last bits (measured worst 5.4e-7 relative on these wavefronts, with
# every face id and overflow flag equal)
T_RTOL = 2e-6
# render and gradients against the JAX package (measured worst 8.9e-7
# absolute on the image and 2.0e-7 of the largest albedo gradient; the
# position gradient is 0 in both packages: the shading normals are an
# input of their own and the sky depends on directions only)
IMG_ATOL = 1e-5
GRAD_RTOL = 1e-4


def _scene(seed, ntri, nsph):
    """test_traverse.py's scene: ntri random triangles and nsph spheres
    in [-5, 5]^3, here under the JAX package's procedural sky and seen at
    W x W from the origin (so a render has albedo gradients)."""
    from raypt.scenes.builtin import _procedural_sky
    rng = np.random.default_rng(seed)
    b = JBuilder(env=_procedural_sky(16))
    b.camera.viewport_width = b.camera.viewport_height = W
    m0 = b.add_material(JMat(albedo=(0.5, 0.5, 0.5)))
    for _ in range(ntri):
        base = rng.uniform(-5, 5, 3)
        b.add_triangle(base, base + rng.uniform(-1, 1, 3),
                       base + rng.uniform(-1, 1, 3), m0)
    for _ in range(nsph):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.2, 1.0), m0)
    return b.freeze()


@pytest.fixture(scope="module")
def case():
    """test_traverse.py's scene of 300 triangles and 4 spheres (a tiny
    stack overflows on it) in the JAX package, its LBVH and wide tree,
    their copies in the port, and a wavefront of RAYS random rays (10%
    dead) with the sphere pass's t."""
    jscene = _scene(2, 300, 4)
    m = jscene.mesh
    jb = jbuild(m.positions, m.faces, m.face_valid)
    jw = jwide.collapse(jb, m.positions, m.faces, m.face_valid)
    rng = np.random.default_rng(7)
    ro = rng.uniform(-6, 6, (RAYS, 3)).astype(np.float32)
    rd = np.asarray(jnormalize(jnp.asarray(
        rng.normal(size=(RAYS, 3)).astype(np.float32))))
    active = rng.uniform(size=RAYS) < 0.9
    ts, _ = jtrav._closest_sphere(jscene, jnp.asarray(ro), jnp.asarray(rd))
    return dict(jscene=jscene, jb=jb, jw=jw,
                scene=scene_from_numpy(jax_leaves(jscene), "cpu"),
                bvh=lbvh_from_numpy(*(np.asarray(getattr(jb, k))
                                      for k in FIELDS)),
                w=wide_from_numpy(jw.rows, jw.root, jw.nw_cap, "cpu"),
                ro=ro, rd=rd, active=active, t0=np.asarray(ts))


def test_collapse_bitwise(case):
    """collapse of the JAX package's LBVH: rows bitwise (the dump row
    aside), root and nw_cap equal; from the LBVHTensors too."""
    s, jw = case["scene"], case["jw"]
    m = s.mesh
    for tree in (case["bvh"], case["bvh"].tensors("cpu")):
        w = collapse(tree, m.positions, m.faces, m.face_valid)
        rows = np.asarray(jw.rows)
        assert w.rows.shape == rows.shape
        assert np.array_equal(w.rows[:-1].numpy().view(np.int32),
                              rows[:-1].view(np.int32))
        assert (w.root, w.nw_cap) == (int(jw.root), jw.nw_cap)


@pytest.mark.parametrize("stack_d", [STACK_D, 2])
def test_traverse_wide_vs_jax(case, stack_d):
    """The plain walk against jax traverse_wide on one tree: face ids
    and overflow flags exactly, t to T_RTOL; at stack_d 2 rays
    overflow."""
    args = [case[k] for k in ("ro", "rd", "t0", "active")]
    jt, jf, jo = jwide.traverse_wide(case["jw"], *map(jnp.asarray, args),
                                     stack_d=stack_d)
    pt, pf, po = traverse_wide(case["w"], *map(torch.from_numpy, args),
                               stack_d=stack_d)
    assert np.array_equal(pf.numpy(), np.asarray(jf))
    assert np.array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=T_RTOL)
    if stack_d == 2:
        assert po.any()
    # the wrapper runs the plain version on CPU tensors
    kt, kf, ko = tww.wide_walk(case["w"], *map(torch.from_numpy, args),
                               stack_d)
    assert torch.equal(kt, pt) and torch.equal(kf, pf) and torch.equal(ko, po)


@pytest.mark.parametrize("stack_d,tile", [(0, 300), (2, 256)])
def test_find_closest_wide(case, stack_d, tile):
    """The wide finder against the JAX package's: sphere and triangle
    ids exactly, t to T_RTOL; at stack_d 2 the overflowing rays are
    walked again at 8 and the result is the JAX package's."""
    ro, rd, active = (case[k] for k in ("ro", "rd", "active"))
    a = jtrav.find_closest_wide(case["jscene"], case["jw"], jnp.asarray(ro),
                                jnp.asarray(rd), jnp.asarray(active),
                                tile=tile, stack_d=stack_d)
    b = ttrav.find_closest_wide(case["scene"], case["w"],
                                torch.from_numpy(ro), torch.from_numpy(rd),
                                torch.from_numpy(active), tile=tile,
                                stack_d=stack_d)
    assert np.array_equal(b.tri.numpy(), np.asarray(a.tri))
    assert np.array_equal(b.sphere.numpy(), np.asarray(a.sphere))
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), rtol=T_RTOL)


def test_retry_keeps_first_result(case):
    """Rays without overflow keep the first walk's result; the others
    take the deeper walk's, which is the default-stack walk's here."""
    s = case["scene"]
    ro, rd, act = (torch.from_numpy(case[k]) for k in ("ro", "rd", "active"))
    t0 = torch.from_numpy(case["t0"])
    _, f2, o2 = traverse_wide(case["w"], ro, rd, t0, act, 2)
    _, f8, _ = traverse_wide(case["w"], ro, rd, t0, act, 8)
    ids = ttrav.find_closest_wide(s, case["w"], ro, rd, act, stack_d=2)
    tri = torch.where(o2, f8, f2)
    assert torch.equal(torch.where(tri >= 0, tri, -1), ids.tri)


def test_small_scene():
    """test_traverse.py's scene of two stacked triangles: the nearer is
    hit at t 3."""
    from raypt_torch.accel import lbvh
    from raypt_torch.core.scene import MaterialDef, SceneBuilder
    b = SceneBuilder()
    m0 = b.add_material(MaterialDef())
    b.add_triangle((-1, -1, -3), (1, -1, -3), (0, 1, -3), m0)
    b.add_triangle((-1, -1, -5), (1, -1, -5), (0, 1, -5), m0)
    s = b.freeze("cpu")
    m = s.mesh
    w = collapse(lbvh.build(m.positions, m.faces, m.face_valid), m.positions,
                 m.faces, m.face_valid)
    ids = ttrav.find_closest_wide(s, w, torch.tensor([[0.0, 0.0, 0.0]]),
                                  torch.tensor([[0.0, 0.0, -1.0]]))
    assert int(ids.tri[0]) == 0 and abs(float(ids.t[0]) - 3.0) < 1e-5


def test_walk_edges(case):
    """Dead rays keep t0 + rd.x * 0 and face -1; axis-parallel
    directions (components of +-0 and below 1e-12), rays from inside the
    boxes, a seed of -0 and NaN rays walk as the JAX loop walks them."""
    rng = np.random.default_rng(4)
    n = 64
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = np.zeros((n, 3), np.float32)
    rd[np.arange(n), np.arange(n) % 3] = np.where(np.arange(n) % 2, 1.0, -1.0)
    rd[::5, 1] = -0.0
    rd[::7, 2] = 1e-13
    ro[3] = np.nan
    rd[5] = np.nan
    t0 = np.full(n, JBIG, np.float32)
    t0[9] = -0.0
    active = np.ones(n, bool)
    active[::11] = False
    args = (ro, rd, t0, active)
    jt, jf, jo = jwide.traverse_wide(case["jw"], *map(jnp.asarray, args))
    pt, pf, po = traverse_wide(case["w"], *map(torch.from_numpy, args))
    assert np.array_equal(pf.numpy(), np.asarray(jf))
    assert np.array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=T_RTOL)
    dead = ~active
    assert np.array_equal(pt.numpy()[dead].view(np.int32),
                          (t0 + rd[:, 0] * np.float32(0.0))[dead].view(np.int32))
    assert (pf.numpy()[dead] == -1).all()


def test_make_finder_routes(case):
    """bvh4 with an LBVH, its LBVHTensors or no accel collapses the tree
    here; a WideBVH is walked whatever the bvh backend, and auto resolves
    to bvh with it; a PackedLBVH under bvh4 takes the packed finder, as
    in the JAX package, and so does a table of any other layout; the
    bvh finder packs the layout its flags select (tests/
    test_torch_layouts.py); an accel of another kind is a TypeError."""
    box = case
    s = box["scene"]
    m = s.mesh
    cfg = RenderConfig(width=W, height=W, backend="bvh4")
    assert tint.resolve_backend(s, cfg.replace(backend="auto"),
                                box["w"]) == "bvh"
    for accel in (box["bvh"], box["bvh"].tensors("cpu"), None):
        f = tint.make_finder(s, cfg, accel)
        assert f.func is tint._wide_finder
        assert torch.equal(f.args[0].rows[:-1].view(torch.int32),
                           box["w"].rows[:-1].view(torch.int32))
    for backend in ("bvh", "bvh2", "bvh4", "auto"):
        f = tint.make_finder(s, cfg.replace(backend=backend), box["w"])
        assert f.func is tint._wide_finder and f.args[0] is not None
    packed = pack(box["bvh"], m.positions, m.faces, m.face_valid)
    assert tint.make_finder(s, cfg, packed).func is tint._packed_finder
    for flags, packer in ((dict(leaf_tris=2), pack_cherries),
                          (dict(leaf_tris=4), pack_quads),
                          (dict(node_lookahead=True), pack_lookahead)):
        f = tint.make_finder(s, cfg.replace(backend="bvh", **flags),
                             box["bvh"])
        want = packer(box["bvh"], m.positions, m.faces, m.face_valid)
        assert f.func is tint._packed_finder and type(f.args[0]) is type(want)
        assert torch.equal(f.args[0].rows.view(torch.int32),
                           want.rows.view(torch.int32))
        assert tint.make_finder(s, cfg.replace(**flags),
                                want).func is tint._packed_finder
    with pytest.raises(TypeError):
        tint.make_finder(s, cfg, object())


def test_bvh4_render_and_grads(case):
    """The 16x16 bvh4 render (1 spp, 2 bounces) and the gradients of
    its mean w.r.t. positions and albedo, against the JAX package's
    through its own wide finder on the same tree."""
    box = case
    jscene = box["jscene"]
    kw = dict(width=W, height=W, samples_per_pixel=1, num_bounces=2,
              backend="bvh4")
    jskey = sample_key(frame_key(jax.random.key(0), 0), 0)
    jfinder = jint.make_finder(jscene, JaxConfig(**kw), box["jw"])

    def jloss(pos, alb):
        s = jscene.replace(mesh=jscene.mesh.replace(positions=pos),
                           materials=jscene.materials.replace(albedo=alb))
        img = jint.render_sample(s, JaxConfig(**kw), jskey, jfinder)
        return img.mean(), img

    (jl, jimg), (jgp, jga) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jscene.mesh.positions,
                                             jscene.materials.albedo)

    s = box["scene"]
    cfg = RenderConfig(**kw)
    finder = tint.make_finder(s, cfg, box["w"])
    pos = s.mesh.positions.clone().requires_grad_(True)
    alb = s.materials.albedo.clone().requires_grad_(True)
    st = s.replace(mesh=s.mesh.replace(positions=pos),
                   materials=s.materials.replace(albedo=alb))
    skey = trng.sample_key(trng.frame_key(trng.key(0), 0), 0)
    img = tint.render_sample(st, cfg, skey, finder)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=IMG_ATOL)
    img.mean().backward()
    np.testing.assert_allclose(float(img.mean().detach()), float(jl), rtol=1e-5)
    for got, want in ((pos.grad, jgp), (alb.grad, jga)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got.numpy() - want).max()) <= GRAD_RTOL * scale
    assert float(alb.grad.abs().sum()) > 0


@pytest.mark.parametrize("stack_d", [STACK_D, 2])
def test_steps_record(case, stack_d):
    """traverse_wide's `steps` and `depths` records change no result;
    their rows read sum to the `visits` record's, kind by kind, step by
    step; each step's depths align with its rays; and simd_efficiency /
    mixed_share read the record as they read the packed walk's."""
    from raypt_torch.accel.packed import mixed_share, simd_efficiency
    args = [torch.from_numpy(case[k].copy())
            for k in ("ro", "rd", "t0", "active")]
    want = traverse_wide(case["w"], *args, stack_d=stack_d)
    visits, steps, depths = [], [], []
    got = traverse_wide(case["w"], *args, stack_d=stack_d, visits=visits,
                        steps=steps, depths=depths)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert len(visits) == len(steps) == len(depths)
    for (inner, leaves), (rays, rows, leaf), dep in zip(visits, steps,
                                                         depths):
        assert rays.numel() == rows.numel() == dep.numel() == inner + leaves
        assert int(leaf.sum()) == leaves
        assert bool((rows[leaf] >= case["w"].nw_cap).all())
        assert bool((dep >= 0).all())
    assert sum(v[0] + v[1] for v in visits) > int(args[3].sum())
    assert 0 < simd_efficiency(steps) <= 1 and 0 <= mixed_share(steps) <= 1
    deepest = max(int(d.max()) for d in depths if d.numel())
    assert deepest > stack_d if stack_d == 2 else deepest <= stack_d


def test_deep_stack_record():
    """chip_smoke.deep_stack_case, triangles stacked along the view axis
    under a chain of internal rows: at 3 rows, by hand, a downward ray
    pushes 3 leaves a row (stack depth 9 at leaf 0), hits face 0 at t
    about 1 and visits 3 + 10 rows; the ray heading up visits the root
    only, the ray seeded at t0 = 3.5 pushes only the leaves nearer than
    3.5; at 8 rows the recorded depth is 24, above 16, and a stack of 16
    overflows; the plain walk agrees with the JAX package's on both."""
    from chip_smoke import deep_stack_case
    w, o, d, t, a = deep_stack_case(3, 64, "cpu")
    steps, depths = [], []
    pt, pf, po = traverse_wide(w, o, d, t, a, steps=steps, depths=depths)
    per_ray = torch.zeros(64, dtype=torch.int64)
    deepest = torch.zeros(64, dtype=torch.int64)
    for (rays, _, _), dep in zip(steps, depths):
        per_ray[rays] += 1
        deepest.scatter_reduce_(0, rays, dep, "amax")
    lane = torch.arange(64) % 16
    down = lane >= 3
    assert int(deepest.max()) == 9 and bool((deepest[down] == 9).all())
    assert bool((per_ray[down] == 3 + 10).all())
    assert bool((per_ray[lane == 1] == 1).all())
    assert bool((per_ray[lane == 0] == 0).all())
    # t0 = 3.5: the chain's rows and leaves 1 and 2 (t about 2 and 3)
    # only, pushed at the last row, then leaf 0
    assert bool((deepest[lane == 2] == 2).all())
    assert bool((per_ray[lane == 2] == 3 + 3).all())
    assert bool((pf[down | (lane == 2)] == 0).all())
    assert bool((pf[lane <= 1] == -1).all()) and not bool(po.any())
    assert bool(((pt[down] - 1.0).abs() < 1e-3).all())
    for levels, stack_d in ((3, STACK_D), (8, STACK_D), (8, 16)):
        w, o, d, t, a = deep_stack_case(levels, 256, "cpu")
        depths = []
        pt, pf, po = traverse_wide(w, o, d, t, a, stack_d, depths=depths)
        if levels == 8:
            assert max(int(x.max()) for x in depths if x.numel()) == 24 > 16
        assert bool(po.any()) == (stack_d < 3 * levels)
        jw = jwide.WideBVH(rows=jnp.asarray(w.rows.numpy()),
                           root=jnp.int32(w.root), nw_cap=w.nw_cap)
        jt, jf, jo = jwide.traverse_wide(
            jw, *(jnp.asarray(x.numpy()) for x in (o, d, t, a)),
            stack_d=stack_d)
        assert np.array_equal(pf.numpy(), np.asarray(jf))
        assert np.array_equal(po.numpy(), np.asarray(jo))
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=T_RTOL)


def test_wide_designs_match_the_sweep():
    """The sweep's WIDE_DESIGNS are the RK_WWALK_DESIGN lines of
    csrc/wide_walk_designs.cu, each within wide::Design's static checks
    (whole warps, a shared stack of at most 40 KB a block, its settings'
    ranges, no while-while schedule with cooperative leaves, shared
    internal rows only with shared leaves, refilled lanes only in
    persistent warps with shared leaves), with pr16
    beside them; KEPT, the design csrc/wide_walk.cu writes out, is one
    of them: 128 threads, the launch bound's 10 blocks, no shared
    stack, the lean step, cooperative leaves in every pass and none of
    the other schedules, as the package source's constants say."""
    from raypt_torch.kernels import sweep
    root = pathlib.Path(__file__).resolve().parents[1] / "raypt_torch"
    src = (root / "csrc" / "wide_walk_designs.cu").read_text()
    lines = [x for x in src.splitlines() if x.startswith("RK_WWALK_DESIGN(")]
    assert len(lines) == len(sweep.WIDE_DESIGNS) - 1 >= 10
    assert sweep.WIDE_DESIGNS["pr16"] is None
    for name, design in sweep.WIDE_DESIGNS.items():
        if design is None:
            continue
        assert f"RK_WWALK_DESIGN({name}, " in src
        (threads, shared, min_blocks, lean, batch, persist, coop, inner,
         refill) = design
        assert threads % 32 == 0 and threads <= 1024
        assert 0 <= shared
        assert min_blocks >= 1 and lean in (0, 1, 2, 3)
        assert 0 <= batch <= 32 and persist >= 0 and 0 <= coop <= 32
        assert shared * threads * 4 <= 40 * 1024 and not (coop and batch)
        assert 0 <= inner <= 32 and (coop or not inner)
        assert 0 <= refill <= 32 and (not refill or (persist and coop))
    kept = sweep.WIDE_DESIGNS[sweep.KEPT]
    package = (root / "csrc" / "wide_walk.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", package))
    assert kept == (int(consts["kThreads"]), 0, int(consts["kMinBlocks"]),
                    1, 0, 0, 1, 0, 0)
    assert "__launch_bounds__(kThreads, kMinBlocks)" in package
    assert sweep.wide_pattern(kept).startswith("7designs11walk_kernel")


def test_wide_schedule(case):
    """The sweep's schedule measures on the CPU: the SIMD efficiency and
    mixed share of the octant order's record in (0, 1], and the depths'
    maximum the deepest any live ray reaches, at or above its 99th
    percentile."""
    from raypt_torch.kernels import sweep
    w = case["w"]
    wave = (w.rows, w.root, w.nw_cap,
            *(torch.from_numpy(case[k].copy())
              for k in ("ro", "rd", "t0", "active")))
    got = sweep.wide_schedule([wave], 128)
    depths = []
    traverse_wide(w, *wave[3:], depths=depths)
    assert got["depth_max"] == [max(int(x.max()) for x in depths
                                    if x.numel())]
    assert got["depth_p50_p90_p99"][0][2] <= got["depth_max"][0]
    assert 0 < got["simd_efficiency"][0] <= 1
    assert 0 <= got["mixed_share"][0] <= 1


NEW_MODULES = ("app/__init__.py", "app/cli.py", "app/debug.py",
               "app/metrics.py", "app/profiling.py", "io/__init__.py",
               "io/checkpoint.py", "io/ply.py", "io/native.py", "io/obj.py",
               "io/image.py", "accel/wide.py", "kernels/wide_walk.py",
               "render/envmap.py", "core/math3d.py", "core/scene.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_no_jax_imports(module):
    """The modules of this slice import neither jax nor raypt."""
    root = pathlib.Path(__file__).resolve().parents[1] / "raypt_torch"
    tree = ast.parse((root / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "raypt", "flax", "optax"), \
                f"{module} imports {name}"
