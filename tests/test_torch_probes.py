"""The `scripts/` Pallas probes, ported to `raypt_torch/probes/`, against
the scripts' own kernels on the CPU.

The scripts run their probe when imported (scene builds, timing), so
`load_script` takes from a script only its imports, its functions and
its upper-case constants, sets the sizes given, and swaps in a `pl`
whose `pallas_call` runs in interpret mode; no script is changed. The
same inputs, made with numpy from a seed, go through the script's kernel
and the port's wrapper on CPU tensors, which runs its plain version.
Each `main()` also runs once with `--device cpu` at toy sizes.

Tolerances: masks, ranks, gathers, compactions and the diagnostics are
bitwise. The regroup probes round `g * 1.0001 + 0.5` to bf16; XLA on the
CPU contracts it into one multiply-add and torch does not, so a few
results differ by one bf16 step (BF16_STEP of the value: 2^-8 relative)
and the rest are bitwise; where a slot adds several lanes (cycle_budget's
fixed_s) XLA adds them in its own order, and there the results are held
to SUM_RTOL. Measured on this CPU at these sizes (four seeds each): no
result of P2, P3 or P5 differs from JAX's, in any mode.

The CUDA kernels run only on the card: tests/test_torch_gpu.py and
chip_smoke.py hold them bitwise against these plain versions there."""
import ast
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pl
from jax.experimental.pallas import tpu as pltpu

from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.ctree import walk_topwalk_jnp
from raypt.accel.host_bvh import build_sah as jax_build_sah
from raypt.core.math3d import BIG
from raypt.kernels.onehot_walk import pallas_topwalk_cm
from raypt.scenes import builtin as jax_scenes

from raypt_torch.probes import (cycle_budget, expand_debug, expand_diag2,
                                gather, pallas_gather_test,
                                pallas_gather_test2, permute_probe,
                                permute_probe2, regroup, sel_probe,
                                walk_spec_probe)

from test_torch_scene import jax_accel_to_port

torch.set_num_threads(2)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
N = 256             # lanes a program
PROGS = 2
CYCLES = 3
BF16_STEP = 2.0 ** -8
SUM_RTOL = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _interpret_pl():
    shim = types.ModuleType("pallas_interpret")
    shim.__dict__.update(jax_pl.__dict__)

    def pallas_call(*args, **kw):
        kw["interpret"] = True
        return jax_pl.pallas_call(*args, **kw)

    shim.pallas_call = pallas_call
    return shim


def _constant(target) -> bool:
    if isinstance(target, ast.Name):
        return target.id.isupper()
    return isinstance(target, ast.Tuple) and all(map(_constant, target.elts))


def load_script(name: str, **sizes) -> dict:
    """A script's imports, functions and upper-case constants, the given
    sizes set over them, with `pl.pallas_call` in interpret mode."""
    path = os.path.join(SCRIPTS, name)
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(node, ast.Assign)
                and all(map(_constant, node.targets)))]
    ns = {"__name__": "probe_" + name[:-3]}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns.update(sizes)
    ns["pl"] = _interpret_pl()
    return ns


def _close_bf16(got, ref, sums: bool = False):
    """Bitwise but for a few results one bf16 step apart (see the module
    docstring); with sums, within SUM_RTOL. Returns the worst relative
    difference."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    if sums:
        assert rel.max() <= SUM_RTOL
    else:
        assert rel.max() <= BF16_STEP
        assert np.count_nonzero(got != ref) <= max(4, ref.size // 100)
    return float(rel.max())


# --- P10, P11: the gathers

@pytest.fixture(scope="module")
def gather_inputs():
    rng = np.random.default_rng(10)
    n, w, r = 512, 16, 256
    table = rng.normal(size=(n, w)).astype(np.float32)
    idx = rng.integers(0, n, size=r).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("body,oob", [
    ("kern", False), ("k_take", False), ("k_take_clip", False),
    ("k_loop", False), ("k_tal", False), ("k_take_clip", True)])
def test_gather_bitwise(gather_inputs, body, oob):
    """Each kernel body of pallas_gather_test.py (kern) and
    pallas_gather_test2.py against `gather_rows` (clip for k_take_clip),
    bitwise; oob: indices outside the table, which both clamp."""
    table, idx = gather_inputs
    n, w = table.shape
    r = idx.shape[0]
    if oob:
        idx = idx.copy()
        idx[::7] = np.array([-5, n, n + 40, -1])[np.arange(idx[::7].size) % 4]
    script = "pallas_gather_test.py" if body == "kern" else \
        "pallas_gather_test2.py"
    ns = load_script(script, N=n, W=w, R=r)
    spec = jax_pl.BlockSpec(memory_space=pltpu.VMEM)
    ref = ns["pl"].pallas_call(
        ns[body], out_shape=jax.ShapeDtypeStruct((r, w), jnp.float32),
        in_specs=[spec, spec], out_specs=spec)(jnp.asarray(table),
                                               jnp.asarray(idx))
    got = gather.gather_rows(_t(table), _t(idx), body == "k_take_clip")
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_gather_out_of_range_fills_nan(gather_inputs):
    """Without clip an index outside the table gives a NaN row
    (jnp.take's default), not a read outside the table."""
    table, idx = gather_inputs
    idx = idx.copy()
    idx[3], idx[9] = -1, table.shape[0]
    got = gather.gather_rows(_t(table), _t(idx)).numpy()
    assert np.isnan(got[[3, 9]]).all()
    keep = np.ones(idx.size, bool)
    keep[[3, 9]] = False
    assert np.array_equal(got[keep], table[idx[keep]])


# --- P2-P5: the regroup probes

def _rows(seed, rows, dtype=np.float32):
    return np.random.default_rng(seed).normal(
        size=(rows, N * PROGS)).astype(dtype)


def test_permute_matches_jax():
    """tpu_permute_probe.py: the sum of CYCLES cycles' scattered results."""
    ns = load_script("tpu_permute_probe.py", N=N, PROGS=PROGS)
    x = _rows(2, 8)
    ref = ns["run"](jnp.asarray(x), CYCLES, interpret=True)
    got = regroup.permute(_t(x), CYCLES, N)
    assert np.count_nonzero(np.asarray(ref)) > 0
    _close_bf16(got.numpy(), ref)


@pytest.mark.parametrize("fixed_s", [True, False])
def test_permute_chained_matches_jax(fixed_s):
    """tpu_permute_probe2.py: x after CYCLES chained cycles."""
    ns = load_script("tpu_permute_probe2.py", N=N, PROGS=PROGS)
    x = _rows(3, 8)
    ref = np.asarray(ns["run"](jnp.asarray(x), CYCLES, interpret=True,
                               fixed_s=fixed_s))
    got = regroup.permute(_t(x), CYCLES, N, chain=True, fixed_s=fixed_s)
    assert np.count_nonzero(ref != x) > 0
    _close_bf16(got.numpy(), ref)


def test_sel_matches_jax():
    """tpu_sel_probe.py (its grid is 128 programs), bitwise. Its rank is
    the shifted sum of m, not a prefix sum, and with its interest pattern
    no interested lane has another a power of two before it (37 * 2^j mod
    199 is never within 4 of 0 for 2^j < 2^20), so every interested lane
    gets rank -1, no lane reaches a slot and the output is zero."""
    ns = load_script("tpu_sel_probe.py", N=N)
    x = np.random.default_rng(4).normal(size=(24, N * 128)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(ns["run"](xb, "eq_bf16", CYCLES))
    got = regroup.sel(_t(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16), CYCLES, N)
    assert np.array_equal(got.numpy(), ref)
    assert not ref.any()
    for c in range(CYCLES):
        assert bool((regroup.sel_slots(N, c, "cpu") == -1).all())


@pytest.mark.parametrize("mode", regroup.CYCLE_MODES)
def test_cycle_matches_jax(mode):
    """tpu_cycle_budget.py in each mode: the sum of row 0 of CYCLES
    cycles' scattered results (fixed_s sums N / 128 lanes a slot)."""
    ns = load_script("tpu_cycle_budget.py", N=N, PROGS=PROGS)
    x = _rows(5, 24)
    ref = np.asarray(ns["run"](jnp.asarray(x), CYCLES, mode))
    got = regroup.cycle(_t(x), CYCLES, N, mode)
    assert np.count_nonzero(ref) > 0
    _close_bf16(got.numpy(), ref, sums=mode == "fixed_s")


def test_cycle_two_members_matches_jax():
    """tpu_cycle_budget.py in full mode at 16,384 lanes, one program, two
    cycles: there each slot sums two lanes (64 (slot + 128 t) + 8c's
    offset, t = 0, 1), which the kernel adds in ascending lane order."""
    n = 16384
    ns = load_script("tpu_cycle_budget.py", N=n, PROGS=1)
    x = np.random.default_rng(6).normal(size=(24, n)).astype(np.float32)
    ref = np.asarray(ns["run"](jnp.asarray(x), 2, "full"))
    got = regroup.cycle(_t(x), 2, n, "full")
    for c in range(2):
        slots = regroup.cycle_members(n, c, "full", "cpu")[1]
        assert int(torch.bincount(slots).min()) == 2
    assert np.count_nonzero(ref) == 2 * n // 64
    _close_bf16(got.numpy(), ref)


# --- P6-P9: the expansion diagnostics

@pytest.mark.parametrize("wk", [(11, 7), (15, 31), (20, 3)])
def test_expand_debug_stages_bitwise(wk):
    """tpu_expand_debug.py's three kernels: m and rank, the payload's
    compaction and return, and m on a grid of two blocks, bitwise; (15,
    31) reads the sign bit, (20, 3) a page past the last, which XLA's
    dynamic slice clamps."""
    ns = load_script("tpu_expand_debug.py", N=N)
    rng = np.random.default_rng(6)
    pages = rng.integers(-2 ** 31, 2 ** 31, size=(2, 8, N), dtype=np.int32)
    pages2 = rng.integers(-2 ** 31, 2 ** 31, size=(2, 8, 2 * N),
                          dtype=np.int32)
    wk_np = np.array([wk], np.int32)
    m, rank = (np.asarray(a) for a in ns["run12"](jnp.asarray(wk_np),
                                                   jnp.asarray(pages)))
    gm, grank = expand_debug.stage12(_t(wk_np), _t(pages))
    assert np.array_equal(gm.numpy(), m) and np.array_equal(grank.numpy(),
                                                            rank)
    od = (rng.normal(size=(6, N)) * 3).astype(np.float32)
    pay = _t(expand_debug.payload_rows(_t(od)).float().numpy())
    go, gsel = (np.asarray(a) for a in ns["run34"](
        jnp.asarray(pay.numpy()).astype(jnp.bfloat16), jnp.asarray(m)))
    ggo, ggsel = expand_debug.stage34(pay.to(torch.bfloat16), _t(m))
    assert np.array_equal(ggo.numpy(), go)
    assert np.array_equal(ggsel.numpy(), gsel)
    assert 0 < int((gsel[0] != -1).sum()) <= 128
    m5 = np.asarray(ns["run5"](jnp.asarray(wk_np), jnp.asarray(pages2)))
    assert np.array_equal(expand_debug.stage5(_t(wk_np), _t(pages2)).numpy(),
                          m5)


@pytest.fixture(scope="module")
def bunny():
    """The JAX bench scene (the icosphere stand-in) and its SAH tree."""
    scene = jax_scenes.stanford_bunny().freeze()
    return scene, jax_build_sah(scene.mesh)


def _rays(scene, r, seed):
    """r rays from around the mesh towards points in its bounds."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(scene.mesh.positions)[:2562]
    lo, hi = pos.min(0), pos.max(0)
    ro = (lo + hi) / 2 + rng.normal(size=(r, 3)) * (hi - lo)
    rd = lo + rng.random((r, 3)) * (hi - lo) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.fixture(scope="module")
def diag_wave(bunny):
    """1,024 rays around the bunny, the JAX leaf-64 walk's (R, words)
    mask and its (cwp, R) form padded to a multiple of 8 words."""
    scene, bvh = bunny
    m = scene.mesh
    jacc = jax_build_onehot(bvh, m.positions, m.faces, m.face_valid, leaf=64)
    nw = -(-jacc[0].num_clusters // 32)
    ro, rd = _rays(scene, 4 * N, 7)
    r = ro.shape[0]
    mask = np.asarray(walk_topwalk_jnp(jacc[1], jnp.asarray(ro),
                                       jnp.asarray(rd), jnp.full((r,), BIG),
                                       jnp.ones((r,), bool), nw))
    cwp = -(-nw // 8) * 8
    mask_cm = np.zeros((cwp, r), np.int32)
    mask_cm[:nw] = mask.T
    return ro, rd, mask, mask_cm


def test_expand_diag_bitwise(diag_wave):
    """tpu_expand_diag2.py's run_diag on 1,024 rays of the leaf-64 walk,
    four programs of N: v1, v2, nc, v3 bitwise; the flow is right (v1 =
    v2 = v3 = 0, nc = the mask's popcount)."""
    ro, rd, mask, mask_cm = diag_wave
    r = ro.shape[0]
    ns = load_script("tpu_expand_diag2.py", N=N)
    ref = [np.asarray(a) for a in ns["run_diag"](
        jnp.asarray(mask_cm), jnp.asarray(ro), jnp.asarray(rd), N)]
    got = expand_diag2.run_diag(_t(mask_cm), _t(ro), _t(rd), N)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), b)
    pop = expand_diag2.popcount(_t(mask.T.copy())).numpy()
    assert pop.sum() > r and np.array_equal(got[2].numpy()[0], pop)
    assert not got[0].any() and not got[1].any() and not got[3].any()


def test_expand_diag_items_model(diag_wave):
    """The diagnostics kernel's design (`diag_items` of
    test_torch_permute_design.py: a block for each (program, mask word),
    each (cluster, round) item on its own tile, the rays' outputs merged
    in a shuffled order) on the same wavefront: bitwise diag_plain."""
    from test_torch_permute_design import diag_items
    ro, rd, _, mask_cm = diag_wave
    a = (_t(mask_cm), *expand_diag2.payload(_t(ro), _t(rd)), N)
    want = expand_diag2.diag_plain(*a)
    got = diag_items(*a, seed=11)
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert int(got[2].sum()) > ro.shape[0]


# --- P1: the speculative walk

@pytest.mark.parametrize("leaf", [64, 512])
def test_walk_spec_bitwise(bunny, leaf):
    """tpu_walk_spec_probe.py's topwalk_spec and pallas_topwalk_cm (both
    interpret mode) and the port's topwalk_spec: one mask, bitwise."""
    scene, bvh = bunny
    m = scene.mesh
    jacc = jax_build_onehot(bvh, m.positions, m.faces, m.face_valid,
                            leaf=leaf)
    acc = jax_accel_to_port(jacc)
    nw = -(-acc.num_clusters // 32)
    ro, rd = _rays(scene, 256, leaf)
    r = ro.shape[0]
    t0 = np.where(np.arange(r) % 3 == 0, 40.0, BIG).astype(np.float32)
    act = np.arange(r) % 11 != 0
    ns = load_script("tpu_walk_spec_probe.py")
    jargs = (jacc[1], jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t0),
             jnp.asarray(act), nw)
    ref = np.asarray(ns["topwalk_spec"](*jargs, ray_tile=r))
    base = np.asarray(pallas_topwalk_cm(*jargs, interpret=True, ray_tile=r))
    got = walk_spec_probe.topwalk_spec(acc.table, _t(ro), _t(rd), _t(t0),
                                       _t(act), nw)
    assert np.count_nonzero(ref) > r // 8
    assert np.array_equal(ref, base) and np.array_equal(got.numpy(), ref)


# --- the entry points, once each on the CPU at toy sizes

@pytest.mark.parametrize("module,sizes", [
    (pallas_gather_test, {}), (pallas_gather_test2, {}), (expand_debug, {}),
    (permute_probe, {"N": N, "PROGS": PROGS}),
    (permute_probe2, {"N": N, "PROGS": PROGS}),
    (sel_probe, {"N": N, "ITERS": (2, 4)}),
    (cycle_budget, {"N": N, "PROGS": PROGS, "ITERS": 4}),
    (walk_spec_probe, {"SIZE": 32}),
    (expand_diag2, {"SIZE": 32, "N": N})])
def test_main_runs_on_cpu(module, sizes, monkeypatch, capsys):
    """Each entry point with --device cpu at toy sizes: its checks pass
    and its lines name the CPU, not a card."""
    for name, value in sizes.items():
        monkeypatch.setattr(module, name, value)
    if module is permute_probe2:
        for name, value in sizes.items():
            monkeypatch.setattr(permute_probe, name, value)
    argv = ["--device", "cpu"] + (["eq_bf16"] if module is sel_probe else [])
    module.main(argv)
    out = capsys.readouterr().out
    assert "FAIL" not in out and "cpu: plain torch versions" in out
