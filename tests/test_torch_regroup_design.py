"""The premises of the cycle and sel kernels (`raypt_torch/csrc/regroup.cu`)
against the plain versions of `raypt_torch/probes/regroup.py`, on the CPU.

cycle: a lane's slot is the same in every cycle that selects it, so a
program splits into groups of slots, each owning its lanes over all
cycles; the groups rk_cycle launches (`cycle_grid`, its rule
transcribed) cover every slot that holds a lane once, at any n; and
`cycle_model`, the kernel's index arithmetic transcribed block by block
(staging, the chunks of (slot, cycle) sums over four slots a thread, the
totals a thread keeps, the block's lanes), is bitwise the plain
version. sel: the kernel's closed-form rank equals `sel_slots`,
with the probe's interest and with a wider one (the interest a GPU test
builds to reach the kernel's slot sums), and the kernel's spread of
(lane, cycle) pairs over its threads visits each pair once.

The CUDA kernels run only on the card: tests/test_torch_gpu.py and
chip_smoke.py hold them bitwise against the plain versions there."""
import os
import re

import pytest
import torch

from raypt_torch.kernels._build import CSRC_DIR
from raypt_torch.probes import regroup
from raypt_torch.probes._common import bf16

torch.set_num_threads(2)

SEL_THREADS = 1024  # sel_kernel's block
WIDE = 32           # the GPU test's wider interest: residue < 32 of 199


def _bits(a):
    return a.contiguous().view(torch.int32)


def _block(scope: str) -> dict:
    """The `constexpr int` constants of regroup.cu's block that starts
    with `scope` (up to the next blank line)."""
    with open(os.path.join(CSRC_DIR, "regroup.cu")) as f:
        src = f.read()
    block = src[src.index(scope):]
    block = block[:block.index("\n\n")]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", block)}


def _interest_constants():
    """kStride, kShift, kModulus, kWidth of the interest block."""
    return _block("// The probes' interest")


DESIGN = _block("// The cycle kernel's design")


def _design(name):
    """The cycle kernel's design block: the package's, or a sweep
    variant's."""
    from raypt_torch.kernels import sweep
    return DESIGN if name is None else sweep.CYCLE_VARIANTS[name]


def cycle_grid(n: int, mode: str, group: int) -> int:
    """rk_cycle's grid, transcribed: blocks of `group` slots a program,
    enough to cover the slots that hold a lane."""
    run = 1 if mode == "fixed_s" else 64
    return -(-min(128, -(-n // run)) // group)


# --- cycle

@pytest.mark.parametrize("mode", ["full", "fixed_s"])
@pytest.mark.parametrize("n", [128, 256, 4096, 8192, 16384])
def test_cycle_slot_fixed_over_cycles(n, mode):
    """Over cycles 0-63, every lane a cycle selects has the same slot in
    each such cycle: (lane >> 6) & 127 in full, lane & 127 in fixed_s."""
    slot = torch.full((n,), -1, dtype=torch.int64)
    for c in range(64):
        lanes, slots = regroup.cycle_members(n, c, mode, "cpu")
        seen = slot[lanes] >= 0
        assert torch.equal(slot[lanes][seen], slots[seen])
        slot[lanes] = slots
    lane = torch.arange(n)
    want = (lane >> 6) & 127 if mode == "full" else lane & 127
    hit = slot >= 0
    assert torch.equal(slot[hit], want[hit])
    # full selects every eighth lane, each in one cycle of eight
    assert int(hit.sum()) == (n if mode == "fixed_s" else -(-n // 8))


@pytest.mark.parametrize("mode", regroup.CYCLE_MODES)
@pytest.mark.parametrize("n", [1, 63, 100, 128, 256, 4096, 8192, 8200,
                               16384, 32768, 32769, 65536, 300000])
def test_cycle_grid_covers_slots(n, mode):
    """rk_cycle's groups (slots k * group .. k * group + group - 1) cover
    each slot that holds a lane exactly once, every group holds a lane,
    and every lane of the program is one of its group's block lanes (runs
    of group slots' lanes, a period apart), at any n."""
    group = DESIGN["kCycleGroup"]
    groups = cycle_grid(n, mode, group)
    lane = torch.arange(n)
    fixed = mode == "fixed_s"
    slot = lane & 127 if fixed else (lane >> 6) & 127
    owner = slot // group
    assert int(owner.max()) == groups - 1
    assert bool((torch.bincount(owner, minlength=groups) > 0).all())
    covered = torch.cat([torch.arange(k * group, min((k + 1) * group, 128))
                         for k in range(groups)])
    assert torch.equal(covered[covered <= int(slot.max())], torch.unique(slot))
    period, run_w = (128, 1) if fixed else (8192, 64)
    width = group * run_w
    first = owner * width
    runs = (n - first + period - 1) // period
    rel = lane - first
    assert bool((rel % period < width).all())
    assert bool((rel // period < runs).all())


@pytest.mark.parametrize("name", [None, "g16", "g4", "t256_g16", "t64",
                                  "stage256"])
def test_cycle_design_block(name):
    """The package's design block and each sweep variant keep the
    kernel's static_asserts (four slots a sum, a chunk of whole cycles,
    one lane total a thread, whole runs staged) and fit a block's static
    shared memory."""
    d = _design(name)
    threads, group, stage = (d["kCycleThreads"], d["kCycleGroup"],
                             d["kCycleStage"])
    pairs = 4 * threads
    assert group % 4 == 0 and pairs % group == 0
    assert 8 * group <= threads <= 1024 and threads % 32 == 0
    assert stage % (8 * group) == 0
    assert 4 * (stage + pairs + 8 * group) <= 48 * 1024


def cycle_model(x, iters: int, n: int, mode: str, name=None):
    """cycle_kernel transcribed block by block, threads vectorised: the
    staged bf16(x[0, lane]) with +0.0 past n (once, or a chunk of runs at
    a time for each chunk of cycles), each chunk's (four slots, cycle)
    sums in ascending run order, y0, the totals of (q, slot) in cycle
    order, and the block's lanes written from them; lanes no block
    writes stay NaN."""
    d = _design(name)
    threads, group, stage_n = (d["kCycleThreads"], d["kCycleGroup"],
                               d["kCycleStage"])
    pairs = 4 * threads
    progs = x.shape[1] // n
    groups = cycle_grid(n, mode, group)
    fixed = mode == "fixed_s"
    period, run_w, rows = (128, 1, 1) if fixed else (8192, 64, 8)
    width, per_run = group * run_w, rows * group
    stage_runs = stage_n // per_run
    quads, chunk = group // 4, pairs // group
    out = torch.full((progs * n,), float("nan"))
    t = torch.arange(threads)
    c4 = torch.arange(4)                     # a float4's components
    u, cc = t % quads, t // quads            # sums: slots 4u.., cycle cc
    a_slot, q = t % group, t // group        # totals: (q, slot)
    owner = t < 8 * group
    inc = bf16(torch.tensor(1e-9))
    for b in range(progs * groups):
        base = (b // groups) * n
        first = (b % groups) * width
        runs = (n - first + period - 1) // period

        def stage(r0):
            staged = min(stage_runs, runs - r0) * per_run
            e = torch.arange(staged)
            run, rest = r0 + e // per_run, e % per_run
            i = run * period + first + (rest if fixed else
                                        64 * (rest % group) + 8 * (rest // group))
            s_v = torch.full((stage_n,), float("nan"))
            s_v[:staged] = torch.where(
                i < n, bf16(x[0, base + i.clamp(max=n - 1)]), torch.zeros(()))
            return s_v

        acc = torch.zeros(threads)
        if mode == "no_mm":
            for c in range(iters):
                sel = owner & ((c - ((8 - q) & 7)) % 8 == 0)
                acc[sel] = acc[sel] + inc
        else:
            once = runs <= stage_runs
            s_v = stage(0) if once else None
            for cb in range(0, iters, chunk):
                c = cb + cc
                row = torch.zeros_like(c) if fixed else (-c) & 7
                g = torch.zeros(threads, 4)
                for r0 in range(0, runs, stage_runs):
                    if not once:
                        s_v = stage(r0)
                    for r in range(min(stage_runs, runs - r0)):
                        g = g + s_v[((r * rows + row) * quads + u)[:, None] * 4 + c4]
                y = bf16(g * 1.0001 + 0.5)
                s_y = torch.full((pairs,), float("nan"))
                live = c < iters
                s_y[((cc * quads + u)[:, None] * 4 + c4)[live]] = y[live]
                for e_ in range(min(chunk, iters - cb)):
                    sel = owner if fixed else owner & (
                        (e_ - ((8 - q - cb) & 7)) % 8 == 0)
                    yv = s_y[e_ * group + a_slot]
                    acc[sel] = acc[sel] + yv[sel]
        s_acc = acc[:8 * group]
        l = torch.arange(runs * width)
        o = l % width
        i = l // width * period + first + o
        val = s_acc[o] if fixed else torch.where(
            (o & 7) == 0, s_acc[(o & 63) // 8 * group + o // 64],
            torch.zeros(()))
        ok = i < n
        out[base + i[ok]] = val[ok]
    return out.view(1, -1)


@pytest.mark.parametrize("n,progs,iters,name,mode", [
    (n, progs, iters, name, mode)
    for n, progs, iters, name in [
        (128, 3, 17, None), (100, 2, 9, None), (300, 1, 70, None),
        (4096, 3, 5, "g16"), (8200, 1, 3, "g4"), (16384, 1, 2, None),
        (256, 2, 140, "t256_g16"), (40000, 1, 3, None),
        (70000, 1, 2, "stage256")]
    for mode in regroup.CYCLE_MODES] + [
        (512, 1, 40, "t64", "fixed_s"), (9000, 1, 40, "stage256", "fixed_s"),
        (40000, 1, 3, "stage256", "full")])
def test_cycle_model_bitwise(n, progs, iters, name, mode):
    """The kernel's transcription against cycle_plain, bitwise, at sizes
    that end a run, a group or a chunk of cycles early, with a slot of
    two members (full at 16,384) and more, past 32,768 lanes, with runs
    staged a chunk at a time (fixed_s past 32,768 lanes; stage256: full
    past 32,768, fixed_s past 4,096), and at the sweep's other designs."""
    g = torch.Generator().manual_seed(n + iters)
    x = torch.randn((24, n * progs), generator=g) * 3
    got = cycle_model(x, iters, n, mode, name)
    want = regroup.cycle_plain(x, iters, n, mode)
    assert not bool(torch.isnan(got).any())
    assert torch.equal(_bits(got), _bits(want))


# --- sel

def sel_rank_closed_form(n: int, c: int, width: int | None = None):
    """sel_kernel's rank of every lane in cycle c: -1 off interest, else
    -1 plus the shifted terms m[i - k] (k = 1, 2, 4, ... <= i) read off
    the residues (37 i + 131 c) mod 199 less 37 k mod 199."""
    k_ = _interest_constants()
    stride, shift, mod = k_["kStride"], k_["kShift"], k_["kModulus"]
    width = k_["kWidth"] if width is None else width
    i = torch.arange(n)
    r = ((i % mod) * stride + (c % mod) * shift) % mod
    rank = torch.full((n,), -1, dtype=torch.int64)
    a, k = stride % mod, 1
    while k < n:
        t = torch.where(r >= a, r - a, r - a + mod)
        rank += ((t < width) & (i >= k)).long()
        a = 2 * a - mod if 2 * a >= mod else 2 * a
        k *= 2
    return torch.where(r < width, rank, torch.full_like(rank, -1))


def _wide_interest(monkeypatch):
    monkeypatch.setattr(regroup, "_interest",
                        lambda lane, c: ((lane * 37 + c * 131) % 199) < WIDE)


def slot_mask(i: int, width: int) -> int:
    """sel_kernel's slot_mask: bit r (< width) where an interested lane
    i of residue r has a slot, from the windows of the shifts' residues."""
    k_ = _interest_constants()
    stride, mod = k_["kStride"], k_["kModulus"]
    every = (1 << width) - 1
    mask, a, k = 0, stride % mod, 1
    while k <= i:
        if a < width:
            mask |= every & ~((1 << a) - 1)
        if a > mod - width:
            mask |= (1 << (a + width - mod)) - 1
        a = 2 * a - mod if 2 * a >= mod else 2 * a
        k *= 2
    return mask


def test_sel_interest_constants():
    """regroup.cu's interest block is the plain version's interest."""
    k_ = _interest_constants()
    lane = torch.arange(4096)
    for c in range(0, 400, 7):
        want = regroup._interest(lane, c)
        got = ((lane * k_["kStride"] + c * k_["kShift"]) % k_["kModulus"]
               < k_["kWidth"])
        assert torch.equal(got, want)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n", [1, 2, 64, 1000, 2048, 16384])
def test_sel_rank_closed_form(n, wide, monkeypatch):
    """The closed-form rank equals sel_slots for cycles 0-255 (every
    residue of c mod 199): all -1 with the probe's interest, ranks up to
    log2 n with the wide one once n > 16."""
    if wide:
        _wide_interest(monkeypatch)
    top = -1
    for c in range(256):
        got = sel_rank_closed_form(n, c, WIDE if wide else None)
        want = regroup.sel_slots(n, c, "cpu")
        assert torch.equal(got, want), c
        top = max(top, int(want.max()))
    # the wide interest's first shift to give a slot is k = 16
    assert top == -1 if not wide else (top >= 0) == (n > 16)


@pytest.mark.parametrize("wide", [False, True])
def test_sel_slot_mask(wide, monkeypatch):
    """Each lane's residue mask (its bits are the residues that give an
    interested lane a slot) agrees with sel_slots in every cycle 0-255 at
    16,384 lanes: a lane has a slot in cycle c exactly where its residue's
    bit is set. The probe's masks are all zero."""
    width = WIDE if wide else _interest_constants()["kWidth"]
    if wide:
        _wide_interest(monkeypatch)
    n = 16384
    lane = torch.arange(n)
    masks = torch.tensor([slot_mask(i, width) for i in range(n)])
    assert bool((masks != 0).any()) == wide
    for c in range(256):
        r = ((lane % 199) * 37 + (c % 199) * 131) % 199
        bit = torch.where(r < width, (masks >> r.clamp(max=width - 1)) & 1,
                          torch.zeros_like(r))
        assert torch.equal(bit == 1, regroup.sel_slots(n, c, "cpu") >= 0), c


@pytest.mark.parametrize("n,iters", [(1, 5), (64, 256), (100, 7),
                                     (2048, 3), (2048, 256), (16384, 16)])
def test_sel_pairs_each_once(n, iters):
    """sel_kernel's fast path: `lanes` threads a cycle (a power of two up
    to the block), kThreads / lanes cycles in flight, the residue carried
    from cycle to cycle by `dr`; each (lane, cycle) is visited once with
    its residue, and with the probe's interest no visit finds a slot."""
    k_ = _interest_constants()
    stride, shift, mod = k_["kStride"], k_["kShift"], k_["kModulus"]
    lanes = 1
    while lanes < n and lanes < SEL_THREADS:
        lanes *= 2
    step = SEL_THREADS // lanes
    dr = (step % mod) * shift % mod
    t = torch.arange(SEL_THREADS)[:, None, None]
    j = torch.arange(-(-n // lanes))[None, :, None]
    m = torch.arange(-(-iters // step))[None, None, :]
    i, c = t % lanes + lanes * j, t // lanes + step * m
    ok = (i < n) & (c < iters)
    i, c, m = (v.expand(ok.shape)[ok] for v in (i, c, m))
    visits = torch.bincount(i * iters + c, minlength=n * iters)
    assert bool((visits == 1).all())
    r0 = ((i % mod) * stride + ((c - step * m) % mod) * shift) % mod
    r = (r0 + m * dr) % mod
    assert torch.equal(r, ((i % mod) * stride + (c % mod) * shift) % mod)
    ranks = torch.stack([sel_rank_closed_form(n, cc) for cc in range(iters)])
    assert not bool((ranks[c, i] >= 0).any())
    x = torch.randn((24, n)).to(torch.bfloat16)
    assert not bool(regroup.sel_plain(x, min(iters, 4), n).any())
