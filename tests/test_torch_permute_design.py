"""The premises of the permute kernel and of the expansion diagnostics
kernel (`raypt_torch/csrc/regroup.cu`, `csrc/expand_diag.cu`) against the
plain versions of `raypt_torch/probes/regroup.py` and
`probes/expand_diag2.py`, on the CPU.

permute: `ballot_scan`, the kernel's rank_cycle transcribed (a warp's
ballots of the interest tests over 32 lanes at a time, residues stepped
32 lanes on, the exclusive rank a count plus a popcount, the scan
stopped once 128 lanes are found), selects what `permute_lanes` selects
for every residue of 131 c mod 199; `window_counts`, the kernel's
counts of selecting cycles a window of lanes at a time, equals the
plain selections' counts; and `permute_model` (each lane's rows through
its count of steps) and `permute_slots_model` (the sweep's slot tile
design: lists of 32 cycles at a time, then the cycles in order) are
bitwise `permute_plain` in the four modes.

diag: `diag_items`, the kernel's blocks (program, mask word) and items
(cluster, round of 128 ranks) transcribed, each item on a tile of its
own, the rays' outputs merged in a shuffled order by integer adds and a
max of bit patterns, is bitwise `diag_plain` (also on the JAX walk's
wavefront: tests/test_torch_probes.py), and with NaN and inf in the
truth and the payload it agrees with it, NaNs where it has them; a
collision in a slot shows in v1, a ray left out of a round in nc.

The CUDA kernels run only on the card: tests/test_torch_gpu.py and
chip_smoke.py hold them bitwise against the plain versions there."""
import os
import re

import numpy as np
import pytest
import torch

from raypt_torch.kernels._build import CSRC_DIR
from raypt_torch.probes import expand_diag2, regroup
from raypt_torch.probes._common import SLOTS, bf16, split3_bf16

torch.set_num_threads(2)


def _source() -> str:
    with open(os.path.join(CSRC_DIR, "regroup.cu")) as f:
        return f.read()


def _block(scope: str) -> dict:
    """The `constexpr int` constants of regroup.cu's block that starts
    with `scope` (up to the next blank line)."""
    src = _source()
    block = src[src.index(scope):]
    block = block[:block.index("\n\n")]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", block)}


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source())[1])


INTEREST = _block("// The probes' interest")
DESIGN = _block("// The permute kernel's design")
RANK_WORDS = _constant("kRankWords")
LIST_CYCLES = _constant("kListCycles")
STRIDE, SHIFT, MOD, WIDTH = (INTEREST[k] for k in
                             ("kStride", "kShift", "kModulus", "kWidth"))
STEP32 = (32 * STRIDE) % MOD   # kStep32


def _bits(a):
    return a.contiguous().view(torch.int32)


# --- permute

def ballot_scan(n: int, cycles):
    """rank_cycle of regroup.cu for each cycle in `cycles`: (lanes (C,
    128) in rank order, -1 past the slots filled; slots filled (C,); the
    lane where the scan stopped (C,))."""
    cycles = torch.as_tensor(list(cycles), dtype=torch.long)
    ncyc = cycles.numel()
    lane = torch.arange(32)
    r = (lane[None] * STRIDE + (cycles[:, None] % MOD) * SHIFT) % MOD
    found = torch.zeros(ncyc, dtype=torch.long)
    stop = torch.full((ncyc,), -1, dtype=torch.long)
    lanes = torch.full((ncyc, SLOTS), -1, dtype=torch.long)
    active = torch.ones(ncyc, dtype=torch.bool)
    i0 = 0
    while True:
        # the warp's loop test: i0 < n and fewer than 128 found
        done = active & ((i0 >= n) | (found >= SLOTS))
        stop[done] = min(i0, n)
        active &= ~done
        if not bool(active.any()):
            break
        for u in range(RANK_WORDS):
            i = i0 + 32 * u + lane
            m = (i < n)[None] & (r < WIDTH) & active[:, None]   # the ballot
            rank = found[:, None] + torch.cumsum(m, 1) - m.long()
            rows, cols = torch.nonzero(m & (rank < SLOTS), as_tuple=True)
            lanes[rows, rank[rows, cols]] = i[cols]
            found += m.sum(1)
            r = torch.where(r + STEP32 >= MOD, r + STEP32 - MOD, r + STEP32)
        i0 += 32 * RANK_WORDS
    return lanes, found.clamp(max=SLOTS), stop


@pytest.mark.parametrize("n", [31, 100, 8192, 20000])
def test_ballot_rank_selects_permute_lanes(n):
    """For cycles 0-198 (every residue of 131 c mod 199) the ballot scan
    selects permute_lanes' lanes in rank order, each below the lane where
    the scan stopped; the scan reads all n lanes only where fewer than
    128 are interested, and stops within 32 * kRankWords lanes of the
    128th."""
    lanes, nsel, stop = ballot_scan(n, range(MOD))
    for c in range(MOD):
        want = regroup.permute_lanes(n, c, "cpu")
        got = lanes[c, :int(nsel[c])]
        assert torch.equal(got, want)
        assert bool((lanes[c, int(nsel[c]):] == -1).all())
        assert int(stop[c]) <= n and bool((got < stop[c]).all())
        if want.numel() < SLOTS:
            assert int(stop[c]) == n
        else:
            assert int(stop[c]) <= int(want[-1]) + 32 * RANK_WORDS
    if n >= 8192:   # the probes' lanes: about 5,100 scanned a cycle, in
        # the package's one window
        assert int(stop.max()) <= DESIGN["kPermuteWindow"]
        assert bool((nsel == SLOTS).all())


def plain_counts(n: int, iters: int, fixed_s: bool) -> torch.Tensor:
    """How many of `iters` cycles select each lane, from permute_lanes."""
    k = torch.zeros(n, dtype=torch.long)
    for c in range(iters):
        k[regroup.permute_lanes(n, 0 if fixed_s else c, "cpu")] += 1
    return k


def window_counts(n: int, iters: int, fixed_s: bool, window: int):
    """permute_kernel's counts of selecting cycles, transcribed: fixed_s
    ranks cycle 0 alone, weighted by iters; the windows of `window` lanes
    in turn, each ranked again from lane 0, until one reaches the largest
    stop. Returns (counts (n,), windows ranked)."""
    ranked = min(iters, 1) if fixed_s else iters
    weight = iters if fixed_s else 1
    lanes, _, stop = ballot_scan(n, range(ranked))
    last_stop = int(stop.max()) if ranked else 0
    k = torch.zeros(n, dtype=torch.long)
    w0, windows = 0, 0
    while True:
        w1 = min(n, w0 + window)
        count = torch.zeros(w1 - w0, dtype=torch.long)
        sel = lanes[(lanes >= w0) & (lanes < w1)]
        count.index_add_(0, sel - w0, torch.full_like(sel, weight))
        k[w0:w1] = count
        windows += 1
        if w1 >= last_stop:
            return k, windows
        w0 += window


@pytest.mark.parametrize("window", [DESIGN["kPermuteWindow"], 1024, 96])
@pytest.mark.parametrize("n", [100, 1000, 8192, 20000])
def test_window_counts(n, window):
    """The kernel's per-lane counts equal the plain selections', at the
    package's window and at windows small enough that the scans' stops
    lie several windows on; windows past the last stop are not ranked."""
    for iters, fixed_s in ((0, False), (1, True), (9, True), (37, False)):
        k, windows = window_counts(n, iters, fixed_s, window)
        assert torch.equal(k, plain_counts(n, iters, fixed_s))
        stop = (int(ballot_scan(n, [0] if fixed_s else range(iters))[2].max())
                if iters else 0)
        assert windows == max(1, -(-stop // window))


def _step(v: torch.Tensor) -> torch.Tensor:
    """The stand-in test of one value: bf16(bf16(v) * 1.0001 + 0.5)."""
    return bf16(bf16(v) * 1.0001 + 0.5)


def permute_model(x, iters: int, n: int, chain: bool, fixed_s: bool,
                  window: int):
    """permute_kernel, transcribed: each lane's rows through its count
    of selecting cycles, in registers (a step reads only the lane's own
    rows, so the kernel may take lanes of many steps apart, from a packed
    list); the summed output adds the lane's y its count of times from
    0, a lane with count 0 writes 0 (or, chained, its x)."""
    progs = x.shape[1] // n
    k = window_counts(n, iters, fixed_s, window)[0]
    v = x.view(8, progs, n).clone()
    if chain:
        for e in range(int(k.max()) if k.numel() else 0):
            v = torch.where(k > e, v + _step(v) * 1e-6, v)
        return v.reshape(8, progs * n)
    y, acc = _step(v), torch.zeros_like(v)
    for e in range(int(k.max()) if k.numel() else 0):
        acc = torch.where(k > e, acc + y, acc)
    return acc.reshape(8, progs * n)


def permute_slots_model(x, iters: int, n: int, chain: bool, fixed_s: bool):
    """permute_slots_kernel, transcribed: the output set to x or 0;
    lists of the selected lanes of LIST_CYCLES cycles at a time (fixed_s:
    cycle 0's, once); each cycle in order moves its lanes' values into
    the slots, tests them there and adds the result back."""
    progs = x.shape[1] // n
    xv = x.view(8, progs, n)
    out = xv.clone() if chain else torch.zeros_like(xv)
    src = out if chain else xv
    for c0 in range(0, iters, LIST_CYCLES):
        chunk = min(LIST_CYCLES, iters - c0)
        if not fixed_s or c0 == 0:
            lists, nsel, _ = ballot_scan(n, [0] if fixed_s else
                                         range(c0, c0 + chunk))
        for e in range(chunk):
            li = 0 if fixed_s else e
            lanes = lists[li, :int(nsel[li])]
            z = _step(src[:, :, lanes])
            out[:, :, lanes] = out[:, :, lanes] + (z * 1e-6 if chain else z)
    return out.reshape(8, progs * n)


MODES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("chain,fixed_s", MODES,
                         ids=["sum", "sum_fixed", "chain", "chain_fixed"])
@pytest.mark.parametrize("n", [100, 1000, 8192])
def test_per_lane_recurrence_bitwise(n, chain, fixed_s):
    """A lane's selecting cycles as steps on its own rows, in registers,
    equal permute_plain bit for bit, at the package's window and at 256
    lanes; so does the slot tile design's cycle-by-cycle move."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(8, 3 * n)).astype(np.float32))
    for iters in (0, 1, 7, 40):
        want = regroup.permute_plain(x, iters, n, chain, fixed_s)
        for window in (DESIGN["kPermuteWindow"], 256):
            got = permute_model(x, iters, n, chain, fixed_s, window)
            assert torch.equal(_bits(got), _bits(want))
        got = permute_slots_model(x, iters, n, chain, fixed_s)
        assert torch.equal(_bits(got), _bits(want))
        if iters:
            assert bool((want != (x if chain else 0.0)).any())


def test_design_blocks():
    """The permute design block holds the package's design (rows in
    registers), and the sweep's variants and the GPU test's window set
    constants of that block; a window's counts and list fit static
    shared memory; the diagnostics kernel's variants set constants of
    its block."""
    from raypt_torch.kernels import sweep
    assert DESIGN == {"kPermuteSlots": 0, "kPermuteWindow": 6144,
                      "kRankWords": RANK_WORDS, "kPermuteHeavy": 4}
    src = _source()
    for consts in (*sweep.PERMUTE_VARIANTS.values(), {"kPermuteWindow": 1024}):
        sweep._set(src, "// The permute kernel's design", consts)
    assert sweep.SWEPT["permute"][2] == "// The permute kernel's design"
    # the counts (int) and the list of lanes of many steps (uint16)
    assert 6 * DESIGN["kPermuteWindow"] + 8 <= 48 * 1024
    assert DESIGN["kPermuteWindow"] < 2 ** 16
    with open(os.path.join(CSRC_DIR, "expand_diag.cu")) as f:
        diag_src = f.read()
    for consts in sweep.DIAG_VARIANTS.values():
        sweep._set(diag_src, sweep.SWEPT["diag"][2], consts)


# --- diag

CANONICAL_NAN = 0x7FFFFFFF   # the card's NaN from arithmetic


def _max_nan(a, b):
    return torch.where(a.isnan(), a, torch.where(b.isnan(), b,
                                                 torch.maximum(a, b)))


def _unsigned(x: torch.Tensor) -> np.ndarray:
    return x.numpy().astype(np.int64) & 0xFFFFFFFF


def diag_items(mask_cm, pay, otrue, n: int, seed: int = 0, fault=None):
    """expand_diag_kernel, transcribed. Block (program p, word w): the
    rays' words w, their OR, and for each set bit (ascending) the rays
    with the bit before each chunk of 32 (the ballots' popcounts, a
    warp scan); its items (cluster, round of 128 ranks), each on a tile
    of its own: the chunks holding ranks rb to rb + 127 by bisection, the
    selected rays' lanes and 24 payload rows into their slots, each slot's o and d
    rebuilt and split into bf16 digits in place, each ray's slot read
    back. The rays' outputs merge in a shuffled order: nc by adds,
    v1-v3 by a max of bit patterns over zeros (a NaN as the card's
    canonical NaN, which fabsf leaves positive). `fault` "collide" makes
    the last ray of each full round write the slot before its own;
    "drop" leaves the first ray of each round out. Returns (v1, v2, nc,
    v3), each (1, R)."""
    cwp, r = mask_cm.shape
    chunks = -(-n // 32)
    below = torch.tril(torch.ones(32, 32, dtype=torch.long), -1)
    out = []   # (ray, |z1 - 1|, dvo, dvd) tensors, an item's rays each
    for p in range(r // n):
        for w in range(cwp):
            words = np.zeros(32 * chunks, np.int64)
            words[:n] = _unsigned(mask_cm[w, p * n:(p + 1) * n])
            uni = int(np.bitwise_or.reduce(words))
            if not uni:
                continue
            bits = [k for k in range(32) if uni >> k & 1]
            pres, counts = [], []
            for k in bits:   # a warp a wanted cluster
                m = torch.from_numpy((words >> k) & 1).view(chunks, 32)
                per = m.sum(1)
                pres.append(torch.cumsum(per, 0) - per)
                counts.append(int(per.sum()))
            for b, k in enumerate(bits):
                pre = pres[b]
                for rb in range(0, counts[b], SLOTS):
                    nsel = min(SLOTS, counts[b] - rb)
                    q0, hi = 0, chunks - 1
                    while q0 < hi:
                        mid = (q0 + hi + 1) // 2
                        if int(pre[mid]) <= rb:
                            q0 = mid
                        else:
                            hi = mid - 1
                    q1, hi = q0, chunks   # the first with rb + 128 before
                    while q1 < hi:
                        mid = (q1 + hi) // 2
                        if int(pre[mid]) < rb + SLOTS:
                            q1 = mid + 1
                        else:
                            hi = mid
                    owner = torch.full((SLOTS,), -1, dtype=torch.long)
                    tile = torch.zeros((24, SLOTS), dtype=torch.bfloat16)
                    rays, slots = [], []
                    for q in range(q0, q1):
                        m = torch.from_numpy(
                            (words[32 * q:32 * q + 32] >> k) & 1)
                        s = int(pre[q]) + below @ m - rb
                        lanes = torch.nonzero(
                            (m > 0) & (s >= 0) & (s < SLOTS)).flatten()
                        rays.append(32 * q + lanes)
                        slots.append(s[lanes])
                    rays, slots = torch.cat(rays), torch.cat(slots)
                    if fault == "collide" and nsel == SLOTS:
                        slots[-1] -= 1
                    if fault == "drop":
                        rays, slots = rays[1:], slots[1:]
                    owner[slots] = rays
                    tile[:, slots] = pay[:, p * n + rays]
                    if fault == "collide" and nsel == SLOTS:   # it wrote last
                        owner[slots[-1]] = rays[-1]
                        tile[:, slots[-1]] = pay[:, p * n + rays[-1]]
                    g = tile[:18, :nsel].float()
                    for rows, v in ((slice(0, 9), (g[0:3] + g[6:9]) + g[12:15]),
                                    (slice(9, 18),
                                     (g[3:6] + g[9:12]) + g[15:18])):
                        tile[rows, :nsel] = torch.cat(split3_bf16(v))
                    d = tile[:18, slots].float()
                    bo = (d[0:3] + d[3:6]) + d[6:9]
                    bd = (d[9:12] + d[12:15]) + d[15:18]
                    eo = (bo - otrue[0:3, p * n + rays]).abs()
                    ed = (bd - otrue[3:6, p * n + rays]).abs()
                    dvo = _max_nan(_max_nan(eo[0], eo[1]), eo[2])
                    dvd = _max_nan(_max_nan(ed[0], ed[1]), ed[2])
                    z1 = (owner[slots] == rays).float()
                    out.append((p * n + rays, (z1 - 1.0).abs(), dvo, dvd))
    v = np.zeros((3, r), np.int64)   # v1, v2, v3 as bit patterns
    nc = np.zeros(r, np.int64)
    if out:
        ray = torch.cat([o[0] for o in out]).numpy()
        vals = []
        for j in (1, 3, 2):   # v1, v2 (d), v3 (o)
            x = torch.cat([o[j] for o in out])
            bits = x.view(torch.int32).numpy().astype(np.int64)
            vals.append(np.where(x.isnan().numpy(), CANONICAL_NAN, bits))
        for e in np.random.default_rng(seed).permutation(ray.size):
            nc[ray[e]] += 1
            for j in range(3):
                if vals[j][e] > v[j, ray[e]]:
                    v[j, ray[e]] = vals[j][e]
    f = torch.from_numpy(v.astype(np.int32)).view(torch.float32)
    return (f[0:1], f[1:2], torch.from_numpy(nc.astype(np.int32))[None],
            f[2:3])


def _diag_case(seed: int, n: int, progs: int, cwp: int):
    """Random masks over `cwp` words (some clusters wanted by most rays,
    so rounds overflow 128 slots) and the payload of random rays."""
    rng = np.random.default_rng(seed)
    r = n * progs
    dens = rng.choice([0.0, 0.05, 0.3, 0.8], size=(cwp, 32, 1, 1))
    bits = rng.random((cwp, 32, progs, n)) < dens
    mask = (bits.astype(np.int64) << np.arange(32)[None, :, None, None]).sum(1)
    mask_cm = torch.from_numpy(mask.astype(np.uint32).view(np.int32)
                               .reshape(cwp, r))
    ro = torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32) * 4)
    rd = torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32))
    pay, otrue = expand_diag2.payload(ro, rd)
    return mask_cm.contiguous(), pay, otrue


@pytest.mark.parametrize("n,progs,cwp", [(200, 3, 2), (256, 2, 1),
                                         (67, 4, 3)])
def test_diag_items_bitwise(n, progs, cwp):
    """Items on tiles of their own, merged in two shuffled orders, are
    diag_plain bit for bit; nc is each ray's popcount."""
    mask_cm, pay, otrue = _diag_case(n, n, progs, cwp)
    want = expand_diag2.diag_plain(mask_cm, pay, otrue, n)
    for seed in (0, 1):
        got = diag_items(mask_cm, pay, otrue, n, seed)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got[2][0].long(), expand_diag2.popcount(mask_cm))
    assert int(got[2].max()) >= 2


def test_diag_items_nan_inf():
    """NaN and inf in some rays' truth and payload: the bit-pattern max
    gives the values diag_plain gives and NaN where it has NaN (the card
    has one NaN; this CPU's NaN bits may differ)."""
    n = 200
    mask_cm, pay, otrue = _diag_case(5, n, 3, 2)
    hit = torch.nonzero(expand_diag2.popcount(mask_cm) > 0).flatten()
    otrue[0, hit[0::7]] = float("nan")
    otrue[4, hit[1::11]] = float("inf")
    otrue[2, hit[2::13]] = -float("inf")
    pay[3, hit[3::17]] = float("nan")
    want = expand_diag2.diag_plain(mask_cm, pay, otrue, n)
    got = diag_items(mask_cm, pay, otrue, n, 3)
    assert bool(got[3].isnan().any()) and bool(got[1].isinf().any())
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        keep = ~a.isnan()
        assert torch.equal(_bits(a[keep]), _bits(b[keep]))


def test_diag_items_faults_show():
    """A collision in a slot shows in v1 (the ray whose slot another
    overwrote reads a foreign owner); a ray left out of a round shows in
    nc (below its popcount)."""
    n = 200
    mask_cm, pay, otrue = _diag_case(9, n, 2, 1)
    pop = expand_diag2.popcount(mask_cm)
    v1, _, nc, _ = diag_items(mask_cm, pay, otrue, n, fault="collide")
    assert int((v1 == 1).sum()) > 0 and torch.equal(nc[0].long(), pop)
    v1, _, nc, _ = diag_items(mask_cm, pay, otrue, n, fault="drop")
    assert not bool(v1.any()) and int((nc[0].long() < pop).sum()) > 0
