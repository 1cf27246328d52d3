"""The regroup probes' kernels (`csrc/regroup.cu`, contracts there) and
their plain torch versions: `permute` (scripts/tpu_permute_probe.py and
tpu_permute_probe2.py), `sel` (tpu_sel_probe.py) and `cycle`
(tpu_cycle_budget.py). Each runs `iters` cycles of picking interested
lanes, moving their payload into 128 slots, a stand-in test there and
the way back, on every program of n lanes.

The plain versions are vectorised over programs, with a loop over cycles;
where a slot collects several lanes (cycle's fixed_s, and full past
8,192 lanes; sel's rank allows it, though its interest pattern gives no
lane a slot) they add the lanes in ascending order from 0, as the
kernels do. At the n that `sel` takes (at most 16,384) every rank is -1,
so its slot sums never run and its output is zero: a check of `sel`
holds only that. On CPU tensors the wrappers run them.

The kernels: `permute` one block a program, which ranks its cycles at
once by warp ballots over the interest tests (a warp a cycle, stopping
at the 128th interested lane), counts the cycles that select each lane,
and takes each lane's rows through that many steps in registers (a
cycle's update of a lane reads only that lane's rows); `cycle` a block
for each group of slots of a program (a lane's slot is the same in every
cycle, so a group owns its lanes over all cycles; the kernel's entry
picks the grid); `sel` one block a program, the rank of each (lane,
cycle) from its closed form in registers, one block-wide vote whether
any lane has a slot.
"""
from __future__ import annotations

import torch

from ..kernels._build import launch, on_cuda
from ._common import SLOTS, bf16, exclusive_rank

CYCLE_MODES = ("full", "no_mm", "fixed_s")


def _programs(x: torch.Tensor, rows: int, n: int) -> int:
    if x.dim() != 2 or x.shape[0] != rows or n <= 0 or x.shape[1] % n:
        raise ValueError(f"x must be ({rows}, k * {n}), got {tuple(x.shape)}")
    return x.shape[1] // n


def _interest(lane: torch.Tensor, c: int) -> torch.Tensor:
    return ((lane * 37 + c * 131) % 199) < 5


# --- permute: tpu_permute_probe.py (chain=False), tpu_permute_probe2.py

def permute_lanes(n: int, c: int, device) -> torch.Tensor:
    """The lanes a cycle selects, in slot order: the first 128 interested
    lanes by exclusive rank."""
    m = _interest(torch.arange(n, device=device), c).to(torch.int32)
    rank = exclusive_rank(m)
    return torch.nonzero((m > 0) & (rank < SLOTS)).flatten()


def permute_plain(x, iters: int, n: int, chain: bool = False,
                  fixed_s: bool = False):
    progs = _programs(x, 8, n)
    cur = x.view(8, progs, n).clone()
    acc = torch.zeros_like(cur)
    lanes0 = permute_lanes(n, 0, x.device)
    for c in range(iters):
        lanes = lanes0 if fixed_s else permute_lanes(n, c, x.device)
        y = bf16(bf16(cur[:, :, lanes]) * 1.0001 + 0.5)
        if chain:
            cur[:, :, lanes] = cur[:, :, lanes] + y * 1e-6
        else:
            acc[:, :, lanes] = acc[:, :, lanes] + y
    return (cur if chain else acc).reshape(8, progs * n)


def permute(x: torch.Tensor, iters: int, n: int, chain: bool = False,
            fixed_s: bool = False) -> torch.Tensor:
    """x (8, P * n) f32 -> (8, P * n) f32: the sum of the cycles'
    scattered results (chain False), or x after `iters` chained cycles;
    any n and iters."""
    progs = _programs(x, 8, n)
    if not on_cuda({"x": (x, (8, progs * n), torch.float32)}):
        return permute_plain(x, iters, n, chain, fixed_s)
    out = torch.empty_like(x)
    launch("rk_permute", x.data_ptr(), out.data_ptr(), x.shape[1], n, iters,
           int(chain), int(fixed_s))
    permute.launches += 1
    return out


permute.launches = 0


# --- sel: tpu_sel_probe.py

def sel_slots(n: int, c: int, device) -> torch.Tensor:
    """rank_m of a cycle: the probe's shifted-sum rank of each interested
    lane (not a prefix sum), -1 elsewhere; (n,) int64."""
    m = _interest(torch.arange(n, device=device), c).long()
    rank = -m
    k = 1
    while k < n:
        rank[k:] += m[:n - k]
        k *= 2
    return torch.where(m > 0, rank, torch.full_like(rank, -1))


def _slot_sums(pay: torch.Tensor, lanes: torch.Tensor, slots: torch.Tensor,
               nslots: int) -> torch.Tensor:
    """(rows, P, nslots) sums of pay (rows, P, n) over each slot's lanes,
    in ascending lane order from 0 (lanes ascending, slots[k] the slot of
    lanes[k])."""
    g = torch.zeros(pay.shape[:2] + (nslots,), dtype=torch.float32,
                    device=pay.device)
    if lanes.numel() == 0:
        return g
    order = torch.argsort(slots * (int(lanes.max()) + 1) + lanes)
    lanes, slots = lanes[order], slots[order]
    start = torch.searchsorted(slots, slots)   # first entry of each slot
    pos = torch.arange(slots.numel(), device=pay.device) - start
    for p in range(int(pos.max()) + 1):
        k = pos == p
        s = slots[k]
        g[:, :, s] = g[:, :, s] + pay[:, :, lanes[k]]
    return g


def sel_plain(x, iters: int, n: int):
    progs = _programs(x, 24, n)
    pay = x.view(24, progs, n).float()
    acc = torch.zeros((8, progs, n), dtype=torch.float32, device=x.device)
    for c in range(iters):
        rank_m = sel_slots(n, c, x.device)
        lanes = torch.nonzero(rank_m >= 0).flatten()
        slots = rank_m[lanes]
        g = _slot_sums(pay, lanes, slots, SLOTS)
        y = bf16((g[0:6] + g[6:12]) + g[12:18])
        acc[0:6, :, lanes] = acc[0:6, :, lanes] + y[:, :, slots]
    return acc.reshape(8, progs * n)


def sel(x: torch.Tensor, iters: int, n: int) -> torch.Tensor:
    """x (24, P * n) bf16 -> (8, P * n) f32 (rows 6-7 zero); n <= 16,384."""
    progs = _programs(x, 24, n)
    if not on_cuda({"x": (x, (24, progs * n), torch.bfloat16)}):
        return sel_plain(x, iters, n)
    if n > 16384:
        raise ValueError(f"n={n} lanes a program: at most 16384")
    out = torch.empty((8, x.shape[1]), dtype=torch.float32, device=x.device)
    launch("rk_sel", x.data_ptr(), out.data_ptr(), x.shape[1], n, iters)
    sel.launches += 1
    return out


sel.launches = 0


# --- cycle: tpu_cycle_budget.py

def cycle_members(n: int, c: int, mode: str, device):
    """(lanes, slots) of a cycle, lanes ascending: full, the lanes with
    ((lane + 8c) & 63) == 0 in slot (lane >> 6) & 127; fixed_s, every
    lane in slot lane & 127."""
    if mode == "fixed_s":
        lanes = torch.arange(n, device=device)
        return lanes, lanes & (SLOTS - 1)
    lanes = torch.arange((-8 * c) & 63, n, 64, device=device)
    return lanes, (lanes >> 6) & (SLOTS - 1)


def cycle_plain(x, iters: int, n: int, mode: str):
    progs = _programs(x, 24, n)
    pay = bf16(x.view(24, progs, n))
    acc = torch.zeros((progs, n), dtype=torch.float32, device=x.device)
    inc = bf16(torch.tensor(1e-9, dtype=torch.float32, device=x.device))
    for c in range(iters):
        lanes, slots = cycle_members(n, c, mode, x.device)
        if mode == "no_mm":
            acc[:, lanes] = acc[:, lanes] + inc
            continue
        g = _slot_sums(pay, lanes, slots, SLOTS)
        y0 = bf16(g[0] * 1.0001 + 0.5)
        acc[:, lanes] = acc[:, lanes] + y0[:, slots]
    return acc.reshape(1, progs * n)


def cycle(x: torch.Tensor, iters: int, n: int, mode: str) -> torch.Tensor:
    """x (24, P * n) f32 -> (1, P * n) f32, the sum over cycles of row 0
    of the scattered results (mode in CYCLE_MODES)."""
    if mode not in CYCLE_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {CYCLE_MODES}")
    progs = _programs(x, 24, n)
    if not on_cuda({"x": (x, (24, progs * n), torch.float32)}):
        return cycle_plain(x, iters, n, mode)
    out = torch.empty((1, x.shape[1]), dtype=torch.float32, device=x.device)
    launch("rk_cycle", x.data_ptr(), out.data_ptr(), x.shape[1], n, iters,
           CYCLE_MODES.index(mode))
    cycle.launches += 1
    return out


cycle.launches = 0
