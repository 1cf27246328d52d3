"""Instruction counts of the kernels' inner loops, read from the SASS
that `cuobjdump -sass` prints for a built library (on the machine with
the CUDA toolkit)."""
from __future__ import annotations

import functools
import re
import shutil
import subprocess


@functools.lru_cache(maxsize=None)
def _sass(lib_path: str) -> str:
    """`cuobjdump -sass` of a built library, read once a process (each
    library is built once a process; several callers read the
    kernels')."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout


def loop_sizes(lib_path: str, loops: dict, longest: bool = False) -> dict:
    """loops: label -> (pattern of a kernel's mangled name, the
    instruction that marks one unit of work, the marks a unit; 0: the
    loop is one unit, a walk step of either kind of row). For each
    kernel found, the shortest loop (a backward branch to an earlier
    instruction) that holds the mark, or with `longest` the longest, as
    (its instruction count, its units): two units a pass where a thread
    tests two rays or walks two rays, more where the compiler unrolled
    the loop. Returns label -> (instructions, units)."""
    funcs, body = {}, None
    for line in _sass(lib_path).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = next((k for k, (pat, _, _) in loops.items()
                         if re.search(pat, m.group(1))), None)
            body = funcs.setdefault(name, []) if name else None
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if body is not None and m:
            body.append((m.group(1), None))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if body is not None and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, body in funcs.items():
        _, mark, per_unit = loops[name]
        ins, at = [], {}   # at: label or address -> instruction index
        for key, text in body:
            at[key] = len(ins)
            if text is not None:
                ins.append(text)
        best = None
        for end, text in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", text)
            if not m:
                continue
            tgt = m.group(1)
            start = at.get(int(tgt, 16) if tgt.startswith("0x") else tgt)
            if start is None or start > end:
                continue
            marks = sum(mark in x for x in ins[start:end + 1])
            units = marks / per_unit if per_unit else float(marks > 0)
            size = end + 1 - start
            if units and (best is None or (size > best[0] if longest
                                           else size < best[0])):
                best = (size, units)
        if best:
            out[name] = best
    return out
