"""Build-on-first-use of the port's shared libraries.

A library is compiled from sources in the checkout into
`raypt_torch/_build/` (listed in `.gitignore`), named by a hash of its
sources, compiler and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A failed build raises: nothing falls
back to another implementation. Concurrent builders (test workers) each
compile to a private temporary file and publish it with an atomic
rename.

Users: `raypt_torch.io.native` (the host SAH builder, g++) and
`raypt_torch.kernels._build` (the CUDA kernels, nvcc).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_LIBS: dict = {}


def build_library(name: str, compiler: list, flags: list,
                  sources: list) -> str:
    """Compile `sources` into `_build/lib<name>-<hash>.so` unless that
    file exists; returns its path. Raises RuntimeError with the
    compiler's output when the build fails."""
    h = hashlib.sha256()
    for part in compiler + flags:
        h.update(part.encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(compiler + flags + ["-o", tmp] + list(sources),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed ({' '.join(compiler)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library(name: str, compiler: list, flags: list,
                 sources: list) -> ctypes.CDLL:
    """build_library + ctypes.CDLL, once per process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(
            build_library(name, compiler, flags, sources))
    return lib
