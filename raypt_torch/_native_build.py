"""Build-on-first-use of the port's shared libraries.

A library is compiled from sources in the checkout into
`raypt_torch/_build/` (listed in `.gitignore`), named by a hash of its
sources, the headers they include, compiler and flags, so an edited
file is rebuilt and an unchanged one is loaded as it is. Every source
is compiled to an object by its own compiler process, all started
together, and the objects are linked. A failed
build raises: nothing falls back to another implementation. Concurrent
builders (test workers) each compile to private temporary files and
publish the library with an atomic rename.

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


def _run(name: str, compiler: list, procs: list) -> None:
    """Wait for every compiler process; raise with the output of the
    first that failed."""
    outs = [(p.args, *p.communicate(), p.returncode) for p in procs]
    for args, out, err, rc in outs:
        if rc != 0:
            raise RuntimeError(f"building {name} failed ({' '.join(compiler)}"
                               f"): {' '.join(args)}\n{out}\n{err}")


def _start(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def build_library(name: str, compiler: list, flags: list, link_flags: list,
                  sources: list, headers: tuple = ()) -> str:
    """Compile `sources` into `_build/lib<name>-<hash>.so` unless that
    file exists; returns its path. Each source is compiled with `-c` in
    parallel and the objects are linked with flags + link_flags (which
    must make a shared library). Raises RuntimeError with the compiler's
    output when the build fails."""
    h = hashlib.sha256()
    for part in compiler + flags + link_flags:
        h.update(part.encode())
    for src in list(sources) + list(headers):
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{k}.o" for k in range(len(sources))]
    try:
        _run(name, compiler, [_start(compiler + flags + ["-c", "-o", o, s])
                              for o, s in zip(objs, sources)])
        _run(name, compiler, [_start(compiler + flags + link_flags
                                     + ["-o", tmp] + objs)])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)
    return path


def load_library(name: str, compiler: list, flags: list, link_flags: list,
                 sources: list, headers: tuple = ()) -> ctypes.CDLL:
    """build_library + ctypes.CDLL, once per process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build_library(
            name, compiler, flags, link_flags, sources, headers))
    return lib
