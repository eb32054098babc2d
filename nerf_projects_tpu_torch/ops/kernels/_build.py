"""Build and load the port's CUDA kernels and host ops.

Each ``csrc/<name>.cu`` has a plain C interface. ``nvcc`` compiles it for
``sm_90a`` into a shared library in ``_build/`` (listed in .gitignore); a
host op, ``csrc/<name>.cpp``, is compiled by ``g++`` the same way
(``build_host``, ``load_host``). Each library is
named by a hash of its source, the headers it includes from ``csrc/``
(``#include "..."``, followed recursively) and the flags, so it is
rebuilt when any of them changes. It is written under a temporary name
and renamed into place; nothing else guards the build, so there is no
lock to go stale. A missing compiler or a failed build raises with the
compiler's output; nothing falls back to another version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 600


class Build(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # the compiler's output (ptxas register and spill counts)


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str, csrc: Path = CSRC, suffix: str = ".cu") -> list:
    """``csrc/<name><suffix>`` and every header it includes with
    ``#include "..."``, directly or through another header, in a fixed
    order."""
    seen, todo = [], [csrc / f"{name}{suffix}"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file():
                todo.append(dep)
    return seen


def digest(name: str, csrc: Path = CSRC, flags=NVCC_FLAGS, suffix: str = ".cu") -> str:
    """Hash of the flags and of ``sources(name)``: names the library."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources(name, csrc, suffix):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, find_compiler, flags, suffix: str) -> Build:
    src = CSRC / f"{name}{suffix}"
    out = BUILD_DIR / f"{name}-{digest(name, flags=flags, suffix=suffix)}.so"
    if out.exists():
        return Build(out, 0.0, "")
    compiler = find_compiler()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [compiler, *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed on {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return Build(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of these sources and
    these flags exists already."""
    return _compile(name, find_nvcc, NVCC_FLAGS, ".cu")


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host ops are compiled with g++")
    return gxx


def build_host(name: str) -> Build:
    """Compile the host op ``csrc/<name>.cpp`` with g++ unless a library
    of these sources and these flags exists already."""
    return _compile(name, find_gxx, GXX_FLAGS, ".cpp")


def build_all(names) -> dict:
    """Build several libraries at once, one ``nvcc`` process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name).path))


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host op ``csrc/<name>.cpp``, built on
    first use."""
    return ctypes.CDLL(str(build_host(name).path))
