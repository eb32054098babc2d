"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. ``nvcc`` compiles it for
``sm_90a`` into a shared library in ``_build/`` (listed in .gitignore),
named by a hash of the source, the headers it includes from ``csrc/``
(``#include "..."``, followed recursively) and the flags, so a library is
rebuilt when any of them changes. The library is written under a temporary name
and renamed into place; nothing else guards the build, so there is no
lock to go stale. A missing ``nvcc`` or a failed build raises with the
compiler's output.
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


def sources(name: str, csrc: Path = CSRC) -> list:
    """``csrc/<name>.cu`` and every header it includes with ``#include
    "..."``, directly or through another header, in a fixed order."""
    seen, todo = [], [csrc / f"{name}.cu"]
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


def digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of the flags and of ``sources(name)``: names the library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of these sources and
    these flags exists already."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{digest(name)}.so"
    if out.exists():
        return Build(out, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return Build(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


def build_all(names) -> dict:
    """Build several libraries at once, one ``nvcc`` process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name).path))
