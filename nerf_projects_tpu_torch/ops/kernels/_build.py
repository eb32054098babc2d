"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. ``nvcc`` compiles it for
``sm_90a`` into a shared library in ``_build/`` (listed in .gitignore),
named by a hash of the source and the flags, so a library is rebuilt
only when either changes. The library is written under a temporary name
and renamed into place; nothing else guards the build, so there is no
lock to go stale. A missing ``nvcc`` or a failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
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


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of this source and
    these flags exists already."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
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


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name).path))
