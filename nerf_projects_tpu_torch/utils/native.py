"""The port's native host ops (port of ``nerf_projects_tpu/utils/native.py``,
``build_neighbor_links`` only).

``csrc/native_ops.cpp`` is compiled by g++ at first use into ``_build/``
(``ops/kernels/_build.py::build_host``). Unlike the JAX package's loader,
a missing compiler or a failed build raises with the compiler's output:
nothing falls back to a Python version. The numpy version that the tests
hold the op to is ``train/plenoxels_trainer.py::neighbor_links_reference``.
"""
from __future__ import annotations

import ctypes

import numpy as np

from nerf_projects_tpu_torch.ops.kernels import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load_host("native_ops")
    lib.build_neighbor_links.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.build_neighbor_links.restype = None
    return lib


def build_neighbor_links(links: np.ndarray, cap: int) -> np.ndarray:
    """int32 [cap, 3]: the compact rows of the +x, +y, +z neighbours of
    each active cell of ``links`` int32 [X, Y, Z] (-1 where the neighbour
    is empty or past the grid)."""
    links = np.ascontiguousarray(links, np.int32)
    if links.ndim != 3:
        raise ValueError(f"links must be [X, Y, Z], got shape {links.shape}")
    if links.size and int(links.max()) >= cap:
        raise ValueError(f"a link ({int(links.max())}) is outside the {cap} rows of the output")
    X, Y, Z = links.shape
    nbr = np.empty((cap, 3), np.int32)
    ptr = ctypes.POINTER(ctypes.c_int32)
    _lib().build_neighbor_links(links.ctypes.data_as(ptr), X, Y, Z, nbr.ctypes.data_as(ptr), cap)
    return nbr
