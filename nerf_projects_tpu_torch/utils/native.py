"""The port's native host ops (port of ``nerf_projects_tpu/utils/native.py``:
``octree_leaf_geometry``, ``median_cut`` and ``build_neighbor_links``).

``csrc/native_ops.cpp`` is compiled by g++ at first use into ``_build/``
(``ops/kernels/_build.py::build_host``). Unlike the JAX package's loader,
a missing compiler or a failed build raises with the compiler's output:
nothing falls back to a Python version. The numpy versions that the
tests hold the ops to are ``train/plenoxels_trainer.py::neighbor_links_reference``
and, for the octree walk and the median cut, the JAX package's Python
paths, kept in ``tests/test_torch_octree.py``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from nerf_projects_tpu_torch.ops.kernels import _build


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("native_ops")
    i32, i64, f32, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_double
    P = ctypes.POINTER
    lib.build_neighbor_links.argtypes = [P(i32), i64, i64, i64, P(i32), i64]
    lib.build_neighbor_links.restype = None
    lib.octree_leaf_geometry.argtypes = [P(i32), i64, P(i32), P(f64), P(f64), P(ctypes.c_uint8)]
    lib.octree_leaf_geometry.restype = None
    lib.median_cut.argtypes = [P(f32), i64, i64, i64, P(i32), P(f32)]
    lib.median_cut.restype = i64
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
    _lib().build_neighbor_links(_ptr(links, ctypes.c_int32), X, Y, Z, _ptr(nbr, ctypes.c_int32), cap)
    return nbr


def octree_leaf_geometry(child: np.ndarray):
    """child int32 [N, 2, 2, 2] (relative offsets, 0 = leaf) -> each
    cell's (depth int32 [N, 8], lower corner float64 [N, 8, 3] and edge
    float64 [N, 8] in the unit cube, is_leaf bool [N, 8]), cells in
    i * 4 + j * 2 + k order. A child's index must exceed its parent's
    (an append-only refine gives that)."""
    child = np.ascontiguousarray(np.asarray(child).reshape(-1, 8), np.int32)
    n = child.shape[0]
    depth = np.empty((n, 8), np.int32)
    corner = np.empty((n, 8, 3), np.float64)
    size = np.empty((n, 8), np.float64)
    is_leaf = np.empty((n, 8), np.uint8)
    _lib().octree_leaf_geometry(_ptr(child, ctypes.c_int32), n, _ptr(depth, ctypes.c_int32),
                                _ptr(corner, ctypes.c_double), _ptr(size, ctypes.c_double),
                                _ptr(is_leaf, ctypes.c_uint8))
    return depth, corner, size, is_leaf.astype(bool)


def median_cut(vectors: np.ndarray, n_colors: int):
    """Median-cut quantization of vectors [n, c] (n > 0, c <= 4) to at
    most ``n_colors`` palette entries: (palette float16 [k, c], ids [n],
    uint16 where k <= 65536, else uint32)."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, c = vectors.shape
    if c > 4:
        raise ValueError(f"median_cut takes vectors of at most 4 channels, got {c}")
    ids = np.empty(n, np.int32)
    palette = np.zeros((n_colors, c), np.float32)
    k = _lib().median_cut(_ptr(vectors, ctypes.c_float), n, c, n_colors, _ptr(ids, ctypes.c_int32),
                          _ptr(palette, ctypes.c_float))
    k = max(int(k), 1)
    id_dtype = np.uint16 if k <= 65536 else np.uint32
    return palette[:k].astype(np.float16), ids.astype(id_dtype)
