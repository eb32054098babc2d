"""Mesh extraction from a density field -> OBJ (port of
``nerf_projects_tpu/pipeline/mesh.py``).

Parity target: reference plenoctree/nerf_sh/gen_mesh.py: a dense sigma
grid of the model, its isosurface, and OBJ export (``save_obj``). The
reference uses pymcubes' ``marching_cubes``; like the JAX package this
implements marching tetrahedra (each cube split into 6 tetrahedra, a
16-case table: the same isosurface, a denser triangulation), in host
numpy. The field is evaluated on the caller's device.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device

# Each cube [0,1]^3 split into 6 tetrahedra (vertex indices into the
# canonical cube corner ordering below).
_CUBE_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.float64,
)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int64,
)
# For a tetrahedron with inside-mask bits (v0..v3), the edges (pairs of
# local vertex ids) whose interpolated crossings form the triangle(s).
_TET_EDGES = {
    0b0001: [(0, 1), (0, 2), (0, 3)],
    0b0010: [(1, 0), (1, 3), (1, 2)],
    0b0100: [(2, 0), (2, 1), (2, 3)],
    0b1000: [(3, 0), (3, 2), (3, 1)],
    0b0011: [(0, 2), (1, 2), (1, 3), (0, 2), (1, 3), (0, 3)],
    0b0101: [(0, 1), (2, 1), (2, 3), (0, 1), (2, 3), (0, 3)],
    0b1001: [(0, 1), (3, 1), (3, 2), (0, 1), (3, 2), (0, 2)],
    0b0110: [(1, 0), (2, 0), (2, 3), (1, 0), (2, 3), (1, 3)],
    0b1010: [(1, 0), (3, 0), (3, 2), (1, 0), (3, 2), (1, 2)],
    0b1100: [(2, 0), (3, 0), (3, 1), (2, 0), (3, 1), (2, 1)],
}


def _complement(bits):
    return (~bits) & 0b1111


def marching_tetrahedra(
    field: np.ndarray, iso: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a dense scalar field [X, Y, Z] at level `iso`.

    Returns (vertices [V, 3] in index coordinates, triangles [T, 3]).
    Vectorized over all cubes; memory ~ O(active cubes * 6 tets).
    """
    X, Y, Z = field.shape
    inside = field > iso
    # each cube's eight corners' inside bits, cubes in C order (the JAX
    # package's meshgrid order), from shifted views: no [cubes, 8, 3]
    # index array over every cube
    corner_in = np.stack([inside[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz].reshape(-1)
                          for dx, dy, dz in _CUBE_CORNERS.astype(np.int64)], -1)  # [C, 8]
    active = corner_in.any(1) & ~corner_in.all(1)
    if not active.any():
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    base = np.argwhere(active.reshape(X - 1, Y - 1, Z - 1))
    corner_idx = base[:, None, :] + _CUBE_CORNERS[None, :, :].astype(np.int64)
    corner_in = corner_in[active]
    corner_val = field[
        corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]
    ].astype(np.float64)
    corner_pos = corner_idx.astype(np.float64)

    verts_out = []
    tris_out = []
    n_verts = 0
    for tet in _TETS:
        tv = corner_val[:, tet]       # [C, 4]
        tp = corner_pos[:, tet]       # [C, 4, 3]
        ti = corner_in[:, tet]        # [C, 4]
        bits = (
            ti[:, 0].astype(int)
            | (ti[:, 1].astype(int) << 1)
            | (ti[:, 2].astype(int) << 2)
            | (ti[:, 3].astype(int) << 3)
        )
        for case, edges in _TET_EDGES.items():
            for flip in (False, True):
                want = case if not flip else _complement(case)
                sel = bits == want
                if not sel.any():
                    continue
                v, p = tv[sel], tp[sel]
                pts = []
                for a, b in edges:
                    va, vb = v[:, a], v[:, b]
                    t = (iso - va) / np.where(
                        np.abs(vb - va) < 1e-12, 1e-12, vb - va
                    )
                    t = np.clip(t, 0.0, 1.0)
                    pts.append(p[:, a] + t[:, None] * (p[:, b] - p[:, a]))
                pts = np.stack(pts, 1)  # [S, E, 3]
                n_tri = pts.shape[1] // 3
                for k in range(n_tri):
                    tri_pts = pts[:, 3 * k : 3 * k + 3]
                    if flip:
                        tri_pts = tri_pts[:, ::-1]
                    s = tri_pts.shape[0]
                    verts_out.append(tri_pts.reshape(-1, 3))
                    idx = n_verts + np.arange(s * 3).reshape(s, 3)
                    tris_out.append(idx)
                    n_verts += s * 3
    vertices = np.concatenate(verts_out, 0)
    triangles = np.concatenate(tris_out, 0)
    # dedupe vertices
    rounded = np.round(vertices * 1e5).astype(np.int64)
    uniq, inv = np.unique(rounded, axis=0, return_inverse=True)
    vertices = uniq.astype(np.float64) / 1e5
    triangles = inv[triangles]
    return vertices, triangles


def extract_mesh_from_field(
    sigma_fn: Callable,
    *,
    reso: int = 128,
    radius: float = 1.5,
    iso: float = 25.0,
    chunk: int = 65536,
    device: Optional[Union[str, torch.device]] = None,
):
    """Dense sigma eval -> marching tetrahedra -> world-space (vertices,
    triangles) (gen_mesh.py ``marching_cubes`` equivalent). ``sigma_fn``
    takes points [C, 3] and returns sigma [C] (or [C, 1]) on ``device``
    (None: the card); the grid is read back once."""
    dev = resolve_device(device)
    xs = torch.from_numpy(np.linspace(-radius, radius, reso, dtype=np.float32)).to(dev)
    n = reso**3
    field = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for i in range(0, n, chunk):
            idx = torch.arange(i, min(i + chunk, n), device=dev)
            pts = torch.stack([xs[idx // (reso * reso)], xs[(idx // reso) % reso], xs[idx % reso]], -1)
            field[i:i + chunk] = sigma_fn(pts).reshape(-1)
    verts, tris = marching_tetrahedra(field.reshape(reso, reso, reso).cpu().numpy(), iso)
    # index coords -> world
    scale = 2 * radius / (reso - 1)
    return verts * scale - radius, tris


def save_obj(path: str, vertices: np.ndarray, triangles: np.ndarray):
    """OBJ export (gen_mesh.py:133 ``save_obj``)."""
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in triangles:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
