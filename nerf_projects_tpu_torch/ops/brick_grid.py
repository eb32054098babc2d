"""Brick-major sparse voxel storage (port of
``nerf_projects_tpu/ops/brick_grid.py``: ``BrickGrid``,
``from_sparse_grid``, ``create_brick_grid``, ``to_sparse_grid``).

Cells are stored in 8x8x8 bricks; ``brick_links`` [BX, BY, BZ] maps a
brick to its row of the compact brick arrays (-1 = every cell empty),
the brick-level analogue of svox2's cell-level links. Empty cells inside
an active brick hold zeros, which renders exactly as an empty cell;
``cell_mask`` keeps the cell-level occupancy for the round trip.

The JAX package's ``gather_windows`` (2x2x2-brick windows for the TPU's
lockstep march) has no counterpart: the port's march
(``ops/kernels/tile_march.py``) reads any brick through ``brick_links``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid, world_to_grid

BRICK = 8  # brick edge in cells


@dataclass
class BrickGrid:
    """brick_links and the geometry are fixed per topology; the data
    tensors live on one device."""

    brick_links: torch.Tensor     # int32 [BX, BY, BZ], -1 = empty brick
    density_bricks: torch.Tensor  # [nb, 512]
    sh_bricks: torch.Tensor       # [nb, 512, 3 * basis_dim]
    cell_mask: torch.Tensor       # bool [nb, 512]: active cells
    brick_coords: torch.Tensor    # int32 [nb, 3]: brick xyz of each row
    reso: Tuple[int, int, int]    # cell resolution (before padding to bricks)
    radius: np.ndarray            # [3]
    center: np.ndarray            # [3]
    basis_dim: int = 9

    @property
    def n_bricks(self) -> int:
        return self.cell_mask.shape[0]

    @property
    def bricks_shape(self) -> Tuple[int, int, int]:
        return tuple(self.brick_links.shape)

    @property
    def device(self) -> torch.device:
        return self.brick_links.device

    def world_to_grid(self, pts: torch.Tensor) -> torch.Tensor:
        """The voxel-unit transform of ``SparseGrid.world_to_grid``."""
        return world_to_grid(pts, self.reso, self.radius, self.center)


def _brick_view(dense: np.ndarray, BX: int, BY: int, BZ: int) -> np.ndarray:
    """[BX*8, BY*8, BZ*8, ...] -> [BX, BY, BZ, 512, ...]."""
    tail = dense.shape[3:]
    v = dense.reshape(BX, BRICK, BY, BRICK, BZ, BRICK, *tail)
    v = np.moveaxis(v, (1, 3), (3, 4))  # [BX, BY, BZ, 8, 8, 8, ...]
    return v.reshape(BX, BY, BZ, BRICK**3, *tail)


def from_sparse_grid(grid: SparseGrid) -> BrickGrid:
    """SparseGrid -> BrickGrid, through host numpy (the npz-interop
    bridge), onto the grid's device."""
    dev = grid.device
    links = grid.links.cpu().numpy()
    X, Y, Z = links.shape
    BX, BY, BZ = -(-X // BRICK), -(-Y // BRICK), -(-Z // BRICK)
    pad = (BX * BRICK - X, BY * BRICK - Y, BZ * BRICK - Z)
    if any(pad):
        links = np.pad(links, [(0, pad[0]), (0, pad[1]), (0, pad[2])], constant_values=-1)
    lb = _brick_view(links, BX, BY, BZ)  # [BX, BY, BZ, 512]
    active = (lb >= 0).any(axis=-1)
    nb = int(active.sum())
    brick_links = np.full((BX, BY, BZ), -1, np.int32)
    brick_links[active] = np.arange(nb, dtype=np.int32)
    brick_coords = np.argwhere(active).astype(np.int32)

    cell_links = lb[active]  # [nb, 512]
    mask = cell_links >= 0
    safe = np.maximum(cell_links, 0)
    density = grid.density_data.detach().cpu().numpy()[:, 0][safe] * mask
    sh = grid.sh_data.detach().cpu().numpy()[safe] * mask[..., None]
    return BrickGrid(
        brick_links=torch.from_numpy(brick_links).to(dev),
        density_bricks=torch.from_numpy(density.astype(np.float32)).to(dev),
        sh_bricks=torch.from_numpy(sh.reshape(nb, BRICK**3, -1).astype(np.float32)).to(dev),
        cell_mask=torch.from_numpy(mask).to(dev),
        brick_coords=torch.from_numpy(brick_coords).to(dev),
        reso=(X, Y, Z),
        radius=np.asarray(grid.radius, np.float32).copy(),
        center=np.asarray(grid.center, np.float32).copy(),
        basis_dim=grid.basis_dim,
    )


def brick_grid_from_numpy(brick_links, density_bricks, sh_bricks, cell_mask, brick_coords, reso, radius,
                          center, basis_dim: int = 9,
                          device: Optional[Union[str, torch.device]] = None) -> BrickGrid:
    """A BrickGrid from host arrays, e.g. the fields of a JAX package
    BrickGrid as numpy arrays (a trained grid carried across), on
    ``device`` (None: the card)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(dev)

    return BrickGrid(
        brick_links=t(brick_links, np.int32),
        density_bricks=t(density_bricks, np.float32),
        sh_bricks=t(sh_bricks, np.float32),
        cell_mask=t(cell_mask, np.bool_),
        brick_coords=t(brick_coords, np.int32),
        reso=tuple(int(r) for r in reso),
        radius=np.asarray(radius, np.float32).copy(),
        center=np.asarray(center, np.float32).copy(),
        basis_dim=int(basis_dim),
    )


def create_brick_grid(
    reso,
    *,
    basis_dim: int = 9,
    radius=1.0,
    center=(0.0, 0.0, 0.0),
    use_sphere_bound: bool = True,
    init_density: float = 0.0,
    data_dtype=torch.float32,
    alloc_data: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> BrickGrid:
    """A BrickGrid built directly, with the per-cell arrays made on
    ``device`` (no [reso^3] host array). Brick occupancy is decided on
    the host at brick resolution: a brick is active when its point
    closest to the centre lies in the sphere of SparseGrid.create's
    use_sphere_bound; the exact cell mask (same test per cell centre)
    is made on the device. ``alloc_data=False`` leaves the data tensors
    as placeholders, for callers that build the march's cell array
    themselves (see ``ops/kernels/tile_march.geometry_only``)."""
    dev = resolve_device(device)
    if isinstance(reso, int):
        reso = (reso, reso, reso)
    X, Y, Z = (int(r) for r in reso)
    if any(r % BRICK for r in (X, Y, Z)):
        raise ValueError(f"reso {reso} must be brick-aligned ({BRICK})")
    BX, BY, BZ = X // BRICK, Y // BRICK, Z // BRICK
    rs = np.asarray([X, Y, Z], np.float64)
    voxel_diag = float(np.linalg.norm(2.0 / rs)) * 0.5
    thresh2 = (1.0 + voxel_diag) ** 2

    if use_sphere_bound:
        bi, bj, bk = np.meshgrid(np.arange(BX), np.arange(BY), np.arange(BZ), indexing="ij")
        lo = (np.stack([bi, bj, bk], -1) * BRICK + 0.5) / rs * 2.0 - 1.0
        hi = (np.stack([bi, bj, bk], -1) * BRICK + BRICK - 0.5) / rs * 2 - 1
        closest = np.clip(0.0, lo, hi)
        active = (closest**2).sum(-1) <= thresh2
    else:
        active = np.ones((BX, BY, BZ), bool)

    nb = int(active.sum())
    brick_links = np.full((BX, BY, BZ), -1, np.int32)
    brick_links[active] = np.arange(nb, dtype=np.int32)
    coords = torch.from_numpy(np.argwhere(active).astype(np.int32)).to(dev)

    off = torch.arange(BRICK**3, dtype=torch.int32, device=dev)
    local = torch.stack([off // (BRICK * BRICK), (off // BRICK) % BRICK, off % BRICK], dim=-1)
    if use_sphere_bound:
        cell = coords[:, None, :] * BRICK + local[None]  # [nb, 512, 3]
        c = (cell.float() + 0.5) / torch.as_tensor(rs, dtype=torch.float32, device=dev) * 2.0 - 1.0
        mask = torch.sum(c * c, dim=-1) <= thresh2
        del cell, c
    else:
        mask = torch.ones((nb, BRICK**3), dtype=torch.bool, device=dev)

    if alloc_data:
        density = torch.full((nb, BRICK**3), init_density, dtype=data_dtype, device=dev) * mask.to(data_dtype)
        sh = torch.zeros((nb, BRICK**3, 3 * basis_dim), dtype=data_dtype, device=dev)
    else:
        density = torch.zeros((nb, 1), dtype=data_dtype, device=dev)
        sh = torch.zeros((nb, 1, 1), dtype=data_dtype, device=dev)
    return BrickGrid(
        brick_links=torch.from_numpy(brick_links).to(dev),
        density_bricks=density,
        sh_bricks=sh,
        cell_mask=mask,
        brick_coords=coords,
        reso=(X, Y, Z),
        radius=np.broadcast_to(np.asarray(radius, np.float32), (3,)).copy(),
        center=np.asarray(center, np.float32).copy(),
        basis_dim=basis_dim,
    )


def to_sparse_grid(bg: BrickGrid) -> SparseGrid:
    """BrickGrid -> SparseGrid (exact round trip through cell_mask), on
    the brick grid's device."""
    BX, BY, BZ = bg.bricks_shape
    X, Y, Z = bg.reso
    brick_links = bg.brick_links.cpu().numpy()
    mask = bg.cell_mask.cpu().numpy()
    density = bg.density_bricks.detach().float().cpu().numpy()
    sh = bg.sh_bricks.detach().float().cpu().numpy()

    order = (np.cumsum(mask.reshape(-1)) - 1).reshape(mask.shape)
    cell_rows = np.where(mask, order, -1)  # [nb, 512]
    dens_out = density[mask][:, None].astype(np.float32)
    sh_out = sh[mask].astype(np.float32)

    cell_links_full = np.full((BX, BY, BZ, BRICK**3), -1, np.int64)
    cell_links_full[brick_links >= 0] = cell_rows[brick_links[brick_links >= 0]]
    v = cell_links_full.reshape(BX, BY, BZ, BRICK, BRICK, BRICK)
    v = v.transpose(0, 3, 1, 4, 2, 5)  # [bx, lx, by, ly, bz, lz]
    links = v.reshape(BX * BRICK, BY * BRICK, BZ * BRICK).astype(np.int32)
    links = np.ascontiguousarray(links[:X, :Y, :Z])
    return SparseGrid.from_numpy(links, dens_out, sh_out, bg.radius, bg.center, bg.basis_dim,
                                 device=bg.device)
