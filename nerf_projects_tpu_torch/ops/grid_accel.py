"""Empty-space acceleration for grid rendering (port of
``nerf_projects_tpu/ops/grid_accel.py``).

A coarse occupancy bitmap (links occupancy max-pooled by ``factor``, then
dilated, so a superset of the occupied cells) shrinks each ray's march
interval: ``aabb_t_range`` clips it to the occupied cells' bounding box,
``active_t_range`` to the span its probes find occupied. Samples cut
away lie in empty space, so the render does not change.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import device_constant
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid


class OccupancyGrid(NamedTuple):
    bitmap: torch.Tensor  # bool [X/f, Y/f, Z/f] (conservative superset)
    factor: int


def build_occupancy(grid: SparseGrid, *, factor: int = 8, sigma_thresh: float = 0.0,
                    dilate: int = 1) -> OccupancyGrid:
    """Coarse occupancy from links (and optionally density above
    ``sigma_thresh``), built on the host like the reference's
    ``accelerate()`` (svox2.py:1487), returned on the grid's device."""
    from scipy import ndimage

    links = grid.links.cpu().numpy()
    occ = links >= 0
    if sigma_thresh > 0:
        dens = np.zeros(links.shape, np.float32)
        sel = links >= 0
        dens[sel] = grid.density_data.detach().cpu().numpy()[links[sel], 0]
        occ &= dens > sigma_thresh
    pad = [(0, (-s) % factor) for s in occ.shape]
    occ = np.pad(occ, pad)
    coarse = occ.reshape(
        occ.shape[0] // factor, factor, occ.shape[1] // factor, factor, occ.shape[2] // factor, factor,
    ).any(axis=(1, 3, 5))
    if dilate > 0:
        coarse = ndimage.binary_dilation(coarse, structure=np.ones((3, 3, 3), bool), iterations=dilate)
    return OccupancyGrid(bitmap=torch.from_numpy(coarse).to(grid.device), factor=factor)


def occupied_aabb(occ: OccupancyGrid):
    """Bounding box of the occupied coarse cells in fine voxel units:
    (lo [3], hi [3], any_occ [])."""
    b = occ.bitmap
    f = float(occ.factor)
    lo, hi = [], []
    for ax in range(3):
        red = tuple(a for a in range(3) if a != ax)
        line = b.any(dim=red[1]).any(dim=red[0])
        n = line.shape[0]
        first = torch.argmax(line.to(torch.uint8))
        last = n - 1 - torch.argmax(line.flip(0).to(torch.uint8))
        lo.append(first.float() * f)
        hi.append((last.float() + 1.0) * f)
    return torch.stack(lo), torch.stack(hi), b.any()


def aabb_t_range(occ: OccupancyGrid, origins_g: torch.Tensor, dirs_g: torch.Tensor,
                 t0: torch.Tensor, t1: torch.Tensor):
    """Slab test of grid-space rays against the occupied-cell box,
    intersected with [t0, t1]: (t_enter, t_exit), t_enter > t_exit on a
    miss. A superset of ``active_t_range``'s interval, hence exact."""
    lo, hi, any_occ = occupied_aabb(occ)
    inv = 1.0 / torch.where(dirs_g.abs() < 1e-12, torch.full_like(dirs_g, 1e-12), dirs_g)
    ta = (lo - origins_g) * inv
    tb = (hi - origins_g) * inv
    te = torch.minimum(ta, tb).amax(dim=-1)
    tx = torch.maximum(ta, tb).amin(dim=-1)
    te = torch.maximum(te, t0)
    tx = torch.minimum(tx, t1)
    te = torch.where(any_occ, te, t1)
    tx = torch.where(any_occ, tx, t0)
    return te, tx


def active_t_range(occ: OccupancyGrid, origins_g: torch.Tensor, dirs_g: torch.Tensor,
                   t0: torch.Tensor, t1: torch.Tensor, *, n_probe: int = 256):
    """Shrink [t0, t1] to the occupied sub-interval of each ray, probed
    at ``n_probe`` midpoints and widened by one probe interval each side
    (see the JAX docstring for when a corner clip can fall between
    probes). Returns (t_enter, t_exit); t_enter > t_exit on a miss."""
    f = float(occ.factor)
    reso_c = device_constant(tuple(occ.bitmap.shape), torch.int64, origins_g.device)
    frac = (torch.arange(n_probe, dtype=torch.float32, device=origins_g.device) + 0.5) / n_probe
    t = t0[:, None] + frac[None, :] * (t1 - t0)[:, None]  # [R, P]
    pos = origins_g[:, None, :] + t[..., None] * dirs_g[:, None, :]
    cell = torch.minimum(torch.clamp((pos / f).to(torch.int32), min=0), reso_c - 1)
    hit = occ.bitmap[cell[..., 0].long(), cell[..., 1].long(), cell[..., 2].long()]
    any_hit = hit.any(dim=-1)
    idx = torch.arange(n_probe, device=origins_g.device)
    first = torch.where(hit, idx, n_probe).amin(dim=-1)
    last = torch.where(hit, idx, -1).amax(dim=-1)
    span = (t1 - t0) / n_probe
    t_enter = t0 + torch.clamp(first - 1, min=0) * span
    t_exit = t0 + torch.clamp(last + 2, max=n_probe) * span
    return torch.where(any_hit, t_enter, t1), torch.where(any_hit, t_exit, t0)
