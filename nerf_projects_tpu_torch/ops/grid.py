"""Sparse-voxel-grid sampling and the exact per-ray volume render (port
of ``nerf_projects_tpu/ops/grid.py``, cuvol backend).

The numerics of the reference's cuvol kernels
(svox2/svox2/csrc/render_lerp_kernel_cuvol.cu:30-120):
  * trilinear interpolation through ``links``; empty cells (link < 0)
    read as zero;
  * a uniform march in grid space of ``step_size`` voxels, converted to
    world units through 1 / |grid-space direction|;
  * SH-decoded colour with the +0.5 bias, clamped at 0 from below;
  * alpha = 1 - exp(-sigma * step_world), transmittance from the
    exclusive cumulative sum of optical depth, sigma_thresh and
    stop_thresh as masks over a fixed number of steps.

This is the exact path: every sample of every ray, no tiles. It is the
default route of ``cli/render_imgs.py`` and the independent reference
of the tile march's tests. The nvol and svox1 backends (asking for them
raises), background models, learned bases (``sh_mult``), the dense
density cache and the top-K colour fast path are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import device_constant
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops.sh import eval_sh_bases


class GridRenderOptions(NamedTuple):
    """Mirror of the reference RenderOptions (svox2.py:17-80)."""

    step_size: float = 0.5          # in voxel units
    sigma_thresh: float = 1e-8      # samples at or below read as empty
    stop_thresh: float = 1e-7       # a ray stops below this transmittance
    near_clip: float = 0.0
    background_brightness: float = 1.0  # 1 = white, 0 = black
    max_steps: Optional[int] = None  # march length; default: the diagonal
    backend: str = "cuvol"          # only cuvol is ported
    color_mode: str = "bias"        # "bias" (+0.5 clamp) | "sigmoid"


def trilerp(grid: SparseGrid, data: torch.Tensor, gpts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of compact ``data`` [cap, C] at grid
    coordinates [..., 3] -> [..., C]: the lower corner clamped to
    [0, reso - 2] and the weights to [0, 1] (svox2.py:598-653), so a
    sample on the upper face reads the last cell and nothing past it."""
    X, Y, Z = grid.reso
    reso = device_constant(grid.reso, torch.int64, gpts.device)
    l = torch.minimum(torch.clamp(torch.floor(gpts).to(torch.int32), min=0), reso - 2)
    w = torch.clamp(gpts - l.to(gpts.dtype), 0.0, 1.0)
    ix, iy, iz = l[..., 0].long(), l[..., 1].long(), l[..., 2].long()
    wx, wy, wz = w[..., 0:1], w[..., 1:2], w[..., 2:3]

    base = (ix * Y + iy) * Z + iz
    offs = device_constant([0, 1, Z, Z + 1, Y * Z, Y * Z + 1, Y * Z + Z, Y * Z + Z + 1], torch.int64, gpts.device)
    links8 = grid.links.reshape(-1)[base[..., None] + offs]  # [..., 8]
    safe = torch.clamp(links8, min=0).long()
    vals = torch.where((links8 >= 0)[..., None], data[safe], 0.0)  # [..., 8, C]
    cw = torch.stack([
        (1 - wx) * (1 - wy) * (1 - wz),
        (1 - wx) * (1 - wy) * wz,
        (1 - wx) * wy * (1 - wz),
        (1 - wx) * wy * wz,
        wx * (1 - wy) * (1 - wz),
        wx * (1 - wy) * wz,
        wx * wy * (1 - wz),
        wx * wy * wz,
    ], dim=-2)  # [..., 8, 1]
    return torch.sum(vals * cw, dim=-2)


def default_max_steps(grid: SparseGrid, step_size: float) -> int:
    diag = float(np.linalg.norm(np.asarray(grid.reso, np.float64)))
    return int(np.ceil(diag / step_size)) + 1


def ray_grid_geometry(reso, radius, origins_g: torch.Tensor, directions: torch.Tensor,
                      opts: GridRenderOptions):
    """Per-ray march geometry in grid space, as the reference's
    ray_find_bounds: (dirs_g, world_len, dt, step_world, t0, t1) with
    [t0, t1) the clip against the sample-safe box [0, reso - 1] and
    ``near_clip``."""
    dev = directions.device
    reso_f = device_constant(np.asarray(reso, np.float32), torch.float32, dev)
    scale = reso_f * 0.5 / device_constant(np.asarray(radius, np.float32), torch.float32, dev)
    dirs_g = directions * scale
    world_len = torch.linalg.norm(directions, dim=-1)
    gnorm = torch.linalg.norm(dirs_g, dim=-1)
    dt = opts.step_size / torch.clamp(gnorm, min=1e-12)
    step_world = dt * world_len
    inv_d = 1.0 / torch.where(dirs_g.abs() < 1e-12, torch.full_like(dirs_g, 1e-12), dirs_g)
    t_lo = (0.0 - origins_g) * inv_d
    t_hi = (reso_f - 1.0 - origins_g) * inv_d
    t0 = torch.minimum(t_lo, t_hi).amax(dim=-1)
    t1 = torch.maximum(t_lo, t_hi).amin(dim=-1)
    t0 = torch.maximum(t0, opts.near_clip / torch.clamp(world_len, min=1e-12))
    return dirs_g, world_len, dt, step_world, t0, t1


def decode_rgb(coeffs: torch.Tensor, basis: torch.Tensor, color_mode: str) -> torch.Tensor:
    """[..., 3, B] SH coefficients and [..., B] basis -> rgb [..., 3]."""
    raw = torch.sum(coeffs * basis[..., None, :], dim=-1)
    if color_mode == "sigmoid":
        return torch.sigmoid(raw)
    return torch.clamp(raw + 0.5, min=0.0)  # +0.5 bias clamp (cuvol:104)


def volume_render_grid(
    grid: SparseGrid,
    rays: Rays,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    return_depth: bool = False,
    occupancy=None,
    active_steps: Optional[int] = None,
):
    """Render [R] rays against the grid -> dict(rgb [R, 3], acc,
    weights, sigma, log_transmit[, depth]).

    A fixed march of ``opts.max_steps`` (default: the grid diagonal)
    from each ray's entry with masked accumulation. ``occupancy`` (an
    ``OccupancyGrid``) shrinks each interval to its occupied span and
    ``active_steps`` bounds the steps spent there."""
    if opts.backend != "cuvol":
        raise NotImplementedError(f"backend {opts.backend!r}: only cuvol is ported")
    origins_g = grid.world_to_grid(rays.origins)
    dirs_g, world_len, dt, step_world, t0, t1 = ray_grid_geometry(
        grid.reso, grid.radius, origins_g, rays.directions, opts)
    if occupancy is not None:
        from nerf_projects_tpu_torch.ops.grid_accel import active_t_range

        t0, t1 = active_t_range(occupancy, origins_g, dirs_g, t0, t1)
    hit = t1 > t0

    max_steps = opts.max_steps or default_max_steps(grid, opts.step_size)
    if occupancy is not None and active_steps is not None:
        max_steps = min(max_steps, active_steps)
    step_idx = torch.arange(max_steps, dtype=torch.float32, device=origins_g.device)
    t = t0[:, None] + step_idx[None, :] * dt[:, None]  # [R, S]
    in_bounds = (t < t1[:, None]) & hit[:, None]

    gpts = origins_g[:, None, :] + t[..., None] * dirs_g[:, None, :]
    density = trilerp(grid, grid.density_data, gpts)[..., 0]  # [R, S]
    sh_coeffs = trilerp(grid, grid.sh_data, gpts)  # [R, S, 3B]
    density = torch.where(in_bounds, density, 0.0)
    density = torch.where(density > opts.sigma_thresh, density, 0.0)
    basis = eval_sh_bases(grid.basis_dim, rays.viewdirs)
    coeffs = sh_coeffs.reshape(sh_coeffs.shape[:-1] + (3, grid.basis_dim))
    rgb = decode_rgb(coeffs, basis[:, None, :], opts.color_mode)  # [R, S, 3]

    tau = density * step_world[:, None]
    log_T = torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
    T = torch.exp(-log_T)
    alpha = 1.0 - torch.exp(-tau)
    active = T > opts.stop_thresh
    weights = torch.where(active, T * alpha, 0.0)

    out_rgb = torch.einsum("rs,rsc->rc", weights, rgb)
    log_transmit = -torch.sum(torch.where(active, tau, 0.0), dim=-1)
    acc = torch.sum(weights, dim=-1)
    out_rgb = out_rgb + (1.0 - acc[:, None]) * opts.background_brightness
    result = {"rgb": out_rgb, "acc": acc, "weights": weights, "sigma": density,
              "log_transmit": log_transmit}
    if return_depth:
        result["depth"] = torch.sum(weights * t, dim=-1) * world_len
    return result
