"""Sparse-voxel-grid sampling and the per-ray volume render (port of
``nerf_projects_tpu/ops/grid.py``).

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

The render visits every sample of every ray, no tiles: it is the exact
route of ``cli/render_imgs.py`` and the independent reference of the
tile march's tests. Beside cuvol it has the svox1 (nearest cell) and
nvol (Neural-Volumes compositing) backends, background models composited
behind the grid (``ops/background.py``), learned colour bases
(``sh_mult``, ``ops/basis.py``) and the render CLI's fast route: a dense
density cache (``make_render_cache``) and colour fetched only at the
top-K weighted samples of a ray (``color_top_k``). ``sample_grid`` and
``volume_render_depth`` are the grid's readers.
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
    backend: str = "cuvol"          # cuvol | nvol | svox1 (svox2.py:48)
    color_mode: str = "bias"        # "bias" (+0.5 clamp) | "sigmoid"


_CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))  # dz fastest


def _lower_corner(reso, gpts: torch.Tensor):
    """(flat index of each point's lower corner [...], weights [..., 3]):
    the corner clamped to [0, reso - 2] and the weights to [0, 1]
    (svox2.py:598-653), so a sample on the upper face reads the last cell
    and nothing past it."""
    _, Y, Z = reso
    reso_t = device_constant(tuple(reso), torch.int64, gpts.device)
    l = torch.minimum(torch.clamp(torch.floor(gpts).to(torch.int32), min=0), reso_t - 2)
    w = torch.clamp(gpts - l.to(gpts.dtype), 0.0, 1.0)
    return (l[..., 0] * Y + l[..., 1]) * Z + l[..., 2], w


def _corner_weight(w: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return (wx if dx else 1 - wx) * (wy if dy else 1 - wy) * (wz if dz else 1 - wz)


def gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data[idx]`` for row indices ``idx`` [...] -> [..., C], through
    ``index_select``: its backward adds with ``index_add_``, where that
    of ``data[idx]`` sorts the indices first (on the card ~10 s a step of
    the cell route at 256^3, 5,120 rays)."""
    return data.index_select(0, idx.reshape(-1)).reshape(idx.shape + data.shape[1:])


def trilerp(grid: SparseGrid, data: torch.Tensor, gpts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of compact ``data`` [cap, C] at grid
    coordinates [..., 3] -> [..., C]. The eight corners are gathered and
    added one at a time, so the largest temporaries are [..., C], never
    [..., 8, C] (an exact chunk of 16,384 rays at 512^3 and basis 9 would
    need ~25 GB for each of those)."""
    Y, Z = grid.reso[1], grid.reso[2]
    base, w = _lower_corner(grid.reso, gpts)
    flat = grid.links.reshape(-1)
    out = None
    for dx, dy, dz in _CORNERS:
        lnk = flat[base + (dx * Y * Z + dy * Z + dz)]
        vals = torch.where((lnk >= 0)[..., None], gather_rows(data, torch.clamp(lnk, min=0).long()), 0.0)
        term = vals * _corner_weight(w, dx, dy, dz)[..., None]
        out = term if out is None else out + term
    return out


def make_render_cache(grid: SparseGrid, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense density volume [X*Y*Z] in ``dtype`` for evaluation renders
    (``volume_render_grid(dense_density=...)``): one gather a corner
    instead of a link read and then a row read."""
    flat = grid.links.reshape(-1)
    dens = grid.density_data[torch.clamp(flat, min=0).long(), 0].to(dtype)
    return torch.where(flat >= 0, dens, torch.zeros((), dtype=dtype, device=dens.device))


def _trilerp_dense_flat(dense_flat: torch.Tensor, reso, gpts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a dense flat [X*Y*Z] scalar volume at
    grid coordinates [...] -> float32 [...]."""
    Y, Z = reso[1], reso[2]
    base, w = _lower_corner(reso, gpts)
    out = None
    for dx, dy, dz in _CORNERS:
        term = dense_flat[base + (dx * Y * Z + dy * Z + dz)].float() * _corner_weight(w, dx, dy, dz)
        out = term if out is None else out + term
    return out


def sample_grid(grid: SparseGrid, pts: torch.Tensor, *, want_colors: bool = True):
    """(density [..., 1], sh [..., 3B] or None) at world points [..., 3],
    the reference's ``SparseGrid.sample``."""
    gpts = grid.world_to_grid(pts)
    density = trilerp(grid, grid.density_data, gpts)
    colors = trilerp(grid, grid.sh_data, gpts) if want_colors else None
    return density, colors


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


def _composite_background(out_rgb, acc, rays: Rays, grid: SparseGrid, background, opts: GridRenderOptions):
    """Add what lies behind the grid: a ``BackgroundMSI``, a svox2
    checkpoint's ``ReferenceBackground`` (the reference's MSI march) or,
    with None, the solid ``background_brightness``."""
    if background is None:
        return out_rgb + (1.0 - acc[:, None]) * opts.background_brightness
    from nerf_projects_tpu_torch.ops.background import (
        ReferenceBackground,
        render_background,
        render_background_reference,
    )

    if isinstance(background, ReferenceBackground):
        return out_rgb + render_background_reference(
            background, rays.origins, rays.directions, 1.0 - acc, radius=grid.radius, center=grid.center,
            step_size=opts.step_size, background_brightness=opts.background_brightness)
    return out_rgb + render_background(background, rays.origins, rays.directions, 1.0 - acc,
                                       background_brightness=opts.background_brightness)


def _march(grid: SparseGrid, rays: Rays, opts: GridRenderOptions, occupancy=None, active_steps=None):
    """The samples of every ray: (origins_g, dirs_g, world_len,
    step_world, t [R, S], in_bounds [R, S], gpts [R, S, 3])."""
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
    return origins_g, dirs_g, world_len, step_world, t, in_bounds, gpts


def _cuvol_weights(tau: torch.Tensor, stop_thresh: float):
    """(weights, active) of the cuvol compositing: transmittance from the
    exclusive cumulative optical depth, zero once below stop_thresh."""
    log_T = torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
    T = torch.exp(-log_T)
    alpha = 1.0 - torch.exp(-tau)
    active = T > stop_thresh
    return torch.where(active, T * alpha, 0.0), active


def volume_render_grid(
    grid: SparseGrid,
    rays: Rays,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    return_depth: bool = False,
    occupancy=None,
    active_steps: Optional[int] = None,
    background=None,
    color_top_k: Optional[int] = None,
    dense_density: Optional[torch.Tensor] = None,
    sh_mult: Optional[torch.Tensor] = None,
):
    """Render [R] rays against the grid -> dict(rgb [R, 3], acc,
    weights, sigma, log_transmit[, depth]).

    A fixed march of ``opts.max_steps`` (default: the grid diagonal)
    from each ray's entry with masked accumulation. ``occupancy`` (an
    ``OccupancyGrid``) shrinks each interval to its occupied span and
    ``active_steps`` bounds the steps spent there. ``background``: a
    ``BackgroundMSI`` or ``ReferenceBackground`` behind the grid (None:
    the solid ``background_brightness``). ``sh_mult`` [R, B]: the basis
    values of a learned basis (``ops/basis.py::eval_basis``) in place of
    the analytic SH. ``color_top_k`` (cuvol only): fetch colour only at
    the K samples of largest weight, reading density from
    ``dense_density`` (``make_render_cache``) when given; the dropped
    samples' colour is lost, so the result is exact when K covers every
    sample of nonzero weight."""
    origins_g, dirs_g, world_len, step_world, t, in_bounds, gpts = _march(grid, rays, opts, occupancy, active_steps)
    if color_top_k is not None and opts.backend == "cuvol":
        return _render_top_k(grid, rays, opts, origins_g, dirs_g, gpts, t, in_bounds, step_world, world_len,
                             color_top_k, return_depth, background, dense_density, sh_mult=sh_mult)
    if opts.backend == "svox1":
        # the nearest cell (the PlenOctree-compatible backend,
        # render_svox1_kernel.cu); torch.round rounds half to even, as
        # jnp.round does
        reso_i = device_constant(tuple(grid.reso), torch.int64, gpts.device)
        cell = torch.minimum(torch.clamp(torch.round(gpts).to(torch.int64), min=0), reso_i - 1)
        link = grid.links[cell[..., 0], cell[..., 1], cell[..., 2]]
        safe = torch.clamp(link, min=0).long()
        density = torch.where(link >= 0, grid.density_data[safe][..., 0], 0.0)
        sh_coeffs = torch.where((link >= 0)[..., None], grid.sh_data[safe], 0.0)
    elif opts.backend in ("cuvol", "nvol"):
        density = trilerp(grid, grid.density_data, gpts)[..., 0]  # [R, S]
        sh_coeffs = trilerp(grid, grid.sh_data, gpts)  # [R, S, 3B]
    else:
        raise ValueError(f"unknown backend {opts.backend!r}")
    density = torch.where(in_bounds, density, 0.0)
    density = torch.where(density > opts.sigma_thresh, density, 0.0)
    basis = sh_mult if sh_mult is not None else eval_sh_bases(grid.basis_dim, rays.viewdirs)  # [R, B]
    coeffs = sh_coeffs.reshape(sh_coeffs.shape[:-1] + (3, grid.basis_dim))
    rgb = decode_rgb(coeffs, basis[:, None, :], opts.color_mode)  # [R, S, 3]

    tau = density * step_world[:, None]
    if opts.backend == "nvol":
        # Neural Volumes (render_lerp_kernel_nvol.cu): an absolute
        # transmittance, total alpha = min(cumsum(1 - exp(-tau)), 1), and
        # weight_i = total_alpha_i - total_alpha_{i-1}
        cum = torch.clamp(torch.cumsum(1.0 - torch.exp(-tau), dim=-1), max=1.0)
        weights = cum - torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
        log_transmit = torch.log(torch.clamp(1.0 - cum[:, -1], min=1e-30))
    else:
        weights, active = _cuvol_weights(tau, opts.stop_thresh)
        log_transmit = -torch.sum(torch.where(active, tau, 0.0), dim=-1)

    out_rgb = torch.einsum("rs,rsc->rc", weights, rgb)
    acc = torch.sum(weights, dim=-1)
    out_rgb = _composite_background(out_rgb, acc, rays, grid, background, opts)
    result = {"rgb": out_rgb, "acc": acc, "weights": weights, "sigma": density,
              "log_transmit": log_transmit}
    if return_depth:
        result["depth"] = torch.sum(weights * t, dim=-1) * world_len
    return result


def volume_render_depth(grid: SparseGrid, rays: Rays, opts: GridRenderOptions = GridRenderOptions(), *,
                        sigma_thresh: Optional[float] = None) -> torch.Tensor:
    """Depth per ray [R], the reference's ``volume_render_depth``
    (svox2.py:1181-1203). sigma_thresh None: the expected termination
    depth, weights . t (render_lerp_kernel_cuvol.cu:122-177). A number:
    the Dex-NeRF depth, the distance to the first sample whose density
    exceeds it, 0 where no sample does (:180-226)."""
    if sigma_thresh is None:
        return volume_render_grid(grid, rays, opts, return_depth=True)["depth"]
    _, _, world_len, _, t, in_bounds, gpts = _march(grid, rays, opts)
    density = trilerp(grid, grid.density_data, gpts)[..., 0]
    crossed = in_bounds & (density > sigma_thresh)
    first = torch.argmax(crossed.to(torch.uint8), dim=-1)  # the first crossing, as jnp.argmax
    t_first = torch.gather(t, -1, first[:, None])[:, 0]
    return torch.where(crossed.any(dim=-1), t_first * world_len, 0.0)


def _render_top_k(grid, rays, opts, origins_g, dirs_g, gpts, t, in_bounds, step_world, world_len, k, return_depth,
                  background, dense_density=None, sh_mult=None):
    """The fast cuvol render: densities only over the march, then colour
    at the k samples of largest weight of each ray."""
    if dense_density is not None:
        density = _trilerp_dense_flat(dense_density, grid.reso, gpts)
    else:
        density = trilerp(grid, grid.density_data, gpts)[..., 0]
    density = torch.where(in_bounds, density, 0.0)
    density = torch.where(density > opts.sigma_thresh, density, 0.0)
    tau = density * step_world[:, None]
    weights, active = _cuvol_weights(tau, opts.stop_thresh)  # [R, S]

    top_w, top_idx = torch.topk(weights, k, dim=-1)  # [R, K]
    sel_t = torch.gather(t, -1, top_idx)
    sel_pts = origins_g[:, None, :] + sel_t[..., None] * dirs_g[:, None, :]
    sh_coeffs = trilerp(grid, grid.sh_data, sel_pts)  # [R, K, 3B]
    basis = sh_mult if sh_mult is not None else eval_sh_bases(grid.basis_dim, rays.viewdirs)
    coeffs = sh_coeffs.reshape(sh_coeffs.shape[:-1] + (3, grid.basis_dim))
    rgb = decode_rgb(coeffs, basis[:, None, :], opts.color_mode)  # [R, K, 3]

    out_rgb = torch.einsum("rk,rkc->rc", top_w, rgb)
    acc = torch.sum(weights, dim=-1)
    out_rgb = _composite_background(out_rgb, acc, rays, grid, background, opts)
    result = {"rgb": out_rgb, "acc": acc, "weights": weights, "sigma": density,
              "log_transmit": -torch.sum(torch.where(active, tau, 0.0), dim=-1)}
    if return_depth:
        result["depth"] = torch.sum(weights * t, dim=-1) * world_len
    return result
