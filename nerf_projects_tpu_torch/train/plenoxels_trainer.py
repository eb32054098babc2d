"""Plenoxels training on the brick/tile route (port of the tile steps of
``nerf_projects_tpu/train/plenoxels_trainer.py``).

Parity target: the reference's train loop (svox2/opt/opt.py:395-898):
MSE on coherent ray tiles with the beta and Cauchy sparsity gradients
fused into the backward (volume_render_fused, opt.py:699-701), sampled
TV on density and SH (inplace_tv_grad / inplace_tv_color_grad,
opt.py:794-811, here over bricks: ``ops/tv_bricks.py``), optional L2
colour shrinkage, then fused RMSprop or SGD per parameter group with
log-lerp schedules (optim_kernel.cu:20-27, 98-160).

``train_step_tiles_pallas`` is the hot step: the march (K3) and its
backward (K4) through ``ops/kernels/tile_march.py::render_fused_tiles_pallas``,
no autograd graph, as the CUDA original. ``train_step_tiles`` is its
plain counterpart, autograd through ``ops/tile_render.py::render_tiles``.
``train_step`` is the reference-exact cell route: autograd through the
per-ray render of a SparseGrid (``ops/grid.py``) with the cell-level
sampled TV of ``ops/tv.py``; it runs no kernel. ``train_step_bg`` (a
background MSI behind the grid, opt.py's bg_optim path) and
``train_step_with_basis`` (a learned colour basis, opt.py's lr_basis path)
are the cell route with one more set of parameters, each under its own
RMSprop. ``tv_loss`` over ``build_neighbor_links`` (a g++-built host op)
reports the full-grid TV. Each step returns a new
grid and optimizer state (the masters are replaced, not updated in
place); the cells the kernels read are rebuilt from the float32 masters
on every step. Nothing in a step waits for the card: the learning rates
come from the step number on the host, and the TV windows from a
``torch.Generator`` that the caller passes, which should live on the
grid's device.

The packed, sparse and touched-row steps are in
``train/plenoxels_sparse.py``, over the same trainer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.ops.brick_grid import BRICK, BrickGrid
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions, volume_render_grid
from nerf_projects_tpu_torch.ops.kernels.tile_march import render_fused_tiles_pallas
from nerf_projects_tpu_torch.ops.tile_render import render_tiles
from nerf_projects_tpu_torch.ops.tv import (
    l2_color_grad,
    lumisphere_directions,
    sample_window,
    tv_grad_sampled,
    tv_lumisphere_grad_sampled,
)
from nerf_projects_tpu_torch.ops.tv_bricks import sample_brick_window, tv_grad_bricks
from nerf_projects_tpu_torch.train.schedules import log_linear_decay


def neighbor_links_reference(links) -> np.ndarray:
    """The plain version of ``build_neighbor_links``: the JAX package's
    numpy loop."""
    links = np.asarray(links.cpu() if torch.is_tensor(links) else links)
    cap = int(links.max()) + 1
    nbr = np.full((cap, 3), -1, np.int32)
    active = np.argwhere(links >= 0)
    rows = links[active[:, 0], active[:, 1], active[:, 2]]
    for axis in range(3):
        shifted = active.copy()
        shifted[:, axis] += 1
        ok = shifted[:, axis] < links.shape[axis]
        n_rows = np.full(len(active), -1, np.int32)
        n_rows[ok] = links[shifted[ok, 0], shifted[ok, 1], shifted[ok, 2]]
        nbr[rows, axis] = n_rows
    return nbr


def build_neighbor_links(links) -> np.ndarray:
    """int32 [cap, 3]: the compact rows of the +x, +y, +z neighbours of
    each active cell (-1 where empty or past the grid), cap = the largest
    link + 1; ``links`` a tensor or array [X, Y, Z]. A host op
    (``utils/native.py``) for the full-grid TV loss; training takes the
    sampled TV gradients of ``ops/tv.py``."""
    from nerf_projects_tpu_torch.utils import native

    links = np.asarray(links.cpu() if torch.is_tensor(links) else links)
    return native.build_neighbor_links(links, int(links.max()) + 1)


def tv_loss(data: torch.Tensor, nbr) -> torch.Tensor:
    """Isotropic total variation over the active cells through their
    neighbour rows: data [cap, C], nbr [cap, 3] (a tensor or array);
    differences to empty neighbours are 0 (the reference's link-guarded
    TV, loss_kernel.cu:65-110). The loss value, for reporting."""
    nbr = torch.as_tensor(np.asarray(nbr) if not torch.is_tensor(nbr) else nbr, device=data.device)
    sq = 0.0
    for axis in range(3):
        n = nbr[:, axis]
        d = torch.where((n >= 0)[:, None], data[torch.clamp(n, min=0).long()] - data, 0.0)
        sq = sq + torch.sum(d * d, dim=-1)
    return torch.mean(torch.sqrt(sq + 1e-12))


class RMSState(NamedTuple):
    rms_density: torch.Tensor
    rms_sh: torch.Tensor

    @classmethod
    def from_numpy(cls, rms_density, rms_sh, device: Optional[Union[str, torch.device]] = None) -> "RMSState":
        """Optimizer state from host arrays (e.g. a JAX package RMSState's
        fields as numpy arrays), float32 on ``device`` (None: the card)."""
        dev = resolve_device(device)
        return cls(*(torch.from_numpy(np.array(a, np.float32)).to(dev)
                     for a in (rms_density, rms_sh)))


def _psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


class PlenoxelsTrainer:
    def __init__(
        self,
        opts: GridRenderOptions = GridRenderOptions(),
        *,
        n_iters: int = 128_000,
        lr_sigma: float = 3e1,
        lr_sigma_final: float = 5e-2,
        lr_sigma_delay_steps: int = 15000,
        lr_sigma_delay_mult: float = 1e-2,
        lr_sh: float = 1e-2,
        lr_sh_final: float = 5e-6,
        lambda_tv: float = 1e-5,
        tv_sparsity: float = 0.01,
        lambda_tv_sh: float = 1e-3,
        tv_sh_sparsity: float = 0.01,
        lambda_beta: float = 0.0,
        lambda_sparsity: float = 0.0,
        lambda_l2_sh: float = 0.0,
        lambda_tv_lumisphere: float = 0.0,
        tv_lumisphere_sparsity: float = 0.01,
        tv_lumisphere_dir_factor: float = 0.0,
        sigma_optim: str = "rmsprop",
        sh_optim: str = "rmsprop",
        rms_beta: float = 0.95,
        rms_pervisit: bool = False,
        density_minval: float = -1e9,
        bf16_grad_blocks: bool = False,
        use_occupancy: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """The JAX trainer's knobs with its defaults. The lumisphere TV
        knobs are read by the cell route only; ``rms_pervisit`` by the
        row-sparse steps (``train/plenoxels_sparse.py``), not by the dense
        steps here. ``bf16_grad_blocks`` sets the TPU's
        gradient-block dtype, which the port's backward ignores (it adds
        float32 gradients straight into the brick arrays). ``device``:
        where the grids to train live (None: the card, raising without
        one; the host only with "cpu")."""
        self.device = resolve_device(device)
        self.opts = opts
        self.lambda_tv = lambda_tv
        self.tv_sparsity = tv_sparsity
        self.lambda_tv_sh = lambda_tv_sh
        self.tv_sh_sparsity = tv_sh_sparsity
        self.lambda_beta = lambda_beta
        self.lambda_sparsity = lambda_sparsity
        self.lambda_l2_sh = lambda_l2_sh
        self.lambda_tv_lumisphere = lambda_tv_lumisphere
        self.tv_lumisphere_sparsity = tv_lumisphere_sparsity
        self.tv_lumisphere_dir_factor = tv_lumisphere_dir_factor
        self.sigma_optim = sigma_optim
        self.sh_optim = sh_optim
        self.rms_beta = rms_beta
        self.rms_pervisit = rms_pervisit
        self.density_minval = density_minval
        self.grad_block_dtype = torch.bfloat16 if bf16_grad_blocks else torch.float32
        self.use_occupancy = use_occupancy
        self.lr_sigma_fn = log_linear_decay(
            lr_sigma, lr_sigma_final, n_iters,
            lr_delay_steps=lr_sigma_delay_steps, lr_delay_mult=lr_sigma_delay_mult,
        )
        self.lr_sh_fn = log_linear_decay(lr_sh, lr_sh_final, n_iters)

    def _check(self, grid) -> None:
        if grid.device.type != self.device.type:
            raise ValueError(f"the grid is on {grid.device}, the trainer on {self.device}")

    def init_rms(self, grid: SparseGrid) -> RMSState:
        return RMSState(rms_density=torch.zeros_like(grid.density_data), rms_sh=torch.zeros_like(grid.sh_data))

    # -- the cell route ------------------------------------------------------

    def _data_loss(self, out: dict, target: torch.Tensor):
        """MSE + beta + Cauchy sparsity, the fused kernel's loss set:
        (total, mse)."""
        mse = torch.mean((out["rgb"] - target) ** 2)
        total = mse
        if self.lambda_beta > 0:
            # the Neural-Volumes beta prior, averaged over rays (cuvol
            # backward :259-262 with beta_loss / Q at :1127)
            log_T = out["log_transmit"]
            total = total + self.lambda_beta * torch.mean(log_T + torch.log(1.0 - torch.exp(log_T) + 1e-3))
        if self.lambda_sparsity > 0:
            # Cauchy sparsity on every marched sample, unnormalised
            sigma = out["sigma"]
            total = total + self.lambda_sparsity * torch.sum(torch.log1p(2.0 * sigma * sigma))
        return total, mse

    def _tv_grads(self, grid: SparseGrid, generator: torch.Generator):
        """The sampled-fraction TV and L2 gradients of the cell route,
        (g_density or None, g_sh or None), the windows (and the
        lumisphere's directions) drawn from ``generator`` in the order
        density, SH, lumisphere."""
        g_d = g_s = None
        X, Y, Z = grid.reso
        grid_size = X * Y * Z
        if self.lambda_tv > 0:
            cells = sample_window(generator, grid_size, max(int(self.tv_sparsity * grid_size), 1))
            g_d = tv_grad_sampled(grid.links, grid.density_data, cells, scale=self.lambda_tv, ignore_edge=False)
        if self.lambda_tv_sh > 0:
            cells = sample_window(generator, grid_size, max(int(self.tv_sh_sparsity * grid_size), 1))
            g_s = tv_grad_sampled(grid.links, grid.sh_data, cells, scale=self.lambda_tv_sh, ignore_edge=True)
        if self.lambda_tv_lumisphere > 0:
            cells = sample_window(generator, grid_size, max(int(self.tv_lumisphere_sparsity * grid_size), 1))
            g = tv_lumisphere_grad_sampled(grid.links, grid.sh_data, cells, lumisphere_directions(generator),
                                           basis_dim=grid.basis_dim, scale=self.lambda_tv_lumisphere,
                                           dir_factor=self.tv_lumisphere_dir_factor)
            g_s = g if g_s is None else g_s + g
        if self.lambda_l2_sh > 0:
            g = l2_color_grad(grid.sh_data, scale=self.lambda_l2_sh)
            g_s = g if g_s is None else g_s + g
        return g_d, g_s

    def _autograd_cell(self, grid: SparseGrid, generator: torch.Generator, loss_fn, extra=()):
        """Autograd of ``loss_fn(grid, *extra) -> (total, mse)`` over the
        grid's masters and the tensors ``extra``, with the cell route's
        TV and L2 gradients added to the masters': (g_density, g_sh,
        [g of each of extra], total, mse)."""
        self._check(grid)
        dens = grid.density_data.detach().requires_grad_(True)
        sh = grid.sh_data.detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(True) for t in extra]
        total, mse = loss_fn(dataclasses.replace(grid, density_data=dens, sh_data=sh), *leaves)
        g_density, g_sh, *g_extra = torch.autograd.grad(total, (dens, sh, *leaves))
        tv_d, tv_s = self._tv_grads(grid, generator)
        if tv_d is not None:
            g_density = g_density + tv_d
        if tv_s is not None:
            g_sh = g_sh + tv_s
        return g_density, g_sh, g_extra, total.detach(), mse.detach()

    def _cell_apply(self, grid: SparseGrid, rms: RMSState, g_density, g_sh, step):
        new_density, rms_d = self._optim(self.sigma_optim, grid.density_data, g_density, rms.rms_density,
                                         self.lr_sigma_fn(step), minval=self.density_minval)
        new_sh, rms_s = self._optim(self.sh_optim, grid.sh_data, g_sh, rms.rms_sh, self.lr_sh_fn(step))
        return (dataclasses.replace(grid, density_data=new_density, sh_data=new_sh),
                RMSState(rms_density=rms_d, rms_sh=rms_s))

    def cell_grads(self, grid: SparseGrid, rays: Rays, target: torch.Tensor, generator: torch.Generator):
        """The gradients of ``train_step``: (g_density [cap, 1], g_sh
        [cap, 3B], loss, mse), the TV and L2 terms added."""
        g_density, g_sh, _, loss, mse = self._autograd_cell(
            grid, generator, lambda g: self._data_loss(volume_render_grid(g, rays, self.opts), target))
        return g_density, g_sh, loss, mse

    def train_step(self, grid: SparseGrid, rms: RMSState, rays: Rays, target: torch.Tensor, step,
                   generator: torch.Generator):
        """The reference-exact step over a SparseGrid (JAX ``train_step``):
        the per-ray render of [N] rays under autograd, the sampled TV, then
        RMSprop or SGD with the density floor. Returns (grid, rms,
        {"loss", "mse", "psnr"})."""
        g_density, g_sh, loss, mse = self.cell_grads(grid, rays, target, generator)
        new_grid, new_rms = self._cell_apply(grid, rms, g_density, g_sh, step)
        return new_grid, new_rms, {"loss": loss, "mse": mse, "psnr": _psnr(mse)}

    def _rmsprop_plain(self, p, g, r, lr):
        """RMSprop without the first-visit bootstrap, eps 1e-8 (the basis'
        and the background's optimizer in the JAX package)."""
        b = self.rms_beta
        r2 = b * r + (1 - b) * g**2
        return p - lr * g / (torch.sqrt(r2) + 1e-8), r2

    def basis_grads(self, grid: SparseGrid, basis_params, rays: Rays, target: torch.Tensor,
                    generator: torch.Generator, *, basis_type: int, mlp_posenc_size: int = 0):
        """The gradients of ``train_step_with_basis``: (g_density, g_sh,
        g_basis (a tensor, or a dict like ``basis_params``), loss, mse)."""
        from nerf_projects_tpu_torch.ops.basis import eval_basis

        is_mlp = isinstance(basis_params, dict)
        keys = sorted(basis_params) if is_mlp else None
        extra = [basis_params[k] for k in keys] if is_mlp else [basis_params]

        def loss_fn(g, *leaves):
            if is_mlp:
                sh_mult = eval_basis(basis_type, g.basis_dim, rays.viewdirs, mlp_params=dict(zip(keys, leaves)),
                                     mlp_posenc_size=mlp_posenc_size)
            else:
                sh_mult = eval_basis(basis_type, g.basis_dim, rays.viewdirs, basis_data=leaves[0])
            return self._data_loss(volume_render_grid(g, rays, self.opts, sh_mult=sh_mult), target)

        g_density, g_sh, g_extra, loss, mse = self._autograd_cell(grid, generator, loss_fn, extra)
        return g_density, g_sh, dict(zip(keys, g_extra)) if is_mlp else g_extra[0], loss, mse

    def train_step_with_basis(self, grid: SparseGrid, rms: RMSState, basis_params, rms_basis, rays: Rays,
                              target: torch.Tensor, step, generator: torch.Generator, *, basis_type: int,
                              mlp_posenc_size: int = 0, lr_basis: float = 1e-6):
        """The cell route with a learned colour basis (JAX
        ``train_step_with_basis``; opt.py's lr_basis path, svox2.py:2086):
        ``basis_params`` the [r, r, r, B] texture (BASIS_TYPE_3D_TEXTURE)
        or the MLP's parameter dict (BASIS_TYPE_MLP), ``rms_basis`` of the
        same form, updated by RMSprop at ``lr_basis`` and ``rms_beta``.
        Returns (grid, rms, basis_params, rms_basis, {"loss", "mse",
        "psnr"})."""
        g_density, g_sh, g_basis, loss, mse = self.basis_grads(
            grid, basis_params, rays, target, generator, basis_type=basis_type, mlp_posenc_size=mlp_posenc_size)
        new_grid, new_rms = self._cell_apply(grid, rms, g_density, g_sh, step)
        if isinstance(basis_params, dict):
            upd = {k: self._rmsprop_plain(basis_params[k], g_basis[k], rms_basis[k], lr_basis) for k in basis_params}
            new_basis, new_rms_basis = {k: v[0] for k, v in upd.items()}, {k: v[1] for k, v in upd.items()}
        else:
            new_basis, new_rms_basis = self._rmsprop_plain(basis_params, g_basis, rms_basis, lr_basis)
        return new_grid, new_rms, new_basis, new_rms_basis, {"loss": loss, "mse": mse, "psnr": _psnr(mse)}

    def bg_grads(self, grid: SparseGrid, background, rays: Rays, target: torch.Tensor, generator: torch.Generator,
                 *, lambda_tv_bg: float = 1e-3):
        """The gradients of ``train_step_bg``: (g_density, g_sh, g_bg
        [nlayers, H, W, 4], loss, mse)."""
        from nerf_projects_tpu_torch.ops.background import BackgroundMSI, background_tv_loss

        def loss_fn(g, bg_data):
            bg = BackgroundMSI(bg_data, background.radii)
            total, mse = self._data_loss(volume_render_grid(g, rays, self.opts, background=bg), target)
            return total + lambda_tv_bg * background_tv_loss(bg), mse

        g_density, g_sh, (g_bg,), loss, mse = self._autograd_cell(grid, generator, loss_fn, (background.data,))
        return g_density, g_sh, g_bg, loss, mse

    def train_step_bg(self, grid: SparseGrid, background, rms: RMSState, rms_bg: torch.Tensor, rays: Rays,
                      target: torch.Tensor, step, generator: torch.Generator, *, lr_bg_scale: float = 0.1,
                      lambda_tv_bg: float = 1e-3):
        """The cell route with a ``BackgroundMSI`` behind the grid (JAX
        ``train_step_bg``; opt.py's bg_optim path, svox2.py
        optim_background_step): the background's TV over the whole MSI
        (the reference samples a fraction of it), RMSprop on the
        background at lr_sh * lr_bg_scale / 1e-2. Returns (grid,
        background, rms, rms_bg, {"loss", "mse", "psnr"})."""
        from nerf_projects_tpu_torch.ops.background import BackgroundMSI

        g_density, g_sh, g_bg, loss, mse = self.bg_grads(grid, background, rays, target, generator,
                                                         lambda_tv_bg=lambda_tv_bg)
        new_grid, new_rms = self._cell_apply(grid, rms, g_density, g_sh, step)
        new_bg, rms_b = self._rmsprop_plain(background.data, g_bg, rms_bg, self.lr_sh_fn(step) * lr_bg_scale / 1e-2)
        return (new_grid, BackgroundMSI(new_bg, background.radii), new_rms, rms_b,
                {"loss": loss, "mse": mse, "psnr": _psnr(mse)})

    def render_step(self, grid: SparseGrid, rays: Rays):
        return volume_render_grid(grid, rays, self.opts, return_depth=True)

    # -- the brick/tile route ------------------------------------------------

    def init_rms_bricks(self, bg: BrickGrid) -> RMSState:
        return RMSState(rms_density=torch.zeros_like(bg.density_bricks), rms_sh=torch.zeros_like(bg.sh_bricks))

    def _optim(self, optim: str, data, grad, rms, lr, minval=None):
        """Fused RMSprop with a floor, or SGD (optim_kernel.cu:20-27,
        98-160), with the first-visit bootstrap of optim_kernel.cu:21
        (`rms == 0 ? grad^2 : lerp(grad^2, rms, beta)`)."""
        if optim == "rmsprop":
            b = self.rms_beta
            rms = torch.where((rms == 0.0) & (grad != 0.0), grad**2, b * rms + (1 - b) * grad**2)
            new = data - lr * grad / (torch.sqrt(rms) + 1e-8)
        else:  # sgd
            new = data - lr * grad
        if minval is not None:
            new = torch.clamp(new, min=minval)
        return new, rms

    def _regularize(self, bg: BrickGrid, g_density, g_sh, generator: torch.Generator):
        """Add the sampled TV and the L2 colour gradients and zero the
        dead cells' gradients, as both tile steps do."""
        nb = bg.n_bricks
        if self.lambda_tv > 0:
            rows = sample_brick_window(generator, nb, max(int(self.tv_sparsity * nb), 1))
            g_density = g_density + tv_grad_bricks(bg, bg.density_bricks, rows.to(bg.device),
                                                   scale=self.lambda_tv, ignore_edge=False)
        if self.lambda_tv_sh > 0:
            rows = sample_brick_window(generator, nb, max(int(self.tv_sh_sparsity * nb), 1))
            g_sh = g_sh + tv_grad_bricks(bg, bg.sh_bricks, rows.to(bg.device),
                                         scale=self.lambda_tv_sh, ignore_edge=True)
        if self.lambda_l2_sh > 0:
            g_sh = g_sh + (self.lambda_l2_sh / (nb * BRICK**3)) * bg.sh_bricks
        # keep dead cells dead (the reference has no storage for them)
        return g_density * bg.cell_mask, g_sh * bg.cell_mask[..., None]

    def _apply(self, bg: BrickGrid, rms: RMSState, g_density, g_sh, step):
        lr_sigma = self.lr_sigma_fn(step)
        lr_sh = self.lr_sh_fn(step)
        new_density, rms_d = self._optim(self.sigma_optim, bg.density_bricks, g_density, rms.rms_density, lr_sigma,
                                         minval=self.density_minval)
        new_sh, rms_s = self._optim(self.sh_optim, bg.sh_bricks, g_sh, rms.rms_sh, lr_sh)
        # the density floor would resurrect dead cells; re-zero them
        new_density = new_density * bg.cell_mask
        return (dataclasses.replace(bg, density_bricks=new_density, sh_bricks=new_sh),
                RMSState(rms_density=rms_d, rms_sh=rms_s))

    def train_step_tiles(self, bg: BrickGrid, rms: RMSState, rays: Rays, target: torch.Tensor, step,
                         generator: torch.Generator):
        """One step through the plain march under autograd (JAX
        ``train_step_tiles``): rays [T, R] coherent tiles, target
        [T, R, 3]. Returns (bg, rms, {"loss", "mse", "psnr"})."""
        self._check(bg)
        dens = bg.density_bricks.detach().requires_grad_(True)
        sh = bg.sh_bricks.detach().requires_grad_(True)
        out = render_tiles(dataclasses.replace(bg, density_bricks=dens, sh_bricks=sh), rays, self.opts)
        mse = torch.mean((out["rgb"] - target) ** 2)
        total = mse
        if self.lambda_beta > 0:
            log_T = out["log_transmit"]
            total = total + self.lambda_beta * torch.mean(log_T + torch.log(1.0 - torch.exp(log_T) + 1e-3))
        if self.lambda_sparsity > 0:
            total = total + self.lambda_sparsity * torch.sum(out["sparsity_sum"])
        g_density, g_sh = torch.autograd.grad(total, (dens, sh))
        g_density, g_sh = self._regularize(bg, g_density, g_sh, generator)
        new_bg, new_rms = self._apply(bg, rms, g_density, g_sh, step)
        mse = mse.detach()
        return new_bg, new_rms, {"loss": total.detach(), "mse": mse, "psnr": _psnr(mse)}

    def render_tiles_step(self, bg: BrickGrid, rays: Rays):
        return render_tiles(bg, rays, self.opts, return_depth=True)

    def tiles_pallas_grads(self, bg: BrickGrid, rays: Rays, target: torch.Tensor, generator: torch.Generator):
        """The gradients of ``train_step_tiles_pallas``, after TV, L2 and
        the cell mask: (g_density [nb, 512], g_sh [nb, 512, 3B], stats)."""
        self._check(bg)
        rgb, g_density, g_sh, aux = render_fused_tiles_pallas(
            bg, rays, target, self.opts, beta_loss=self.lambda_beta, sparsity_loss=self.lambda_sparsity,
            grad_dtype=self.grad_block_dtype, use_occupancy=self.use_occupancy,
        )
        mse = torch.mean((rgb - target) ** 2)
        g_density, g_sh = self._regularize(bg, g_density, g_sh, generator)
        return g_density, g_sh, {"loss": mse, "mse": mse, "psnr": _psnr(mse), "window_miss": aux["window_miss"]}

    def train_step_tiles_pallas(self, bg: BrickGrid, rms: RMSState, rays: Rays, target: torch.Tensor, step,
                                generator: torch.Generator):
        """The fused hot step (JAX ``train_step_tiles_pallas``): the march
        and its backward kernels (plain versions on host tensors), the
        sampled TV gradients, then RMSprop or SGD; the whole reference
        opt.py step (:699-842) with no autograd graph. rays [T, r]
        coherent tiles, target [T, r, 3], step a number (the learning
        rates' schedule position), generator draws the TV windows.
        Returns (bg, rms, {"loss", "mse", "psnr", "window_miss"}), the
        stats as tensors on the grid's device."""
        g_density, g_sh, stats = self.tiles_pallas_grads(bg, rays, target, generator)
        new_bg, new_rms = self._apply(bg, rms, g_density, g_sh, step)
        return new_bg, new_rms, stats
