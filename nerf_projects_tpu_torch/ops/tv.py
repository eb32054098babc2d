"""Sampled-fraction total-variation gradients for the Plenoxels grid
(port of ``nerf_projects_tpu/ops/tv.py``).

The reference's in-place TV kernels (svox2 loss_kernel.cu:
tv_grad_sparse_kernel:180-248, lumisphere_tv_grad_sparse_kernel:336-470)
as driven by inplace_tv_grad / inplace_tv_color_grad /
inplace_tv_lumisphere_grad / inplace_l2_color_grad (svox2.py:1731-1929),
with the cells chosen as _get_rand_cells does (svox2.py:2224-2241): a
contiguous window of ``max(int(sparse_frac * X*Y*Z), 1)`` flat cell
indices from a random start, wrapping around the end of the grid. The
base cell and its +x, +y, +z neighbours are then slices of the flat
links, offset by Y*Z, Z and 1.

Per sampled cell with value v000 and neighbours v100, v010, v001 (an
empty neighbour reads 0, or v000 with ignore_edge):

    idelta = scale / n / sqrt(1e-9 + dx^2 + dy^2 + dz^2)   (per coefficient)
    g[link100] += dx * (X/256) * idelta   (likewise y, z)
    g[link000] -= (dx*(X/256) + dy*(Y/256) + dz*(Z/256)) * idelta

n the number of sampled cells. A neighbour past the +max face is empty
(the reference reads data row 0 there; the JAX package documents the
same deviation).
"""
from __future__ import annotations

from typing import Optional

import torch

from nerf_projects_tpu_torch.ops.sh import eval_sh_bases


def sample_window(generator: torch.Generator, grid_size: int, window: int) -> torch.Tensor:
    """Contiguous flat-index window with wraparound (svox2.py:2230-2237),
    int32 [window] on the generator's device."""
    dev = generator.device
    start = torch.randint(0, grid_size, (), generator=generator, device=dev)
    return ((start + torch.arange(window, device=dev)) % grid_size).to(torch.int32)


def _window_links(links: torch.Tensor, cells: torch.Tensor):
    """Links of each sampled cell [W] and of its +x, +y, +z neighbours
    (-1 where empty or past the grid)."""
    X, Y, Z = links.shape
    flat = links.reshape(-1)
    n = X * Y * Z
    cells = cells.long().to(links.device)
    z = cells % Z
    y = (cells // Z) % Y
    x = cells // (Y * Z)
    lnk000 = flat[cells]
    lnk100 = torch.where(x + 1 >= X, -1, flat[torch.clamp(cells + Y * Z, max=n - 1)])
    lnk010 = torch.where(y + 1 >= Y, -1, flat[torch.clamp(cells + Z, max=n - 1)])
    lnk001 = torch.where(z + 1 >= Z, -1, flat[torch.clamp(cells + 1, max=n - 1)])
    return lnk000, lnk100, lnk010, lnk001


def _fetch(data: torch.Tensor, lnk: torch.Tensor, null_val: torch.Tensor) -> torch.Tensor:
    return torch.where((lnk >= 0)[:, None], data[torch.clamp(lnk, min=0).long()], null_val)


def _add(grad: torch.Tensor, lnk: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    grad.index_add_(0, torch.clamp(lnk, min=0).long(), torch.where((lnk >= 0)[:, None], val, 0.0))
    return grad


def tv_grad_sampled(links: torch.Tensor, data: torch.Tensor, cells: torch.Tensor, *, scale: float,
                    ignore_edge: bool) -> torch.Tensor:
    """TV gradient over the sampled cells, scatter-added into
    zeros_like(data). ignore_edge False for density (the reference's
    sigma TV), True for SH (a missing neighbour copies the base value, so
    no gradient crosses the sparse boundary)."""
    lnk000, lnk100, lnk010, lnk001 = _window_links(links, cells)
    zero = torch.zeros((1, data.shape[1]), dtype=data.dtype, device=data.device)
    v000 = _fetch(data, lnk000, zero)
    null_val = v000 if ignore_edge else zero
    dx = _fetch(data, lnk100, null_val) - v000
    dy = _fetch(data, lnk010, null_val) - v000
    dz = _fetch(data, lnk001, null_val) - v000
    # a per-coefficient norm (one reference thread per (cell,
    # coefficient)); a mean over the sampled cells (loss_kernel.cu:595)
    idelta = (scale / cells.shape[0]) * torch.rsqrt(1e-9 + dx * dx + dy * dy + dz * dz)
    X, Y, Z = links.shape
    gx = dx * ((X / 256.0) * idelta)
    gy = dy * ((Y / 256.0) * idelta)
    gz = dz * ((Z / 256.0) * idelta)
    grad = torch.zeros_like(data)
    _add(grad, lnk100, gx)
    _add(grad, lnk010, gy)
    _add(grad, lnk001, gz)
    return _add(grad, lnk000, -(gx + gy + gz))


def lumisphere_directions(generator: torch.Generator) -> tuple:
    """The two normal 3-vectors that tv_lumisphere_grad_sampled draws:
    the view direction and the perturbation axis (before normalising)."""
    return (torch.randn(3, generator=generator, device=generator.device),
            torch.randn(3, generator=generator, device=generator.device))


def tv_lumisphere_grad_sampled(links: torch.Tensor, sh_data: torch.Tensor, cells: torch.Tensor,
                               directions: tuple, *, basis_dim: int, scale: float, dir_factor: float = 0.0,
                               dir_perturb_radians: float = 0.05) -> torch.Tensor:
    """View-direction TV of the decoded colour (inplace_tv_lumisphere_grad,
    svox2.py:1822-1896; loss_kernel.cu:336-470) for one random direction
    (``directions``, from ``lumisphere_directions``): spatial differences
    of c = sum_b sh_b basis_b across +x, +y, +z, and with dir_factor a
    difference against a direction perturbed by a first-order rotation of
    dir_perturb_radians, flowing back through the SH (dc/dsh_b = basis_b).
    The spatial differences are scaled by reso/256 before the norm and
    again after it, as the reference kernel does."""
    d_raw, axis_raw = (x.to(sh_data.device, torch.float32) for x in directions)
    d = d_raw / torch.linalg.norm(d_raw)
    basis = eval_sh_bases(basis_dim, d[None])[0]  # [B]
    if dir_factor > 0.0:
        axis = axis_raw / torch.linalg.norm(axis_raw) * dir_perturb_radians
        d_u = d + torch.linalg.cross(axis, d)
        d_u = d_u / torch.linalg.norm(d_u)
        basis_u = eval_sh_bases(basis_dim, d_u[None])[0]
    else:
        basis_u = basis

    lnk000, lnk100, lnk010, lnk001 = _window_links(links, cells)
    zero = torch.zeros((1, sh_data.shape[1]), dtype=sh_data.dtype, device=sh_data.device)
    v000 = _fetch(sh_data, lnk000, zero)
    W = cells.shape[0]

    def decode(v, b):  # [W, 3B] x [B] -> [W, 3]
        return torch.einsum("wcb,b->wc", v.reshape(W, 3, basis_dim), b)

    c000 = decode(v000, basis)
    X, Y, Z = links.shape
    sxa = (X / 256.0, Y / 256.0, Z / 256.0)
    dx = (decode(_fetch(sh_data, lnk100, v000), basis) - c000) * sxa[0]
    dy = (decode(_fetch(sh_data, lnk010, v000), basis) - c000) * sxa[1]
    dz = (decode(_fetch(sh_data, lnk001, v000), basis) - c000) * sxa[2]
    du = (decode(v000, basis_u) - c000) * dir_factor
    idelta = (scale / W) * torch.rsqrt(1e-9 + dx * dx + dy * dy + dz * dz + du * du)
    dx, dy, dz, du = dx * sxa[0], dy * sxa[1], dz * sxa[2], du * dir_factor

    def to_sh(cgrad, b):  # [W, 3] x [B] -> [W, 3B]
        return (cgrad[..., None] * b).reshape(W, 3 * basis_dim)

    g0 = to_sh(-(dx + dy + dz) * idelta, basis) + ((du * idelta)[..., None] * (basis_u - basis)).reshape(
        W, 3 * basis_dim)
    grad = torch.zeros_like(sh_data)
    _add(grad, lnk100, to_sh(dx * idelta, basis))
    _add(grad, lnk010, to_sh(dy * idelta, basis))
    _add(grad, lnk001, to_sh(dz * idelta, basis))
    return _add(grad, lnk000, g0)


def l2_color_grad(sh_data: torch.Tensor, *, scale: float, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2 shrinkage on the SH coefficients (inplace_l2_color_grad,
    svox2.py:1897-1929): (scale / n_rows) * sh_data, n_rows being all rows
    or, with a bool ``mask`` [rows], the rows it selects (zero elsewhere)."""
    if mask is None:
        return (scale / sh_data.shape[0]) * sh_data
    nz = max(int(mask.sum()), 1)
    return torch.where(mask[:, None], (scale / nz) * sh_data, torch.zeros_like(sh_data))
