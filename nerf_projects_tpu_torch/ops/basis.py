"""Learned colour bases for the Plenoxels grid (port of
``nerf_projects_tpu/ops/basis.py``).

svox2's three ``basis_type``s (defs.py:1-4, svox2.py:355-535, 2262-2296):
  * BASIS_TYPE_SH (1): the analytic real SH (``ops/sh.py``), the default;
  * BASIS_TYPE_3D_TEXTURE (4): a learnable [r, r, r, B] volume, sampled
    trilinearly at the direction's point in [-1, 1]^3 (grid_sample with
    align_corners=True and zeros outside, svox2.py:2262);
  * BASIS_TYPE_MLP (255): a 4-layer ReLU MLP of width ``mlp_width`` from
    (optionally encoded) directions to B values, through a sigmoid at use
    (svox2.py:2270-2282, 673-675).

The MLP's parameters are JAX's dict (``w{i}`` [in, out], ``b{i}``) of
tensors; random draws come from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.ops.grid import gather_rows
from nerf_projects_tpu_torch.ops.sh import eval_sh_bases

BASIS_TYPE_SH = 1
BASIS_TYPE_3D_TEXTURE = 4
BASIS_TYPE_MLP = 255


def eval_basis_3d(basis_data: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of basis_data [r, r, r, B] at unit directions
    [..., 3] in [-1, 1]^3 (align_corners=True, zeros outside) -> [..., B]."""
    r = basis_data.shape[0]
    g = (dirs + 1.0) * 0.5 * (r - 1)
    l = torch.floor(g).to(torch.int64)
    w = g - l
    out = torch.zeros(dirs.shape[:-1] + (basis_data.shape[-1],), dtype=basis_data.dtype, device=dirs.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = torch.stack([l[..., 0] + dx, l[..., 1] + dy, l[..., 2] + dz], dim=-1)
                inside = torch.all((c >= 0) & (c <= r - 1), dim=-1)
                cc = torch.clamp(c, 0, r - 1)
                vals = gather_rows(basis_data.reshape(r * r * r, -1),  # its backward adds without sorting
                                   (cc[..., 0] * r + cc[..., 1]) * r + cc[..., 2])
                cw = ((w[..., 0] if dx else 1 - w[..., 0]) * (w[..., 1] if dy else 1 - w[..., 1])
                      * (w[..., 2] if dz else 1 - w[..., 2]))
                out = out + torch.where(inside[..., None], vals * cw[..., None], 0.0)
    return out


def init_basis_3d(basis_reso: int = 16, basis_dim: int = 9,
                  device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    return torch.zeros((basis_reso, basis_reso, basis_reso, basis_dim), dtype=torch.float32,
                       device=resolve_device(device))


def init_basis_mlp(generator: torch.Generator, basis_dim: int = 9, *, mlp_width: int = 16,
                   mlp_posenc_size: int = 0) -> Dict[str, torch.Tensor]:
    """The 4-layer basis MLP's parameters (svox2.py:470-482) on the
    generator's device: weights U[-1/sqrt(in), 1/sqrt(in)] (torch
    Linear's scale), zero biases."""
    dev = generator.device
    dims = [3 + 6 * mlp_posenc_size, mlp_width, mlp_width, mlp_width, basis_dim]
    params = {}
    for i in range(4):
        bound = 1.0 / np.sqrt(dims[i])
        u = torch.rand((dims[i], dims[i + 1]), generator=generator, device=dev)
        params[f"w{i}"] = u * (2 * bound) - bound
        params[f"b{i}"] = torch.zeros((dims[i + 1],), device=dev)
    return params


def mlp_params_from_numpy(params, device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """The basis MLP's parameter dict from host arrays (e.g. the JAX
    package's ``init_basis_mlp`` output), float32 on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev) for k, v in params.items()}


def _posenc_dirs(dirs: torch.Tensor, n_freqs: int) -> torch.Tensor:
    if n_freqs <= 0:
        return dirs
    freqs = 2.0 ** torch.arange(n_freqs, dtype=dirs.dtype, device=dirs.device)
    ang = dirs[..., None, :] * freqs[:, None]  # [..., F, 3]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(dirs.shape[:-1] + (6 * n_freqs,))
    return torch.cat([dirs, enc], dim=-1)


def eval_basis_mlp(params: Dict[str, torch.Tensor], dirs: torch.Tensor, *, mlp_posenc_size: int = 0) -> torch.Tensor:
    """The MLP's raw output; the caller applies the sigmoid
    (svox2.py:675, 903)."""
    x = _posenc_dirs(dirs, mlp_posenc_size)
    for i in range(4):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < 3:
            x = torch.relu(x)
    return x


def eval_basis(basis_type: int, basis_dim: int, dirs: torch.Tensor, *, basis_data: Optional[torch.Tensor] = None,
               mlp_params: Optional[Dict[str, torch.Tensor]] = None, mlp_posenc_size: int = 0) -> torch.Tensor:
    """``sh_mult`` for any basis type, the dispatch of svox2.py:671-677."""
    if basis_type == BASIS_TYPE_3D_TEXTURE:
        return eval_basis_3d(basis_data, dirs)
    if basis_type == BASIS_TYPE_MLP:
        return torch.sigmoid(eval_basis_mlp(mlp_params, dirs, mlp_posenc_size=mlp_posenc_size))
    return eval_sh_bases(basis_dim, dirs)


def _sg_draws(generator: torch.Generator, basis_dim: int, sg_lambda_max: float):
    """The spherical Gaussians' axes (normal, [B, 3]) and sharpnesses
    (U[0, sg_lambda_max), [B]) on the generator's device."""
    mu = torch.randn((basis_dim, 3), generator=generator, device=generator.device)
    lam = torch.rand((basis_dim,), generator=generator, device=generator.device) * sg_lambda_max
    return mu, lam


def reinit_learned_basis(basis_data: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                         init_type: str = "sh", sg_lambda_max: float = 1.0, upper_hemi: bool = False) -> torch.Tensor:
    """The 3D-texture basis seeded with SH or random spherical-Gaussian
    values at each texel's direction (svox2.py reinit_learned_bases);
    ``generator`` draws the Gaussians ("sg" only)."""
    r, B = basis_data.shape[0], basis_data.shape[-1]
    ax = torch.linspace(-1.0, 1.0, r, dtype=torch.float32, device=basis_data.device)
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.stack([X, Y, Z], -1)  # [r, r, r, 3]
    dirs = pts / torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), min=1e-6)
    if init_type == "sh":
        vals = eval_sh_bases(B, dirs.reshape(-1, 3)).reshape(r, r, r, B)
    elif init_type == "sg":
        mu, lam = _sg_draws(generator, B, sg_lambda_max)
        mu = mu.to(basis_data.device)
        mu = mu / torch.linalg.norm(mu, dim=-1, keepdim=True)
        if upper_hemi:
            mu = torch.cat([mu[:, :2], -torch.abs(mu[:, 2:])], dim=-1)
        dot = torch.einsum("xyzc,bc->xyzb", dirs, mu)
        vals = torch.exp(lam.to(basis_data.device) * (dot - 1.0))
    else:
        raise ValueError(f"unknown init_type {init_type}")
    return vals.to(basis_data.dtype)
