"""Spherical-Gaussian radiance basis (port of ``nerf_projects_tpu/ops/sg.py``).

Reference plenoctree/nerf_sh/nerf/sg.py:35-66 (`eval_sg`): output =
(1/N) * sum_i coeffs_i * exp(softplus(lambda_i) * (mu_i . d - 1)), with
lobe directions given as cartesian vectors or as (theta, phi).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def spher2cart(r, theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    x = r * torch.sin(theta) * torch.cos(phi)
    y = r * torch.sin(theta) * torch.sin(phi)
    z = r * torch.cos(theta)
    return torch.stack([x, y, z], dim=-1)


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles [..., 3] (x, y, z, radians) -> rotation matrices
    [..., 3, 3], x @ y @ z."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    zmat = torch.stack([torch.stack([cz, -sz, zeros], -1), torch.stack([sz, cz, zeros], -1),
                        torch.stack([zeros, zeros, ones], -1)], -1)
    ymat = torch.stack([torch.stack([cy, zeros, sy], -1), torch.stack([zeros, ones, zeros], -1),
                        torch.stack([-sy, zeros, cy], -1)], -1)
    xmat = torch.stack([torch.stack([ones, zeros, zeros], -1), torch.stack([zeros, cx, -sx], -1),
                        torch.stack([zeros, sx, cx], -1)], -1)
    return torch.einsum("...ij,...jk,...kq->...iq", xmat, ymat, zmat)


def eval_sg(sg_lambda: torch.Tensor, sg_mu: torch.Tensor, sg_coeffs: torch.Tensor,
            dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate a learnable SG basis at unit directions.

    sg_lambda: lobe sharpness logits [N] or [..., N] (softplus applied);
    sg_mu: lobe directions [..., N, 3] cartesian or [..., N, 2] (theta,
    phi); sg_coeffs: lobe amplitudes [..., C, N]; dirs: [..., 3] unit
    directions. Returns [..., C], divided by the lobe count N.
    """
    sg_lambda = F.softplus(sg_lambda)
    if sg_mu.shape[-1] == 2:
        sg_mu = spher2cart(1.0, sg_mu[..., 0], sg_mu[..., 1])
    product = (sg_mu * dirs[..., None, :]).sum(-1)
    basis = torch.exp(sg_lambda * (product - 1.0))
    out = (sg_coeffs * basis[..., None, :]).sum(-1)
    return out / sg_lambda.shape[-1]
