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
