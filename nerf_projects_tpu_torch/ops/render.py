"""Volume-rendering compositing, the NeRF `raw2outputs` math (port of
``nerf_projects_tpu/ops/render.py``).

relu density and sigmoid rgb come from the caller; here: dists with a
1e10 tail scaled by |d|, the exclusive cumprod of (1 - alpha + 1e-10),
and disp = 1 / max(1e-10, depth / max(1e-10, acc)) ("nerf") or acc /
depth kept inside (0, 1e10) where acc > 1e-10 ("jaxnerf",
plenoctree/nerf_sh/nerf/model_utils.py:176-222). All in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor      # [..., 3] composited colour
    disp: torch.Tensor     # [...] disparity
    acc: torch.Tensor      # [...] accumulated opacity
    weights: torch.Tensor  # [..., N] per-sample weights
    depth: torch.Tensor    # [...] expected depth


def compute_alpha_weights(sigma: torch.Tensor, z_vals: torch.Tensor, dirs: torch.Tensor):
    """sigma, z_vals [..., N] and dirs [..., 3] -> (alpha, weights), [..., N]."""
    eps = 1e-10
    dists = torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[..., :1], 1e10)],
        dim=-1,
    )
    dists = dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cat(
        [torch.ones_like(alpha[..., :1]), torch.cumprod(1.0 - alpha[..., :-1] + eps, dim=-1)],
        dim=-1,
    )
    return alpha, alpha * trans


def volumetric_rendering(
    rgb: torch.Tensor,
    sigma: torch.Tensor,
    z_vals: torch.Tensor,
    dirs: torch.Tensor,
    *,
    white_bkgd: bool = False,
    disp_mode: str = "nerf",
) -> RenderOutputs:
    """Composite per-sample rgb [..., N, 3] (activated) and sigma [..., N]
    (activated, >= 0) at depths z_vals [..., N] along dirs [..., 3]."""
    if disp_mode not in ("nerf", "jaxnerf"):
        raise ValueError(f"unsupported disp_mode: {disp_mode!r}")
    rgb = rgb.float()
    sigma = sigma.float()
    z_vals = z_vals.float()
    _, weights = compute_alpha_weights(sigma, z_vals, dirs)
    comp_rgb = (weights[..., None] * rgb).sum(-2)
    depth = (weights * z_vals).sum(-1)
    acc = weights.sum(-1)
    if disp_mode == "nerf":
        disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    else:
        # jaxnerf: acc / depth where it lies in (0, 1e10) and acc > 1e-10, else 1e10
        disp = acc / depth
        disp = torch.where((disp > 0) & (disp < 1e10) & (acc > 1e-10), disp, torch.full_like(disp, 1e10))
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return RenderOutputs(rgb=comp_rgb, disp=disp, acc=acc, weights=weights, depth=depth)
