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


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` over the last dimension of factors that are never
    zero, with a backward that reads nothing to the host: for c = cumprod(f),
    dL/df_j = sum_{k >= j} g_k c_k / f_j, a reverse cumulative sum divided
    by the factor. (``torch.cumprod``'s own backward tests its input for
    zeros on the host, so on a card it waits for the queue to drain.)"""

    @staticmethod
    def forward(ctx, f):
        c = torch.cumprod(f, dim=-1)
        ctx.save_for_backward(f, c)
        return c

    @staticmethod
    def backward(ctx, g):
        f, c = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(g * c, (-1,)), dim=-1), (-1,)) / f


def _alpha(sigma: torch.Tensor, z_vals: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    dists = torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[..., :1], 1e10)],
        dim=-1,
    )
    dists = dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    return 1.0 - torch.exp(-sigma * dists)


def compute_alpha_weights(sigma: torch.Tensor, z_vals: torch.Tensor, dirs: torch.Tensor):
    """sigma, z_vals [..., N] and dirs [..., 3] -> (alpha, weights), [..., N].
    The exclusive transmittance's factors 1 - alpha + 1e-10 are never zero
    (alpha <= 1), so its gradient needs no test for zeros (``_Cumprod``)."""
    alpha = _alpha(sigma, z_vals, dirs)
    trans = torch.cat(
        [torch.ones_like(alpha[..., :1]), _Cumprod.apply(1.0 - alpha[..., :-1] + 1e-10)],
        dim=-1,
    )
    return alpha, alpha * trans


def compute_alpha_weights_reference(sigma: torch.Tensor, z_vals: torch.Tensor, dirs: torch.Tensor):
    """``compute_alpha_weights`` through ``torch.cumprod`` and its own
    backward (which waits for the card): the yardstick of ``_Cumprod``."""
    alpha = _alpha(sigma, z_vals, dirs)
    trans = torch.cat(
        [torch.ones_like(alpha[..., :1]), torch.cumprod(1.0 - alpha[..., :-1] + 1e-10, dim=-1)],
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
