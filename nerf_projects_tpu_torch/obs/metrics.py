"""Image-quality metrics: MSE, PSNR, SSIM and (unavailable) LPIPS (port of
``nerf_projects_tpu/obs/metrics.py``).

  * img2mse / mse2psnr / to8b — reference nerf/nerf_helpers.py:8-18.
  * SSIM — the tf.image-style separable-Gaussian implementation of both
    reference stacks (nerf/nerf_helpers.py:21-111,
    plenoctree/nerf_sh/nerf/utils.py:396-480): filter 11, sigma 1.5,
    k1 0.01, k2 0.03, variance clamping and covariance sign handling.
  * LPIPS needs pretrained VGG weights, which cannot be fetched here:
    ``lpips_fn`` returns None, as the reference package's does offline.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse):
    """-10 log10(mse), for a float (giving a float) or a tensor."""
    if torch.is_tensor(mse):
        return -10.0 * torch.log(mse) / math.log(10.0)
    return -10.0 * math.log(mse) / math.log(10.0) if mse > 0 else math.inf


def to8b(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def compute_ssim(
    img1,
    img2,
    *,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    """SSIM between two [H, W, C] images, tf.image convention: separable
    Gaussian blur over H then W with zero SAME padding, variance clamping,
    covariance magnitude capping."""
    img1 = torch.clamp(torch.as_tensor(img1, dtype=torch.float32), 0, max_val)
    img2 = torch.clamp(torch.as_tensor(img2, dtype=torch.float32), 0, max_val).to(img1.device)

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((torch.arange(filter_size, dtype=torch.float32, device=img1.device) - hw + shift) / filter_sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    filt = filt / filt.sum()

    def blur(z):  # [H, W, C] -> [H, W, C], depthwise 1-D convs
        x = z.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
        x = F.conv2d(x, filt.reshape(1, 1, filter_size, 1), padding=(hw, 0))
        x = F.conv2d(x, filt.reshape(1, 1, 1, filter_size), padding=(0, hw))
        return x[:, 0].permute(1, 2, 0)

    mu1, mu2 = blur(img1), blur(img2)
    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma11 = torch.clamp(blur(img1 * img1) - mu11, min=0.0)
    sigma22 = torch.clamp(blur(img2 * img2) - mu22, min=0.0)
    sigma12 = blur(img1 * img2) - mu12
    sigma12 = torch.sign(sigma12) * torch.minimum(torch.sqrt(sigma11 * sigma22), sigma12.abs())

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu12 + c1) * (2 * sigma12 + c2)
    denom = (mu11 + mu22 + c1) * (sigma11 + sigma22 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else ssim_map.mean()


def lpips_fn(img1, img2) -> Optional[float]:
    """LPIPS (VGG) needs pretrained weights that are not available
    offline; returns None, as the reference evaluators degrade."""
    return None


def compute_metrics(pred, target, include_lpips: bool = False) -> dict:
    """PSNR / SSIM (/ LPIPS) of a rendered image against ground truth."""
    pred = torch.clamp(torch.as_tensor(pred, dtype=torch.float32), 0, 1)
    target = torch.clamp(torch.as_tensor(target, dtype=torch.float32), 0, 1).to(pred.device)
    mse = float(img2mse(pred, target))
    out = {"mse": mse, "psnr": float(mse2psnr(mse)), "ssim": float(compute_ssim(pred, target))}
    if include_lpips:
        out["lpips"] = lpips_fn(pred, target)
    return out
