from nerf_projects_tpu_torch.obs.metrics import (
    compute_metrics,
    compute_ssim,
    img2mse,
    lpips_fn,
    mse2psnr,
    to8b,
)

__all__ = ["compute_metrics", "compute_ssim", "img2mse", "lpips_fn", "mse2psnr", "to8b"]
