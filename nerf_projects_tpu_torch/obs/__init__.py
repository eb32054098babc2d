"""Metrics, logs and their analysis. The image metrics below load at
first use (from ``metrics.py``), so a tool that imports one module of
this package (``analysis.py``, ``dashboards.py``) imports no torch."""
import importlib

__all__ = ["compute_metrics", "compute_ssim", "img2mse", "lpips_fn", "mse2psnr", "to8b"]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module(f"{__name__}.metrics"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
