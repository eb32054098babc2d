"""Shared visualization theme for the analysis figures (port of
``nerf_projects_tpu/obs/theme.py``).

Parity target: plenoctree/analysis/visualization_theme.py (Colors /
Typography / PlotTemplates + per-scene and per-metric color maps) — the
one styling source every dashboard module pulls from, so cross-experiment
figures read as one family.
"""
from __future__ import annotations

from typing import Optional

# Categorical palette (colorblind-safe ordering)
PALETTE = [
    "#4C72B0", "#DD8452", "#55A868", "#C44E52",
    "#8172B3", "#937860", "#DA8BC3", "#8C8C8C",
    "#CCB974", "#64B5CD",
]

SCENE_ORDER = [
    "chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship",
]

METRIC_COLORS = {
    "psnr": "#4C72B0",
    "ssim": "#55A868",
    "lpips": "#C44E52",
    "loss": "#DD8452",
    "mse": "#DD8452",
    "memory": "#8172B3",
    "time": "#937860",
    "rays_per_sec": "#64B5CD",
    "storage": "#CCB974",
}

STAGE_COLORS = {
    "training": "#4C72B0",
    "extraction": "#DD8452",
    "optimization": "#55A868",
    "compression": "#8172B3",
    "evaluation": "#C44E52",
}

RC_PARAMS = {
    "figure.dpi": 130,
    "savefig.dpi": 130,
    "savefig.bbox": "tight",
    "savefig.facecolor": "white",
    "font.size": 10,
    "axes.titlesize": 12,
    "axes.labelsize": 10,
    "legend.fontsize": 9,
    "figure.titlesize": 14,
    "axes.grid": True,
    "grid.alpha": 0.25,
    "axes.spines.top": False,
    "axes.spines.right": False,
    "axes.facecolor": "#FAFAFA",
    "lines.linewidth": 2.0,
    "lines.markersize": 5,
}


def get_scene_color(scene: str) -> str:
    """Stable color per scene name (visualization_theme.get_scene_color)."""
    name = scene.lower()
    if name in SCENE_ORDER:
        return PALETTE[SCENE_ORDER.index(name)]
    return PALETTE[hash(name) % len(PALETTE)]


def get_metric_color(metric: str) -> str:
    return METRIC_COLORS.get(metric.lower(), PALETTE[0])


def get_stage_color(stage: str) -> str:
    return STAGE_COLORS.get(stage.lower(), PALETTE[-1])


def sig3(value) -> str:
    """3-significant-figure formatting for annotations."""
    if value is None:
        return "-"
    v = float(value)
    if v == 0:
        return "0.00"
    a = abs(v)
    if a >= 100:
        return f"{v:.1f}"
    if a >= 1:
        return f"{v:.3g}"
    return f"{v:.3g}"


def apply_theme():
    """Set the Agg backend + rcParams; returns pyplot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update(RC_PARAMS)
    return plt
