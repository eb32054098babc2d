"""Offline analysis dashboards over training/evaluation logs (port of
``nerf_projects_tpu/obs/analysis.py``; matplotlib imported at the call).

Parity targets:
  * nerf/training_analysis.py — load `training_log.jsonl`/`.csv` +
    `testset_*/metrics.json`, plot loss/PSNR curves, build a
    cross-experiment comparison table (`analyze_all_experiments`);
  * plenoctree/analysis/* — per-scene pipeline dashboards over
    `metrics_log.json` (training/evaluation/octree phases), efficiency
    trends (memory_analysis_tools.py), and a shared plot theme
    (visualization_theme.py).

Everything renders headless (matplotlib Agg) into PNG files.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

THEME = {
    "figure.figsize": (10, 6),
    "figure.dpi": 110,
    "axes.grid": True,
    "grid.alpha": 0.3,
    "axes.spines.top": False,
    "axes.spines.right": False,
    "font.size": 10,
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update(THEME)
    return plt


def load_training_log(exp_dir: str) -> List[dict]:
    """training_log.jsonl entries (falls back to CSV)."""
    p = os.path.join(exp_dir, "training_log.jsonl")
    if os.path.exists(p):
        with open(p) as f:
            return [json.loads(l) for l in f if l.strip()]
    p = os.path.join(exp_dir, "training_log.csv")
    if os.path.exists(p):
        import csv

        with open(p) as f:
            return [
                {k: float(v) if k != "step" else int(float(v)) for k, v in row.items()}
                for row in csv.DictReader(f)
            ]
    return []


def load_metrics_log(exp_dir: str) -> List[dict]:
    """metrics_log.json array entries (MetricsLogger output)."""
    p = os.path.join(exp_dir, "metrics_log.json")
    if not os.path.exists(p):
        return []
    with open(p) as f:
        return json.load(f)


def load_testset_metrics(exp_dir: str) -> List[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(exp_dir, "testset_*/metrics.json"))):
        with open(p) as f:
            data = json.load(f)
        data["path"] = p
        out.append(data)
    return out


def plot_training_curves(exp_dir: str, out_path: Optional[str] = None) -> Optional[str]:
    """Loss/PSNR/rays-per-sec curves (training_analysis.py:103)."""
    entries = load_training_log(exp_dir)
    if not entries:
        entries = [
            dict(e["metrics"], step=e["step"])
            for e in load_metrics_log(exp_dir)
            if e.get("phase") == "training"
        ]
    if not entries:
        return None
    plt = _plt()
    steps = [e["step"] for e in entries]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, key, label in [
        (axes[0], "loss", "loss"),
        (axes[1], "psnr", "train PSNR (dB)"),
        (axes[2], "rays_per_sec", "rays/sec"),
    ]:
        vals = [e.get(key) for e in entries]
        if any(v is not None for v in vals):
            ax.plot(steps, [v if v is not None else np.nan for v in vals])
        ax.set_xlabel("step")
        ax.set_title(label)
    if any("loss" in e for e in entries):
        axes[0].set_yscale("log")
    fig.suptitle(os.path.basename(exp_dir.rstrip("/")))
    fig.tight_layout()
    out_path = out_path or os.path.join(exp_dir, "training_curves.png")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_memory_trends(exp_dir: str, out_path: Optional[str] = None) -> Optional[str]:
    """Device/host memory over steps (memory_analysis_tools.py)."""
    entries = [
        e for e in load_metrics_log(exp_dir)
        if e.get("phase") == "training"
        and e.get("additional_info", {}).get("memory")
    ]
    if not entries:
        return None
    plt = _plt()
    steps = [e["step"] for e in entries]
    mem = [e["additional_info"]["memory"] for e in entries]
    fig, ax = plt.subplots()
    for key, label in [
        ("device_memory_gb", "device HBM (GB)"),
        ("process_rss_gb", "process RSS (GB)"),
    ]:
        vals = [m.get(key, 0.0) for m in mem]
        if any(vals):
            ax.plot(steps, vals, label=label)
    ax.set_xlabel("step")
    ax.set_ylabel("GB")
    ax.legend()
    fig.tight_layout()
    out_path = out_path or os.path.join(exp_dir, "memory_trends.png")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def experiment_summary(exp_dir: str) -> Dict:
    """One row of the cross-experiment table
    (training_analysis.py:356 create_summary_comparison)."""
    train = load_training_log(exp_dir)
    tests = load_testset_metrics(exp_dir)
    evals = [
        e for e in load_metrics_log(exp_dir) if e.get("phase") == "evaluation"
    ]
    row: Dict = {"experiment": os.path.basename(exp_dir.rstrip("/"))}
    if train:
        row["final_train_psnr"] = train[-1].get("psnr")
        row["final_loss"] = train[-1].get("loss")
        row["steps"] = train[-1].get("step")
        rps = [e.get("rays_per_sec") for e in train if e.get("rays_per_sec")]
        if rps:
            row["mean_rays_per_sec"] = float(np.mean(rps))
    if tests:
        row["test_psnr"] = tests[-1]["mean"].get("psnr")
        row["test_ssim"] = tests[-1]["mean"].get("ssim")
    elif evals:
        row["test_psnr"] = evals[-1]["metrics"].get("psnr")
        row["test_ssim"] = evals[-1]["metrics"].get("ssim")
    return row


def analyze_all_experiments(base_dir: str, out_path: Optional[str] = None):
    """Comparison table + per-experiment dashboards over `base_dir`
    (training_analysis.py:446)."""
    rows = []
    for exp_dir in sorted(glob.glob(os.path.join(base_dir, "*"))):
        if not os.path.isdir(exp_dir):
            continue
        if not (
            os.path.exists(os.path.join(exp_dir, "training_log.jsonl"))
            or os.path.exists(os.path.join(exp_dir, "metrics_log.json"))
        ):
            continue
        plot_training_curves(exp_dir)
        plot_memory_trends(exp_dir)
        rows.append(experiment_summary(exp_dir))
    out_path = out_path or os.path.join(base_dir, "comparison.json")
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=2)
    return rows
