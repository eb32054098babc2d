"""Per-scene pipeline dashboards, efficiency analysis, and
cross-experiment visualization over MetricsLogger logs (port of
``nerf_projects_tpu/obs/dashboards.py``; matplotlib imported at the
call, through ``obs/theme.py::apply_theme``).

Parity targets (plenoctree/analysis/*):
  * experiment_analyzer.py:76-1010 SimplePlenOctreeAnalyzer — per-scene
    comprehensive dashboard over the pipeline stages
    (training -> extraction -> optimization -> compression ->
    evaluation), stage timing chart;
  * efficiency_metrics_analyzer.py — efficiency-index trends and report;
  * enhanced_scene_analyzer.py — per-scene quality/memory panels;
  * cross_experiment_visualizer.py — multi-experiment comparison charts
    + leaderboard;
  * run_all_analysis.py — one orchestrator emitting the full set.

Input: a directory of experiment directories, each holding the
MetricsLogger pair metrics_log.json(l) (obs/json_logger.py) and/or the
vanilla-NeRF training_log.jsonl. All figures share obs/theme.py.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

from nerf_projects_tpu_torch.obs.analysis import (
    load_metrics_log,
    load_testset_metrics,
    load_training_log,
)
from nerf_projects_tpu_torch.obs.theme import (
    apply_theme,
    get_metric_color,
    get_scene_color,
    get_stage_color,
    sig3,
)

PIPELINE_STAGES = [
    "training", "extraction", "optimization", "compression", "evaluation",
]


# ---------------------------------------------------------------------------
# extraction of structured data from logs
# ---------------------------------------------------------------------------

def extract_pipeline_stages(exp_dir: str) -> Dict[str, dict]:
    """Group log entries by pipeline stage and summarize each
    (experiment_analyzer.py:339 extract_pipeline_stages).

    A stage summary carries: last PSNR seen, best PSNR, wall time
    (first->last timestamp), n_entries, and any storage/compression info.
    """
    entries = load_metrics_log(exp_dir)
    if not entries:
        entries = [
            {"phase": "training", "step": e.get("step", i), "metrics": e,
             "timestamp": None}
            for i, e in enumerate(load_training_log(exp_dir))
        ]
    stages: Dict[str, dict] = {}
    for e in entries:
        phase = e.get("phase", "training")
        # octree_evaluation and compressed variants roll into evaluation
        stage = {
            "octree_evaluation": "evaluation",
            "compressed_evaluation": "compression",
        }.get(phase, phase)
        s = stages.setdefault(
            stage,
            {"psnr": [], "steps": [], "timestamps": [], "extras": {}},
        )
        m = e.get("metrics", {})
        if m.get("psnr") is not None:
            s["psnr"].append(float(m["psnr"]))
            s["steps"].append(e.get("step", 0))
        if e.get("timestamp"):
            s["timestamps"].append(e["timestamp"])
        for k in ("storage_mb", "compression_ratio", "capacity", "fps"):
            if m.get(k) is not None:
                s["extras"][k] = float(m[k])

    out = {}
    for stage, s in stages.items():
        summary = {
            "n_entries": len(s["steps"]) or len(s["timestamps"]),
            "last_psnr": s["psnr"][-1] if s["psnr"] else None,
            "best_psnr": max(s["psnr"]) if s["psnr"] else None,
            "extras": s["extras"],
            "wall_seconds": None,
        }
        ts = s["timestamps"]
        if len(ts) >= 2:
            from datetime import datetime

            try:
                t0 = datetime.fromisoformat(ts[0])
                t1 = datetime.fromisoformat(ts[-1])
                summary["wall_seconds"] = (t1 - t0).total_seconds()
            except ValueError:
                pass
        out[stage] = summary
    return out


def efficiency_trends(exp_dir: str) -> List[dict]:
    """Efficiency-index time series from training/eval entries
    (efficiency_metrics_analyzer.py)."""
    rows = []
    for e in load_metrics_log(exp_dir):
        info = e.get("additional_info", {}) or {}
        eff = info.get("efficiency_indices")
        mem = info.get("memory")
        m = e.get("metrics", {})
        if not (eff or mem):
            continue
        row = {"step": e.get("step", 0), "phase": e.get("phase")}
        if m.get("psnr") is not None:
            row["psnr"] = float(m["psnr"])
        if mem:
            row["memory_gb"] = mem.get(
                "device_memory_gb", mem.get("process_rss_gb")
            )
        if eff:
            row.update({k: v for k, v in eff.items()})
        elif row.get("psnr") and row.get("memory_gb"):
            row["memory_efficiency_index"] = row["psnr"] / max(
                row["memory_gb"], 1e-9
            )
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# per-scene dashboards
# ---------------------------------------------------------------------------

def scene_dashboard(exp_dir: str, out_path: Optional[str] = None):
    """Comprehensive per-scene dashboard: training curves, stage PSNR
    bars, stage timing, memory trend, efficiency trend
    (experiment_analyzer.py:506 _create_comprehensive_plot)."""
    train = load_training_log(exp_dir)
    if not train:
        train = [
            dict(e["metrics"], step=e["step"])
            for e in load_metrics_log(exp_dir)
            if e.get("phase") == "training"
        ]
    stages = extract_pipeline_stages(exp_dir)
    eff = efficiency_trends(exp_dir)
    if not train and not stages:
        return None

    plt = apply_theme()
    scene = os.path.basename(exp_dir.rstrip("/"))
    fig, axes = plt.subplots(2, 3, figsize=(16, 8))

    # (0,0) train PSNR curve
    ax = axes[0][0]
    steps = [e.get("step", i) for i, e in enumerate(train)]
    psnr = [e.get("psnr") for e in train]
    if any(v is not None for v in psnr):
        ax.plot(steps, [v if v is not None else np.nan for v in psnr],
                color=get_scene_color(scene))
    ax.set_title("train PSNR")
    ax.set_xlabel("step")

    # (0,1) loss (log scale)
    ax = axes[0][1]
    loss = [e.get("loss", e.get("mse")) for e in train]
    if any(v is not None for v in loss):
        ax.plot(steps, [v if v is not None else np.nan for v in loss],
                color=get_metric_color("loss"))
        ax.set_yscale("log")
    ax.set_title("loss")
    ax.set_xlabel("step")

    # (0,2) pipeline-stage PSNR bars
    ax = axes[0][2]
    names, vals, colors = [], [], []
    for stage in PIPELINE_STAGES:
        s = stages.get(stage)
        if s and s["last_psnr"] is not None:
            names.append(stage)
            vals.append(s["last_psnr"])
            colors.append(get_stage_color(stage))
    if names:
        bars = ax.bar(names, vals, color=colors)
        for b, v in zip(bars, vals):
            ax.text(b.get_x() + b.get_width() / 2, v, sig3(v),
                    ha="center", va="bottom", fontsize=8)
        ax.tick_params(axis="x", rotation=20)
    ax.set_title("PSNR by pipeline stage")

    # (1,0) stage wall time
    ax = axes[1][0]
    names, vals, colors = [], [], []
    for stage in PIPELINE_STAGES:
        s = stages.get(stage)
        if s and s.get("wall_seconds"):
            names.append(stage)
            vals.append(s["wall_seconds"] / 60.0)
            colors.append(get_stage_color(stage))
    if names:
        ax.bar(names, vals, color=colors)
        ax.tick_params(axis="x", rotation=20)
    ax.set_ylabel("minutes")
    ax.set_title("stage wall time")

    # (1,1) memory trend
    ax = axes[1][1]
    mem_rows = [r for r in eff if r.get("memory_gb")]
    if mem_rows:
        ax.plot([r["step"] for r in mem_rows],
                [r["memory_gb"] for r in mem_rows],
                color=get_metric_color("memory"))
    ax.set_title("device memory (GB)")
    ax.set_xlabel("step")

    # (1,2) efficiency index trend
    ax = axes[1][2]
    ef_rows = [r for r in eff if r.get("memory_efficiency_index")]
    if ef_rows:
        ax.plot([r["step"] for r in ef_rows],
                [r["memory_efficiency_index"] for r in ef_rows],
                color=get_metric_color("psnr"))
    ax.set_title("memory efficiency (PSNR/GB)")
    ax.set_xlabel("step")

    fig.suptitle(scene)
    fig.tight_layout()
    out_path = out_path or os.path.join(exp_dir, "scene_dashboard.png")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def timing_chart(exp_dir: str, out_path: Optional[str] = None):
    """Horizontal stage-duration chart
    (experiment_analyzer.py:848 create_timing_visualization)."""
    stages = extract_pipeline_stages(exp_dir)
    rows = [
        (st, s["wall_seconds"] / 60.0)
        for st, s in stages.items()
        if s.get("wall_seconds")
    ]
    if not rows:
        return None
    plt = apply_theme()
    fig, ax = plt.subplots(figsize=(8, 0.6 * len(rows) + 1.5))
    names = [r[0] for r in rows]
    vals = [r[1] for r in rows]
    ax.barh(names, vals, color=[get_stage_color(n) for n in names])
    for i, v in enumerate(vals):
        ax.text(v, i, f" {sig3(v)}m", va="center", fontsize=8)
    ax.set_xlabel("minutes")
    ax.set_title(f"{os.path.basename(exp_dir.rstrip('/'))} — stage timing")
    fig.tight_layout()
    out_path = out_path or os.path.join(exp_dir, "stage_timing.png")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def efficiency_report(exp_dir: str, out_path: Optional[str] = None):
    """Efficiency-index trend figure + JSON report
    (efficiency_metrics_analyzer.py)."""
    rows = efficiency_trends(exp_dir)
    if not rows:
        return None
    keys = sorted(
        {
            k
            for r in rows
            for k in r
            if k.endswith("_index") or k.endswith("_efficiency")
            or k.endswith("_tradeoff")
        }
    )
    plt = apply_theme()
    fig, ax = plt.subplots()
    for i, k in enumerate(keys):
        pts = [(r["step"], r[k]) for r in rows if r.get(k) is not None]
        if pts:
            ax.plot(*zip(*pts), label=k)
    ax.legend(fontsize=7)
    ax.set_xlabel("step")
    ax.set_title("efficiency indices")
    fig.tight_layout()
    fig_path = out_path or os.path.join(exp_dir, "efficiency_trends.png")
    fig.savefig(fig_path)
    plt.close(fig)

    report = {
        "final": {k: rows[-1].get(k) for k in keys},
        "n_samples": len(rows),
    }
    with open(os.path.join(exp_dir, "efficiency_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return fig_path


def _series(exp_dir: str) -> List[dict]:
    """Unified per-entry time series for the enhanced panels: step,
    psnr/ssim/lpips, current + peak memory, efficiency indices."""
    rows = []
    for e in load_metrics_log(exp_dir):
        m = e.get("metrics", {}) or {}
        info = e.get("additional_info", {}) or {}
        mem = info.get("memory") or {}
        eff = info.get("efficiency_indices") or {}
        row = {"step": e.get("step", 0), "phase": e.get("phase")}
        for k in ("psnr", "ssim", "lpips"):
            if m.get(k) is not None:
                row[k] = float(m[k])
        cur = mem.get("device_memory_gb") or mem.get("process_rss_gb")
        peak = mem.get("device_peak_memory_gb") or mem.get(
            "peak_process_rss_gb"
        )
        if cur is not None:
            row["mem_gb"] = float(cur)
        if peak is not None:
            row["peak_gb"] = float(peak)
        row.update({k: float(v) for k, v in eff.items()
                    if v is not None})
        if "memory_efficiency_index" not in row and (
            row.get("psnr") and row.get("peak_gb")
        ):
            row["memory_efficiency_index"] = row["psnr"] / max(
                row["peak_gb"], 1e-9
            )
        rows.append(row)
    return rows


def _pts(rows, key):
    return [(r["step"], r[key]) for r in rows if r.get(key) is not None]


def enhanced_scene_dashboard(exp_dir: str, out_dir: Optional[str] = None):
    """Per-scene deep-dive figure set — the reference
    EnhancedSceneAnalyzer (enhanced_scene_analyzer.py:25-597):

      memory_analysis.png       2x2: current vs peak w/ headroom shading,
                                headroom, utilization %, distribution
      efficiency_comparison.png 2x3: MEI/QMT/voxel-efficiency trends,
                                normalized overlay, final bars
      quality_detailed.png      2x2: PSNR+SSIM dual-axis, combined
                                score PSNR*SSIM*(1-LPIPS), LPIPS
      training_progression.png  3x3 overview of all of the above

    Returns the list of written figure paths (empty if no usable log).
    """
    rows = _series(exp_dir)
    if not rows:
        return []
    out_dir = out_dir or os.path.join(exp_dir, "enhanced_analysis")
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(exp_dir.rstrip("/"))
    plt = apply_theme()
    written = []

    mem = _pts(rows, "mem_gb")
    peak = _pts(rows, "peak_gb")
    psnr = _pts(rows, "psnr")
    ssim = _pts(rows, "ssim")
    lpips = _pts(rows, "lpips")

    # ---- 1. memory analysis (create_memory_comparison_plot:47)
    if mem and peak:
        fig, axes = plt.subplots(2, 2, figsize=(13, 9))
        fig.suptitle(f"Detailed memory analysis — {name}",
                     fontweight="bold")
        ax = axes[0, 0]
        ms, mv = zip(*mem)
        ps_, pv = zip(*peak)
        ax.plot(ms, mv, label="current", color=get_metric_color("memory"))
        ax.plot(ps_, pv, label="peak", color="#d62728")
        ax.fill_between(ms, mv,
                        np.interp(ms, ps_, pv), alpha=0.2,
                        label="headroom")
        ax.set_title("current vs peak memory (GB)")
        ax.legend(fontsize=8)
        ax = axes[0, 1]
        head = np.interp(ms, ps_, pv) - np.asarray(mv)
        ax.plot(ms, head, color="#2ca02c")
        ax.set_title("memory headroom (peak − current, GB)")
        ax = axes[1, 0]
        util = 100.0 * np.asarray(mv) / np.maximum(
            np.interp(ms, ps_, pv), 1e-9
        )
        ax.plot(ms, util, color="#9467bd")
        ax.set_ylim(0, 105)
        ax.set_title("memory utilization (current/peak, %)")
        ax = axes[1, 1]
        ax.hist(mv, bins=min(20, max(len(mv) // 2, 3)),
                color=get_metric_color("memory"), alpha=0.8)
        ax.set_title("current-memory distribution (GB)")
        for a in axes.flat:
            a.set_xlabel("step")
        fig.tight_layout()
        p = os.path.join(out_dir, "memory_analysis.png")
        fig.savefig(p)
        plt.close(fig)
        written.append(p)

    # ---- 2. efficiency comparison (create_efficiency_comparison_plot:137)
    eff_keys = [
        ("memory_efficiency_index", "MEI — PSNR per GB"),
        ("quality_memory_tradeoff", "QMT — PSNR·SSIM per GB"),
        ("voxel_density_efficiency", "voxel efficiency"),
    ]
    have = [(k, t) for k, t in eff_keys if _pts(rows, k)]
    if have:
        fig, axes = plt.subplots(2, 3, figsize=(15, 8))
        fig.suptitle(f"Efficiency metrics — {name}", fontweight="bold")
        for i, (k, t) in enumerate(have[:3]):
            ax = axes[0, i]
            ax.plot(*zip(*_pts(rows, k)), color=get_metric_color(k))
            ax.set_title(t, fontsize=10)
            ax.set_xlabel("step")
        for i in range(len(have), 3):
            axes[0, i].axis("off")
        ax = axes[1, 0]
        for k, t in have:
            pts = _pts(rows, k)
            v = np.asarray([p[1] for p in pts])
            vn = (v - v.min()) / max(v.max() - v.min(), 1e-12)
            ax.plot([p[0] for p in pts], vn, label=k.split("_")[0])
        ax.set_title("normalized overlay", fontsize=10)
        ax.legend(fontsize=7)
        ax = axes[1, 1]
        finals = {k: _pts(rows, k)[-1][1] for k, _ in have}
        ax.bar(range(len(finals)), list(finals.values()),
               color=[get_metric_color(k) for k in finals])
        ax.set_xticks(range(len(finals)))
        ax.set_xticklabels([k.split("_")[0] for k in finals], fontsize=8)
        ax.set_title("final values", fontsize=10)
        ax = axes[1, 2]
        if mem and peak:
            ax.bar(["current", "peak"],
                   [mem[-1][1], peak[-1][1]],
                   color=["#1f77b4", "#d62728"])
            ax.set_title("final memory (GB)", fontsize=10)
        else:
            ax.axis("off")
        fig.tight_layout()
        p = os.path.join(out_dir, "efficiency_comparison.png")
        fig.savefig(p)
        plt.close(fig)
        written.append(p)

    # ---- 3. detailed quality (create_quality_metrics_detailed:285)
    if psnr:
        fig, axes = plt.subplots(2, 2, figsize=(13, 9))
        fig.suptitle(f"Quality metrics — {name}", fontweight="bold")
        ax = axes[0, 0]
        ax.plot(*zip(*psnr), color=get_metric_color("psnr"),
                label="PSNR")
        ax.set_ylabel("PSNR (dB)")
        if ssim:
            ax2 = ax.twinx()
            ax2.plot(*zip(*ssim), color=get_metric_color("ssim"),
                     label="SSIM", linestyle="--")
            ax2.set_ylabel("SSIM")
        ax.set_title("PSNR and SSIM (dual axis)")
        ax = axes[0, 1]
        if ssim:
            steps = [s for s, _ in ssim]
            pv = np.interp(steps, *zip(*psnr))
            sv = np.asarray([v for _, v in ssim])
            lv = (
                1.0 - np.interp(steps, *zip(*lpips))
                if lpips else np.ones_like(sv)
            )
            ax.plot(steps, pv * sv * lv, color="#2ca02c")
            ax.set_title("combined score PSNR·SSIM·(1−LPIPS)")
        else:
            ax.axis("off")
        ax = axes[1, 0]
        if lpips:
            ax.plot(*zip(*lpips), color=get_metric_color("lpips"))
            ax.set_title("LPIPS (lower is better)")
        else:
            ax.axis("off")
        ax = axes[1, 1]
        pvals = [v for _, v in psnr]
        ax.hist(pvals, bins=min(20, max(len(pvals) // 2, 3)),
                color=get_metric_color("psnr"), alpha=0.8)
        ax.set_title("PSNR distribution")
        for a in axes.flat:
            a.set_xlabel("step")
        fig.tight_layout()
        p = os.path.join(out_dir, "quality_detailed.png")
        fig.savefig(p)
        plt.close(fig)
        written.append(p)

    # ---- 4. training progression 3x3 (create_training_progression:406)
    panels = [
        ("psnr", "PSNR"), ("mem_gb", "memory (GB)"),
        ("memory_efficiency_index", "MEI"),
        ("ssim", "SSIM"), ("quality_memory_tradeoff", "QMT"),
        ("voxel_density_efficiency", "voxel eff."),
        ("lpips", "LPIPS"), ("peak_gb", "peak memory (GB)"),
    ]
    fig, axes = plt.subplots(3, 3, figsize=(14, 11))
    fig.suptitle(f"Training progression — {name}", fontweight="bold")
    drawn = 0
    for (k, t), ax in zip(panels, axes.flat):
        pts = _pts(rows, k)
        if pts:
            ax.plot(*zip(*pts), color=get_metric_color(k))
            drawn += 1
        ax.set_title(t, fontsize=10)
        ax.set_xlabel("step")
    ax = axes.flat[-1]
    finals = {t: _pts(rows, k)[-1][1]
              for k, t in panels if _pts(rows, k)}
    txt = "\n".join(f"{t:<16} {sig3(v)}" for t, v in finals.items())
    ax.text(0.02, 0.95, txt or "no data", va="top",
            family="monospace", fontsize=9, transform=ax.transAxes)
    ax.axis("off")
    if drawn:
        fig.tight_layout()
        p = os.path.join(out_dir, "training_progression.png")
        fig.savefig(p)
        written.append(p)
    plt.close(fig)
    return written


# ---------------------------------------------------------------------------
# cross-experiment comparison
# ---------------------------------------------------------------------------

def _experiment_dirs(base_dir: str) -> List[str]:
    out = []
    for d in sorted(glob.glob(os.path.join(base_dir, "*"))):
        if os.path.isdir(d) and (
            os.path.exists(os.path.join(d, "metrics_log.json"))
            or os.path.exists(os.path.join(d, "metrics_log.jsonl"))
            or os.path.exists(os.path.join(d, "training_log.jsonl"))
        ):
            out.append(d)
    return out


def cross_experiment_figure(base_dir: str, out_path: Optional[str] = None):
    """Grouped comparison: final PSNR per experiment + PSNR-vs-memory
    scatter (cross_experiment_visualizer.py)."""
    from nerf_projects_tpu_torch.obs.analysis import experiment_summary

    dirs = _experiment_dirs(base_dir)
    if not dirs:
        return None
    rows = []
    for d in dirs:
        row = experiment_summary(d)
        eff = efficiency_trends(d)
        mem = [r["memory_gb"] for r in eff if r.get("memory_gb")]
        if mem:
            row["peak_memory_gb"] = max(mem)
        rows.append(row)

    plt = apply_theme()
    fig, axes = plt.subplots(1, 2, figsize=(13, 5))
    names = [r["experiment"] for r in rows]
    psnr = [r.get("test_psnr") or r.get("final_train_psnr") or 0 for r in rows]
    axes[0].bar(names, psnr, color=[get_scene_color(n) for n in names])
    for i, v in enumerate(psnr):
        axes[0].text(i, v, sig3(v), ha="center", va="bottom", fontsize=8)
    axes[0].set_ylabel("PSNR (dB)")
    axes[0].set_title("final quality by experiment")
    axes[0].tick_params(axis="x", rotation=30)

    pts = [
        (r.get("peak_memory_gb"), p, r["experiment"])
        for r, p in zip(rows, psnr)
        if r.get("peak_memory_gb")
    ]
    for m, p, n in pts:
        axes[1].scatter(m, p, color=get_scene_color(n), label=n)
        axes[1].annotate(n, (m, p), fontsize=7,
                         textcoords="offset points", xytext=(4, 2))
    axes[1].set_xlabel("peak memory (GB)")
    axes[1].set_ylabel("PSNR (dB)")
    axes[1].set_title("quality vs memory")
    fig.tight_layout()
    out_path = out_path or os.path.join(base_dir, "cross_experiment.png")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def leaderboard(base_dir: str) -> List[dict]:
    """Ranked summary rows -> leaderboard.json + .md
    (cross_experiment_visualizer.py + autotune leaderboard)."""
    from nerf_projects_tpu_torch.obs.analysis import experiment_summary

    rows = [experiment_summary(d) for d in _experiment_dirs(base_dir)]
    rows.sort(
        key=lambda r: -(r.get("test_psnr") or r.get("final_train_psnr") or 0)
    )
    with open(os.path.join(base_dir, "leaderboard.json"), "w") as f:
        json.dump(rows, f, indent=2)
    cols = ["experiment", "test_psnr", "test_ssim", "final_train_psnr",
            "steps", "mean_rays_per_sec"]
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "---|" * len(cols)]
    for r in rows:
        lines.append(
            "| " + " | ".join(sig3(r.get(c)) if c != "experiment"
                              else str(r.get(c)) for c in cols) + " |"
        )
    with open(os.path.join(base_dir, "leaderboard.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return rows


def results_report(base_dir: str,
                   out_path: Optional[str] = None) -> str:
    """Consolidated HTML results view — the headless equivalent of the
    reference's results notebook (plenoctree/analysis/
    view_results.ipynb): per-experiment metric summary table, every
    generated dashboard figure inlined, and a file-structure section.
    Figures are referenced relative to the report so the HTML is
    portable alongside the experiment tree. Run run_all (or the
    run_analysis CLI) first to generate the figures."""
    from nerf_projects_tpu_torch.obs.analysis import experiment_summary

    out_path = out_path or os.path.join(base_dir, "results_report.html")
    dirs = _experiment_dirs(base_dir)
    rows = [experiment_summary(d) for d in dirs]
    cols: List[str] = []
    for r in rows:
        for k in r:
            if k != "experiment" and k not in cols:
                cols.append(k)

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        return "—" if v is None else str(v)

    parts = [
        "<!doctype html><meta charset='utf-8'>",
        "<title>Pipeline results</title>",
        "<style>body{font-family:sans-serif;max-width:1100px;"
        "margin:2em auto;color:#222}table{border-collapse:collapse}"
        "td,th{border:1px solid #ccc;padding:4px 10px;"
        "text-align:right}th{background:#f3f3f3}img{max-width:100%;"
        "margin:6px 0}h2{border-bottom:1px solid #ddd}"
        "code{background:#f6f6f6}</style>",
        f"<h1>Pipeline analysis — {os.path.basename(os.path.abspath(base_dir))}</h1>",
        "<h2>Cross-experiment summary</h2><table><tr><th>experiment</th>"
        + "".join(f"<th>{c}</th>" for c in cols) + "</tr>",
    ]
    for r in rows:
        parts.append(
            f"<tr><td>{r['experiment']}</td>"
            + "".join(f"<td>{fmt(r.get(c))}</td>" for c in cols)
            + "</tr>"
        )
    parts.append("</table>")

    for g in ("cross_experiment.png", "leaderboard.json"):
        p = os.path.join(base_dir, g)
        if os.path.exists(p) and g.endswith(".png"):
            parts.append(f"<img src='{g}' alt='{g}'>")

    base_abs = os.path.abspath(base_dir)
    for d in dirs:
        name = os.path.basename(d.rstrip("/"))
        parts.append(f"<h2>{name}</h2>")
        figs = sorted(
            glob.glob(os.path.join(d, "*.png"))
            + glob.glob(os.path.join(d, "analysis", "*.png"))
        )
        for f in figs:
            rel = os.path.relpath(f, base_abs)
            parts.append(
                f"<h3>{os.path.splitext(os.path.basename(f))[0]}</h3>"
                f"<img src='{rel}' alt='{rel}'>"
            )
        # file-structure section (view_results.ipynb final cell)
        parts.append("<details><summary>files</summary><pre>")
        for root, _dn, fns in sorted(os.walk(d)):
            rel_root = os.path.relpath(root, base_abs)
            for fn in sorted(fns):
                sz = os.path.getsize(os.path.join(root, fn))
                parts.append(
                    f"{rel_root}/{fn}  ({sz / 1024:.1f} KB)"
                )
        parts.append("</pre></details>")

    with open(out_path, "w") as fh:
        fh.write("\n".join(parts))
    return out_path


def run_all(base_dir: str) -> Dict[str, list]:
    """Emit the full dashboard set for every experiment under base_dir
    (run_all_analysis.py)."""
    from nerf_projects_tpu_torch.obs.analysis import (
        plot_memory_trends,
        plot_training_curves,
    )

    produced: Dict[str, list] = {"per_experiment": [], "global": []}
    for d in _experiment_dirs(base_dir):
        outs = []
        for fn in (plot_training_curves, plot_memory_trends,
                   scene_dashboard, timing_chart, efficiency_report,
                   enhanced_scene_dashboard):
            try:
                p = fn(d)
            except Exception as exc:  # a broken log should not stop the run
                p = None
                print(f"[analysis] {fn.__name__} failed for {d}: {exc}")
            if p:
                outs.extend(p if isinstance(p, list) else [p])
        produced["per_experiment"].append({"dir": d, "figures": outs})
    for fn in (cross_experiment_figure,):
        p = fn(base_dir)
        if p:
            produced["global"].append(p)
    leaderboard(base_dir)
    produced["global"].append(os.path.join(base_dir, "leaderboard.json"))
    produced["global"].append(results_report(base_dir))
    return produced
