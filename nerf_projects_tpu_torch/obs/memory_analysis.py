"""Memory analysis over experiment logs (port of
``nerf_projects_tpu/obs/memory_analysis.py``; pandas and matplotlib
imported at the call) — the reference's
memory_analysis_tools.py (plenoctree/memory_analysis_tools.py:16-390)
re-expressed for this repo's MetricsLogger schema.

MemoryAnalyzer loads one or more experiment JSON logs (the array format
obs/json_logger.py writes), flattens the typed entries into a pandas
DataFrame, computes per-phase efficiency statistics over the
memory_tracker indices (MEI = PSNR/GB, PMEI, quality-memory tradeoff,
combined index; memory_tracker.py:110-145), compares phases, plots
trends, and writes a markdown report. `analyze_directory` is the batch
entry point (reference :338-390).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

from nerf_projects_tpu_torch.obs.theme import apply_theme

_EFFICIENCY_KEYS = [
    "memory_efficiency_index",
    "peak_memory_efficiency_index",
    "quality_memory_tradeoff",
    "lpips_memory_efficiency",
    "combined_quality_memory_index",
]
_MEMORY_KEYS = [
    "device_memory_gb",
    "device_peak_memory_gb",
    "host_used_gb",
    "process_rss_gb",
]
_QUALITY_KEYS = ["psnr", "ssim", "lpips", "mse", "loss"]


class MemoryAnalyzer:
    """Flatten + analyze MetricsLogger logs (reference :16-75)."""

    def __init__(self, log_files: List[str]):
        self.log_files = list(log_files)
        self.entries: List[dict] = []
        self.load_data()

    def load_data(self):
        self.entries = []
        for path in self.log_files:
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(data, dict):
                data = data.get("entries", [])
            for e in data:
                e = dict(e)
                e["source_file"] = os.path.basename(path)
                self.entries.append(e)

    def to_dataframe(self):
        """Flat DataFrame: step/phase + metric_* + info_* columns."""
        import pandas as pd

        rows = []
        for e in self.entries:
            row = {
                "step": e.get("step"),
                "phase": e.get("phase"),
                "timestamp": e.get("timestamp"),
                "source_file": e.get("source_file"),
            }
            for k, v in (e.get("metrics") or {}).items():
                if isinstance(v, (int, float)):
                    row[f"metric_{k}"] = v
            info = e.get("additional_info") or {}
            for group in ("memory", "efficiency_indices", "timing"):
                for k, v in (info.get(group) or {}).items():
                    if isinstance(v, (int, float)):
                        row[f"info_{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)

    def analyze_memory_efficiency(
        self, phase: Optional[str] = None
    ) -> Dict[str, float]:
        """Per-phase (or global) efficiency statistics
        (reference :76-143; same avg/max/min/std summary keys)."""
        df = self.to_dataframe()
        if df.empty:
            return {}
        if phase is not None and "phase" in df:
            df = df[df["phase"] == phase]
        results: Dict[str, float] = {}
        for key in _EFFICIENCY_KEYS:
            col = f"info_{key}"
            if col in df and df[col].notna().any():
                vals = df[col].dropna()
                results[f"avg_{key}"] = float(vals.mean())
                results[f"max_{key}"] = float(vals.max())
                results[f"min_{key}"] = float(vals.min())
                results[f"std_{key}"] = float(vals.std(ddof=0))
        for key in _MEMORY_KEYS:
            col = f"info_{key}"
            if col in df and df[col].notna().any():
                vals = df[col].dropna()
                results[f"avg_{key}"] = float(vals.mean())
                results[f"max_{key}"] = float(vals.max())
                results[f"min_{key}"] = float(vals.min())
        return results

    def compare_phases(self):
        """Phase x metric aggregation table (reference :144-179)."""
        df = self.to_dataframe()
        import pandas as pd

        if df.empty or "phase" not in df:
            return pd.DataFrame()
        cols = [
            c
            for c in df.columns
            if c.startswith("info_")
            or c in [f"metric_{k}" for k in _QUALITY_KEYS]
        ]
        cols = [c for c in cols if df[c].notna().any()]
        if not cols:
            return pd.DataFrame()
        return df.groupby("phase")[cols].agg(
            ["mean", "std", "max", "min"]
        )

    def plot_memory_efficiency_trends(
        self, save_path: Optional[str] = None
    ):
        """Four-panel trend figure (reference :180-268): memory vs
        step, MEI vs step, PSNR vs memory scatter, per-phase peak."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        apply_theme()
        df = self.to_dataframe()
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        if df.empty:
            fig.text(0.5, 0.5, "no data", ha="center")
        else:
            ax = axes[0][0]
            if "info_device_memory_gb" in df:
                for ph, grp in df.groupby("phase"):
                    ax.plot(grp["step"], grp["info_device_memory_gb"],
                            label=str(ph))
                ax.legend()
            ax.set_title("Device memory (GB)")
            ax.set_xlabel("step")

            ax = axes[0][1]
            if "info_memory_efficiency_index" in df:
                ax.plot(df["step"], df["info_memory_efficiency_index"])
            ax.set_title("Memory efficiency index (PSNR/GB)")
            ax.set_xlabel("step")

            ax = axes[1][0]
            if (
                "metric_psnr" in df
                and "info_device_memory_gb" in df
            ):
                ax.scatter(
                    df["info_device_memory_gb"], df["metric_psnr"], s=12
                )
            ax.set_title("PSNR vs memory")
            ax.set_xlabel("GB")
            ax.set_ylabel("PSNR")

            ax = axes[1][1]
            if "info_device_peak_memory_gb" in df:
                peaks = df.groupby("phase")[
                    "info_device_peak_memory_gb"
                ].max()
                ax.bar([str(i) for i in peaks.index], peaks.values)
            ax.set_title("Peak memory by phase")
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=110)
            plt.close(fig)
            return save_path
        return fig

    def generate_report(self, output_path: str):
        """Markdown report: global + per-phase statistics and the phase
        comparison table (reference :269-337)."""
        lines = ["# Memory analysis report", ""]
        lines.append(f"Sources: {', '.join(self.log_files)}")
        lines.append(f"Entries: {len(self.entries)}")
        lines.append("")
        glob_stats = self.analyze_memory_efficiency()
        if glob_stats:
            lines.append("## Overall")
            lines.append("")
            for k, v in sorted(glob_stats.items()):
                lines.append(f"- {k}: {v:.6g}")
            lines.append("")
        phases = sorted(
            {e.get("phase") for e in self.entries if e.get("phase")}
        )
        for ph in phases:
            stats = self.analyze_memory_efficiency(ph)
            if not stats:
                continue
            lines.append(f"## Phase: {ph}")
            lines.append("")
            for k, v in sorted(stats.items()):
                lines.append(f"- {k}: {v:.6g}")
            lines.append("")
        cmp = self.compare_phases()
        if len(cmp):
            lines.append("## Phase comparison")
            lines.append("")
            lines.append("```")
            lines.append(cmp.to_string())
            lines.append("```")
        with open(output_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return output_path


def analyze_directory(log_dir: str, output_dir: Optional[str] = None):
    """Analyze every experiment log under log_dir (reference :338-390):
    writes memory_report.md + memory_trends.png and returns the
    analyzer."""
    logs = sorted(glob.glob(os.path.join(log_dir, "**", "*.json"),
                            recursive=True))
    logs = [p for p in logs if not p.endswith("args.json")]
    analyzer = MemoryAnalyzer(logs)
    out = output_dir or log_dir
    os.makedirs(out, exist_ok=True)
    analyzer.generate_report(os.path.join(out, "memory_report.md"))
    analyzer.plot_memory_efficiency_trends(
        os.path.join(out, "memory_trends.png")
    )
    return analyzer
