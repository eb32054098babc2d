"""Structured JSON metrics logging (port of
``nerf_projects_tpu/obs/json_logger.py``).

Parity target: reference plenoctree/json_logger.py (`MetricsLogger`,
:14-228): one JSON array file of typed entries (training / evaluation /
octree_evaluation phases) with timestamps, timing, memory metrics, and
efficiency indices; numpy and torch values converted to Python scalars.

Implementation note: the reference rewrites the whole array per entry;
this appends JSONL to a sidecar and rewrites the array file from it,
keeping the same on-disk array format while making appends O(1).
"""
from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np
import torch


def to_serializable(obj: Any) -> Any:
    """numpy / torch -> plain Python (json_logger.py:43-57 equivalent);
    a tensor is read back to the host."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if hasattr(obj, "tolist") and hasattr(obj, "size"):
        return obj.tolist() if getattr(obj, "size", 1) > 1 else float(np.asarray(obj))
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, dict):
        return {k: to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_serializable(v) for v in obj]
    return obj


class MetricsLogger:
    def __init__(
        self,
        log_dir: str,
        log_filename: str = "metrics_log.json",
        clean_existing: bool = True,
    ):
        self.log_dir = log_dir
        self.log_file = os.path.join(log_dir, log_filename)
        self._jsonl = self.log_file + "l"  # metrics_log.jsonl sidecar
        os.makedirs(log_dir, exist_ok=True)
        if clean_existing:
            for p in (self.log_file, self._jsonl):
                if os.path.exists(p):
                    os.remove(p)
        if not os.path.exists(self.log_file):
            with open(self.log_file, "w") as f:
                f.write("[\n]\n")

    def log_metrics(
        self,
        step: int,
        phase: str,
        metrics: Dict[str, Any],
        additional_info: Optional[Dict[str, Any]] = None,
    ):
        entry = {
            "timestamp": datetime.now().isoformat(),
            "step": int(step),
            "phase": phase,
            "metrics": to_serializable(metrics),
        }
        if additional_info:
            entry["additional_info"] = to_serializable(additional_info)
        with open(self._jsonl, "a") as f:
            f.write(json.dumps(entry) + "\n")
        self._rewrite_array()

    def _rewrite_array(self):
        entries = self.read_entries()
        with open(self.log_file, "w") as f:
            json.dump(entries, f, indent=2)
            f.write("\n")

    def read_entries(self):
        if not os.path.exists(self._jsonl):
            return []
        with open(self._jsonl) as f:
            return [json.loads(line) for line in f if line.strip()]

    # -- typed entry points (json_logger.py:107-227) ----------------------

    def log_training_step(
        self,
        step: int,
        stats: Dict[str, Any],
        lr: float,
        timing_info: Optional[Dict[str, float]] = None,
        memory_metrics: Optional[Dict[str, float]] = None,
        efficiency_indices: Optional[Dict[str, float]] = None,
    ):
        metrics = dict(to_serializable(stats))
        metrics["learning_rate"] = float(lr)
        info: Dict[str, Any] = {}
        if timing_info:
            info["timing"] = timing_info
        if memory_metrics:
            info["memory"] = memory_metrics
        if efficiency_indices:
            info["efficiency_indices"] = efficiency_indices
        self.log_metrics(step, "training", metrics, info or None)

    def log_evaluation_step(
        self,
        step: int,
        metrics: Dict[str, Any],
        memory_metrics: Optional[Dict[str, float]] = None,
        efficiency_indices: Optional[Dict[str, float]] = None,
    ):
        info: Dict[str, Any] = {}
        if memory_metrics:
            info["memory"] = memory_metrics
        if efficiency_indices:
            info["efficiency_indices"] = efficiency_indices
        self.log_metrics(step, "evaluation", metrics, info or None)

    def log_octree_evaluation(
        self,
        step: int,
        metrics: Dict[str, Any],
        additional_info: Optional[Dict[str, Any]] = None,
    ):
        self.log_metrics(step, "octree_evaluation", metrics, additional_info)
