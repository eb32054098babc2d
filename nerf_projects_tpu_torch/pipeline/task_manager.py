"""Multi-scene task scheduler + hyperparameter sweep (port of
``nerf_projects_tpu/pipeline/task_manager.py``).

Parity targets:
  * plenoctree/octree/task_manager.py:69-195 — JSON task specs with
    `{%}` / template substitution, a worker pool (one process per device),
    per-task device pinning, stdout parsing for result metrics, and a
    results.txt summary;
  * svox2/opt/autotune.py:34+ — task executor with `variables` sweeps
    (`loglin(lo, hi, n)` / `lin` / `log` / list expansion), reading
    test_psnr.txt from finished runs, and a leaderboard.

The pool has one worker per card (one with no card) and pins no device:
a task that wants one sets CUDA_VISIBLE_DEVICES in its own `env`, as the
reference's tasks do. Workers are spawned processes, which re-import the
caller's main script, so a script that runs a TaskManager guards its work
with `if __name__ == "__main__"`. Tasks are subprocesses running this
package's CLIs, exactly like the reference runs its CLIs.
"""
from __future__ import annotations

import itertools
import json
import multiprocessing as mp
import os
import re
import subprocess
from typing import Any, Dict, List, Optional

import numpy as np


def expand_variables(variables: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand autotune `variables` into the task grid.

    Supported specs (autotune.py): explicit list, "lin(lo,hi,n)",
    "log(lo,hi,n)", "loglin(lo,hi,n)" (log-spaced values).
    """

    def expand_one(spec):
        if isinstance(spec, (list, tuple)):
            return list(spec)
        if isinstance(spec, str):
            m = re.match(r"(loglin|log|lin)\(([^,]+),([^,]+),([^)]+)\)", spec.strip())
            if m:
                kind, lo, hi, n = m.groups()
                lo, hi, n = float(lo), float(hi), int(n)
                if kind == "lin":
                    return list(np.linspace(lo, hi, n))
                return list(np.exp(np.linspace(np.log(lo), np.log(hi), n)))
        return [spec]

    keys = list(variables.keys())
    value_lists = [expand_one(variables[k]) for k in keys]
    return [dict(zip(keys, combo)) for combo in itertools.product(*value_lists)]


def substitute(template: str, mapping: Dict[str, Any]) -> str:
    """`{scene}`-style substitution in task command templates
    (task_manager.py:150-182)."""
    out = template
    for k, v in mapping.items():
        out = out.replace("{" + str(k) + "}", str(v))
    return out


_RESULT_PATTERNS = {
    "psnr": re.compile(r"psnr[\"':\s=]+([0-9.]+)", re.IGNORECASE),
    "capacity": re.compile(r"capacity[\"':\s=]+([0-9]+)", re.IGNORECASE),
}


def parse_stdout_metrics(text: str) -> Dict[str, float]:
    """Scrape metrics from task stdout (task_manager.py:107-115)."""
    out = {}
    for name, pat in _RESULT_PATTERNS.items():
        matches = pat.findall(text)
        if matches:
            out[name] = float(matches[-1])
    return out


def _run_task(task: Dict[str, Any]) -> Dict[str, Any]:
    env = os.environ.copy()
    env.update({str(k): str(v) for k, v in task.get("env", {}).items()})
    cmd = task["cmd"]
    try:
        proc = subprocess.run(
            cmd,
            shell=isinstance(cmd, str),
            capture_output=True,
            text=True,
            env=env,
            timeout=task.get("timeout", None),
            cwd=task.get("cwd"),
        )
        metrics = parse_stdout_metrics(proc.stdout + "\n" + proc.stderr)
        # prefer test_psnr.txt when the task wrote one (autotune.py:48-50)
        train_dir = task.get("train_dir")
        if train_dir:
            p = os.path.join(train_dir, "test_psnr.txt")
            if os.path.exists(p):
                metrics["psnr"] = float(open(p).read().strip())
        return {
            "name": task.get("name", ""),
            "returncode": proc.returncode,
            "metrics": metrics,
            "stdout_tail": proc.stdout[-2000:],
        }
    except subprocess.TimeoutExpired:
        return {"name": task.get("name", ""), "returncode": -1,
                "metrics": {}, "error": "timeout"}


class TaskManager:
    """Run a list of task dicts over N parallel workers; write results.txt."""

    def __init__(self, n_workers: Optional[int] = None):
        if n_workers is None:
            import torch  # here, not at the top: the spawned workers import this module

            n_workers = max(1, torch.cuda.device_count())
        self.n_workers = n_workers

    def run(self, tasks: List[Dict[str, Any]], results_path: Optional[str] = None):
        if self.n_workers <= 1 or len(tasks) <= 1:
            results = [_run_task(t) for t in tasks]
        else:
            with mp.get_context("spawn").Pool(self.n_workers) as pool:
                results = pool.map(_run_task, tasks)
        if results_path:
            with open(results_path, "w") as f:
                for r in results:
                    f.write(json.dumps(r) + "\n")
        return results


def build_tasks_from_spec(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Task spec format (octree/config task JSONs + autotune sweeps):

    {
      "train_root": "...", "data_root": "...",
      "tasks": [{"name": ..., "cmd": "... {scene} {var} ..."}],
      "scenes": ["lego", "chair"],
      "variables": {"lr_sigma": "loglin(1,30,3)"}
    }
    """
    scenes = spec.get("scenes", [None])
    sweeps = expand_variables(spec.get("variables", {})) or [{}]
    out = []
    for base in spec["tasks"]:
        for scene in scenes:
            for var in sweeps:
                mapping = dict(var)
                if scene is not None:
                    mapping["scene"] = scene
                for k in ("train_root", "data_root"):
                    if k in spec:
                        mapping[k] = spec[k]
                task = dict(base)
                task["cmd"] = substitute(base["cmd"], mapping)
                name_bits = [base.get("name", "task")]
                if scene:
                    name_bits.append(str(scene))
                name_bits += [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in var.items()]
                task["name"] = "_".join(name_bits)
                if "train_dir" in base:
                    task["train_dir"] = substitute(base["train_dir"], mapping)
                out.append(task)
    return out


def leaderboard(results: List[Dict[str, Any]], metric: str = "psnr"):
    """Sorted (best-first) summary (autotune leaderboard)."""
    scored = [
        (r["metrics"].get(metric, float("-inf")), r["name"]) for r in results
    ]
    return sorted(scored, reverse=True)
