"""NeRF-SH evaluation CLI (port of ``nerf_projects_tpu/cli/eval_nerf_sh.py``).

Parity target: reference plenoctree/nerf_sh/eval.py:41-300 — render the
test set from the checkpoint (optionally every ``approx_eval_skip``-th
view), per-frame PSNR/SSIM, prediction PNGs (imageio imported at the
call) and the THREE JSON outputs:
  * nerf_evaluation_steps.json    — per-image metrics;
  * nerf_evaluation_summary.json  — averages + rays/sec + memory &
    efficiency indices;
  * nerf_evaluation_final.json    — final scalar summary.

    python -m nerf_projects_tpu_torch.cli.eval_nerf_sh --train_dir DIR --data_dir SCENE [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
from nerf_projects_tpu_torch.cli.train_nerf_sh import flag_parser, flags_from, render_image_sh
from nerf_projects_tpu_torch.obs.memory_tracker import MemoryTracker
from nerf_projects_tpu_torch.obs.metrics import compute_metrics, to8b
from nerf_projects_tpu_torch.train.checkpoint import load_checkpoint
from nerf_projects_tpu_torch.train.nerf_sh_trainer import NeRFSHTrainer


def evaluate(flags: NeRFSHFlags, *, trainer=None, state=None, scene=None,
             device: Optional[Union[str, torch.device]] = None):
    """Evaluate ``checkpoint.pt`` (or a passed-in trainer and state) on a
    test set, on ``device`` (``None``: the card; a passed-in trainer's
    device otherwise)."""
    if trainer is None:
        # Restore architecture flags saved at training time when present.
        saved = os.path.join(flags.train_dir, "flags.json")
        if os.path.exists(saved):
            with open(saved) as f:
                data = json.load(f)
            keep = {"train_dir", "data_dir", "config", "chunk",
                    "approx_eval_skip", "save_output", "eval_once"}
            for field in dataclasses.fields(flags):
                if field.name not in keep and field.name in data:
                    setattr(flags, field.name, data[field.name])
        model = build_model(flags)
        trainer = NeRFSHTrainer(model, randomized=False, device=device)
        state = load_checkpoint(os.path.join(flags.train_dir, "checkpoint.pt"), trainer.init_state(0))
    if scene is None:
        from nerf_projects_tpu_torch.data.base import load_scene

        scene = load_scene(flags.data_dir, "test", white_bkgd=flags.white_bkgd)

    out_dir = os.path.join(flags.train_dir, "test_preds")
    if flags.save_output:
        os.makedirs(out_dir, exist_ok=True)

    tracker = MemoryTracker()
    steps_log = []
    t0 = time.time()
    n_rays_total = 0
    views = range(0, scene.images.shape[0], max(1, flags.approx_eval_skip))
    for v in views:
        img = render_image_sh(trainer, state.model, scene, v, chunk=flags.chunk, device=trainer.device)
        n_rays_total += scene.height * scene.width
        m = compute_metrics(img, scene.images[v])
        m["image_index"] = int(v)
        steps_log.append(m)
        if flags.save_output:
            import imageio.v2 as imageio

            imageio.imwrite(os.path.join(out_dir, f"{v:03d}.png"), to8b(img))
    elapsed = time.time() - t0
    tracker.capture_snapshot(0)

    mean = {
        k: float(np.mean([s[k] for s in steps_log]))
        for k in ("mse", "psnr", "ssim")
    }
    efficiency = tracker.calculate_efficiency_indices(
        mean["psnr"], ssim=mean["ssim"]
    )
    summary = {
        **mean,
        "n_images": len(steps_log),
        "rays_per_sec": n_rays_total / max(elapsed, 1e-9),
        "elapsed_sec": elapsed,
        "memory": tracker.get_memory_metrics(),
        "efficiency_indices": efficiency,
    }
    with open(os.path.join(flags.train_dir, "nerf_evaluation_steps.json"), "w") as f:
        json.dump(steps_log, f, indent=2)
    with open(os.path.join(flags.train_dir, "nerf_evaluation_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(flags.train_dir, "nerf_evaluation_final.json"), "w") as f:
        json.dump({"psnr": mean["psnr"], "ssim": mean["ssim"]}, f, indent=2)
    return summary


def main(argv=None):
    ns = flag_parser("Evaluate NeRF-SH (H100)").parse_args(argv)
    flags = flags_from(ns)
    if flags.config:
        from nerf_projects_tpu_torch.utils.config import update_flags

        update_flags(flags, flags.config)
    summary = evaluate(flags, device=ns.device)
    print(json.dumps({k: v for k, v in summary.items()
                      if not isinstance(v, dict)}))


if __name__ == "__main__":
    main()
