"""Metrics of saved renders against ground-truth images (port of
``nerf_projects_tpu/cli/calc_metrics.py``).

Parity target: reference svox2/opt/calc_metrics.py: PSNR and SSIM over a
directory of rendered PNGs against a dataset split, with the advanced
metrics (MCQ, FDR) when a grid checkpoint is given. ``imageio`` is
imported at the call.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Metrics from saved renders")
    p.add_argument("render_dir")
    p.add_argument("data_dir")
    p.add_argument("--split", default="test")
    p.add_argument("--ckpt", default=None, help="grid npz for MCQ/FDR")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import imageio.v2 as imageio

    from nerf_projects_tpu_torch.data.base import load_scene
    from nerf_projects_tpu_torch.obs.metrics import compute_metrics

    scene = load_scene(args.data_dir, args.split)
    files = sorted(f for f in os.listdir(args.render_dir) if f.lower().endswith(("png", "jpg")))
    results = []
    for i, f in enumerate(files[: scene.images.shape[0]]):
        img = np.asarray(imageio.imread(os.path.join(args.render_dir, f)), np.float32) / 255.0
        results.append(compute_metrics(img[..., :3], scene.images[i]))
    mean = {k: float(np.mean([r[k] for r in results])) for k in results[0]}
    out = {"mean": mean, "per_image": results, "n_images": len(results)}

    if args.ckpt:
        from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
        from nerf_projects_tpu_torch.obs.advanced_metrics import compute_fdr, compute_mcq

        grid = SparseGrid.load(args.ckpt, device="cpu")
        out["advanced"] = {
            **compute_mcq(mean["psnr"], os.path.getsize(args.ckpt) / 2**20),
            **compute_fdr(grid, threshold=0.01, min_object_size=100),
        }

    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(mean))
    return out


if __name__ == "__main__":
    main()
