"""The full NeRF-SH -> PlenOctree pipeline runner (port of
``nerf_projects_tpu/cli/full_pipeline.py``).

Parity target: reference plenoctree/scripts/full_pipeline.sh (train ->
extract -> optimize -> compress -> eval per scene, with skip and force
logic and logging) as a Python CLI: each stage runs the port's tool as
``python -m nerf_projects_tpu_torch.cli.<tool>``, writes its output to
``<stage>.log`` in the run directory and, on success, a ``.done_<stage>``
marker, so a run restarts stage by stage (``--force`` reruns them all).

    python -m nerf_projects_tpu_torch.cli.full_pipeline --data_dir SCENE --train_dir RUN [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _run(stage: str, cmd, log_dir: str, force: bool, marker: str):
    done = os.path.join(log_dir, f".done_{marker}")
    if os.path.exists(done) and not force:
        print(f"[skip] {stage}")
        return
    print(f"[run ] {stage}")
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(log_dir, f"{marker}.log"), "w") as f:
        f.write(res.stdout + "\n" + res.stderr)
    if res.returncode != 0:
        print(res.stdout[-2000:])
        print(res.stderr[-2000:])
        raise SystemExit(f"stage {stage} failed ({res.returncode})")
    with open(done, "w") as f:
        f.write("ok\n")


def main(argv=None):
    p = argparse.ArgumentParser(description="train->octree full pipeline")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--sh_deg", type=int, default=2)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--init_grid_depth", type=int, default=8)
    p.add_argument("--samples_per_cell", type=int, default=8)
    p.add_argument("--n_colors", type=int, default=65536)
    p.add_argument("--finetune_epochs", type=int, default=20)
    p.add_argument("--force", action="store_true")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--device", default=None, help="torch device of every stage (default: the card)")
    args = p.parse_args(argv)

    os.makedirs(args.train_dir, exist_ok=True)
    py = [sys.executable, "-m"]
    dev = ["--device", args.device] if args.device else []
    tree = os.path.join(args.train_dir, "octree.npz")
    tree_opt = os.path.join(args.train_dir, "octree_opt.npz")
    tree_c = os.path.join(args.train_dir, "octree_compressed.npz")

    if not args.skip_train:
        cmd = py + [
            "nerf_projects_tpu_torch.cli.train_nerf_sh",
            "--train_dir", args.train_dir,
            "--data_dir", args.data_dir,
            "--sh_deg", str(args.sh_deg),
            "--use_viewdirs", "false",
            "--max_steps", str(args.max_steps),
        ] + dev
        if args.config:
            cmd += ["--config", args.config]
        _run("train", cmd, args.train_dir, args.force, "train")

    tools = py + ["nerf_projects_tpu_torch.cli.octree_tools"]
    _run(
        "extract",
        tools + ["extract", "--train_dir", args.train_dir, "--data_dir", args.data_dir, "--output", tree,
                 "--autoscale", "--init_grid_depth", str(args.init_grid_depth),
                 "--samples_per_cell", str(args.samples_per_cell)] + dev,
        args.train_dir, args.force, "extract",
    )
    _run(
        "optimize",
        tools + ["optimize", "--input", tree, "--output", tree_opt, "--data_dir", args.data_dir,
                 "--num_epochs", str(args.finetune_epochs)] + dev,
        args.train_dir, args.force, "optimize",
    )
    _run(
        "compress",
        tools + ["compress", "--input", tree_opt, "--output", tree_c, "--n_colors", str(args.n_colors)] + dev,
        args.train_dir, args.force, "compress",
    )
    _run(
        "evaluate",
        tools + ["compressed_eval", "--input", tree_c, "--data_dir", args.data_dir, "--train_dir", args.train_dir,
                 "--output", os.path.join(args.train_dir, "octree_eval.json")] + dev,
        args.train_dir, args.force, "evaluate",
    )
    print(json.dumps({"train_dir": args.train_dir, "status": "complete"}))


if __name__ == "__main__":
    main()
