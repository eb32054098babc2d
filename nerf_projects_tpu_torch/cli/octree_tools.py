"""PlenOctree pipeline CLI: extract / optimize / evaluate / compress /
compressed_eval (port of ``nerf_projects_tpu/cli/octree_tools.py``).

Front end over ``pipeline.{extraction,optimization,compression}`` after
the reference CLIs (octree/extraction.py, octree/optimization.py,
octree/evaluation.py, octree/compression.py,
octree/compressed_evaluation.py) with the JAX package's flags and
defaults. It reads the NeRF-SH runs that ``cli/train_nerf_sh.py`` writes
(``flags.json``, ``checkpoint.pt``). Each ``cmd_*`` takes its scenes by
keyword too (``SceneData``), so a caller needs no scene folder; the
commands run on ``--device`` (default: the card).

    python -m nerf_projects_tpu_torch.cli.octree_tools extract --train_dir RUN --output tree.npz --autoscale
    python -m nerf_projects_tpu_torch.cli.octree_tools evaluate --input tree.npz --data_dir SCENE [--fast]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device


def _load_model(args, device=None):
    """(flags, model): the NeRF-SH architecture restored from the run's
    ``flags.json`` (every NeRFSHFlags field but the paths and the config,
    ``use_fused_trunk`` included), an explicit ``--config`` overlay, then
    ``checkpoint.pt``'s weights, on ``device`` (None: the card)."""
    from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
    from nerf_projects_tpu_torch.train.checkpoint import load_checkpoint
    from nerf_projects_tpu_torch.train.nerf_sh_trainer import NeRFSHTrainer
    from nerf_projects_tpu_torch.utils.config import update_flags

    flags = NeRFSHFlags(train_dir=args.train_dir, data_dir=args.data_dir)
    saved = os.path.join(flags.train_dir, "flags.json")
    if os.path.exists(saved):
        with open(saved) as f:
            data = json.load(f)
        keep = {"train_dir", "data_dir", "config"}
        for field in dataclasses.fields(flags):
            if field.name not in keep and field.name in data:
                setattr(flags, field.name, data[field.name])
    if getattr(args, "config", None):
        update_flags(flags, args.config)
    trainer = NeRFSHTrainer(build_model(flags), randomized=False, device=device)
    state = load_checkpoint(os.path.join(flags.train_dir, "checkpoint.pt"), trainer.init_state(0))
    state.model.eval()
    return flags, state.model


def _load_split(data_dir, split):
    from nerf_projects_tpu_torch.data.base import load_scene

    return load_scene(data_dir, split)


def cmd_extract(args, *, dataset=None, device=None, stats=None):
    """Extract a tree from the run and save it; ``dataset`` (the training
    split) serves the weight mask, else it is loaded from ``data_dir``.
    ``stats`` receives extract_octree's (the masked share, the finest
    leaves)."""
    from nerf_projects_tpu_torch.pipeline.extraction import auto_scale, extract_octree

    dev = resolve_device(device)
    flags, model = _load_model(args, dev)

    def eval_fn(pts):
        return model.eval_points_raw(pts)

    center, radius = (0.0, 0.0, 0.0), (args.radius,) * 3
    if args.autoscale:
        center, radius = auto_scale(eval_fn, center, radius, init_grid_depth=args.init_grid_depth,
                                    scale_alpha_thresh=args.scale_alpha_thresh, chunk=args.chunk, device=dev)
        radius = tuple(r * args.scale_margin for r in radius)
    data_dim = 3 * (flags.sh_deg + 1) ** 2 + 1 if flags.sh_deg >= 0 else 4
    if args.masking_mode == "weight" and dataset is None:
        dataset = _load_split(flags.data_dir, "train")
    tree = extract_octree(
        eval_fn,
        center=tuple(center),
        radius=tuple(radius),
        data_dim=data_dim,
        init_grid_depth=args.init_grid_depth,
        alpha_thresh=args.alpha_thresh,
        samples_per_cell=args.samples_per_cell,
        masking_mode=args.masking_mode,
        weight_thresh=args.weight_thresh,
        dataset=dataset if args.masking_mode == "weight" else None,
        renderer_step_size=args.renderer_step_size,
        chunk=args.chunk,
        device=dev,
        stats=stats,
    )
    tree.save(args.output)
    print(json.dumps({"nodes": tree.n_nodes, "leaves": tree.n_leaves, "output": args.output}))
    return tree


def cmd_optimize(args, *, train=None, val=None, device=None):
    """Finetune a saved tree (``OctreeFinetuner``) on ``train`` / ``val``
    (loaded from ``data_dir`` when not given; val falls back to train)."""
    from nerf_projects_tpu_torch.models.octree import PlenOctree
    from nerf_projects_tpu_torch.ops.octree_render import OctreeRenderOptions
    from nerf_projects_tpu_torch.pipeline.optimization import OctreeFinetuner

    dev = resolve_device(device)
    tree = PlenOctree.load(args.input, device=dev)
    if train is None:
        train = _load_split(args.data_dir, "train")
        try:
            val = _load_split(args.data_dir, "val")
        except Exception:
            val = train
    val = train if val is None else val
    # --sgd is store_true with default True, as in the JAX package: Adam is
    # never chosen from the command line
    ft = OctreeFinetuner(OctreeRenderOptions(step_size=args.renderer_step_size),
                         optimizer=args.sgd and "sgd" or "adam", lr=args.lr, chunk=args.chunk)
    tree2 = ft.finetune(tree, train, val, n_epochs=args.num_epochs, val_interval=args.val_interval)
    tree2.save(args.output or args.input)
    psnr = ft.eval_psnr(tree2, val)
    print(json.dumps({"psnr": psnr}))
    return tree2, psnr


def _evaluate_tree(tree, args, scene):
    from nerf_projects_tpu_torch.obs.json_logger import MetricsLogger
    from nerf_projects_tpu_torch.obs.metrics import compute_metrics
    from nerf_projects_tpu_torch.ops.octree_render import OctreeRenderOptions, render_image_octree

    opts = OctreeRenderOptions(step_size=args.renderer_step_size)
    fast_render = None
    if getattr(args, "fast", False):
        # bake to a grid and render it by the fast per-ray grid route
        # (occupancy + top-K colour + a bf16 dense density cache)
        from nerf_projects_tpu_torch.cli.render_imgs import render_grid_image
        from nerf_projects_tpu_torch.models.grid_lifecycle import octree_to_grid
        from nerf_projects_tpu_torch.ops.grid import GridRenderOptions, make_render_cache
        from nerf_projects_tpu_torch.ops.grid_accel import build_occupancy

        baked = octree_to_grid(tree, sigma_thresh=opts.sigma_thresh)
        gopts = GridRenderOptions(step_size=0.5, sigma_thresh=opts.sigma_thresh, color_mode="sigmoid")
        occ = build_occupancy(baked, factor=8, sigma_thresh=opts.sigma_thresh)
        cache = make_render_cache(baked, dtype=torch.bfloat16)

        def fast_render(v):
            with torch.inference_mode():
                return render_grid_image(baked, scene, v, gopts, args.chunk, occupancy=occ, color_top_k=48,
                                         dense_density=cache)

    results = []
    t0 = time.time()
    for v in range(scene.images.shape[0]):
        if fast_render is not None:
            img = fast_render(v)
        else:
            img = render_image_octree(tree, scene.height, scene.width, scene.intrinsics, scene.poses[v], opts,
                                      chunk=args.chunk)
        results.append(compute_metrics(img, scene.images[v]))
    elapsed = time.time() - t0
    mean = {k: float(np.mean([r[k] for r in results])) for k in results[0]}
    fps = len(results) / max(elapsed, 1e-9)
    out = {"mean": mean, "per_image": results, "fps": fps}
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    if args.train_dir:
        MetricsLogger(args.train_dir, clean_existing=False).log_octree_evaluation(0, mean, {"fps": fps})
    print(json.dumps({"psnr": mean["psnr"], "fps": fps}))
    return out


def cmd_evaluate(args, *, scene=None, device=None):
    """PSNR / SSIM of a saved tree on ``scene`` (the test split of
    ``data_dir`` when not given): the exact octree march, or with
    ``--fast`` the baked grid's fast route."""
    from nerf_projects_tpu_torch.models.octree import PlenOctree

    dev = resolve_device(device)
    scene = _load_split(args.data_dir, "test") if scene is None else scene
    return _evaluate_tree(PlenOctree.load(args.input, device=dev), args, scene)


def cmd_compress(args, *, device=None):
    from nerf_projects_tpu_torch.models.octree import PlenOctree
    from nerf_projects_tpu_torch.pipeline.compression import compress_octree

    tree = PlenOctree.load(args.input, device=resolve_device(device))
    stats = compress_octree(tree, args.output, n_colors=args.n_colors, sigma_thresh=args.sigma_thresh,
                            retain=args.retain)
    print(json.dumps(stats))
    return stats


def cmd_compressed_eval(args, *, scene=None, device=None):
    """``evaluate`` of a compressed tree. The JAX package saves the tree
    to a temporary npz (float16 data) and evaluates that; the palette,
    the retained coefficients and sigma are float16 already, so the tree
    is evaluated as loaded."""
    from nerf_projects_tpu_torch.pipeline.compression import load_compressed_octree

    dev = resolve_device(device)
    scene = _load_split(args.data_dir, "test") if scene is None else scene
    return _evaluate_tree(load_compressed_octree(args.input, device=dev), args, scene)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PlenOctree tools (H100)")
    sub = p.add_subparsers(dest="command", required=True)

    pe = sub.add_parser("extract")
    pe.add_argument("--train_dir", required=True)
    pe.add_argument("--data_dir", default=None)
    pe.add_argument("--config", default=None)
    pe.add_argument("--output", required=True)
    pe.add_argument("--radius", type=float, default=1.5)
    pe.add_argument("--autoscale", action="store_true")
    pe.add_argument("--scale_alpha_thresh", type=float, default=0.01)
    pe.add_argument("--scale_margin", type=float, default=1.05)
    pe.add_argument("--init_grid_depth", type=int, default=8)
    pe.add_argument("--alpha_thresh", type=float, default=0.01)
    pe.add_argument("--samples_per_cell", type=int, default=8)
    pe.add_argument("--masking_mode", choices=["sigma", "weight"], default="sigma")
    pe.add_argument("--weight_thresh", type=float, default=1e-4)
    pe.add_argument("--renderer_step_size", type=float, default=1e-3)
    pe.add_argument("--chunk", type=int, default=65536)
    pe.set_defaults(fn=cmd_extract)

    po = sub.add_parser("optimize")
    po.add_argument("--input", required=True)
    po.add_argument("--output", default=None)
    po.add_argument("--data_dir", required=True)
    po.add_argument("--lr", type=float, default=1e7)
    po.add_argument("--sgd", action="store_true", default=True)
    po.add_argument("--num_epochs", type=int, default=80)
    po.add_argument("--val_interval", type=int, default=2)
    po.add_argument("--renderer_step_size", type=float, default=1e-3)
    po.add_argument("--chunk", type=int, default=8192)
    po.set_defaults(fn=cmd_optimize)

    for name, fn in (("evaluate", cmd_evaluate), ("compressed_eval", cmd_compressed_eval)):
        pv = sub.add_parser(name)
        pv.add_argument("--input", required=True)
        pv.add_argument("--data_dir", required=True)
        pv.add_argument("--train_dir", default=None)
        pv.add_argument("--output", default=None)
        pv.add_argument("--renderer_step_size", type=float, default=1e-3)
        pv.add_argument("--chunk", type=int, default=16384)
        if name == "evaluate":
            pv.add_argument("--fast", action="store_true", help="bake to a grid and use the fast grid render route")
        pv.set_defaults(fn=fn)

    pc = sub.add_parser("compress")
    pc.add_argument("--input", required=True)
    pc.add_argument("--output", required=True)
    pc.add_argument("--n_colors", type=int, default=65536)
    pc.add_argument("--sigma_thresh", type=float, default=1.0)
    pc.add_argument("--retain", type=int, default=1)
    pc.set_defaults(fn=cmd_compress)
    for sp in sub.choices.values():
        sp.add_argument("--device", default=None, help="torch device (default: the card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args, device=args.device)


if __name__ == "__main__":
    main()
