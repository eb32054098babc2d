"""Render-path video CLI (port of ``nerf_projects_tpu/cli/gen_video.py``).

Parity target: reference plenoctree/nerf_sh/gen_video.py and
svox2/opt/render_imgs_circle.py: render a spherical pose path from a
checkpoint (a Plenoxels grid npz, a PlenOctree npz or a NeRF-SH run
directory) to frames and an animation.

``make_renderer(args, device)`` builds the per-kind render function
(pose -> [H, W, 3] image tensor on ``device``); ``main`` writes its frames
with ``pipeline/video.py``. A machine without imageio can render the
frames through ``make_renderer`` and leave the files to another.
"""
from __future__ import annotations

import argparse
from typing import Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import spherical_pose_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render a pose-path video")
    p.add_argument("ckpt", help="grid npz / octree npz / NeRF-SH train_dir")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--kind", choices=["grid", "octree", "nerf_sh"], required=True)
    p.add_argument("--n_poses", type=int, default=40)
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--elevation", type=float, default=-30.0)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--focal", type=float, default=0.0, help="0 = width*1.1")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--step_size", type=float, default=0.5)
    p.add_argument("--chunk", type=int, default=16384)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p


def intrinsics(args) -> np.ndarray:
    """The path's pinhole K: focal ``--focal`` (0: 1.1 x width), centred."""
    H, W = args.height, args.width
    focal = args.focal or W * 1.1
    return np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)


def poses(args) -> np.ndarray:
    return spherical_pose_path(args.n_poses, args.elevation, args.radius)


def make_renderer(args, device: Optional[Union[str, torch.device]] = None):
    """The ``--kind`` render function from ``args.ckpt``: pose (a [4, 4]
    camera-to-world) -> rgb [H, W, 3] on ``device`` (None: the card)."""
    dev = resolve_device(device)
    H, W, K = args.height, args.width, intrinsics(args)

    def scene_at(pose, near, far):
        from nerf_projects_tpu_torch.data.base import SceneData

        return SceneData(images=np.zeros((1, H, W, 3), np.float32), poses=np.asarray([pose]), intrinsics=K,
                         near=near, far=far)

    if args.kind == "grid":
        from nerf_projects_tpu_torch.cli.render_imgs import render_grid_image
        from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
        from nerf_projects_tpu_torch.ops.grid import GridRenderOptions

        grid = SparseGrid.load(args.ckpt, device=dev)
        opts = GridRenderOptions(step_size=args.step_size)
        return lambda pose: render_grid_image(grid, scene_at(pose, 0.1, 10.0), 0, opts, args.chunk)
    if args.kind == "octree":
        from nerf_projects_tpu_torch.models.octree import PlenOctree
        from nerf_projects_tpu_torch.ops.octree_render import OctreeRenderOptions, render_image_octree

        tree = PlenOctree.load(args.ckpt, device=dev)
        opts = OctreeRenderOptions(step_size=1e-3)
        return lambda pose: render_image_octree(tree, H, W, K, pose, opts, args.chunk)
    if args.kind == "nerf_sh":
        from nerf_projects_tpu_torch.cli.octree_tools import _load_model
        from nerf_projects_tpu_torch.cli.train_nerf_sh import render_image_sh
        from nerf_projects_tpu_torch.train.nerf_sh_trainer import NeRFSHTrainer

        ns = argparse.Namespace(train_dir=args.ckpt, data_dir=None, config=None)
        flags, model = _load_model(ns, device=dev)
        trainer = NeRFSHTrainer(model, randomized=False, device=dev)
        return lambda pose: render_image_sh(trainer, model, scene_at(pose, flags.near, flags.far), 0,
                                            chunk=args.chunk, device=dev)
    raise ValueError(f"unknown --kind {args.kind!r}")


def main(argv=None):
    from nerf_projects_tpu_torch.pipeline.video import render_video

    args = build_parser().parse_args(argv)
    render = make_renderer(args, args.device)
    _, anim = render_video(render, poses(args), args.out_dir, fps=args.fps, basename="render")
    print(anim)
    return anim


if __name__ == "__main__":
    main()
