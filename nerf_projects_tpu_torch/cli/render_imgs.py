"""Plenoxels test-set renderer and metrics CLI (port of
``nerf_projects_tpu/cli/render_imgs.py``; reference svox2/opt/render_imgs.py).

Routes:
  * default: the fast per-ray render, as the JAX package's default, in
    chunks of rays: each ray's march shrunk to its occupied span
    (``build_occupancy``, at most 256 steps there), densities read from a
    bf16 dense cache (``make_render_cache``) and colour fetched only at
    the ``--color_top_k`` samples of largest weight (48);
  * ``--exact``: the exact per-ray render (``ops/grid.py::volume_render_grid``)
    of every sample, in chunks of rays;
  * ``--tiles``: 8x16-ray tiles through the march kernel
    (``ops/kernels/tile_march.py``);
  * ``--frame``: the whole frame in one march launch with per-ray early
    stop (``ops/kernels/frame_march.py``).
``--timing`` prints frames/s instead of metrics. The grid is an svox2-
schema npz (``SparseGrid.load``); ``--device`` defaults to the card.

    python -m nerf_projects_tpu_torch.cli.render_imgs grid.npz data_dir --frame
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import camera_rays_opencv
from nerf_projects_tpu_torch.data.base import load_scene
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.obs.metrics import compute_metrics, to8b
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions, volume_render_grid
from nerf_projects_tpu_torch.ops.tile_render import tiles_from_image_rays, untile_image

TILE_H, TILE_W = 8, 16


def _to_opencv_pose(c2w: np.ndarray, scene) -> np.ndarray:
    """OpenGL-convention c2w (-z forward, +y up, as the loaders store
    poses) -> OpenCV (+z forward, +y down), the convention the Plenoxels
    path renders with (svox2 nerf_dataset.py flips blender poses by
    diag(1, -1, -1) the same way)."""
    if scene.meta.get("convention", "opengl") == "opencv":
        return np.asarray(c2w)
    out = np.asarray(c2w, np.float64).copy()
    out[:3, 1] *= -1.0
    out[:3, 2] *= -1.0
    return out.astype(np.float32)


def _view_rays(scene, view, height, width, device):
    fx, fy = float(scene.intrinsics[0, 0]), float(scene.intrinsics[1, 1])
    cx, cy = float(scene.intrinsics[0, 2]), float(scene.intrinsics[1, 2])
    return camera_rays_opencv(height, width, fx, fy, cx, cy, _to_opencv_pose(scene.poses[view], scene),
                              device=device)


def render_grid_image(grid: SparseGrid, scene, view: int, opts: GridRenderOptions, chunk: int = 16384,
                      *, occupancy=None, color_top_k=None, dense_density=None) -> torch.Tensor:
    """The per-ray render of one view, in chunks of ``chunk`` rays, on the
    grid's device -> [H, W, 3]: exact with no keyword; ``occupancy``
    (``build_occupancy``) shrinks each ray to its occupied span, at most
    256 steps there, ``color_top_k`` and ``dense_density`` as
    ``volume_render_grid`` takes them (the JAX route's keywords)."""
    rays = _view_rays(scene, view, scene.height, scene.width, grid.device)
    flat = rays.map(lambda x: x.reshape(-1, 3))
    n = flat.origins.shape[0]
    outs = []
    for i in range(0, n, chunk):
        out = volume_render_grid(grid, flat.map(lambda x: x[i:i + chunk]), opts, occupancy=occupancy,
                                 active_steps=256 if occupancy is not None else None, color_top_k=color_top_k,
                                 dense_density=dense_density)
        outs.append(out["rgb"])
    return torch.cat(outs).reshape(scene.height, scene.width, 3)


def _padded_tiles(scene, view, device):
    Hp = -(-scene.height // TILE_H) * TILE_H
    Wp = -(-scene.width // TILE_W) * TILE_W
    rays = _view_rays(scene, view, Hp, Wp, device)
    return tiles_from_image_rays(rays.map(lambda x: x.reshape(-1, 3)), Hp, Wp, TILE_H, TILE_W), Hp, Wp


def render_grid_image_frame(bg, ka, scene, view: int, opts: GridRenderOptions, n_chunks: int,
                            max_windows=None) -> torch.Tensor:
    """One view through the whole-frame march (one launch, per-ray early
    stop) over prebuilt kernel arrays ``ka`` -> [H, W, 3]."""
    from nerf_projects_tpu_torch.ops.kernels.frame_march import render_frame_pallas

    tiles, Hp, Wp = _padded_tiles(scene, view, bg.device)
    out = render_frame_pallas(bg, tiles, opts, kernel_arrays=ka, n_chunks=n_chunks, use_occupancy=False,
                              max_windows=max_windows)
    return untile_image(out["rgb"], Hp, Wp, TILE_H, TILE_W)[: scene.height, : scene.width]


def render_grid_image_tiles(bg, ka, ck, scene, view: int, opts: GridRenderOptions,
                            exact_fallback_grid=None) -> torch.Tensor:
    """One view through the tile march over prebuilt kernel arrays
    ``ka`` -> [H, W, 3]. ``ck`` (the TPU's chunk compaction bound) and
    ``exact_fallback_grid`` (the TPU's re-render of window-missed rays)
    have nothing to do here: the port's march misses no sample."""
    from nerf_projects_tpu_torch.ops.kernels.tile_march import render_tiles_pallas

    del exact_fallback_grid
    tiles, Hp, Wp = _padded_tiles(scene, view, bg.device)
    out = render_tiles_pallas(bg, tiles, opts, kernel_arrays=ka, compact_chunks=ck)
    return untile_image(out["rgb"], Hp, Wp, TILE_H, TILE_W)[: scene.height, : scene.width]


def main(argv=None):
    p = argparse.ArgumentParser(description="Render/evaluate a Plenoxels grid")
    p.add_argument("ckpt", type=str, help="grid npz checkpoint (svox2 schema)")
    p.add_argument("data_dir", type=str)
    p.add_argument("--split", default="test")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--step_size", type=float, default=0.5)
    p.add_argument("--timing", action="store_true", help="frames/s mode (no metrics or saving)")
    p.add_argument("--frame", action="store_true",
                   help="whole-frame renderer: one march launch, per-ray early stop")
    p.add_argument("--tiles", action="store_true", help="render through the tile march kernel")
    p.add_argument("--exact", action="store_true",
                   help="the exact per-ray render: no occupancy interval, top-K colour or dense density cache")
    p.add_argument("--color_top_k", type=int, default=48)
    p.add_argument("--no_fallback", action="store_true",
                   help="accepted for the JAX CLI's sake: the TPU's tile route re-renders the rays its "
                        "windows miss; the port's march misses none")
    p.add_argument("--max_windows", type=int, default=None,
                   help="--frame: the TPU plan's window cap; not ported (raises)")
    p.add_argument("--chunk", type=int, default=16384)
    p.add_argument("--n_images", type=int, default=0, help="0 = all")
    p.add_argument("--device", default=None, help="torch device; default the CUDA card")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    grid = SparseGrid.load(args.ckpt, device=device)
    scene = load_scene(args.data_dir, args.split)
    opts = GridRenderOptions(step_size=args.step_size)
    n = scene.images.shape[0] if not args.n_images else min(args.n_images, scene.images.shape[0])

    if args.frame or args.tiles:
        from nerf_projects_tpu_torch.ops.brick_grid import from_sparse_grid
        from nerf_projects_tpu_torch.ops.kernels.tile_march import (
            build_kernel_arrays,
            default_chunks_for,
            geometry_only,
        )

        bg = from_sparse_grid(grid)
        ka = build_kernel_arrays(bg)
        n_chunks = default_chunks_for(bg, opts)
        bg = geometry_only(bg)
        if args.frame:
            def render_view(v):
                return render_grid_image_frame(bg, ka, scene, v, opts, n_chunks, max_windows=args.max_windows)
        else:
            def render_view(v):
                return render_grid_image_tiles(bg, ka, n_chunks, scene, v, opts)
    else:
        fast = {}
        if not args.exact:
            from nerf_projects_tpu_torch.ops.grid import make_render_cache
            from nerf_projects_tpu_torch.ops.grid_accel import build_occupancy

            fast = dict(occupancy=build_occupancy(grid, factor=8, sigma_thresh=opts.sigma_thresh),
                        color_top_k=args.color_top_k, dense_density=make_render_cache(grid, dtype=torch.bfloat16))

        def render_view(v):
            return render_grid_image(grid, scene, v, opts, args.chunk, **fast)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.timing:
        render_view(0)
        sync()
        t0 = time.perf_counter()
        for v in range(n):
            render_view(v)
        sync()
        dt = time.perf_counter() - t0
        print(json.dumps({"fps": n / dt, "sec_per_image": dt / n, "device": str(device)}))
        return

    results = []
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    for v in range(n):
        img = render_view(v)
        results.append(compute_metrics(img, scene.images[v]))
        if args.out_dir:
            import imageio.v2 as imageio

            imageio.imwrite(os.path.join(args.out_dir, f"{v:04d}.png"), to8b(img))
    mean = {k: float(np.mean([r[k] for r in results])) for k in results[0]}
    if args.out_dir:
        with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
            json.dump({"mean": mean, "per_image": results}, f, indent=2)
    print(json.dumps(mean))


if __name__ == "__main__":
    main()
