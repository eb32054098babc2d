"""Tile rendering over a BrickGrid (port of
``nerf_projects_tpu/ops/tile_render.py``).

Rays are grouped into coherent tiles (pixels of one image patch) that
march from the tile's least entry T0 with a shared SH basis at the
tile's mean view direction: the two sampling deviations from the exact
per-ray path (``ops/grid.py``) that the TPU's lockstep march documents,
both under one step of phase and ~1e-4 of colour.

On the TPU this module is the jnp twin of the Pallas march, with the
2x2x2-brick windows that drop samples outside them (``window_miss``).
In the port ``render_tiles`` is the plain PyTorch version of the march
(``ops/kernels/tile_march.py::march_reference``) on float32 cells: it
reads any brick, drops nothing, and reports ``window_miss`` 0.
``render_image_tiles_pallas_exact`` renders through the kernel; since
the march misses no sample, its exact re-render of missed rays never
fires.
"""
from __future__ import annotations

from typing import Optional

import torch

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.ops.brick_grid import BrickGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
from nerf_projects_tpu_torch.ops.kernels.tile_march import (
    build_kernel_arrays,
    default_chunks,
    march_outputs,
    march_reference,
    pack_rays,
    render_tiles_pallas,
)

__all__ = [
    "default_chunks",
    "render_image_tiles",
    "render_image_tiles_pallas_exact",
    "render_tiles",
    "tiles_from_image_rays",
    "untile_image",
]


def render_tiles(
    bg: BrickGrid,
    rays: Rays,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    steps_per_chunk: int = 12,
    n_chunks: Optional[int] = None,
    return_depth: bool = False,
):
    """Render rays [T, R] (T tiles of R coherent rays) through the plain
    march on float32 cells, at most n_chunks * steps_per_chunk steps
    (default: the grid diagonal). Returns dict(rgb [T, R, 3], acc,
    log_transmit, sparsity_sum, window_miss (0)[, depth])."""
    C = n_chunks or default_chunks(bg, opts.step_size, steps_per_chunk)
    pack, basis = pack_rays(bg, rays, opts)
    out = march_reference(
        build_kernel_arrays(bg, dtype=torch.float32), bg.brick_links, bg.reso, pack, basis,
        max_steps=C * steps_per_chunk, color_mode=opts.color_mode,
        sigma_thresh=opts.sigma_thresh, stop_thresh=opts.stop_thresh,
    )
    full = march_outputs(out, pack, opts, return_depth)
    keep = ("rgb", "acc", "log_transmit", "sparsity_sum", "window_miss", "depth")
    return {k: v for k, v in full.items() if k in keep}


def tiles_from_image_rays(rays: Rays, H: int, W: int, tile_h: int, tile_w: int) -> Rays:
    """Full-image rays [H*W] (row-major) -> coherent tiles
    [T, tile_h*tile_w]; H and W must divide by the tile's."""
    assert H % tile_h == 0 and W % tile_w == 0, (H, W, tile_h, tile_w)

    def rs(x):
        x = x.reshape(H // tile_h, tile_h, W // tile_w, tile_w, 3)
        return x.permute(0, 2, 1, 3, 4).reshape(-1, tile_h * tile_w, 3)

    return Rays(rs(rays.origins), rs(rays.directions), rs(rays.viewdirs))


def untile_image(vals: torch.Tensor, H: int, W: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """[T, tile_h*tile_w, C] -> [H, W, C] (inverse of tiles_from_image_rays)."""
    C = vals.shape[-1]
    v = vals.reshape(H // tile_h, W // tile_w, tile_h, tile_w, C)
    return v.permute(0, 2, 1, 3, 4).reshape(H, W, C)


def render_image_tiles(
    bg: BrickGrid,
    rays: Rays,
    H: int,
    W: int,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    tile_h: int = 8,
    tile_w: int = 16,
    tiles_per_batch: int = 128,
    return_depth: bool = False,
):
    """Full-image render of flat [H*W] row-major rays through
    ``render_tiles`` in batches of tiles -> dict of [H, W, ...] images."""
    tiles = tiles_from_image_rays(rays, H, W, tile_h, tile_w)
    T = tiles.origins.shape[0]
    outs = [
        render_tiles(bg, tiles.map(lambda x: x[i:i + tiles_per_batch]), opts, return_depth=return_depth)
        for i in range(0, T, tiles_per_batch)
    ]
    merged = {k: torch.cat([o[k] for o in outs]) for k in ("rgb", "acc", "depth") if k in outs[0]}
    result = {
        "rgb": untile_image(merged["rgb"], H, W, tile_h, tile_w),
        "acc": untile_image(merged["acc"][..., None], H, W, tile_h, tile_w)[..., 0],
    }
    if return_depth:
        result["depth"] = untile_image(merged["depth"][..., None], H, W, tile_h, tile_w)[..., 0]
    return result


def render_image_tiles_pallas_exact(
    bg: BrickGrid,
    rays: Rays,
    H: int,
    W: int,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    grid=None,
    kernel_arrays=None,
    tile_batch: int = 512,
    fallback_chunk: int = 2048,
):
    """Full-image render through the march kernel (``render_tiles_pallas``)
    in 8x16-ray tiles -> (rgb [H, W, 3], {"fallback_rays": n}).

    On the TPU the march drops samples outside its windows and this
    function re-renders the rays that lost some through the exact path.
    The port's march reads every sample, so ``fallback_rays`` counts the
    rays with a nonzero ``miss_per_ray``, which is 0, and ``grid`` and
    ``fallback_chunk`` are not used."""
    del grid, fallback_chunk
    tiles = tiles_from_image_rays(rays.map(lambda x: x.reshape(-1, 3)), H, W, 8, 16)
    parts, misses = [], []
    for i in range(0, tiles.origins.shape[0], tile_batch):
        out = render_tiles_pallas(bg, tiles.map(lambda x: x[i:i + tile_batch]), opts,
                                  kernel_arrays=kernel_arrays)
        parts.append(out["rgb"])
        misses.append(out["miss_per_ray"])
    img = untile_image(torch.cat(parts), H, W, 8, 16)
    miss = torch.cat(misses)
    return img, {"fallback_rays": int((miss > 0).sum())}
