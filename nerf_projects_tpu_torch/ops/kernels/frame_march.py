"""Whole-frame renderer over a BrickGrid (port of
``nerf_projects_tpu/ops/pallas/frame_march.py::render_frame_pallas``).

On the TPU a frame is rendered in one jitted program: a flat plan of
every frame's active 2x2x2-brick windows, marched by K3 in groups of
<= 640 grid steps, with an analytic occlusion cull (``term_cull``) and a
tile-level all-rays-saturated skip (``early_stop``). A per-ray march
needs none of that plan: the frame is one launch of the march kernel
(``tile_march.tile_march_fwd``) over all its tiles, and ``early_stop``
ends each ray where its transmittance falls below ``opts.stop_thresh``.
rgb, acc, depth and log_transmit are the same as without early stop.
The frame's outputs are built from the march's block alone: the TPU
plan's counters (``render_tiles_pallas``' window_miss, miss_per_ray,
sparsity_sum, dropped_active_chunks) are not formed.
"""
from __future__ import annotations

from typing import Optional

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.obs.trace import span
from nerf_projects_tpu_torch.ops.brick_grid import BrickGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
from nerf_projects_tpu_torch.ops.kernels.tile_march import default_chunks_for, frame_outputs, march, march_inputs


def render_frame_pallas(
    bg: BrickGrid,
    rays: Rays,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    kernel_arrays,
    n_chunks: Optional[int] = None,
    use_occupancy: bool = True,
    group: int = 640,
    max_windows: Optional[int] = None,
    return_depth: bool = False,
    early_stop: bool = True,
    term_cull: bool = True,
    gather_fetch: bool = False,
    wps: int = 1,
):
    """Render a whole frame of [T, r] ray tiles in one march launch (the
    plain version on host tensors) -> dict(rgb [T, r, 3], acc,
    log_transmit[, depth]).

    ``kernel_arrays``: the prebuilt cell array (``build_kernel_arrays``).
    ``use_occupancy`` clips each ray to the active bricks' box and, with
    no ``n_chunks``, the march length stays the grid diagonal, as on the
    TPU. ``group``, ``term_cull``, ``gather_fetch`` and ``wps`` shape the
    TPU's window plan and are accepted and ignored. ``max_windows``, the
    TPU plan's approximate per-tile window cap, is not ported: it raises
    NotImplementedError."""
    del group, term_cull, gather_fetch, wps
    if max_windows is not None:
        raise NotImplementedError("max_windows (a cap on the TPU's window plan) is not ported")
    with span("frame"):
        cells, pack, basis, max_steps = march_inputs(
            bg, rays, opts, n_chunks=n_chunks or default_chunks_for(bg, opts), use_occupancy=use_occupancy,
            kernel_arrays=kernel_arrays)
        out = march(cells, bg.brick_links, bg.reso, pack, basis, max_steps=max_steps, color_mode=opts.color_mode,
                    sigma_thresh=opts.sigma_thresh, stop_thresh=opts.stop_thresh, early_stop=early_stop)
        with span("frame.outputs"):
            return frame_outputs(out, pack, opts, return_depth)
