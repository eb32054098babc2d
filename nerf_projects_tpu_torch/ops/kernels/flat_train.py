"""The flat-plan fused train step over a BrickGrid (port of
``nerf_projects_tpu/ops/pallas/flat_train.py``: ``required_windows``,
``fused_grad_blocks_flat``).

On the TPU, the (T, C) train kernels march every tile for the batch's
largest active chunk count, so on surface scenes most marched windows
are padding; the flat plan compacts the batch's active (tile, window)
pairs into one list of static capacity ``w_cap`` and marches only those.
The port has no window plan: K3 and K4 march each ray alone from its
entry to its exit and jump the bricks that hold no data
(``csrc/tile_march.cuh``), so every ray already pays only for its own
bricks. ``fused_grad_blocks_flat`` is therefore ``fused_grad_blocks``
with the occupancy clip on (the flat plan always clips): ``w_cap`` and
``group`` are accepted and ignored, and nothing is dropped.
"""
from __future__ import annotations

import torch

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.ops.brick_grid import BrickGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
from nerf_projects_tpu_torch.ops.kernels.tile_march import SC, _step_range, active_chunk_bound, fused_grad_blocks, pack_rays


def required_windows(bg: BrickGrid, rays: Rays, opts: GridRenderOptions = GridRenderOptions()) -> int:
    """Host-side sizing probe (counterpart of ``required_windows``): the
    (tile, chunk of SC steps) pairs that the tiles' rays span inside the
    active bricks' box, the count the TPU's flat plan sizes ``w_cap`` by.
    The port's march needs no capacity; this only reports the span."""
    C = active_chunk_bound(bg, opts.step_size)
    pack, _ = pack_rays(bg, rays, opts, True)
    span = _step_range(pack, C * SC)  # [T, r, 2]
    hit = span[..., 1] > span[..., 0]
    lo = torch.where(hit, span[..., 0], float(C * SC)).amin(dim=-1)
    hi = torch.where(hit, span[..., 1], 0.0).amax(dim=-1)
    chunks = torch.clamp(torch.ceil(hi / SC) - torch.floor(lo / SC), min=0)
    return int(chunks.sum())


def fused_grad_blocks_flat(
    bg: BrickGrid,
    rays: Rays,
    rgb_gt: torch.Tensor,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    kernel_arrays,
    w_cap: int,
    beta_loss: float = 0.0,
    sparsity_loss: float = 0.0,
    grad_dtype=torch.float32,
    group: int = 640,
):
    """The fused render + gradient of the flat plan: ``fused_grad_blocks``
    with ``use_occupancy=True`` on prebuilt ``kernel_arrays`` (cells or
    masters, ``tile_march.kernel_cells``), returning its (rgb_out,
    (grad_density, grad_sh), touched, aux), aux with ``dropped_windows``
    (0) beside ``dropped_active_chunks`` (0). ``w_cap`` and ``group`` size
    the TPU's plan and ``grad_dtype`` its blocks: accepted and ignored."""
    del w_cap, group
    if kernel_arrays is None:
        raise ValueError("the flat train path requires prebuilt kernel arrays (the training state's cells)")
    rgb_out, grads, touched, aux = fused_grad_blocks(
        bg, rays, rgb_gt, opts, beta_loss=beta_loss, sparsity_loss=sparsity_loss, use_occupancy=True,
        kernel_arrays=kernel_arrays, grad_dtype=grad_dtype)
    aux["dropped_windows"] = aux["dropped_active_chunks"]
    return rgb_out, grads, touched, aux
