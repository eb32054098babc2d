"""Plenoxels tile march, forward (K3): port of
``nerf_projects_tpu/ops/pallas/tile_march.py``'s render side.

The kernel ``tile_march_fwd`` (``csrc/tile_march_fwd.cu``, CUDA C++ for
sm_90a, built with nvcc and loaded with ctypes) marches tiles of r rays
(any r) through a brick grid; ``march_reference`` is its plain PyTorch
version. ``march`` takes the plain version for host tensors and launches
the kernel, or raises, for CUDA tensors.

What it computes, per tile (from ``_make_fwd_kernel`` and ``_pack_rays``):
ray geometry in grid space, samples at tt = T0 + k * dt from the tile's
least entry T0, trilinear density and SH from 8 cells, the tile's SH
basis at its mean view direction, and the cuvol composite with
sigma_thresh and stop_thresh (see the kernel source for the terms).

What does not carry over: the TPU march reads 2x2x2-brick windows and
drops the samples that fall outside them (``miss_per_ray``,
``window_miss``). The port reads any brick through ``brick_links``, so
it drops nothing: ``miss_per_ray`` and ``window_miss`` are 0, and the
chunk plan's knobs (``n_chunks`` aside, which bounds the march length
at n_chunks * SC steps as on the TPU) are accepted and ignored.

Kernel arrays: the port's own layout, one tensor ``cells`` [nb, 512, CP]
with each cell's density and 3B SH coefficients together (channel 0
density, then c * B + b), zero-padded to CP = 8 * ceil((1 + 3B) / 8)
channels; bf16 by default (64 bytes a cell at B = 9).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.ops.brick_grid import BRICK, BrickGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions, decode_rgb, ray_grid_geometry
from nerf_projects_tpu_torch.ops.kernels.fused_mlp import (
    _INT,
    _LL,
    _VP,
    check_tensor,
    current_stream,
    load_library,
)
from nerf_projects_tpu_torch.ops.sh import eval_sh_bases

SC = 16          # steps per TPU chunk: n_chunks counts these
PACK = 12        # per-ray floats: og xyz, dg xyz, dt, t0, t1, T0, step_world, world_len
BASIS_DIMS = (1, 4, 9, 16, 25)
_BIG = 1e30
# Float operations the march needs (an FMA counts 2), the count of the
# kernel's bound. A marched sample: tt 2, position 6, fractions and their
# complements 6, the 8 corner weights 12, 8 density taps 16, threshold 1,
# transmittance 3, sparsity 4.
FLOPS_PER_SAMPLE = 50


def flops_per_shaded(basis_dim: int) -> int:
    """Float operations a shaded sample adds: 8 corners of 3B SH taps,
    one 3B dot with the basis, the bias activation 6, the composite 15."""
    return 8 * 2 * 3 * basis_dim + 2 * 3 * basis_dim + 6 + 15


def channels(basis_dim: int) -> int:
    """Channels a cell holds in the kernel arrays: 1 + 3B padded to 8."""
    return -(-(1 + 3 * basis_dim) // 8) * 8


# ---------------------------------------------------------------------------
# Kernel arrays and ray geometry
# ---------------------------------------------------------------------------

def build_kernel_arrays(bg: BrickGrid, dtype=torch.bfloat16) -> torch.Tensor:
    """The march's cell array [nb, 512, CP] from the brick grid's
    density and SH (counterpart of ``build_kernel_arrays``)."""
    B = bg.basis_dim
    cells = torch.zeros((bg.n_bricks, BRICK**3, channels(B)), dtype=dtype, device=bg.device)
    cells[..., 0] = bg.density_bricks.reshape(bg.n_bricks, BRICK**3)
    cells[..., 1:1 + 3 * B] = bg.sh_bricks.reshape(bg.n_bricks, BRICK**3, 3 * B)
    return cells


# The port has one layout: the TPU's packed variant is the same array.
build_packed_kernel_arrays = build_kernel_arrays


def geometry_only(bg: BrickGrid) -> BrickGrid:
    """The brick grid with its float32 data shrunk to placeholders,
    geometry kept: valid wherever prebuilt kernel arrays are passed."""
    nb = bg.n_bricks
    return dataclasses.replace(
        bg,
        density_bricks=bg.density_bricks.new_zeros((nb, 1)),
        sh_bricks=bg.sh_bricks.new_zeros((nb, 1, 1)),
    )


def mean_viewdir_basis(basis_dim: int, viewdirs: torch.Tensor) -> torch.Tensor:
    """Each tile's SH basis [T, B] at its normalised mean view direction
    (viewdirs [T, r, 3])."""
    vmean = torch.mean(viewdirs, dim=1)
    vmean = vmean / torch.clamp(torch.linalg.norm(vmean, dim=-1, keepdim=True), min=1e-12)
    return eval_sh_bases(basis_dim, vmean).float()


def pack_rays(bg: BrickGrid, rays: Rays, opts: GridRenderOptions, use_occupancy=False):
    """Per-ray geometry [T, r, PACK] float32 and the tile basis [T, B],
    as ``_pack_rays``: grid-space origin and direction, dt, [t0, t1) (the
    box clip, ``near_clip``, and with ``use_occupancy`` the active bricks'
    box (True / "aabb") or probes ("probe")), the tile's least hit t0 as
    T0, step_world and |d|. A ray that misses gets t0 = 1e30, t1 = -1e30."""
    og = bg.world_to_grid(rays.origins)
    dg, world_len, dt, step_world, t0, t1 = ray_grid_geometry(
        bg.reso, bg.radius, og, rays.directions, opts)
    if use_occupancy:
        from nerf_projects_tpu_torch.ops.grid_accel import OccupancyGrid, aabb_t_range, active_t_range

        occ = OccupancyGrid(bitmap=bg.brick_links >= 0, factor=BRICK)
        shrink = active_t_range if use_occupancy == "probe" else aabb_t_range
        te, tx = shrink(occ, og.reshape(-1, 3), dg.reshape(-1, 3), t0.reshape(-1), t1.reshape(-1))
        t0 = torch.maximum(t0, te.reshape(t0.shape))
        t1 = torch.minimum(t1, tx.reshape(t1.shape))
    hit = t1 > t0
    T0 = torch.where(hit, t0, _BIG).amin(dim=-1)
    T0 = torch.where(T0 < _BIG, T0, 0.0)
    pack = torch.cat([
        og, dg, dt[..., None],
        torch.where(hit, t0, _BIG)[..., None], torch.where(hit, t1, -_BIG)[..., None],
        T0[:, None, None].expand(t0.shape + (1,)), step_world[..., None], world_len[..., None],
    ], dim=-1).float().contiguous()
    return pack, mean_viewdir_basis(bg.basis_dim, rays.viewdirs)


def default_chunks(bg: BrickGrid, step_size: float, steps_per_chunk: int = SC) -> int:
    diag = float(np.linalg.norm(np.asarray(bg.reso, np.float64)))
    total = int(np.ceil(diag / step_size)) + 1
    return -(-total // steps_per_chunk)


def default_chunks_for(bg: BrickGrid, opts: GridRenderOptions) -> int:
    """Chunks of SC steps covering the grid diagonal: the march length
    bound is default_chunks_for * SC steps, as on the TPU."""
    return default_chunks(bg, opts.step_size, SC)


def active_chunk_bound(bg: BrickGrid, step_size: float = 0.5) -> int:
    """Chunks covering the longest chord through the active bricks'
    bounding box (host-side, once per topology)."""
    coords = bg.brick_coords.cpu().numpy()
    if len(coords) == 0:
        return 1
    span = (coords.max(0) - coords.min(0) + 2) * BRICK
    diag = float(np.linalg.norm(span.astype(np.float64)))
    return int(np.ceil(diag / (SC * step_size))) + 2


def _step_range(pack: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Per ray [first, last) candidate step, a little wider than the
    valid span; the predicate t0 <= tt < t1 decides exactly."""
    dt, t0, t1, T0 = pack[..., 6], pack[..., 7], pack[..., 8], pack[..., 9]
    hit = t1 > t0
    lo = torch.where(hit, torch.floor((t0 - T0) / dt) - 2.0, float(max_steps))
    hi = torch.where(hit, torch.ceil((t1 - T0) / dt) + 2.0, 0.0)
    return torch.stack([lo.clamp(0, max_steps), hi.clamp(0, max_steps)], dim=-1)


def required_chunks(bg: BrickGrid, rays: Rays, opts: GridRenderOptions = GridRenderOptions(),
                    *, use_occupancy: bool = False, multiple: int = 8) -> int:
    """Chunks of SC steps that the longest ray of these tiles needs,
    rounded up to ``multiple`` and capped at ``default_chunks_for``. On
    the TPU this sizes the chunk compaction; the port's march needs no
    plan, so it only reports the span."""
    C = default_chunks_for(bg, opts)
    pack, _ = pack_rays(bg, rays, opts, use_occupancy)
    span = _step_range(pack, C * SC)
    need = max(1, math.ceil(float(span[..., 1].amax()) / SC))
    return min(C, -(-need // multiple) * multiple)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

_CORNERS = [(cx, cy, cz) for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)]


def _corners(brick_links: torch.Tensor, reso, pos: torch.Tensor):
    """For each of the 8 cells around grid coordinates [..., 3]: (brick
    row, -1 where empty; cell in the brick; trilinear weight). The lower
    corner is clamped to [0, reso - 2] and the weights to [0, 1], as
    ``ops.grid.trilerp``."""
    reso_t = torch.as_tensor(reso, device=pos.device)
    l = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), reso_t - 2)
    w = torch.clamp(pos - l.to(pos.dtype), 0.0, 1.0)
    for cx, cy, cz in _CORNERS:
        c = l + torch.tensor([cx, cy, cz], device=pos.device)
        row = brick_links[c[..., 0] >> 3, c[..., 1] >> 3, c[..., 2] >> 3].long()
        o = c & 7
        wt = ((w[..., 0] if cx else 1 - w[..., 0]) * (w[..., 1] if cy else 1 - w[..., 1])
              * (w[..., 2] if cz else 1 - w[..., 2]))
        yield row, o[..., 0] * 64 + o[..., 1] * 8 + o[..., 2], wt


def trilerp_cells(cells: torch.Tensor, brick_links: torch.Tensor, reso, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of every channel of the cell array at grid
    coordinates [..., 3] -> [..., CP] float32, through brick_links (empty
    bricks read 0)."""
    if cells.shape[0] == 0:  # no active brick: everything reads 0
        return pos.new_zeros(pos.shape[:-1] + cells.shape[-1:])
    out = None
    for row, cell, wt in _corners(brick_links, reso, pos):
        vals = torch.where((row >= 0)[..., None], cells[row.clamp(min=0), cell].float(), 0.0)
        term = wt[..., None] * vals
        out = term if out is None else out + term
    return out


def march_reference(cells: torch.Tensor, brick_links: torch.Tensor, reso, pack: torch.Tensor,
                    basis: torch.Tensor, *, max_steps: int, color_mode: str = "bias",
                    sigma_thresh: float = 1e-8, stop_thresh: float = 1e-7, early_stop: bool = False,
                    slice_steps: int = 32, counts: bool = False):
    """Plain version of ``tile_march_fwd`` on any device, ``slice_steps``
    steps of every ray at a time: out [T, 8, r] float32 (rgb, acc,
    depth_t, -log_transmit, sparsity, misses (0)). With ``counts``,
    (out, dict(marched [T, r], shaded [T, r] int32: the samples each ray
    marches and shades; touched [nb] bool: the bricks their corners
    read)), the work the kernel does on these inputs."""
    T, r, _ = pack.shape
    B = basis.shape[-1]
    p = pack.reshape(T * r, PACK)
    og, dg = p[:, 0:3], p[:, 3:6]
    dt, t0, t1, T0, sw = p[:, 6], p[:, 7], p[:, 8], p[:, 9], p[:, 10]
    bas = basis.float().repeat_interleave(r, dim=0)  # [N, B]
    N, dev = T * r, pack.device
    span = _step_range(p, max_steps)
    k_start, k_end = int(span[:, 0].amin()), int(span[:, 1].amax())

    zeros = functools.partial(torch.zeros, N, device=dev)
    cum, acc, depth, spars = zeros(), zeros(), zeros(), zeros()
    rgb_acc = torch.zeros(N, 3, device=dev)
    n_marched = torch.zeros(N, dtype=torch.int32, device=dev)
    n_shaded = torch.zeros(N, dtype=torch.int32, device=dev)
    nb = cells.shape[0]
    touched = torch.zeros(nb + 1, dtype=torch.bool, device=dev)  # the last slot takes the unread corners
    for k0 in range(k_start, k_end, slice_steps):
        ks = torch.arange(k0, min(k0 + slice_steps, k_end), dtype=torch.float32, device=dev)
        tt = T0[:, None] + ks[None, :] * dt[:, None]  # [N, S]
        valid = (tt >= t0[:, None]) & (tt < t1[:, None])
        pos = og[:, None, :] + tt[..., None] * dg[:, None, :]
        vals = trilerp_cells(cells, brick_links, reso, pos)  # [N, S, CP]
        sigma = torch.where(valid, vals[..., 0], 0.0)
        sigma = torch.where(sigma > sigma_thresh, sigma, 0.0)
        rgb = decode_rgb(vals[..., 1:1 + 3 * B].reshape(N, -1, 3, B), bas[:, None, :], color_mode)

        tau = sigma * sw[:, None]
        prefix = cum[:, None] + torch.cat(
            [torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        Tp = torch.exp(-prefix)
        active = Tp > stop_thresh
        w = torch.where(active, Tp * (1.0 - torch.exp(-tau)), 0.0)
        rgb_acc += torch.einsum("ns,nsc->nc", w, rgb)
        acc += w.sum(-1)
        depth += (w * tt).sum(-1)
        cum += torch.where(active, tau, 0.0).sum(-1)
        live = valid & active if early_stop else valid
        spars += torch.where(live, torch.log1p(2.0 * sigma * sigma), 0.0).sum(-1)
        if counts:
            n_marched += live.sum(-1, dtype=torch.int32)
            n_shaded += (valid & active & (sigma > 0)).sum(-1, dtype=torch.int32)
            for row, _, _ in _corners(brick_links, reso, pos):
                touched.index_fill_(0, torch.where(live & (row >= 0), row, nb).reshape(-1), True)

    out = torch.stack([rgb_acc[:, 0], rgb_acc[:, 1], rgb_acc[:, 2], acc, depth, cum, spars,
                       torch.zeros_like(acc)], dim=0)  # [8, N]
    out = out.reshape(8, T, r).permute(1, 0, 2).contiguous()
    if not counts:
        return out
    return out, dict(marched=n_marched.reshape(T, r), shaded=n_shaded.reshape(T, r), touched=touched[:nb])


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    F = ctypes.c_float
    return load_library("tile_march_fwd", {
        "tile_march_fwd": ([_VP] * 5 + [_LL] + [_INT] * 8 + [F, F, _INT, _INT, _VP], _INT),
        "tile_march_fwd_channels": ([_INT], _INT),
        "tile_march_fwd_error_string": ([_INT], ctypes.c_char_p),
    })


def tile_march_fwd(cells: torch.Tensor, brick_links: torch.Tensor, reso, pack: torch.Tensor,
                   basis: torch.Tensor, *, max_steps: int, color_mode: str = "bias",
                   sigma_thresh: float = 1e-8, stop_thresh: float = 1e-7, early_stop: bool = False):
    """Launch the CUDA march: cells bf16 [nb, 512, CP], brick_links int32
    [BX, BY, BZ], pack float32 [T, r, PACK], basis float32 [T, B] on one
    card -> out [T, 8, r] as ``march_reference``."""
    dev = pack.device
    if dev.type != "cuda":
        raise ValueError(f"tile_march_fwd runs on a CUDA device, got {dev}")
    T, r, _ = pack.shape
    B = basis.shape[-1]
    if B not in BASIS_DIMS:
        raise ValueError(f"tile_march_fwd takes basis_dim in {BASIS_DIMS}, got {B}")
    if color_mode not in ("bias", "sigmoid"):
        raise NotImplementedError(f"unknown color mode {color_mode!r}")
    lib = _library()
    nb = cells.shape[0]
    check_tensor(cells, "cells", torch.bfloat16, (nb, BRICK**3, lib.tile_march_fwd_channels(B)), dev)
    check_tensor(brick_links, "brick_links", torch.int32, tuple(brick_links.shape), dev)
    check_tensor(pack, "pack", torch.float32, (T, r, PACK), dev)
    check_tensor(basis, "basis", torch.float32, (T, B), dev)
    BX, BY, BZ = brick_links.shape
    X, Y, Z = (int(v) for v in reso)
    if not (2 <= X <= BX * BRICK and 2 <= Y <= BY * BRICK and 2 <= Z <= BZ * BRICK):
        raise ValueError(f"reso {tuple(reso)} does not fit brick_links of shape {(BX, BY, BZ)}")
    out = torch.empty((T, 8, r), dtype=torch.float32, device=dev)
    if T * r == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.tile_march_fwd(
            cells.data_ptr(), brick_links.data_ptr(), pack.data_ptr(), basis.data_ptr(),
            out.data_ptr(), T * r, r, X, Y, Z, BY, BZ, B, int(max_steps), float(sigma_thresh), float(stop_thresh),
            int(color_mode == "sigmoid"), int(early_stop), current_stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"tile_march_fwd launch failed: {lib.tile_march_fwd_error_string(rc).decode()}")
    tile_march_fwd.launches += 1
    return out


tile_march_fwd.launches = 0


def march(cells, brick_links, reso, pack, basis, **kw):
    """The kernel for CUDA tensors, its plain version for host tensors."""
    if pack.device.type == "cuda":
        return tile_march_fwd(cells, brick_links, reso, pack, basis, **kw)
    return march_reference(cells, brick_links, reso, pack, basis, **kw)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def march_outputs(out: torch.Tensor, pack: torch.Tensor, opts: GridRenderOptions,
                  return_depth: bool) -> dict:
    """The march's [T, 8, r] block -> the render dict of
    ``render_tiles_pallas``."""
    acc = out[:, 3]
    result = {
        "rgb": out[:, 0:3].transpose(1, 2) + (1.0 - acc[..., None]) * opts.background_brightness,
        "acc": acc,
        "log_transmit": -out[:, 5],
        "sparsity_sum": out[:, 6],
        "miss_per_ray": out[:, 7],
        "window_miss": out[:, 7].sum() / max(1, out.shape[0] * out.shape[-1]),
    }
    if return_depth:
        result["depth"] = out[:, 4] * pack[..., 11]
    return result


def render_tiles_pallas(
    bg: BrickGrid,
    rays: Rays,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    n_chunks: Optional[int] = None,
    use_occupancy: bool = False,
    return_depth: bool = False,
    kernel_arrays: Optional[torch.Tensor] = None,
    compact_chunks: Optional[int] = None,
    wps: int = 1,
    early_stop: bool = False,
):
    """Render [T, r] coherent ray tiles through the march (counterpart of
    ``render_tiles_pallas``): dict(rgb [T, r, 3], acc, log_transmit,
    sparsity_sum, miss_per_ray (0), window_miss (0),
    dropped_active_chunks (0)[, depth]).

    The march is n_chunks * SC steps long at most (default: the grid
    diagonal; with ``use_occupancy``, the active bricks' box).
    ``kernel_arrays``: prebuilt cells (``build_kernel_arrays``), so the
    data fields of ``bg`` are not read. ``compact_chunks`` and ``wps``
    are TPU plan knobs, accepted and ignored. ``opts.sigma_thresh`` and
    ``opts.stop_thresh`` are used as given (the TPU kernel compiles in
    the defaults)."""
    del compact_chunks, wps
    if opts.color_mode not in ("bias", "sigmoid"):
        raise NotImplementedError(f"tile march: unknown color mode {opts.color_mode!r}")
    if n_chunks:
        C = n_chunks
    elif use_occupancy:
        C = active_chunk_bound(bg, opts.step_size)
    else:
        C = default_chunks_for(bg, opts)
    pack, basis = pack_rays(bg, rays, opts, use_occupancy)
    cells = kernel_arrays if kernel_arrays is not None else build_kernel_arrays(bg)
    out = march(
        cells, bg.brick_links, bg.reso, pack, basis, max_steps=C * SC, color_mode=opts.color_mode,
        sigma_thresh=opts.sigma_thresh, stop_thresh=opts.stop_thresh, early_stop=early_stop,
    )
    result = march_outputs(out, pack, opts, return_depth)
    result["dropped_active_chunks"] = torch.zeros((), dtype=torch.int32, device=pack.device)
    return result


def render_tiles_pallas_bucketed(bg: BrickGrid, rays: Rays, opts: GridRenderOptions = GridRenderOptions(),
                                 *, kernel_arrays=None, buckets: int = 3, use_occupancy: bool = False,
                                 return_depth: bool = False):
    """Counterpart of ``render_tiles_pallas_bucketed``. The TPU buckets
    tiles by their active-chunk count so that short tiles march fewer
    chunks; a per-ray march stops each ray at its own exit, so this is
    ``render_tiles_pallas`` (``buckets`` is ignored) without the
    window_miss and dropped_active_chunks keys, as on the TPU."""
    del buckets
    out = render_tiles_pallas(bg, rays, opts, kernel_arrays=kernel_arrays, use_occupancy=use_occupancy,
                              return_depth=return_depth)
    return {k: v for k, v in out.items() if k not in ("window_miss", "dropped_active_chunks")}
