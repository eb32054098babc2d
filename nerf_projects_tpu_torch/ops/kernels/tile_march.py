"""Plenoxels tile march, forward (K3) and backward (K4): port of
``nerf_projects_tpu/ops/pallas/tile_march.py``.

The kernel ``tile_march_fwd`` (``csrc/tile_march_fwd.cu``, CUDA C++ for
sm_90a, built with nvcc and loaded with ctypes) marches tiles of r rays
(any r) through a brick grid; ``march_reference`` is its plain PyTorch
version. ``march`` takes the plain version for host tensors and launches
the kernel, or raises, for CUDA tensors. The backward ``tile_march_bwd``
(``csrc/tile_march_bwd.cu``) re-marches each ray through the same
stepping and skip (``csrc/tile_march.cuh``) and adds the density and SH
gradients of the MSE, beta and Cauchy sparsity losses, summed over each
corner's run of samples first, straight into brick-layout arrays;
``march_backward_reference`` is its plain version,
``backward_flushes`` the host twin of its runs, and ``march_backward``
dispatches as ``march`` does. With ``flag_touched`` the backward also
returns int32 [nb + 1] flags, 1 at each brick it adds a gradient into
(the kernel sets them where it adds a run; ``touched_bricks`` is the
plain version's set), the rows that the row-sparse training steps
update.
``render_fused_tiles_pallas`` runs both: the fused render + gradient of
a Plenoxels training step; ``fused_grad_blocks`` also returns the flags.

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

from nerf_projects_tpu_torch.core.device import device_constant
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.obs.trace import span
from nerf_projects_tpu_torch.ops.brick_grid import BRICK, BrickGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions, decode_rgb, ray_grid_geometry
from nerf_projects_tpu_torch.ops.kernels.fused_mlp import (
    _INT,
    _LL,
    _VP,
    check_tensor,
    launch_stream,
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
# A run of samples in a brick that no data can be read from costs one
# brick step: the landing sample's step and position 8, the exit through
# the brick's three faces 6 (a subtraction and a product with the
# reciprocal direction each), their minimum 2, the step index 3.
FLOPS_PER_BRICK_STEP = 19
SKIP_EPS = 1.0 / 128.0  # cells: the kernel's skip stays this far inside a brick (SKIP_EPS in the source)


def flops_per_shaded(basis_dim: int) -> int:
    """Float operations a shaded sample adds: 8 corners of 3B SH taps,
    one 3B dot with the basis, the bias activation 6, the composite 15."""
    return 8 * 2 * 3 * basis_dim + 2 * 3 * basis_dim + 6 + 15


def bwd_flops_per_shaded(basis_dim: int) -> int:
    """Float operations the backward adds to a shaded sample (after its
    re-march, counted as the forward's): c . g 5; w (c . g) and the
    running sum 2; T e^-tau, its product with c . g, the suffix and the
    difference 4; times step_world into g_sigma 2; g_rgb = w g decode' 6;
    then per corner cw g_sigma and its add 2, cw g_rgb 3 and the 3B
    products with the basis and their adds 6B."""
    return 5 + 2 + 4 + 2 + 6 + 8 * (2 + 3 + 6 * basis_dim)


# The Cauchy sparsity term on a sample with sigma above the threshold:
# sigma^2, 2 sigma^2, + 1, 4 sigma, the quotient, the scale, the add 7.
# On a sample that is not shaded (the ray is inactive), its density
# gradient is scattered alone: 8 corners of a product and an add, 16.
BWD_FLOPS_SPARSITY = 7
BWD_FLOPS_SPARSITY_UNSHADED = 16


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
    reso_t = device_constant(tuple(reso), torch.int64, pos.device)
    l = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), reso_t - 2)
    w = torch.clamp(pos - l.to(pos.dtype), 0.0, 1.0)
    for cx, cy, cz in _CORNERS:
        c = l + device_constant((cx, cy, cz), torch.int64, pos.device)
        row = brick_links[c[..., 0] >> 3, c[..., 1] >> 3, c[..., 2] >> 3].long()
        o = c & 7
        wt = ((w[..., 0] if cx else 1 - w[..., 0]) * (w[..., 1] if cy else 1 - w[..., 1])
              * (w[..., 2] if cz else 1 - w[..., 2]))
        yield row, o[..., 0] * 64 + o[..., 1] * 8 + o[..., 2], wt


def reachable_bricks(brick_links: torch.Tensor, reso) -> torch.Tensor:
    """[BX, BY, BZ] bool: the bricks b such that a sample whose lower
    corner lies in b can read data, i.e. one of the bricks b + {0, 1}^3
    (the upper corner may cross a face) is occupied, each index clamped to
    the last brick that holds a cell of the grid. The kernel applies this
    rule to the bricks its rays enter; this is its plain version."""
    occ = brick_links >= 0
    steps = []
    for n, r in zip(occ.shape, reso):
        i = torch.arange(n, device=occ.device)
        steps.append((i, torch.clamp(i + 1, max=(int(r) - 1) >> 3)))
    reach = torch.zeros_like(occ)
    for cx, cy, cz in _CORNERS:
        reach |= occ[steps[0][cx]][:, steps[1][cy]][:, :, steps[2][cz]]
    return reach


def _lower_brick(pos: torch.Tensor, reso_t: torch.Tensor) -> torch.Tensor:
    """The brick of each position's clamped lower corner [..., 3] int64."""
    return torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), reso_t - 2) >> 3


def kernel_visits(reach: torch.Tensor, reso, p: torch.Tensor, max_steps: int, k_start: int, k_end: int):
    """[N, k_end - k_start] bool: the steps at which the kernel evaluates
    each ray of the packed rays p [N, PACK] (the valid ones, t0 <= tt <
    t1), given the reachable-brick mask. It follows the kernel's stepping
    in the same float32 arithmetic: from the first candidate step, one
    step at a time, except that a valid sample whose lower corner lies in
    an unreachable brick b, at least SKIP_EPS inside b on every axis,
    jumps to the step after the last one before the ray leaves b shrunk
    by SKIP_EPS (that exit formed with the ray's reciprocal direction and
    step, as the kernel forms it)."""
    og, dg = p[:, 0:3], p[:, 3:6]
    dt, t0, t1, T0 = p[:, 6], p[:, 7], p[:, 8], p[:, 9]
    N, dev = p.shape[0], p.device
    reso_t = device_constant(tuple(reso), torch.int64, dev)
    kmax = float(max_steps)
    kf = torch.floor((t0 - T0) / dt) - 2.0
    k = torch.where(kf > 0, torch.minimum(kf, torch.full_like(kf, kmax)), 0.0).long()
    alive = (t1 > t0) & (k < max_steps)
    visit = torch.zeros((N, max(0, k_end - k_start)), dtype=torch.bool, device=dev)
    while bool(alive.any()):
        idx = alive.nonzero()[:, 0]
        kk = k[idx]
        tt = T0[idx] + kk.float() * dt[idx]
        valid = (tt >= t0[idx]) & (tt < t1[idx])
        done = ~(tt < t1[idx])
        o, d = og[idx], dg[idx]
        pos = o + tt[:, None] * d
        b = _lower_brick(pos, reso_t)
        lo = (8 * b).float() + SKIP_EPS
        hi = (8 * b + 8).float() - SKIP_EPS
        inside = ((pos >= lo) & (pos <= hi)).all(dim=-1)
        inv = 1.0 / d
        t_exit = torch.where(d > 0, (hi - o) * inv, torch.where(d < 0, (lo - o) * inv, float("inf")))
        kf = torch.floor((t_exit.amin(dim=-1) - T0[idx]) * (1.0 / dt[idx]))
        jump = valid & ~reach[b[:, 0], b[:, 1], b[:, 2]] & inside & (kf > kk.float())
        nxt = torch.where(jump, torch.minimum(kf, torch.full_like(kf, kmax - 1)).long(), kk) + 1
        rows = idx[valid]
        visit[rows, kk[valid] - k_start] = True
        k[idx] = nxt
        alive[idx] = ~done & (nxt < max_steps)
    return visit


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
                    slice_steps: int = 32, counts: bool = False, skip_empty: bool = False,
                    reach: Optional[torch.Tensor] = None):
    """Plain version of ``tile_march_fwd`` on any device, ``slice_steps``
    steps of every ray at a time: out [T, 8, r] float32 (rgb, acc,
    depth_t, -log_transmit, sparsity, misses (0)). With ``counts``,
    (out, dict(marched [T, r], shaded [T, r], dense [T, r], reach [T, r],
    brick_steps [T, r] int32: the samples each ray marches, shades,
    marches with sigma above the threshold, and marches with its lower
    corner in a reachable brick, and the runs of marched samples in one
    unreachable brick; touched [nb] bool: the bricks their corners read)),
    the work the kernel does on these inputs.

    ``reach`` is the reachable-brick mask (default
    ``reachable_bricks``). With ``skip_empty`` the march evaluates only
    the steps that the kernel visits (``kernel_visits``) and treats the
    others as reading nothing, as the kernel's skip does: with a right
    mask the outputs are the same bits as without it."""
    T, r, _ = pack.shape
    B = basis.shape[-1]
    p = pack.reshape(T * r, PACK)
    og, dg = p[:, 0:3], p[:, 3:6]
    dt, t0, t1, T0, sw = p[:, 6], p[:, 7], p[:, 8], p[:, 9], p[:, 10]
    bas = basis.float().repeat_interleave(r, dim=0)  # [N, B]
    N, dev = T * r, pack.device
    span = _step_range(p, max_steps)
    k_start, k_end = int(span[:, 0].amin()), int(span[:, 1].amax())
    if reach is None and (counts or skip_empty):
        reach = reachable_bricks(brick_links, reso)
    visits = kernel_visits(reach, reso, p, max_steps, k_start, k_end) if skip_empty else None
    reso_t = device_constant(tuple(reso), torch.int64, dev)

    zeros = functools.partial(torch.zeros, N, device=dev)
    cum, acc, depth, spars = zeros(), zeros(), zeros(), zeros()
    rgb_acc = torch.zeros(N, 3, device=dev)
    n_marched = torch.zeros(N, dtype=torch.int32, device=dev)
    n_shaded = torch.zeros(N, dtype=torch.int32, device=dev)
    n_dense = torch.zeros(N, dtype=torch.int32, device=dev)
    n_reach = torch.zeros(N, dtype=torch.int32, device=dev)
    n_steps = torch.zeros(N, dtype=torch.int32, device=dev)
    prev = torch.full((N,), -1, dtype=torch.int64, device=dev)  # brick of the last unreachable marched sample, else -1
    nb = cells.shape[0]
    touched = torch.zeros(nb + 1, dtype=torch.bool, device=dev)  # the last slot takes the unread corners
    for k0 in range(k_start, k_end, slice_steps):
        ks = torch.arange(k0, min(k0 + slice_steps, k_end), dtype=torch.float32, device=dev)
        tt = T0[:, None] + ks[None, :] * dt[:, None]  # [N, S]
        valid = (tt >= t0[:, None]) & (tt < t1[:, None])
        if skip_empty:
            valid &= visits[:, k0 - k_start:k0 - k_start + ks.shape[0]]
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
            n_dense += (live & (sigma > 0)).sum(-1, dtype=torch.int32)
            b = _lower_brick(pos, reso_t)
            ok = reach[b[..., 0], b[..., 1], b[..., 2]]
            n_reach += (live & ok).sum(-1, dtype=torch.int32)
            bid = torch.where(live & ~ok, (b[..., 0] * reach.shape[1] + b[..., 1]) * reach.shape[2] + b[..., 2], -1)
            before = torch.cat([prev[:, None], bid[:, :-1]], dim=-1)
            n_steps += ((bid >= 0) & (bid != before)).sum(-1, dtype=torch.int32)
            prev = bid[:, -1]
            for row, _, _ in _corners(brick_links, reso, pos):
                touched.index_fill_(0, torch.where(live & (row >= 0), row, nb).reshape(-1), True)

    out = torch.stack([rgb_acc[:, 0], rgb_acc[:, 1], rgb_acc[:, 2], acc, depth, cum, spars,
                       torch.zeros_like(acc)], dim=0)  # [8, N]
    out = out.reshape(8, T, r).permute(1, 0, 2).contiguous()
    if not counts:
        return out
    return out, dict(marched=n_marched.reshape(T, r), shaded=n_shaded.reshape(T, r),
                     dense=n_dense.reshape(T, r), reach=n_reach.reshape(T, r),
                     brick_steps=n_steps.reshape(T, r), touched=touched[:nb])


def _backward_terms(cells, brick_links, reso, pack, basis, grad_rgb, s_total, *, max_steps, color_mode,
                    sigma_thresh, stop_thresh, sparsity_scale, slice_steps, skip_empty, reach):
    """The plain backward's terms, ``slice_steps`` steps of every ray at a
    time: per slice and corner, dict(k [S] float32 step indices, cell [N,
    S] the corner's row * 512 + cell in the brick (row clamped to 0 where
    empty), ok [N, S] (valid, the corner occupied), enter [N, S] (ok and
    the kernel accumulates the sample: sigma above the threshold and the
    ray active or sparsity on), gd [N, S] (cw g_sigma), gc [N, S, 3] (cw
    g_rgb, before the basis))."""
    T, r, _ = pack.shape
    B = basis.shape[-1]
    p = pack.reshape(T * r, PACK)
    og, dg = p[:, 0:3], p[:, 3:6]
    dt, t0, t1, T0, sw = p[:, 6], p[:, 7], p[:, 8], p[:, 9], p[:, 10]
    bas = basis.float().repeat_interleave(r, dim=0)  # [N, B]
    g = grad_rgb.reshape(T * r, 3).float()
    S = s_total.reshape(T * r).float()
    N, dev = T * r, pack.device
    span = _step_range(p, max_steps)
    k_start, k_end = int(span[:, 0].amin()), int(span[:, 1].amax())
    if skip_empty and reach is None:
        reach = reachable_bricks(brick_links, reso)
    visits = kernel_visits(reach, reso, p, max_steps, k_start, k_end) if skip_empty else None

    cum = torch.zeros(N, device=dev)  # -log T over the active samples
    P = torch.zeros(N, device=dev)    # inclusive prefix of w (c . g)
    for k0 in range(k_start, k_end, slice_steps):
        ks = torch.arange(k0, min(k0 + slice_steps, k_end), dtype=torch.float32, device=dev)
        tt = T0[:, None] + ks[None, :] * dt[:, None]  # [N, S]
        valid = (tt >= t0[:, None]) & (tt < t1[:, None])
        if skip_empty:
            valid &= visits[:, k0 - k_start:k0 - k_start + ks.shape[0]]
        pos = og[:, None, :] + tt[..., None] * dg[:, None, :]
        vals = trilerp_cells(cells, brick_links, reso, pos)  # [N, S, CP]
        sig_pos = valid & (vals[..., 0] > sigma_thresh)
        sigma = torch.where(sig_pos, vals[..., 0], 0.0)
        raw = torch.sum(vals[..., 1:1 + 3 * B].reshape(N, -1, 3, B) * bas[:, None, None, :], dim=-1)
        if color_mode == "sigmoid":
            rgb = torch.sigmoid(raw)
            gate = rgb * (1.0 - rgb)
        else:
            rgb = torch.clamp(raw + 0.5, min=0.0)
            gate = (raw + 0.5 > 0.0).float()

        tau = sigma * sw[:, None]
        prefix = cum[:, None] + torch.cat(
            [torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        Tp = torch.exp(-prefix)
        active = Tp > stop_thresh
        e = torch.exp(-tau)
        w = torch.where(active, Tp * (1.0 - e), 0.0)
        cdotg = torch.sum(rgb * g[:, None, :], dim=-1)
        P_in = P[:, None] + torch.cumsum(w * cdotg, dim=-1)
        gtau = Tp * e * cdotg - (S[:, None] - P_in)
        gsig = torch.where(active & sig_pos, gtau * sw[:, None], 0.0)
        if sparsity_scale:
            gsig = gsig + torch.where(sig_pos, sparsity_scale * (4.0 * sigma / (1.0 + 2.0 * sigma * sigma)), 0.0)
        g_rgb = w[..., None] * g[:, None, :] * gate  # [N, S, 3]
        cum += torch.where(active, tau, 0.0).sum(-1)
        P = P_in[:, -1]
        enter = sig_pos & (active | (sparsity_scale != 0))
        corners = []
        for row, cell, wt in _corners(brick_links, reso, pos):
            ok = valid & (row >= 0)
            corners.append(dict(k=ks, cell=row.clamp(min=0) * BRICK**3 + cell, ok=ok, enter=ok & enter,
                                gd=wt * gsig, gc=wt[..., None] * g_rgb))
        yield corners


def march_backward_reference(cells: torch.Tensor, brick_links: torch.Tensor, reso, pack: torch.Tensor,
                             basis: torch.Tensor, grad_rgb: torch.Tensor, s_total: torch.Tensor, *,
                             max_steps: int, color_mode: str = "bias", sigma_thresh: float = 1e-8,
                             stop_thresh: float = 1e-7, sparsity_scale: float = 0.0, slice_steps: int = 32,
                             skip_empty: bool = False, reach: Optional[torch.Tensor] = None,
                             flag_touched: bool = False):
    """Plain version of ``tile_march_bwd`` on any device, ``slice_steps``
    steps of every ray at a time: the gradients of the march's loss with
    respect to the cells' density and SH, (grad_density [nb, 512],
    grad_sh [nb, 512, 3B]) float32, given grad_rgb [T, r, 3] (dL/d rgb_out)
    and s_total [T, r] (g . rgb_out plus the beta term). The formulas of
    ``_make_bwd_kernel``: on a sample with sigma above the threshold,
    dL/dtau = T e^-tau (c . g) - suffix while the ray is active, suffix =
    s_total minus the inclusive prefix of w (c . g); g_sigma = dL/dtau *
    step_world, plus sparsity_scale * 4 sigma / (1 + 2 sigma^2) on every
    valid sample; g_rgb = w g decode'. Each corner receives its trilinear
    weight's share through ``index_add_``.

    With ``skip_empty`` the backward evaluates only the steps that the
    kernel visits (``kernel_visits`` under the reachable-brick mask
    ``reach``, default ``reachable_bricks``), as the kernel's skip does:
    with a right mask the gradients are the same bits as without it.

    With ``flag_touched``, also int32 flags [nb + 1]: 1 at the brick of
    each corner term that the kernel accumulates (``enter``) with a
    nonzero density or colour gradient. That is ``touched_bricks``' set
    (the bricks of the kernel's runs that add) unless a run's terms
    cancel to an exact 0, where this set is the larger; any superset of
    the bricks with a nonzero gradient serves the training steps."""
    B = basis.shape[-1]
    nb = cells.shape[0]
    r = pack.shape[1]
    bas = basis.float().repeat_interleave(r, dim=0)  # [N, B]
    grad_d = torch.zeros(nb * BRICK**3, device=pack.device)
    grad_sh = torch.zeros(nb * BRICK**3, 3 * B, device=pack.device)
    touched = torch.zeros(nb + 1, dtype=torch.int32, device=pack.device)
    if nb == 0:
        out = grad_d.reshape(0, BRICK**3), grad_sh.reshape(0, BRICK**3, 3 * B)
        return out + (touched,) if flag_touched else out
    for corners in _backward_terms(cells, brick_links, reso, pack, basis, grad_rgb, s_total, max_steps=max_steps,
                                   color_mode=color_mode, sigma_thresh=sigma_thresh, stop_thresh=stop_thresh,
                                   sparsity_scale=sparsity_scale, slice_steps=slice_steps, skip_empty=skip_empty,
                                   reach=reach):
        for c in corners:
            idx, ok = c["cell"].reshape(-1), c["ok"]
            grad_d.index_add_(0, idx, torch.where(ok, c["gd"], 0.0).reshape(-1))
            gsh = c["gc"][..., None] * bas[:, None, None, :]  # [N, S, 3, B]
            grad_sh.index_add_(0, idx, torch.where(ok[..., None, None], gsh, 0.0).reshape(-1, 3 * B))
            if flag_touched:
                adds = c["enter"] & ((c["gd"] != 0) | (c["gc"] != 0).any(-1))
                touched.index_fill_(0, torch.where(adds, c["cell"] // BRICK**3, nb).reshape(-1), 1)
    out = grad_d.reshape(nb, BRICK**3), grad_sh.reshape(nb, BRICK**3, 3 * B)
    if flag_touched:
        touched[nb].fill_(0)
        return out + (touched,)
    return out


def backward_flushes(cells: torch.Tensor, brick_links: torch.Tensor, reso, pack: torch.Tensor,
                     basis: torch.Tensor, grad_rgb: torch.Tensor, s_total: torch.Tensor, *, max_steps: int,
                     color_mode: str = "bias", sigma_thresh: float = 1e-8, stop_thresh: float = 1e-7,
                     sparsity_scale: float = 0.0, slice_steps: int = 32, reach: Optional[torch.Tensor] = None):
    """Host twin of the kernel's pre-summed adds (``tile_march_bwd``): a
    ray's corner slot (the parities of its cell's coordinates) keeps a run
    while its cell stays the same over the samples the kernel accumulates
    (the skipping march's samples with sigma above the threshold, while
    the ray is active or with sparsity on), and adds the run's sums when
    the cell changes and at the ray's end: its density unless all its
    contributions are 0, and its 3B SH gradients unless all its colour
    contributions are 0, as float4 adds where grad_sh's row is 16-byte
    aligned and scalar ones around them. Returns dict(ray [F], cell [F]
    (row * 512 + cell in the brick), density [F], colour [F, 3] (before
    the tile basis), adds: the floats the kernel adds into the arrays,
    add_ops: the add instructions it issues for them, bricks: the bricks
    of the runs that add, the kernel's flags)."""
    B = basis.shape[-1]
    r = pack.shape[1]
    rays, ks, cells_, gd, gc = [], [], [], [], []
    N = pack.shape[0] * r
    ray_ids = torch.arange(N, device=pack.device)
    for corners in _backward_terms(cells, brick_links, reso, pack, basis, grad_rgb, s_total, max_steps=max_steps,
                                   color_mode=color_mode, sigma_thresh=sigma_thresh, stop_thresh=stop_thresh,
                                   sparsity_scale=sparsity_scale, slice_steps=slice_steps, skip_empty=True,
                                   reach=reach):
        for c in corners:
            m = c["enter"]
            rays.append(ray_ids[:, None].expand(m.shape)[m])
            ks.append(c["k"][None, :].expand(m.shape)[m])
            cells_.append(c["cell"][m])
            gd.append(c["gd"][m])
            gc.append(c["gc"][m])
    ray, k, cell = torch.cat(rays), torch.cat(ks), torch.cat(cells_)
    gd, gc = torch.cat(gd), torch.cat(gc)
    # slot: the parities of the cell's coordinates (those of its place in the brick)
    cib = cell % BRICK**3
    slot = ((cib >> 6) & 1) * 4 + ((cib >> 3) & 1) * 2 + (cib & 1)
    order = torch.argsort(k, stable=True)
    order = order[torch.argsort((ray * 8 + slot)[order], stable=True)]  # by ray and slot, each in step order
    key, cell, gd, gc = (ray * 8 + slot)[order], cell[order], gd[order], gc[order]
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = (key[1:] != key[:-1]) | (cell[1:] != cell[:-1])
    run = torch.cumsum(new.long(), 0) - 1
    F = int(new.sum())
    density = torch.zeros(F, device=gd.device).index_add_(0, run, gd)
    colour = torch.zeros(F, 3, device=gd.device).index_add_(0, run, gc)
    live_d = torch.zeros(F, dtype=torch.bool, device=gd.device).index_fill_(0, run[gd != 0], True)
    live_c = torch.zeros(F, dtype=torch.bool, device=gd.device).index_fill_(0, run[(gc != 0).any(-1)], True)
    # a row of N = 3B floats starting A floats past a 16-byte boundary:
    # head scalars to the boundary, float4s, tail scalars
    N = 3 * B
    head = torch.clamp((4 - (cell[new][live_c] * N) % 4) % 4, max=N)
    body = (N - head) // 4
    ops = head + body + (N - head - 4 * body)
    return dict(ray=key[new] // 8, cell=cell[new], density=density, colour=colour,
                adds=int(live_d.sum()) + N * int(live_c.sum()), add_ops=int(live_d.sum()) + int(ops.sum()),
                bricks=torch.unique(cell[new][live_d | live_c] // BRICK**3))


def touched_bricks(cells: torch.Tensor, brick_links: torch.Tensor, reso, pack: torch.Tensor, basis: torch.Tensor,
                   grad_rgb: torch.Tensor, s_total: torch.Tensor, *, tiles_per_call: int = 64,
                   **kw) -> torch.Tensor:
    """The plain version of the kernel's flags: int32 [nb + 1], 1 at the
    brick of each run that ``backward_flushes`` counts as adds (its
    density or colour sum nonzero), ``tiles_per_call`` tiles at a time (a
    run never leaves its ray). ``kw`` as ``backward_flushes``."""
    nb = cells.shape[0]
    flags = torch.zeros(nb + 1, dtype=torch.int32, device=pack.device)
    if "reach" not in kw:
        kw["reach"] = reachable_bricks(brick_links, reso)
    for i in range(0, pack.shape[0], tiles_per_call):
        f = backward_flushes(cells, brick_links, reso, pack[i:i + tiles_per_call], basis[i:i + tiles_per_call],
                             grad_rgb[i:i + tiles_per_call], s_total[i:i + tiles_per_call], **kw)
        flags[f["bricks"]] = 1
    return flags


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    F = ctypes.c_float
    args = [_VP] * 5 + [_LL] + [_INT] * 8 + [F, F, _INT, _INT]
    return load_library("tile_march_fwd", {
        "tile_march_fwd": (args + [_VP], _INT),
        "tile_march_fwd_probe": (args + [_INT, _VP], _INT),
        "tile_march_fwd_channels": ([_INT], _INT),
        "tile_march_fwd_error_string": ([_INT], ctypes.c_char_p),
    })


def _fwd_launch(cells, brick_links, reso, pack, basis, out, *, max_steps, color_mode="bias", sigma_thresh=1e-8,
                stop_thresh=1e-7, early_stop=False, probe=None) -> bool:
    """Check the inputs and launch ``tile_march_fwd`` into ``out`` [T, 8,
    r], or, with ``probe`` (0, 1, 2), ``tile_march_fwd_probe`` into
    ``out`` [T, r]. Returns whether a kernel was launched."""
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
    if T * r == 0:
        return False
    args = (cells.data_ptr(), brick_links.data_ptr(), pack.data_ptr(), basis.data_ptr(), out.data_ptr(), T * r, r,
            X, Y, Z, BY, BZ, B, int(max_steps), float(sigma_thresh), float(stop_thresh),
            int(color_mode == "sigmoid"), int(early_stop))
    with launch_stream(dev) as stream:
        if probe is None:
            rc = lib.tile_march_fwd(*args, stream)
        else:
            rc = lib.tile_march_fwd_probe(*args, int(probe), stream)
    if rc != 0:
        raise RuntimeError(f"tile_march_fwd launch failed: {lib.tile_march_fwd_error_string(rc).decode()}")
    return True


def tile_march_fwd(cells: torch.Tensor, brick_links: torch.Tensor, reso, pack: torch.Tensor,
                   basis: torch.Tensor, *, max_steps: int, color_mode: str = "bias",
                   sigma_thresh: float = 1e-8, stop_thresh: float = 1e-7, early_stop: bool = False):
    """Launch the CUDA march: cells bf16 [nb, 512, CP], brick_links int32
    [BX, BY, BZ], pack float32 [T, r, PACK], basis float32 [T, B] on one
    card -> out [T, 8, r] as ``march_reference``."""
    with span("k3.launch"):
        T, r, _ = pack.shape
        out = torch.empty((T, 8, r), dtype=torch.float32, device=pack.device)
        if _fwd_launch(cells, brick_links, reso, pack, basis, out, max_steps=max_steps, color_mode=color_mode,
                       sigma_thresh=sigma_thresh, stop_thresh=stop_thresh, early_stop=early_stop):
            tile_march_fwd.launches += 1
        return out


tile_march_fwd.launches = 0


def tile_march_fwd_probe(cells, brick_links, reso, pack, basis, *, mode: int, **kw) -> torch.Tensor:
    """The first port's per-sample march (8 link reads, 8 densities and 8
    SH lines a sample, no skip, rays in order) cut after its link reads
    (mode 0), after its densities (1) or whole (2) -> one float a ray [T,
    r]: to time where that design's time goes. Counts no launch."""
    sink = torch.empty(pack.shape[:2], dtype=torch.float32, device=pack.device)
    _fwd_launch(cells, brick_links, reso, pack, basis, sink, probe=mode, **kw)
    return sink


def march(cells, brick_links, reso, pack, basis, **kw):
    """The kernel for CUDA tensors, its plain version for host tensors."""
    if pack.device.type == "cuda":
        return tile_march_fwd(cells, brick_links, reso, pack, basis, **kw)
    return march_reference(cells, brick_links, reso, pack, basis, **kw)


@functools.lru_cache(maxsize=None)
def _bwd_library():
    F = ctypes.c_float
    args = [_VP] * 6 + [_VP, _VP, _VP, _LL] + [_INT] * 8 + [F, F, F, _INT, _VP]
    return load_library("tile_march_bwd", {
        "tile_march_bwd": (args, _INT),
        "tile_march_bwd_probe": (args[:6] + [_VP] + args[9:], _INT),
        "tile_march_bwd_channels": ([_INT], _INT),
        "tile_march_bwd_error_string": ([_INT], ctypes.c_char_p),
    })


def _bwd_launch(cells, brick_links, reso, pack, basis, grad_rgb, s_total, outs, *, max_steps, color_mode,
                sigma_thresh, stop_thresh, sparsity_scale, probe):
    """Check the inputs and launch ``tile_march_bwd`` into ``outs``
    (grad_density, grad_sh, touched or None), or, with ``probe``,
    ``tile_march_bwd_probe`` into ``outs`` (sink,)."""
    dev = pack.device
    if dev.type != "cuda":
        raise ValueError(f"tile_march_bwd runs on a CUDA device, got {dev}")
    T, r, _ = pack.shape
    B = basis.shape[-1]
    if B not in BASIS_DIMS:
        raise ValueError(f"tile_march_bwd takes basis_dim in {BASIS_DIMS}, got {B}")
    if color_mode not in ("bias", "sigmoid"):
        raise NotImplementedError(f"unknown color mode {color_mode!r}")
    lib = _bwd_library()
    nb = cells.shape[0]
    check_tensor(cells, "cells", torch.bfloat16, (nb, BRICK**3, lib.tile_march_bwd_channels(B)), dev)
    check_tensor(brick_links, "brick_links", torch.int32, tuple(brick_links.shape), dev)
    check_tensor(pack, "pack", torch.float32, (T, r, PACK), dev)
    check_tensor(basis, "basis", torch.float32, (T, B), dev)
    check_tensor(grad_rgb, "grad_rgb", torch.float32, (T, r, 3), dev)
    check_tensor(s_total, "s_total", torch.float32, (T, r), dev)
    BX, BY, BZ = brick_links.shape
    X, Y, Z = (int(v) for v in reso)
    if not (2 <= X <= BX * BRICK and 2 <= Y <= BY * BRICK and 2 <= Z <= BZ * BRICK):
        raise ValueError(f"reso {tuple(reso)} does not fit brick_links of shape {(BX, BY, BZ)}")
    if not probe and outs[1].data_ptr() % 16:
        raise ValueError("tile_march_bwd adds grad_sh's rows as float4s: grad_sh must be 16-byte aligned")
    if not probe and outs[2] is not None:
        check_tensor(outs[2], "touched", torch.int32, (nb + 1,), dev)
    if T * r == 0:
        return
    fn = lib.tile_march_bwd_probe if probe else lib.tile_march_bwd
    with launch_stream(dev) as stream:
        rc = fn(
            cells.data_ptr(), brick_links.data_ptr(), pack.data_ptr(), basis.data_ptr(), grad_rgb.data_ptr(),
            s_total.data_ptr(), *(None if o is None else o.data_ptr() for o in outs), T * r, r, X, Y, Z, BY, BZ, B,
            int(max_steps),
            float(sigma_thresh), float(stop_thresh), float(sparsity_scale), int(color_mode == "sigmoid"), stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_march_bwd launch failed: {lib.tile_march_bwd_error_string(rc).decode()}")


def tile_march_bwd(cells: torch.Tensor, brick_links: torch.Tensor, reso, pack: torch.Tensor,
                   basis: torch.Tensor, grad_rgb: torch.Tensor, s_total: torch.Tensor, *, max_steps: int,
                   color_mode: str = "bias", sigma_thresh: float = 1e-8, stop_thresh: float = 1e-7,
                   sparsity_scale: float = 0.0, flag_touched: bool = False):
    """Launch the CUDA backward: the inputs of ``tile_march_fwd`` plus
    grad_rgb float32 [T, r, 3] and s_total float32 [T, r] on one card ->
    (grad_density [nb, 512], grad_sh [nb, 512, 3B]) float32 as
    ``march_backward_reference``, and with ``flag_touched`` int32 flags
    [nb + 1], 1 at each brick a run adds into (``touched_bricks``' set).
    A ray's corner slot sums its gradient while its cell stays a corner
    and adds the run into the arrays with float32 atomics
    (``backward_flushes`` counts them): the order of the sums differs
    from the plain version's, and their last bits change from run to
    run."""
    nb, B = cells.shape[0], basis.shape[-1]
    grad_d = torch.zeros((nb, BRICK**3), dtype=torch.float32, device=pack.device)
    grad_sh = torch.zeros((nb, BRICK**3, 3 * B), dtype=torch.float32, device=pack.device)
    touched = torch.zeros(nb + 1, dtype=torch.int32, device=pack.device) if flag_touched else None
    _bwd_launch(cells, brick_links, reso, pack, basis, grad_rgb, s_total, (grad_d, grad_sh, touched),
                max_steps=max_steps, color_mode=color_mode, sigma_thresh=sigma_thresh,
                stop_thresh=stop_thresh, sparsity_scale=sparsity_scale, probe=False)
    if pack.shape[0] * pack.shape[1]:
        tile_march_bwd.launches += 1
    return (grad_d, grad_sh, touched) if flag_touched else (grad_d, grad_sh)


tile_march_bwd.launches = 0


def tile_march_bwd_probe(cells, brick_links, reso, pack, basis, grad_rgb, s_total, **kw) -> torch.Tensor:
    """The backward kernel with each global add summed into one float a
    ray instead -> [2, T, r]: those sums and the samples each ray visited
    (as ``kernel_visits`` counts them, up to the ray's first inactive
    sample without the sparsity loss): the same march, runs and arithmetic
    without the adds, to time what they cost. Counts no launch."""
    sink = torch.empty((2,) + tuple(pack.shape[:2]), dtype=torch.float32, device=pack.device)
    _bwd_launch(cells, brick_links, reso, pack, basis, grad_rgb, s_total, (sink,), probe=True, **kw)
    return sink


def march_backward(cells, brick_links, reso, pack, basis, grad_rgb, s_total, **kw):
    """The backward kernel for CUDA tensors, its plain version for host
    tensors."""
    if pack.device.type == "cuda":
        return tile_march_bwd(cells, brick_links, reso, pack, basis, grad_rgb, s_total, **kw)
    return march_backward_reference(cells, brick_links, reso, pack, basis, grad_rgb, s_total, **kw)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def march_inputs(bg: BrickGrid, rays: Rays, opts: GridRenderOptions, *, n_chunks: Optional[int] = None,
                 use_occupancy: bool = False, kernel_arrays: Optional[torch.Tensor] = None):
    """What the march and its backward read, as both entry points build
    it: (cells, pack, basis, max_steps). The march is n_chunks * SC steps
    long (default: the grid diagonal; with ``use_occupancy``, the active
    bricks' box); ``kernel_arrays``, prebuilt cells, or else
    ``build_kernel_arrays(bg)``."""
    if opts.color_mode not in ("bias", "sigmoid"):
        raise NotImplementedError(f"tile march: unknown color mode {opts.color_mode!r}")
    with span("march.pack"):
        if n_chunks:
            C = n_chunks
        elif use_occupancy:
            C = active_chunk_bound(bg, opts.step_size)
        else:
            C = default_chunks_for(bg, opts)
        pack, basis = pack_rays(bg, rays, opts, use_occupancy)
        cells = kernel_arrays if kernel_arrays is not None else build_kernel_arrays(bg)
        return cells, pack, basis, C * SC


def frame_outputs(out: torch.Tensor, pack: torch.Tensor, opts: GridRenderOptions, return_depth: bool) -> dict:
    """The march's [T, 8, r] block -> dict(rgb [T, r, 3], acc,
    log_transmit[, depth])."""
    acc = out[:, 3]
    result = {
        "rgb": out[:, 0:3].transpose(1, 2) + (1.0 - acc[..., None]) * opts.background_brightness,
        "acc": acc,
        "log_transmit": -out[:, 5],
    }
    if return_depth:
        result["depth"] = out[:, 4] * pack[..., 11]
    return result


def march_outputs(out: torch.Tensor, pack: torch.Tensor, opts: GridRenderOptions,
                  return_depth: bool) -> dict:
    """The march's [T, 8, r] block -> the render dict of
    ``render_tiles_pallas``: ``frame_outputs`` and the TPU plan's
    counters."""
    result = frame_outputs(out, pack, opts, False)
    result.update(sparsity_sum=out[:, 6], miss_per_ray=out[:, 7],
                  window_miss=out[:, 7].sum() / max(1, out.shape[0] * out.shape[-1]))
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
    cells, pack, basis, max_steps = march_inputs(bg, rays, opts, n_chunks=n_chunks, use_occupancy=use_occupancy,
                                                 kernel_arrays=kernel_arrays)
    out = march(
        cells, bg.brick_links, bg.reso, pack, basis, max_steps=max_steps, color_mode=opts.color_mode,
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


def loss_seeds(out: torch.Tensor, rgb_gt: torch.Tensor, opts: GridRenderOptions, beta_loss: float = 0.0):
    """From the march's [T, 8, r] block and the target [T, r, 3]: (rgb_out
    [T, r, 3], the MSE gradient g = 2 (rgb_out - gt) / (3N) [T, r, 3],
    the backward's suffix seed S_total = g . rgb_out [T, r], plus the beta
    term (beta / N) (1 - T / (1 - T + 1e-3)) when beta_loss > 0), N the
    rays of the batch (tile_march.py:2004-2016)."""
    acc = out[:, 3]
    rgb_out = out[:, 0:3].transpose(1, 2) + (1.0 - acc[..., None]) * opts.background_brightness
    n_rays = out.shape[0] * out.shape[2]
    g = 2.0 * (rgb_out - rgb_gt) / (3.0 * n_rays)
    s_total = torch.sum(g * rgb_out, dim=-1)
    if beta_loss > 0:
        t_fin = torch.exp(-out[:, 5])
        s_total = s_total + (beta_loss / n_rays) * (1.0 - t_fin / (1.0 - t_fin + 1e-3))
    return rgb_out, g.contiguous(), s_total.contiguous()


def _fused(bg, rays, rgb_gt, opts, *, beta_loss, sparsity_loss, n_chunks, use_occupancy, kernel_arrays,
           flag_touched):
    """K3, the loss seeds and K4: (rgb_out, K4's outputs, aux)."""
    cells, pack, basis, max_steps = march_inputs(bg, rays, opts, n_chunks=n_chunks, use_occupancy=use_occupancy,
                                                 kernel_arrays=kernel_arrays)
    kw = dict(max_steps=max_steps, color_mode=opts.color_mode, sigma_thresh=opts.sigma_thresh,
              stop_thresh=opts.stop_thresh)
    out = march(cells, bg.brick_links, bg.reso, pack, basis, **kw)
    rgb_out, g, s_total = loss_seeds(out, rgb_gt, opts, beta_loss)
    grads = march_backward(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                           sparsity_scale=float(sparsity_loss), flag_touched=flag_touched, **kw)
    aux = {
        "acc": out[:, 3],
        "log_transmit": -out[:, 5],
        "sparsity_sum": out[:, 6],
        "window_miss": torch.zeros((), dtype=torch.float32, device=pack.device),
        "dropped_active_chunks": torch.zeros((), dtype=torch.int32, device=pack.device),
    }
    return rgb_out, grads, aux


def render_fused_tiles_pallas(
    bg: BrickGrid,
    rays: Rays,
    rgb_gt: torch.Tensor,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    beta_loss: float = 0.0,
    sparsity_loss: float = 0.0,
    n_chunks: Optional[int] = None,
    use_occupancy: bool = False,
    grad_dtype=torch.float32,
    compact_chunks: Optional[int] = None,
    kernel_arrays: Optional[torch.Tensor] = None,
):
    """Fused render + gradient over [T, r] tiles, the reference's
    volume_render_fused (counterpart of ``render_fused_tiles_pallas``):
    (rgb_out [T, r, 3], grad_density [nb, 512], grad_sh [nb, 512, 3B],
    aux dict(acc, log_transmit, sparsity_sum, window_miss (0),
    dropped_active_chunks (0))).

    The march (K3) gives rgb_out; the MSE gradient g = 2 (rgb_out - gt) /
    (3N) and the suffix seed S_total = g . rgb_out, plus the beta term
    (beta / N) (1 - T / (1 - T + 1e-3)), are formed here; the backward
    (K4) re-marches and adds the gradients, with the Cauchy sparsity term
    ``sparsity_loss`` per sample, into the brick layout. ``grad_dtype``
    and ``compact_chunks`` are TPU knobs (the dtype of its gradient
    blocks, its chunk compaction), accepted and ignored: the gradients
    are float32 and no sample is dropped. ``kernel_arrays``: prebuilt
    cells (``build_kernel_arrays``, any dtype for the plain versions)."""
    del grad_dtype, compact_chunks
    rgb_out, (grad_density, grad_sh), aux = _fused(
        bg, rays, rgb_gt, opts, beta_loss=beta_loss, sparsity_loss=sparsity_loss, n_chunks=n_chunks,
        use_occupancy=use_occupancy, kernel_arrays=kernel_arrays, flag_touched=False)
    return rgb_out, grad_density, grad_sh, aux


def kernel_cells(kernel_arrays, n_bricks: int) -> torch.Tensor:
    """The cells [nb, 512, CP] the march reads, from prebuilt kernel
    arrays in any of the layouts the training states hold: cells [nb, 512,
    CP] or with the sentinel row [nb + 1, 512, CP] (a view of the first nb
    rows), or a (density [nb(+1), 512], sh [nb(+1), 512, 3B]) pair of
    masters (packed into new cells of their dtype)."""
    if isinstance(kernel_arrays, (tuple, list)):
        density, sh = (x[:n_bricks] for x in kernel_arrays)
        B = sh.shape[-1] // 3
        cells = sh.new_zeros((n_bricks, BRICK**3, channels(B)))
        cells[..., 0] = density.reshape(n_bricks, BRICK**3)
        cells[..., 1:1 + 3 * B] = sh
        return cells
    return kernel_arrays[:n_bricks]


def fused_grad_blocks(
    bg: BrickGrid,
    rays: Rays,
    rgb_gt: torch.Tensor,
    opts: GridRenderOptions = GridRenderOptions(),
    *,
    beta_loss: float = 0.0,
    sparsity_loss: float = 0.0,
    n_chunks: Optional[int] = None,
    use_occupancy: bool = False,
    kernel_arrays=None,
    grad_dtype=torch.float32,
    compact_chunks: Optional[int] = None,
    wps: int = 1,
    skip_empty: bool = False,
):
    """Fused render + gradient with the bricks it wrote (counterpart of
    ``fused_grad_blocks``): (rgb_out [T, r, 3], (grad_density [nb, 512],
    grad_sh [nb, 512, 3B]) float32, touched int32 [nb + 1] (1 at each
    brick K4 adds a gradient into; row nb, the training states' sentinel,
    is 0), aux dict(acc, log_transmit, sparsity_sum, window_miss (0),
    dropped_active_chunks (0))).

    The TPU's version returns per-(tile, window, corner) gradient blocks
    and their brick rows [T, C, 8], which the row-sparse steps reduce onto
    the bricks they touch. K4 already sums each run of a corner's samples
    on chip and adds it into brick arrays, so the port returns those
    arrays and the flags; a step gathers its touched rows from them. Any
    r rays a tile (the TPU's tiles hold 128 or 256).

    ``kernel_arrays``: prebuilt cells or masters (``kernel_cells``), or
    None to build bf16 cells from ``bg``. The TPU's schedule knobs
    change no result when nothing overflows, so they are accepted and
    ignored: ``grad_dtype`` (its gradient blocks' dtype; the port's
    gradients are float32), ``compact_chunks`` (its chunk compaction),
    ``wps`` (windows per grid step), ``skip_empty`` (its window skip; K3
    and K4 always skip empty bricks, with the same bits) and the layout of
    ``kernel_arrays``."""
    del grad_dtype, compact_chunks, wps, skip_empty
    cells = None if kernel_arrays is None else kernel_cells(kernel_arrays, bg.n_bricks)
    rgb_out, (grad_density, grad_sh, touched), aux = _fused(
        bg, rays, rgb_gt, opts, beta_loss=beta_loss, sparsity_loss=sparsity_loss, n_chunks=n_chunks,
        use_occupancy=use_occupancy, kernel_arrays=cells, flag_touched=True)
    return rgb_out, (grad_density, grad_sh), touched, aux
