"""Sampled TV gradients over BrickGrid storage (port of
``nerf_projects_tpu/ops/tv_bricks.py``).

The regularizer of the reference's tv_grad_sparse_kernel
(loss_kernel.cu:180-248) in the brick-major layout: a contiguous window
of brick rows is sampled (tv_sparsity as a fraction of bricks ~= a
fraction of cells), all 512 cells of each sampled brick get the per-cell
TV gradient, and the cross-brick face terms come from the +x/+y/+z
neighbour bricks' first planes. The per-cell gradient is the
reference's, with its per-coefficient norm and reso/256 axis scaling.

Sampling deviation (the JAX package's, kept): the reference samples
cells uniformly over the whole dense grid; sampling bricks skips cells
of fully empty bricks, so an active cell facing a fully empty brick
misses that one inward boundary term.
"""
from __future__ import annotations

from typing import Callable

import torch

from nerf_projects_tpu_torch.ops.brick_grid import BRICK, BrickGrid


def sample_brick_window(generator: torch.Generator, n_bricks: int, window: int) -> torch.Tensor:
    """Contiguous brick-row window with wraparound (svox2.py:2230-2237 at
    brick granularity), int32 [window] on the generator's device: the
    start is drawn there, so a generator on the card waits for nothing."""
    dev = generator.device
    start = torch.randint(0, n_bricks, (), generator=generator, device=dev)
    return ((start + torch.arange(window, device=dev)) % n_bricks).to(torch.int32)


def _neighbor_rows(bg: BrickGrid, rows: torch.Tensor, axis: int) -> torch.Tensor:
    """Brick row of the +axis neighbour of each sampled brick (-1 = none)."""
    n = bg.bricks_shape
    shifted = bg.brick_coords[rows.long()].long()  # [w, 3]
    shifted[:, axis] += 1
    oob = shifted[:, axis] >= n[axis]
    safe = [torch.clamp(shifted[:, a], 0, n[a] - 1) for a in range(3)]
    nbr = bg.brick_links[safe[0], safe[1], safe[2]]
    return torch.where(oob, -1, nbr).to(torch.int32)


def tv_grad_brick_blocks(bg: BrickGrid, fetch: Callable[[torch.Tensor], torch.Tensor], rows: torch.Tensor, *,
                         scale: float, ignore_edge: bool):
    """Block form of ``tv_grad_bricks``: (rows4 [4w], vals4 [4w, 512, C]),
    rows4 -1 where there is no neighbour (its vals are zero). Rows repeat;
    contributions add.

    fetch: brick rows int64 [n] -> their data [n, 512, C] (``x.__getitem__``
    of a [nb, 512, C] tensor; the window's rows and their neighbours are
    all it reads). rows: sampled brick rows [w]. ignore_edge as the
    reference's flag (False for density, True for SH: differences to
    empty neighbours are zeroed)."""
    w = rows.shape[0]
    B = BRICK

    def brick_vals(r):
        r = r.long()
        safe = torch.clamp(r, min=0)
        vals = fetch(safe)
        C = vals.shape[-1]
        vals = torch.where((r >= 0)[:, None, None], vals, 0.0)
        mask = (r >= 0)[:, None] & bg.cell_mask[safe]
        return vals.reshape(w, B, B, B, C), mask.reshape(w, B, B, B)

    v, m = brick_vals(rows)
    C = v.shape[-1]
    nxr, nyr, nzr = (_neighbor_rows(bg, rows, a) for a in range(3))
    vx, mx = brick_vals(nxr)
    vy, my = brick_vals(nyr)
    vz, mz = brick_vals(nzr)

    # +axis neighbour values and masks for every cell of the base brick
    v_px = torch.cat([v[:, 1:], vx[:, :1]], dim=1)
    m_px = torch.cat([m[:, 1:], mx[:, :1]], dim=1)
    v_py = torch.cat([v[:, :, 1:], vy[:, :, :1]], dim=2)
    m_py = torch.cat([m[:, :, 1:], my[:, :, :1]], dim=2)
    v_pz = torch.cat([v[:, :, :, 1:], vz[:, :, :, :1]], dim=3)
    m_pz = torch.cat([m[:, :, :, 1:], mz[:, :, :, :1]], dim=3)

    if ignore_edge:
        dx = torch.where(m_px[..., None], v_px - v, 0.0)
        dy = torch.where(m_py[..., None], v_py - v, 0.0)
        dz = torch.where(m_pz[..., None], v_pz - v, 0.0)
    else:
        dx, dy, dz = v_px - v, v_py - v, v_pz - v

    # per-coefficient norm; the scale is a mean over the sampled cells
    # (loss_kernel.cu:595 `scale / nl`)
    idelta = (scale / (w * B * B * B)) * torch.rsqrt(1e-9 + dx * dx + dy * dy + dz * dz)
    X, Y, Z = bg.reso
    gx = dx * (X / 256.0) * idelta
    gy = dy * (Y / 256.0) * idelta
    gz = dz * (Z / 256.0) * idelta

    # the base side uses the unmasked differences, gated on the base cell
    # being active; the neighbour sides are gated on the receiving cell
    g_base = -(gx + gy + gz) * m[..., None]
    gx = gx * m_px[..., None]
    gy = gy * m_py[..., None]
    gz = gz * m_pz[..., None]

    local = g_base.clone()
    local[:, 1:] += gx[:, :-1]
    local[:, :, 1:] += gy[:, :, :-1]
    local[:, :, :, 1:] += gz[:, :, :, :-1]

    # cross-brick faces: the last plane of g goes to the neighbour's first
    def face_brick(plane, axis):
        buf = torch.zeros((w, B, B, B, C), dtype=v.dtype, device=v.device)
        buf.select(axis + 1, 0).copy_(plane)
        return buf

    rows4 = torch.cat([rows.to(torch.int32), nxr, nyr, nzr])
    vals4 = torch.cat([
        local.reshape(w, B**3, C),
        face_brick(gx[:, -1], 0).reshape(w, B**3, C),
        face_brick(gy[:, :, -1], 1).reshape(w, B**3, C),
        face_brick(gz[:, :, :, -1], 2).reshape(w, B**3, C),
    ])
    vals4 = torch.where((rows4 >= 0)[:, None, None], vals4, 0.0)
    return rows4, vals4


def tv_grad_bricks(bg: BrickGrid, data: torch.Tensor, rows: torch.Tensor, *, scale: float,
                   ignore_edge: bool) -> torch.Tensor:
    """The TV gradient, scatter-added into zeros_like(data); see
    ``tv_grad_brick_blocks`` for the arguments."""
    squeeze = data.dim() == 2
    rows4, vals4 = tv_grad_brick_blocks(bg, (data[..., None] if squeeze else data).__getitem__, rows, scale=scale,
                                        ignore_edge=ignore_edge)
    grad = torch.zeros(data.shape + ((1,) if squeeze else ()), dtype=data.dtype, device=data.device)
    grad.index_add_(0, torch.clamp(rows4, min=0).long(), vals4)
    return grad[..., 0] if squeeze else grad
