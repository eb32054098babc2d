"""Plain PyTorch reference of the Plenoxels march, its gradient and the
per-visit RMSprop sweep, in float32 with TF32 off.

A frozen copy of the arithmetic of the port's plain versions
(``ops/kernels/tile_march.py``: ``pack_rays``, ``march_reference``,
``_backward_terms``, ``loss_seeds``; ``ops/grid.py::ray_grid_geometry``;
``ops/sh.py::eval_sh_bases``; ``train/plenoxels_sparse.py``'s dense
sweep; ``train/schedules.py::log_linear_decay``), which follow svox2's
cuvol march (svox2/csrc/render_lerp_kernel_cuvol.cu) with the port's one
departure kept: every ray of a tile steps from the tile's least entry
distance T0, so sample positions line up across the tile. It imports
nothing of the port and takes only the benchmark's inputs: the brick
links and the cell array, the cameras' rays and the targets. The march's
packing, the tile basis and the learning rates are worked out here again.

``dtype`` is the precision of the per-sample arithmetic (trilinear
weights and values, the colour decode, the optical depth and the
compositing); ray geometry stays float32. The benchmark runs float32;
the control runs bfloat16.
"""
from __future__ import annotations

import math

import torch

from port_bench.reference import full_fp32

PACK = 12
SC = 16
BIG = 1e30
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
CORNERS = [(cx, cy, cz) for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)]


def max_steps(reso: int, step_size: float) -> int:
    """The march's length in steps: chunks of SC steps covering the grid
    diagonal."""
    diag = math.sqrt(3.0) * reso
    total = int(math.ceil(diag / step_size)) + 1
    return -(-total // SC) * SC


def sh_basis(basis_dim: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis [..., B] at unit directions, B in (1, 4, 9)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, SH_C0)]
    if basis_dim > 1:
        comps += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if basis_dim > 4:
        xx, yy, zz = x * x, y * y, z * z
        comps += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if basis_dim not in (1, 4, 9):
        raise ValueError(f"basis_dim {basis_dim} is not 1, 4 or 9")
    return torch.stack(comps, dim=-1)


def pack_tiles(origins: torch.Tensor, dirs: torch.Tensor, reso: int, radius: float, step_size: float):
    """World rays [T, r, 3] of a grid of reso^3 over [-radius, radius]^3 ->
    (pack [T, r, PACK] float32, tile basis input: the tiles' mean unit
    view direction [T, 3]). The pack holds the grid-space origin and
    direction, dt, [t0, t1) clipped to [0, reso - 1], the tile's T0, the
    world length of a step and |d|."""
    half = reso * 0.5
    og = origins / radius * half + (half - 0.5)
    dg = dirs * (half / radius)
    world_len = torch.linalg.norm(dirs, dim=-1)
    dt = step_size / torch.clamp(torch.linalg.norm(dg, dim=-1), min=1e-12)
    step_world = dt * world_len
    inv = 1.0 / torch.where(dg.abs() < 1e-12, torch.full_like(dg, 1e-12), dg)
    t_lo, t_hi = (0.0 - og) * inv, (reso - 1.0 - og) * inv
    t0 = torch.minimum(t_lo, t_hi).amax(-1)
    t1 = torch.maximum(t_lo, t_hi).amin(-1)
    t0 = torch.clamp(t0, min=0.0)
    hit = t1 > t0
    T0 = torch.where(hit, t0, BIG).amin(-1)
    T0 = torch.where(T0 < BIG, T0, 0.0)
    pack = torch.cat([og, dg, dt[..., None], torch.where(hit, t0, BIG)[..., None],
                      torch.where(hit, t1, -BIG)[..., None], T0[:, None, None].expand(t0.shape + (1,)),
                      step_world[..., None], world_len[..., None]], dim=-1).float().contiguous()
    vmean = dirs.mean(dim=1)
    vmean = vmean / torch.clamp(torch.linalg.norm(vmean, dim=-1, keepdim=True), min=1e-12)
    return pack, vmean


def _step_span(p: torch.Tensor, n_steps: int):
    dt, t0, t1, T0 = p[:, 6], p[:, 7], p[:, 8], p[:, 9]
    hit = t1 > t0
    lo = torch.where(hit, torch.floor((t0 - T0) / dt) - 2.0, float(n_steps)).clamp(0, n_steps)
    hi = torch.where(hit, torch.ceil((t1 - T0) / dt) + 2.0, 0.0).clamp(0, n_steps)
    return int(lo.amin()), int(hi.amax())


def _corners(links: torch.Tensor, reso: int, pos: torch.Tensor):
    """(brick row or -1, cell in the brick, trilinear weight) of the 8
    corners around grid positions [..., 3], the lower corner clamped to
    [0, reso - 2] and the weights to [0, 1]."""
    lo = torch.clamp(torch.floor(pos).long(), min=0, max=reso - 2)
    w = torch.clamp(pos - lo.to(pos.dtype), 0.0, 1.0)
    for cx, cy, cz in CORNERS:
        c = lo + torch.tensor((cx, cy, cz), device=pos.device)
        row = links[c[..., 0] >> 3, c[..., 1] >> 3, c[..., 2] >> 3].long()
        o = c & 7
        wt = ((w[..., 0] if cx else 1 - w[..., 0]) * (w[..., 1] if cy else 1 - w[..., 1])
              * (w[..., 2] if cz else 1 - w[..., 2]))
        yield row, o[..., 0] * 64 + o[..., 1] * 8 + o[..., 2], wt


def _trilerp(cells, links, reso, pos, n_ch: int, dtype):
    out = None
    for row, cell, wt in _corners(links, reso, pos):
        vals = torch.where((row >= 0)[..., None], cells[row.clamp(min=0), cell, :n_ch].to(dtype), 0.0)
        term = wt.to(dtype)[..., None] * vals
        out = term if out is None else out + term
    return out


def reachable(links: torch.Tensor, reso: int) -> torch.Tensor:
    """Bricks from whose cells a sample's corners can read data: one of
    b + {0, 1}^3 occupied, indices clamped to the grid's last brick."""
    occ = links >= 0
    steps = []
    for n in occ.shape:
        i = torch.arange(n, device=occ.device)
        steps.append((i, torch.clamp(i + 1, max=(reso - 1) >> 3)))
    reach = torch.zeros_like(occ)
    for cx, cy, cz in CORNERS:
        reach |= occ[steps[0][cx]][:, steps[1][cy]][:, :, steps[2][cz]]
    return reach


@torch.no_grad()
@full_fp32()
def march(cells, links, reso: int, pack, basis, n_steps: int, *, sigma_thresh=1e-8, stop_thresh=1e-7,
          dtype=torch.float32, slice_steps: int = 32):
    """The forward march of [T, r] ray tiles -> (rgb [T, r, 3] before the
    background, acc [T, r], -log transmittance [T, r]) in float32."""
    T, r, _ = pack.shape
    B = basis.shape[-1]
    p = pack.reshape(T * r, PACK)
    og, dg, dt, t0, t1, T0, sw = p[:, 0:3], p[:, 3:6], p[:, 6], p[:, 7], p[:, 8], p[:, 9], p[:, 10]
    bas = basis.to(dtype).repeat_interleave(r, dim=0)
    N = T * r
    cum = torch.zeros(N, device=p.device, dtype=dtype)
    acc = torch.zeros(N, device=p.device, dtype=dtype)
    rgb_acc = torch.zeros(N, 3, device=p.device, dtype=dtype)
    k_start, k_end = _step_span(p, n_steps)
    for k0 in range(k_start, k_end, slice_steps):
        ks = torch.arange(k0, min(k0 + slice_steps, k_end), dtype=torch.float32, device=p.device)
        tt = T0[:, None] + ks[None, :] * dt[:, None]
        valid = (tt >= t0[:, None]) & (tt < t1[:, None])
        pos = og[:, None, :] + tt[..., None] * dg[:, None, :]
        vals = _trilerp(cells, links, reso, pos, 1 + 3 * B, dtype)
        sigma = torch.where(valid & (vals[..., 0] > sigma_thresh), vals[..., 0], 0.0)
        raw = torch.sum(vals[..., 1:].reshape(N, -1, 3, B) * bas[:, None, None, :], dim=-1)
        rgb = torch.clamp(raw + 0.5, min=0.0)
        tau = sigma * sw[:, None].to(dtype)
        prefix = cum[:, None] + torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        Tp = torch.exp(-prefix)
        active = Tp > stop_thresh
        w = torch.where(active, Tp * (1.0 - torch.exp(-tau)), 0.0)
        rgb_acc += torch.einsum("ns,nsc->nc", w, rgb)
        acc += w.sum(-1)
        cum += torch.where(active, tau, 0.0).sum(-1)
    return (rgb_acc.float().reshape(T, r, 3), acc.float().reshape(T, r), cum.float().reshape(T, r))


@torch.no_grad()
def march_counts(cells, links, reso: int, pack, n_steps: int, *, early_stop: bool, touched: torch.Tensor,
                 reach=None, sigma_thresh=1e-8, stop_thresh=1e-7, slice_steps: int = 64) -> dict:
    """The work of a march on these inputs, from the density alone: the
    samples marched (``live``: valid, and active under early stop), those
    whose lower corner lies in a reachable brick (``reach``), the runs of
    live samples in one unreachable brick (``brick_steps``), the samples
    shaded (valid, active, density above the threshold), the live ones
    with density above it (``dense``); the bricks their corners read are
    set in ``touched`` (bool [nb + 1], the last slot a sink), so that
    calls over parts of one march count each brick once."""
    T, r, _ = pack.shape
    p = pack.reshape(T * r, PACK)
    og, dg, dt, t0, t1, T0, sw = p[:, 0:3], p[:, 3:6], p[:, 6], p[:, 7], p[:, 8], p[:, 9], p[:, 10]
    N, dev = T * r, p.device
    reach = reachable(links, reso) if reach is None else reach
    nb = cells.shape[0]
    out = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in ("marched", "reach", "brick_steps", "shaded",
                                                                       "dense")}
    cum = torch.zeros(N, device=dev)
    prev = torch.full((N,), -1, dtype=torch.int64, device=dev)
    k_start, k_end = _step_span(p, n_steps)
    for k0 in range(k_start, k_end, slice_steps):
        ks = torch.arange(k0, min(k0 + slice_steps, k_end), dtype=torch.float32, device=dev)
        tt = T0[:, None] + ks[None, :] * dt[:, None]
        valid = (tt >= t0[:, None]) & (tt < t1[:, None])
        pos = og[:, None, :] + tt[..., None] * dg[:, None, :]
        dens = _trilerp(cells, links, reso, pos, 1, torch.float32)[..., 0]
        sigma = torch.where(valid & (dens > sigma_thresh), dens, 0.0)
        tau = sigma * sw[:, None]
        prefix = cum[:, None] + torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        active = torch.exp(-prefix) > stop_thresh
        cum += torch.where(active, tau, 0.0).sum(-1)
        live = valid & active if early_stop else valid
        b = torch.clamp(torch.floor(pos).long(), min=0, max=reso - 2) >> 3
        ok = reach[b[..., 0], b[..., 1], b[..., 2]]
        out["marched"] += live.sum()
        out["reach"] += (live & ok).sum()
        out["shaded"] += (valid & active & (sigma > 0)).sum()
        out["dense"] += (live & (sigma > 0)).sum()
        bid = torch.where(live & ~ok, (b[..., 0] * reach.shape[1] + b[..., 1]) * reach.shape[2] + b[..., 2], -1)
        before = torch.cat([prev[:, None], bid[:, :-1]], dim=-1)
        out["brick_steps"] += ((bid >= 0) & (bid != before)).sum()
        prev = bid[:, -1]
        for row, _, _ in _corners(links, reso, pos):
            touched.index_fill_(0, torch.where(live & (row >= 0), row, nb).reshape(-1), True)
    return {k: int(v) for k, v in out.items()}


def loss_seeds(rgb: torch.Tensor, gt: torch.Tensor):
    """The MSE's gradient at the rendered colours g = 2 (rgb - gt) / (3N)
    and the suffix seed S = g . rgb, N the batch's rays."""
    n = rgb.shape[0] * rgb.shape[1]
    g = 2.0 * (rgb - gt) / (3.0 * n)
    return g, (g * rgb).sum(-1)


@torch.no_grad()
@full_fp32()
def march_grads(cells, links, reso: int, pack, basis, g, s_total, n_steps: int, *, sigma_thresh=1e-8,
                stop_thresh=1e-7, dtype=torch.float32, slice_steps: int = 32):
    """The gradients of the loss whose seeds are (g [T, r, 3], s_total [T,
    r]) with respect to the cells' density [nb, 512] and SH [nb, 512, 3B]:
    on a sample with density above the threshold, dL/dtau = T e^-tau (c .
    g) - (S - inclusive prefix of w (c . g)) while the ray is active,
    g_sigma = dL/dtau * step_world, g_rgb = w g (raw + 0.5 > 0); each
    corner takes its trilinear weight's share."""
    T, r, _ = pack.shape
    B = basis.shape[-1]
    nb = cells.shape[0]
    p = pack.reshape(T * r, PACK)
    og, dg, dt, t0, t1, T0, sw = p[:, 0:3], p[:, 3:6], p[:, 6], p[:, 7], p[:, 8], p[:, 9], p[:, 10]
    N, dev = T * r, p.device
    bas = basis.to(dtype).repeat_interleave(r, dim=0)
    gg = g.reshape(N, 3).to(dtype)
    S = s_total.reshape(N).to(dtype)
    grad_d = torch.zeros(nb * 512, device=dev)
    grad_sh = torch.zeros(nb * 512, 3 * B, device=dev)
    cum = torch.zeros(N, device=dev, dtype=dtype)
    P = torch.zeros(N, device=dev, dtype=dtype)
    k_start, k_end = _step_span(p, n_steps)
    for k0 in range(k_start, k_end, slice_steps):
        ks = torch.arange(k0, min(k0 + slice_steps, k_end), dtype=torch.float32, device=dev)
        tt = T0[:, None] + ks[None, :] * dt[:, None]
        valid = (tt >= t0[:, None]) & (tt < t1[:, None])
        pos = og[:, None, :] + tt[..., None] * dg[:, None, :]
        vals = _trilerp(cells, links, reso, pos, 1 + 3 * B, dtype)
        sig_pos = valid & (vals[..., 0] > sigma_thresh)
        sigma = torch.where(sig_pos, vals[..., 0], 0.0)
        raw = torch.sum(vals[..., 1:].reshape(N, -1, 3, B) * bas[:, None, None, :], dim=-1)
        rgb = torch.clamp(raw + 0.5, min=0.0)
        gate = (raw + 0.5 > 0.0).to(dtype)
        tau = sigma * sw[:, None].to(dtype)
        prefix = cum[:, None] + torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        Tp = torch.exp(-prefix)
        active = Tp > stop_thresh
        e = torch.exp(-tau)
        w = torch.where(active, Tp * (1.0 - e), 0.0)
        cdotg = torch.sum(rgb * gg[:, None, :], dim=-1)
        P_in = P[:, None] + torch.cumsum(w * cdotg, dim=-1)
        gtau = Tp * e * cdotg - (S[:, None] - P_in)
        gsig = torch.where(active & sig_pos, gtau * sw[:, None].to(dtype), 0.0)
        g_rgb = w[..., None] * gg[:, None, :] * gate
        cum += torch.where(active, tau, 0.0).sum(-1)
        P = P_in[:, -1]
        for row, cell, wt in _corners(links, reso, pos):
            ok = valid & (row >= 0)
            idx = (row.clamp(min=0) * 512 + cell).reshape(-1)
            wt = wt.to(dtype)
            grad_d.index_add_(0, idx, torch.where(ok, wt * gsig, 0.0).reshape(-1).float())
            gsh = (wt[..., None] * g_rgb)[..., None] * bas[:, None, None, :]
            grad_sh.index_add_(0, idx, torch.where(ok[..., None, None], gsh, 0.0).reshape(-1, 3 * B).float())
    return grad_d.reshape(nb, 512), grad_sh.reshape(nb, 512, 3 * B)


def log_linear(lr_init: float, lr_final: float, max_steps: int, delay_steps: int = 0, delay_mult: float = 1.0):
    """svox2's get_expon_lr_func: exp(lerp(log lr_init, log lr_final,
    step / max_steps)) times a half-cosine ramp from delay_mult to 1 over
    delay_steps."""
    def lr(step: int) -> float:
        t = min(max(step / max_steps, 0.0), 1.0)
        base = math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
        if delay_steps > 0:
            ramp = math.sin(0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
            return (delay_mult + (1.0 - delay_mult) * ramp) * base
        return base
    return lr


@torch.no_grad()
def rmsprop_pervisit(data, grad, rms, lr, beta: float, eps: float = 1e-8):
    """Per-visit RMSprop on the elements with a gradient; the others keep
    their value and their rms: (new data, new rms)."""
    touched = grad != 0.0
    rms_new = torch.where(rms == 0.0, grad * grad, beta * rms + (1.0 - beta) * grad * grad)
    rms_new = torch.where(touched, rms_new, rms)
    new = data - lr * grad / (torch.sqrt(rms_new) + eps)
    return torch.where(touched, new, data), rms_new
