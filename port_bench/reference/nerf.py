"""Plain PyTorch reference of vanilla NeRF (Mildenhall et al. 2020,
nerf/run_nerf_helpers.py and nerf/run_nerf.py): the positional encoding,
the 8x256 MLP with the skip into layer 5 and the 128-wide view layer,
stratified and inverse-CDF sampling, the compositing with the 1e10 tail,
the coarse + fine MSE and Adam.

Every matrix product takes ``dtype`` operands (the configuration's
bfloat16: weights and activations rounded to it) and sums in float32 with
TF32 off; everything else is float32. The control passes
``torch.float8_e4m3fn``. It imports nothing of the port: it takes the
benchmark's float32 weights (a dict of the ``nn.Linear`` tensors by
name), rays, targets and seeds, and works out the encodings, samples and
rounded weights itself.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import full_fp32


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back to float32 (the gradient passes
    straight through)."""
    if dtype == torch.float32:
        return x
    top = torch.finfo(dtype).max
    return x + (x.clamp(-top, top).to(dtype).float() - x).detach()


def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    out = [x]
    for k in range(n_freqs):
        out += [torch.sin(x * 2.0**k), torch.sin(x * 2.0**k + 0.5 * math.pi)]
    return torch.cat(out, dim=-1)


def linear(h: torch.Tensor, p: dict, name: str, dtype) -> torch.Tensor:
    return round_to(h, dtype) @ round_to(p[f"{name}.weight"], dtype).T + round_to(p[f"{name}.bias"], dtype)


def mlp(p: dict, x: torch.Tensor, v: torch.Tensor, depth: int, dtype):
    """Encoded points x [N, 63] and views v [N, 27] -> (rgb logits [N, 3],
    sigma logit [N])."""
    h = x
    for i in range(depth):
        h = torch.relu(linear(h, p, f"trunk.{i}", dtype))
        if i == 4:
            h = torch.cat([x, h], dim=-1)
    sigma = linear(h, p, "sigma_head", dtype)[:, 0]
    feat = linear(h, p, "bottleneck", dtype)
    hv = torch.relu(linear(torch.cat([feat, v], dim=-1), p, "view_0", dtype))
    return linear(hv, p, "rgb_head", dtype), sigma


def composite(rgb_logit, sigma_logit, z, dirs, white: bool):
    """(rgb [R, 3], acc [R], weights [R, S]) of samples at depths z [R, S]."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma_logit) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-10], dim=-1), dim=-1)
    w = alpha * trans
    rgb = (w[..., None] * torch.sigmoid(rgb_logit)).sum(-2)
    acc = w.sum(-1)
    if white:
        rgb = rgb + (1.0 - acc[:, None])
    return rgb, acc, w


def sample_pdf(bins, weights, n: int, u: torch.Tensor):
    """Inverse-CDF samples (nerf/run_nerf_helpers.py sample_pdf) at
    uniforms u [R, n] from bins [R, M] and weights [R, M - 1]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    k = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo, hi = (k - 1).clamp(min=0), k.clamp(max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    denom = c_hi - c_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return (b_lo + (u - c_lo) / denom * (b_hi - b_lo)).detach()


def level(p, o, d, vd, z, cfg, dtype):
    """One hierarchy level: (rgb, acc, weights) of samples at depths z."""
    R, S = z.shape
    pts = (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3)
    x = posenc(pts, cfg["multires"])
    v = posenc(vd, cfg["multires_views"]).repeat_interleave(S, dim=0)
    rgb_logit, sigma = mlp(p, x, v, cfg["netdepth"], dtype)
    return composite(rgb_logit.reshape(R, S, 3), sigma.reshape(R, S), z, d, cfg["white_bkgd"])


def render(coarse, fine, o, d, vd, cfg, dtype, u_coarse=None, u_fine=None):
    """Coarse then fine render of rays [R, 3] -> dict(rgb, acc, rgb0,
    last_weight) ; u_coarse [R, Nc] / u_fine [R, Nf] are the training
    draws (None: the deterministic serving path)."""
    R, Nc, Nf = o.shape[0], cfg["N_samples"], cfg["N_importance"]
    t = torch.linspace(0.0, 1.0, Nc, device=o.device)
    z = (cfg["near"] * (1.0 - t) + cfg["far"] * t).expand(R, Nc)
    if u_coarse is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper, lower = torch.cat([mids, z[:, -1:]], -1), torch.cat([z[:, :1], mids], -1)
        z = lower + (upper - lower) * u_coarse
    rgb0, _, w0 = level(coarse, o, d, vd, z, cfg, dtype)
    u = u_fine if u_fine is not None else torch.linspace(0.0, 1.0, Nf, device=o.device).expand(R, Nf)
    zs = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w0[:, 1:-1].detach(), Nf, u)
    zf = torch.sort(torch.cat([z, zs], dim=-1), dim=-1).values
    rgb, acc, w = level(fine, o, d, vd, zf, cfg, dtype)
    return {"rgb": rgb, "acc": acc, "rgb0": rgb0, "last_weight": w[:, -1]}


def render_rays(coarse, fine, o, d, vd, cfg, dtype=torch.bfloat16, block: int = 4096) -> dict:
    """The serving render of rays [R, 3] in blocks of ``block`` rays."""
    outs = []
    with torch.no_grad(), full_fp32():
        for i in range(0, o.shape[0], block):
            outs.append(render(coarse, fine, o[i:i + block], d[i:i + block], vd[i:i + block], cfg, dtype))
    return {k: torch.cat([x[k] for x in outs]) for k in outs[0]}


def loss_and_grads(coarse, fine, o, d, vd, target, u_coarse, u_fine, cfg, dtype):
    """(MSE(fine) + MSE(coarse), dict of gradients by "coarse."/"fine." +
    parameter name) of one training batch."""
    leaves = {f"coarse.{k}": v for k, v in coarse.items()} | {f"fine.{k}": v for k, v in fine.items()}
    for v in leaves.values():
        v.requires_grad_(True)
    with full_fp32():
        out = render(coarse, fine, o, d, vd, cfg, dtype, u_coarse, u_fine)
        loss = F.mse_loss(out["rgb"], target) + F.mse_loss(out["rgb0"], target)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    for v in leaves.values():
        v.requires_grad_(False)
    return float(loss.detach()), dict(zip(leaves, grads))


class Adam:
    """Adam (b1 0.9, b2 0.999) with the learning rate of update k
    lr0 * 0.1^(k / (decay * 1000)), over a dict of float32 leaves."""

    def __init__(self, leaves: dict, lr0: float, decay: float, eps: float):
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.lr0, self.decay, self.eps, self.t = lr0, decay, eps, 0

    @torch.no_grad()
    def step(self, leaves: dict, grads: dict) -> None:
        lr = self.lr0 * 0.1 ** (self.t / (self.decay * 1000.0))
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, p in leaves.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[k] / (1.0 - b1**self.t)
            v_hat = self.v[k] / (1.0 - b2**self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + self.eps))
