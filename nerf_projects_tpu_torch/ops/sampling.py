"""Ray sampling: stratified coarse samples and inverse-CDF importance
samples (port of ``nerf_projects_tpu/ops/sampling.py``).

The inverse CDF brackets each u with ``torch.searchsorted(right=True)``
and clamps the edges to the first and last bin, which is what the
reference package's masked min/max over ``u >= cdf`` computes.
Randomness comes from an explicit ``torch.Generator`` on the tensors'
device.
"""
from __future__ import annotations

from typing import Optional

import torch

from nerf_projects_tpu_torch.core.device import device_constant


def cast_rays(z_vals: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor):
    """Points o + z*d: [..., N] x [..., 3] -> [..., N, 3]."""
    return origins[..., None, :] + z_vals[..., None] * directions[..., None, :]


def _uniform(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def stratified_sample(
    generator: Optional[torch.Generator],
    num_samples: int,
    near,
    far,
    batch_shape,
    *,
    lindisp: bool = False,
    randomized: bool = True,
    dtype=torch.float32,
    device=None,
):
    """Stratified depths in [near, far], shaped batch_shape + [num_samples].

    near/far are scalars or tensors broadcastable to batch_shape.
    """
    if torch.is_tensor(near):
        device = near.device
    device = torch.device("cpu") if device is None else torch.device(device)
    t_vals = torch.linspace(0.0, 1.0, num_samples, dtype=dtype, device=device)
    # scalars come from device_constant: a copy of host numbers to the
    # card waits for its queue
    near = near.to(device=device, dtype=dtype) if torch.is_tensor(near) else device_constant(near, dtype, device)
    far = far.to(device=device, dtype=dtype) if torch.is_tensor(far) else device_constant(far, dtype, device)
    if near.ndim:
        near = near[..., None]
    if far.ndim:
        far = far[..., None]
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    z_vals = z_vals.expand(tuple(batch_shape) + (num_samples,))

    if randomized:
        if generator is None:
            raise ValueError("randomized stratified sampling requires a generator")
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = _uniform(generator, z_vals.shape, dtype, device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sorted_uniform(generator: torch.Generator, shape, dtype=torch.float32, device=None):
    """IID Uniform(0,1) order statistics, drawn already sorted along the
    last axis (exponential spacings: U_(i) = (E_1+..+E_i)/(E_1+..+E_{n+1}))."""
    n = shape[-1]
    e = -torch.log1p(-_uniform(generator, tuple(shape[:-1]) + (n + 1,), dtype, device))
    cs = torch.cumsum(e, dim=-1)
    return cs[..., :n] / cs[..., -1:]


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two per-row sorted arrays along the last axis (ties: `a`
    first), by rank counts and two scatters. [..., Sa], [..., Sb] ->
    [..., Sa+Sb]."""
    Sa, Sb = a.shape[-1], b.shape[-1]
    ia = torch.arange(Sa, device=a.device) + (b[..., None, :] < a[..., :, None]).sum(-1)
    ib = torch.arange(Sb, device=a.device) + (a[..., None, :] <= b[..., :, None]).sum(-1)
    out = a.new_zeros(a.shape[:-1] + (Sa + Sb,))
    out.scatter_(-1, ia, a)
    out.scatter_(-1, ib, b)
    return out


def _invert_cdf(u: torch.Tensor, cdf: torch.Tensor, bins: torch.Tensor):
    """Bracketing interval of each u in the sorted cdf: [..., N] u,
    [..., M] cdf and bins -> (bins_lo, bins_hi, cdf_lo, cdf_hi), each
    [..., N]. k = searchsorted "right" (the count of cdf <= u); the low
    edge is entry k-1 and the high edge entry k, clamped to the first and
    last bin, as the reference's masked min/max over u >= cdf gives."""
    k = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = (k - 1).clamp_(min=0)
    hi = k.clamp_(max=cdf.shape[-1] - 1)
    return (bins.gather(-1, lo), bins.gather(-1, hi), cdf.gather(-1, lo), cdf.gather(-1, hi))


def piecewise_constant_pdf(
    generator: Optional[torch.Generator],
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    *,
    randomized: bool = True,
    mode: str = "nerf",
    sorted_u: bool = False,
    u: Optional[torch.Tensor] = None,
):
    """Importance samples from the piecewise-constant PDF over `bins`.

    mode="nerf" (reference nerf_helpers.py:372-439): bins [..., M],
    weights [..., M-1]; weights += 1e-5; cdf = [0, cumsum(pdf)];
    denominators below 1e-5 become 1.
    mode="jaxnerf" (model_utils.py:225-287): the weight sum padded to
    1e-5; cdf = [0, min(1, cumsum(pdf[:-1])), 1]; deterministic u in
    [0, 1 - eps]; t through nan_to_num and clip to [0, 1].
    Returns [..., num_samples], detached from the graph.

    ``u`` overrides the uniforms (shape [..., num_samples]); otherwise
    they are linspace(0, 1) (jaxnerf: to 1 - eps) when not randomized,
    else drawn from ``generator`` (as order statistics when ``sorted_u``).
    """
    if mode == "nerf":
        weights = weights + 1e-5
        pdf = weights / weights.sum(-1, keepdim=True)
        cdf = torch.cumsum(pdf, dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
        u_max = 1.0
    elif mode == "jaxnerf":
        eps = 1e-5
        weight_sum = weights.sum(-1, keepdim=True)
        padding = torch.clamp(eps - weight_sum, min=0.0)
        weights = weights + padding / weights.shape[-1]
        pdf = weights / (weight_sum + padding)
        cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)
        u_max = 1.0 - torch.finfo(torch.float32).eps
    else:
        raise ValueError(f"unsupported sample_pdf mode: {mode!r}")
    shape = cdf.shape[:-1] + (num_samples,)
    if u is None:
        if randomized:
            if generator is None:
                raise ValueError("randomized pdf sampling requires a generator")
            draw = sorted_uniform if sorted_u else _uniform
            u = draw(generator, shape, cdf.dtype, cdf.device)
        else:
            u = torch.linspace(0.0, u_max, num_samples, dtype=cdf.dtype, device=cdf.device)
            u = u.expand(shape)
    bins_lo, bins_hi, cdf_lo, cdf_hi = _invert_cdf(u, cdf, bins)
    if mode == "nerf":
        denom = cdf_hi - cdf_lo
        denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
        t = (u - cdf_lo) / denom
    else:
        t = torch.clamp(torch.nan_to_num((u - cdf_lo) / (cdf_hi - cdf_lo), nan=0.0), 0.0, 1.0)
    samples = bins_lo + t * (bins_hi - bins_lo)
    return samples.detach()


def sample_pdf(
    generator: Optional[torch.Generator],
    bins: torch.Tensor,
    weights: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    z_vals: torch.Tensor,
    num_samples: int,
    *,
    randomized: bool = True,
    mode: str = "nerf",
):
    """Hierarchical sampling: fine samples from the pdf, sorted together
    with the coarse z_vals (reference model_utils.py:289-314). Returns
    (z_vals [..., Nc+Nf], points [..., Nc+Nf, 3])."""
    z_samples = piecewise_constant_pdf(
        generator, bins, weights, num_samples, randomized=randomized, mode=mode
    )
    z_combined = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
    return z_combined, cast_rays(z_combined, origins, directions)
