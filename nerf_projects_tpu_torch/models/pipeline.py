"""The hierarchical NeRF rendering pipeline, coarse + fine (port of
``nerf_projects_tpu/models/pipeline.py``):

    stratified z -> posenc -> coarse MLP -> composite -> inverse-CDF fine
    samples (detached) -> merge/sort -> fine MLP -> composite

(posenc is skipped for an MLP that encodes raw points itself.)

The MLP runs on flattened [rays*samples, features] batches. Sigma noise
is added to the raw logit before the relu, as reference `raw2outputs`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.ops.posenc import posenc
from nerf_projects_tpu_torch.ops.render import volumetric_rendering
from nerf_projects_tpu_torch.ops.sampling import (
    cast_rays,
    merge_sorted,
    piecewise_constant_pdf,
    stratified_sample,
)


class NeRFRenderConfig(NamedTuple):
    """Static rendering configuration; field names mirror the reference
    flags (nerf/utils.py create_default_config)."""

    num_coarse_samples: int = 64       # N_samples
    num_fine_samples: int = 0          # N_importance
    multires: int = 10                 # point posenc frequencies
    multires_views: int = 4            # viewdir posenc frequencies
    use_viewdirs: bool = True
    lindisp: bool = False
    perturb: bool = True               # stratified jitter (training)
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    posenc_ordering: str = "interleaved"
    pdf_mode: str = "nerf"
    # draw the pdf uniforms as order statistics and merge the sorted fine
    # depths with the coarse ones instead of sorting the concatenation
    resample_sorted: bool = False


def _query_mlp(apply_fn, params, pts, viewdirs, cfg: NeRFRenderConfig):
    """Encode and evaluate the MLP at [R, N, 3] points -> raw [R, N, 4].
    An ``apply_fn`` tagged ``accepts_raw_points`` (a wrapper of
    ``ops/kernels/fused_mlp.fused_apply_raw``, which encodes in the kernel)
    gets the flat raw points and each row's view direction instead, and
    the config's posenc settings do not apply."""
    r, n = pts.shape[0], pts.shape[1]
    flat_pts = pts.reshape(r * n, 3)
    if getattr(apply_fn, "accepts_raw_points", False):
        vd = viewdirs[:, None, :].expand(r, n, 3).reshape(r * n, 3)
        raw = apply_fn(params, flat_pts, vd)
        return raw.reshape(r, n, raw.shape[-1])
    pts_enc = posenc(flat_pts, cfg.multires, ordering=cfg.posenc_ordering)
    if cfg.use_viewdirs:
        vd = viewdirs[:, None, :].expand(r, n, 3).reshape(r * n, 3)
        views_enc = posenc(vd, cfg.multires_views, ordering=cfg.posenc_ordering)
        raw = apply_fn(params, pts_enc, views_enc)
    else:
        raw = apply_fn(params, pts_enc)
    return raw.reshape(r, n, raw.shape[-1])


def _raw_to_outputs(generator, raw, z_vals, dirs, cfg: NeRFRenderConfig, randomized):
    """Activate raw outputs and composite (notebook cell 9 semantics)."""
    rgb = torch.sigmoid(raw[..., :3])
    sigma_logit = raw[..., 3]
    if cfg.raw_noise_std > 0.0 and randomized:
        noise = torch.randn(
            sigma_logit.shape, generator=generator, dtype=sigma_logit.dtype,
            device=sigma_logit.device,
        )
        sigma_logit = sigma_logit + noise * cfg.raw_noise_std
    sigma = torch.relu(sigma_logit)
    return volumetric_rendering(
        rgb, sigma, z_vals, dirs, white_bkgd=cfg.white_bkgd, disp_mode="nerf"
    )


def render_rays(
    generator: Optional[torch.Generator],
    params_coarse: Any,
    params_fine: Optional[Any],
    apply_fn: Callable,
    rays: Rays,
    near,
    far,
    cfg: NeRFRenderConfig,
    *,
    randomized: bool = True,
):
    """Render a [R] ray batch; ``apply_fn(params, pts_enc, views_enc)``
    evaluates the MLP, or ``apply_fn(params, pts, viewdirs)`` on raw
    [R*N, 3] points and per-row view directions when ``apply_fn`` has a
    true ``accepts_raw_points`` attribute (the in-kernel encoding route,
    ``fused_apply_raw``). Returns a dict with rgb, disp, acc, depth and
    weights (plus rgb0/disp0/acc0/z_std when num_fine_samples > 0).

    ``randomized=False`` is the serving path: linspace depths, linspace
    pdf uniforms and no sigma noise. ``randomized=True`` draws all three
    from ``generator``, which lives on the rays' device.
    """
    if randomized and generator is None and (cfg.perturb or cfg.raw_noise_std > 0):
        raise ValueError("randomized rendering requires a generator")
    n_rays = rays.origins.shape[0]
    device = rays.origins.device
    z_vals = stratified_sample(
        generator, cfg.num_coarse_samples, near, far, (n_rays,),
        lindisp=cfg.lindisp, randomized=randomized and cfg.perturb, device=device,
    )
    pts = cast_rays(z_vals, rays.origins, rays.directions)
    raw = _query_mlp(apply_fn, params_coarse, pts, rays.viewdirs, cfg)
    coarse = _raw_to_outputs(generator, raw, z_vals, rays.directions, cfg, randomized)
    out = {
        "rgb": coarse.rgb,
        "disp": coarse.disp,
        "acc": coarse.acc,
        "depth": coarse.depth,
        "weights": coarse.weights,
    }
    if cfg.num_fine_samples > 0:
        z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = piecewise_constant_pdf(
            generator, z_mids, coarse.weights[..., 1:-1], cfg.num_fine_samples,
            randomized=randomized and cfg.perturb, mode=cfg.pdf_mode,
            sorted_u=cfg.resample_sorted,
        )
        if cfg.resample_sorted:
            z_combined = merge_sorted(z_vals, z_samples)
        else:
            z_combined = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        pts_fine = cast_rays(z_combined, rays.origins, rays.directions)
        params_f = params_fine if params_fine is not None else params_coarse
        raw_fine = _query_mlp(apply_fn, params_f, pts_fine, rays.viewdirs, cfg)
        fine = _raw_to_outputs(generator, raw_fine, z_combined, rays.directions, cfg, randomized)
        out.update(
            rgb0=coarse.rgb,
            disp0=coarse.disp,
            acc0=coarse.acc,
            rgb=fine.rgb,
            disp=fine.disp,
            acc=fine.acc,
            depth=fine.depth,
            weights=fine.weights,
            z_std=torch.std(z_samples, dim=-1, unbiased=False),
        )
    return out
