"""NeRF -> PlenOctree extraction (port of
``nerf_projects_tpu/pipeline/extraction.py``): so far only
``grid_weight_render``, which the Plenoxels grid lifecycle's
weight-threshold resample uses. The rest of the module (``auto_scale``,
``extract_octree``, the SH projection) comes with the PlenOctree
pipeline (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import camera_rays


def grid_weight_render(
    sigmas: np.ndarray,
    c2w: np.ndarray,
    intrinsics: np.ndarray,
    height: int,
    width: int,
    *,
    step_size: float = 1e-3,
    ray_subsample: int = 1,
    slice_steps: int = 64,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """The largest ray weight each cell of a dense [reso]^3 sigma grid
    receives from one camera (svox's ``_C.grid_weight_render``,
    misc_kernel.cu:310-334; extraction.py:212): camera rays marched in the
    unit cube (world [-1, 1] -> [0, 1); callers move other frames there)
    with nearest-cell lookups, transmittance weights, and a scatter-max
    into the visited cells. ``slice_steps`` steps of every ray at a time
    (the transmittance carried across slices); on ``device`` (None: the
    card). Returns float32 [reso]^3 on the host."""
    dev = resolve_device(device)
    reso = sigmas.shape[0]
    sig = torch.as_tensor(np.ascontiguousarray(sigmas, np.float32), device=dev).reshape(-1)
    rays = camera_rays(height // ray_subsample, width // ray_subsample, np.asarray(intrinsics) / ray_subsample,
                       np.asarray(c2w), device=dev)
    origins = rays.origins.reshape(-1, 3)
    dirs = rays.directions.reshape(-1, 3)

    o = origins * 0.5 + 0.5
    d = dirs * 0.5
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t_lo = (0.0 - o) * inv_d
    t_hi = (1.0 - o) * inv_d
    t0 = torch.clamp(torch.amax(torch.minimum(t_lo, t_hi), -1), min=0.0)
    t1 = torch.amin(torch.maximum(t_lo, t_hi), -1)
    world_len = torch.linalg.norm(dirs, dim=-1)
    dt = step_size / torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-12)
    step_world = dt * world_len

    max_steps = int(np.ceil(np.sqrt(3.0) / step_size)) + 1
    log_T = torch.zeros(o.shape[0], device=dev)
    max_w = torch.zeros(reso**3, device=dev)
    for k0 in range(0, max_steps, slice_steps):
        idx = torch.arange(k0, min(k0 + slice_steps, max_steps), dtype=torch.float32, device=dev)
        t = t0[:, None] + idx[None, :] * dt[:, None]  # [N, S]
        valid = t < t1[:, None]
        pos = o[:, None, :] + t[..., None] * d[:, None, :]
        cell = torch.clamp((pos * reso).to(torch.int32), 0, reso - 1).long()
        flat = (cell[..., 0] * reso + cell[..., 1]) * reso + cell[..., 2]
        tau = torch.where(valid, sig[flat], 0.0) * step_world[:, None]
        before = log_T[:, None] - (torch.cumsum(tau, dim=-1) - tau)  # log T at each sample
        w = torch.exp(before) * (1.0 - torch.exp(-tau))
        max_w.scatter_reduce_(0, flat.reshape(-1), torch.where(valid, w, 0.0).reshape(-1), reduce="amax")
        log_T = before[:, -1] - tau[:, -1]
    return max_w.reshape(reso, reso, reso).cpu().numpy()
