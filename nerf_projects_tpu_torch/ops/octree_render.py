"""PlenOctree volume rendering, the svox ``VolumeRenderer`` equivalent (port
of ``nerf_projects_tpu/ops/octree_render.py``).

Parity target: svox's ``VolumeRenderer.render_persp`` as the reference's
conversion and eval pipeline uses it (plenoctree/octree/nerf/utils.py:448-499
``eval_octree``, octree/optimization.py:312): per-sample octree queries
of [SH..., sigma] leaves, the SH decode against the view direction then
sigmoid (or svox2's +0.5 clamp), relu'd sigma composited by the
transmittance recursion, a white background, and the early stop below
``stop_thresh`` transmittance.

The JAX package scans one step at a time. Here ``slice_steps`` steps of
every ray are marched at once and the log transmittance is carried from
one slice to the next. The early stop stays exact: the transmittance
only falls, so a ray's active samples are a prefix of its samples, and
an exclusive cumulative sum of the optical depth gives the same
transmittance at each of them. The march is differentiable in
``tree.data`` (``PlenOctree.query`` gathers rows with ``index_select``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import device_constant
from nerf_projects_tpu_torch.core.rays import Rays, camera_rays
from nerf_projects_tpu_torch.models.octree import PlenOctree
from nerf_projects_tpu_torch.ops.sh import eval_sh_bases


class OctreeRenderOptions(NamedTuple):
    step_size: float = 1e-3         # march step in tree (unit-cube) units
    sigma_thresh: float = 1e-2      # svox default sigma threshold
    stop_thresh: float = 1e-2       # early-stop transmittance ("fast")
    background_brightness: float = 1.0
    max_steps: Optional[int] = None
    sh_deg: Optional[int] = None    # None = infer from data_dim
    color_mode: str = "sigmoid"     # "sigmoid" (PlenOctree) | "bias" (+0.5 clamp, svox2 export)


def infer_sh_deg(data_dim: int) -> int:
    basis = (data_dim - 1) // 3
    deg = int(np.sqrt(basis)) - 1
    if 3 * (deg + 1) ** 2 + 1 != data_dim:
        raise ValueError(f"data_dim {data_dim} is not 3*(d+1)^2+1")
    return deg


def default_max_steps(step_size: float) -> int:
    return int(np.ceil(np.sqrt(3.0) / step_size)) + 1


def volume_render_octree(
    tree: PlenOctree,
    rays: Rays,
    opts: OctreeRenderOptions = OctreeRenderOptions(),
    *,
    return_depth: bool = False,
    slice_steps: int = 64,
):
    """Render [R] rays through the octree -> dict(rgb [R, 3], acc [R][,
    depth [R]]) on the tree's device."""
    sh_deg = opts.sh_deg if opts.sh_deg is not None else infer_sh_deg(tree.data_dim)
    basis_dim = (sh_deg + 1) ** 2
    if opts.color_mode not in ("sigmoid", "bias"):
        raise ValueError(f"unknown color_mode {opts.color_mode!r}")

    origins_t = tree.world_to_tree(rays.origins)  # [R, 3]
    dirs_t = rays.directions * device_constant(tree.invradius, torch.float32, rays.directions.device)
    world_len = torch.linalg.norm(rays.directions, dim=-1)
    dt = opts.step_size / torch.clamp(torch.linalg.norm(dirs_t, dim=-1), min=1e-12)  # t per step
    step_world = dt * world_len

    inv_d = 1.0 / torch.where(torch.abs(dirs_t) < 1e-12, 1e-12, dirs_t)
    t_lo = (0.0 - origins_t) * inv_d
    t_hi = (1.0 - origins_t) * inv_d
    t0 = torch.clamp(torch.amax(torch.minimum(t_lo, t_hi), dim=-1), min=0.0)
    t1 = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit = t1 > t0
    n_rays = rays.origins.shape[0]
    max_steps = opts.max_steps if opts.max_steps is not None else default_max_steps(opts.step_size)
    # no ray has a valid sample past its exit: march only as far as the
    # longest chord of these rays (one read of the card a call)
    chord = torch.where(hit, (t1 - t0) / dt, 0.0)
    max_steps = min(max_steps, int(torch.ceil(chord.max())) + 2) if n_rays else 0

    basis = eval_sh_bases(basis_dim, rays.viewdirs)  # [R, B]
    dev = rays.origins.device
    log_T = torch.zeros(n_rays, device=dev)
    rgb_acc = torch.zeros((n_rays, 3), device=dev)
    acc = torch.zeros(n_rays, device=dev)
    depth_acc = torch.zeros(n_rays, device=dev)
    for k0 in range(0, max_steps, slice_steps):
        idx = torch.arange(k0, min(k0 + slice_steps, max_steps), dtype=torch.float32, device=dev)
        t = t0[:, None] + idx[None, :] * dt[:, None]  # [R, S]
        valid = (t < t1[:, None]) & hit[:, None]
        pts_t = origins_t[:, None, :] + t[..., None] * dirs_t[:, None, :]
        vals = tree.query(tree.tree_to_world(pts_t))  # [R, S, D]
        sigma = torch.relu(vals[..., -1])
        sigma = torch.where(valid & (sigma > opts.sigma_thresh), sigma, 0.0)
        coeffs = vals[..., : 3 * basis_dim].reshape(n_rays, -1, 3, basis_dim)
        decoded = torch.einsum("rscb,rb->rsc", coeffs, basis)
        rgb = torch.sigmoid(decoded) if opts.color_mode == "sigmoid" else torch.relu(decoded + 0.5)

        tau = sigma * step_world[:, None]
        before = torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        T = torch.exp(log_T[:, None] - before)
        active = T > opts.stop_thresh  # a prefix of each ray's samples
        w = torch.where(active, T * (1.0 - torch.exp(-tau)), 0.0)
        rgb_acc = rgb_acc + torch.sum(w[..., None] * rgb, dim=1)
        depth_acc = depth_acc + torch.sum(w * t * world_len[:, None], dim=1)
        acc = acc + torch.sum(w, dim=1)
        log_T = log_T - torch.sum(torch.where(active, tau, 0.0), dim=1)
    out = {"rgb": rgb_acc + (1.0 - acc[:, None]) * opts.background_brightness, "acc": acc}
    if return_depth:
        out["depth"] = depth_acc
    return out


def render_image_octree(
    tree: PlenOctree,
    height: int,
    width: int,
    intrinsics,
    c2w,
    opts: OctreeRenderOptions = OctreeRenderOptions(),
    chunk: int = 16384,
) -> torch.Tensor:
    """Full-image render (the render_persp equivalent) in chunks of rays
    on the tree's device -> rgb [H, W, 3]."""
    rays = camera_rays(height, width, intrinsics, c2w, device=tree.device)
    flat = rays.map(lambda x: x.reshape(-1, 3))
    n = height * width
    with torch.inference_mode():
        outs = [volume_render_octree(tree, flat.map(lambda x: x[i:i + chunk]), opts)["rgb"]
                for i in range(0, n, chunk)]
    return torch.cat(outs).reshape(height, width, 3)
