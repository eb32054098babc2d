"""NeRF-SH training helpers (port of part of
``nerf_projects_tpu/cli/train_nerf_sh.py``): the ray pool of a scene
split and the chunked render of one view. ``train_main`` and the CLI's
``main`` (YAML configs, JSON metrics, memory snapshots, flax checkpoints)
are not ported yet (ROADMAP, Queue 1).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from nerf_projects_tpu_torch.core.rays import Rays, camera_rays


def build_ray_pool(scene, device: Optional[Union[str, torch.device]] = None):
    """Every pixel's ray (pixel centres at +0.5) and colour of a scene
    split: (Rays of [V*H*W, 3], rgb [V*H*W, 3]) on ``device``."""
    all_rays, all_rgb = [], []
    for v in range(scene.images.shape[0]):
        rays = camera_rays(scene.height, scene.width, scene.intrinsics, scene.poses[v], pixel_center=0.5,
                           device=device)
        all_rays.append(rays.map(lambda x: x.reshape(-1, 3)))
        all_rgb.append(torch.as_tensor(scene.images[v].reshape(-1, 3), device=all_rays[-1].origins.device))
    pool = Rays(*(torch.cat(xs) for xs in zip(*all_rays)))
    return pool, torch.cat(all_rgb)


def render_image_sh(trainer, model, scene, view: int, chunk: int = 8192,
                    device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """The rgb [H, W, 3] of one view through ``trainer.render_eval`` in
    requests of ``chunk`` rays; the last request is padded with copies of
    its last ray, as the reference pads it, and cut back."""
    rays = camera_rays(scene.height, scene.width, scene.intrinsics, scene.poses[view], pixel_center=0.5,
                       device=device)
    flat = rays.map(lambda x: x.reshape(-1, 3))
    n = flat.origins.shape[0]
    outs = []
    for i in range(0, n, chunk):
        sl = flat.map(lambda x: x[i: i + chunk])
        pad = chunk - sl.origins.shape[0]
        if pad:
            sl = sl.map(lambda x: F.pad(x[None], (0, 0, 0, pad), mode="replicate")[0])
        out = trainer.render_eval(model, sl)["rgb"]
        outs.append(out[: chunk - pad] if pad else out)
    return torch.cat(outs).reshape(scene.height, scene.width, 3)
