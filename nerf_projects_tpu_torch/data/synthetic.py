"""Procedural synthetic scenes for tests and dataset-free training (port
of ``nerf_projects_tpu/data/synthetic.py``).

An analytic volume scene (constant-density coloured spheres) whose
ground-truth images come from the same compositing math at a fine step
count, so trainers run end to end (loss -> PSNR) with no dataset.
Random draws come from an explicit ``torch.Generator`` on the data's
device; camera elevations from a numpy generator seeded by ``seed``, as
in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays, camera_rays, pose_spherical
from nerf_projects_tpu_torch.ops.render import volumetric_rendering


class SphereScene(NamedTuple):
    centers: torch.Tensor  # [S, 3]
    radii: torch.Tensor    # [S]
    colors: torch.Tensor   # [S, 3]
    density: float


def default_scene() -> SphereScene:
    return SphereScene(
        centers=torch.tensor([[0.0, 0.0, 0.0], [0.6, 0.4, -0.2], [-0.5, -0.3, 0.3]]),
        radii=torch.tensor([0.5, 0.3, 0.35]),
        colors=torch.tensor([[0.9, 0.2, 0.2], [0.2, 0.8, 0.3], [0.2, 0.3, 0.9]]),
        density=40.0,
    )


def scene_fields(scene: SphereScene, pts: torch.Tensor):
    """Analytic (rgb, sigma) at [..., 3] points."""
    centers, radii, colors = (t.to(pts.device) for t in scene[:3])
    d2 = ((pts[..., None, :] - centers) ** 2).sum(-1)  # [..., S]
    inside = d2 < radii ** 2
    sigma = scene.density * inside.any(dim=-1).float()
    # nearest-centre colour where inside; elsewhere sigma is 0
    rgb = colors[torch.argmin(d2 / radii ** 2, dim=-1)]
    return rgb, sigma


def render_scene(
    scene: SphereScene,
    rays: Rays,
    near: float = 2.0,
    far: float = 6.0,
    num_samples: int = 256,
    white_bkgd: bool = True,
):
    """Ground-truth render with dense uniform sampling."""
    t = torch.linspace(0.0, 1.0, num_samples, device=rays.origins.device)
    z_vals = (near * (1 - t) + far * t).expand(tuple(rays.batch_shape) + (num_samples,))
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z_vals[..., None]
    rgb, sigma = scene_fields(scene, pts)
    return volumetric_rendering(rgb, sigma, z_vals, rays.directions, white_bkgd=white_bkgd).rgb


@torch.no_grad()
def make_dataset(
    scene: Optional[SphereScene] = None,
    *,
    n_views: int = 8,
    image_size: int = 64,
    focal: float = 80.0,
    radius: float = 4.0,
    near: float = 2.0,
    far: float = 6.0,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
):
    """Render a small multi-view dataset on ``device`` (``None``: the
    card). Returns a dict with 'images' [V, H, W, 3], 'pixels' [V*H*W, 3],
    'rays' (flattened Rays over all pixels of all views), 'poses',
    'intrinsics', 'near', 'far' and 'scene'."""
    dev = resolve_device(device)
    if scene is None:
        scene = default_scene()
    H = W = image_size
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], dtype=np.float32)
    # cameras over the sphere (varying elevation), not a single ring
    rng = np.random.default_rng(seed)
    thetas = np.linspace(-180.0, 180.0, n_views + 1)[:-1]
    phis = rng.uniform(-75.0, 15.0, n_views)
    poses = np.stack([pose_spherical(t, p, radius) for t, p in zip(thetas, phis)], axis=0)
    # chunk by rows: dense sampling holds H*W*256 points
    rows = max(1, min(H, (1 << 24) // max(W * 256, 1)))
    all_rays, all_rgb = [], []
    for v in range(n_views):
        rays = camera_rays(H, W, K, poses[v], device=dev)
        parts = [
            render_scene(scene, rays.map(lambda x: x[i: i + rows]), near=near, far=far)
            for i in range(0, H, rows)
        ]
        all_rays.append(rays)
        all_rgb.append(torch.cat(parts, dim=0))
    images = torch.stack(all_rgb)  # [V, H, W, 3]
    flat_rays = Rays(*(torch.stack(fs).reshape(-1, 3) for fs in zip(*all_rays)))
    return {
        "images": images,
        "pixels": images.reshape(-1, 3),
        "rays": flat_rays,
        "poses": poses,
        "intrinsics": K,
        "near": near,
        "far": far,
        "scene": scene,
    }


def ray_batches(generator: torch.Generator, dataset, batch_size: int):
    """Infinite generator of random ray batches from the pooled dataset,
    drawn on the pool's device from ``generator`` (on that device)."""
    n = dataset["pixels"].shape[0]
    device = dataset["pixels"].device
    while True:
        idx = torch.randint(0, n, (batch_size,), generator=generator, device=device)
        yield dataset["rays"].map(lambda x: x[idx]), dataset["pixels"][idx]


def tile_batches(generator: torch.Generator, dataset, n_tiles: int, tile_h: int = 8, tile_w: int = 8):
    """Infinite generator of coherent tile batches: each tile is a
    tile_h x tile_w pixel patch of one view (random view and offset).
    Yields (Rays [T, R], target [T, R, 3]) with R = tile_h * tile_w."""
    V, H, W = dataset["images"].shape[:3]
    device = dataset["pixels"].device
    dy, dx = torch.meshgrid(torch.arange(tile_h, device=device), torch.arange(tile_w, device=device),
                            indexing="ij")
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    while True:
        v = torch.randint(0, V, (n_tiles,), generator=generator, device=device)
        y0 = torch.randint(0, H - tile_h + 1, (n_tiles,), generator=generator, device=device)
        x0 = torch.randint(0, W - tile_w + 1, (n_tiles,), generator=generator, device=device)
        flat = v[:, None] * (H * W) + (y0[:, None] + dy[None]) * W + (x0[:, None] + dx[None])
        yield dataset["rays"].map(lambda a: a[flat]), dataset["pixels"][flat]
