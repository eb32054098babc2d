"""Ray primitives and camera-ray generation (port of
``nerf_projects_tpu/core/rays.py``).

OpenGL convention, as reference nerf/nerf_helpers.py:222 (`get_rays`):
the camera looks down -z, pixel coordinates are integers, y is flipped.
The pose helpers are host-side numpy, copied so that the port imports
nothing of the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device


class Rays(NamedTuple):
    """A bundle of rays; all fields share their leading dims.

    ``viewdirs`` is the normalised direction used for view-dependent
    shading; ``directions`` are not normalised.
    """

    origins: torch.Tensor     # [..., 3]
    directions: torch.Tensor  # [..., 3]
    viewdirs: torch.Tensor    # [..., 3]

    @property
    def batch_shape(self):
        return self.origins.shape[:-1]

    def map(self, fn) -> "Rays":
        """Apply ``fn`` to every field."""
        return Rays(*(fn(t) for t in self))


def camera_rays(
    height: int,
    width: int,
    intrinsics,
    c2w,
    *,
    pixel_center: float = 0.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Rays:
    """Per-pixel pinhole rays, OpenGL convention, shaped [H, W, 3].

    intrinsics: [3, 3] K (fx=K[0,0], fy=K[1,1], cx=K[0,2], cy=K[1,2]);
    c2w: [3, 4] or [4, 4] camera-to-world. ``pixel_center`` is added to
    the integer pixel indices (0.0 for reference parity).
    """
    dev = resolve_device(device)
    K = torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=dev)
    x = torch.arange(width, dtype=torch.float32, device=dev) + pixel_center
    y = torch.arange(height, dtype=torch.float32, device=dev) + pixel_center
    y, x = torch.meshgrid(y, x, indexing="ij")
    dirs_cam = torch.stack(
        [(x - K[0, 2]) / K[0, 0], -(y - K[1, 2]) / K[1, 1], -torch.ones_like(x)],
        dim=-1,
    )
    directions = dirs_cam @ c2w[:3, :3].T
    origins = c2w[:3, -1].expand(directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    return Rays(origins=origins, directions=directions, viewdirs=viewdirs)


def camera_rays_opencv(
    height: int,
    width: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    c2w,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Rays:
    """Per-pixel pinhole rays, OpenCV convention (+z forward, y down,
    pixel centres at +0.5), unit directions, shaped [H, W, 3]: svox2's
    ``Camera.gen_rays`` (svox2/svox2/svox2.py:157-183)."""
    dev = resolve_device(device)
    c2w = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=dev)
    x = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    y = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    y, x = torch.meshgrid(y, x, indexing="ij")
    dirs_cam = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(x)], dim=-1)
    dirs_cam = dirs_cam / torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)
    directions = dirs_cam @ c2w[:3, :3].T
    origins = c2w[:3, -1].expand(directions.shape)
    return Rays(origins=origins, directions=directions, viewdirs=directions)


def ndc_rays(
    height: int,
    width: int,
    focal: float,
    near: float,
    origins: torch.Tensor,
    directions: torch.Tensor,
):
    """Shift rays to the near plane and warp them into OpenGL NDC space
    (reference nerf/nerf_helpers.py:311-369, the jaxnerf variant
    plenoctree/nerf_sh/nerf/datasets.py:40-60): forward-facing (LLFF)
    scenes, rays with negative z in camera space, fx == fy == focal."""
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    dx, dy, dz = directions[..., 0], directions[..., 1], directions[..., 2]

    o0 = -1.0 / (width / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (height / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz
    d0 = -1.0 / (width / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (height / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def ndc_rays_opencv(origins: torch.Tensor, directions: torch.Tensor, ndc_coeffs: tuple):
    """The OpenCV-convention NDC warp of the Plenoxels path (reference
    svox2/svox2/utils.py:576-597): +z forward rays, ndc_coeffs = (2 fx / W,
    2 fy / H), the near plane at z = 1; unit directions out."""
    cx, cy = ndc_coeffs
    t = -(1.0 - origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    dx, dy, dz = directions[..., 0], directions[..., 1], directions[..., 2]

    o0 = cx * ox / oz
    o1 = cy * oy / oz
    o2 = 1.0 - 2.0 / oz
    d0 = cx * (dx / dz - ox / oz)
    d1 = cy * (dy / dz - oy / oz)
    d2 = 2.0 / oz

    ndc_directions = torch.stack([d0, d1, d2], dim=-1)
    ndc_directions = ndc_directions / torch.linalg.norm(ndc_directions, dim=-1, keepdim=True)
    return torch.stack([o0, o1, o2], dim=-1), ndc_directions


# ---------------------------------------------------------------------------
# Pose path helpers (host-side numpy)
# ---------------------------------------------------------------------------

def _trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] pose on a sphere, looking at the origin
    (reference nerf/load_blender.py:29). Angles in degrees."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def spherical_pose_path(n_poses: int = 40, phi: float = -30.0, radius: float = 4.0):
    """The reference's 40-pose render path (load_blender.py:80-84)."""
    thetas = np.linspace(-180.0, 180.0, n_poses + 1)[:-1]
    return np.stack([pose_spherical(t, phi, radius) for t in thetas], axis=0)


def equirect_rays(height: int, width: int, c2w, *, device: Optional[Union[str, torch.device]] = None) -> Rays:
    """360-degree equirectangular rays shaped [H, W, 3] (reference
    nerf_sh/nerf/utils.py:591-624): longitude over [-pi, pi) across the
    width, latitude over (-pi/2, pi/2] down the height, directions rotated
    by c2w, origins at the camera centre."""
    dev = resolve_device(device)
    c2w = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=dev)
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    y, x = torch.meshgrid(y, x, indexing="ij")
    lon = (x / width - 0.5) * 2.0 * np.pi
    lat = -(y / height - 0.5) * np.pi
    dirs_cam = torch.stack([torch.cos(lat) * torch.sin(lon), torch.sin(lat), -torch.cos(lat) * torch.cos(lon)],
                           dim=-1)
    directions = dirs_cam @ c2w[:3, :3].T
    origins = c2w[:3, -1].expand(directions.shape)
    return Rays(origins=origins, directions=directions, viewdirs=directions)
