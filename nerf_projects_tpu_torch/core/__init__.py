from nerf_projects_tpu_torch.core.chunk import chunk_apply, pad_to_multiple
from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import (
    Rays,
    camera_rays,
    camera_rays_opencv,
    ndc_rays,
    pose_spherical,
    spherical_pose_path,
)

__all__ = [
    "Rays",
    "camera_rays",
    "camera_rays_opencv",
    "chunk_apply",
    "ndc_rays",
    "pad_to_multiple",
    "pose_spherical",
    "resolve_device",
    "spherical_pose_path",
]
