"""Blender / NeRF-synthetic loader (port of
``nerf_projects_tpu/data/blender.py``; reference
nerf/load_blender.py:37-91): transforms_{split}.json with
``camera_angle_x`` and per-frame c2w matrices, RGBA pngs composited per
``white_bkgd``, ``testskip``, ``half_res`` area-downscale, the 40-pose
render path, near/far 2/6. imageio (and cv2 for downscaling) are
imported at the call.
"""
from __future__ import annotations

import json
import os

import numpy as np

from nerf_projects_tpu_torch.core.rays import spherical_pose_path
from nerf_projects_tpu_torch.data.base import SceneData


def _imread(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path), dtype=np.float32) / 255.0


def load_blender(
    root: str,
    split: str = "train",
    *,
    half_res: bool = False,
    testskip: int = 1,
    white_bkgd: bool = True,
    factor: int = 1,
) -> SceneData:
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    skip = 1 if (split == "train" or testskip == 0) else testskip
    frames = meta["frames"][::skip]

    images, poses = [], []
    for frame in frames:
        images.append(_imread(os.path.join(root, frame["file_path"] + ".png")))
        poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
    images = np.stack(images)  # [V, H, W, 4] rgba
    poses = np.stack(poses)

    H, W = images.shape[1:3]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    down = 2 if half_res else max(1, factor)
    if down > 1:
        import cv2

        H, W = H // down, W // down
        focal = focal / down
        images = np.stack([cv2.resize(im, (W, H), interpolation=cv2.INTER_AREA) for im in images])

    if images.shape[-1] == 4:
        if white_bkgd:
            images = images[..., :3] * images[..., 3:4] + (1.0 - images[..., 3:4])
        else:
            images = images[..., :3] * images[..., 3:4]

    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32)
    return SceneData(
        images=images.astype(np.float32),
        poses=poses,
        intrinsics=K,
        near=2.0,
        far=6.0,
        render_poses=spherical_pose_path(40, phi=-30.0, radius=4.0),
        white_bkgd=white_bkgd,
        meta={"camera_angle_x": camera_angle_x, "split": split},
    )
