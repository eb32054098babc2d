"""DeepVoxels dataset loader (port of
``nerf_projects_tpu/data/deepvoxels.py``; host-side numpy, imageio
imported at the call).

Parity target: reference nerf/load_deepvoxels.py:6-108 (`load_dv_data`):
intrinsics.txt (focal + cx/cy on line 1, near/far metadata), per-image 4x4
pose files under pose/, train/val/test subdirectories, hemisphere-derived
near/far bounds around the fixed camera radius.
"""
from __future__ import annotations

import os

import numpy as np

from nerf_projects_tpu_torch.data.base import SceneData


def _parse_intrinsics(path: str, H: int):
    with open(path) as f:
        lines = f.readlines()
    focal, cx, cy = map(float, lines[0].split()[:3])
    grid_barycenter = np.array(list(map(float, lines[1].split())))
    near_plane = float(lines[2].split()[0])
    scale = float(lines[3].split()[0])
    height, width = map(float, lines[4].split()[:2])
    f_factor = H / height
    return focal * f_factor, grid_barycenter, near_plane, scale


def load_deepvoxels(
    root: str,
    split: str = "train",
    *,
    scene: str = None,
    testskip: int = 1,
) -> SceneData:
    import imageio.v2 as imageio

    base = root if scene is None else os.path.join(root, scene)
    splitdir = {"train": "train", "val": "validation", "test": "test"}.get(
        split, split
    )
    d = os.path.join(base, splitdir) if os.path.isdir(
        os.path.join(base, splitdir)
    ) else base

    img_dir = os.path.join(d, "rgb")
    pose_dir = os.path.join(d, "pose")
    img_files = sorted(
        f for f in os.listdir(img_dir) if f.lower().endswith(("png", "jpg"))
    )
    skip = 1 if split == "train" or testskip == 0 else testskip
    img_files = img_files[::skip]

    images, poses = [], []
    for f in img_files:
        im = np.asarray(imageio.imread(os.path.join(img_dir, f)), np.float32) / 255.0
        images.append(im[..., :3])
        pose_file = os.path.join(pose_dir, os.path.splitext(f)[0] + ".txt")
        pose = np.loadtxt(pose_file).reshape(4, 4).astype(np.float32)
        poses.append(pose)
    images = np.stack(images)
    poses = np.stack(poses)

    H, W = images.shape[1:3]
    focal, _, _, _ = _parse_intrinsics(os.path.join(d, "intrinsics.txt"), H)

    # Hemisphere bounds around the mean camera radius (load_deepvoxels.py:95-100).
    hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, 3], axis=-1)))
    near = hemi_r - 1.0
    far = hemi_r + 1.0

    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32
    )
    return SceneData(
        images=images,
        poses=poses,
        intrinsics=K,
        near=near,
        far=far,
        white_bkgd=False,
        meta={"split": split},
    )
