"""NSVF (Neural Sparse Voxel Fields, e.g. TanksAndTemples) loader (port of
``nerf_projects_tpu/data/nsvf.py``; host-side numpy, imageio imported at
the call).

Parity target: reference plenoctree/nerf_sh/nerf/datasets.py:491-553 and
svox2/opt/util/nsvf_dataset.py:19+: rgb/ and pose/ directories with
0_/1_/2_ filename prefixes marking the train/val/test splits, a global
intrinsics.txt, and an optional bbox.txt scene AABB.
"""
from __future__ import annotations

import os

import numpy as np

from nerf_projects_tpu_torch.data.base import SceneData

_SPLIT_PREFIX = {"train": "0_", "val": "1_", "test": "2_"}


def load_nsvf(
    root: str,
    split: str = "train",
    *,
    white_bkgd: bool = True,
    scale: float = 1.0,
) -> SceneData:
    import imageio.v2 as imageio

    prefix = _SPLIT_PREFIX.get(split, "0_")
    img_dir = os.path.join(root, "rgb")
    pose_dir = os.path.join(root, "pose")
    img_files = sorted(
        f
        for f in os.listdir(img_dir)
        if f.startswith(prefix) and f.lower().endswith(("png", "jpg"))
    )
    if not img_files:  # some sets have no split prefixes
        img_files = sorted(
            f for f in os.listdir(img_dir) if f.lower().endswith(("png", "jpg"))
        )

    images, poses = [], []
    for f in img_files:
        im = np.asarray(imageio.imread(os.path.join(img_dir, f)), np.float32) / 255.0
        if im.shape[-1] == 4:
            if white_bkgd:
                im = im[..., :3] * im[..., 3:4] + (1 - im[..., 3:4])
            else:
                im = im[..., :3]
        images.append(im[..., :3])
        pose_file = os.path.join(pose_dir, os.path.splitext(f)[0] + ".txt")
        pose = np.loadtxt(pose_file).reshape(4, 4).astype(np.float32)
        pose[:3, 3] *= scale
        poses.append(pose)
    images = np.stack(images)
    poses = np.stack(poses)

    intrin = np.loadtxt(os.path.join(root, "intrinsics.txt"))
    if intrin.ndim == 2:  # full 3x3 (or 4x4) matrix
        K = intrin[:3, :3].astype(np.float32)
    else:
        focal = float(intrin.flat[0])
        H, W = images.shape[1:3]
        K = np.array(
            [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
            dtype=np.float32,
        )

    bbox = None
    bbox_path = os.path.join(root, "bbox.txt")
    if os.path.isfile(bbox_path):
        vals = np.loadtxt(bbox_path).reshape(-1)[:6] * scale
        bbox = vals.reshape(2, 3).astype(np.float32)

    cam_dist = float(np.mean(np.linalg.norm(poses[:, :3, 3], axis=-1)))
    near = max(0.05, cam_dist - 3.0)
    far = cam_dist + 3.0
    return SceneData(
        images=images,
        poses=poses,
        intrinsics=K,
        near=near,
        far=far,
        white_bkgd=white_bkgd,
        bbox=bbox,
        meta={"split": split},
    )
