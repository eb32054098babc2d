"""LINEMOD dataset loader (port of ``nerf_projects_tpu/data/linemod.py``;
host-side numpy, imageio and cv2 imported at the call).

Parity target: reference nerf/load_LINEMOD.py:37-93 (`load_LINEMOD_data`):
Blender-style transforms_{split}.json but with an explicit per-frame
`intrinsic_matrix` and per-split near/far fields; testskip subsampling and
half_res area resize.
"""
from __future__ import annotations

import json
import os

import numpy as np

from nerf_projects_tpu_torch.data.base import SceneData


def load_linemod(
    root: str,
    split: str = "train",
    *,
    half_res: bool = False,
    testskip: int = 1,
    white_bkgd: bool = False,
) -> SceneData:
    import imageio.v2 as imageio

    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    skip = 1 if split == "train" or testskip == 0 else testskip
    frames = meta["frames"][::skip]

    images, poses = [], []
    for frame in frames:
        fname = frame["file_path"]
        if not os.path.isabs(fname):
            fname = os.path.join(root, fname)
        if not os.path.splitext(fname)[1]:
            fname += ".png"
        images.append(
            np.asarray(imageio.imread(fname), np.float32) / 255.0
        )
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
    images = np.stack(images)
    poses = np.stack(poses)

    K = np.asarray(
        meta.get("intrinsic_matrix", frames[0].get("intrinsic_matrix")),
        np.float32,
    )
    H, W = images.shape[1:3]

    if half_res:
        import cv2

        H, W = H // 2, W // 2
        K = K.copy()
        K[:2] /= 2.0
        images = np.stack(
            [cv2.resize(im, (W, H), interpolation=cv2.INTER_AREA) for im in images]
        )

    if images.shape[-1] == 4:
        if white_bkgd:
            images = images[..., :3] * images[..., 3:4] + (1 - images[..., 3:4])
        else:
            images = images[..., :3]

    near = float(meta.get("near", 0.1))
    far = float(meta.get("far", 2.0))
    return SceneData(
        images=images[..., :3],
        poses=poses,
        intrinsics=K,
        near=near,
        far=far,
        white_bkgd=white_bkgd,
        meta={"split": split},
    )
