"""CO3D dataset loader (port of ``nerf_projects_tpu/data/co3d.py``;
host numpy, imageio imported at the call). As in the JAX package,
``data/base.py::load_scene`` does not dispatch to it.

Parity target: reference svox2/opt/util/co3d_dataset.py:22+ — CO3D
sequence frames with per-frame viewpoint (R, T) and intrinsics in the
frame_annotations json(.jgz), converted to c2w poses, with per-sequence
selection and train/test splitting by frame stride.
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Optional

import numpy as np

from nerf_projects_tpu_torch.data.base import SceneData


def _load_annotations(root: str):
    for name in ("frame_annotations.jgz", "frame_annotations.json.gz"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            with gzip.open(p, "rt") as f:
                return json.load(f)
    p = os.path.join(root, "frame_annotations.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    raise FileNotFoundError(f"no frame annotations under {root}")


def load_co3d(
    root: str,
    split: str = "train",
    *,
    sequence: Optional[str] = None,
    test_every: int = 8,
    max_frames: int = 0,
) -> SceneData:
    import imageio.v2 as imageio

    anns = _load_annotations(root)
    if sequence is None:
        sequence = anns[0]["sequence_name"]
    frames = [a for a in anns if a["sequence_name"] == sequence]
    frames.sort(key=lambda a: a["frame_number"])
    if max_frames:
        frames = frames[:max_frames]

    idx = np.arange(len(frames))
    test_idx = set(idx[::test_every].tolist())
    if split == "train":
        sel = [i for i in idx if i not in test_idx]
    else:
        sel = [i for i in idx if i in test_idx]

    images, poses, Ks = [], [], []
    for i in sel:
        a = frames[i]
        img_path = os.path.join(root, a["image"]["path"])
        im = np.asarray(imageio.imread(img_path), np.float32) / 255.0
        images.append(im[..., :3])
        vp = a["viewpoint"]
        R = np.asarray(vp["R"], np.float32)          # world->cam rotation (PyTorch3D row-major)
        T = np.asarray(vp["T"], np.float32)
        # PyTorch3D convention: x_cam = x_world @ R + T ->
        # c2w rotation = R (row-vector form transposes twice), center = -T @ R^T
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R.T
        w2c[:3, 3] = T
        c2w = np.linalg.inv(w2c)
        poses.append(c2w.astype(np.float32))
        H, W = im.shape[:2]
        focal = np.asarray(vp["focal_length"], np.float32)
        pp = np.asarray(vp.get("principal_point", [0.0, 0.0]), np.float32)
        # NDC-style intrinsics -> pixels (co3d_dataset.py conversion)
        half = min(H, W) / 2.0
        fx, fy = focal[0] * half, focal[1] * half
        cx = W / 2.0 - pp[0] * half
        cy = H / 2.0 - pp[1] * half
        Ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32))

    images = np.stack(images)
    poses = np.stack(poses)
    K = Ks[0]
    cam_dist = float(np.mean(np.linalg.norm(poses[:, :3, 3], axis=-1)))
    return SceneData(
        images=images,
        poses=poses,
        intrinsics=K,
        near=max(0.1, cam_dist - 8.0),
        far=cam_dist + 8.0,
        white_bkgd=False,
        meta={"split": split, "sequence": sequence, "convention": "opencv"},
    )
