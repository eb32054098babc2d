"""Dataset container and auto-detection (port of
``nerf_projects_tpu/data/base.py``).

Host-side numpy throughout: ``load_scene`` dispatches to the Blender,
LLFF, NSVF, DeepVoxels and LINEMOD loaders (``data/*.py``) by
``detect_dataset_type``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SceneData:
    """Everything a trainer or renderer needs from a scene split."""

    images: np.ndarray          # [V, H, W, 3] float32 in [0, 1]
    poses: np.ndarray           # [V, 4, 4] camera-to-world
    intrinsics: np.ndarray      # [3, 3] K
    near: float
    far: float
    render_poses: Optional[np.ndarray] = None  # [P, 4, 4] video path
    ndc: bool = False
    white_bkgd: bool = False
    bbox: Optional[np.ndarray] = None          # [2, 3] scene AABB (NSVF)
    meta: dict = field(default_factory=dict)

    @property
    def height(self):
        return self.images.shape[1]

    @property
    def width(self):
        return self.images.shape[2]

    @property
    def focal(self):
        return float(self.intrinsics[0, 0])


def detect_dataset_type(root: str) -> str:
    """The dataset flavour from its files (svox2/opt/util/dataset.py:7-27
    plus the nerf/ loader types): one of blender, llff, nsvf, deepvoxels,
    linemod."""
    if os.path.isfile(os.path.join(root, "poses_bounds.npy")):
        return "llff"
    if os.path.isfile(os.path.join(root, "transforms_train.json")) or os.path.isfile(
        os.path.join(root, "transforms.json")
    ):
        import json

        p = os.path.join(root, "transforms_train.json")
        if os.path.isfile(p):
            with open(p) as f:
                meta = json.load(f)
            if "intrinsic_matrix" in meta or (
                meta.get("frames") and "intrinsic_matrix" in meta["frames"][0]
            ):
                return "linemod"
        return "blender"
    if os.path.isdir(os.path.join(root, "pose")) and os.path.isfile(
        os.path.join(root, "intrinsics.txt")
    ):
        return "nsvf"
    if os.path.isfile(os.path.join(root, "intrinsics.txt")):
        return "deepvoxels"
    raise ValueError(f"cannot detect dataset type at {root}")


def load_scene(root: str, split: str = "train", **kwargs) -> SceneData:
    """Load any supported dataset by auto-detection."""
    kind = detect_dataset_type(root)
    if kind == "blender":
        from nerf_projects_tpu_torch.data.blender import load_blender

        return load_blender(root, split, **kwargs)
    if kind == "llff":
        from nerf_projects_tpu_torch.data.llff import load_llff

        return load_llff(root, split, **kwargs)
    if kind == "nsvf":
        from nerf_projects_tpu_torch.data.nsvf import load_nsvf

        return load_nsvf(root, split, **kwargs)
    if kind == "deepvoxels":
        from nerf_projects_tpu_torch.data.deepvoxels import load_deepvoxels

        return load_deepvoxels(root, split, **kwargs)
    if kind == "linemod":
        from nerf_projects_tpu_torch.data.linemod import load_linemod

        return load_linemod(root, split, **kwargs)
    raise ValueError(kind)
