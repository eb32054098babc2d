"""LLFF (forward-facing real scenes) loader (port of
``nerf_projects_tpu/data/llff.py``; host-side numpy, imageio and cv2
imported at the call).

Parity target: reference nerf/load_llff.py:242-315 (`load_llff_data`) and
the jaxnerf port (plenoctree/nerf_sh/nerf/datasets.py:235-383): the
poses_bounds.npy [N, 17] format, axis-convention fix, factor downscaling
(cv2 area-interp replaces the reference's ImageMagick mogrify), bd_factor
rescale, pose recentering, spiral / spherified render paths, and the
every-Nth-image holdout split (llffhold=8).
"""
from __future__ import annotations

import os

import numpy as np

from nerf_projects_tpu_torch.data.base import SceneData


def _load_images(root: str, factor: int) -> np.ndarray:
    import cv2
    import imageio.v2 as imageio

    img_dir = os.path.join(root, "images")
    # Prefer a pre-downsampled images_N directory when present (the
    # reference's minify output); otherwise resize on the fly.
    pre = os.path.join(root, f"images_{factor}")
    use_pre = factor > 1 and os.path.isdir(pre)
    src = pre if use_pre else img_dir
    files = sorted(
        os.path.join(src, f)
        for f in os.listdir(src)
        if f.lower().endswith(("jpg", "jpeg", "png"))
    )
    images = []
    for f in files:
        im = np.asarray(imageio.imread(f), dtype=np.float32) / 255.0
        if factor > 1 and not use_pre:
            h, w = im.shape[:2]
            im = cv2.resize(
                im, (w // factor, h // factor), interpolation=cv2.INTER_AREA
            )
        images.append(im[..., :3])
    return np.stack(images)


def _recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly transform all poses so their average is the identity
    (reference load_llff.py:165-181)."""
    bottom = np.array([0, 0, 0, 1.0], dtype=np.float32).reshape(1, 4)
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    c2w = np.concatenate([_viewmatrix(vec2, up, center), bottom], 0)
    out = np.linalg.inv(c2w) @ np.concatenate(
        [poses[:, :3, :4], np.broadcast_to(bottom, (len(poses), 1, 4))], 1
    )
    result = poses.copy()
    result[:, :3, :4] = out[:, :3, :4]
    return result


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _spiral_path(poses, bds, focal_scale=0.75, n_views=120, n_rots=2, zrate=0.5):
    """Spiral render path for forward-facing scenes (load_llff.py:152-163)."""
    c2w = _average_pose(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    mean_dz = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    focal = mean_dz * focal_scale

    tt = poses[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array(
                [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
            )
            * np.append(rads, 1.0)
        )
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        m = np.eye(4, dtype=np.float32)
        m[:3, :4] = _viewmatrix(z, up, c)
        render_poses.append(m)
    return np.stack(render_poses)


def _average_pose(poses):
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    m = np.eye(4, dtype=np.float32)
    m[:3, :4] = _viewmatrix(vec2, up, center)
    return m


def _spherify_poses(poses, bds):
    """Re-pose an inward-facing capture onto a sphere and build a circular
    render path (load_llff.py:183-240)."""
    p34_to_44 = lambda p: np.concatenate(
        [p, np.broadcast_to(np.array([0, 0, 0, 1.0]), (len(p), 1, 4))], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -a_i @ rays_o
        return np.squeeze(
            -np.linalg.pinv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
            @ b_i.mean(0)
        )

    center = min_line_dist(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    pos = center
    c2w = np.stack([vec1, vec2, vec0, pos], 1)

    poses_reset = (
        np.linalg.inv(p34_to_44(c2w[None]))[0] @ p34_to_44(poses[:, :3, :4])
    )
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    render_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh]
        )
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        pos = camorigin
        m = np.eye(4, dtype=np.float32)
        m[:3, :4] = np.stack([vec0, vec1, vec2, pos], 1)
        render_poses.append(m)
    out = np.broadcast_to(np.eye(4, dtype=np.float32), poses_reset.shape).copy()
    out[:, :3, :4] = poses_reset[:, :3, :4]
    return out, np.stack(render_poses), bds


def load_llff(
    root: str,
    split: str = "train",
    *,
    factor: int = 8,
    bd_factor: float = 0.75,
    recenter: bool = True,
    spherify: bool = False,
    llffhold: int = 8,
    ndc: bool = None,
) -> SceneData:
    poses_arr = np.load(os.path.join(root, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).astype(np.float32)
    bds = poses_arr[:, -2:].astype(np.float32)

    images = _load_images(root, factor)
    if images.shape[0] != poses.shape[0]:
        raise ValueError(
            f"image count {images.shape[0]} != pose count {poses.shape[0]}"
        )

    # hwf column; rescale intrinsics to the loaded resolution.
    hwf = poses[0, :3, -1].copy()
    hwf[0] = images.shape[1]
    hwf[1] = images.shape[2]
    hwf[2] = poses[0, 2, 4] / (poses[0, 0, 4] / images.shape[1])

    # Axis-convention fix: stored [down, right, back] -> [r, u, -t]
    # (load_llff.py:260).
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:4]], axis=2
    )  # [N, 3, 4]
    poses44 = np.broadcast_to(np.eye(4, dtype=np.float32), (len(poses), 4, 4)).copy()
    poses44[:, :3, :4] = poses

    # Rescale so nearest bound ~ 1/bd_factor (load_llff.py:286).
    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses44[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses44 = _recenter_poses(poses44)

    if spherify:
        poses44, render_poses, bds = _spherify_poses(poses44, bds)
        near = bds.min() * 0.9
        far = bds.max() * 1.0
        use_ndc = False
    else:
        render_poses = _spiral_path(poses44, bds)
        use_ndc = True if ndc is None else ndc
        if use_ndc:
            near, far = 0.0, 1.0
        else:
            near = bds.min() * 0.9
            far = bds.max() * 1.0

    # Holdout split: every llffhold-th image is test (notebook cell 19 §2).
    i_test = np.arange(images.shape[0])[::llffhold] if llffhold > 0 else np.array([], int)
    if split == "train":
        sel = np.array([i for i in range(images.shape[0]) if i not in i_test])
    else:
        sel = i_test if len(i_test) else np.arange(images.shape[0])

    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32
    )
    return SceneData(
        images=images[sel],
        poses=poses44[sel],
        intrinsics=K,
        near=float(near),
        far=float(far),
        render_poses=render_poses,
        ndc=use_ndc,
        white_bkgd=False,
        meta={"bds": bds, "split": split, "i_test": i_test},
    )
