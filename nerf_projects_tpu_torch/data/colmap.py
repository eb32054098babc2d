"""COLMAP model readers + dataset converters (port of
``nerf_projects_tpu/data/colmap.py``; host numpy, no tensors).

Parity targets: reference svox2/opt/scripts — the vendored COLMAP binary
readers (read_write_model.py), the colmap -> NSVF converter
(colmap2nsvf.py), and the LLFF `poses_bounds.npy` generation that
nerf/load_llff.py consumes. The binary formats are COLMAP's public
sparse-model layout (cameras.bin / images.bin / points3D.bin).
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # [4] w,x,y,z
    tvec: np.ndarray   # [3]
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
}


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            img_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            raw = f.read(24 * n_pts)
            data = np.frombuffer(raw, dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            # the third field is a uint64 point3D id, not a double
            ids = (
                np.frombuffer(raw, dtype=np.uint64)
                .reshape(-1, 3)[:, 2]
                .astype(np.int64)
            )
            out[img_id] = ColmapImage(
                img_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                cam_id,
                name.decode("utf-8"),
                xys,
                ids,
            )
    return out


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz [N, 3], rgb [N, 3] uint8)."""
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return np.asarray(xyzs), np.asarray(rgbs, np.uint8)


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def colmap_c2w(image: ColmapImage) -> np.ndarray:
    """World-to-camera (R, t) -> OpenCV-convention c2w 4x4."""
    R = qvec2rotmat(image.qvec)
    t = image.tvec
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ t
    return c2w


def colmap_to_nsvf(sparse_dir: str, out_dir: str, *, scale: float = 1.0):
    """cameras/images/points3D.bin -> NSVF layout (pose/*.txt,
    intrinsics.txt, bbox.txt) — colmap2nsvf.py equivalent. Images are NOT
    copied; pose files are named after the source images."""
    cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    os.makedirs(os.path.join(out_dir, "pose"), exist_ok=True)

    cam = next(iter(cams.values()))
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy, cx, cy = cam.params[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    np.savetxt(os.path.join(out_dir, "intrinsics.txt"), K)

    for img in imgs.values():
        c2w = colmap_c2w(img)
        c2w[:3, 3] *= scale
        stem = os.path.splitext(os.path.basename(img.name))[0]
        np.savetxt(os.path.join(out_dir, "pose", stem + ".txt"), c2w)

    pts_path = os.path.join(sparse_dir, "points3D.bin")
    if os.path.exists(pts_path):
        xyz, _ = read_points3d_binary(pts_path)
        if len(xyz):
            xyz = xyz * scale
            lo = np.percentile(xyz, 2, axis=0)
            hi = np.percentile(xyz, 98, axis=0)
            voxel = float((hi - lo).max() / 256.0)
            np.savetxt(
                os.path.join(out_dir, "bbox.txt"),
                np.concatenate([lo, hi, [voxel]])[None],
            )
    return out_dir


def colmap_to_poses_bounds(sparse_dir: str, out_path: str):
    """cameras/images/points3D.bin -> LLFF poses_bounds.npy (the gen_poses
    flow the reference's nerf/load_llff.py consumes)."""
    cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    xyz, _ = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))

    rows = []
    for img_id in sorted(imgs, key=lambda i: imgs[i].name):
        img = imgs[img_id]
        cam = cams[img.camera_id]
        fx = cam.params[0]
        c2w_cv = colmap_c2w(img)
        # OpenCV c2w -> LLFF [down, right, back] storage convention:
        # columns reorder [r, u, -t] -> [-u, r, -t] inverse of loader fix.
        r, u, t = c2w_cv[:3, 0], -c2w_cv[:3, 1], -c2w_cv[:3, 2]
        m = np.stack([-u, r, -t], axis=1)  # 3x3 in llff storage order
        pose35 = np.concatenate(
            [np.concatenate([m, c2w_cv[:3, 3:4]], 1),
             np.array([[cam.height], [cam.width], [fx]])],
            axis=1,
        )  # 3x5
        # depth bounds from visible 3D points in this camera's frame
        R = qvec2rotmat(img.qvec)
        pts_cam = (R @ xyz.T).T + img.tvec
        z = pts_cam[:, 2]
        z = z[z > 0]
        close = np.percentile(z, 0.1) if len(z) else 0.1
        inf = np.percentile(z, 99.9) if len(z) else 100.0
        rows.append(np.concatenate([pose35.ravel(), [close, inf]]))
    arr = np.stack(rows)
    np.save(out_path, arr)
    return arr
