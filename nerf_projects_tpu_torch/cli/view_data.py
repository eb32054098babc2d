"""Dataset viewer — the svox2/opt/scripts/view_data.py equivalent (port
of ``nerf_projects_tpu/cli/view_data.py``; host numpy, matplotlib
imported at the call).

The reference renders an interactive nerfvis HTML scene of the camera
frustums + scene bbox + sparse points. nerfvis is not available offline,
so this emits the same geometry as:
  * an OBJ wireframe (cameras.obj: frustum edges, bbox, axes, points)
    loadable in any mesh viewer, and
  * a matplotlib 3D overview PNG (cameras.png).

Usage: python -m nerf_projects_tpu_torch.cli.view_data DATA_DIR [--split train]
       [--out OUT_DIR] [--scale S]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def frustum_lines(c2w: np.ndarray, fx: float, fy: float, cx: float,
                  cy: float, w: int, h: int, scale: float = 0.15):
    """Line segments (pairs of 3D points) of one camera frustum."""
    corners_px = np.array(
        [[0, 0], [w, 0], [w, h], [0, h]], np.float64
    )
    dirs = np.stack(
        [
            (corners_px[:, 0] - cx) / fx,
            (corners_px[:, 1] - cy) / fy,
            np.ones(4),
        ],
        -1,
    )
    # our loaders store OpenGL poses (-z forward); flip to OpenCV-ish ray
    dirs = dirs * np.array([1.0, -1.0, -1.0])
    world = dirs * scale @ c2w[:3, :3].T + c2w[:3, 3]
    o = c2w[:3, 3]
    lines = [(o, world[i]) for i in range(4)]
    lines += [(world[i], world[(i + 1) % 4]) for i in range(4)]
    # up indicator
    up_tip = (world[0] + world[1]) / 2 + (world[0] - world[3]) * 0.3
    lines += [(world[0], up_tip), (world[1], up_tip)]
    return lines


def bbox_lines(lo, hi):
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    corners = np.array(
        [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
         [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
         [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
         [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]]
    )
    e = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return [(corners[a], corners[b]) for a, b in e]


def write_obj(path: str, lines, points=None):
    """OBJ with `l` line elements (+ optional `p`-style point vertices)."""
    with open(path, "w") as f:
        f.write("# nerf_projects_tpu dataset viewer\n")
        n = 0
        for a, b in lines:
            f.write(f"v {a[0]:.6f} {a[1]:.6f} {a[2]:.6f}\n")
            f.write(f"v {b[0]:.6f} {b[1]:.6f} {b[2]:.6f}\n")
            f.write(f"l {n + 1} {n + 2}\n")
            n += 2
        if points is not None:
            for p in points:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
                n += 1
                f.write(f"p {n}\n")
    return path


def render_png(path: str, lines, points=None, title=""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for a, b in lines:
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                color="#4C72B0", linewidth=0.7)
    if points is not None and len(points):
        pts = np.asarray(points)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, color="#C44E52")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def view_dataset(data_dir: str, split: str = "train",
                 out_dir: str | None = None, scale: float = 0.15,
                 max_points: int = 20000):
    from nerf_projects_tpu_torch.data.base import load_scene

    scene = load_scene(data_dir, split)
    out_dir = out_dir or data_dir
    os.makedirs(out_dir, exist_ok=True)
    fx = float(scene.intrinsics[0, 0])
    fy = float(scene.intrinsics[1, 1])
    cx = float(scene.intrinsics[0, 2])
    cy = float(scene.intrinsics[1, 2])

    lines = []
    for v in range(scene.poses.shape[0]):
        lines += frustum_lines(np.asarray(scene.poses[v], np.float64),
                               fx, fy, cx, cy,
                               scene.width, scene.height, scale)
    cams = np.asarray(scene.poses)[:, :3, 3]
    r = np.abs(cams).max() * 0.5
    lines += bbox_lines([-r, -r, -r], [r, r, r])

    points = None
    pts_path = os.path.join(data_dir, "sparse", "0", "points3D.bin")
    if os.path.exists(pts_path):
        from nerf_projects_tpu_torch.data.colmap import read_points3d_binary

        xyz, _ = read_points3d_binary(pts_path)
        if len(xyz) > max_points:
            idx = np.random.default_rng(0).choice(
                len(xyz), max_points, replace=False
            )
            xyz = xyz[idx]
        points = xyz

    obj = write_obj(os.path.join(out_dir, "cameras.obj"), lines, points)
    png = render_png(
        os.path.join(out_dir, "cameras.png"), lines, points,
        title=f"{os.path.basename(data_dir.rstrip('/'))} [{split}] "
              f"{scene.poses.shape[0]} cams",
    )
    return obj, png


def main(argv=None):
    p = argparse.ArgumentParser(description="visualize dataset cameras")
    p.add_argument("data_dir")
    p.add_argument("--split", default="train")
    p.add_argument("--out", default=None)
    p.add_argument("--scale", type=float, default=0.15)
    args = p.parse_args(argv)
    obj, png = view_dataset(args.data_dir, args.split, args.out, args.scale)
    print(f"wrote {obj} and {png}")


if __name__ == "__main__":
    main()
