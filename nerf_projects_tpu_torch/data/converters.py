"""Small dataset converters + image minification (port of
``nerf_projects_tpu/data/converters.py``; host numpy, cv2 and imageio
imported at the call).

Parity targets:
  * svox2/opt/scripts/ingp2nsvf.py — instant-ngp `transforms.json` ->
    NSVF layout (pose/*.txt, intrinsics.txt, optional bbox);
  * nerf/load_llff.py:9-58 `_minify` — pre-downsampled `images_N/`
    directories (cv2 area interpolation instead of ImageMagick mogrify).
"""
from __future__ import annotations

import json
import os
import numpy as np


def ingp_to_nsvf(transforms_path: str, out_dir: str, *, scale: float = 1.0):
    """instant-ngp transforms.json -> NSVF pose/intrinsics files."""
    with open(transforms_path) as f:
        meta = json.load(f)
    os.makedirs(os.path.join(out_dir, "pose"), exist_ok=True)

    # intrinsics: either fl_x/fl_y/cx/cy or camera_angle_x
    if "fl_x" in meta:
        fx, fy = float(meta["fl_x"]), float(meta.get("fl_y", meta["fl_x"]))
        cx, cy = float(meta.get("cx", 0)), float(meta.get("cy", 0))
    else:
        w = float(meta.get("w", 800))
        fx = fy = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        cx, cy = w / 2, float(meta.get("h", 800)) / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    np.savetxt(os.path.join(out_dir, "intrinsics.txt"), K)

    for frame in meta["frames"]:
        c2w = np.asarray(frame["transform_matrix"], np.float64)
        # ngp uses OpenGL convention (-z forward); NSVF consumers here
        # store poses as-is and the loaders handle convention.
        c2w[:3, 3] *= scale
        stem = os.path.splitext(os.path.basename(frame["file_path"]))[0]
        np.savetxt(os.path.join(out_dir, "pose", stem + ".txt"), c2w)

    if "aabb_scale" in meta:
        r = float(meta["aabb_scale"]) * scale
        np.savetxt(
            os.path.join(out_dir, "bbox.txt"),
            np.array([[-r, -r, -r, r, r, r, 2 * r / 256]]),
        )
    return out_dir


def minify(root: str, factors=(2, 4, 8)):
    """Create images_N/ downsampled copies of root/images (llff _minify)."""
    import cv2
    import imageio.v2 as imageio

    src = os.path.join(root, "images")
    files = sorted(
        f for f in os.listdir(src) if f.lower().endswith(("jpg", "jpeg", "png"))
    )
    for factor in factors:
        out = os.path.join(root, f"images_{factor}")
        if os.path.isdir(out) and len(os.listdir(out)) == len(files):
            continue
        os.makedirs(out, exist_ok=True)
        for f in files:
            im = imageio.imread(os.path.join(src, f))
            h, w = im.shape[:2]
            small = cv2.resize(
                im, (w // factor, h // factor), interpolation=cv2.INTER_AREA
            )
            imageio.imwrite(os.path.join(out, f), small)
    return root


def parse_timings(path: str):
    """Parse a timings.txt (step ISO-timestamp lines) into steps/sec
    (reference plenoctree/nerf_sh/parse_timing.py)."""
    from datetime import datetime

    steps, times = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            steps.append(int(parts[0]))
            times.append(datetime.fromisoformat(parts[1]))
    if len(steps) < 2:
        return {"steps": len(steps), "steps_per_sec": None}
    dt = (times[-1] - times[0]).total_seconds()
    return {
        "steps": steps[-1] - steps[0],
        "elapsed_sec": dt,
        "steps_per_sec": (steps[-1] - steps[0]) / dt if dt > 0 else None,
    }
