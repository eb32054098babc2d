"""Render-path video generation (port of
``nerf_projects_tpu/pipeline/video.py``).

Parity target: reference plenoctree/nerf_sh/gen_video.py:108-176 and the
notebook's i_video spiral renders: render a pose path with any
image-render function and write the frames and an animation. Without an
mp4 writer (no ffmpeg) the animation falls back to a GIF; the frame PNGs
are written either way. ``imageio`` is imported at the call: the machine
that renders need not have it, as long as the files are written where it
is.
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

from nerf_projects_tpu_torch.obs.metrics import to8b


def render_video(
    render_image_fn: Callable,
    poses: Sequence,
    out_dir: str,
    *,
    fps: int = 30,
    basename: str = "video",
    save_frames: bool = True,
):
    """render_image_fn(c2w) -> [H, W, 3] float image (a tensor on any
    device, or an array). Writes ``{basename}_{i:03d}.png`` per pose (with
    ``save_frames``) and ``{basename}.mp4``, or ``{basename}.gif`` where no
    mp4 writer is; returns (frame paths, the animation's path)."""
    import imageio.v2 as imageio

    os.makedirs(out_dir, exist_ok=True)
    frames, frame_paths = [], []
    for i, pose in enumerate(poses):
        img = to8b(render_image_fn(pose))
        frames.append(img)
        if save_frames:
            p = os.path.join(out_dir, f"{basename}_{i:03d}.png")
            imageio.imwrite(p, img)
            frame_paths.append(p)
    anim_path = os.path.join(out_dir, f"{basename}.mp4")
    try:
        imageio.mimwrite(anim_path, frames, fps=fps)
    except Exception:
        anim_path = os.path.join(out_dir, f"{basename}.gif")
        imageio.mimwrite(anim_path, frames, duration=1000.0 / fps, loop=0)
    return frame_paths, anim_path

