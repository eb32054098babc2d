"""NeRF-SH training CLI, the ``python -m nerf_sh.train`` equivalent (port
of ``nerf_projects_tpu/cli/train_nerf_sh.py``).

Parity target: reference plenoctree/nerf_sh/train.py:134-382 ``main``:
flag/YAML config (PyYAML imported only when a config file is read), the
dataset's ray pool on the trainer's device, the train step, periodic
logging (rays/s, JSON metrics, memory snapshots, timings.txt), the
checkpoint (``checkpoint.pt``, written by ``torch.save``: the step, the
model's state dict, Adam's state and the state's generator) and a
periodic test-image render with PSNR/SSIM.

    python -m nerf_projects_tpu_torch.cli.train_nerf_sh --train_dir DIR --data_dir SCENE \
        [--config flags.yaml] [--device cpu] [--<flag> value ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Union

import torch
import torch.nn.functional as F

from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays, camera_rays
from nerf_projects_tpu_torch.data.base import load_scene
from nerf_projects_tpu_torch.obs.json_logger import MetricsLogger
from nerf_projects_tpu_torch.obs.memory_tracker import MemoryTracker
from nerf_projects_tpu_torch.obs.metrics import compute_metrics
from nerf_projects_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from nerf_projects_tpu_torch.train.nerf_sh_trainer import NeRFSHTrainer
from nerf_projects_tpu_torch.utils.config import check_flags, update_flags
from nerf_projects_tpu_torch.utils.timing import profiler_trace


def build_ray_pool(scene, device: Optional[Union[str, torch.device]] = None):
    """Every pixel's ray (pixel centres at +0.5) and colour of a scene
    split: (Rays of [V*H*W, 3], rgb [V*H*W, 3]) on ``device``."""
    all_rays, all_rgb = [], []
    for v in range(scene.images.shape[0]):
        rays = camera_rays(scene.height, scene.width, scene.intrinsics, scene.poses[v], pixel_center=0.5,
                           device=device)
        all_rays.append(rays.map(lambda x: x.reshape(-1, 3)))
        all_rgb.append(torch.as_tensor(scene.images[v].reshape(-1, 3), device=all_rays[-1].origins.device))
    pool = Rays(*(torch.cat(xs) for xs in zip(*all_rays)))
    return pool, torch.cat(all_rgb)


def render_image_sh(trainer, model, scene, view: int, chunk: int = 8192,
                    device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """The rgb [H, W, 3] of one view through ``trainer.render_eval`` in
    requests of ``chunk`` rays; the last request is padded with copies of
    its last ray, as the reference pads it, and cut back."""
    rays = camera_rays(scene.height, scene.width, scene.intrinsics, scene.poses[view], pixel_center=0.5,
                       device=device)
    flat = rays.map(lambda x: x.reshape(-1, 3))
    n = flat.origins.shape[0]
    outs = []
    for i in range(0, n, chunk):
        sl = flat.map(lambda x: x[i: i + chunk])
        pad = chunk - sl.origins.shape[0]
        if pad:
            sl = sl.map(lambda x: F.pad(x[None], (0, 0, 0, pad), mode="replicate")[0])
        out = trainer.render_eval(model, sl)["rgb"]
        outs.append(out[: chunk - pad] if pad else out)
    return torch.cat(outs).reshape(scene.height, scene.width, 3)


def train_main(flags: NeRFSHFlags, *, scene=None, test_scene=None, max_steps=None, seed: int = 20200823,
               device: Optional[Union[str, torch.device]] = None):
    """Train per ``flags`` on ``device`` (``None``: the card). Returns
    (trainer, state, scene, test_scene)."""
    dev = resolve_device(device)
    if flags.config:
        update_flags(flags, flags.config)
    check_flags(flags, require_data=scene is None,
                n_devices=torch.cuda.device_count() if dev.type == "cuda" else 1)
    if scene is None:
        kwargs = {}
        if flags.dataset == "blender":
            kwargs = dict(white_bkgd=flags.white_bkgd)
        elif flags.dataset == "llff":
            kwargs = dict(factor=flags.factor, spherify=flags.spherify,
                          llffhold=flags.llffhold)
        scene = load_scene(flags.data_dir, "train", **kwargs)
        try:
            test_scene = load_scene(flags.data_dir, "test", **kwargs)
        except Exception:
            test_scene = scene

    os.makedirs(flags.train_dir, exist_ok=True)
    # Persist the resolved flags so downstream tools (eval, octree
    # extraction) reconstruct the exact same model architecture.
    with open(os.path.join(flags.train_dir, "flags.json"), "w") as f:
        json.dump(dataclasses.asdict(flags), f, indent=2)
    model = build_model(flags)
    trainer = NeRFSHTrainer(
        model,
        lr_init=flags.lr_init,
        lr_final=flags.lr_final,
        max_steps=flags.max_steps,
        lr_delay_steps=flags.lr_delay_steps,
        lr_delay_mult=flags.lr_delay_mult,
        sparsity_weight=flags.sparsity_weight,
        sparsity_length=flags.sparsity_length,
        sparsity_npoints=flags.sparsity_npoints,
        sparsity_radius=flags.sparsity_radius,
        weight_decay_mult=flags.weight_decay_mult,
        randomized=flags.randomized,
        device=dev,
    )
    state = trainer.init_state(seed)

    # resume
    ckpt = os.path.join(flags.train_dir, "checkpoint.pt")
    if os.path.exists(ckpt):
        state = load_checkpoint(ckpt, state)

    pool, pixels = build_ray_pool(scene, device=dev)
    n_pool = pixels.shape[0]

    def draw(generator):
        idx = torch.randint(0, n_pool, (flags.batch_size,), generator=generator, device=dev)
        return pool.map(lambda x: x[idx]), pixels[idx]

    logger = MetricsLogger(flags.train_dir, clean_existing=state.step == 0)
    tracker = MemoryTracker()
    timings_path = os.path.join(flags.train_dir, "timings.txt")

    n_steps = max_steps if max_steps is not None else flags.max_steps
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    last_t = time.time()
    start = state.step
    prof = None
    prof_open = start + 2 if flags.profile_dir else None  # after the first steps' warm-up
    for i in range(start, n_steps):
        if prof_open is not None and i == prof_open:
            prof = profiler_trace(flags.profile_dir)
            prof.__enter__()
        if prof is not None and i >= prof_open + flags.profile_steps:
            prof.__exit__(None, None, None)
            prof = None
        rays, target = draw(generator)
        state, stats = trainer.train_step(state, rays, target)
        step = i + 1
        if step % flags.print_every == 0:
            host_stats = {k: float(v) for k, v in stats.items()}
            now = time.time()
            interval = max(now - last_t, 1e-9)
            last_t = now
            logger.log_training_step(
                step,
                host_stats,
                float(trainer.schedule(step)),
                timing_info={
                    "rays_per_sec": flags.batch_size * flags.print_every / interval,
                    "steps_per_sec": flags.print_every / interval,
                },
                memory_metrics=tracker.get_memory_metrics(
                    tracker.capture_snapshot(step)
                ),
            )
            with open(timings_path, "a") as f:
                from datetime import datetime

                f.write(f"{step} {datetime.now().isoformat()}\n")
        if step % flags.save_every == 0 or step == n_steps:
            save_checkpoint(ckpt, state)
        if flags.render_every > 0 and step % flags.render_every == 0 and test_scene is not None:
            img = render_image_sh(trainer, state.model, test_scene, 0, chunk=flags.chunk, device=dev)
            m = compute_metrics(img, test_scene.images[0])
            logger.log_evaluation_step(step, m)
    if prof is not None:
        prof.__exit__(None, None, None)
    return trainer, state, scene, test_scene


def flag_parser(description: str) -> argparse.ArgumentParser:
    """One ``--<flag>`` per NeRFSHFlags field (bools read "1"/"true"),
    and ``--device`` (default: the card)."""
    p = argparse.ArgumentParser(description=description)
    for f in dataclasses.fields(NeRFSHFlags):
        name = f.name
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true"),
                           default=f.default)
        else:
            typ = type(f.default) if f.default is not None else str
            p.add_argument(f"--{name}", type=typ, default=f.default)
    p.add_argument("--device", type=str, default=None, help="torch device (default: the card)")
    return p


def flags_from(ns) -> NeRFSHFlags:
    return NeRFSHFlags(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(NeRFSHFlags)})


def main(argv=None):
    p = flag_parser("Train NeRF-SH (H100)")
    p.add_argument("--smoke_steps", type=int, default=None)
    ns = p.parse_args(argv)
    return train_main(flags_from(ns), max_steps=ns.smoke_steps, device=ns.device)


if __name__ == "__main__":
    main()
