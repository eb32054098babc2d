"""The vanilla-NeRF training loop (port of
``nerf_projects_tpu/train/loop.py``): the notebook's `train()` (reference
nerf/nerf.ipynb cell 19) as a function over ``NeRFTrainer``.

  * the dataset loaded by type, with each family's near/far;
  * use_batching (a shuffled ray pool of every image) or per-image
    sampling with the precrop_iters / precrop_frac central-crop warm-up;
    the pool, the per-view rays and the crop ids are built once, on the
    trainer's device, and a step draws its rays there from a generator
    seeded with 1 on every call (as the JAX loop remakes PRNGKey(1));
  * checkpoints ``{step:09d}.pt`` written by ``torch.save``: the step,
    both models' state dicts, Adam's state and the state's generator;
    reloaded with the step counter;
  * JSONL and CSV training logs, MetricsLogger entries, memory snapshots
    and TensorBoard scalars at i_print, and a testset render with its
    metrics JSON at i_testset.

A step makes no host tensor and waits for the card only in its i_print,
i_weights and i_testset branches. ``trainer_kwargs`` passes the
``NeRFTrainer`` constructor's route arguments (``use_fused_mlp``,
``use_mega``, ``compute_dtype``, ``mega_rc``, ``mega_rf``) through; by
default the loop trains by autograd, as the JAX loop does.
"""
from __future__ import annotations

import csv
import json
import os
import time
import warnings
from typing import Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.rays import Rays, camera_rays, ndc_rays
from nerf_projects_tpu_torch.data.base import SceneData, load_scene
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
from nerf_projects_tpu_torch.obs.json_logger import MetricsLogger
from nerf_projects_tpu_torch.obs.memory_tracker import MemoryTracker
from nerf_projects_tpu_torch.obs.metrics import compute_metrics, to8b
from nerf_projects_tpu_torch.obs.tb import SummaryWriter
from nerf_projects_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from nerf_projects_tpu_torch.train.nerf_trainer import NeRFTrainer

Device = Optional[Union[str, torch.device]]


def _scene_from_config(cfg) -> tuple:
    kind = cfg.dataset_type
    kwargs = {}
    if kind == "blender":
        kwargs = dict(half_res=cfg.half_res, testskip=cfg.testskip,
                      white_bkgd=cfg.white_bkgd)
    elif kind == "llff":
        kwargs = dict(factor=cfg.factor, spherify=cfg.spherify,
                      llffhold=cfg.llffhold, ndc=not cfg.no_ndc)
    elif kind in ("LINEMOD", "linemod"):
        kwargs = dict(half_res=cfg.half_res, testskip=cfg.testskip,
                      white_bkgd=cfg.white_bkgd)
    elif kind == "deepvoxels":
        kwargs = dict(scene=cfg.shape, testskip=cfg.testskip)
    train = load_scene(cfg.datadir, "train", **kwargs)
    try:
        test = load_scene(cfg.datadir, "test", **kwargs)
    except Exception:
        test = train
    return train, test


def _view_rays(scene: SceneData, height: int, width: int, K, v: int, device: Device) -> Rays:
    """View v's [H, W] rays, warped to NDC for an NDC scene."""
    rays = camera_rays(height, width, K, scene.poses[v], device=device)
    if scene.ndc:
        o, d = ndc_rays(height, width, float(K[0, 0]), 1.0, rays.origins, rays.directions)
        rays = Rays(o, d, rays.viewdirs)
    return rays


def _per_view_rays(scene: SceneData, device: Device = None):
    """[V, H*W] per-view rays and pixels (the no_batching path)."""
    all_rays, all_rgb = [], []
    for v in range(scene.images.shape[0]):
        rays = _view_rays(scene, scene.height, scene.width, scene.intrinsics, v, device)
        all_rays.append(rays.map(lambda x: x.reshape(-1, 3)))
        all_rgb.append(torch.as_tensor(scene.images[v].reshape(-1, 3), device=rays.origins.device))
    return Rays(*(torch.stack(xs) for xs in zip(*all_rays))), torch.stack(all_rgb)


def _precrop_pixel_ids(height, width, frac, device: Device = None) -> torch.Tensor:
    """Flat pixel ids of the central crop (cell 19 §7 precrop)."""
    dh = int(height // 2 * frac)
    dw = int(width // 2 * frac)
    ys = np.arange(height // 2 - dh, height // 2 + dh)
    xs = np.arange(width // 2 - dw, width // 2 + dw)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return torch.as_tensor((yy * width + xx).reshape(-1), device=device)


def _build_ray_pool(scene: SceneData, device: Device = None):
    """The ray pool of every image (the use_batching path, cell 19 §6)."""
    rays, rgb = _per_view_rays(scene, device)
    return rays.map(lambda x: x.reshape(-1, 3)), rgb.reshape(-1, 3)


def _draw_ids(generator: torch.Generator, high: int, n: int) -> torch.Tensor:
    """n ids in [0, high) from ``generator``, on its device."""
    return torch.randint(0, high, (n,), generator=generator, device=generator.device)


def make_draw(cfg, scene: SceneData, device: Device = None):
    """The step's ray draw: draw(generator, in_precrop) -> (rays [N_rand],
    target [N_rand, 3]). Its pool (or its per-view rays and crop ids) is
    built here, once, on ``device``; a draw is a randint and a gather
    there. ``in_precrop`` is a host bool."""
    if not getattr(cfg, "no_batching", False):
        pool_rays, pool_rgb = _build_ray_pool(scene, device)
        n_pool = pool_rgb.shape[0]

        def draw(generator, in_precrop):
            idx = _draw_ids(generator, n_pool, cfg.N_rand)
            return pool_rays.map(lambda x: x[idx]), pool_rgb[idx]

        return draw

    # per-image sampling with the central-crop warm-up (cell 19 §7)
    view_rays, view_rgb = _per_view_rays(scene, device)
    n_views, n_pix = view_rgb.shape[:2]
    flat_rays, flat_rgb = view_rays.map(lambda x: x.reshape(-1, 3)), view_rgb.reshape(-1, 3)
    precrop_ids = _precrop_pixel_ids(scene.height, scene.width, cfg.precrop_frac, view_rgb.device)

    def draw(generator, in_precrop):
        v = _draw_ids(generator, n_views, 1)
        if in_precrop:
            idx = precrop_ids[_draw_ids(generator, precrop_ids.shape[0], cfg.N_rand)]
        else:
            idx = _draw_ids(generator, n_pix, cfg.N_rand)
        idx = v * n_pix + idx
        return flat_rays.map(lambda x: x[idx]), flat_rgb[idx]

    return draw


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".pt"))
    return os.path.join(ckpt_dir, files[-1]) if files else None


def make_trainer(cfg, scene: SceneData, trainer_kwargs=None, device: Device = None) -> NeRFTrainer:
    """The ``NeRFTrainer`` that ``train`` builds from the config and the
    scene's near/far; ``trainer_kwargs`` are its route arguments."""
    render_cfg = NeRFRenderConfig(
        num_coarse_samples=cfg.N_samples,
        num_fine_samples=cfg.N_importance,
        multires=cfg.multires if cfg.i_embed != -1 else 0,
        multires_views=cfg.multires_views if cfg.i_embed != -1 else 0,
        use_viewdirs=cfg.use_viewdirs,
        lindisp=cfg.lindisp,
        perturb=cfg.perturb > 0,
        raw_noise_std=cfg.raw_noise_std,
        white_bkgd=cfg.white_bkgd,
    )
    return NeRFTrainer(
        render_cfg,
        depth=cfg.netdepth,
        width=cfg.netwidth,
        lrate=cfg.lrate,
        lrate_decay=cfg.lrate_decay,
        near=scene.near,
        far=scene.far,
        device=device,
        **(trainer_kwargs or {}),
    )


def train(cfg, *, max_iters: Optional[int] = None, scene=None, test_scene=None, trainer_kwargs=None,
          device: Device = None):
    """Run vanilla-NeRF training per config on ``device`` (``None``: the
    card). Returns (trainer, state)."""
    if scene is None:
        scene, test_scene = _scene_from_config(cfg)
    if test_scene is None:
        test_scene = scene

    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    os.makedirs(exp_dir, exist_ok=True)

    trainer = make_trainer(cfg, scene, trainer_kwargs, device)
    state = trainer.init_state(0)

    # checkpoint reload (cell 17:44-62)
    if not cfg.no_reload:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            state = load_checkpoint(latest, state)

    draw = make_draw(cfg, scene, trainer.device)

    logger = MetricsLogger(exp_dir, clean_existing=state.step == 0)
    tracker = MemoryTracker()
    tb = SummaryWriter(os.path.join(exp_dir, "tb"))
    jsonl_path = os.path.join(exp_dir, "training_log.jsonl")
    csv_path = os.path.join(exp_dir, "training_log.csv")
    if state.step == 0:
        for p in (jsonl_path, csv_path):
            if os.path.exists(p):
                os.remove(p)

    n_iters = max_iters if max_iters is not None else cfg.N_iters
    generator = torch.Generator(device=trainer.device).manual_seed(1)
    t_start = time.time()
    last_log_t = t_start
    for i in range(state.step, n_iters):
        rays, target = draw(generator, i < cfg.precrop_iters)
        state, stats = trainer.train_step(state, rays, target)

        step = i + 1
        if step % cfg.i_print == 0:
            loss = float(stats["loss"])
            psnr = float(stats["psnr"])
            now = time.time()
            rays_per_s = cfg.N_rand * cfg.i_print / max(now - last_log_t, 1e-9)
            last_log_t = now
            entry = {
                "step": step,
                "loss": loss,
                "psnr": psnr,
                "lrate": float(trainer.schedule(step)),
                "rays_per_sec": rays_per_s,
                "elapsed_sec": now - t_start,
            }
            with open(jsonl_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
            write_header = not os.path.exists(csv_path)
            with open(csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(entry.keys()))
                if write_header:
                    w.writeheader()
                w.writerow(entry)
            tb.scalar("train/loss", loss, step)
            tb.scalar("train/psnr", psnr, step)
            tb.scalar("train/rays_per_sec", rays_per_s, step)
            snap = tracker.capture_snapshot(step)
            logger.log_training_step(
                step, {"loss": loss, "psnr": psnr},
                float(trainer.schedule(step)),
                timing_info={"rays_per_sec": rays_per_s},
                memory_metrics=tracker.get_memory_metrics(snap),
            )

        if step % cfg.i_weights == 0 or step == n_iters:
            save_checkpoint(os.path.join(ckpt_dir, f"{step:09d}.pt"), state)

        if step % cfg.i_testset == 0 and test_scene is not None:
            run_testset_eval(cfg, trainer, state, test_scene, exp_dir, step, logger)

    return trainer, state


def run_testset_eval(cfg, trainer, state, test_scene, exp_dir, step, logger=None):
    """Render the test set and its metrics (cell 13 render_path
    equivalent) through ``trainer.render_image``, which evaluates the
    modules as the reference does. A view's PNG is written when imageio
    is there (the card's machine has none; a warning says so)."""
    out_dir = os.path.join(exp_dir, f"testset_{step:06d}")
    os.makedirs(out_dir, exist_ok=True)
    factor = max(1, cfg.render_factor) if cfg.render_factor else 1
    H, W = test_scene.height // factor, test_scene.width // factor
    K = test_scene.intrinsics / factor
    K[2, 2] = 1.0
    results = []
    for v in range(test_scene.images.shape[0]):
        rays = _view_rays(test_scene, H, W, K, v, trainer.device)
        out = trainer.render_image(state.params, rays)
        gt = test_scene.images[v]
        if factor > 1:
            import cv2

            gt = cv2.resize(np.asarray(gt), (W, H), interpolation=cv2.INTER_AREA)
        m = compute_metrics(out["rgb"], gt)
        results.append(m)
        try:
            import imageio.v2 as imageio

            imageio.imwrite(os.path.join(out_dir, f"{v:03d}.png"), to8b(out["rgb"]))
        except Exception as e:
            warnings.warn(f"run_testset_eval writes no PNG: {e!r}")
    summary = {k: float(np.mean([r[k] for r in results])) for k in results[0]}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump({"per_image": results, "mean": summary, "step": step}, f, indent=2)
    if logger is not None:
        logger.log_evaluation_step(step, summary)
    return summary
