"""Plenoxels optimization CLI, the svox2/opt/opt.py equivalent (port of
``nerf_projects_tpu/cli/train_plenoxels.py``).

Parity target: reference svox2/opt/opt.py:
  * the argument groups (general / optimization / losses / logging /
    rendering) with the JAX package's names and defaults (:42-273), plus
    the JSON config merge and ``--device`` (default the card);
  * grid init: z-order layout, sphere bound, init_sigma (:311-327);
  * the loop (:395-898): random ray or coherent-tile batches, fused
    render + gradient + RMSprop steps, sampled TV, the progressive
    ``reso`` upsampling schedule with ``tv_early_only``, the training
    logs (JSON, memory, TensorBoard), a final test-view PSNR, the
    checkpoint (``ckpt.npz``, svox2 schema), time_mins.txt.

``--step_mode``: ``cell`` (``PlenoxelsTrainer.train_step`` over the
SparseGrid, no kernel), ``tiles`` (``train_step_tiles_pallas``, K3 + K4,
the dense optimizer), ``sparse`` (``train/plenoxels_sparse.py::
train_step_tiles_sparse``), ``touched`` (``train_step_tiles_packed_touched``,
the touched-row optimizer or, under ``--dense_optim``, the dense sweep)
and ``flat`` (the touched step through ``flat_train``). Random draws
come from one ``torch.Generator`` on the device, seeded 20200823;
topology events (resample) run between steps on the host and the
device.

    python -m nerf_projects_tpu_torch.cli.train_plenoxels <blender dir> --step_mode touched
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

from nerf_projects_tpu_torch.cli.render_imgs import _view_rays
from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.data.base import load_scene
from nerf_projects_tpu_torch.models.grid_lifecycle import resample
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.obs.advanced_metrics import compute_fdr, compute_mcq
from nerf_projects_tpu_torch.obs.json_logger import MetricsLogger
from nerf_projects_tpu_torch.obs.memory_tracker import MemoryTracker
from nerf_projects_tpu_torch.obs.metrics import compute_metrics
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
from nerf_projects_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer
from nerf_projects_tpu_torch.utils.config import maybe_merge_config_file, save_args_snapshot

SEED = 20200823


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Plenoxels optimization (PyTorch / CUDA)")
    g = parser.add_argument_group("general")
    g.add_argument("data_dir", type=str, nargs="?", default=None)
    g.add_argument("--train_dir", "-t", type=str, default="ckpt")
    g.add_argument("--config", "-c", type=str, default=None)
    g.add_argument("--reso", type=str, default="[[256, 256, 256], [512, 512, 512]]",
                   help="list of grid resolution steps (python literal)")
    g.add_argument("--upsamp_every", type=int, default=3 * 12800)
    g.add_argument("--init_iters", type=int, default=0)
    g.add_argument("--upsample_density_add", type=float, default=0.0)
    g.add_argument("--sh_dim", type=int, default=9)
    g.add_argument("--scene_radius", type=float, default=1.5)
    g.add_argument("--device", type=str, default="cuda",
                   help="where the grid and the steps run: cuda (the card) or cpu (the plain versions)")
    g = parser.add_argument_group("optimization")
    g.add_argument("--n_iters", type=int, default=10 * 12800)
    g.add_argument("--batch_size", type=int, default=5000)
    g.add_argument("--sigma_optim", choices=["sgd", "rmsprop"], default="rmsprop")
    g.add_argument("--lr_sigma", type=float, default=3e1)
    g.add_argument("--lr_sigma_final", type=float, default=5e-2)
    g.add_argument("--lr_sigma_decay_steps", type=int, default=-1,
                   help="-1 (default): the reference's 250000/128000 decay-horizon ratio scaled to n_iters "
                   "(exactly 250000 at the default n_iters=128000): the reference trains against a horizon "
                   "longer than the run (opt.py:100), ending at lr_sigma ~1, never the fully decayed 5e-2")
    g.add_argument("--lr_sigma_delay_steps", type=int, default=-1,
                   help="-1 (default): the reference's 15000/128000 warm-up ratio scaled to n_iters; without "
                   "the delay, lr_sigma 30 overshoots the density in the first ~100 steps")
    g.add_argument("--lr_sigma_delay_mult", type=float, default=1e-2)
    g.add_argument("--sh_optim", choices=["sgd", "rmsprop"], default="rmsprop")
    g.add_argument("--lr_sh", type=float, default=1e-2)
    g.add_argument("--lr_sh_final", type=float, default=5e-6)
    g.add_argument("--lr_sh_decay_steps", type=int, default=-1,
                   help="-1: scale with n_iters (see lr_sigma_decay_steps)")
    g.add_argument("--rms_beta", type=float, default=0.95)
    g.add_argument("--rms_pervisit", type=int, default=1,
                   help="RMSprop's second moment decays once per touch instead of the reference-literal once "
                   "per global step (beta^delta lazy). The literal semantics degenerate under coherent-tile "
                   "sampling (rms collapses between bursts -> sign-sized updates); per-visit matches the "
                   "reference's effective dynamics under its global ray shuffle. Applies to the touched and "
                   "sparse steps.")
    g.add_argument("--print_every", type=int, default=20)
    g.add_argument("--save_every", type=int, default=5)
    g.add_argument("--eval_every", type=int, default=1)
    g.add_argument("--init_sigma", type=float, default=0.1)
    g = parser.add_argument_group("losses")
    g.add_argument("--lambda_tv", type=float, default=1e-5)
    g.add_argument("--tv_sparsity", type=float, default=0.01)
    g.add_argument("--lambda_tv_sh", type=float, default=1e-3)
    g.add_argument("--tv_sh_sparsity", type=float, default=0.01)
    g.add_argument("--lambda_tv_lumisphere", type=float, default=0.0)
    g.add_argument("--tv_lumisphere_sparsity", type=float, default=0.01)
    g.add_argument("--tv_lumisphere_dir_factor", type=float, default=0.0)
    g.add_argument("--lambda_l2_sh", type=float, default=0.0)
    g.add_argument("--lambda_sparsity", type=float, default=0.0, help="SNeRG/PlenOctrees ray sparsity loss weight")
    g.add_argument("--lambda_beta", type=float, default=0.0, help="neural-volumes beta distribution loss weight")
    g.add_argument("--tv_early_only", type=int, default=1, help="disable TV after the first upsample")
    g.add_argument("--density_thresh", type=float, default=5.0)
    g.add_argument("--weight_thresh", type=float, default=0.0005 * 512)
    g.add_argument("--max_grid_elements", type=int, default=44_000_000)
    g.add_argument("--thresh_type", choices=["weight", "sigma"], default="weight")
    g = parser.add_argument_group("rendering")
    g.add_argument("--step_mode", choices=["cell", "tiles", "sparse", "touched", "flat"], default="cell",
                   help="cell: per-ray step over the SparseGrid (reference-exact, no kernel); tiles: the fused "
                   "K3 + K4 tile step on a BrickGrid with the dense optimizer; sparse: the row-sparse tile "
                   "step (O(touched bricks)); touched: the packed state with the O(touched)-row lazy-exact "
                   "optimizer; flat: the touched step through the flat plan (the occupancy clip on)")
    g.add_argument("--max_touched", type=int, default=16384,
                   help="touched/flat modes: the bound on the distinct bricks a step touches (overflow drops "
                   "updates and is reported)")
    g.add_argument("--dense_optim", type=int, default=-1,
                   help="touched/flat modes: the dense-sweep optimizer (no K-row gather and scatter; exact "
                   "under per-visit rms or SGD). -1 = auto (on when eligible)")
    g.add_argument("--bf16_grad_blocks", action="store_true", default=False,
                   help="the TPU's bf16 gradient blocks; the port's gradients are float32 (accepted)")
    g.add_argument("--use_occupancy", action="store_true", default=False,
                   help="clip the tile march to the active bricks' box")
    g.add_argument("--tile_shape", type=str, default="8,16", help="tile rows,cols for the tile step modes")
    g.add_argument("--step_size", type=float, default=0.5)
    g.add_argument("--sigma_thresh", type=float, default=1e-8)
    g.add_argument("--stop_thresh", type=float, default=1e-7)
    g.add_argument("--background_brightness", type=float, default=1.0)
    g = parser.add_argument_group("logging")
    g.add_argument("--log_mse_image", action="store_true", default=False)
    g.add_argument("--log_depth_map", action="store_true", default=False)
    g.add_argument("--log_advanced_metrics", action="store_true", default=False)
    g.add_argument("--log_fdr", action="store_true", default=False)
    g.add_argument("--log_floater_viz", action="store_true", default=False,
                   help="log floater slices/overlays to TensorBoard (not ported yet)")
    g.add_argument("--floater_viz_slices", type=int, default=3)
    g.add_argument("--fdr_density_threshold", type=float, default=0.01)
    g.add_argument("--profile_dir", type=str, default=None,
                   help="capture a torch.profiler trace of a few train steps after the first two into this "
                   "directory")
    g.add_argument("--profile_steps", type=int, default=5, help="steps to include in the profiler trace")
    return parser


def _flat_view_rays(scene, v: int, device) -> Rays:
    return _view_rays(scene, v, scene.height, scene.width, device).map(lambda x: x.reshape(-1, 3))


def build_ray_pool_opencv(scene, device=None):
    """Rays for every pixel of every train view, OpenCV convention
    (dataset_base.py:37-76), with their colours: (Rays [V*H*W, 3],
    pixels [V*H*W, 3]) on ``device`` (None: the card)."""
    dev = resolve_device(device)
    views = [_flat_view_rays(scene, v, dev) for v in range(scene.images.shape[0])]
    pool = Rays(*(torch.cat(xs) for xs in zip(*views)))
    pixels = torch.from_numpy(np.ascontiguousarray(scene.images, np.float32).reshape(-1, 3)).to(dev)
    return pool, pixels


def eval_step(trainer, grid, scene, max_views=2, chunk=4096):
    """Test-view PSNR (opt.py eval_step, without TB image dumps): the
    exact per-ray render of the first ``max_views`` views."""
    psnrs = []
    for v in range(min(scene.images.shape[0], max_views)):
        flat = _flat_view_rays(scene, v, grid.device)
        with torch.no_grad():
            outs = [trainer.render_step(grid, flat.map(lambda x: x[i:i + chunk]))["rgb"]
                    for i in range(0, flat.origins.shape[0], chunk)]
        img = torch.cat(outs).reshape(scene.height, scene.width, 3)
        psnrs.append(compute_metrics(img, scene.images[v])["psnr"])
    return float(np.mean(psnrs))


def resolve_schedule(args):
    """Fill the -1 schedule sentinels from n_iters with the reference's
    ratios (opt.py:100 defaults against its 128000-step run): delay
    15000/128000, decay horizon 250000/128000. At the default n_iters
    they give the reference's values; on a shorter run they keep its
    dynamics (the warm-up's share and a horizon never fully decayed)."""
    if args.lr_sigma_decay_steps < 0:
        args.lr_sigma_decay_steps = max(1, round(args.n_iters * 250000 / 128000))
    if args.lr_sh_decay_steps < 0:
        args.lr_sh_decay_steps = max(1, round(args.n_iters * 250000 / 128000))
    if args.lr_sigma_delay_steps < 0:
        args.lr_sigma_delay_steps = round(args.n_iters * 15000 / 128000)
    return args


def run(args, *, scene=None, test_scene=None, max_iters=None):
    """Train as opt.py does; returns (grid, trainer, result dict(psnr,
    time_mins, capacity[, MCQ and FDR keys]))."""
    if args.log_floater_viz:
        raise NotImplementedError("--log_floater_viz needs obs/floater_viz.py, not ported yet (ROADMAP Queue 1, "
                                  "The rest)")
    args = resolve_schedule(args)
    dev = resolve_device(args.device)
    if scene is None:
        scene = load_scene(args.data_dir, "train")
        try:
            test_scene = load_scene(args.data_dir, "test")
        except Exception:
            test_scene = scene
    os.makedirs(args.train_dir, exist_ok=True)
    save_args_snapshot(args, args.train_dir)

    reso_schedule = ast.literal_eval(args.reso)
    reso_idx = 0
    grid = SparseGrid.create(tuple(reso_schedule[0]), basis_dim=args.sh_dim, radius=args.scene_radius,
                             use_sphere_bound=True, use_z_order=True, init_density=args.init_sigma, device=dev)
    opts = GridRenderOptions(step_size=args.step_size, sigma_thresh=args.sigma_thresh,
                             stop_thresh=args.stop_thresh, background_brightness=args.background_brightness)

    def make_trainer(tv_on=True):
        return PlenoxelsTrainer(
            opts,
            n_iters=args.lr_sigma_decay_steps,
            lr_sigma=args.lr_sigma,
            lr_sigma_final=args.lr_sigma_final,
            lr_sigma_delay_steps=args.lr_sigma_delay_steps,
            lr_sigma_delay_mult=args.lr_sigma_delay_mult,
            lr_sh=args.lr_sh,
            lr_sh_final=args.lr_sh_final,
            lambda_tv=args.lambda_tv if tv_on else 0.0,
            tv_sparsity=args.tv_sparsity,
            lambda_tv_sh=args.lambda_tv_sh if tv_on else 0.0,
            tv_sh_sparsity=args.tv_sh_sparsity,
            lambda_beta=args.lambda_beta,
            lambda_sparsity=args.lambda_sparsity,
            lambda_l2_sh=args.lambda_l2_sh,
            lambda_tv_lumisphere=args.lambda_tv_lumisphere if tv_on else 0.0,
            tv_lumisphere_sparsity=args.tv_lumisphere_sparsity,
            tv_lumisphere_dir_factor=args.tv_lumisphere_dir_factor,
            sigma_optim=args.sigma_optim,
            sh_optim=args.sh_optim,
            rms_beta=args.rms_beta,
            rms_pervisit=bool(args.rms_pervisit),
            bf16_grad_blocks=args.bf16_grad_blocks,
            use_occupancy=args.use_occupancy,
            device=dev,
        )

    trainer = make_trainer(True)
    rms = trainer.init_rms(grid)

    pool, pixels = build_ray_pool_opencv(scene, dev)
    n_pool = pixels.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw():
        idx = torch.randint(0, n_pool, (args.batch_size,), generator=gen, device=dev)
        return pool.map(lambda x: x[idx]), pixels[idx]

    # ---- the tile step modes: brick-grid state + coherent-tile draws
    tile_mode = args.step_mode in ("tiles", "sparse", "touched", "flat")
    bg = sst = rms_b = None
    if tile_mode:
        from nerf_projects_tpu_torch.ops.brick_grid import from_sparse_grid, to_sparse_grid
        from nerf_projects_tpu_torch.ops.kernels.tile_march import geometry_only
        from nerf_projects_tpu_torch.train import plenoxels_sparse as ps

        th, tw = (int(x) for x in args.tile_shape.split(","))
        V, H, Wd = scene.images.shape[:3]
        if not (1 <= th <= H and 1 <= tw <= Wd):
            raise SystemExit(f"--tile_shape {th},{tw} does not fit {H}x{Wd} images")
        n_t = max(args.batch_size // (th * tw), 1)
        dy, dx = torch.meshgrid(torch.arange(th, device=dev), torch.arange(tw, device=dev), indexing="ij")
        dy, dx = dy.reshape(-1), dx.reshape(-1)

        def draw_tiles(g=gen):
            v = torch.randint(0, V, (n_t,), generator=g, device=dev)
            y0 = torch.randint(0, H - th + 1, (n_t,), generator=g, device=dev)
            x0 = torch.randint(0, Wd - tw + 1, (n_t,), generator=g, device=dev)
            flat = v[:, None] * (H * Wd) + (y0[:, None] + dy[None]) * Wd + (x0[:, None] + dx[None])
            return pool.map(lambda a: a[flat]), pixels[flat]

        flat_cap = {"w": 0}
        # the dense-sweep optimizer (-1 auto): on for touched/flat under
        # per-visit rms or SGD, the JAX package's rule (its K-row gather
        # and scatter measured ~5.5 us a row on the TPU)
        dense_optim = bool(args.dense_optim if args.dense_optim >= 0 else (
            args.step_mode in ("touched", "flat") and (bool(args.rms_pervisit) or args.sigma_optim == "sgd")))

        def build_tile_state(g):
            nonlocal bg, sst, rms_b
            full = from_sparse_grid(g)
            if args.step_mode == "sparse":
                sst = ps.sparse_state_from_grid(full)
            elif args.step_mode in ("touched", "flat"):
                sst = ps.packed_state_from_grid(full)
                if args.step_mode == "flat":
                    # the TPU plan's window capacity from a probe batch
                    # (+50%, 64-aligned), sized at every topology change;
                    # the port marches without a plan and ignores it
                    from nerf_projects_tpu_torch.ops.kernels.flat_train import required_windows

                    probe = draw_tiles(torch.Generator(device=dev).manual_seed(7))[0]
                    w = required_windows(full, probe, trainer.opts)
                    flat_cap["w"] = max(64, -(-(w * 3 // 2) // 64) * 64)
            else:
                rms_b = trainer.init_rms_bricks(full)
            bg = full if args.step_mode == "tiles" else geometry_only(full)

        def materialize_grid():
            if args.step_mode == "sparse":
                return to_sparse_grid(ps.grid_from_sparse_state(bg, sst))
            if args.step_mode in ("touched", "flat"):
                return to_sparse_grid(ps.grid_from_packed_state(bg, sst))
            return to_sparse_grid(bg)

        build_tile_state(grid)

    logger = MetricsLogger(args.train_dir)
    tracker = MemoryTracker()
    from nerf_projects_tpu_torch.obs.tb import SummaryWriter

    tb = SummaryWriter(os.path.join(args.train_dir, "tb"))
    t_start = time.time()
    n_iters = max_iters if max_iters is not None else args.n_iters
    cameras = [(scene.poses[v], scene.intrinsics, scene.height, scene.width) for v in range(scene.images.shape[0])]
    from nerf_projects_tpu_torch.utils.timing import profiler_trace

    prof = None
    prof_window = (3, 3 + args.profile_steps) if args.profile_dir else None
    for step in range(1, n_iters + 1):
        if prof_window and step == prof_window[0]:
            prof = profiler_trace(args.profile_dir)
            prof.__enter__()
        if prof is not None and (step == prof_window[1] or step == n_iters):
            prof.__exit__(None, None, None)
            prof = None
        if args.step_mode == "cell":
            rays, target = draw()
            grid, rms, stats = trainer.train_step(grid, rms, rays, target, step, gen)
        elif args.step_mode == "tiles":
            rays, target = draw_tiles()
            bg, rms_b, stats = trainer.train_step_tiles_pallas(bg, rms_b, rays, target, step, gen)
        elif args.step_mode in ("touched", "flat"):
            rays, target = draw_tiles()
            sst, stats = ps.train_step_tiles_packed_touched_jit(
                trainer, bg, sst, rays, target, step, gen, max_touched=args.max_touched,
                use_occupancy=args.use_occupancy, flat_windows=flat_cap["w"] or None, dense_optim=dense_optim)
        else:  # sparse
            rays, target = draw_tiles()
            sst, stats = ps.train_step_tiles_sparse_jit(trainer, bg, sst, rays, target, step, gen,
                                                        use_occupancy=args.use_occupancy)
        if step % args.print_every == 0:
            tb.scalar("train/mse", stats["mse"], step)
            tb.scalar("train/psnr", stats["psnr"], step)
            snap = tracker.capture_snapshot(step)
            logger.log_training_step(step, {k: float(v) for k, v in stats.items()},
                                     float(trainer.lr_sigma_fn(step)),
                                     memory_metrics=tracker.get_memory_metrics(snap))
        # progressive upsampling (opt.py:855-887)
        if step % args.upsamp_every == 0 and reso_idx + 1 < len(reso_schedule):
            reso_idx += 1
            kwargs = dict(dilate=2, max_elements=args.max_grid_elements)
            if args.thresh_type == "weight":
                kwargs.update(cameras=cameras, weight_thresh=args.weight_thresh / 512)
            else:
                kwargs.update(sigma_thresh=args.density_thresh)
            if tile_mode:
                grid = materialize_grid()
                bg = sst = rms_b = None  # free the old topology's state first
            grid = resample(grid, tuple(reso_schedule[reso_idx]), **kwargs)
            if args.upsample_density_add:
                grid = replace(grid, density_data=grid.density_data + args.upsample_density_add)
            if args.tv_early_only:
                trainer = make_trainer(tv_on=False)
            rms = trainer.init_rms(grid)
            if tile_mode:
                build_tile_state(grid)
    if prof is not None:  # the window reached past n_iters
        prof.__exit__(None, None, None)
    # final eval + save (opt.py:889-898)
    if tile_mode:
        grid = materialize_grid()
    psnr = eval_step(trainer, grid, test_scene or scene)
    grid.save(os.path.join(args.train_dir, "ckpt.npz"))
    mins = (time.time() - t_start) / 60.0
    with open(os.path.join(args.train_dir, "time_mins.txt"), "w") as f:
        f.write(f"{mins:.4f}\n")
    with open(os.path.join(args.train_dir, "test_psnr.txt"), "w") as f:
        f.write(f"{psnr:.4f}\n")
    result = {"psnr": psnr, "time_mins": mins, "capacity": grid.capacity}
    if args.log_advanced_metrics or args.log_fdr:
        mem = tracker.get_memory_metrics()
        result.update(compute_mcq(psnr, mem["device_peak_memory_gb"] * 1024))
        result.update(compute_fdr(grid, threshold=0.01, min_object_size=100))
    logger.log_evaluation_step(n_iters, {"psnr": psnr})
    return grid, trainer, result


def main(argv=None):
    args = maybe_merge_config_file(build_parser().parse_args(argv))
    _, _, result = run(args)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
