#!/usr/bin/env python3
"""Drive the PyTorch port's vanilla-NeRF serving and training paths and its
Plenoxels serving and training paths on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

  build   nvcc compiles the five kernel libraries for sm_90a, one
          process per source, all at once.
  kernel  each kernel against its plain PyTorch version on the card,
          then timed with CUDA events beside its bound and its plain
          version: the fused-MLP forward (K1f) on 8192 + 37 rows and at
          the render's fine level (786,432 rows); its weight-gradient
          backward (K1b) on 8192 + 37 rows (also against float64 sums)
          and at a training step's fine level (294,912 rows); the fused
          train level (K2) at a training step's coarse level (S 96, R 8,
          1,024 rays, with weights), fine level (S 288, R 4) and once
          with encoded inputs.
  render  requests of 4096 rays (64x64 patches of three 800x800 Blender
          cameras from pose_spherical) through NeRFTrainer.render_image
          with use_fused_mlp=True, at the Blender lego configuration of
          the reference: 8x256 MLPs with viewdirs, multires 10/4, 64
          coarse + 128 fine samples, white background, separate coarse
          and fine models, random weights and biases from a seed. One
          request per camera first (these outputs are checked), then
          requests back to back for WINDOW_S seconds, timed as all rays
          over all time. The launch counters are zeroed just before and
          read just after; the outputs are checked against the same
          render through the kernel's plain version and through the
          float32 modules.
  train   NeRFTrainer at the flagship training configuration (bench.py's:
          96 + 192 samples, 1,024 rays a step from the pool of
          make_dataset(n_views=2, image_size=128), Adam at 5e-4 with
          exponential decay): one step of each route on 64 rays against
          the plain versions, then each route trained for WINDOW_S
          seconds after a few warm steps — the fused train level
          (use_mega, K2) and the fused MLP under autograd (K1f + K1b) —
          with rays/s, step times, the first and last loss and PSNR, the
          launch counts (zeroed just before, read just after; the loss
          must fall and stay finite), then a short torch.profiler trace
          of each route splitting the card's time into the hand-written
          kernels and the rest.
  kernel_march
          the Plenoxels tile march (K3) against its plain PyTorch version
          on the card: a random 32^3 grid (basis_dim 9) with tiles of 128,
          256 and 512 rays, then one 800x800 frame at 512^3 (the fog scene
          below) in 16x32-ray tiles, compared tile by tile; then that
          frame's march timed with CUDA events beside its bound (the
          bricks it touches and its rays over HBM bandwidth, its samples'
          float operations over the float32 rate) and the plain version.
  render_plenoxels
          render_frame_pallas (one K3 launch a frame, per-ray early stop)
          at bench.py's two frame configurations: 512^3, basis_dim 9,
          step 0.5, 800x800 frames from bench.py's frame_tiles poses, on
          the fog scene (density U[0, 2], SH N(0, 0.2^2) on every cell of
          the sphere) and the opaque shell (bricks at radius 0.85-1.02,
          density U[500, 1500]); both grids are built on the card. Frames
          run back to back for WINDOW_S seconds; frames/s, ms a frame,
          bricks, GB on the card, K3 launches (zeroed just before, read
          just after) and samples marched; a few tiles of the first frame
          of each scene are checked against the plain version.
  kernel_march_bwd
          the tile march's backward (K4) against its plain PyTorch
          version on the card: a random 32^3 grid whose rays stop
          (density U[20, 60]) with tiles of 128, 256 and 512 rays, the
          bias and sigmoid decodes, the beta and sparsity losses off and
          on; then one training batch of the fog scene at 256^3 (40
          tiles of 8x16 rays); each gradient tensor within BWD_FRO_TOL
          (relative Frobenius) and BWD_MAX_TOL of its largest entry.
          Then that batch's backward timed with CUDA events beside its
          bound, the plain version, the same kernel without its atomics
          (tile_march_bwd_probe) and the forward (K3).
  train_plenoxels
          PlenoxelsTrainer.train_step_tiles_pallas (K3 + K4, sampled TV,
          RMSprop) at bench.py's two training configurations: fog 256^3
          (plenoxels_train: 40 tiles of 8x16 rays a step from
          bench.py's _tile_rays, target 0.4) and the shell at 512^3
          (plenoxels_train_sparse512's scene: bricks at radius
          0.85-1.02, 128 tiles a step), basis_dim 9, step 0.5, float32
          masters built on the card in chunks (density U[0, 2], SH
          N(0, 0.2^2)). First one step's gradients and updated masters
          against the same step through the plain versions; then 3 warm
          steps and steps back to back for WINDOW_S seconds, a CUDA event
          after each: train rays/s, step ms median, min and max, the K3
          and K4 launches (zeroed just before, read just after), the
          first and last MSE (the loss must fall and stay finite).

Output: progress lines, a `{"kernels": [...]}` JSON line, the card's
name and power limit as nvidia-smi gives them, and last
`{"ok": true, "device": {...}}`. Without a card it exits non-zero and
prints no result. A watchdog ends the process if it runs past
WATCHDOG_S seconds.
"""
from __future__ import annotations

import copy
import dataclasses
import faulthandler
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
WATCHDOG_S = 600
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
SIZE, FOCAL = 800, 1111.11  # Blender synthetic camera
PATCH = 64                  # 64x64 = 4096 rays per request
REQUESTS = ((0.0, 368, 368), (120.0, 300, 420), (240.0, 420, 300))  # theta, row, col
WINDOW_S = 3.0              # timed render window
BIAS_STD = 0.2              # flax init zeroes biases; trained models do not have zero biases
KERNEL_TOL = 1e-2           # max |err| / (mean |plain| + 1)
RGB_TOL = 1e-2
MAX_TAIL_FLIPS = 0.01       # share of rays
GRAD_FRO_TOL = 2e-2         # |err|_F / |plain|_F of each gradient tensor
GRAD_MAX_TOL = 5e-2         # largest |err| / largest |plain| of each gradient tensor
NOISE_FACTOR = 2.0          # kernel vs float64 sums, over float32 plain vs float64 sums
TRAIN_TOL = 2e-3            # rgb, acc, weights of a train level (tests/test_fused_train.py)
TRAIN_RAYS = 1024           # rays per training step
COARSE, FINE = 96, 192      # samples per ray: the flagship training configuration
MEGA_RC, MEGA_RF = 8, 4     # rays per block of the per-ray inputs, coarse and fine
WARM_STEPS = 3              # training steps before the timed window
CHECK_RAYS = 64             # rays of the one-step check against the plain versions
PROFILE_STEPS = 5           # traced training steps per route


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_biases(model, gen: torch.Generator):
    """Every bias from a seeded normal, so that the checks see where the
    kernel reads each one."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * BIAS_STD)
    return model


def encodings(n: int, gen: torch.Generator, device) -> tuple:
    """Random [n, 64] / [n, 32] inputs laid out as fused_apply pads them."""
    x = torch.zeros(n, 64)
    x[:, :63] = torch.randn(n, 63, generator=gen)
    v = torch.zeros(n, 32)
    v[:, :27] = torch.randn(n, 27, generator=gen)
    return x.to(device), v.to(device)


LIBRARIES = ("fused_mlp_fwd", "fused_mlp_bwd", "fused_train", "tile_march_fwd", "tile_march_bwd")


def phase_build():
    from nerf_projects_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    builds = _build.build_all(LIBRARIES)  # one nvcc per source, all at once
    for name, b in builds.items():
        log(f"build: {name} {b.seconds:.1f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    return time.perf_counter() - t0


def check_grads(tag, got, want, names, exact=None) -> float:
    """Each gradient tensor of the kernel against the plain version's:
    relative Frobenius error below GRAD_FRO_TOL and the largest entry's
    error below GRAD_MAX_TOL of the largest |plain|. The two round to bf16
    at the same points and sum float32 in another order, so a relu mask
    or a bf16 rounding that flips moves a whole column of dW. With
    ``exact`` (the plain version with float64 sums, on the same output
    gradient), the kernel must also be no further from it than
    NOISE_FACTOR times the float32 plain version is (+ 1e-5). Returns the
    largest absolute error."""
    max_abs, worst = 0.0, {"fro": (0.0, ""), "max": (0.0, ""), "noise": (0.0, "")}
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag}: non-finite gradient {name}")
        d = (g - w).double()
        max_abs = max(max_abs, float(d.abs().max()))
        vals = {"fro": float(d.norm() / (w.double().norm() + 1e-30)),
                "max": float(d.abs().max() / (w.abs().max().double() + 1e-30))}
        if exact is not None:
            e = exact[i].double()
            en = e.norm() + 1e-30
            vals["noise"] = float((g.double() - e).norm() / en) / (float((w.double() - e).norm() / en) + 1e-5)
        for k, v in vals.items():
            worst[k] = max(worst[k], (v, name))
    msg = (f"{tag}: grads max_abs_err={max_abs:.3e}; worst relative Frobenius error {worst['fro'][0]:.3e} "
           f"({worst['fro'][1]}, tolerance {GRAD_FRO_TOL}), worst entry {worst['max'][0]:.3e} of scale "
           f"({worst['max'][1]}, tolerance {GRAD_MAX_TOL})")
    if exact is not None:
        msg += (f"; against float64 sums the kernel strays {worst['noise'][0]:.3f}x as far as the float32 "
                f"plain version ({worst['noise'][1]}, tolerance {NOISE_FACTOR}x)")
    log(msg)
    if not (worst["fro"][0] < GRAD_FRO_TOL and worst["max"][0] < GRAD_MAX_TOL
            and worst["noise"][0] <= NOISE_FACTOR):
        raise AssertionError(f"{tag}: gradients disagree with the plain version")
    return max_abs


def bound(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def phase_kernel(dev, fine_rows: int) -> dict:
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    W = fm.pack_params(model)
    wk = fm.kernel_weights(model)
    max_abs = 0.0
    for n in (8192 + 37, fine_rows):
        x, v = encodings(n, gen, dev)
        got = fm.fused_mlp_fwd(wk, x, v)
        want = fm.fused_nerf_mlp_reference(W, x, v)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel: non-finite output at n={n}")
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().mean()) + 1.0)
        log(f"kernel: fused_mlp_fwd n={n} max_abs_err={err:.3e} err/(mean|plain|+1)={rel:.3e} "
            f"(tolerance {KERNEL_TOL})")
        if not rel < KERNEL_TOL:
            raise AssertionError(f"kernel: fused_mlp_fwd disagrees with its plain version at n={n}")
        max_abs = max(max_abs, err)

    # x, v are the fine level's shape now
    ms = time_ms(lambda: fm.fused_mlp_fwd(wk, x, v), iters=20)
    plain_ms = time_ms(lambda: fm.fused_nerf_mlp_reference(W, x, v), iters=5, warmup=1)
    flops = 2.0 * fm.LIVE_MACS_PER_SAMPLE * fine_rows
    nbytes = fm.IO_BYTES_PER_SAMPLE * fine_rows + wk.numel() * wk.element_size()
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"kernel: fused_mlp_fwd n={fine_rows}: {ms:.4f} ms ({ms / fine_rows * 1e6:.4f} ms per 1M samples, "
        f"{flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {bound_ms / ms:.3f} of bound")
    return {
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/fused_mlp.py:450",
        "launches": 0,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def phase_kernel_bwd(dev, big_rows: int) -> dict:
    """K1b against its plain version on a ragged size and at the fine
    level's rows of a training step, then timed at the latter."""
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 2)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    W = fm.pack_params(model)
    wk, wkt = fm.kernel_weights(model), fm.kernel_weights_bwd(model)
    max_abs = 0.0
    for n in (8192 + 37, big_rows):
        x, v = encodings(n, gen, dev)
        g = (torch.randn(n, 8, generator=gen) * 1e-3).to(dev)
        got = fm.fused_mlp_bwd(wk, wkt, x, v, g)
        want = fm.fused_mlp_bwd_reference(W, x, v, g)
        exact = None
        if n < big_rows:
            with fm.float64_sums():
                exact = fm.fused_mlp_bwd_reference(W, x, v, g)
        torch.cuda.synchronize()
        max_abs = max(max_abs, check_grads(f"kernel: fused_mlp_bwd n={n}", got, want,
                                           fm.FusedMLPWeights._fields, exact))

    ms = time_ms(lambda: fm.fused_mlp_bwd(wk, wkt, x, v, g), iters=10)
    plain_ms = time_ms(lambda: fm.fused_mlp_bwd_reference(W, x, v, g), iters=3, warmup=1)
    # recomputed forward, dX and dW: three passes of live MACs
    flops = 3 * 2.0 * fm.LIVE_MACS_PER_SAMPLE * big_rows
    nbytes = (64 + 32 + 8) * 4 * big_rows + fm.GRAD_ELEMS * 4 + (wk.numel() + wkt.numel()) * 2
    bound_ms, by, t_ops, t_bytes = bound(flops, nbytes)
    log(f"kernel: fused_mlp_bwd n={big_rows}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {bound_ms / ms:.3f} of bound")
    return {
        "name": "fused_mlp_bwd", "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/fused_mlp.py:475",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
    }


def level_batch(gen, n_rays: int, S: int, R: int, dev, raw: bool):
    """A level's kernel inputs for n_rays rays from cameras at radius 4
    looking at the origin, S stratified depths in [2, 6], uniform targets."""
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft

    look = torch.randn(n_rays, 3, generator=gen)
    origins = 4.0 * look / look.norm(dim=-1, keepdim=True)
    dirs = -origins / 4.0 + 0.2 * torch.randn(n_rays, 3, generator=gen)
    viewdirs = dirs / dirs.norm(dim=-1, keepdim=True)
    t = (torch.arange(S) + torch.rand(n_rays, S, generator=gen)) / S
    z = 2.0 + 4.0 * t
    pts = origins[:, None] + z[..., None] * dirs[:, None]
    target = torch.rand(n_rays, 3, generator=gen)
    args = [a.to(dev) for a in (pts, viewdirs, z, dirs, target)]
    if raw:
        return ft.pack_level_inputs_raw(*args, S, R)
    return ft.pack_level_inputs(*args, S, R)


def phase_kernel_train(dev) -> dict:
    """K2 against its plain version at the coarse level (S 96, R 8, with
    weights), the fine level (S 288, R 4) and, once, with encoded inputs;
    then each level timed. Rays whose last sample's weight changes sign
    (the 1e10 tail) are counted, not compared."""
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft

    gen = torch.Generator().manual_seed(SEED + 3)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    wkt = fm.kernel_weights_bwd(model)
    shapes = (("coarse", COARSE, MEGA_RC, True, True), ("fine", COARSE + FINE, MEGA_RF, False, True),
              ("coarse, encoded inputs", COARSE, MEGA_RC, True, False))
    max_abs, timed = 0.0, {}
    for tag, S, R, want_w, raw in shapes:
        x, vt = level_batch(gen, TRAIN_RAYS, S, R, dev, raw)
        wk, W = fm.kernel_weights(model, raw_layout=raw), fm.pack_params(model, raw_layout=raw)
        kw = dict(S=S, R=R, n_rays_total=TRAIN_RAYS, bkgd=1.0, want_weights=want_w, raw_inputs=raw)
        got = ft.fused_train_level(wk, wkt, x, vt, **kw)
        want = ft.fused_train_level_reference(W, x, vt, **kw)
        torch.cuda.synchronize()
        n_rows = TRAIN_RAYS * S
        tag = f"kernel: fused_train_level {tag} (S {S}, R {R}, {n_rows} rows)"
        flips = torch.zeros(TRAIN_RAYS, dtype=torch.bool, device=dev)
        if want_w:
            flips = (got[2][:, -1] > 0) != (want[2][:, -1] > 0)
        keep = ~flips
        errs = [float((got[0] - want[0]).abs().amax(-1)[keep].max()), float((got[1] - want[1]).abs()[keep].max())]
        if want_w:
            errs.append(float((got[2] - want[2]).abs()[keep].max()))
        log(f"{tag}: max |err| rgb {errs[0]:.3e}, acc {errs[1]:.3e}"
            + (f", weights {errs[2]:.3e}" if want_w else "") + f" (tolerance {TRAIN_TOL}); {int(flips.sum())} tail flips")
        if not max(errs) < TRAIN_TOL or int(flips.sum()) > MAX_TAIL_FLIPS * TRAIN_RAYS:
            raise AssertionError(f"{tag}: outputs disagree with the plain version")
        if raw:
            max_abs = max(max_abs, *errs, check_grads(tag, got[3], want[3], fm.FusedMLPWeights._fields))
        else:
            # encoded inputs carry dist (1e10 on the tail) in x's padding
            # column 63, so w0's and w5's padded row 63 sums 1e10-sized
            # products that cancel; no parameter reads it, so these are
            # compared in the model's layout
            got_p, want_p = fm.unpack_grads(got[3], model), fm.unpack_grads(want[3], model)
            max_abs = max(max_abs, *errs, check_grads(tag, list(got_p.values()), list(want_p.values()),
                                                      list(got_p)))
        if raw:
            ms = time_ms(lambda: ft.fused_train_level(wk, wkt, x, vt, **kw), iters=10)
            plain_ms = time_ms(lambda: ft.fused_train_level_reference(W, x, vt, **kw), iters=3, warmup=1)
            flops = 3 * 2.0 * fm.LIVE_MACS_PER_SAMPLE * n_rows
            nbytes = (x.numel() + vt.numel() + TRAIN_RAYS * (4 + (S if want_w else 0))) * 4 \
                + fm.GRAD_ELEMS * 4 + (wk.numel() + wkt.numel()) * 2
            b_ms, by, t_ops, t_bytes = bound(flops, nbytes)
            log(f"{tag}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"(operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {b_ms / ms:.3f} of bound")
            timed[S] = (ms, plain_ms, b_ms, by)
    # a training step launches both levels: its numbers are the sums
    ms, plain_ms, b_ms = (sum(t[i] for t in timed.values()) for i in range(3))
    log(f"kernel: fused_train_level per step (coarse + fine): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms, {b_ms / ms:.3f} of bound")
    return {
        "name": "fused_train_level", "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/fused_train.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/fused_train.py:215",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": timed[COARSE + FINE][3], "library_ms": None,
    }


def phase_render(dev) -> int:
    from nerf_projects_tpu_torch.core.rays import camera_rays, pose_spherical
    from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig, render_rays
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.train import NeRFTrainer

    cfg = NeRFRenderConfig(
        num_coarse_samples=64, num_fine_samples=128, multires=10, multires_views=4,
        use_viewdirs=True, white_bkgd=True, perturb=False,
    )
    trainer = NeRFTrainer(cfg, depth=8, width=256, use_fused_mlp=True, device=dev)
    if not trainer.use_fused_mlp:
        raise AssertionError("render: the fused-MLP gate refused the lego configuration")
    gen = torch.Generator().manual_seed(SEED + 1)
    params = tuple(random_biases(m, gen) for m in trainer.init_params(SEED))
    K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1]], np.float32)
    requests = []
    for theta, r0, c0 in REQUESTS:
        rays = camera_rays(SIZE, SIZE, K, pose_spherical(theta, -30.0, 4.0), device=dev)
        requests.append(rays.map(lambda t: t[r0:r0 + PATCH, c0:c0 + PATCH].contiguous()))
    torch.cuda.synchronize()
    n_rays = PATCH * PATCH

    fm.fused_mlp_fwd.launches = 0
    outs = []
    for rays in requests:
        t0 = time.perf_counter()
        outs.append(trainer.render_image(params, rays, chunk=n_rays, use_kernel=True))
        torch.cuda.synchronize()
        log(f"render: first request at theta {REQUESTS[len(outs) - 1][0]}: {time.perf_counter() - t0:.6f} s")
    secs = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < WINDOW_S:
        t0 = time.perf_counter()
        trainer.render_image(params, requests[len(secs) % len(requests)], chunk=n_rays, use_kernel=True)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    window = time.perf_counter() - t_window
    launches = fm.fused_mlp_fwd.launches
    log(f"render: {len(secs)} timed requests of {n_rays} rays in {window:.6f} s: "
        f"{len(secs) * n_rays / window:.1f} rays/s; request ms median {np.median(secs) * 1e3:.4f}, "
        f"min {min(secs) * 1e3:.4f}, max {max(secs) * 1e3:.4f}; "
        f"{launches} fused_mlp_fwd launches in {len(requests) + len(secs)} requests")
    if launches <= 0:
        raise AssertionError("render: the main path launched no fused_mlp_fwd kernel")

    packed = [fm.pack_params(p) for p in params]
    plain = NeRFTrainer(cfg, depth=8, width=256, use_fused_mlp=False, device=dev)
    for i, (rays, out) in enumerate(zip(requests, outs)):
        for key in ("rgb", "acc", "depth", "disp"):
            if tuple(out[key].shape[:2]) != (PATCH, PATCH) or not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"render: request {i} {key} is not finite of shape {PATCH}x{PATCH}")
        flat = rays.map(lambda t: t.reshape(-1, 3))
        with torch.no_grad():
            ref = render_rays(None, packed[0], packed[1], fm.fused_apply_reference, flat,
                              trainer.near, trainer.far, cfg, randomized=False)
        rgb = out["rgb"].reshape(-1, 3)
        # The 1e10 tail distance makes the last sample opaque whenever its
        # density is above zero, so a density within rounding of zero there
        # flips the ray's acc and rgb. Such rays are counted, not compared.
        flips = (out["weights"].reshape(n_rays, -1)[:, -1] > 0) != (ref["weights"][:, -1] > 0)
        d = (rgb - ref["rgb"]).abs().amax(-1)
        worst = float(d[~flips].max())
        log(f"render: request {i} vs the kernel's plain version: max |rgb| diff {worst:.3e} "
            f"over {int((~flips).sum())} rays, {int(flips.sum())} tail flips")
        if not worst <= RGB_TOL or int(flips.sum()) > MAX_TAIL_FLIPS * n_rays:
            raise AssertionError(f"render: request {i} disagrees with the plain version")
        f32 = plain.render_image(params, rays, chunk=n_rays)["rgb"].reshape(-1, 3)
        d32 = (rgb - f32).abs()
        log(f"render: request {i} vs the float32 modules: max |rgb| diff {float(d32.max()):.3e}, "
            f"mean {float(d32.mean()):.3e}, rays beyond {RGB_TOL}: {int((d32.amax(-1) > RGB_TOL).sum())}")
        if not float(d32.mean()) < RGB_TOL:
            raise AssertionError(f"render: request {i} is far from the float32 render")
    return launches


def train_window(trainer, state, ds):
    """Steps back to back for WINDOW_S seconds after WARM_STEPS warm ones;
    a CUDA event after each step times it on the card. Returns the
    per-step stats and times."""
    state, warm = trainer.scan_steps(state, ds["rays"], ds["pixels"], WARM_STEPS, batch_size=TRAIN_RAYS)
    torch.cuda.synchronize()
    events, losses, psnrs = [torch.cuda.Event(enable_timing=True)], [], []
    t0 = time.perf_counter()
    events[0].record()
    while time.perf_counter() - t0 < WINDOW_S:
        state, stats = trainer.scan_steps(state, ds["rays"], ds["pixels"], 1, batch_size=TRAIN_RAYS)
        losses.append(stats["loss"])
        psnrs.append(stats["psnr"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    losses = torch.cat([warm["loss"]] + losses).tolist()
    psnrs = torch.cat([warm["psnr"]] + psnrs).tolist()
    return state, window, step_ms, losses, psnrs


OUR_KERNELS = ("mlp_fwd_kernel", "mlp_dx_kernel", "mlp_dw_kernel", "mlp_grad_reduce_kernel",
               "composite_kernel", "march_kernel", "march_bwd_kernel")


def profile_steps(run_steps, route: str, n: int = PROFILE_STEPS):
    """torch.profiler over ``run_steps(n)`` (n training steps; its result
    is returned): the card's busy time split into the port's hand-written
    kernels and everything else (the glue), with the largest glue
    kernels, and the idle share of the host-clock window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run_steps(n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ours, glue = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue  # ranges such as Optimizer.step span kernels already counted
        us = float(getattr(e, "self_device_time_total", 0.0))
        if any(k in e.key for k in OUR_KERNELS):
            ours += us
        else:
            glue[e.key] = glue.get(e.key, 0.0) + us
    waits = {e.key: (e.count / n, e.cpu_time_total / n / 1e3) for e in prof.key_averages()
             if e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize")}
    busy = ours + sum(glue.values())
    if busy <= 0:
        log(f"profile: {route}: the profiler saw no device time; kernel and glue shares not measured")
        return result
    top = sorted(glue.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile: {route}, {n} steps: host window {wall_us / n / 1e3:.4f} ms a step; device busy "
        f"{busy / n / 1e3:.4f} ms a step (idle share {1 - busy / wall_us:.3f}): hand-written kernels "
        f"{ours / n / 1e3:.4f} ms, other kernels {(busy - ours) / n / 1e3:.4f} ms; largest others: "
        + "; ".join(f"{k[:60]} {v / n / 1e3:.4f} ms" for k, v in top)
        + "; host calls that can wait on the card, per step: "
        + ", ".join(f"{k} {c:.1f} calls {ms:.4f} ms" for k, (c, ms) in sorted(waits.items())))
    return result


def phase_train(dev, card: str) -> dict:
    """NeRFTrainer at the flagship training configuration (bench.py's):
    8x256 coarse and fine MLPs with viewdirs, multires 10/4, 96 coarse +
    192 fine samples, white background, perturb, near 2 and far 6, Adam
    at 5e-4 with exponential_decay(5e-4, 250), batches of 1,024 rays drawn
    on the card from the 32,768-ray pool of make_dataset(n_views=2,
    image_size=128). First one step of each route against the plain
    versions on CHECK_RAYS rays (perturb off), then each route trained for
    a timed window: the fused train level (use_mega) and the fused MLP
    under autograd. The launch counters are zeroed just before each
    window and read just after."""
    from nerf_projects_tpu_torch.core.rays import Rays
    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft
    from nerf_projects_tpu_torch.train import NeRFTrainer

    cfg = NeRFRenderConfig(
        num_coarse_samples=COARSE, num_fine_samples=FINE, multires=10, multires_views=4,
        use_viewdirs=True, white_bkgd=True, perturb=True, raw_noise_std=0.0, resample_sorted=False,
    )
    ds = make_dataset(n_views=2, image_size=128, device=dev)
    torch.cuda.synchronize()
    log(f"train: pool of {ds['pixels'].shape[0]} rays from make_dataset(n_views=2, image_size=128)")

    def make(mega, config=cfg, device=dev):
        trainer = NeRFTrainer(config, depth=8, width=256, near=2.0, far=6.0, lrate=5e-4, lrate_decay=250,
                              compute_dtype=torch.bfloat16, use_fused_mlp=True, use_mega=mega,
                              mega_rc=MEGA_RC, mega_rf=MEGA_RF, device=device)
        if not (trainer.use_fused_mlp and trainer.use_mega == mega):
            raise AssertionError("train: a kernel gate refused the flagship configuration")
        return trainer

    # one step of each route on the card against the same step through the
    # plain versions (the models copied to the host), perturb off
    check = cfg._replace(perturb=False)
    idx = torch.arange(CHECK_RAYS, device=dev) * (ds["pixels"].shape[0] // CHECK_RAYS)
    rays, target = ds["rays"].map(lambda t: t[idx]), ds["pixels"][idx]
    for mega in (True, False):
        on_card, on_host = make(mega, check), make(mega, check, "cpu")
        gen = torch.Generator().manual_seed(SEED + 4)
        params = tuple(random_biases(m, gen) for m in on_card.init_params(SEED))
        host_params = tuple(copy.deepcopy(m).cpu() for m in params)
        (loss, mse), grads = on_card._value_and_grad(params, None, rays, target)
        (hloss, hmse), hgrads = on_host._value_and_grad(host_params, None, rays.map(lambda t: t.cpu()), target.cpu())
        tag = f"train: one {'fused train-level' if mega else 'fused-MLP autograd'} step of {CHECK_RAYS} rays"
        log(f"{tag}: loss {float(loss):.6f} (plain {float(hloss):.6f}), fine mse {float(mse):.6f} "
            f"(plain {float(hmse):.6f})")
        if not (abs(float(loss) - float(hloss)) < 3e-3 * float(hloss)
                and abs(float(mse) - float(hmse)) < 3e-3 * float(hmse)):
            raise AssertionError(f"{tag}: the loss disagrees with the plain versions")
        # the coarse model's gradients come from the coarse level alone, which
        # the fine level's resample (sensitive to bf16 noise) does not reach
        names = list(grads[0])
        check_grads(f"{tag}, coarse model", [grads[0][k].cpu() for k in names],
                    [hgrads[0][k] for k in names], names)

    out = {}
    for route, mega in (("fused train level (use_mega)", True), ("fused MLP under autograd", False)):
        trainer = make(mega)
        state = trainer.init_state(SEED)
        fm.fused_mlp_fwd.launches = fm.fused_mlp_bwd.launches = ft.fused_train_level.launches = 0
        state, window, step_ms, losses, psnrs = train_window(trainer, state, ds)
        counts = {"fused_mlp_fwd": fm.fused_mlp_fwd.launches, "fused_mlp_bwd": fm.fused_mlp_bwd.launches,
                  "fused_train_level": ft.fused_train_level.launches}
        n = len(step_ms)
        log(f"train: {route} on {card}: {n} timed steps of {TRAIN_RAYS} rays in {window:.6f} s: "
            f"{n * TRAIN_RAYS / window:.1f} rays/s; step ms median {float(np.median(step_ms)):.4f}, "
            f"min {min(step_ms):.4f}, max {max(step_ms):.4f}; loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
            f"psnr {psnrs[0]:.4f} -> {psnrs[-1]:.4f} over {len(losses)} steps; launches {counts} "
            f"(warm steps included)")
        need = ("fused_train_level",) if mega else ("fused_mlp_fwd", "fused_mlp_bwd")
        if any(counts[k] <= 0 for k in need):
            raise AssertionError(f"train: {route} launched no {need} kernel")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train: {route}: a loss is not finite")
        k = min(10, len(losses) // 4)
        if not np.mean(losses[-k:]) < np.mean(losses[:k]):
            raise AssertionError(f"train: {route}: the loss did not fall")
        out[mega] = counts
        profile_steps(lambda n: trainer.scan_steps(state, ds["rays"], ds["pixels"], n, batch_size=TRAIN_RAYS)[0],
                      route)
    return {"fused_train_level": out[True]["fused_train_level"],
            "fused_mlp_bwd": out[False]["fused_mlp_bwd"]}


# ---------------------------------------------------------------------------
# Plenoxels serving: the tile march (K3)
# ---------------------------------------------------------------------------

H100_FP32_FLOPS = 67e12     # float32 outside the tensor cores, H100 SXM data sheet
GRID_RESO, GRID_BASIS = 512, 9
FRAME = 800                 # 800x800 frames
FRAME_TILE = (16, 32)       # 512-ray tiles, as bench.py's frame bench
MARCH_TOL = 1e-4            # max |err| / (|plain| + 1), float32 sums of the same bf16 cells
PLAIN_BATCH_TILES = 64      # tiles per call of the plain version


def frame_tiles(i: int, dev):
    """bench.py's frame_tiles(i): 800x800 OpenCV rays (focal 800) from a
    camera on a circle of radius 2.4 around the grid, in 16x32 tiles."""
    from nerf_projects_tpu_torch.core.rays import camera_rays_opencv
    from nerf_projects_tpu_torch.ops.tile_render import tiles_from_image_rays

    pose = np.eye(4, dtype=np.float32)
    ang = 0.15 * i
    pose[0, 3] = 2.4 * np.sin(ang)
    pose[2, 3] = -2.4 * np.cos(ang)
    rays = camera_rays_opencv(FRAME, FRAME, float(FRAME), float(FRAME), FRAME / 2.0, FRAME / 2.0, pose, device=dev)
    return tiles_from_image_rays(rays.map(lambda x: x.reshape(-1, 3)), FRAME, FRAME, *FRAME_TILE)


def random_cells(bg, gen: torch.Generator, opaque_sigma=None, chunk: int = 8192):
    """The march's bf16 cell array for bg's geometry, filled on the card
    from ``gen`` as bench.py's _gen_z: density U[0, 2] (or
    U[S/2, 3S/2] with opaque_sigma=S) and SH N(0, 0.2^2) on active cells,
    zeros elsewhere."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    nb, B = bg.n_bricks, bg.basis_dim
    cells = torch.zeros((nb, 512, tm.channels(B)), dtype=torch.bfloat16, device=bg.device)
    for i in range(0, nb, chunk):
        m = bg.cell_mask[i:i + chunk].float()
        d = torch.rand(m.shape, generator=gen, device=bg.device) * 2.0
        if opaque_sigma is not None:
            d = d * (opaque_sigma / 2.0) + opaque_sigma / 2.0
        cells[i:i + chunk, :, 0] = d * m
        sh = torch.randn(m.shape + (3 * B,), generator=gen, device=bg.device) * 0.2
        cells[i:i + chunk, :, 1:1 + 3 * B] = sh * m[..., None]
    return cells


def shell_select(bg, r_lo: float = 0.85, r_hi: float = 1.02):
    """bench.py's _shell_select: keep the bricks whose centre lies at
    radius r_lo..r_hi of the unit sphere, rows renumbered."""
    links = bg.brick_links.cpu().numpy()
    coords = np.argwhere(links >= 0)
    centers = (coords * 8.0 + 4.0) / bg.reso[0] * 2.0 - 1.0
    rad = np.linalg.norm(centers, axis=1)
    keep = (rad >= r_lo) & (rad <= r_hi)
    if not keep.any():  # a grid too coarse for the band keeps every brick
        keep[:] = True
    old_rows = links[coords[:, 0], coords[:, 1], coords[:, 2]]
    new_links = np.full_like(links, -1)
    kept = coords[keep]
    new_links[kept[:, 0], kept[:, 1], kept[:, 2]] = np.arange(int(keep.sum()), dtype=np.int32)
    sel = torch.from_numpy(old_rows[keep]).long().to(bg.device)
    return dataclasses.replace(bg, brick_links=torch.from_numpy(new_links).to(bg.device), cell_mask=bg.cell_mask[sel],
                      brick_coords=bg.brick_coords[sel], density_bricks=bg.density_bricks[sel],
                      sh_bricks=bg.sh_bricks[sel])


def scene_grid(dev, shell: bool):
    """(geometry-only BrickGrid, cells) of a 512^3 basis-9 scene built
    on the card: the fog or the opaque shell."""
    from nerf_projects_tpu_torch.ops.brick_grid import create_brick_grid

    bg = create_brick_grid(GRID_RESO, basis_dim=GRID_BASIS, use_sphere_bound=True, alloc_data=False, device=dev)
    if shell:
        bg = shell_select(bg)
    gen = torch.Generator(device=dev).manual_seed(SEED + (6 if shell else 5))
    return bg, random_cells(bg, gen, opaque_sigma=1000.0 if shell else None)


def plain_march(cells, bg, pack, basis, counts=False, **kw):
    """The plain version in batches of PLAIN_BATCH_TILES tiles: out, or
    with ``counts`` (out, (samples marched, samples shaded, bricks
    touched)) over all the tiles."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    outs, marched, shaded, touched = [], 0, 0, None
    for i in range(0, pack.shape[0], PLAIN_BATCH_TILES):
        got = tm.march_reference(cells, bg.brick_links, bg.reso, pack[i:i + PLAIN_BATCH_TILES],
                                 basis[i:i + PLAIN_BATCH_TILES], counts=counts, **kw)
        if counts:
            got, c = got
            marched += int(c["marched"].sum())
            shaded += int(c["shaded"].sum())
            touched = c["touched"] if touched is None else touched | c["touched"]
        outs.append(got)
    out = torch.cat(outs)
    return (out, (marched, shaded, int(touched.sum()))) if counts else out


def compare_march(tag, out, ref) -> float:
    """Kernel out against the plain version's: every output row within
    MARCH_TOL of (|plain| + 1), no NaN, no miss. Returns the largest |err|
    of rgb and acc."""
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: non-finite kernel output")
    rel = ((out - ref).abs() / (ref.abs() + 1.0)).amax(dim=(0, 2))  # per output row
    max_abs = float((out[:, :4] - ref[:, :4]).abs().max())
    names = ("r", "g", "b", "acc", "depth_t", "-log_transmit", "sparsity", "miss")
    log(f"{tag}: max |err| rgb/acc {max_abs:.3e}; worst err/(|plain|+1) per row "
        + ", ".join(f"{n} {float(v):.2e}" for n, v in zip(names, rel)) + f" (tolerance {MARCH_TOL})")
    if not float(rel.max()) < MARCH_TOL or bool(out[:, 7].any()):
        raise AssertionError(f"{tag}: the march kernel disagrees with its plain version")
    return max_abs


def march_bound(touched_bricks: int, basis_dim: int, n_rays: int, n_tiles: int, marched: int, shaded: int):
    """(bound ms, "bytes" | "operations", ops ms, bytes ms) of one march:
    the touched bricks' live channels (1 + 3B bf16 a cell) and each ray's
    pack and outputs and each tile's basis once over HBM; the samples'
    float operations over the float32 rate."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    nbytes = (touched_bricks * 512 * (1 + 3 * basis_dim) * 2 + n_rays * (tm.PACK * 4 + 8 * 4)
              + n_tiles * basis_dim * 4)
    flops = marched * tm.FLOPS_PER_SAMPLE + shaded * tm.flops_per_shaded(basis_dim)
    t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def phase_kernel_march(dev) -> dict:
    """K3 against its plain version: a random 32^3 grid with 128-, 256-
    and 512-ray tiles, then a whole 800x800 frame of the 512^3 fog scene,
    whose plain run also counts the work of the bound; then that frame's
    march timed, and the plain version's."""
    from nerf_projects_tpu_torch.core.rays import camera_rays_opencv
    from nerf_projects_tpu_torch.ops.brick_grid import create_brick_grid
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.ops.tile_render import tiles_from_image_rays

    opts = GridRenderOptions(step_size=0.5)
    max_abs = 0.0
    bg = create_brick_grid(32, basis_dim=GRID_BASIS, use_sphere_bound=True, alloc_data=False, device=dev)
    cells = random_cells(bg, torch.Generator(device=dev).manual_seed(SEED + 4), opaque_sigma=40.0)
    C = tm.default_chunks_for(bg, opts)
    tm.tile_march_fwd.launches = 0
    for th, tw in ((8, 16), (16, 16), (16, 32)):
        H, W = 4 * th, 4 * tw
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.3, -0.2, -2.6]
        rays = camera_rays_opencv(H, W, 1.2 * W, 1.2 * W, W / 2.0, H / 2.0, pose, device=dev)
        tiles = tiles_from_image_rays(rays.map(lambda x: x.reshape(-1, 3)), H, W, th, tw)
        pack, basis = tm.pack_rays(bg, tiles, opts)
        for early_stop in (False, True):
            kw = dict(max_steps=C * tm.SC, early_stop=early_stop)
            got = tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw)
            want = tm.march_reference(cells, bg.brick_links, bg.reso, pack, basis, **kw)
            torch.cuda.synchronize()
            max_abs = max(max_abs, compare_march(
                f"kernel_march: 32^3, {th}x{tw}-ray tiles, {pack.shape[0]} tiles, early_stop {early_stop}",
                got, want))

    bg, cells = scene_grid(dev, shell=False)
    tiles = frame_tiles(0, dev)
    pack, basis = tm.pack_rays(bg, tiles, opts)
    kw = dict(max_steps=tm.default_chunks_for(bg, opts) * tm.SC, early_stop=True)
    got = tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw)
    torch.cuda.synchronize()
    if tm.tile_march_fwd.launches != 7:
        raise AssertionError(f"kernel_march: {tm.tile_march_fwd.launches} launches counted for 7 kernel calls")
    T = pack.shape[0]
    want, (marched, shaded, n_touched) = plain_march(cells, bg, pack, basis, counts=True, **kw)
    max_abs = max(max_abs, compare_march(
        f"kernel_march: {GRID_RESO}^3 fog frame, {T} tiles of {pack.shape[1]} rays", got, want))

    ms = time_ms(lambda: tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw), iters=5)
    t0 = time.perf_counter()
    plain_march(cells, bg, pack, basis, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    b_ms, by, t_ops, t_bytes = march_bound(n_touched, bg.basis_dim, T * pack.shape[1], T, marched, shaded)
    log(f"kernel_march: {GRID_RESO}^3 fog frame ({FRAME}x{FRAME}, {T} tiles): {ms:.4f} ms a frame "
        f"({marched / ms / 1e6:.3f} G samples/s; {marched} samples marched, {shaded} shaded, by the plain version; "
        f"{n_touched} of {bg.n_bricks} bricks touched), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"(operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {b_ms / ms:.3f} of bound")
    del cells, bg
    torch.cuda.empty_cache()
    return {
        "name": "tile_march_fwd", "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/tile_march_fwd.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/tile_march.py:431",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def phase_render_plenoxels(dev, card: str) -> int:
    """render_frame_pallas at bench.py's two frame configurations (fog,
    opaque shell): frames back to back for WINDOW_S seconds after one
    warm frame a pose. Returns the K3 launches of both windows."""
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.ops.kernels.frame_march import render_frame_pallas

    opts = GridRenderOptions(step_size=0.5)
    frames = [frame_tiles(i, dev) for i in range(4)]
    launches = 0
    for name, shell in (("fog", False), ("shell", True)):
        torch.cuda.reset_peak_memory_stats(dev)
        bg, cells = scene_grid(dev, shell)
        C = tm.default_chunks_for(bg, opts)
        gb = cells.numel() * cells.element_size() / 1e9

        def render(rays):
            return render_frame_pallas(bg, rays, opts, kernel_arrays=cells, n_chunks=C, use_occupancy=False)

        first = [render(f) for f in frames]
        torch.cuda.synchronize()
        for i, out in enumerate(first):
            for key, shape in (("rgb", (frames[i].origins.shape[0], 512, 3)), ("acc", (frames[i].origins.shape[0], 512))):
                if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key]).all()):
                    raise AssertionError(f"render_plenoxels: {name} frame {i} {key} is not finite of shape {shape}")
            if not (float(out["acc"].min()) >= -1e-6 and float(out["acc"].max()) <= 1 + 1e-5):
                raise AssertionError(f"render_plenoxels: {name} frame {i}: acc outside [0, 1]")
        # every frame against the plain version, which also counts its samples
        per_pose = []
        for i, f in enumerate(frames):
            pack, basis = tm.pack_rays(bg, f, opts)
            plain, (marched, _, _) = plain_march(cells, bg, pack, basis, counts=True, max_steps=C * tm.SC,
                                                 early_stop=True)
            ref = tm.march_outputs(plain, pack, opts, False)
            err = max(float((first[i][k] - ref[k]).abs().max()) for k in ("rgb", "acc"))
            log(f"render_plenoxels: {name}: frame {i} against the plain version: max |rgb, acc err| {err:.3e} "
                f"(tolerance {MARCH_TOL}); {marched} samples marched")
            if not err < MARCH_TOL:
                raise AssertionError(f"render_plenoxels: {name}: frame {i} disagrees with the plain version")
            per_pose.append(marched)

        tm.tile_march_fwd.launches = 0
        secs, marched = [], 0
        t_window = time.perf_counter()
        while time.perf_counter() - t_window < WINDOW_S:
            t0 = time.perf_counter()
            render(frames[len(secs) % len(frames)])
            marched += per_pose[len(secs) % len(frames)]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        window = time.perf_counter() - t_window
        n_launch = tm.tile_march_fwd.launches
        launches += n_launch
        mean_acc = float(first[0]["acc"].mean())
        log(f"render_plenoxels: {name} on {card}: {GRID_RESO}^3 basis {GRID_BASIS} step 0.5, {bg.n_bricks} active bricks, "
            f"cells {gb:.3f} GB, peak allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; "
            f"{len(secs)} frames of {FRAME}x{FRAME} in {window:.6f} s: {len(secs) / window:.4f} frames/s; ms a frame "
            f"median {np.median(secs) * 1e3:.4f}, min {min(secs) * 1e3:.4f}, max {max(secs) * 1e3:.4f}; "
            f"{n_launch} tile_march_fwd launches; {marched} samples marched (counted by the plain version) "
            f"({marched / len(secs) / 1e6:.3f} M a frame); mean acc of frame 0 {mean_acc:.4f}")
        if n_launch <= 0:
            raise AssertionError(f"render_plenoxels: {name}: the main path launched no tile_march_fwd kernel")
        del cells, bg, first
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Plenoxels training: the march's backward (K4) and the training step
# ---------------------------------------------------------------------------

TRAIN_SCENES = {"fog": (256, 40), "shell": (512, 128)}  # reso, tiles of 8x16 rays a step
TRAIN_TARGET = 0.4
BWD_FRO_TOL = 1e-4          # |err|_F / |plain|_F of each gradient tensor: float32 atomics against index_add_
BWD_MAX_TOL = 1e-3          # largest |err| / largest |plain| of each gradient tensor
BWD_LOSSES = {"mse": (0.0, 0.0), "beta+sparsity": (1e-3, 1e-3)}
MASTER_TOL = 1e-5           # of scale: updated masters where |g| > 1e-3 max |g| (lr sign(g) on a first step)
RMS_TOL = 2 * BWD_MAX_TOL   # of scale: rms = g^2 on a first step


def train_tile_rays(seed: int, n_tiles: int, dev, radius=3.0, focal_px=800.0, tile_shape=(8, 16)):
    """bench.py's _tile_rays: n_tiles tiles of 8x16 rays from cameras on
    a sphere of radius 3 looking at the origin, focal 800 px, each at a
    random offset in [-300, 300) px (numpy's generator, not JAX's)."""
    from nerf_projects_tpu_torch.core.rays import Rays

    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n_tiles, 3))
    cam = radius * u / np.linalg.norm(u, axis=-1, keepdims=True)
    fwd = -cam / radius
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.maximum(np.linalg.norm(right, axis=-1, keepdims=True), 1e-6)
    up2 = np.cross(right, fwd)
    ii, jj = np.meshgrid(np.arange(float(tile_shape[0])), np.arange(float(tile_shape[1])), indexing="ij")
    base = rng.uniform(-300, 300, (n_tiles, 2))
    px = base[:, 0:1] + jj.reshape(-1)[None]
    py = base[:, 1:2] + ii.reshape(-1)[None]
    d = fwd[:, None] + (px / focal_px)[..., None] * right[:, None] + (py / focal_px)[..., None] * up2[:, None]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(cam[:, None], d.shape).astype(np.float32)
    o, d = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (o, d))
    return Rays(o, d, d)


def train_grid(dev, name: str, chunk: int = 4096):
    """bench.py's _plenoxels_setup(reso) (fog) or _shell_setup(512)
    (shell): basis 9, float32 masters made on the card chunk by chunk
    (density U[0, 2], SH N(0, 0.2^2) on active cells); the shell keeps
    the bricks at radius 0.85-1.02 and never builds the whole sphere."""
    from nerf_projects_tpu_torch.ops.brick_grid import create_brick_grid

    reso, _ = TRAIN_SCENES[name]
    bg = create_brick_grid(reso, basis_dim=GRID_BASIS, use_sphere_bound=True, alloc_data=False, device=dev)
    if name == "shell":
        bg = shell_select(bg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    nb, B = bg.n_bricks, bg.basis_dim
    dens = torch.empty((nb, 512), device=dev)
    sh = torch.empty((nb, 512, 3 * B), device=dev)
    for i in range(0, nb, chunk):
        m = bg.cell_mask[i:i + chunk].float()
        dens[i:i + chunk] = torch.rand(m.shape, generator=gen, device=dev) * 2.0 * m
        sh[i:i + chunk] = torch.randn(m.shape + (3 * B,), generator=gen, device=dev) * 0.2 * m[..., None]
    return dataclasses.replace(bg, density_bricks=dens, sh_bricks=sh)


class plain_kernels:
    """Within the block, the march and its backward run their plain
    versions on CUDA tensors too."""

    def __enter__(self):
        from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

        self.saved = tm.march, tm.march_backward
        tm.march, tm.march_backward = tm.march_reference, tm.march_backward_reference
        return self

    def __exit__(self, *exc):
        from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

        tm.march, tm.march_backward = self.saved


def check_bwd(tag, got, want) -> float:
    """Each of K4's gradient tensors against the plain version's:
    relative Frobenius error below BWD_FRO_TOL and the largest entry's
    error below BWD_MAX_TOL of the largest |plain|. Returns the largest
    absolute error."""
    max_abs, msgs, ok = 0.0, [], True
    for name, g, w in zip(("grad_density", "grad_sh"), got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag}: non-finite {name}")
        d = (g - w).double()
        fro = float(d.norm() / (w.double().norm() + 1e-30))
        worst = float(d.abs().max() / (w.abs().max().double() + 1e-30))
        max_abs = max(max_abs, float(d.abs().max()))
        msgs.append(f"{name} relative Frobenius {fro:.3e}, worst entry {worst:.3e} of scale")
        ok = ok and fro < BWD_FRO_TOL and worst < BWD_MAX_TOL and float(w.abs().max()) > 0
    log(f"{tag}: " + "; ".join(msgs) + f" (tolerances {BWD_FRO_TOL}, {BWD_MAX_TOL})")
    if not ok:
        raise AssertionError(f"{tag}: the march backward disagrees with its plain version")
    return max_abs


def bwd_inputs(cells, bg, pack, basis, gt, opts, beta, max_steps):
    """The backward's g and S_total from the forward kernel's outputs."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    out = tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, max_steps=max_steps,
                            color_mode=opts.color_mode)
    _, g, s_total = tm.loss_seeds(out, gt, opts, beta)
    return g, s_total


def march_bwd_bound(n_touched: int, nb: int, basis_dim: int, n_rays: int, n_tiles: int, counts: dict,
                    sparsity: float):
    """(bound ms, "bytes" | "operations", ops ms, bytes ms) of one
    backward: the touched bricks' live channels (1 + 3B bf16 a cell) read
    once, the float32 gradient arrays ((1 + 3B) a cell) written once, and
    each ray's pack, g and S_total and each tile's basis read once, over
    HBM; the re-march's and the backward's float operations (itemised in
    ops/kernels/tile_march.py) over the float32 rate."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    B = basis_dim
    nbytes = (n_touched * 512 * (1 + 3 * B) * 2 + nb * 512 * (1 + 3 * B) * 4
              + n_rays * (tm.PACK + 3 + 1) * 4 + n_tiles * B * 4)
    flops = (counts["marched"] * tm.FLOPS_PER_SAMPLE
             + counts["shaded"] * (tm.flops_per_shaded(B) + tm.bwd_flops_per_shaded(B)))
    if sparsity:
        flops += (counts["dense"] * tm.BWD_FLOPS_SPARSITY
                  + (counts["dense"] - counts["shaded"]) * tm.BWD_FLOPS_SPARSITY_UNSHADED)
    t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def phase_kernel_march_bwd(dev) -> dict:
    """K4 against its plain version: a random 32^3 grid whose rays stop,
    tiles of 128, 256 and 512 rays, both decodes, the losses off and on;
    then one training batch of the 256^3 fog scene, whose plain run
    also counts the work of the bound; then that batch's backward timed
    beside the plain version, the kernel without atomics and K3."""
    from nerf_projects_tpu_torch.core.rays import camera_rays_opencv
    from nerf_projects_tpu_torch.ops.brick_grid import create_brick_grid
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.ops.tile_render import tiles_from_image_rays

    max_abs = 0.0
    bg = create_brick_grid(32, basis_dim=GRID_BASIS, use_sphere_bound=True, alloc_data=False, device=dev)
    cells = random_cells(bg, torch.Generator(device=dev).manual_seed(SEED + 8), opaque_sigma=40.0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    tm.tile_march_bwd.launches = 0
    n_calls = 0
    for th, tw in ((8, 16), (16, 16), (16, 32)):
        H, W = 4 * th, 4 * tw
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.3, -0.2, -2.6]
        rays = camera_rays_opencv(H, W, 1.2 * W, 1.2 * W, W / 2.0, H / 2.0, pose, device=dev)
        tiles = tiles_from_image_rays(rays.map(lambda x: x.reshape(-1, 3)), H, W, th, tw)
        gt = torch.rand(tiles.origins.shape, generator=gen, device=dev)
        for mode in ("bias", "sigmoid"):
            opts = GridRenderOptions(step_size=0.5, color_mode=mode)
            cells_, pack, basis, max_steps = tm.march_inputs(bg, tiles, opts, kernel_arrays=cells)
            for losses, (beta, spars) in BWD_LOSSES.items():
                g, s_total = bwd_inputs(cells, bg, pack, basis, gt, opts, beta, max_steps)
                kw = dict(max_steps=max_steps, color_mode=mode, sparsity_scale=spars)
                got = tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
                want = tm.march_backward_reference(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
                torch.cuda.synchronize()
                n_calls += 1
                max_abs = max(max_abs, check_bwd(
                    f"kernel_march_bwd: 32^3, {th}x{tw}-ray tiles, {pack.shape[0]} tiles, {mode}, {losses}", got, want))

    # one training batch of the fog scene: bench.py's plenoxels_train
    name = "fog"
    reso, n_tiles = TRAIN_SCENES[name]
    bg = train_grid(dev, name)
    opts = GridRenderOptions(step_size=0.5)
    rays = train_tile_rays(SEED + 2, n_tiles, dev)
    gt = torch.full(rays.origins.shape, TRAIN_TARGET, device=dev)
    cells, pack, basis, max_steps = tm.march_inputs(bg, rays, opts)
    g, s_total = bwd_inputs(cells, bg, pack, basis, gt, opts, 0.0, max_steps)
    kw = dict(max_steps=max_steps, color_mode=opts.color_mode)
    got = tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
    want = tm.march_backward_reference(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
    torch.cuda.synchronize()
    n_calls += 1
    if tm.tile_march_bwd.launches != n_calls:
        raise AssertionError(f"kernel_march_bwd: {tm.tile_march_bwd.launches} launches counted for {n_calls} calls")
    T, r = pack.shape[:2]
    max_abs = max(max_abs, check_bwd(f"kernel_march_bwd: {reso}^3 fog training batch, {T} tiles of {r} rays",
                                     got, want))
    # the backward marches until each ray goes inactive (no sparsity loss)
    _, counts = tm.march_reference(cells, bg.brick_links, bg.reso, pack, basis, counts=True, early_stop=True,
                                   max_steps=max_steps)
    counts = {k: int(v.sum()) for k, v in counts.items()}

    ms = time_ms(lambda: tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw),
                 iters=10)
    probe_ms = time_ms(lambda: tm.tile_march_bwd_probe(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                                       sigma_thresh=opts.sigma_thresh,
                                                       stop_thresh=opts.stop_thresh, sparsity_scale=0.0, **kw),
                       iters=10)
    zero_ms = time_ms(lambda: (torch.zeros_like(bg.density_bricks), torch.zeros_like(bg.sh_bricks)), iters=10)
    fwd_ms = time_ms(lambda: tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw), iters=10)
    plain_ms = time_ms(lambda: tm.march_backward_reference(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                                           **kw), iters=2, warmup=1)
    b_ms, by, t_ops, t_bytes = march_bwd_bound(counts["touched"], bg.n_bricks, bg.basis_dim, T * r, T, counts, 0.0)
    issue_bytes_ms = (counts["touched"] * 512 * (1 + 3 * bg.basis_dim) * (2 + 8) + T * r * 64) / H100_HBM_BYTES_S * 1e3
    atomics = counts["shaded"] * 8 * (1 + 3 * bg.basis_dim)
    log(f"kernel_march_bwd: {reso}^3 fog training batch ({T * r} rays, {bg.n_bricks} bricks): K4 {ms:.4f} ms "
        f"(the wrapper: zeroed gradient arrays {zero_ms:.4f} ms, then the kernel); without its atomics "
        f"{probe_ms:.4f} ms; K3 on the batch {fwd_ms:.4f} ms; {counts['marched']} samples marched, "
        f"{counts['shaded']} shaded ({atomics} atomic adds), {counts['touched']} bricks touched, by the plain "
        f"version; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms (operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms; "
        f"touched gradients read and written instead of the arrays written: {issue_bytes_ms:.4f} ms), "
        f"{b_ms / ms:.3f} of bound")
    del cells, bg, got, want
    torch.cuda.empty_cache()
    return {
        "name": "tile_march_bwd", "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/tile_march.py:1341",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def phase_train_plenoxels(dev, card: str) -> dict:
    """train_step_tiles_pallas at the fog 256^3 and shell 512^3 training
    configurations: one step against the plain versions, then a timed
    window. Returns the K3 and K4 launches of both windows."""
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.train import PlenoxelsTrainer

    launches = {"tile_march_fwd": 0, "tile_march_bwd": 0}
    for name, (reso, n_tiles) in TRAIN_SCENES.items():
        bg = train_grid(dev, name)
        torch.cuda.reset_peak_memory_stats(dev)  # the peak from here counts the masters
        trainer = PlenoxelsTrainer(GridRenderOptions(step_size=0.5), n_iters=128_000, lambda_tv=1e-5,
                                   lambda_tv_sh=1e-3, device=dev)
        rays = train_tile_rays(SEED + 2, n_tiles, dev)
        target = torch.full(rays.origins.shape, TRAIN_TARGET, device=dev)
        n_rays = target.shape[0] * target.shape[1]
        tag = f"train_plenoxels: {name} {reso}^3"

        def gen():
            return torch.Generator(device=dev).manual_seed(SEED + 10)

        # one step: its gradients and updated state against the plain versions
        gd, gsh, stats = trainer.tiles_pallas_grads(bg, rays, target, gen())
        with plain_kernels():
            pd, psh, pstats = trainer.tiles_pallas_grads(bg, rays, target, gen())
        torch.cuda.synchronize()
        check_bwd(f"{tag}: one step's gradients (after TV and the cell mask)", (gd, gsh), (pd, psh))
        keep = [p.abs() > 1e-3 * p.abs().max() for p in (pd, psh)]
        del gd, gsh, pd, psh
        rms = trainer.init_rms_bricks(bg)
        new_k, rms_k, _ = trainer.train_step_tiles_pallas(bg, rms, rays, target, 0, gen())
        with plain_kernels():
            new_p, rms_p, _ = trainer.train_step_tiles_pallas(bg, rms, rays, target, 0, gen())
        errs = []
        for got, want, m in ((new_k.density_bricks, new_p.density_bricks, keep[0]),
                             (new_k.sh_bricks, new_p.sh_bricks, keep[1]),
                             (rms_k.rms_density, rms_p.rms_density, keep[0]), (rms_k.rms_sh, rms_p.rms_sh, keep[1])):
            errs.append(float((got - want)[m].abs().max() / want[m].abs().max()))
        mse_k, mse_p = float(stats["mse"]), float(pstats["mse"])
        log(f"{tag}: one step against the plain versions: mse {mse_k:.6f} (plain {mse_p:.6f}); where "
            f"|g| > 1e-3 max |g| ({int(keep[0].sum())} + {int(keep[1].sum())} entries) the updated density and SH "
            f"differ by {errs[0]:.3e} and {errs[1]:.3e} of scale (tolerance {MASTER_TOL}), the rms by {errs[2]:.3e} "
            f"and {errs[3]:.3e} (tolerance {RMS_TOL})")
        if not (abs(mse_k - mse_p) < 1e-5 * mse_p and max(errs[:2]) < MASTER_TOL and max(errs[2:]) < RMS_TOL):
            raise AssertionError(f"{tag}: the step disagrees with the plain versions")
        del new_k, rms_k, new_p, rms_p, keep
        torch.cuda.empty_cache()

        tm.tile_march_fwd.launches = tm.tile_march_bwd.launches = 0
        g_tv = torch.Generator(device=dev).manual_seed(SEED + 11)
        mses = []
        step = 0
        for _ in range(WARM_STEPS):
            bg, rms, st = trainer.train_step_tiles_pallas(bg, rms, rays, target, step, g_tv)
            mses.append(st["mse"])
            step += 1
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True)]
        t0 = time.perf_counter()
        events[0].record()
        while time.perf_counter() - t0 < WINDOW_S:
            bg, rms, st = trainer.train_step_tiles_pallas(bg, rms, rays, target, step, g_tv)
            mses.append(st["mse"])
            step += 1
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        counts = {"tile_march_fwd": tm.tile_march_fwd.launches, "tile_march_bwd": tm.tile_march_bwd.launches}
        step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        mses = torch.stack(mses).tolist()
        n = len(step_ms)
        log(f"{tag} on {card}: {bg.n_bricks} bricks, peak allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; "
            f"{n} timed steps of {n_rays} rays in {window:.6f} s: {n * n_rays / window:.1f} rays/s; step ms median "
            f"{float(np.median(step_ms)):.4f}, min {min(step_ms):.4f}, max {max(step_ms):.4f}; mse {mses[0]:.6f} -> "
            f"{mses[-1]:.6f} over {len(mses)} steps; launches {counts} (warm steps included)")
        if any(v <= 0 for v in counts.values()):
            raise AssertionError(f"{tag}: the training step launched no {counts} kernel")
        if not all(np.isfinite(mses)):
            raise AssertionError(f"{tag}: an MSE is not finite")
        k = min(10, len(mses) // 4)
        if not np.mean(mses[-k:]) < np.mean(mses[:k]):
            raise AssertionError(f"{tag}: the MSE did not fall")
        for key in launches:
            launches[key] += counts[key]

        def run_steps(n, state=(bg, rms)):
            b, r = state
            for i in range(n):
                b, r, _ = trainer.train_step_tiles_pallas(b, r, rays, target, step + i, g_tv)
            return b, r

        profile_steps(run_steps, f"Plenoxels train, {name} {reso}^3")
        del bg, rms, trainer
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    import nerf_projects_tpu_torch  # noqa: F401  (fails outside the repository)

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}; "
        "plain versions run float32 matmuls in full float32 (allow_tf32=False)")
    card = nvidia_smi()
    log(f"card: {card}")
    build_s = phase_build()
    kernels = [
        phase_kernel(dev, fine_rows=PATCH * PATCH * (64 + 128)),
        phase_kernel_bwd(dev, big_rows=TRAIN_RAYS * (COARSE + FINE)),
        phase_kernel_train(dev),
    ]
    kernels[0]["launches"] = phase_render(dev)
    launches = phase_train(dev, card)
    for entry in kernels[1:]:
        entry["launches"] = launches[entry["name"]]
    march = phase_kernel_march(dev)
    march["launches"] = phase_render_plenoxels(dev, card)
    march_bwd = phase_kernel_march_bwd(dev)
    train_launches = phase_train_plenoxels(dev, card)
    march["launches"] += train_launches["tile_march_fwd"]
    march_bwd["launches"] = train_launches["tile_march_bwd"]
    kernels += [march, march_bwd]
    log(f"chip_smoke: wall {time.perf_counter() - t0:.1f} s, build {build_s:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
