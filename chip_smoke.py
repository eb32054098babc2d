#!/usr/bin/env python3
"""Drive the PyTorch port's vanilla-NeRF, Plenoxels and NeRF-SH serving and
training paths and its PlenOctree pipeline on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

  build   nvcc compiles the nine kernel libraries for sm_90a, one
          process per source, all at once; g++ the host op
          (csrc/native_ops.cpp).
  kernel  each kernel against its plain PyTorch version on the card,
          then timed with CUDA events beside its bound and its plain
          version: the fused-MLP forward (K1f, on the wgmma core over the
          encoded route's buffer, forward_weights) on 8192 + 37 rows and at
          the render's fine level (786,432 rows); its weight-gradient
          backward (K1b, on the wgmma core over the same buffer and the dX
          buffer, backward_weights) on 8192 + 37 rows (also against
          float64 sums) and at a training step's fine level (294,912
          rows), each launched twice for the same bits, and on four
          training coarse levels (1,024 rays each) under the route's own
          output gradient (the compositing's and the MSE loss's;
          route_grad, route_rule: the float64 rule's reading logged, not
          held, since it swings with the few rows that carry that g); the fused
          train level (K2) at a training step's coarse level (S 96, R 8,
          1,024 rays, with weights; a second launch must give the same
          bits), fine level (S 288, R 4) and once with encoded inputs, and
          its gradients against float64 sums at a 128-ray coarse level;
          then K2's split into its launches at both levels
          (torch.profiler), beside the forward alone at the same rows and
          a bf16 torch.matmul yardstick of the ten layer products, and
          K1rb's split at a training step's fine level (294,912 rows).
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
          must fall and stay finite), one step's calls that wait for the
          card (torch.cuda.set_sync_debug_mode: none on either route),
          then a short torch.profiler trace of each route splitting the
          card's time into the hand-written kernels and the rest.
  kernel_march
          the Plenoxels tile march (K3) against its plain PyTorch version
          on the card: a random 32^3 grid (basis_dim 9) with tiles of 128,
          256 and 512 rays; a 32^3 grid built to stress the kernel's
          empty-space skip (data only in the central 2x2x2 bricks and one
          brick on the upper x face) on camera tiles, rays grazing the
          bricks' faces and rays entering through the upper face; then
          one 800x800 frame at 512^3 (the fog scene below) in 16x32-ray
          tiles, compared tile by tile; then that frame's march timed with
          CUDA events beside its bound (the bricks it touches and its rays
          over HBM bandwidth, the float operations of the samples that can
          reach data, the shaded ones and a brick step per skipped brick
          over the float32 rate; the first port's bound, every marched
          sample, beside it) and the plain version.
  kernel_raw
          the fused MLP on raw points, posenc in the kernel: its forward
          (K1rf) against its plain version on 8192 + 37 rows and at the
          render's fine level (786,432 rows), equal bit for bit to K1f
          over K1rf's weights on the same rows' encodings (_encode_tile:
          the in-kernel encoder against the host's); its weight-gradient
          backward (K1rb, on the wgmma core) against its plain version on
          8192 + 37 and 16,385 rows (n = 1 mod 128; both also against
          float64 sums) and at a training step's fine level (294,912
          rows), each size launched twice for the same bits and equal bit
          for bit to K1b over K1rb's weights on the same rows' encodings,
          and under the route's own output gradient on four training
          coarse levels (route_rule); the
          parameter gradients of
          the raw route (fused_apply_raw, through unpack_grads'
          raw layout) against the encoded route's (K1f + K1b). Points
          U[-4, 4], unit view directions, random biases. Both timed with
          CUDA events beside their bounds, their plain versions and K1f
          or K1b on the same rows.
  render_raw
          the render phase's requests (lego configuration, 4096 rays,
          three cameras, random weights and biases from a seed) through
          render_rays(..., randomized=False) with a tagged
          fused_apply_raw (the reference's accepts_raw_points route):
          the first request per camera checked against the same render
          through K1rf's plain version (tail flips counted) and, on
          average, against the encoded route (K1f); then requests back
          to back for WINDOW_S seconds, K1rf's launches zeroed just
          before the first request and read just after the window.
  train_raw
          the train phase's flagship configuration with the MLP on raw
          points (K1rf + K1rb under autograd): render_rays with a tagged
          fused_apply_raw, MSE(fine) + MSE(coarse), torch.autograd.grad
          and Adam through NeRFTrainer. First the transmittance's
          gradient (ops/render.py) against autograd through
          torch.cumprod at a training step's shapes, and one step on 64
          rays against the plain versions on the host (the coarse
          model's gradients at the gradient gates); then 3 warm steps
          and WINDOW_S seconds: rays/s, step ms, the first and last loss
          (it must fall and stay finite), K1rf and K1rb launches (zeroed
          just before, read just after), one step's waiting calls (none)
          and a profile of 5 steps.
  render_plenoxels
          render_frame_pallas (one K3 launch a frame, per-ray early stop)
          at bench.py's two frame configurations: 512^3, basis_dim 9,
          step 0.5, 800x800 frames from bench.py's frame_tiles poses, on
          the fog scene (density U[0, 2], SH N(0, 0.2^2) on every cell of
          the sphere) and the opaque shell (bricks at radius 0.85-1.02,
          density U[500, 1500]); both grids are built on the card. Frames
          run back to back for WINDOW_S seconds; frames/s, ms a frame,
          bricks, GB on the card, K3 launches (zeroed just before, read
          just after) and samples marched; every frame of each scene is
          checked against the plain version; K3 alone timed on frame 0
          with CUDA events, with and without early stop, beside the first
          port's per-sample march cut after its link reads, after its
          densities and whole (tile_march_fwd_probe).
  render_plenoxels_eval
          cli/render_imgs.py's per-ray routes (plain torch, no kernel) on
          render_plenoxels' fog and shell 512^3 grids as SparseGrids
          (to_sparse_grid) and frame 0's 800x800 camera: one frame through
          render_grid_image with the CLI's fast keywords (occupancy at 256
          active steps, top-48 colour, bf16 density cache), finite, acc in
          [0, 1]; on a chunk of 16,384 rays (the CLI's default) the top-K
          identity with a float32 cache against the same call without
          color_top_k (equal acc; per ray and channel exact - fast in
          [0, (acc - the top-48 weight) x the ray's largest colour]); the
          frame with the bf16 cache against the float32 cache (the scene's
          densities and the same jittered below bf16's resolution), under
          stated gates; the exact route without occupancy on that chunk
          (its peak memory, beside the first port's eight-corner trilerp);
          ms a frame and peak memory of the fast route and of the exact
          route with occupancy beside K3's frame route, and the share of
          rays that the 256 active steps cut short.
  kernel_march_bwd
          the tile march's backward (K4) against its plain PyTorch
          version on the card (BWD_CASES): a random 32^3 grid whose rays
          stop (density U[20, 60]) with tiles of 128, 256 and 512 rays,
          tiles of 100 rays and of 1 (partial warps), the skip grid of
          kernel_march on camera tiles and on its grazing and upper-face
          rays (the kernel's probe counts the samples each ray visits,
          held to the host twin's count, kernel_visits; the twins count
          the samples skipped and the adds),
          basis 1 and 25 beside 9, the bias and sigmoid decodes, the
          beta and sparsity losses off and on; then one training batch
          of the fog scene at 256^3 (40 tiles of 8x16 rays); each
          gradient tensor within BWD_FRO_TOL (relative Frobenius) and
          BWD_MAX_TOL of its largest entry. Then that batch's backward
          timed with CUDA events beside its bound, the plain version, the
          same kernel without its global adds (tile_march_bwd_probe), the
          wrapper's zero fill and the forward (K3), with the samples it
          visits by its probe's count beside the host twin's; the probe
          with the sparsity loss on marches each ray to its exit and must
          visit the samples that K3 visits by the host twin; and the add
          instructions it issues (backward_flushes, host twin) beside the
          first port's scalar adds.
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
          first and last MSE (the loss must fall and stay finite); K3
          and K4 alone timed on the batch with CUDA events beside their
          bounds, K4 with its probe, zero fill and its visits and adds
          as in kernel_march_bwd.
  train_plenoxels_sparse
          the row-sparse steps (train/plenoxels_sparse.py) on the same
          batches, against the dense step, then the training CLI (see
          phase_train_plenoxels_sparse).
  train_plenoxels_bg
          the cell route's background and learned-basis steps (plain
          torch, no kernel) on the fog 256^3 grid as a SparseGrid, 5,120
          rays a step: train_step_bg with BackgroundMSI.create(), and
          train_step_with_basis with a 3D texture (reso 16, basis 9) and
          with the MLP (width 16); 10 steps of each (the loss falls), one
          step of each under set_sync_debug_mode (no waits), one step of
          each on 256 rays on the card and on the host from one state and
          the same TV windows (gradients and updates held), device ms a
          step and peak memory beside train_step; a ReferenceBackground
          behind the grid on 4,096 rays against the host's render; the
          full-grid TV loss over build_neighbor_links (the g++ host op,
          held to its numpy version).
  kernel_sh
          the fused NeRF-SH trunk's forward (K5f, on the wgmma core)
          against its plain PyTorch version on 1, 100, 8192 + 1 and
          8192 + 37 rows at each head width the kernel builds (27, 48, 75,
          128 columns) and at a serving request's fine level (1,572,864
          rows, sh_deg 3), each launched twice for the same bits; its
          weight-gradient backward (K5b, on the wgmma core too, over the
          forward's buffer and its dX buffer, backward_weights) against
          its plain version on 1, 100 and 8192 + 1 rows and on 8192 + 37
          rows, four draws at each width, and at a training step's fine
          level (196,608 rows), the same bits on a second launch, and
          against float64 sums (SH_NOISE_FACTOR) from 8,192 rows up (at 1
          and 100 rows that reading is logged, and the kernel gives the
          same bits on the rows zero-padded to a whole 128-row tile), with
          a control (dW summed in bf16) that the float64 rule must refuse;
          both timed with CUDA events beside their bounds and their plain
          versions.
  render_nerf_sh
          requests of 8,192 rays (NeRFSHFlags.chunk; 64x128 patches of the
          render phase's three cameras) through NeRFSHTrainer.render_eval
          at the reference's Blender NeRF-SH configuration (sh_deg 3,
          8x256 trunk, 64 + 128 samples, near 2, far 6, white background;
          build_model with use_fused_trunk), random weights and biases
          from a seed. The first request per camera is checked against
          K5f's plain version (tail flips counted) and the float32
          modules; then requests back to back for WINDOW_S seconds, with
          K5f's launches zeroed just before and read just after; then
          one request under torch.cuda.set_sync_debug_mode, which must
          make no call that waits for the card.
  train_nerf_sh
          NeRFSHTrainer at that configuration on make_dataset(n_views=2,
          image_size=128), 1,024 rays a step: one step on 64 rays against
          the host's plain versions with sparsity and weight decay on
          (both models' gradients; the host step takes the card's fine
          depths); then 3 warm steps and WINDOW_S seconds at
          sparsity_weight 0, as bench.py's nerf_sh_train: rays/s, step
          ms, the first and last loss (it must fall and stay finite), K5f
          and K5b launches, peak memory; then one step's waiting calls
          (none) and a profile of 5 steps, the card's busy time a step
          split into K5f's launches, K5b's and the rest.
  train_nerf_loop
          train/loop.py::train at the lego configuration (a config dict,
          no YAML: 64 + 128 samples, viewdirs, white background, 1,024
          rays a step, lrate 5e-4 decaying over 500k steps, precrop_frac
          0.5) on make_dataset's scene at half-res lego's size (400^2,
          4 train views, 1 test view), 60 steps a route: batching on the
          autograd route (i_print 20, i_weights 30, i_testset 60); the
          same resumed from its step-30 checkpoint (the restored models,
          Adam moments and generator equal to the file's); no_batching
          with precrop_iters 20; the mega route (K2) through
          trainer_kwargs; a forward-facing NDC scene at fern's factor-8
          size (504x378). Each: losses finite and falling, the files,
          metrics.json's PSNR against a direct render_image +
          compute_metrics, the loop's rays/s beside scan_steps', eval s
          a view, peak memory, K2's launches; one loop step of each draw
          under torch.cuda.set_sync_debug_mode (no waits).
  train_nerf_sh_cli
          cli/train_nerf_sh.py::train_main at sh_deg 3 (8x256, 64 + 128
          samples, 1,024 rays a step, use_fused_trunk) on
          make_dataset(n_views=4, image_size=128), 60 steps (print 20,
          save 30, render 60), then cli/eval_nerf_sh.py::evaluate from
          checkpoint.pt with flags.json restoring the model: K5f and K5b
          launches, view 0's MSE below the initial model's, the three
          JSON files, each view's PSNR against render_image_sh's.
  plenoctree
          the PlenOctree pipeline on train_nerf_sh_cli's run directory
          (main keeps it for both phases): train_main resumed to 500
          steps without the learning rate's delay, so that the density
          passes the extraction's threshold; the masked share of the
          autoscaled 512^3 cells (K5f on 134,217,728 rows) and the
          depth-8 tree's size from them; octree_tools extract --autoscale
          at depth 7 (OCTREE_EXTRACT_DEPTH says why; K5f at 65,536 rows
          a launch), 4,096 finest
          leaves held against the mean of their sample points through
          K5f's plain version; evaluate (the exact octree march, 1,024
          rays held against a step-at-a-time march on the host within
          1e-4) and evaluate --fast; finetune_fast for one epoch (K3 +
          K4; the baked grid's val PSNR must not fall); one
          OctreeFinetuner SGD step on 1,024 rays against the host's step,
          as updates; compress and compressed_eval (at most n_colors
          palette entries a basis, PSNR within 0.5 dB of evaluate's);
          gen_mesh --kind nerf_sh --reso 256 --iso 10; to_octree of
          render_plenoxels' 512^3 shell grid, then octree_to_grid, every
          occupied cell's density and SH back; gen_video's renderers
          (make_renderer) of a 64^3 grid npz, the extracted tree and the
          run, 4 poses at 128^2 each: finite frames, the grid's equal to
          render_grid_image's. The wall and peak of each step are printed.
  parallel: data parallelism (parallel/, NeRFTrainer(mesh=), the
          row-sharded Plenoxels state). (a) A one-rank NCCL group in this
          process: 20 steps of the mega route (K2) and of the fused-MLP
          route (K1f + K1b) through mesh= against the same steps without a
          group, the same bits, step ms of both, a step of each under
          set_sync_debug_mode. (b) Ranks in processes of their own
          (parallel/launch.py, parallel_rank): NCCL over every card when
          there are two or more, else two ranks sharing the card over gloo:
          5 steps of each route against one process on the same global
          batches (perturb on; each step's loss within 1e-5 and its
          gradients by the trainer's bounds at that step's parameters; the
          ranks' parameters the same bits after every step; K2 runs with
          n_rays_total twice its rows), a 4,096-ray request through
          render_rays_sharded against render_image, and 3 touched steps at
          fog 256^3 on a state row-sharded over the ranks against the
          one-process step, each rank's cells equal to the owners'
          masters, the float32 bytes a rank holds beside one process's.

Each MLP kernel is also timed at every level size its main paths launch
it at (a serving request's and a training step's coarse and fine
levels), and a "rule2:" line orders the kernels by launches x (ms -
bound) summed over those sizes.

Output: progress lines, a `{"kernels": [...]}` JSON line, the card's
name and power limit as nvidia-smi gives them, and last
`{"ok": true, "device": {...}}`. Without a card it exits non-zero and
prints no result. A watchdog ends the process if it runs past
WATCHDOG_S seconds.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import faulthandler
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

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
LOOP_COARSE, LOOP_FINE = 64, 128  # samples per ray: the training loop's lego configuration
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


LIBRARIES = ("fused_mlp_fwd", "fused_mlp_bwd", "fused_train", "tile_march_fwd", "tile_march_bwd", "fused_sh_fwd",
             "fused_sh_bwd", "fused_mlp_raw_fwd", "fused_mlp_raw_bwd")


def phase_build():
    from nerf_projects_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    builds = _build.build_all(LIBRARIES)  # one nvcc per source, all at once
    builds["native_ops (g++)"] = _build.build_host("native_ops")  # the host op of the full-grid TV loss
    for name, b in builds.items():
        log(f"build: {name} {b.seconds:.1f} s -> {b.path.name}")
        entry, injected = "", 0
        for line in b.log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
                entry = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", entry)  # the anonymous namespace
            elif "warpgroup.arrive is injected" in line:
                injected += 1
            elif "Used" in line or "spill" in line:
                log(f"  ptxas: {name}: {entry[:72]}: {line.strip()}")
        if injected:
            log(f"  ptxas: {name}: {injected} warpgroup.arrive injected between wgmmas (registers written under them)")
    return time.perf_counter() - t0


def noise_ratio(got, want, exact) -> tuple:
    """The float64 rule's reading: over the gradient tensors, the largest
    ratio of the kernel's relative Frobenius distance from the float64
    sums (``exact``) to the float32 plain version's (+ 1e-5), and the
    index of that tensor."""
    worst = (0.0, 0)
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        e = e.double()
        en = e.norm() + 1e-30
        r = float((g.double() - e).norm() / en) / (float((w.double() - e).norm() / en) + 1e-5)
        worst = max(worst, (r, i))
    return worst


def check_grads(tag, got, want, names, exact=None, noise_factor=NOISE_FACTOR) -> float:
    """Each gradient tensor of the kernel against the plain version's:
    relative Frobenius error below GRAD_FRO_TOL and the largest entry's
    error below GRAD_MAX_TOL of the largest |plain|. The two round to bf16
    at the same points and sum float32 in another order, so a relu mask
    or a bf16 rounding that flips moves a whole column of dW. With
    ``exact`` (the plain version with float64 sums, on the same output
    gradient), the kernel must also be no further from it than
    ``noise_factor`` times the float32 plain version is (+ 1e-5). Returns
    the largest absolute error."""
    max_abs, worst = 0.0, {"fro": (0.0, ""), "max": (0.0, "")}
    for name, g, w in zip(names, got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag}: non-finite gradient {name}")
        d = (g - w).double()
        max_abs = max(max_abs, float(d.abs().max()))
        vals = {"fro": float(d.norm() / (w.double().norm() + 1e-30)),
                "max": float(d.abs().max() / (w.abs().max().double() + 1e-30))}
        for k, v in vals.items():
            worst[k] = max(worst[k], (v, name))
    msg = (f"{tag}: grads max_abs_err={max_abs:.3e}; worst relative Frobenius error {worst['fro'][0]:.3e} "
           f"({worst['fro'][1]}, tolerance {GRAD_FRO_TOL}), worst entry {worst['max'][0]:.3e} of scale "
           f"({worst['max'][1]}, tolerance {GRAD_MAX_TOL})")
    noise = 0.0
    if exact is not None:
        noise, i = noise_ratio(got, want, exact)
        msg += (f"; against float64 sums the kernel strays {noise:.3f}x as far as the float32 "
                f"plain version ({names[i]}, tolerance {noise_factor}x)")
    log(msg)
    if not (worst["fro"][0] < GRAD_FRO_TOL and worst["max"][0] < GRAD_MAX_TOL and noise <= noise_factor):
        raise AssertionError(f"{tag}: gradients disagree with the plain version")
    return max_abs


def check_waits(tag, fn, most: int) -> None:
    """Run ``fn()`` once under torch.cuda.set_sync_debug_mode("warn"):
    at most ``most`` of its calls may wait for the card (the mode does not
    see every such call). Logs them by Python line."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in rec:
        if "synchroniz" in str(w.message):
            key = f"{w.filename}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    log(f"{tag}: {sum(sites.values())} calls wait for the card (at most {most})"
        + "".join(f"; {k} x{n}" for k, n in sites.items()))
    if sum(sites.values()) > most:
        raise AssertionError(f"{tag}: the host waits for the card")


def bound(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


SIZE_TIMES = {}  # kernel name -> {shape: (ms, bound ms)}, each shape a main path launches it at


def time_sizes(name: str, main_shape: str, main: tuple, shapes, launch, work) -> None:
    """Record a kernel's time and bound at main_shape, then time it with
    CUDA events at each (shape, rows) of ``shapes``: launch(rows) makes
    the inputs and returns a call of the kernel on them, work(rows) the
    (flops, bytes) of its bound."""
    SIZE_TIMES.setdefault(name, {})[main_shape] = main
    for shape, rows in shapes:
        fn = launch(rows)
        ms = time_ms(fn, iters=10)
        b_ms = bound(*work(rows))[0]
        SIZE_TIMES[name][shape] = (ms, b_ms)
        log(f"kernel sizes: {name} at a {shape} level ({rows} rows): {ms:.4f} ms, bound {b_ms:.4f} ms, "
            f"{b_ms / ms:.3f} of bound")
        del fn
    torch.cuda.empty_cache()


def rule2(paths: dict) -> None:
    """Log each kernel's launches x (ms - bound), summed over the shapes
    its main paths launched it at (paths: kernel name -> {shape:
    launches}), and the kernels in that order."""
    order = []
    for name, shapes in paths.items():
        terms = [(shape, n) + SIZE_TIMES[name][shape] for shape, n in shapes.items()]
        total = sum(n * (ms - b) for _, n, ms, b in terms)
        order.append((total, name))
        log(f"rule2: {name}: {total:.1f} ms = " + " + ".join(
            f"{n:g} x ({ms:.4f} - {b:.4f}) [{shape}]" for shape, n, ms, b in terms))
    log("rule2: order: " + ", ".join(f"{name} {t:.1f}" for t, name in sorted(order, reverse=True)))


SERVE_COARSE, SERVE_FINE = PATCH * PATCH * 64, PATCH * PATCH * (64 + 128)
TRAIN_COARSE, TRAIN_FINE = TRAIN_RAYS * COARSE, TRAIN_RAYS * (COARSE + FINE)


def phase_kernel(dev, fine_rows: int) -> dict:
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    W = fm.pack_params(model)
    wk = fm.forward_weights(model, raw=False)  # the buffer the encoded route hands K1f
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
    del x, v

    def launch(n):
        xv = encodings(n, gen, dev)
        return lambda: fm.fused_mlp_fwd(wk, *xv)

    time_sizes("fused_mlp_fwd", "serving fine", (ms, bound_ms),
               (("serving coarse", SERVE_COARSE), ("training coarse", TRAIN_COARSE), ("training fine", TRAIN_FINE)),
               launch, lambda n: (2.0 * fm.LIVE_MACS_PER_SAMPLE * n,
                                  fm.IO_BYTES_PER_SAMPLE * n + wk.numel() * wk.element_size()))
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


def route_grad(gen, W, dev, raw: bool, n_rays: int = TRAIN_RAYS):
    """A seeded training coarse level (level_batch: S COARSE, R MEGA_RC,
    n_rays rays) as the route's MLP sees it, with the route's own output
    gradient: (x, v, g [n, 8]) per row, g the compositing's and the MSE
    loss's gradient (fused_train.composite_grads, K2's arithmetic) at the
    plain forward's head outputs (rgb 0..2, sigma 4) over W. K1b's encoded
    rows are the route's (x column 63 zero, v the view encoding); K1rb's
    the raw points and directions. K2's forward without its per-slab
    promotion read 6.585x on the float64 rule under such a g."""
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft

    x, vt = level_batch(gen, n_rays, COARSE, MEGA_RC, dev, raw)
    per_ray = vt[:, :MEGA_RC].reshape(n_rays, vt.shape[-1])
    if raw:
        dist, target = x[:, 3], per_ray[:, 4:7]
        v = per_ray.repeat_interleave(COARSE, dim=0).contiguous()
        out = fm.fused_nerf_mlp_raw_reference(W, x, v)
    else:
        dist, target = x[:, 63].clone(), per_ray[:, 28:31]
        x = x.clone()
        x[:, 63] = 0.0
        v = F.pad(per_ray[:, :27], (0, 5)).repeat_interleave(COARSE, dim=0).contiguous()
        out = fm.fused_nerf_mlp_reference(W, x, v)
    _, _, _, d_rgb, d_sig = ft.composite_grads(out[:, :3], out[:, 4], dist, target, S=COARSE,
                                               n_rays_total=n_rays, bkgd=1.0)
    g = torch.zeros(x.shape[0], 8, device=dev)
    g[:, :3], g[:, 4] = d_rgb, d_sig
    return x, v, g


ROUTE_DRAWS = 4             # training coarse levels checked under the route's own g


def route_rule(tag, launch, ref, W, wk, wkt, gen, dev, raw: bool) -> float:
    """The kernel against its plain version (GRAD_FRO_TOL, GRAD_MAX_TOL) on
    each of ROUTE_DRAWS seeded training coarse levels (route_grad: 1,024
    rays, 98,304 rows) under the route's own output gradient, and the
    float64-sums rule's reading there, logged but not held to
    NOISE_FACTOR: only rows near a ray's surface carry that gradient, so
    one relu mask or bf16 rounding of the forward that flips on such a row
    moves a column of dW, and the tensor cores' float32 sums flip more of
    them than the float32 plain version's. Promoted K1b and K1rb read
    0.06x to 95.5x on single levels, their forwards without PROMOTE 0.06x
    to 336x, some levels reading the same for both (PERF.md §6): no limit
    at 2x tells the two apart. Returns the largest absolute error."""
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    names = fm.FusedMLPWeights._fields
    max_abs = 0.0
    for draw in range(ROUTE_DRAWS):
        x, v, g = route_grad(gen, W, dev, raw)
        got, want = launch(wk, wkt, x, v, g), ref(W, x, v, g)
        with fm.float64_sums():
            exact = ref(W, x, v, g)
        torch.cuda.synchronize()
        max_abs = max(max_abs, check_grads(f"{tag} n={x.shape[0]} draw {draw}", got, want, names))
        ratio, i = noise_ratio(got, want, exact)
        del got, want, exact
        log(f"{tag} n={x.shape[0]} draw {draw}: against float64 sums the kernel strays {ratio:.3f}x as far as the "
            f"float32 plain version ({names[i]}; a reading, not held to {NOISE_FACTOR}x)")
    return max_abs


def phase_kernel_bwd(dev, big_rows: int) -> dict:
    """K1b against its plain version on a ragged size and at the fine
    level's rows of a training step (each also a second launch's bits),
    against float64 sums on the ragged size, on training coarse levels
    under the route's own g (route_rule: the float64 rule's reading
    logged), then timed at the fine level."""
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 2)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    W = fm.pack_params(model)
    wk, wkt = fm.backward_weights(model, False, fm.forward_weights(model, raw=False))  # the encoded route's
    max_abs = 0.0
    for n in (8192 + 37, big_rows):
        x, v = encodings(n, gen, dev)
        g = (torch.randn(n, 8, generator=gen) * 1e-3).to(dev)
        got = fm.fused_mlp_bwd(wk, wkt, x, v, g)
        again = fm.fused_mlp_bwd(wk, wkt, x, v, g)
        want = fm.fused_mlp_bwd_reference(W, x, v, g)
        exact = None
        if n < big_rows:
            with fm.float64_sums():
                exact = fm.fused_mlp_bwd_reference(W, x, v, g)
        torch.cuda.synchronize()
        tag = f"kernel: fused_mlp_bwd n={n}"
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"{tag}: a second launch gives the same bits: {same}")
        if not same:
            raise AssertionError(f"{tag}: two launches on the same inputs differ")
        max_abs = max(max_abs, check_grads(tag, got, want, fm.FusedMLPWeights._fields, exact))
    max_abs = max(max_abs, route_rule("kernel: fused_mlp_bwd on a coarse level under the route's own g",
                                      fm.fused_mlp_bwd, fm.fused_mlp_bwd_reference, W, wk, wkt, gen, dev,
                                      raw=False))

    ms = time_ms(lambda: fm.fused_mlp_bwd(wk, wkt, x, v, g), iters=10)
    plain_ms = time_ms(lambda: fm.fused_mlp_bwd_reference(W, x, v, g), iters=3, warmup=1)
    # recomputed forward, dX and dW: three passes of live MACs
    flops = 3 * 2.0 * fm.LIVE_MACS_PER_SAMPLE * big_rows
    nbytes = (64 + 32 + 8) * 4 * big_rows + fm.GRAD_ELEMS * 4 + (wk.numel() + wkt.numel()) * 2
    bound_ms, by, t_ops, t_bytes = bound(flops, nbytes)
    log(f"kernel: fused_mlp_bwd n={big_rows}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {bound_ms / ms:.3f} of bound")

    def launch(n):
        xv = encodings(n, gen, dev)
        gn = (torch.randn(n, 8, generator=gen) * 1e-3).to(dev)
        return lambda: fm.fused_mlp_bwd(wk, wkt, *xv, gn)

    time_sizes("fused_mlp_bwd", "training fine", (ms, bound_ms), (("training coarse", TRAIN_COARSE),), launch,
               lambda n: (3 * 2.0 * fm.LIVE_MACS_PER_SAMPLE * n,
                          (64 + 32 + 8) * 4 * n + fm.GRAD_ELEMS * 4 + (wk.numel() + wkt.numel()) * 2))
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
    weights; a second launch must give the same bits), the fine level (S
    288, R 4), the training loop's lego levels (S 64, R 8 and S 192, R 4)
    and, once, with encoded inputs; its gradients at a 128-ray coarse
    level against float64 sums; then each level timed. Rays whose last
    sample's weight changes sign (the 1e10 tail) are counted, not
    compared."""
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft

    gen = torch.Generator().manual_seed(SEED + 3)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    wkt = fm.kernel_weights_sm90_bwd(model)
    # the loop's levels draw from a generator of their own: the other
    # levels and the float64 check below keep their inputs, and that
    # check's rule reads differently draw by draw (chip_probes.py k2f64)
    loop_gen = torch.Generator().manual_seed(SEED + 32)
    shapes = (("coarse", COARSE, MEGA_RC, True, True, gen), ("fine", COARSE + FINE, MEGA_RF, False, True, gen),
              ("loop coarse", LOOP_COARSE, MEGA_RC, True, True, loop_gen),
              ("loop fine", LOOP_COARSE + LOOP_FINE, MEGA_RF, False, True, loop_gen),
              ("coarse, encoded inputs", COARSE, MEGA_RC, True, False, gen))
    max_abs, timed = 0.0, {}
    for tag, S, R, want_w, raw, draw in shapes:
        x, vt = level_batch(draw, TRAIN_RAYS, S, R, dev, raw)
        wk, W = fm.kernel_weights_sm90(model, raw_layout=raw), fm.pack_params(model, raw_layout=raw)
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
        if want_w:
            again = ft.fused_train_level(wk, wkt, x, vt, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got[:3] + tuple(got[3]), again[:3] + tuple(again[3])))
            log(f"{tag}: a second launch gives the same bits: {same}")
            if not same:
                raise AssertionError(f"{tag}: two launches on the same inputs differ")
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
    # the gradients' sum order against float64 sums, at a small coarse level
    n_small = 128
    x, vt = level_batch(gen, n_small, COARSE, MEGA_RC, dev, raw=True)
    wk, W = fm.kernel_weights_sm90(model, raw_layout=True), fm.pack_params(model, raw_layout=True)
    kw = dict(S=COARSE, R=MEGA_RC, n_rays_total=n_small, bkgd=1.0, want_weights=False, raw_inputs=True)
    got = ft.fused_train_level(wk, wkt, x, vt, **kw)[3]
    want = ft.fused_train_level_reference(W, x, vt, **kw)[3]
    with fm.float64_sums():
        exact = ft.fused_train_level_reference(W, x, vt, **kw)[3]
    torch.cuda.synchronize()
    max_abs = max(max_abs, check_grads(f"kernel: fused_train_level coarse (S {COARSE}, R {MEGA_RC}, {n_small} rays)",
                                       got, want, fm.FusedMLPWeights._fields, exact))
    # a training step launches both levels: its numbers are the sums
    for step, levels in (("training step", (COARSE, COARSE + FINE)),
                         ("loop step", (LOOP_COARSE, LOOP_COARSE + LOOP_FINE))):
        ms, plain_ms, b_ms = (sum(timed[S][i] for S in levels) for i in range(3))
        log(f"kernel: fused_train_level per {step} (coarse + fine, S {levels}): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms, {b_ms / ms:.3f} of bound")
        SIZE_TIMES.setdefault("fused_train_level", {})[step] = (ms, b_ms)
    # the kernels line's times are the flagship training step's
    ms, plain_ms, b_ms = (sum(timed[S][i] for S in (COARSE, COARSE + FINE)) for i in range(3))
    return {
        "name": "fused_train_level", "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/fused_train.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/fused_train.py:215",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": timed[COARSE + FINE][3], "library_ms": None,
    }


def kernel_split(run, n: int = 5) -> dict:
    """torch.profiler over n calls of ``run``: the card's time a call by
    kernel name (ms), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            times[e.key] = times.get(e.key, 0.0) + float(getattr(e, "self_device_time_total", 0.0)) / n / 1e3
    return dict(sorted(times.items(), key=lambda kv: -kv[1]))


def matmul_yardstick(dev, rows: int) -> float:
    """The ten large layer products of the MLP (trunk_0..7, the bottleneck,
    the view layer) as bf16 torch.matmul calls at ``rows`` rows, timed with
    CUDA events: a diagnostic of the card's GEMM rate at these shapes, not a
    kernel of the port and not its library_ms."""
    shapes = [(64, 256)] + [(256, 256)] * 4 + [(320, 256)] + [(256, 256)] * 3 + [(288, 128)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ins = {k: torch.randn(rows, k, generator=gen, device=dev).bfloat16() for k in {k for k, _ in shapes}}
    ws = [torch.randn(k, n, generator=gen, device=dev).bfloat16() for k, n in shapes]
    ms = time_ms(lambda: [torch.matmul(ins[k], w) for (k, _), w in zip(shapes, ws)], iters=10)
    flops = 2.0 * rows * sum(k * n for k, n in shapes)
    log(f"split: yardstick, the ten layer products as bf16 torch.matmul at {rows} rows: {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s)")
    del ins, ws
    torch.cuda.empty_cache()
    return ms


def profile_train_split(dev) -> dict:
    """K2 (ft.train_level on raw inputs, the mega route's call) split into
    its launches by kernel name at a training step's coarse level (S 96,
    R 8, with weights) and fine level (S 288, R 4), beside the forward
    alone at the same rows (fused_apply_raw: K1rf, which writes no stash),
    and the matmul yardstick at the fine level's rows; then K1rb split at
    the fine level's rows, through the raw route's autograd (K1rf's forward,
    K1rb's launches, the gradients' unpacking). Public entry points only,
    so it splits any checkout's K2 and K1rb."""
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft

    gen = torch.Generator().manual_seed(SEED + 3)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    out = {}
    for tag, S, R, want_w in (("coarse", COARSE, MEGA_RC, True), ("fine", COARSE + FINE, MEGA_RF, False)):
        x, vt = level_batch(gen, TRAIN_RAYS, S, R, dev, raw=True)
        kw = dict(S=S, R=R, n_rays_total=TRAIN_RAYS, bkgd=1.0, want_weights=want_w, raw_inputs=True)
        with torch.no_grad():
            split = kernel_split(lambda: ft.train_level(model, x, vt, **kw))
            pts = x[:, :3].contiguous()
            dirs = vt[:, :R, :3].reshape(-1, 3).repeat_interleave(S, dim=0).contiguous()
            fwd = kernel_split(lambda: fm.fused_apply_raw(model, pts, dirs))
        n_rows = TRAIN_RAYS * S
        total = sum(split.values())
        log(f"split: K2 {tag} level ({n_rows} rows), {total:.4f} ms a call on the card: "
            + "; ".join(f"{k[:48]} {v:.4f} ms" for k, v in split.items() if v >= 0.001))
        name, ms = next(iter(fwd.items()), ("none", 0.0))
        log(f"split: the forward alone at the {tag} level's rows (fused_apply_raw, no stash): {name[:48]} {ms:.4f} ms")
        out[tag] = (split, ms)
    matmul_yardstick(dev, TRAIN_FINE)
    p, v = raw_inputs(TRAIN_FINE, gen, dev)
    pts, dirs = p[:, :3].contiguous(), v[:, :3].contiguous()
    cot = (torch.randn(TRAIN_FINE, 4, generator=gen) * 1e-3).to(dev)
    params = list(model.parameters())
    split = kernel_split(lambda: torch.autograd.grad((fm.fused_apply_raw(model, pts, dirs) * cot).sum(), params))
    log(f"split: K1rb at the training fine level's rows ({TRAIN_FINE}) through the raw route's autograd, "
        f"{sum(split.values()):.4f} ms a call on the card: "
        + "; ".join(f"{k[:48]} {v:.4f} ms" for k, v in split.items() if v >= 0.001))
    out["raw backward"] = split
    return out


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


OUR_KERNELS = ("mlp_grad_reduce_kernel", "sm90_fwd_kernel", "sm90_dx_kernel", "sm90_dw_kernel", "composite_kernel",
               "march_kernel", "march_bwd_kernel", "sh_grad_reduce_kernel")


def profile_steps(run_steps, route: str, n: int = PROFILE_STEPS, split=None, top: int = 6):
    """torch.profiler over ``run_steps(n)`` (n training steps; its result
    is returned): the card's busy time split into the port's hand-written
    kernels and everything else (the glue), with the largest glue
    kernels, and the idle share of the host-clock window. ``split`` maps
    a label to a pattern of kernel names: the busy time a step of each
    such share is logged too. ``top``: the glue kernels listed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run_steps(n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ours, glue, shares = 0.0, {}, dict.fromkeys(split or {}, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue  # ranges such as Optimizer.step span kernels already counted
        us = float(getattr(e, "self_device_time_total", 0.0))
        if any(k in e.key for k in OUR_KERNELS):
            ours += us
        else:
            glue[e.key] = glue.get(e.key, 0.0) + us
        for label, pattern in (split or {}).items():
            if re.search(pattern, e.key):
                shares[label] += us
    waits = {e.key: (e.count / n, e.cpu_time_total / n / 1e3) for e in prof.key_averages()
             if e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize")}
    busy = ours + sum(glue.values())
    if busy <= 0:
        log(f"profile: {route}: the profiler saw no device time; kernel and glue shares not measured")
        return result
    top = sorted(glue.items(), key=lambda kv: -kv[1])[:top]
    log(f"profile: {route}, {n} steps: host window {wall_us / n / 1e3:.4f} ms a step; device busy "
        f"{busy / n / 1e3:.4f} ms a step (idle share {1 - busy / wall_us:.3f}): hand-written kernels "
        f"{ours / n / 1e3:.4f} ms, other kernels {(busy - ours) / n / 1e3:.4f} ms; largest others: "
        + "; ".join(f"{k[:60]} {v / n / 1e3:.4f} ms" for k, v in top)
        + "; host calls that can wait on the card, per step: "
        + ", ".join(f"{k} {c:.1f} calls {ms:.4f} ms" for k, (c, ms) in sorted(waits.items())))
    if split:
        log(f"profile: {route}: device busy a step by share: " + ", ".join(
            f"{label} {us / n / 1e3:.4f} ms" for label, us in shares.items())
            + f", the rest {(busy - sum(shares.values())) / n / 1e3:.4f} ms (idle share {1 - busy / wall_us:.3f})")
    return result


def hold_step(tag, on_card, on_host, rays, target) -> None:
    """One step's loss and fine MSE (within 3e-3 relative) and coarse
    gradients (check_grads) of a trainer on the card against the same
    trainer on the host, which runs the kernels' plain versions, from the
    same random models (biases too) on the same rays."""
    gen = torch.Generator().manual_seed(SEED + 4)
    params = tuple(random_biases(m, gen) for m in on_card.init_params(SEED))
    host_params = tuple(copy.deepcopy(m).cpu() for m in params)
    (loss, mse), grads = on_card._value_and_grad(params, None, rays, target)
    (hloss, hmse), hgrads = on_host._value_and_grad(host_params, None, rays.map(lambda t: t.cpu()), target.cpu())
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
        hold_step(f"train: one {'fused train-level' if mega else 'fused-MLP autograd'} step of {CHECK_RAYS} rays",
                  make(mega, check), make(mega, check, "cpu"), rays, target)

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
        # neither route reads anything back: the transmittance's backward
        # (ops/render.py::_Cumprod) tests nothing on the host
        check_waits(f"train: {route}, one step",
                    lambda: trainer.scan_steps(state, ds["rays"], ds["pixels"], 1, batch_size=TRAIN_RAYS), 0)
        profile_steps(lambda n: trainer.scan_steps(state, ds["rays"], ds["pixels"], n, batch_size=TRAIN_RAYS)[0],
                      route)
    return {"fused_train_level": out[True]["fused_train_level"],
            "fused_mlp_bwd": out[False]["fused_mlp_bwd"], "fused_mlp_fwd": out[False]["fused_mlp_fwd"]}


# ---------------------------------------------------------------------------
# Vanilla NeRF on raw points: the fused MLP with posenc in the kernel (K1rf, K1rb)
# ---------------------------------------------------------------------------

TRANSMITTANCE_TOL = 1e-6    # of scale: the same reverse cumulative sum over the factor as torch.cumprod's backward


def raw_inputs(n: int, gen: torch.Generator, dev) -> tuple:
    """Raw points U[-4, 4] (2^9 |p| reaches ~2,000 rad) and unit view
    directions [n, 8], columns 0..2 live, as fused_apply_raw pads them."""
    p = torch.zeros(n, 8)
    p[:, :3] = torch.rand(n, 3, generator=gen) * 8.0 - 4.0
    d = torch.randn(n, 3, generator=gen)
    v = torch.zeros(n, 8)
    v[:, :3] = d / d.norm(dim=-1, keepdim=True)
    return p.to(dev), v.to(dev)


def tagged(fn):
    """A wrapper of ``fn`` tagged ``accepts_raw_points``: render_rays then
    hands it raw points and per-row view directions."""
    def apply(params, pts, viewdirs):
        return fn(params, pts, viewdirs)
    apply.accepts_raw_points = True
    return apply


def model_grads(model, run, cot) -> dict:
    """The model's parameter gradients of sum(run() * cot)."""
    model.zero_grad(set_to_none=True)
    (run() * cot).sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def phase_kernel_raw(dev, serve_rows: int, train_rows: int) -> tuple:
    """K1rf against its plain version on a ragged size and at the render's
    fine level, equal bit for bit to K1f over K1rf's weights on the port's
    encodings of the same rows (the same core: the encoder alone differs);
    K1rb against its plain version on two ragged sizes (also against
    float64 sums) and at a training step's fine level, a second launch
    the same bits at each; the raw route's parameter gradients against
    the encoded route's. Then both timed beside their bounds, their plain
    versions and K1f / K1b on the same rows."""
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.posenc import posenc

    gen = torch.Generator().manual_seed(SEED + 30)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    model = random_biases(model, gen).to(dev)
    W = fm.pack_params(model, raw_layout=True)
    wk, wkt = fm.backward_weights(model, True, fm.forward_weights(model, raw=True))  # the raw route's buffers
    max_fwd = max_bwd = 0.0
    for n in (8192 + 37, serve_rows):
        p, v = raw_inputs(n, gen, dev)
        got = fm.fused_mlp_raw_fwd(wk, p, v)
        want = fm.fused_nerf_mlp_raw_reference(W, p, v)
        x, ve = fm._encode_raw(p, v)
        core = fm.fused_mlp_fwd(wk, x, ve)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel_raw: non-finite K1rf output at n={n}")
        scale = float(want.abs().mean()) + 1.0
        err = float((got - want).abs().max())
        # the kernel's sinf and torch.sin on the card give the same bits, so
        # K1rf and K1f on the port's encodings see the same bf16 inputs
        # through the same core and must agree exactly
        same = float((got == core).all(-1).float().mean())
        log(f"kernel_raw: fused_mlp_raw_fwd n={n} max_abs_err={err:.3e} err/(mean|plain|+1)={err / scale:.3e} "
            f"(tolerance {KERNEL_TOL}); against K1f over its weights on the port's encodings of the same rows: "
            f"{same:.6f} of rows the same bits (all must be)")
        if not (err / scale < KERNEL_TOL and torch.equal(got, core)):
            raise AssertionError(f"kernel_raw: fused_mlp_raw_fwd disagrees at n={n}")
        max_fwd = max(max_fwd, err)
    fwd_args = (p, v, x, ve)

    # 8192 + 37 and 128 * 128 + 1 rows leave ragged tiles (the padded rows'
    # stash must stay finite and add nothing); all eight g columns are live.
    # K1b over K1rb's weights on the port's encodings of the same rows has
    # the same stash, so the same gradients bit for bit
    for n in (8192 + 37, 128 * 128 + 1, train_rows):
        p, v = raw_inputs(n, gen, dev)
        g = (torch.randn(n, 8, generator=gen) * 1e-3).to(dev)
        got = fm.fused_mlp_raw_bwd(wk, wkt, p, v, g)
        again = fm.fused_mlp_raw_bwd(wk, wkt, p, v, g)
        core = fm.fused_mlp_bwd(wk, wkt, *fm._encode_raw(p, v), g)
        want = fm.fused_mlp_raw_bwd_reference(W, p, v, g)
        exact = None
        if n < train_rows:
            with fm.float64_sums():
                exact = fm.fused_mlp_raw_bwd_reference(W, p, v, g)
        torch.cuda.synchronize()
        tag = f"kernel_raw: fused_mlp_raw_bwd n={n}"
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        as_k1b = all(torch.equal(a, b) for a, b in zip(got, core))
        log(f"{tag}: a second launch gives the same bits: {same}; K1b over its weights on the port's encodings "
            f"of the same rows gives the same bits: {as_k1b}")
        if not same:
            raise AssertionError(f"{tag}: two launches on the same inputs differ")
        if not as_k1b:
            raise AssertionError(f"{tag}: K1b over its weights on the same rows' encodings gives other bits")
        max_bwd = max(max_bwd, check_grads(tag, got, want, fm.FusedMLPWeights._fields, exact))
    bwd_args = (p, v, g)
    del core
    max_bwd = max(max_bwd, route_rule("kernel_raw: fused_mlp_raw_bwd on a coarse level under the route's own g",
                                      fm.fused_mlp_raw_bwd, fm.fused_mlp_raw_bwd_reference, W, wk, wkt, gen, dev,
                                      raw=True))

    # the raw route maps K1rb's gradients back through unpack_grads' raw
    # layout, which its plain version shares: held against the encoded
    # route (K1f + K1b, the model's layout) on the same points
    n = 8192 + 37
    p, v = raw_inputs(n, gen, dev)
    pts, vd = p[:, :3].contiguous(), v[:, :3].contiguous()
    cot = (torch.randn(n, 4, generator=gen) * 1e-3).to(dev)
    raw = model_grads(model, lambda: fm.fused_apply_raw(model, pts, vd), cot)
    enc = model_grads(model, lambda: fm.fused_apply(model, posenc(pts, 10), posenc(vd, 4)), cot)
    names = list(raw)
    max_bwd = max(max_bwd, check_grads(f"kernel_raw: the raw route's parameter gradients (n={n}) against the "
                                       "encoded route's", [raw[k] for k in names], [enc[k] for k in names], names))

    p, v, x, ve = fwd_args
    ms = time_ms(lambda: fm.fused_mlp_raw_fwd(wk, p, v), iters=20)
    k1f_ms = time_ms(lambda: fm.fused_mlp_fwd(wk, x, ve), iters=20)
    plain_ms = time_ms(lambda: fm.fused_nerf_mlp_raw_reference(W, p, v), iters=5, warmup=1)
    flops = 2.0 * fm.LIVE_MACS_PER_SAMPLE * serve_rows
    b_ms, by, t_ops, t_bytes = bound(flops, fm.RAW_IO_BYTES_PER_SAMPLE * serve_rows + wk.numel() * 2)
    log(f"kernel_raw: fused_mlp_raw_fwd n={serve_rows}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), K1f on the "
        f"same rows' encodings {k1f_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms (operations "
        f"{t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {b_ms / ms:.3f} of bound")
    del p, v, x, ve

    def launch_fwd(n):
        pv = raw_inputs(n, gen, dev)
        return lambda: fm.fused_mlp_raw_fwd(wk, *pv)

    time_sizes("fused_mlp_raw_fwd", "serving fine", (ms, b_ms),
               (("serving coarse", SERVE_COARSE), ("training coarse", TRAIN_COARSE), ("training fine", TRAIN_FINE)),
               launch_fwd, lambda n: (2.0 * fm.LIVE_MACS_PER_SAMPLE * n,
                                      fm.RAW_IO_BYTES_PER_SAMPLE * n + wk.numel() * 2))
    fwd = {"name": "fused_mlp_raw_fwd", "route": "cuda", "source": "nerf_projects_tpu_torch/csrc/fused_mlp_raw_fwd.cu",
           "replaces": "nerf_projects_tpu/ops/pallas/fused_mlp.py:534", "launches": 0, "max_abs_err": max_fwd,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None}

    p, v, g = bwd_args
    x, ve = fm._encode_raw(p, v)
    ms = time_ms(lambda: fm.fused_mlp_raw_bwd(wk, wkt, p, v, g), iters=10)
    k1b_ms = time_ms(lambda: fm.fused_mlp_bwd(wk, wkt, x, ve, g), iters=10)
    plain_ms = time_ms(lambda: fm.fused_mlp_raw_bwd_reference(W, p, v, g), iters=3, warmup=1)
    flops = 3 * 2.0 * fm.LIVE_MACS_PER_SAMPLE * train_rows
    nbytes = fm.RAW_IO_BYTES_PER_SAMPLE * train_rows + fm.GRAD_ELEMS * 4 + (wk.numel() + wkt.numel()) * 2
    b_ms, by, t_ops, t_bytes = bound(flops, nbytes)
    log(f"kernel_raw: fused_mlp_raw_bwd n={train_rows}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), K1b on the "
        f"same rows' encodings {k1b_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms (operations "
        f"{t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {b_ms / ms:.3f} of bound")

    def launch_bwd(n):
        pv = raw_inputs(n, gen, dev)
        gn = (torch.randn(n, 8, generator=gen) * 1e-3).to(dev)
        return lambda: fm.fused_mlp_raw_bwd(wk, wkt, *pv, gn)

    time_sizes("fused_mlp_raw_bwd", "training fine", (ms, b_ms), (("training coarse", TRAIN_COARSE),), launch_bwd,
               lambda n: (3 * 2.0 * fm.LIVE_MACS_PER_SAMPLE * n, fm.RAW_IO_BYTES_PER_SAMPLE * n + fm.GRAD_ELEMS * 4
                          + (wk.numel() + wkt.numel()) * 2))
    bwd = {"name": "fused_mlp_raw_bwd", "route": "cuda", "source": "nerf_projects_tpu_torch/csrc/fused_mlp_raw_bwd.cu",
           "replaces": "nerf_projects_tpu/ops/pallas/fused_mlp.py:559", "launches": 0, "max_abs_err": max_bwd,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    return fwd, bwd


def phase_render_raw(dev, card: str) -> int:
    """The render phase's requests through render_rays with a tagged
    fused_apply_raw (K1rf): one request per camera, checked against K1rf's
    plain version and the encoded route, then requests back to back for
    WINDOW_S seconds. Returns K1rf's launches, zeroed just before the
    first request and read just after the window."""
    from nerf_projects_tpu_torch.core.rays import camera_rays, pose_spherical
    from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig, render_rays
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.train import NeRFTrainer

    cfg = NeRFRenderConfig(
        num_coarse_samples=64, num_fine_samples=128, multires=10, multires_views=4,
        use_viewdirs=True, white_bkgd=True, perturb=False,
    )
    trainer = NeRFTrainer(cfg, depth=8, width=256, use_fused_mlp=True, device=dev)
    gen = torch.Generator().manual_seed(SEED + 31)
    params = tuple(random_biases(m, gen) for m in trainer.init_params(SEED))
    K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1]], np.float32)
    requests = []
    for theta, r0, c0 in REQUESTS:
        rays = camera_rays(SIZE, SIZE, K, pose_spherical(theta, -30.0, 4.0), device=dev)
        requests.append(rays.map(lambda t: t[r0:r0 + PATCH, c0:c0 + PATCH].reshape(-1, 3).contiguous()))
    torch.cuda.synchronize()
    n_rays = PATCH * PATCH
    apply = tagged(fm.fused_apply_raw)

    @torch.no_grad()
    def serve(rays, fn=apply, p=params):
        return render_rays(None, p[0], p[1], fn, rays, trainer.near, trainer.far, cfg, randomized=False)

    fm.fused_mlp_raw_fwd.launches = 0
    outs = []
    for rays in requests:
        t0 = time.perf_counter()
        outs.append(serve(rays))
        torch.cuda.synchronize()
        log(f"render_raw: first request at theta {REQUESTS[len(outs) - 1][0]}: {time.perf_counter() - t0:.6f} s")
    secs = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < WINDOW_S:
        t0 = time.perf_counter()
        serve(requests[len(secs) % len(requests)])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    window = time.perf_counter() - t_window
    launches = fm.fused_mlp_raw_fwd.launches
    log(f"render_raw on {card}: {len(secs)} timed requests of {n_rays} rays in {window:.6f} s: "
        f"{len(secs) * n_rays / window:.1f} rays/s; request ms median {np.median(secs) * 1e3:.4f}, "
        f"min {min(secs) * 1e3:.4f}, max {max(secs) * 1e3:.4f}; "
        f"{launches} fused_mlp_raw_fwd launches in {len(requests) + len(secs)} requests")
    if launches <= 0:
        raise AssertionError("render_raw: the main path launched no fused_mlp_raw_fwd kernel")

    packed = tuple(fm.pack_params(m, raw_layout=True) for m in params)
    for i, (rays, out) in enumerate(zip(requests, outs)):
        for key in ("rgb", "acc", "depth", "disp"):
            if out[key].shape[0] != n_rays or not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"render_raw: request {i} {key} is not finite of {n_rays} rays")
        ref = serve(rays, tagged(fm.fused_apply_raw_reference), packed)
        # rays whose last sample's weight changes sign (the 1e10 tail) are counted, not compared
        flips = (out["weights"][:, -1] > 0) != (ref["weights"][:, -1] > 0)
        worst = float((out["rgb"] - ref["rgb"]).abs().amax(-1)[~flips].max())
        log(f"render_raw: request {i} vs K1rf's plain version: max |rgb| diff {worst:.3e} over "
            f"{int((~flips).sum())} rays, {int(flips.sum())} tail flips")
        if not worst <= RGB_TOL or int(flips.sum()) > MAX_TAIL_FLIPS * n_rays:
            raise AssertionError(f"render_raw: request {i} disagrees with the plain version")
        d_enc = (out["rgb"] - trainer.render_image(params, rays, chunk=n_rays, use_kernel=True)["rgb"]).abs()
        log(f"render_raw: request {i} vs the encoded route (K1f): max |rgb| diff {float(d_enc.max()):.3e}, "
            f"mean {float(d_enc.mean()):.3e}, rays beyond {RGB_TOL}: {int((d_enc.amax(-1) > RGB_TOL).sum())}")
        if not float(d_enc.mean()) < RGB_TOL:
            raise AssertionError(f"render_raw: request {i} is far from the encoded route")
    return launches


def check_transmittance(dev) -> None:
    """The weights' gradient through compute_alpha_weights (a backward
    that reads nothing to the host) against autograd through
    torch.cumprod, at a training step's fine-level shapes: the same
    weights, the gradient within TRANSMITTANCE_TOL of its scale. The last
    sample's gradient is left out: its distance is the 1e10 tail, so
    where its sigma is 0 its own gradient is ~1e10 and would hide the
    transmittance's part."""
    from nerf_projects_tpu_torch.ops import render

    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    shape = (TRAIN_RAYS, COARSE + FINE)
    sigma = torch.relu(torch.randn(shape, generator=gen, device=dev)) * 4.0
    z = torch.sort(2.0 + 4.0 * torch.rand(shape, generator=gen, device=dev), dim=-1).values
    dirs = torch.randn(TRAIN_RAYS, 3, generator=gen, device=dev)
    cot = torch.randn(shape, generator=gen, device=dev)
    res = []
    for fn in (render.compute_alpha_weights, render.compute_alpha_weights_reference):
        s = sigma.clone().requires_grad_(True)
        _, w = fn(s, z, dirs)
        res.append((w.detach(), torch.autograd.grad((w * cot).sum(), s)[0][:, :-1]))
    (w, g), (w_ref, g_ref) = res
    err = float((g - g_ref).abs().max() / g_ref.abs().max())
    log(f"train_raw: the transmittance's gradient against torch.cumprod's autograd at {shape}: weights the same "
        f"bits {torch.equal(w, w_ref)}, gradient max |err| {err:.3e} of scale (tolerance {TRANSMITTANCE_TOL})")
    if not (torch.equal(w, w_ref) and err < TRANSMITTANCE_TOL):
        raise AssertionError("train_raw: the transmittance's gradient disagrees with torch.cumprod's")


def phase_train_raw(dev, card: str) -> dict:
    """The train phase's flagship configuration with the MLP on raw points:
    NeRFTrainer.loss_fn's render through a tagged fused_apply_raw (K1rf
    and K1rb under autograd). First the transmittance's gradient and one
    step of CHECK_RAYS rays against the plain versions on the host, then
    WARM_STEPS and a WINDOW_S window with the launch counters zeroed just
    before and read just after, the waiting calls of one step and a
    profile."""
    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.train import NeRFTrainer

    check_transmittance(dev)
    apply = tagged(fm.fused_apply_raw)

    class RawTrainer(NeRFTrainer):
        """NeRFTrainer whose loss_fn renders through the raw-points MLP."""

        @property
        def apply_fn(self):
            return apply

    cfg = NeRFRenderConfig(
        num_coarse_samples=COARSE, num_fine_samples=FINE, multires=10, multires_views=4,
        use_viewdirs=True, white_bkgd=True, perturb=True, raw_noise_std=0.0, resample_sorted=False,
    )

    def make(config=cfg, device=dev):
        return RawTrainer(config, depth=8, width=256, near=2.0, far=6.0, lrate=5e-4, lrate_decay=250,
                          compute_dtype=torch.bfloat16, use_fused_mlp=True, device=device)

    ds = make_dataset(n_views=2, image_size=128, device=dev)
    torch.cuda.synchronize()
    check = cfg._replace(perturb=False)
    idx = torch.arange(CHECK_RAYS, device=dev) * (ds["pixels"].shape[0] // CHECK_RAYS)
    rays, target = ds["rays"].map(lambda t: t[idx]), ds["pixels"][idx]
    on_card, on_host = make(check), make(check, "cpu")
    gen = torch.Generator().manual_seed(SEED + 33)
    params = tuple(random_biases(m, gen) for m in on_card.init_params(SEED))
    host_params = tuple(copy.deepcopy(m).cpu() for m in params)
    fm.fused_mlp_raw_fwd.launches = fm.fused_mlp_raw_bwd.launches = 0
    (loss, mse), grads = on_card._value_and_grad(params, None, rays, target)
    launched = (fm.fused_mlp_raw_fwd.launches, fm.fused_mlp_raw_bwd.launches)
    (hloss, hmse), hgrads = on_host._value_and_grad(host_params, None, rays.map(lambda t: t.cpu()), target.cpu())
    tag = f"train_raw: one raw-points autograd step of {CHECK_RAYS} rays"
    log(f"{tag}: loss {float(loss):.6f} (plain {float(hloss):.6f}), fine mse {float(mse):.6f} "
        f"(plain {float(hmse):.6f}); K1rf, K1rb launches {launched}")
    if launched != (2, 2) or not (abs(float(loss) - float(hloss)) < 3e-3 * float(hloss)
                                  and abs(float(mse) - float(hmse)) < 3e-3 * float(hmse)):
        raise AssertionError(f"{tag}: the loss disagrees with the plain versions")
    names = list(grads[0])
    check_grads(f"{tag}, coarse model", [grads[0][k].cpu() for k in names], [hgrads[0][k] for k in names], names)

    trainer = make()
    state = trainer.init_state(SEED)
    fm.fused_mlp_raw_fwd.launches = fm.fused_mlp_raw_bwd.launches = 0
    state, window, step_ms, losses, psnrs = train_window(trainer, state, ds)
    counts = {"fused_mlp_raw_fwd": fm.fused_mlp_raw_fwd.launches, "fused_mlp_raw_bwd": fm.fused_mlp_raw_bwd.launches}
    n = len(step_ms)
    log(f"train_raw: raw-points MLP under autograd on {card}: {n} timed steps of {TRAIN_RAYS} rays in {window:.6f} s: "
        f"{n * TRAIN_RAYS / window:.1f} rays/s; step ms median {float(np.median(step_ms)):.4f}, "
        f"min {min(step_ms):.4f}, max {max(step_ms):.4f}; loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
        f"psnr {psnrs[0]:.4f} -> {psnrs[-1]:.4f} over {len(losses)} steps; launches {counts} (warm steps included)")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"train_raw: the training step launched no {counts} kernel")
    if not all(np.isfinite(losses)):
        raise AssertionError("train_raw: a loss is not finite")
    k = min(10, len(losses) // 4)
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise AssertionError("train_raw: the loss did not fall")
    check_waits("train_raw: one step",
                lambda: trainer.scan_steps(state, ds["rays"], ds["pixels"], 1, batch_size=TRAIN_RAYS), 0)
    profile_steps(lambda n: trainer.scan_steps(state, ds["rays"], ds["pixels"], n, batch_size=TRAIN_RAYS)[0],
                  "raw-points MLP under autograd")
    return counts


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


def select_bricks(bg, keep: np.ndarray):
    """bg with only its active bricks where ``keep`` (bool, one per
    active brick in row order) holds, rows renumbered."""
    links = bg.brick_links.cpu().numpy()
    coords = np.argwhere(links >= 0)
    old_rows = links[coords[:, 0], coords[:, 1], coords[:, 2]]
    new_links = np.full_like(links, -1)
    kept = coords[keep]
    new_links[kept[:, 0], kept[:, 1], kept[:, 2]] = np.arange(int(keep.sum()), dtype=np.int32)
    sel = torch.from_numpy(old_rows[keep]).long().to(bg.device)
    return dataclasses.replace(bg, brick_links=torch.from_numpy(new_links).to(bg.device), cell_mask=bg.cell_mask[sel],
                               brick_coords=bg.brick_coords[sel], density_bricks=bg.density_bricks[sel],
                               sh_bricks=bg.sh_bricks[sel])


def shell_select(bg, r_lo: float = 0.85, r_hi: float = 1.02):
    """bench.py's _shell_select: keep the bricks whose centre lies at
    radius r_lo..r_hi of the unit sphere, rows renumbered."""
    coords = np.argwhere(bg.brick_links.cpu().numpy() >= 0)
    centers = (coords * 8.0 + 4.0) / bg.reso[0] * 2.0 - 1.0
    rad = np.linalg.norm(centers, axis=1)
    keep = (rad >= r_lo) & (rad <= r_hi)
    if not keep.any():  # a grid too coarse for the band keeps every brick
        keep[:] = True
    return select_bricks(bg, keep)


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
    with ``counts`` (out, dict of its counts summed over all the tiles:
    marched, shaded, dense, reach, brick_steps, and touched, the bricks
    touched)."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    outs, total = [], {}
    reach = tm.reachable_bricks(bg.brick_links, bg.reso) if counts else None
    for i in range(0, pack.shape[0], PLAIN_BATCH_TILES):
        got = tm.march_reference(cells, bg.brick_links, bg.reso, pack[i:i + PLAIN_BATCH_TILES],
                                 basis[i:i + PLAIN_BATCH_TILES], counts=counts, reach=reach, **kw)
        if counts:
            got, c = got
            for k, v in c.items():
                total[k] = total.get(k, 0) + int(v.sum()) if k != "touched" else total.get(k, False) | v
        outs.append(got)
    out = torch.cat(outs)
    if not counts:
        return out
    total["touched"] = int(total["touched"].sum())
    return out, total


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


def march_bound(c: dict, basis_dim: int, n_rays: int, n_tiles: int, skip: bool = True):
    """(bound ms, "bytes" | "operations", ops ms, bytes ms) of one march
    with the plain version's counts ``c``: the touched bricks' live
    channels (1 + 3B bf16 a cell) and each ray's pack and outputs and each
    tile's basis once over HBM; the float operations over the float32
    rate of the samples that can reach data, the shaded ones and a brick
    step per run of samples in an unreachable brick (with ``skip``), or,
    as the first port counted them, of every marched sample."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    nbytes = (c["touched"] * 512 * (1 + 3 * basis_dim) * 2 + n_rays * (tm.PACK * 4 + 8 * 4)
              + n_tiles * basis_dim * 4)
    flops = c["shaded"] * tm.flops_per_shaded(basis_dim)
    if skip:
        flops += c["reach"] * tm.FLOPS_PER_SAMPLE + c["brick_steps"] * tm.FLOPS_PER_BRICK_STEP
    else:
        flops += c["marched"] * tm.FLOPS_PER_SAMPLE
    t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def bound_text(c: dict, basis_dim: int, n_rays: int, n_tiles: int) -> str:
    """The new bound beside the first port's, for a log line."""
    new, old = march_bound(c, basis_dim, n_rays, n_tiles), march_bound(c, basis_dim, n_rays, n_tiles, skip=False)
    return (f"bound {new[0]:.4f} ms ({new[1]}; operations {new[2]:.4f} ms, bytes {new[3]:.4f} ms; {c['reach']} samples "
            f"reach data, {c['brick_steps']} brick steps), the first port's bound {old[0]:.4f} ms ({c['marched']} "
            f"samples marched, {c['shaded']} shaded)")


def march_probes(tag, cells, bg, pack, basis, max_steps: int) -> dict:
    """K3 against the first port's per-sample march cut after its link
    reads, after its densities and whole (tile_march_fwd_probe), all
    without early stop so that each marches the same samples, timed with
    CUDA events. Returns the times."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    kw = dict(max_steps=max_steps, early_stop=False)
    times = {f"probe {name}": time_ms(lambda m=mode: tm.tile_march_fwd_probe(cells, bg.brick_links, bg.reso, pack,
                                                                             basis, mode=m, **kw), iters=5)
             for mode, name in enumerate(("links", "links + density", "whole"))}
    times["probe whole, early stop"] = time_ms(lambda: tm.tile_march_fwd_probe(
        cells, bg.brick_links, bg.reso, pack, basis, mode=2, max_steps=max_steps, early_stop=True), iters=5)
    log(f"{tag}: the first port's per-sample march (tile_march_fwd_probe, no early stop): "
        + ", ".join(f"{k[6:]} {v:.4f} ms" for k, v in times.items()))
    return times


# The skip case's grid, 32^3: the central 2x2x2 bricks and brick (3, 1, 1)
# on the upper x face hold data; every face of each borders an empty brick.
SKIP_BRICKS = {(x, y, z) for x in (1, 2) for y in (1, 2) for z in (1, 2)} | {(3, 1, 1)}


def skip_rays(dev):
    """Tiles of 8 rays [6, 8] through the skip grid (a 32^3 grid of radius
    1: world = (grid + 0.5) / 16 - 1): rays along y grazing the block's
    x faces (grid x 7.99, 8, 8.01, 15.99, 16, 23.99, 24, 24.01) at three
    depths, two tiles of them tilted by 1e-3; one tile entering through
    the upper x face into brick (3, 1, 1); two tiles of random
    directions through the block. The CPU tests march the same rays."""
    from nerf_projects_tpu_torch.core.rays import Rays

    def world(g):
        return (np.asarray(g, np.float32) + 0.5) / 16.0 - 1.0

    xs = [7.99, 8.0, 8.01, 15.99, 16.0, 23.99, 24.0, 24.01]
    os_, ds = [], []
    for z, tilt in ((12.5, 0.0), (8.0, 1e-3), (23.99, -1e-3)):
        os_.append([world([x, -6.0, z]) for x in xs])
        ds.append([[tilt, 1.0, 0.5 * tilt]] * 8)
    os_.append([world([40.0, 8.5 + i, 9.0 + 0.7 * i]) for i in range(8)])
    ds.append([[-1.0, 0.01 * i, -0.02 * i] for i in range(8)])
    rng = np.random.default_rng(7)
    for _ in range(2):
        o = rng.standard_normal(3)
        o = 2.5 * o / np.linalg.norm(o)
        os_.append([o] * 8)
        ds.append(list(world([16.0, 16.0, 16.0]) + rng.uniform(-0.35, 0.35, (8, 3)) - o))
    o, d = (np.asarray(x, np.float32) for x in (os_, ds))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(x).to(dev) for x in (o, d))
    return Rays(o, d, d)


def skip_grid(dev, seed: int, opaque_sigma: float = 8.0, basis_dim: int = GRID_BASIS):
    """(BrickGrid, cells) of the 32^3 skip grid: data only in SKIP_BRICKS."""
    from nerf_projects_tpu_torch.ops.brick_grid import create_brick_grid

    full = create_brick_grid(32, basis_dim=basis_dim, use_sphere_bound=False, alloc_data=False, device=dev)
    coords = [tuple(c) for c in full.brick_coords.cpu().numpy().tolist()]
    bg = select_bricks(full, np.array([c in SKIP_BRICKS for c in coords]))
    return bg, random_cells(bg, torch.Generator(device=dev).manual_seed(seed), opaque_sigma=opaque_sigma)


def camera_tiles(th: int, tw: int, dev):
    """A 4th x 4tw camera's rays (focal 1.2 x 4tw, 2.6 in front of a
    32^3 grid of radius 1) in th x tw tiles, and the same rays in image
    order [4th x 4tw]."""
    from nerf_projects_tpu_torch.core.rays import camera_rays_opencv
    from nerf_projects_tpu_torch.ops.tile_render import tiles_from_image_rays

    H, W = 4 * th, 4 * tw
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, -0.2, -2.6]
    rays = camera_rays_opencv(H, W, 1.2 * W, 1.2 * W, W / 2.0, H / 2.0, pose, device=dev)
    flat = rays.map(lambda x: x.reshape(-1, 3))
    return tiles_from_image_rays(flat, H, W, th, tw), flat


def phase_kernel_march(dev) -> dict:
    """K3 against its plain version: a random 32^3 grid with 128-, 256-
    and 512-ray tiles; the skip grid (SKIP_BRICKS) on grazing rays, rays
    through the upper face and camera tiles, with and without early stop;
    then a whole 800x800 frame of the 512^3 fog scene, whose plain run
    also counts the work of the bound; then that frame's march timed, and
    the plain version's."""
    from nerf_projects_tpu_torch.ops.brick_grid import create_brick_grid
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    opts = GridRenderOptions(step_size=0.5)
    max_abs = 0.0
    bg = create_brick_grid(32, basis_dim=GRID_BASIS, use_sphere_bound=True, alloc_data=False, device=dev)
    cells = random_cells(bg, torch.Generator(device=dev).manual_seed(SEED + 4), opaque_sigma=40.0)
    skip_bg, skip_cells = skip_grid(dev, SEED + 12)
    C = tm.default_chunks_for(bg, opts)
    tm.tile_march_fwd.launches = 0
    n_calls = 0
    cases = []
    for th, tw in ((8, 16), (16, 16), (16, 32)):
        tiles, _ = camera_tiles(th, tw, dev)
        cases.append((f"32^3, {th}x{tw}-ray tiles", bg, cells, tiles))
        if th == 16:
            cases.append((f"32^3 skip grid, {th}x{tw}-ray camera tiles", skip_bg, skip_cells, tiles))
    cases.append(("32^3 skip grid, grazing and upper-face rays", skip_bg, skip_cells, skip_rays(dev)))
    for name, g, c, tiles in cases:
        pack, basis = tm.pack_rays(g, tiles, opts)
        for early_stop in (False, True):
            kw = dict(max_steps=C * tm.SC, early_stop=early_stop)
            got = tm.tile_march_fwd(c, g.brick_links, g.reso, pack, basis, **kw)
            want = tm.march_reference(c, g.brick_links, g.reso, pack, basis, **kw)
            torch.cuda.synchronize()
            n_calls += 1
            max_abs = max(max_abs, compare_march(
                f"kernel_march: {name}, {pack.shape[0]} tiles, early_stop {early_stop}", got, want))
            if g is skip_bg and not early_stop:
                _, cnt = tm.march_reference(c, g.brick_links, g.reso, pack, basis, counts=True, **kw)
                log(f"kernel_march: {name}: mean acc {float(want[:, 3].mean()):.4f}; "
                    f"{int(cnt['marched'].sum())} samples marched, {int(cnt['reach'].sum())} reach data, "
                    f"{int(cnt['brick_steps'].sum())} brick steps")

    bg, cells = scene_grid(dev, shell=False)
    tiles = frame_tiles(0, dev)
    pack, basis = tm.pack_rays(bg, tiles, opts)
    kw = dict(max_steps=tm.default_chunks_for(bg, opts) * tm.SC, early_stop=True)
    got = tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw)
    torch.cuda.synchronize()
    n_calls += 1
    if tm.tile_march_fwd.launches != n_calls:
        raise AssertionError(f"kernel_march: {tm.tile_march_fwd.launches} launches counted for {n_calls} kernel calls")
    T = pack.shape[0]
    want, cnt = plain_march(cells, bg, pack, basis, counts=True, **kw)
    max_abs = max(max_abs, compare_march(
        f"kernel_march: {GRID_RESO}^3 fog frame, {T} tiles of {pack.shape[1]} rays", got, want))

    ms = time_ms(lambda: tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw), iters=5)
    t0 = time.perf_counter()
    plain_march(cells, bg, pack, basis, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    b_ms, by, _, _ = march_bound(cnt, bg.basis_dim, T * pack.shape[1], T)
    log(f"kernel_march: {GRID_RESO}^3 fog frame ({FRAME}x{FRAME}, {T} tiles): {ms:.4f} ms a frame "
        f"({cnt['marched'] / ms / 1e6:.3f} G samples/s marched by the plain version; {cnt['touched']} of "
        f"{bg.n_bricks} bricks touched), plain {plain_ms:.4f} ms, "
        f"{bound_text(cnt, bg.basis_dim, T * pack.shape[1], T)}; {b_ms / ms:.3f} of bound")
    del cells, bg
    torch.cuda.empty_cache()
    return {
        "name": "tile_march_fwd", "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/tile_march_fwd.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/tile_march.py:431",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def profile_march(dev) -> None:
    """march_probes on frame 0 of the fog and the shell scene, alone."""
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    opts = GridRenderOptions(step_size=0.5)
    for name, shell in (("fog", False), ("shell", True)):
        bg, cells = scene_grid(dev, shell)
        pack, basis = tm.pack_rays(bg, frame_tiles(0, dev), opts)
        march_probes(f"profile_march: {name} frame 0", cells, bg, pack, basis, tm.default_chunks_for(bg, opts) * tm.SC)
        del bg, cells
        torch.cuda.empty_cache()


def phase_render_plenoxels(dev, card: str) -> int:
    """render_frame_pallas at bench.py's two frame configurations (fog,
    opaque shell): frames back to back for WINDOW_S seconds after one
    warm frame a pose. Returns the K3 launches of both windows."""
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.ops.kernels.frame_march import render_frame_pallas

    opts = GridRenderOptions(step_size=0.5)
    frames = [frame_tiles(i, dev) for i in range(4)]
    launches = {}
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
        per_pose, work = [], []
        for i, f in enumerate(frames):
            pack, basis = tm.pack_rays(bg, f, opts)
            plain, cnt = plain_march(cells, bg, pack, basis, counts=True, max_steps=C * tm.SC, early_stop=True)
            work.append((cnt, bg.basis_dim, pack.shape[0] * pack.shape[1], pack.shape[0]))
            ref = tm.march_outputs(plain, pack, opts, False)
            err = max(float((first[i][k] - ref[k]).abs().max()) for k in ("rgb", "acc"))
            log(f"render_plenoxels: {name}: frame {i} against the plain version: max |rgb, acc err| {err:.3e} "
                f"(tolerance {MARCH_TOL}); {cnt['marched']} samples marched, {cnt['reach']} reach data")
            if not err < MARCH_TOL:
                raise AssertionError(f"render_plenoxels: {name}: frame {i} disagrees with the plain version")
            per_pose.append(cnt["marched"])
        pack, basis = tm.pack_rays(bg, frames[0], opts)
        k3_ms = time_ms(lambda: tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, max_steps=C * tm.SC,
                                                  early_stop=True), iters=5)
        k3_bound = march_bound(*work[0])[0]
        probes = march_probes(f"render_plenoxels: {name} frame 0", cells, bg, pack, basis, C * tm.SC)
        k3_full_ms = time_ms(lambda: tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis,
                                                       max_steps=C * tm.SC), iters=5)
        SIZE_TIMES.setdefault("tile_march_fwd", {})[f"{name} frame"] = (k3_ms, k3_bound)

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
        launches[f"{name} frame"] = n_launch
        FRAME_MS[name] = float(np.median(secs) * 1e3)
        mean_acc = float(first[0]["acc"].mean())
        log(f"render_plenoxels: {name} on {card}: {GRID_RESO}^3 basis {GRID_BASIS} step 0.5, {bg.n_bricks} active bricks, "
            f"cells {gb:.3f} GB, peak allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; "
            f"{len(secs)} frames of {FRAME}x{FRAME} in {window:.6f} s: {len(secs) / window:.4f} frames/s; ms a frame "
            f"median {np.median(secs) * 1e3:.4f}, min {min(secs) * 1e3:.4f}, max {max(secs) * 1e3:.4f}; "
            f"{n_launch} tile_march_fwd launches; {marched} samples marched (counted by the plain version) "
            f"({marched / len(secs) / 1e6:.3f} M a frame); mean acc of frame 0 {mean_acc:.4f}; K3 alone on frame 0 "
            f"{k3_ms:.4f} ms (CUDA events), {bound_text(*work[0])}, {k3_bound / k3_ms:.3f} of bound; without early "
            f"stop {k3_full_ms:.4f} ms, the first port's march whole {probes['probe whole']:.4f} ms, "
            f"{probes['probe whole'] / k3_full_ms:.3f}x")
        if n_launch <= 0:
            raise AssertionError(f"render_plenoxels: {name}: the main path launched no tile_march_fwd kernel")
        del cells, bg, first
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Plenoxels evaluation: the render CLI's per-ray routes (plain torch)
# ---------------------------------------------------------------------------


EVAL_CHUNK = 16384          # cli/render_imgs.py's --chunk default
EVAL_TOP_K = 48             # its --color_top_k default
EVAL_ACTIVE_STEPS = 256     # the steps the fast route marches inside a ray's occupied span
TOPK_SLACK = 1e-5           # exact - fast per channel within [0, (acc - top-K weight) max colour], this slack
TOPK_ACC_TOL = 1e-5         # acc of the fast route (float32 cache) against the route without top-K
CACHE_MAX_TOL = 2e-2        # |rgb(bf16 cache) - rgb(float32 cache)|: the JAX package's bf16-against-float32 bound
CACHE_MEAN_TOL = 2.0 ** -8  # mean of it: bf16 keeps 2^-9 of a density, times ~2 for the optical depth under the weights
FRAME_MS = {}               # render_plenoxels: K3's frame route, ms a frame by scene


def eval_scene(i: int):
    """A one-view scene for cli/render_imgs.py's render_grid_image: the
    camera of frame_tiles(i) (OpenCV pose, focal 800 px, 800x800)."""
    import types

    pose = np.eye(4, dtype=np.float32)
    ang = 0.15 * i
    pose[0, 3] = 2.4 * np.sin(ang)
    pose[2, 3] = -2.4 * np.cos(ang)
    K = np.array([[FRAME, 0.0, FRAME / 2.0], [0.0, FRAME, FRAME / 2.0], [0.0, 0.0, 1.0]], np.float32)
    return types.SimpleNamespace(height=FRAME, width=FRAME, intrinsics=K, poses=[pose], meta={"convention": "opencv"})


def scene_sparse_grid(dev, shell: bool):
    """scene_grid's 512^3 fog or shell as a SparseGrid on the card
    (float32 values of its bf16 cells), through to_sparse_grid."""
    from nerf_projects_tpu_torch.ops.brick_grid import to_sparse_grid

    bg, cells = scene_grid(dev, shell)
    B = bg.basis_dim
    bg = dataclasses.replace(bg, density_bricks=cells[..., 0].float(), sh_bricks=cells[..., 1:1 + 3 * B].float())
    del cells
    grid = to_sparse_grid(bg)
    del bg
    torch.cuda.empty_cache()
    return grid


def trilerp_eight_corners(grid, data, gpts):
    """The port's first trilerp (ops/grid.py), which gathered the eight
    corners' rows at once, [..., 8, C]; kept to measure the memory that
    form needs."""
    X, Y, Z = grid.reso
    reso = torch.tensor(grid.reso, device=gpts.device)
    l = torch.minimum(torch.clamp(torch.floor(gpts).to(torch.int32), min=0), reso - 2)
    w = torch.clamp(gpts - l.to(gpts.dtype), 0.0, 1.0)
    wx, wy, wz = w[..., 0:1], w[..., 1:2], w[..., 2:3]
    base = (l[..., 0].long() * Y + l[..., 1].long()) * Z + l[..., 2].long()
    offs = torch.tensor([0, 1, Z, Z + 1, Y * Z, Y * Z + 1, Y * Z + Z, Y * Z + Z + 1], device=gpts.device)
    links8 = grid.links.reshape(-1)[base[..., None] + offs]
    vals = torch.where((links8 >= 0)[..., None], data[torch.clamp(links8, min=0).long()], 0.0)
    cw = torch.stack([(1 - wx) * (1 - wy) * (1 - wz), (1 - wx) * (1 - wy) * wz, (1 - wx) * wy * (1 - wz),
                      (1 - wx) * wy * wz, wx * (1 - wy) * (1 - wz), wx * (1 - wy) * wz, wx * wy * (1 - wz),
                      wx * wy * wz], dim=-2)
    return torch.sum(vals * cw, dim=-2)


def wall_ms(fn, n: int = 2) -> tuple:
    """(ms a call on the host clock, each call synchronised, after a warm
    call; peak allocated GB over the timed calls)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, torch.cuda.max_memory_allocated() / 1e9


def phase_render_plenoxels_eval(dev, card: str) -> None:
    """cli/render_imgs.py's per-ray routes on render_plenoxels' 512^3 fog
    and shell grids (as SparseGrids) and frame 0's 800x800 camera: (a) one
    frame through render_grid_image with the CLI's fast keywords
    (occupancy, top-48 colour, bf16 density cache): finite, acc in [0, 1];
    (b) on one chunk of 16,384 rays, the fast route with a float32 cache
    against the same call without color_top_k: equal acc, and per ray and
    channel exact - fast in [0, (acc - sum of the top-K weights) x the
    ray's largest sample colour]; (c) the frame with the bf16 cache
    against the float32 cache; (d) the exact route without occupancy on
    that chunk: its peak memory, beside the eight-corner trilerp's; (e)
    ms a frame and peak memory of the fast route and of the exact route
    with occupancy, beside K3's frame route, and the share of rays that
    the 256 active steps cut short. Plain torch: no kernel."""
    from nerf_projects_tpu_torch.cli.render_imgs import _view_rays, render_grid_image
    from nerf_projects_tpu_torch.ops import grid as og
    from nerf_projects_tpu_torch.ops.grid_accel import active_t_range, build_occupancy
    from nerf_projects_tpu_torch.ops.sh import eval_sh_bases

    opts = og.GridRenderOptions(step_size=0.5)
    scene = eval_scene(0)
    for name, shell in (("fog", False), ("shell", True)):
        tag = f"render_plenoxels_eval: {name} {GRID_RESO}^3"
        t_build = time.perf_counter()
        grid = scene_sparse_grid(dev, shell)
        occ = build_occupancy(grid, factor=8, sigma_thresh=opts.sigma_thresh)
        cache16, cache32 = og.make_render_cache(grid, torch.bfloat16), og.make_render_cache(grid, torch.float32)
        torch.cuda.synchronize()
        log(f"{tag}: SparseGrid of {grid.capacity} cells, occupancy and caches built in "
            f"{time.perf_counter() - t_build:.3f} s; grid {grid.sh_data.numel() * 4 / 1e9:.3f} GB of SH")
        fast = dict(occupancy=occ, color_top_k=EVAL_TOP_K, dense_density=cache16)

        # (a) and (e): the fast route's frame
        out = {}
        fast_ms, fast_gb = wall_ms(lambda: out.__setitem__("img", render_grid_image(grid, scene, 0, opts, EVAL_CHUNK,
                                                                                    **fast)))
        img16 = out["img"]
        if tuple(img16.shape) != (FRAME, FRAME, 3) or not bool(torch.isfinite(img16).all()):
            raise AssertionError(f"{tag}: (a) the fast route's frame is not finite of shape ({FRAME}, {FRAME}, 3)")

        # (b) the top-K identity on the centre chunk
        flat = _view_rays(scene, 0, FRAME, FRAME, dev).map(lambda x: x.reshape(-1, 3))
        c0 = FRAME * FRAME // 2 - EVAL_CHUNK // 2
        rays = flat.map(lambda x: x[c0:c0 + EVAL_CHUNK])
        kw = dict(occupancy=occ, active_steps=EVAL_ACTIVE_STEPS)
        with torch.no_grad():
            got = og.volume_render_grid(grid, rays, opts, color_top_k=EVAL_TOP_K, dense_density=cache32, **kw)
            ref = og.volume_render_grid(grid, rays, opts, **kw)
            _, _, _, _, _, _, gpts = og._march(grid, rays, opts, occ, EVAL_ACTIVE_STEPS)
            coeffs = og.trilerp(grid, grid.sh_data, gpts).reshape(gpts.shape[:-1] + (3, grid.basis_dim))
            colour = og.decode_rgb(coeffs, eval_sh_bases(grid.basis_dim, rays.viewdirs)[:, None, :], opts.color_mode)
            max_c = torch.where((ref["weights"] > 0)[..., None], colour, 0.0).amax(dim=1)  # [R, 3]
            del gpts, coeffs, colour
        acc = got["acc"]
        if not (float(acc.min()) >= -1e-6 and float(acc.max()) <= 1 + 1e-5):
            raise AssertionError(f"{tag}: (a) acc outside [0, 1]")
        top_w = torch.topk(ref["weights"], EVAL_TOP_K, dim=-1).values.sum(-1)
        dropped = torch.clamp(ref["acc"] - top_w, min=0.0)
        diff = ref["rgb"] - got["rgb"]
        upper = dropped[:, None] * max_c
        below = int((diff < -TOPK_SLACK).any(-1).sum())
        above = int((diff > upper + TOPK_SLACK).any(-1).sum())
        d_acc = float((got["acc"] - ref["acc"]).abs().max())
        log(f"{tag}: (b) top-{EVAL_TOP_K} on {EVAL_CHUNK} rays (float32 cache) against the same call without "
            f"color_top_k: max |acc err| {d_acc:.3e} (tolerance {TOPK_ACC_TOL}); exact - fast per channel in "
            f"[{float(diff.min()):.3e}, {float(diff.max()):.3e}], the dropped weight (acc - top-K weight) mean "
            f"{float(dropped.mean()):.4e}, max {float(dropped.max()):.4e}; rays below 0: {below}, above "
            f"(acc - top-K weight) x max colour: {above} (slack {TOPK_SLACK})")
        if below or above or not d_acc <= TOPK_ACC_TOL:
            raise AssertionError(f"{tag}: (b) the top-K route breaks its identity with the full route")
        del got, ref, max_c, top_w, dropped, diff, upper

        # (c) the bf16 cache against the float32 cache, whole frame: on the
        # scene's densities (bf16 values, which the bf16 cache holds exactly)
        # and on them jittered below bf16's resolution, which it rounds
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        jitter = 1.0 + torch.rand(grid.density_data.shape, generator=gen, device=dev) * 2.0 ** -8
        jittered = dataclasses.replace(grid, density_data=grid.density_data * jitter)
        del jitter
        for label, g_, c16, c32 in (("the scene's densities", grid, cache16, cache32),
                                    ("densities x (1 + 2^-8 U[0, 1))", jittered, None, None)):
            c16 = og.make_render_cache(g_, torch.bfloat16) if c16 is None else c16
            c32 = og.make_render_cache(g_, torch.float32) if c32 is None else c32
            a, b = (render_grid_image(g_, scene, 0, opts, EVAL_CHUNK, occupancy=occ, color_top_k=EVAL_TOP_K,
                                      dense_density=c) for c in (c16, c32))
            d = (a - b).abs()
            log(f"{tag}: (c) bf16 against float32 density cache over the frame, {label}: max |rgb err| "
                f"{float(d.max()):.4e} (gate {CACHE_MAX_TOL}), mean {float(d.mean()):.4e} (gate {CACHE_MEAN_TOL:.4e}); "
                f"cells whose density bf16 changes {float((c16.float() != c32).float().mean()):.4f}")
            if not (float(d.max()) <= CACHE_MAX_TOL and float(d.mean()) <= CACHE_MEAN_TOL):
                raise AssertionError(f"{tag}: (c) the bf16 cache strays from the float32 cache")
            del a, b, d, c16, c32
        del jittered, cache32

        # (d) the exact route without occupancy on one chunk at the CLI's default
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 1e9
        exact_ms, exact_gb = wall_ms(lambda: og.volume_render_grid(grid, rays, opts), n=1)
        S = og.default_max_steps(grid, opts.step_size)
        before, real_trilerp = "not run", og.trilerp
        try:
            og.trilerp = trilerp_eight_corners  # the same route through the first port's trilerp
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                og.volume_render_grid(grid, rays, opts)
            torch.cuda.synchronize()
            before = f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB"
        except torch.cuda.OutOfMemoryError as e:
            before = f"out of memory ({str(e).splitlines()[0][:160]})"
        finally:
            og.trilerp = real_trilerp
            torch.cuda.empty_cache()
        log(f"{tag}: (d) the exact route without occupancy on {EVAL_CHUNK} rays x {S} steps: {exact_ms:.4f} ms, "
            f"peak allocated {exact_gb:.3f} GB ({exact_gb - base:.3f} GB over the {base:.3f} GB held before the "
            f"call), on {card}; through the first port's eight-corner trilerp: peak {before}")

        # (e) the exact route with occupancy, the share cut by the active steps
        occ_ms, occ_gb = wall_ms(lambda: render_grid_image(grid, scene, 0, opts, EVAL_CHUNK, occupancy=occ))
        cut = hit = 0
        with torch.no_grad():
            for i in range(0, flat.origins.shape[0], 4 * EVAL_CHUNK):
                r = flat.map(lambda x: x[i:i + 4 * EVAL_CHUNK])
                og_ = grid.world_to_grid(r.origins)
                dirs_g, _, dt, _, t0, t1 = og.ray_grid_geometry(grid.reso, grid.radius, og_, r.directions, opts)
                t0, t1 = active_t_range(occ, og_, dirs_g, t0, t1)
                h = t1 > t0
                hit += int(h.sum())
                cut += int((h & ((t1 - t0) / dt > EVAL_ACTIVE_STEPS)).sum())
        k3 = FRAME_MS.get(name)
        log(f"{tag}: (e) on {card}: fast route (occupancy, top-{EVAL_TOP_K}, bf16 cache) {fast_ms:.4f} ms a frame, "
            f"peak allocated {fast_gb:.3f} GB; exact route with occupancy {occ_ms:.4f} ms a frame, peak "
            f"{occ_gb:.3f} GB; K3's frame route (render_plenoxels) "
            + (f"{k3:.4f} ms a frame" if k3 is not None else "not run") +
            f"; {EVAL_ACTIVE_STEPS} active steps cut {cut} of the {hit} rays that reach occupied space "
            f"({cut / max(hit, 1):.4f}; {cut / (FRAME * FRAME):.4f} of the frame)")
        del grid, occ, cache16, img16, flat, rays, out
        torch.cuda.empty_cache()


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
    HBM; the re-march's float operations (the samples that can reach
    data, a brick step per run of samples in an unreachable brick, as
    K3's bound counts them) and the backward's (itemised in
    ops/kernels/tile_march.py) over the float32 rate."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    B = basis_dim
    nbytes = (n_touched * 512 * (1 + 3 * B) * 2 + nb * 512 * (1 + 3 * B) * 4
              + n_rays * (tm.PACK + 3 + 1) * 4 + n_tiles * B * 4)
    flops = (counts["reach"] * tm.FLOPS_PER_SAMPLE + counts["brick_steps"] * tm.FLOPS_PER_BRICK_STEP
             + counts["shaded"] * (tm.flops_per_shaded(B) + tm.bwd_flops_per_shaded(B)))
    if sparsity:
        flops += (counts["dense"] * tm.BWD_FLOPS_SPARSITY
                  + (counts["dense"] - counts["shaded"]) * tm.BWD_FLOPS_SPARSITY_UNSHADED)
    t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def k4_work(cells, bg, pack, basis, g, s_total, **kw) -> dict:
    """What K4 does on a batch without the sparsity loss: the plain
    version's counts of its bound (skipping as the kernel does, up to each
    ray's first inactive sample, where K4 stops); the samples the kernel
    visits by its probe's count (visits) beside the host twin's
    (kernel_visits: twin_visits); the samples the kernel visits to each
    ray's exit (the probe with the sparsity loss on: to_exit), which must
    be the twin's count of the samples K3 visits on the batch (k3_visits:
    training runs K3 without its early stop); the global add instructions
    of its runs and the floats they add (backward_flushes,
    PLAIN_BATCH_TILES tiles at a time: a run never leaves its ray) beside
    the first port's 8 (1 + 3B) scalar adds a shaded sample."""
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    march_kw = {k: v for k, v in kw.items() if k != "sparsity_scale"}
    _, c = plain_march(cells, bg, pack, basis, counts=True, early_stop=True, skip_empty=True, **march_kw)
    c["twin_visits"] = c["marched"]
    c["k3_visits"] = plain_march(cells, bg, pack, basis, counts=True, skip_empty=True, **march_kw)[1]["marched"]
    for key, spars in (("visits", 0.0), ("to_exit", 1.0)):
        v = tm.tile_march_bwd_probe(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, sparsity_scale=spars,
                                    **march_kw)[1]
        c[key] = int(v.long().sum())
    if c["to_exit"] != c["k3_visits"]:
        raise AssertionError(f"K4 visits {c['to_exit']} samples to the rays' exits where the host twin "
                             f"(kernel_visits) counts {c['k3_visits']}")
    if not c["visits"] <= c["to_exit"]:
        raise AssertionError(f"K4 visits {c['visits']} samples, more than K3's {c['to_exit']}")
    reach = tm.reachable_bricks(bg.brick_links, bg.reso)
    n = PLAIN_BATCH_TILES
    c["adds"] = c["add_ops"] = 0
    for i in range(0, pack.shape[0], n):
        f = tm.backward_flushes(cells, bg.brick_links, bg.reso, pack[i:i + n], basis[i:i + n], g[i:i + n],
                                s_total[i:i + n], reach=reach, **kw)
        c["adds"] += f["adds"]
        c["add_ops"] += f["add_ops"]
    c["first_port_adds"] = c["shaded"] * 8 * (1 + 3 * bg.basis_dim)
    return c


def k4_text(ms: float, probe_ms: float, zero_ms: float, c: dict, b: tuple) -> str:
    """A log line's account of K4 on a training batch."""
    b_ms, by, t_ops, t_bytes = b
    return (f"K4 {ms:.4f} ms (the wrapper: zeroed gradient arrays {zero_ms:.4f} ms, then the kernel); without its "
            f"global adds (tile_march_bwd_probe) {probe_ms:.4f} ms; {c['add_ops']} global add instructions issued "
            f"for {c['adds']} floats (host twin, backward_flushes; the first port's 8 (1 + 3B) scalar adds a shaded "
            f"sample: {c['first_port_adds']}, {c['first_port_adds'] / max(c['add_ops'], 1):.2f}x as many "
            f"instructions); samples visited {c['visits']} (the probe's count; host twin {c['twin_visits']}), "
            f"{c['to_exit']} to the rays' exits (the probe with the sparsity loss on; the samples K3 visits, by "
            f"the host twin, {c['k3_visits']}); by the plain version {c['reach']} reach data, "
            f"{c['brick_steps']} brick steps, {c['shaded']} shaded, {c['touched']} bricks touched; bound {b_ms:.4f} "
            f"ms ({by}; operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), {b_ms / ms:.3f} of bound")


# K4's cases at 32^3: (name, grid kind, basis_dim, tiles, decodes); each
# with the losses off and on (BWD_LOSSES)
BWD_CASES = [(f"{th}x{tw}-ray tiles", "random", GRID_BASIS, (th, tw), ("bias", "sigmoid"))
             for th, tw in ((8, 16), (16, 16), (16, 32))]
BWD_CASES += [("tiles of 100 rays", "random", GRID_BASIS, 100, ("bias",)),
              ("tiles of 1 ray", "random", GRID_BASIS, 1, ("sigmoid",)),
              ("skip grid, 16x16-ray camera tiles", "skip", GRID_BASIS, (16, 16), ("bias",)),
              ("skip grid, grazing and upper-face rays", "skip", GRID_BASIS, "skip", ("bias", "sigmoid")),
              ("basis 1, 8x16-ray tiles", "random", 1, (8, 16), ("bias",)),
              ("basis 25, 8x16-ray tiles", "random", 25, (8, 16), ("sigmoid",)),
              ("basis 25, skip grid, 16x16-ray camera tiles", "skip", 25, (16, 16), ("bias",))]


def bwd_case_rays(tiles, dev):
    """A BWD_CASES entry's rays: camera tiles of th x tw rays, the 8x16
    case's camera rays in tiles of n rays (image order; the last partial
    tile dropped), or the skip rays."""
    from nerf_projects_tpu_torch.core.rays import Rays

    if tiles == "skip":
        return skip_rays(dev)
    if isinstance(tiles, tuple):
        return camera_tiles(*tiles, dev)[0]
    flat = camera_tiles(8, 16, dev)[1]
    n = flat.origins.shape[0] // tiles * tiles
    return Rays(*(x[:n].reshape(-1, tiles, 3).contiguous() for x in (flat.origins, flat.directions, flat.viewdirs)))


def phase_kernel_march_bwd(dev) -> dict:
    """K4 against its plain version (BWD_CASES: a random 32^3 grid whose
    rays stop, tiles of 128, 256 and 512 rays, tiles of 100 and of 1 ray
    (partial warps), the skip grid on camera tiles and on grazing and
    upper-face rays, basis 1 and 25 beside 9, both decodes, the losses off
    and on); then one training batch of the 256^3 fog scene, whose plain
    run also counts the work of the bound; then that batch's backward
    timed beside the plain version, the kernel without its global adds
    and K3, with the host twins' counts of its samples and adds."""
    from nerf_projects_tpu_torch.ops.brick_grid import create_brick_grid
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    max_abs = 0.0
    grids = {}
    for i, B in enumerate((GRID_BASIS, 1, 25)):
        bg = create_brick_grid(32, basis_dim=B, use_sphere_bound=True, alloc_data=False, device=dev)
        grids["random", B] = bg, random_cells(bg, torch.Generator(device=dev).manual_seed(SEED + 8 + 20 * i),
                                              opaque_sigma=40.0)
        grids["skip", B] = skip_grid(dev, SEED + 13 + 20 * i, basis_dim=B)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    tm.tile_march_bwd.launches = 0
    n_calls = 0
    for name, kind, B, tiles, modes in BWD_CASES:
        bg, cells = grids[kind, B]
        rays = bwd_case_rays(tiles, dev)
        gt = torch.rand(rays.origins.shape, generator=gen, device=dev)
        for mode in modes:
            opts = GridRenderOptions(step_size=0.5, color_mode=mode)
            _, pack, basis, max_steps = tm.march_inputs(bg, rays, opts, kernel_arrays=cells)
            for losses, (beta, spars) in BWD_LOSSES.items():
                g, s_total = bwd_inputs(cells, bg, pack, basis, gt, opts, beta, max_steps)
                kw = dict(max_steps=max_steps, color_mode=mode, sparsity_scale=spars)
                got = tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
                want = tm.march_backward_reference(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
                torch.cuda.synchronize()
                n_calls += 1
                tag = f"kernel_march_bwd: 32^3 {name}, {pack.shape[0]} tiles, {mode}, {losses}"
                max_abs = max(max_abs, check_bwd(tag, got, want))
                if kind == "skip" and mode == "bias":  # the skip at work: the kernel's visits and the host twins'
                    f = tm.backward_flushes(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
                    c = [tm.march_reference(cells, bg.brick_links, bg.reso, pack, basis, counts=True,
                                            skip_empty=skip, max_steps=max_steps, color_mode=mode)[1]
                         for skip in (True, False)]
                    visits = tm.tile_march_bwd_probe(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                                     sigma_thresh=opts.sigma_thresh, stop_thresh=opts.stop_thresh,
                                                     **kw)[1]
                    twin = c[0]["marched"].float()  # to each ray's exit, as K4 marches with the sparsity loss on
                    log(f"{tag}: {int(c[0]['marched'].sum())} samples visited of {int(c[1]['marched'].sum())} by "
                        f"the host twin, {int(visits.long().sum())} by the kernel (its probe's count), "
                        f"{int(c[0]['brick_steps'].sum())} brick steps; {f['add_ops']} global add instructions "
                        f"for {f['adds']} floats")
                    if int(c[0]["brick_steps"].sum()) == 0:
                        raise AssertionError(f"{tag}: no sample of the skip case is skipped")
                    if not bool((visits == twin).all() if spars > 0 else (visits <= twin).all()):
                        raise AssertionError(f"{tag}: the kernel's visits per ray disagree with the host twin's "
                                             f"(kernel_visits)")

    # one training batch of the fog scene: bench.py's plenoxels_train
    name = "fog"
    reso, n_tiles = TRAIN_SCENES[name]
    bg = train_grid(dev, name)
    opts = GridRenderOptions(step_size=0.5)
    rays = train_tile_rays(SEED + 2, n_tiles, dev)
    gt = torch.full(rays.origins.shape, TRAIN_TARGET, device=dev)
    cells, pack, basis, max_steps = tm.march_inputs(bg, rays, opts)
    g, s_total = bwd_inputs(cells, bg, pack, basis, gt, opts, 0.0, max_steps)
    kw = dict(max_steps=max_steps, color_mode=opts.color_mode, sigma_thresh=opts.sigma_thresh,
              stop_thresh=opts.stop_thresh)
    got = tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
    want = tm.march_backward_reference(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
    torch.cuda.synchronize()
    n_calls += 1
    if tm.tile_march_bwd.launches != n_calls:
        raise AssertionError(f"kernel_march_bwd: {tm.tile_march_bwd.launches} launches counted for {n_calls} calls")
    T, r = pack.shape[:2]
    max_abs = max(max_abs, check_bwd(f"kernel_march_bwd: {reso}^3 fog training batch, {T} tiles of {r} rays",
                                     got, want))
    work = k4_work(cells, bg, pack, basis, g, s_total, **kw)

    ms = time_ms(lambda: tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw),
                 iters=10)
    probe_ms = time_ms(lambda: tm.tile_march_bwd_probe(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                                       sparsity_scale=0.0, **kw), iters=10)
    zero_ms = time_ms(lambda: (torch.zeros_like(bg.density_bricks), torch.zeros_like(bg.sh_bricks)), iters=10)
    fwd_ms = time_ms(lambda: tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw), iters=10)
    plain_ms = time_ms(lambda: tm.march_backward_reference(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                                           **kw), iters=2, warmup=1)
    b = march_bwd_bound(work["touched"], bg.n_bricks, bg.basis_dim, T * r, T, work, 0.0)
    log(f"kernel_march_bwd: {reso}^3 fog training batch ({T * r} rays, {bg.n_bricks} bricks): "
        f"{k4_text(ms, probe_ms, zero_ms, work, b)}; K3 on the batch {fwd_ms:.4f} ms; plain {plain_ms:.4f} ms")
    del cells, bg, got, want
    torch.cuda.empty_cache()
    return {
        "name": "tile_march_bwd", "route": "cuda",
        "source": "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "replaces": "nerf_projects_tpu/ops/pallas/tile_march.py:1341",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
    }


def phase_train_plenoxels(dev, card: str) -> dict:
    """train_step_tiles_pallas at the fog 256^3 and shell 512^3 training
    configurations: one step against the plain versions, then a timed
    window; then K3 and K4 alone on a step's batch beside their bounds.
    Returns the K3 and K4 launches of each window."""
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.train import PlenoxelsTrainer

    launches = {"tile_march_fwd": {}, "tile_march_bwd": {}}
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
            launches[key][f"{name} batch"] = counts[key]
        cells, pack, basis, max_steps = tm.march_inputs(bg, rays, trainer.opts)
        kw = dict(max_steps=max_steps, color_mode=trainer.opts.color_mode, sigma_thresh=trainer.opts.sigma_thresh,
                  stop_thresh=trainer.opts.stop_thresh)
        k3_ms = time_ms(lambda: tm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, **kw), iters=10)
        _, cnt = plain_march(cells, bg, pack, basis, counts=True, **kw)
        k3_bound = march_bound(cnt, bg.basis_dim, n_rays, pack.shape[0])[0]
        SIZE_TIMES.setdefault("tile_march_fwd", {})[f"{name} batch"] = (k3_ms, k3_bound)
        log(f"{tag}: K3 alone on a step's batch ({n_rays} rays): {k3_ms:.4f} ms (CUDA events), "
            f"{bound_text(cnt, bg.basis_dim, n_rays, pack.shape[0])}, {k3_bound / k3_ms:.3f} of bound; "
            f"{cnt['touched']} bricks touched; {counts['tile_march_fwd']} launches in the window above")
        # K4 alone on the batch: it marches each ray until it goes inactive
        g, s_total = bwd_inputs(cells, bg, pack, basis, target, trainer.opts, 0.0, max_steps)
        k4_ms = time_ms(lambda: tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw),
                        iters=10)
        probe_ms = time_ms(lambda: tm.tile_march_bwd_probe(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                                           sparsity_scale=0.0, **kw), iters=10)
        zero_ms = time_ms(lambda: (torch.zeros_like(bg.density_bricks), torch.zeros_like(bg.sh_bricks)), iters=10)
        work = k4_work(cells, bg, pack, basis, g, s_total, **kw)
        b4 = march_bwd_bound(work["touched"], bg.n_bricks, bg.basis_dim, n_rays, pack.shape[0], work, 0.0)
        SIZE_TIMES.setdefault("tile_march_bwd", {})[f"{name} batch"] = (k4_ms, b4[0])
        log(f"{tag}: K4 alone on a step's batch: {k4_text(k4_ms, probe_ms, zero_ms, work, b4)} (CUDA events)")
        del cells, g, s_total

        def run_steps(n, state=(bg, rms)):
            b, r = state
            for i in range(n):
                b, r, _ = trainer.train_step_tiles_pallas(b, r, rays, target, step + i, g_tv)
            return b, r

        profile_steps(run_steps, f"Plenoxels train, {name} {reso}^3")
        del bg, rms, trainer
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Plenoxels: the row-sparse steps and the training CLI
# ---------------------------------------------------------------------------

SPARSE_STEPS = 3            # steps of each row-sparse step held against a reference step
SPARSE_TIMED = 20           # timed steps of each step function (a CUDA event after each)
SPARSE_FRAC, SPARSE_RTOL, SPARSE_ATOL = 0.995, 1e-3, 1e-4   # tests/test_sparse_step.py:82-89
CLI_RESO = "[[128,128,128],[256,256,256]]"
CLI_STEPS = 40              # steps of the CLI drive, the upsample after half of them


def close_share(got, want) -> float:
    """The share of entries within SPARSE_RTOL and SPARSE_ATOL."""
    return float(torch.isclose(got.float(), want.float(), rtol=SPARSE_RTOL, atol=SPARSE_ATOL).float().mean())


def rms_now(rms, last_step, step: int, beta: float):
    """A lazy state's rms as the dense recursion holds it after ``step``:
    rms b^(step - last_step) on the rows ever touched."""
    decay = torch.where(last_step >= 0, beta ** (step - last_step).double(), 1.0).float()
    return rms * decay.reshape((-1,) + (1,) * (rms.dim() - 1))


def hold_states(tag, pairs, mses, want_mses) -> None:
    """Each (name, got, want) within tests/test_sparse_step.py's rule (more
    than SPARSE_FRAC of the entries close), the first MSE within 1e-5 and
    the later ones within 1e-4 (K4's atomics change their last bits)."""
    shares = {name: close_share(got, want) for name, got, want in pairs}
    rel = [abs(a - b) / abs(b) for a, b in zip(mses, want_mses)]
    log(f"{tag}: {len(mses)} steps; MSE relative differences " + ", ".join(f"{r:.3e}" for r in rel)
        + " (tolerances 1e-5, then 1e-4); entries close: " + ", ".join(f"{k} {v:.6f}" for k, v in shares.items())
        + f" (more than {SPARSE_FRAC} needed)")
    if not (rel[0] <= 1e-5 and all(r <= 1e-4 for r in rel[1:]) and min(shares.values()) > SPARSE_FRAC):
        raise AssertionError(f"{tag}: the row-sparse step disagrees with its reference step")


def timed_steps(tag, card, run_step, n_rays: int, route: str, n_steps: int = SPARSE_TIMED):
    """A warm step, then n_steps steps with a CUDA event after each
    (rays/s on the host clock, device ms a step), then a 3-step profile
    (the idle share and the kernels). Returns the median device ms."""
    run_step(0)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n_steps):
        run_step(1 + i)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    med = float(np.median(step_ms))
    log(f"{tag} on {card}: {n_steps} steps of {n_rays} rays in {wall:.6f} s: "
        f"{n_steps * n_rays / wall:.1f} rays/s; device ms a step median {med:.4f}, min {min(step_ms):.4f}, "
        f"max {max(step_ms):.4f} (CUDA events)")

    def run_steps(n):
        for i in range(n):
            run_step(1 + n_steps + i)

    profile_steps(run_steps, route, n=3, top=12)
    return med


def op_table(tag, run_step, nb: int, top: int = 24) -> None:
    """One step under torch.profiler with its operators' input shapes:
    the operators by device time (their own kernels'), each with its
    input shapes and calls, and the device time of those with an input
    of the state's nb or nb + 1 rows (whole-state tensors: a pass over
    them, or a gather or scatter of a step's rows from or into them)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        run_step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        us = float(getattr(e, "self_device_time_total", 0.0))
        if e.key.startswith("aten::") and us > 0:
            shapes = [tuple(x) for x in (e.input_shapes or []) if isinstance(x, (list, tuple)) and x]
            rows.append((us, e.key, shapes, e.count, any(x[0] in (nb, nb + 1) for x in shapes)))
    rows.sort(key=lambda r: -r[0])
    total = sum(r[0] for r in rows)
    whole = sum(r[0] for r in rows if r[4])
    log(f"{tag}: one step's operators by device time ({total / 1e3:.4f} ms; {whole / 1e3:.4f} ms in those with a "
        f"whole-state input of {nb} or {nb + 1} rows): " + "; ".join(
            f"{k} {sh} x{n} {us / 1e3:.4f} ms{' [whole-state input]' if w else ''}" for us, k, sh, n, w in rows[:top]))


def phase_train_plenoxels_sparse(dev, card: str) -> dict:
    """The row-sparse steps (train/plenoxels_sparse.py) at the fog 256^3
    and shell 512^3 training configurations of train_plenoxels: (a) K4's
    brick flags against the plain version's set; (b) SPARSE_STEPS steps
    of train_step_tiles_sparse and of the lazy
    train_step_tiles_packed_touched against train_step_tiles_pallas, and
    of the per-visit touched step against its dense sweep; (c) a step of
    each under set_sync_debug_mode (no waits); (d) each timed beside the
    dense step; then (e) the training CLI, cli/train_plenoxels.run with
    --step_mode touched from 128^3 to 256^3 on the synthetic scene.
    Returns the K3 and K4 launches of the timed windows by batch shape,
    those of the CLI run, and the CLI's wall."""
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.train import PlenoxelsTrainer
    from nerf_projects_tpu_torch.train import plenoxels_sparse as ps

    launches = {"tile_march_fwd": {}, "tile_march_bwd": {}}
    kw_trainer = dict(n_iters=128_000, lambda_tv=1e-5, lambda_tv_sh=1e-3, device=dev)
    for name, (reso, n_tiles) in TRAIN_SCENES.items():
        tag = f"train_plenoxels_sparse: {name} {reso}^3"
        bg = train_grid(dev, name)
        nb = bg.n_bricks
        geo = tm.geometry_only(bg)
        trainer = PlenoxelsTrainer(GridRenderOptions(step_size=0.5), **kw_trainer)
        trainer_pv = PlenoxelsTrainer(GridRenderOptions(step_size=0.5), rms_pervisit=True, **kw_trainer)
        rays = train_tile_rays(SEED + 2, n_tiles, dev)
        target = torch.full(rays.origins.shape, TRAIN_TARGET, device=dev)
        n_rays = target.shape[0] * target.shape[1]

        def gen(i):
            return torch.Generator(device=dev).manual_seed(SEED + 20 + i)

        # (a) K4's flags against the plain version's set
        cells, pack, basis, max_steps = tm.march_inputs(bg, rays, trainer.opts)
        kw = dict(max_steps=max_steps, color_mode=trainer.opts.color_mode, sigma_thresh=trainer.opts.sigma_thresh,
                  stop_thresh=trainer.opts.stop_thresh)
        g, s_total = bwd_inputs(cells, bg, pack, basis, target, trainer.opts, 0.0, max_steps)
        gd, gsh, flags = tm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                           flag_touched=True, **kw)
        want = tm.touched_bricks(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                 tiles_per_call=PLAIN_BATCH_TILES, **kw)
        nonzero = (gd != 0).any(1) | (gsh != 0).flatten(1).any(1)
        n_flag, n_want = int(flags.sum()), int(want.sum())
        n_diff, n_missed = int((flags != want).sum()), int((nonzero & (flags[:nb] == 0)).sum())
        log(f"{tag}: (a) K4 flags {n_flag} of {nb} bricks ({n_flag / nb:.4f}); the plain version's set "
            f"(backward_flushes' adding runs) {n_want}; {n_diff} differ; bricks with a nonzero gradient "
            f"{int(nonzero.sum())}, {n_missed} of them unflagged")
        if n_diff or n_missed or int(flags[nb]) != 0 or n_flag == 0:
            raise AssertionError(f"{tag}: K4's flags disagree with the plain version's set")
        del cells, g, s_total, gd, gsh, want, nonzero
        w_tv = max(int(trainer.tv_sparsity * nb), 1) + max(int(trainer.tv_sh_sparsity * nb), 1)
        K = -(-((n_flag + 4 * w_tv) * 5 // 4) // 256) * 256  # the batch's flags and TV rows, 25% over
        log(f"{tag}: max_touched {K} ({K / (nb + 1):.4f} of the state's rows)")

        # (b) three steps of each against its reference; (c) no waits
        dense_bg, dense_rms = bg, trainer.init_rms_bricks(bg)
        want_mse = []
        for i in range(SPARSE_STEPS):
            dense_bg, dense_rms, st = trainer.train_step_tiles_pallas(dense_bg, dense_rms, rays, target, i, gen(i))
            want_mse.append(float(st["mse"]))
        last = SPARSE_STEPS - 1
        steps = {
            "sparse": (trainer, lambda: ps.sparse_state_from_grid(bg),
                       lambda t, s, i: ps.train_step_tiles_sparse(t, geo, s, rays, target, i, gen(i), max_touched=K)),
            "touched": (trainer, lambda: ps.packed_state_from_grid(bg, bf16_cells=True),
                        lambda t, s, i: ps.train_step_tiles_packed_touched(t, geo, s, rays, target, i, gen(i),
                                                                           max_touched=K)),
        }
        times = {}
        for key, (tr, make, step) in steps.items():
            state = make()
            mses, overflow = [], []
            for i in range(SPARSE_STEPS):
                state, st = step(tr, state, i)
                mses.append(float(st["mse"]))
                overflow.append(float(st["touched_overflow"]))
            if max(overflow) > 0:
                raise AssertionError(f"{tag}: {key} step dropped touched rows ({overflow})")
            if key == "sparse":
                got = (state.density_k[:nb], state.sh_k[:nb], state.rms_density[:nb], state.rms_sh[:nb])
            else:
                got = (state.packed_k[:nb, :, 0], state.packed_k[:nb, :, 1:1 + 3 * bg.basis_dim],
                       state.rms[:nb, :, 0], state.rms[:nb, :, 1:1 + 3 * bg.basis_dim])
            ls = state.last_step[:nb]
            hold_states(f"{tag}: (b) {key} step against train_step_tiles_pallas", [
                ("density", got[0], dense_bg.density_bricks), ("sh", got[1], dense_bg.sh_bricks),
                ("rms density", rms_now(got[2], ls, last, trainer.rms_beta), dense_rms.rms_density),
                ("rms sh", rms_now(got[3], ls, last, trainer.rms_beta), dense_rms.rms_sh)], mses, want_mse)
            if key == "touched" and not torch.equal(state.cells, state.packed_k.to(torch.bfloat16)):
                raise AssertionError(f"{tag}: the touched step's bf16 cells are not its masters' rounding")
            check_waits(f"{tag}: (c) one {key} step", lambda: step(tr, state, SPARSE_STEPS), most=0)
            holder = [state]

            def run_step(i, holder=holder, step=step, tr=tr):
                holder[0] = step(tr, holder[0], SPARSE_STEPS + 1 + i)[0]

            tm.tile_march_fwd.launches = tm.tile_march_bwd.launches = 0
            times[key] = timed_steps(f"{tag}: (d) {key} step", card, run_step, n_rays,
                                     f"Plenoxels {key} step, {name} {reso}^3")
            for k in launches:
                launches[k][f"{name} batch"] = launches[k].get(f"{name} batch", 0) + getattr(tm, k).launches
            op_table(f"{tag}: (d) {key} step", lambda: run_step(SPARSE_TIMED + 3), nb)
            del state, holder, got
            torch.cuda.empty_cache()

        # the per-visit touched step against its dense sweep
        pv_states = {}
        pv_mse = {}
        for key, dense in (("touched per-visit", False), ("touched dense sweep", True)):
            state, pv_mse[key] = ps.packed_state_from_grid(bg, bf16_cells=True), []
            for i in range(SPARSE_STEPS):
                state, st = ps.train_step_tiles_packed_touched(trainer_pv, geo, state, rays, target, i, gen(i),
                                                               max_touched=K, dense_optim=dense)
                pv_mse[key].append(float(st["mse"]))
            pv_states[key] = state
        a, b = pv_states["touched per-visit"], pv_states["touched dense sweep"]
        hold_states(f"{tag}: (b) per-visit touched step against its dense sweep (dense_optim=True)",
                    [("packed masters", a.packed_k, b.packed_k), ("rms", a.rms, b.rms)],
                    pv_mse["touched per-visit"], pv_mse["touched dense sweep"])
        if not torch.equal(a.last_step, b.last_step):
            raise AssertionError(f"{tag}: the per-visit touched step's last_step differs from its dense sweep's")
        for key, dense in (("touched per-visit", False), ("touched dense sweep", True)):
            holder = [pv_states.pop(key)]

            def step_pv(st_, i, dense=dense):
                return ps.train_step_tiles_packed_touched(trainer_pv, geo, st_, rays, target, i, gen(i),
                                                          max_touched=K, dense_optim=dense)[0]

            check_waits(f"{tag}: (c) one {key} step", lambda: step_pv(holder[0], SPARSE_STEPS), most=0)

            def run_step(i, holder=holder, step_pv=step_pv):
                holder[0] = step_pv(holder[0], SPARSE_STEPS + 1 + i)

            tm.tile_march_fwd.launches = tm.tile_march_bwd.launches = 0
            times[key] = timed_steps(f"{tag}: (d) {key} step", card, run_step, n_rays,
                                     f"Plenoxels {key} step, {name} {reso}^3")
            for k in launches:
                launches[k][f"{name} batch"] += getattr(tm, k).launches
            del holder
            torch.cuda.empty_cache()
        del a, b

        # the dense step beside them
        holder = [(dense_bg, dense_rms)]

        def run_dense(i, holder=holder):
            b_, r_, _ = trainer.train_step_tiles_pallas(*holder[0], rays, target, SPARSE_STEPS + i, gen(i))
            holder[0] = (b_, r_)

        times["dense"] = timed_steps(f"{tag}: (d) the dense step (train_step_tiles_pallas)", card, run_dense, n_rays,
                                     f"Plenoxels dense step, {name} {reso}^3")
        log(f"{tag}: device ms a step, median: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f"; against the dense step " + ", ".join(f"{k} {times['dense'] / v:.2f}x" for k, v in times.items()
                                                      if k != "dense"))
        del holder, dense_bg, dense_rms, bg, geo
        torch.cuda.empty_cache()

    # (e) the training CLI on the synthetic scene, through one upsample
    import tempfile

    from nerf_projects_tpu_torch.cli import train_plenoxels as cli
    from nerf_projects_tpu_torch.data.base import SceneData
    from nerf_projects_tpu_torch.data.synthetic import make_dataset

    ds = make_dataset(n_views=8, image_size=64, device=dev)
    scene = SceneData(images=ds["images"].cpu().numpy(), poses=np.asarray(ds["poses"]), intrinsics=ds["intrinsics"],
                      near=ds["near"], far=ds["far"])
    with tempfile.TemporaryDirectory() as d:
        args = cli.build_parser().parse_args([
            "--train_dir", d, "--step_mode", "touched", "--reso", CLI_RESO, "--upsamp_every", str(CLI_STEPS // 2),
            "--n_iters", str(CLI_STEPS), "--print_every", "2", "--device", "cuda"])
        tm.tile_march_fwd.launches = tm.tile_march_bwd.launches = 0
        t0 = time.perf_counter()
        grid, _, result = cli.run(args, scene=scene, test_scene=scene)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"tile_march_fwd": tm.tile_march_fwd.launches, "tile_march_bwd": tm.tile_march_bwd.launches}
        entries = json.load(open(f"{d}/metrics_log.json"))
        mses = [e["metrics"]["mse"] for e in entries if e["phase"] == "training"]
        ckpt = f"{d}/ckpt.npz"
        saved = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
    log(f"train_plenoxels_sparse: (e) cli/train_plenoxels.run --step_mode touched --reso {CLI_RESO}, {CLI_STEPS} "
        f"steps of {args.batch_size} rays (make_dataset, 8 views of 64x64) on {card}: wall {wall:.3f} s (the "
        f"upsample, the final eval and the checkpoint included); reso {grid.reso}, capacity {grid.capacity}; mse "
        f"{mses[0]:.6f} -> {mses[-1]:.6f} over {len(mses)} logged steps; test PSNR {result['psnr']:.4f}; "
        f"ckpt.npz {saved} bytes; launches {counts}")
    if list(grid.reso) != json.loads(CLI_RESO)[-1] or not saved or not all(np.isfinite(mses)):
        raise AssertionError("train_plenoxels_sparse: the CLI did not upsample, save or train finitely")
    if not np.mean(mses[-3:]) < np.mean(mses[:3]):
        raise AssertionError("train_plenoxels_sparse: the CLI's loss did not fall")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"train_plenoxels_sparse: the CLI launched no {counts} kernel")
    return launches, counts, wall


BG_STEPS = 10               # steps of each step function in (a)
BG_TIMED = 10               # timed steps of each in (d), a CUDA event after each
BG_CHECK_RAYS = 256         # rays of the card-against-host step
BG_RENDER_RAYS = 4096       # rays of the reference background's render
BG_GRAD_TOL = 1e-4          # of scale: float32 autograd on both, the card's scatter-adds in another order
UPDATE_TOL = 1e-3           # |update err| in learning rates, where the gradient is clear of noise (held_update)


def grid_to(grid, dev):
    return dataclasses.replace(grid, links=grid.links.to(dev), density_data=grid.density_data.to(dev),
                               sh_data=grid.sh_data.to(dev))


def held_update(tag, got, want, g, lr: float, plain_rmsprop: bool) -> tuple:
    """A tensor updated by the card's step against the host's (both from
    one state, so their difference is that of the updates): within
    UPDATE_TOL of the step's learning rate where |g| > 1e-3 max |g| and
    sqrt(rms) > 100 eps after this first step (rms = g^2 with the
    masters' bootstrap, (1 - b) g^2 without it). There the step lr g /
    (sqrt(rms) + eps) moves by at most lr x 0.01 x |dg| / |g| for a
    gradient error dg. Returns (error in learning rates, entries held)."""
    g, got, want = g.detach().cpu(), got.detach().cpu(), want.detach().cpu()
    keep = (g.abs() > 1e-3 * g.abs().max()) & ((np.sqrt(0.05) if plain_rmsprop else 1.0) * g.abs() > 100 * 1e-8)
    n = int(keep.sum())
    err = float((got[keep] - want[keep]).abs().max()) / lr if n else 0.0
    if not err < UPDATE_TOL:
        raise AssertionError(f"{tag}: the card's update strays {err:.3e} learning rates from the host's ({n} entries)")
    return err, n


def held_grad(tag, got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    err = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    if not (err < BG_GRAD_TOL and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{tag}: the card's gradient strays {err:.3e} of scale from the host's")
    return err


def phase_train_plenoxels_bg(dev, card: str) -> None:
    """The cell route's background and learned-basis steps
    (train/plenoxels_trainer.py) on the fog 256^3 grid of TRAIN_SCENES as a
    SparseGrid, 5,120 rays a step (40 tiles of 8x16), target 0.4:
    train_step_bg with BackgroundMSI.create() (16 layers, reso 128) and
    train_step_with_basis with a 3D texture (reso 16, basis 9,
    reinit_learned_basis "sh") and with the MLP (width 16). (a) BG_STEPS
    steps of each: the loss falls and stays finite; (b) one step of each
    under set_sync_debug_mode: no waits; (c) one step of each on 256 rays
    on the card and on the host from the same state with the same TV
    windows: gradients within BG_GRAD_TOL of scale, updates within
    UPDATE_TOL learning rates where |g| is clear of noise (held_update;
    the masters' on the background route, whose whole-grid host passes
    every route shares); (d) device ms a step
    (CUDA events) and peak memory of each beside train_step (the cell
    route), then a ReferenceBackground composited behind the grid on
    4,096 rays against the host's render (each against the same render
    in float64: the card within NOISE_FACTOR x the host's distance), and
    the full-grid TV loss over
    build_neighbor_links (the g++ host op, against its numpy version).
    Plain torch but the host op: no kernel."""
    from nerf_projects_tpu_torch.ops import basis as ob
    from nerf_projects_tpu_torch.ops.background import BackgroundMSI, ReferenceBackground
    from nerf_projects_tpu_torch.ops.brick_grid import to_sparse_grid
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions, volume_render_grid
    from nerf_projects_tpu_torch.train import PlenoxelsTrainer
    from nerf_projects_tpu_torch.train import plenoxels_trainer as pt

    reso, n_tiles = TRAIN_SCENES["fog"]
    tag = f"train_plenoxels_bg: fog {reso}^3"
    grid = to_sparse_grid(train_grid(dev, "fog"))
    rays = train_tile_rays(SEED + 2, n_tiles, dev).map(lambda x: x.reshape(-1, 3))
    n_rays = rays.origins.shape[0]
    target = torch.full((n_rays, 3), TRAIN_TARGET, device=dev)
    kw_trainer = dict(n_iters=128_000, lambda_tv=1e-5, lambda_tv_sh=1e-3)
    trainer = PlenoxelsTrainer(GridRenderOptions(step_size=0.5), device=dev, **kw_trainer)
    host_trainer = PlenoxelsTrainer(GridRenderOptions(step_size=0.5), device="cpu", **kw_trainer)
    msi = BackgroundMSI.create(device=dev)
    texture = ob.reinit_learned_basis(ob.init_basis_3d(16, grid.basis_dim, device=dev), init_type="sh")
    mlp = ob.init_basis_mlp(torch.Generator(device=dev).manual_seed(SEED + 30), grid.basis_dim, mlp_width=16)
    zeros = lambda p: {k: torch.zeros_like(v) for k, v in p.items()} if isinstance(p, dict) else torch.zeros_like(p)
    log(f"{tag}: SparseGrid of {grid.capacity} cells; {n_rays} rays a step; MSI {tuple(msi.data.shape)}, texture "
        f"{tuple(texture.shape)}, MLP {sum(v.numel() for v in mlp.values())} parameters")

    def gen(i):
        return torch.Generator(device=dev).manual_seed(SEED + 40 + i)

    def bg_step(state, i):
        g, m, rms, rb = state
        g, m, rms, rb, st = trainer.train_step_bg(g, m, rms, rb, rays, target, i, gen(i))
        return (g, m, rms, rb), st

    def basis_step(basis_type):
        def step(state, i):
            g, rms, b, rb = state
            g, rms, b, rb, st = trainer.train_step_with_basis(g, rms, b, rb, rays, target, i, gen(i),
                                                              basis_type=basis_type)
            return (g, rms, b, rb), st
        return step

    def cell_step(state, i):
        g, rms = state
        g, rms, st = trainer.train_step(g, rms, rays, target, i, gen(i))
        return (g, rms), st

    routes = {
        "train_step_bg": (bg_step, lambda: (grid, msi, trainer.init_rms(grid), torch.zeros_like(msi.data))),
        "train_step_with_basis, 3D texture": (basis_step(ob.BASIS_TYPE_3D_TEXTURE),
                                              lambda: (grid, trainer.init_rms(grid), texture, zeros(texture))),
        "train_step_with_basis, MLP": (basis_step(ob.BASIS_TYPE_MLP),
                                       lambda: (grid, trainer.init_rms(grid), mlp, zeros(mlp))),
        "train_step (the cell route)": (cell_step, lambda: (grid, trainer.init_rms(grid))),
    }
    times = {}
    for route, (step, init) in routes.items():
        # (a) training
        state, mses = init(), []
        for i in range(BG_STEPS):
            state, st = step(state, i)
            mses.append(float(st["mse"]))
        log(f"{tag}: (a) {route}: mse over {BG_STEPS} steps " + " ".join(f"{m:.6f}" for m in mses))
        if not (np.isfinite(mses).all() and np.mean(mses[-3:]) < np.mean(mses[:3])):
            raise AssertionError(f"{tag}: (a) {route}: the loss did not fall or went non-finite")
        # (b) no waits
        check_waits(f"{tag}: (b) one {route} step", lambda: step(state, BG_STEPS), most=0)
        # (d) timings
        holder = [state]

        def run_step(i, holder=holder, step=step):
            holder[0] = step(holder[0], BG_STEPS + 1 + i)[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[route] = timed_steps(f"{tag}: (d) {route}", card, run_step, n_rays, f"Plenoxels {route}, fog {reso}^3",
                                   n_steps=BG_TIMED)
        log(f"{tag}: (d) {route}: peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
        del state, holder
        torch.cuda.empty_cache()
    log(f"{tag}: device ms a step, median: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))

    # (c) one step on 256 rays, card against host, the same TV windows
    sub, sub_t = rays.map(lambda x: x[:BG_CHECK_RAYS]), target[:BG_CHECK_RAYS]
    host_sub, host_t = sub.map(lambda x: x.cpu()), sub_t.cpu()
    gs = reso ** 3
    windows = [pt.sample_window(gen(99), gs, max(int(f * gs), 1))
               for f in (trainer.tv_sparsity, trainer.tv_sh_sparsity)]
    host_grid = grid_to(grid, "cpu")
    to_host = lambda p: {k: v.cpu() for k, v in p.items()} if isinstance(p, dict) else p.cpu()
    own = {"train_step_bg": (msi.data, to_host(msi.data)), "3D texture": (texture, to_host(texture)),
           "MLP": (mlp, to_host(mlp))}
    basis_types = {"3D texture": ob.BASIS_TYPE_3D_TEXTURE, "MLP": ob.BASIS_TYPE_MLP}
    real_window = pt.sample_window
    try:
        def fed(fn):
            drawn = iter(windows)
            pt.sample_window = lambda generator, n, w: next(drawn)
            return fn()

        for route, (p_card, p_host) in own.items():
            kw = {} if route == "train_step_bg" else dict(basis_type=basis_types[route])
            lr_own = trainer.lr_sh_fn(0) * 0.1 / 1e-2 if route == "train_step_bg" else 1e-6  # the steps' defaults
            # the card: the step itself, and its gradients (their noise sets the entries held)
            if route == "train_step_bg":
                m = BackgroundMSI(p_card, msi.radii)
                cg = fed(lambda: trainer.bg_grads(grid, m, sub, sub_t, torch.Generator()))
                new = fed(lambda: trainer.train_step_bg(grid, m, trainer.init_rms(grid), torch.zeros_like(p_card), sub,
                                                        sub_t, 0, torch.Generator()))
                c_new = (new[0].density_data, new[0].sh_data, new[1].data)
                hg = fed(lambda: host_trainer.bg_grads(host_grid, BackgroundMSI(p_host, msi.radii), host_sub, host_t,
                                                       torch.Generator()))
            else:
                cg = fed(lambda: trainer.basis_grads(grid, p_card, sub, sub_t, torch.Generator(), **kw))
                new = fed(lambda: trainer.train_step_with_basis(grid, trainer.init_rms(grid), p_card, zeros(p_card), sub,
                                                                sub_t, 0, torch.Generator(), **kw))
                c_new = (new[0].density_data, new[0].sh_data, new[2])
                hg = fed(lambda: host_trainer.basis_grads(host_grid, p_host, host_sub, host_t, torch.Generator(), **kw))
            # the host: the same step composed from its gradients (one autograd pass on the host, not two); the
            # masters' update (the same _cell_apply on every route, whole-grid passes on the host) on the first route
            h_own = ({k: host_trainer._rmsprop_plain(p_host[k], hg[2][k], torch.zeros_like(hg[2][k]), lr_own)[0]
                      for k in p_host} if isinstance(p_host, dict)
                     else host_trainer._rmsprop_plain(p_host, hg[2], torch.zeros_like(hg[2]), lr_own)[0])
            upd = []
            if route == "train_step_bg":
                h_grid, _ = host_trainer._cell_apply(host_grid, host_trainer.init_rms(host_grid), hg[0], hg[1], 0)
                upd = [held_update(f"{tag}: (c) {route} density", c_new[0], h_grid.density_data, cg[0],
                                   trainer.lr_sigma_fn(0), False),
                       held_update(f"{tag}: (c) {route} sh", c_new[1], h_grid.sh_data, cg[1], trainer.lr_sh_fn(0), False)]
                del h_grid
            flat = lambda x: [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]
            errs = [held_grad(f"{tag}: (c) {route} gradient {i}", a, b)
                    for i, (a, b) in enumerate(zip([cg[0], cg[1], *flat(cg[2])], [hg[0], hg[1], *flat(hg[2])]))]
            loss_err = abs(float(cg[3]) - float(hg[3])) / abs(float(hg[3]))
            upd += [held_update(f"{tag}: (c) {route} own parameters", a, b, g_, lr_own, True)
                    for a, b, g_ in zip(flat(c_new[2]), flat(h_own), flat(cg[2]))]
            if sum(n for _, n in upd) == 0:
                raise AssertionError(f"{tag}: (c) {route}: no updated entry's gradient is clear of noise")
            log(f"{tag}: (c) {route}, one step on {BG_CHECK_RAYS} rays, card against host (the same state and TV "
                f"windows): gradients within {max(errs):.3e} of scale (tolerance {BG_GRAD_TOL}), loss {loss_err:.3e} "
                f"relative; the updates of {'the masters and ' if route == 'train_step_bg' else ''}its own "
                f"parameters within {max(e for e, _ in upd):.3e} "
                f"learning rates where |g| is clear of noise (tolerance {UPDATE_TOL}; entries held: "
                + ", ".join(str(n) for _, n in upd) + ")")
            if not loss_err < BG_GRAD_TOL:
                raise AssertionError(f"{tag}: (c) {route}: the card's loss strays from the host's")
    finally:
        pt.sample_window = real_window

    # (d) a ReferenceBackground behind the grid, card against host
    g_ref = torch.Generator(device=dev).manual_seed(SEED + 31)
    ref_reso, ref_layers = 64, 16
    links = torch.randperm(2 * ref_reso * ref_reso, generator=g_ref, device=dev).reshape(2 * ref_reso, ref_reso)
    links = torch.where(torch.rand(links.shape, generator=g_ref, device=dev) < 0.2, -1, links).to(torch.int32)
    data = torch.randn((2 * ref_reso * ref_reso, ref_layers, 4), generator=g_ref, device=dev)
    data[..., 3] = torch.rand(data.shape[:-1], generator=g_ref, device=dev) * 3.0
    ref_bg = ReferenceBackground(data, links)
    r4 = rays.map(lambda x: x[:BG_RENDER_RAYS])
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_rgb = volume_render_grid(grid, r4, trainer.opts, background=ref_bg)["rgb"]
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        host_rgb = volume_render_grid(host_grid, r4.map(lambda x: x.cpu()), trainer.opts,
                                      background=ReferenceBackground(data.cpu(), links.cpu()))["rgb"]
        g64 = dataclasses.replace(grid, density_data=grid.density_data.double(), sh_data=grid.sh_data.double())
        exact = volume_render_grid(g64, r4.map(lambda x: x.double()), trainer.opts,
                                   background=ReferenceBackground(data.double(), links))["rgb"].cpu()
        del g64
    err = float((card_rgb.cpu() - host_rgb).abs().max())
    card_64, host_64 = (float((x.cpu().double() - exact).abs().max()) for x in (card_rgb, host_rgb))
    solid = volume_render_grid(grid, r4, trainer.opts)["rgb"]
    moved = float((card_rgb - solid).abs().max())
    log(f"{tag}: (d) a ReferenceBackground ({ref_layers} layers, reso {ref_reso}, 20% of texels pruned) "
        f"behind the grid on {BG_RENDER_RAYS} rays: card {card_ms:.3f} ms; max |rgb err| against the host's render "
        f"{err:.3e}; against float64 sums (the same render in float64 on the card) the card {card_64:.3e}, the host "
        f"{host_64:.3e} (the card within {NOISE_FACTOR}x the host's + 1e-6); it moves the rgb by up to {moved:.4f} "
        f"from the solid background")
    if not (card_64 <= NOISE_FACTOR * host_64 + 1e-6 and moved > 1e-3 and bool(torch.isfinite(card_rgb).all())):
        raise AssertionError(f"{tag}: (d) the reference background's render on the card disagrees with the host's")

    # the full-grid TV loss over the host op
    t0 = time.perf_counter()
    nbr = pt.build_neighbor_links(grid.links)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = pt.neighbor_links_reference(grid.links)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(nbr, plain):
        raise AssertionError(f"{tag}: build_neighbor_links (g++) disagrees with its numpy version")
    tv_d, tv_s = (float(pt.tv_loss(x, nbr)) for x in (grid.density_data, grid.sh_data))
    log(f"{tag}: build_neighbor_links over {reso}^3 links: the g++ host op {native_s:.3f} s, equal to its numpy "
        f"version ({plain_s:.3f} s); full-grid TV loss: density {tv_d:.6f}, SH {tv_s:.6f}")
    del grid, host_grid, nbr, plain
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# NeRF-SH: the fused trunk forward (K5f) and backward (K5b)
# ---------------------------------------------------------------------------

SH_DEG = 3                  # plenoctree/nerf_sh/config/blender.yaml
SH_RGB = 3 * (SH_DEG + 1) ** 2
SH_CHUNK = 8192             # rays a serving request (NeRFSHFlags.chunk)
SH_PATCH = (64, 128)        # 8,192 rays of an 800x800 Blender camera
SH_COARSE, SH_FINE = 64, 128
SPARSITY_POINTS = 10_000    # NeRFSHFlags.sparsity_npoints
# K5b's float64 rule. On the wgmma core the worst tensor's ratio read
# 0.888-1.675 over kernel_sh's 17 draws at 8,229 and 196,608 rows and
# 0.965-2.928 on its 8,193-row draws (NVIDIA H100 80GB HBM3, 700 W), so the
# factor sits 1.3x above the largest of the 21 it holds (the first port's
# tile, under 4.0, read up to 3.039); the bf16-reduce control read 58.554,
# a plain version with another float32 order up to 1.922 from 8,192 rows
# and up to 44.455 below (chip_probes.py sh; PERF.md §6)
SH_NOISE_FACTOR = 3.81
SH_NOISE_DRAWS = 4          # weight and input draws a head width
# Below this many rows a few bf16 or relu flips rule the reading, for the
# float32 plain version with another sum order too (chip_probes.py sh): it
# is logged there, not held.
SH_RULE_ROWS = 8192
# The NeRF-SH route's kernels by the profiler's names: K5f is the core's
# forward in its NeRF-SH input mode (3) without the stash; K5b that forward
# with it, the NeRF-SH dX pass, dW and K5b's reduce (no other core kernel
# runs on the route).
SH_KERNELS = {
    "K5f": r"sm90_fwd_kernel<3, false, false>",
    "K5b": r"sm90_fwd_kernel<3, true, true>|sm90_dx_kernel<true>|sm90_dw_kernel|sh_grad_reduce_kernel",
}


def sh_points(n: int, gen: torch.Generator, dev):
    """The block encoding [n, 63] of points uniform in the cube of radius
    1.5, as the model feeds the trunk."""
    from nerf_projects_tpu_torch.ops.posenc import posenc

    pts = (torch.rand(n, 3, generator=gen) * 3.0 - 1.5).to(dev)
    return posenc(pts, 10, ordering="block").contiguous()


def mmT_bf16_reduce(a: torch.Tensor, b: torch.Tensor, rows: int = 64) -> torch.Tensor:
    """fused_mlp._mmT (a [T, I]^T @ b [T, O], bf16 operands) with the sum
    over rows carried in bf16 from one 64-row tile to the next: a K5b
    whose split-K reduce lost float32, the control that K5b's float64
    rule must refuse."""
    pad = (-a.shape[0]) % rows
    A = F.pad(a.to(torch.bfloat16).float(), (0, 0, 0, pad)).view(-1, rows, a.shape[1])
    B = F.pad(b.to(torch.bfloat16).float(), (0, 0, 0, pad)).view(-1, rows, b.shape[1])
    acc = torch.zeros(a.shape[1], b.shape[1], dtype=torch.bfloat16, device=a.device)
    for part in torch.bmm(A.transpose(1, 2), B):
        acc = (acc.float() + part).to(torch.bfloat16)
    return acc.float()


def phase_kernel_sh(dev) -> tuple:
    """K5f (over the route's buffer, forward_weights) against its plain
    version on 1, 100, 8192 + 1 and 8192 + 37 rows (each head width the
    kernel builds: 27, 48, 75 and 128 columns; the first three drawn from a
    generator of their own, so K5b's draws stay those of earlier runs) and
    at a serving request's fine level (1,572,864 rows, sh_deg 3), a second
    launch the same bits at each. K5b (over backward_weights: the same
    buffer and the dX buffer) against its plain version on 1, 100 and
    8192 + 1 rows (a third generator's draws) and on 8192 + 37 rows, for
    SH_NOISE_DRAWS draws of weights and inputs at each width, and at a
    training step's fine level (196,608 rows, sh_deg 3), and against
    float64 sums (SH_NOISE_FACTOR) from SH_RULE_ROWS up (logged below,
    where the rows zero-padded to a whole tile give the same bits); two
    launches on the same inputs give the same bits, and a plain K5b
    whose dW sums round to bf16 between 64-row tiles fails the float64
    rule. Then both kernels timed at those levels."""
    from nerf_projects_tpu_torch.models.nerf_sh import CondMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm

    gen = torch.Generator().manual_seed(SEED + 20)
    edge_gen = torch.Generator().manual_seed(SEED + 25)
    bwd_edge_gen = torch.Generator().manual_seed(SEED + 26)
    serve_rows, train_rows = SH_CHUNK * (SH_COARSE + SH_FINE), TRAIN_RAYS * (SH_COARSE + SH_FINE)
    max_fwd = max_bwd = 0.0
    readings = []
    for num_rgb in (27, SH_RGB, 75, 128):
        for draw in range(SH_NOISE_DRAWS):
            mlp = random_biases(CondMLP(num_rgb_channels=num_rgb).reset_parameters(gen), gen).to(dev)
            W, wf = fsm.pack_sh_params(mlp), fsm.forward_weights(mlp)
            wk, wkt = fsm.backward_weights(mlp, wf)
            headline = num_rgb == SH_RGB and draw == 0
            sizes = [(n, edge_gen) for n in (1, 100, 8192 + 1)] + [(8192 + 37, gen)] if draw == 0 else []
            for n, ng in sizes + ([(serve_rows, gen)] if headline else []):
                x = sh_points(n, ng, dev)
                got = fsm.fused_sh_fwd(wf, x, num_rgb)
                again = fsm.fused_sh_fwd(wf, x, num_rgb)
                want = fsm.fused_sh_mlp_reference(W, x, num_rgb)
                torch.cuda.synchronize()
                if not all(bool(torch.isfinite(g).all()) for g in got):
                    raise AssertionError(f"kernel_sh: non-finite K5f output at n={n}, num_rgb={num_rgb}")
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                rel = err / (float(torch.cat([w.abs().flatten() for w in want]).mean()) + 1.0)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"kernel_sh: fused_sh_fwd n={n} num_rgb={num_rgb} max_abs_err={err:.3e} "
                    f"err/(mean|plain|+1)={rel:.3e} (tolerance {KERNEL_TOL}); a second launch gives the same "
                    f"bits: {same}")
                if not (rel < KERNEL_TOL and same):
                    raise AssertionError(f"kernel_sh: fused_sh_fwd disagrees with its plain version or itself at "
                                         f"n={n}, num_rgb={num_rgb}")
                max_fwd = max(max_fwd, err)
            if headline:
                fwd_args = (mlp, W, wf, x)
            # K5b: the ragged sizes (draw 0), then the float64 rule's draws
            bwd_sizes = [(n, bwd_edge_gen) for n in ((1, 100, 8192 + 1) if draw == 0 else ())]
            bwd_sizes += [(n, gen) for n in ((8192 + 37, train_rows) if headline else (8192 + 37,))]
            for n, ng in bwd_sizes:
                x = sh_points(n, ng, dev)
                g_rgb = (torch.randn(n, num_rgb, generator=ng) * 1e-3).to(dev)
                g_sig = (torch.randn(n, 1, generator=ng) * 1e-3).to(dev)
                got = fsm.fused_sh_bwd(wk, wkt, x, g_rgb, g_sig)
                want = fsm.fused_sh_bwd_reference(W, x, g_rgb, g_sig)
                with fm.float64_sums():
                    exact = fsm.fused_sh_bwd_reference(W, x, g_rgb, g_sig)
                tag = f"kernel_sh: fused_sh_bwd n={n} num_rgb={num_rgb} draw {draw}"
                held = n >= SH_RULE_ROWS
                max_bwd = max(max_bwd, check_grads(tag, got, want, fsm.FusedSHWeights._fields,
                                                   exact if held else None, SH_NOISE_FACTOR))
                if held:
                    readings.append(noise_ratio(got, want, exact)[0])
                else:
                    ratio, i = noise_ratio(got, want, exact)
                    log(f"{tag}: against float64 sums the kernel strays {ratio:.3f}x as far as the float32 plain "
                        f"version ({fsm.FusedSHWeights._fields[i]}): logged, not held, below {SH_RULE_ROWS} rows")
                    padded = (F.pad(t, (0, 0, 0, (-n) % 128)).contiguous() for t in (x, g_rgb, g_sig))
                    if not all(torch.equal(a, b) for a, b in zip(got, fsm.fused_sh_bwd(wk, wkt, *padded))):
                        raise AssertionError(f"{tag}: the rows zero-padded to a whole tile gave other bits")
                if draw == 0 and not all(torch.equal(a, b) for a, b in
                                         zip(got, fsm.fused_sh_bwd(wk, wkt, x, g_rgb, g_sig))):
                    raise AssertionError(f"{tag}: a second launch gave other bits")
                if headline and n == 8192 + 37:
                    saved, fm._mmT = fm._mmT, mmT_bf16_reduce
                    try:
                        control = fsm.fused_sh_bwd_reference(W, x, g_rgb, g_sig)
                    finally:
                        fm._mmT = saved
                    ratio, i = noise_ratio(control, want, exact)
                    log(f"{tag}: the control (dW summed in bf16 between 64-row tiles) strays {ratio:.3f}x as far "
                        f"as the float32 plain version ({fsm.FusedSHWeights._fields[i]})")
                    if not ratio > SH_NOISE_FACTOR:
                        raise AssertionError("kernel_sh: K5b's float64 rule passes a bf16 reduce")
                del exact
            if headline:
                bwd_args = (W, wk, wkt, x, g_rgb, g_sig)
    log(f"kernel_sh: K5b's float64 rule over the {len(readings)} draws it holds: the worst tensor strays "
        f"{min(readings):.3f}x to {max(readings):.3f}x (median {float(np.median(readings)):.3f}x) as far as the "
        f"float32 plain version, tolerance {SH_NOISE_FACTOR}x")

    mlp, W, wf, x = fwd_args
    ms = time_ms(lambda: fsm.fused_sh_fwd(wf, x, SH_RGB), iters=20)
    plain_ms = time_ms(lambda: fsm.fused_sh_mlp_reference(W, x, SH_RGB), iters=3, warmup=1)
    flops = 2.0 * fsm.fwd_macs(SH_RGB) * serve_rows
    nbytes = fsm.io_bytes(SH_RGB) * serve_rows + wf.numel() * 2
    b_ms, by, t_ops, t_bytes = bound(flops, nbytes)
    log(f"kernel_sh: fused_sh_fwd n={serve_rows}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms (operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), "
        f"{b_ms / ms:.3f} of bound")
    del x

    def launch_fwd(n):
        xs = sh_points(n, gen, dev)
        return lambda: fsm.fused_sh_fwd(wf, xs, SH_RGB)

    time_sizes("fused_sh_fwd", "serving fine", (ms, b_ms),
               (("serving coarse", SH_CHUNK * SH_COARSE), ("training coarse", TRAIN_RAYS * SH_COARSE),
                ("training fine", train_rows)),
               launch_fwd, lambda n: (2.0 * fsm.fwd_macs(SH_RGB) * n, fsm.io_bytes(SH_RGB) * n + wf.numel() * 2))
    fwd = {"name": "fused_sh_fwd", "route": "cuda", "source": "nerf_projects_tpu_torch/csrc/fused_sh_fwd.cu",
           "replaces": "nerf_projects_tpu/ops/pallas/fused_sh_mlp.py:215", "launches": 0,
           "max_abs_err": max_fwd, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
           "library_ms": None}

    W, wk, wkt, x, g_rgb, g_sig = bwd_args
    ms = time_ms(lambda: fsm.fused_sh_bwd(wk, wkt, x, g_rgb, g_sig), iters=10)
    plain_ms = time_ms(lambda: fsm.fused_sh_bwd_reference(W, x, g_rgb, g_sig), iters=3, warmup=1)
    macs = fsm.bwd_macs(SH_RGB)
    flops = 2.0 * sum(macs.values()) * train_rows
    nbytes = fsm.io_bytes(SH_RGB) * train_rows + fsm.GRAD_ELEMS * 4 + (wk.numel() + wkt.numel()) * 2
    b_ms, by, t_ops, t_bytes = bound(flops, nbytes)
    stash = fsm.STASH_BYTES_PER_ROW * train_rows
    log(f"kernel_sh: fused_sh_bwd n={train_rows}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms (operations {t_ops:.4f} ms: multiply-adds a row {macs}; bytes "
        f"{t_bytes:.4f} ms), {b_ms / ms:.3f} of bound; the stashes hold {stash / 1e9:.3f} GB, written once and "
        f"read at least once: {2 * stash / H100_HBM_BYTES_S * 1e3:.4f} ms of HBM traffic the bound does not count")

    def launch_bwd(n):
        xs = sh_points(n, gen, dev)
        gr = (torch.randn(n, SH_RGB, generator=gen) * 1e-3).to(dev)
        gs = (torch.randn(n, 1, generator=gen) * 1e-3).to(dev)
        return lambda: fsm.fused_sh_bwd(wk, wkt, xs, gr, gs)

    time_sizes("fused_sh_bwd", "training fine", (ms, b_ms), (("training coarse", TRAIN_RAYS * SH_COARSE),),
               launch_bwd, lambda n: (2.0 * sum(macs.values()) * n, fsm.io_bytes(SH_RGB) * n + fsm.GRAD_ELEMS * 4
                                      + (wk.numel() + wkt.numel()) * 2))
    bwd = {"name": "fused_sh_bwd", "route": "cuda", "source": "nerf_projects_tpu_torch/csrc/fused_sh_bwd.cu",
           "replaces": "nerf_projects_tpu/ops/pallas/fused_sh_mlp.py:242", "launches": 0,
           "max_abs_err": max_bwd, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
           "library_ms": None}
    return fwd, bwd


class plain_sh:
    """Within the block, the fused SH trunk runs its plain forward on CUDA
    tensors too (no autograd: serving only)."""

    def __enter__(self):
        from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm

        self.saved = fsm.fused_sh_apply
        fsm.fused_sh_apply = lambda mlp, x, num_rgb: fsm.fused_sh_mlp_reference(fsm.pack_sh_params(mlp), x, num_rgb)
        return self

    def __exit__(self, *exc):
        from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm

        fsm.fused_sh_apply = self.saved


def sh_trainer(dev, **kwargs):
    """NeRFSHTrainer over the headline model: build_model of NeRFSHFlags
    at sh_deg 3 (8x256 trunk, 64 + 128 samples, near 2, far 6, white
    background) with the fused trunk on."""
    from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
    from nerf_projects_tpu_torch.train import NeRFSHTrainer

    flags = NeRFSHFlags(sh_deg=SH_DEG, use_viewdirs=False, use_fused_trunk=True)
    model = build_model(flags)
    if not model._fused_trunk_ok():
        raise AssertionError("nerf_sh: the fused-trunk gate refused the headline configuration")
    return NeRFSHTrainer(model, device=dev, **kwargs)  # the trainer's defaults are the flags' schedule


def phase_render_nerf_sh(dev, card: str) -> int:
    """Requests of 8,192 rays (64x128 patches of the three Blender cameras
    of the render phase) through NeRFSHTrainer.render_eval at the headline
    configuration, random weights and biases from a seed. The first
    request per camera is checked against the same render through K5f's
    plain version and through the float32 modules; then requests run back
    to back for WINDOW_S seconds. K5f's launch counter is zeroed just
    before and read just after."""
    from nerf_projects_tpu_torch.core.rays import camera_rays, pose_spherical
    from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm

    trainer = sh_trainer(dev)
    state = trainer.init_state(SEED)
    model = random_biases(state.model, torch.Generator().manual_seed(SEED + 21))
    K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1]], np.float32)
    h, w = SH_PATCH
    requests = []
    for theta, r0, c0 in REQUESTS:
        rays = camera_rays(SIZE, SIZE, K, pose_spherical(theta, -30.0, 4.0), device=dev)
        requests.append(rays.map(lambda t: t[r0:r0 + h, c0:c0 + w].reshape(-1, 3).contiguous()))
    torch.cuda.synchronize()
    n_rays = h * w

    fsm.fused_sh_fwd.launches = 0
    for i, rays in enumerate(requests):
        t0 = time.perf_counter()
        out = trainer.render_eval(model, rays)
        torch.cuda.synchronize()
        log(f"render_nerf_sh: first request at theta {REQUESTS[i][0]}: {time.perf_counter() - t0:.6f} s")
        for key in ("rgb", "acc", "disp"):
            if out[key].shape[0] != n_rays or not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"render_nerf_sh: request {i} {key} is not finite of {n_rays} rays")
        with torch.no_grad():
            fine = model(rays, False)[-1]
            with plain_sh():
                ref = model(rays, False)[-1]
        if not torch.equal(fine.rgb, out["rgb"]):
            raise AssertionError(f"render_nerf_sh: request {i}: render_eval and the model disagree")
        # the 1e10 tail makes the last sample opaque whenever its density is
        # above zero: rays whose last weight changes sign are counted, not compared
        flips = (fine.weights[:, -1] > 0) != (ref.weights[:, -1] > 0)
        worst = float((fine.rgb - ref.rgb).abs().amax(-1)[~flips].max())
        log(f"render_nerf_sh: request {i} vs K5f's plain version: max |rgb| diff {worst:.3e} over "
            f"{int((~flips).sum())} rays, {int(flips.sum())} tail flips")
        if not worst <= RGB_TOL or int(flips.sum()) > MAX_TAIL_FLIPS * n_rays:
            raise AssertionError(f"render_nerf_sh: request {i} disagrees with the plain version")
        model.use_fused_trunk = False
        f32 = trainer.render_eval(model, rays)["rgb"]
        model.use_fused_trunk = True
        d32 = (out["rgb"] - f32).abs()
        log(f"render_nerf_sh: request {i} vs the float32 modules: max |rgb| diff {float(d32.max()):.3e}, "
            f"mean {float(d32.mean()):.3e}, rays beyond {RGB_TOL}: {int((d32.amax(-1) > RGB_TOL).sum())}")
        if not float(d32.mean()) < RGB_TOL:
            raise AssertionError(f"render_nerf_sh: request {i} is far from the float32 render")

    fsm.fused_sh_fwd.launches = 0
    secs = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < WINDOW_S:
        t0 = time.perf_counter()
        trainer.render_eval(model, requests[len(secs) % len(requests)])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    window = time.perf_counter() - t_window
    launches = fsm.fused_sh_fwd.launches
    log(f"render_nerf_sh on {card}: {len(secs)} timed requests of {n_rays} rays in {window:.6f} s: "
        f"{len(secs) * n_rays / window:.1f} rays/s; request ms median {np.median(secs) * 1e3:.4f}, "
        f"min {min(secs) * 1e3:.4f}, max {max(secs) * 1e3:.4f}; {launches} fused_sh_fwd launches")
    if launches <= 0:
        raise AssertionError("render_nerf_sh: the main path launched no fused_sh_fwd kernel")
    check_waits("render_nerf_sh: one request", lambda: trainer.render_eval(model, requests[0]), 0)
    return launches


def phase_train_nerf_sh(dev, card: str) -> dict:
    """NeRFSHTrainer at the headline configuration, Adam at the reference's
    log-linear schedule (5e-4 -> 5e-6, delay 2500 steps at 0.01), 1,024
    rays a step drawn on the card from the 32,768-ray pool of
    make_dataset(n_views=2, image_size=128). First one step on CHECK_RAYS
    rays (randomized off, sparsity and weight decay on, 10,000 sparsity
    points) against the same step on the host through the plain versions;
    then WARM_STEPS and a WINDOW_S window at sparsity_weight 0 (as
    bench.py's nerf_sh_train), then a profile. The launch counters are
    zeroed just before the window and read just after. The host step takes
    the card's fine depths, and both models' gradients are held to the
    plain versions'."""
    import copy as _copy

    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.models import nerf_sh
    from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm
    from nerf_projects_tpu_torch.ops.sampling import cast_rays, sample_pdf

    ds = make_dataset(n_views=2, image_size=128, device=dev)
    torch.cuda.synchronize()
    idx = torch.arange(CHECK_RAYS, device=dev) * (ds["pixels"].shape[0] // CHECK_RAYS)
    rays, target = ds["rays"].map(lambda t: t[idx]), ds["pixels"][idx]
    kw = dict(sparsity_weight=1e-2, sparsity_npoints=SPARSITY_POINTS, weight_decay_mult=1e-3, randomized=False)
    on_card, on_host = sh_trainer(dev, **kw), sh_trainer("cpu", **kw)
    model = random_biases(on_card.init_state(SEED).model, torch.Generator().manual_seed(SEED + 22))
    host_model = _copy.deepcopy(model).cpu()
    pts = (torch.rand(SPARSITY_POINTS, 3, generator=torch.Generator().manual_seed(SEED + 23)) * 3.0 - 1.5)
    # the host step takes the card's fine depths: through the resample, bf16
    # noise in the coarse weights moves the fine samples (ROADMAP, "Limits
    # of comparison")
    card_z = []

    def card_sample_pdf(*args, **kwargs):
        z, points = sample_pdf(*args, **kwargs)
        card_z.append(z.detach())
        return z, points

    def host_sample_pdf(generator, bins, weights, origins, directions, z_vals, n, **kwargs):
        z = card_z[-1].cpu()
        return z, cast_rays(z, origins, directions)

    fsm.fused_sh_fwd.launches = fsm.fused_sh_bwd.launches = 0
    try:
        nerf_sh.sample_pdf = card_sample_pdf
        stats, grads = on_card.value_and_grad(model, None, rays, target, sparsity_points=pts.to(dev))
        launched = (fsm.fused_sh_fwd.launches, fsm.fused_sh_bwd.launches)
        nerf_sh.sample_pdf = host_sample_pdf
        hstats, hgrads = on_host.value_and_grad(host_model, None, rays.map(lambda t: t.cpu()), target.cpu(),
                                                sparsity_points=pts)
    finally:
        nerf_sh.sample_pdf = sample_pdf
    tag = f"train_nerf_sh: one step of {CHECK_RAYS} rays with sparsity and weight decay"
    log(f"{tag}: " + ", ".join(f"{k} {float(stats[k]):.6f} (plain {float(hstats[k]):.6f})" for k in stats)
        + f"; K5f, K5b launches {launched}")
    if launched != (3, 3) or not all(abs(float(stats[k]) - float(hstats[k])) <= 3e-3 * abs(float(hstats[k]))
                                      for k in stats):
        raise AssertionError(f"{tag}: the loss disagrees with the plain versions")
    for level in ("coarse", "fine"):
        names = [k for k in grads if k.startswith(f"mlp_{level}.")]
        check_grads(f"{tag}, {level} model", [grads[k].cpu() for k in names], [hgrads[k] for k in names], names)
    del model, host_model, grads, hgrads

    trainer = sh_trainer(dev)
    state = trainer.init_state(SEED)
    random_biases(state.model, torch.Generator().manual_seed(SEED + 24))
    torch.cuda.reset_peak_memory_stats(dev)
    n_pool = ds["pixels"].shape[0]

    def steps(n):
        losses = []
        for _ in range(n):
            i = torch.randint(0, n_pool, (TRAIN_RAYS,), generator=state.generator, device=dev)
            _, st = trainer.train_step(state, ds["rays"].map(lambda t: t[i]), ds["pixels"][i])
            losses.append(st["loss"])
        return losses

    fsm.fused_sh_fwd.launches = fsm.fused_sh_bwd.launches = 0
    losses = steps(WARM_STEPS)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    t0 = time.perf_counter()
    events[0].record()
    while time.perf_counter() - t0 < WINDOW_S:
        losses += steps(1)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    counts = {"fused_sh_fwd": fsm.fused_sh_fwd.launches, "fused_sh_bwd": fsm.fused_sh_bwd.launches}
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    losses = torch.stack(losses).tolist()
    n = len(step_ms)
    log(f"train_nerf_sh on {card}: {n} timed steps of {TRAIN_RAYS} rays in {window:.6f} s: "
        f"{n * TRAIN_RAYS / window:.1f} rays/s; step ms median {float(np.median(step_ms)):.4f}, "
        f"min {min(step_ms):.4f}, max {max(step_ms):.4f}; loss {losses[0]:.6f} -> {losses[-1]:.6f} over "
        f"{len(losses)} steps; peak allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; launches "
        f"{counts} (warm steps included)")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"train_nerf_sh: the training step launched no {counts} kernel")
    if not all(np.isfinite(losses)):
        raise AssertionError("train_nerf_sh: a loss is not finite")
    k = min(10, len(losses) // 4)
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise AssertionError("train_nerf_sh: the loss did not fall")
    check_waits("train_nerf_sh: one step", lambda: steps(1), 0)
    profile_steps(steps, "NeRF-SH train (fused trunk)", split=SH_KERNELS)
    return counts


LOOP_STEPS = 60              # loop steps of each route
LOOP_SCAN_STEPS = 20         # trainer.scan_steps steps timed beside each route's loop
LOOP_FOCAL = 555.555         # half-res lego: 0.5 * 800 / tan(0.5 * camera_angle_x), halved
FERN_HW, FERN_FOCAL = (378, 504), 407.5625  # fern's poses_bounds.npy hwf at factor 8
PSNR_TOL_DB = 1e-4


def loop_config(basedir: str, expname: str, **kw):
    """The loop's config for the Blender lego configuration, as an AttrDict
    with no YAML: 64 + 128 samples, viewdirs, white background, 1,024
    rays a step, Adam at 5e-4 decaying over 500k steps, precrop_frac 0.5."""
    from nerf_projects_tpu_torch.utils.config import AttrDict, create_default_config

    cfg = create_default_config()
    cfg.update(dataset_type="blender", N_samples=LOOP_COARSE, N_importance=LOOP_FINE, use_viewdirs=True,
               white_bkgd=True, N_rand=TRAIN_RAYS, lrate=5e-4, lrate_decay=500, precrop_frac=0.5, basedir=basedir,
               expname=expname, i_print=20, i_weights=30, i_testset=LOOP_STEPS)
    cfg.update(kw)
    return AttrDict(cfg)


def loop_scenes(dev):
    """(train, test) SceneData: half-res lego's size, make_dataset's sphere
    scene (4 train views, 1 test view); and a forward-facing NDC scene at
    fern's factor-8 size, the same spheres 4 units down -z from cameras
    near the origin that all look down -z, near 0 and far 1 in NDC."""
    from nerf_projects_tpu_torch.core.rays import camera_rays
    from nerf_projects_tpu_torch.data.base import SceneData
    from nerf_projects_tpu_torch.data.synthetic import default_scene, make_dataset, render_scene

    ds = make_dataset(n_views=5, image_size=400, focal=LOOP_FOCAL, seed=SEED, device=dev)
    images = ds["images"].cpu().numpy()
    kw = dict(intrinsics=ds["intrinsics"], near=ds["near"], far=ds["far"], white_bkgd=True)
    lego = (SceneData(images=images[:4], poses=ds["poses"][:4], **kw),
            SceneData(images=images[4:], poses=ds["poses"][4:], **kw))
    spheres = default_scene()
    spheres = spheres._replace(centers=spheres.centers + torch.tensor([0.0, 0.0, -4.0]))
    (H, W), rng = FERN_HW, np.random.default_rng(SEED + 30)
    K = np.array([[FERN_FOCAL, 0, W / 2], [0, FERN_FOCAL, H / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, :2, 3] = rng.uniform(-0.3, 0.3, (5, 2))
    views = []
    for pose in poses:
        rays = camera_rays(H, W, K, pose, device=dev)
        views.append(torch.cat([render_scene(spheres, rays.map(lambda t: t[r:r + 64]), white_bkgd=False)
                                for r in range(0, H, 64)]))
    images = torch.stack(views).cpu().numpy()
    kw = dict(intrinsics=K, near=0.0, far=1.0, ndc=True)
    fern = (SceneData(images=images[:4], poses=poses[:4], **kw), SceneData(images=images[4:], poses=poses[4:], **kw))
    return lego, fern


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_train_nerf_loop(dev, card: str) -> dict:
    """``train/loop.py::train`` at the lego configuration (a config dict, no
    YAML), LOOP_STEPS steps a route on the card: batching on the autograd
    route (i_print 20, i_weights 30, i_testset 60); the same resumed from
    its step-30 checkpoint; no_batching with precrop_iters 20; the mega
    route (K2) through trainer_kwargs, whose step at the loop's levels is
    also held against the host's plain path (hold_step); and a
    forward-facing NDC scene at fern's factor-8 size. Each route: the
    losses finite and falling, the files, the testset PSNR against a
    direct render_image + compute_metrics of the final state, the loop's
    rays/s beside scan_steps' on the same configuration, eval seconds a
    view and peak memory. Then one loop step (draw + train_step) of each
    draw under set_sync_debug_mode: no waits. K2's launch counter is
    zeroed just before the mega run and read just after. Returns
    {"fused_train_level": launches}."""
    import shutil
    import tempfile

    from nerf_projects_tpu_torch.core.rays import Rays, camera_rays, ndc_rays
    from nerf_projects_tpu_torch.obs.metrics import compute_metrics
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft
    from nerf_projects_tpu_torch.train import loop

    lego, fern = loop_scenes(dev)
    torch.cuda.synchronize()
    routes = {
        "batching": (lego, {}, None),
        "resumed": (lego, {}, None),
        "no_batching": (lego, dict(no_batching=True, precrop_iters=20), None),
        "mega": (lego, {}, dict(use_fused_mlp=True, use_mega=True, compute_dtype=torch.bfloat16)),
        "ndc": (fern, dict(white_bkgd=False), None),
    }
    launches = {}
    with tempfile.TemporaryDirectory() as base:
        for name, ((scene, test_scene), kw, trainer_kwargs) in routes.items():
            cfg = loop_config(base, name, **kw)
            exp = os.path.join(base, name)
            if name == "resumed":
                os.makedirs(os.path.join(exp, "checkpoints"))
                saved = os.path.join(exp, "checkpoints", f"{30:09d}.pt")
                shutil.copy(os.path.join(base, "batching", "checkpoints", f"{30:09d}.pt"), saved)
            torch.cuda.reset_peak_memory_stats(dev)
            ft.fused_train_level.launches = 0
            t0 = time.perf_counter()
            trainer, state = loop.train(cfg, max_iters=LOOP_STEPS, scene=scene, test_scene=test_scene,
                                        trainer_kwargs=trainer_kwargs, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = ft.fused_train_level.launches
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            tag = f"train_nerf_loop {name}"
            if trainer_kwargs:
                # the route's step at the loop's levels (S 64 and 192) against
                # the host's plain path, perturb off, on pool rays drawn from a seed
                check = loop_config(base, "check", perturb=0.0, **kw)
                on_card = loop.make_trainer(check, scene, trainer_kwargs, dev)
                if not (on_card.use_fused_mlp and on_card.use_mega):
                    raise AssertionError(f"{tag}: a kernel gate refused the loop's configuration")
                pool, pool_rgb = loop._build_ray_pool(scene, dev)
                pick = torch.randperm(pool_rgb.shape[0], generator=torch.Generator().manual_seed(SEED + 31))
                pick = pick[:CHECK_RAYS].to(dev)
                hold_step(f"{tag}: one step of {CHECK_RAYS} rays (S {LOOP_COARSE} + {LOOP_FINE})", on_card,
                          loop.make_trainer(check, scene, trainer_kwargs, "cpu"), pool.map(lambda t: t[pick]),
                          pool_rgb[pick])
                del on_card, pool, pool_rgb
            log_rows = read_jsonl(os.path.join(exp, "training_log.jsonl"))
            losses = [r["loss"] for r in log_rows]
            steps = [r["step"] for r in log_rows]
            want_steps = [40, 60] if name == "resumed" else [20, 40, 60]
            if steps != want_steps or state.step != LOOP_STEPS:
                raise AssertionError(f"{tag}: logged steps {steps}, state at {state.step}")
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"{tag}: the loss is not finite or did not fall: {losses}")
            files = ["training_log.jsonl", "training_log.csv", "metrics_log.json",
                     f"checkpoints/{60:09d}.pt", f"testset_{60:06d}/metrics.json"]
            files += [] if name == "resumed" else [f"checkpoints/{30:09d}.pt"]
            missing = [p for p in files if not os.path.exists(os.path.join(exp, p))]
            if missing:
                raise AssertionError(f"{tag}: missing {missing}")
            if name == "resumed":
                ckpt = torch.load(saved, map_location="cpu", weights_only=True)
                restored = loop.load_checkpoint(saved, trainer.init_state(0))
                got, want = restored.optimizer.state_dict()["state"], ckpt["optimizer"]["state"]
                same = (restored.step == ckpt["step"] == 30
                        and all(torch.equal(v.cpu(), sd[k]) for model, sd in zip(restored.params, ckpt["models"])
                                for k, v in model.state_dict().items())
                        and sorted(got) == sorted(want) and len(want) > 0
                        and all(torch.equal(got[k][m].cpu(), v[m]) for k, v in want.items()
                                for m in ("step", "exp_avg", "exp_avg_sq"))
                        and torch.equal(restored.generator.get_state(), ckpt["generator"]))
                log(f"{tag}: started at 30 (logged steps {steps}); restored models, Adam moments and generator "
                    f"equal to the checkpoint: {same}")
                if not same:
                    raise AssertionError(f"{tag}: the restored state is not the checkpoint's")
            # the testset metrics against a direct render of the final state
            with open(os.path.join(exp, f"testset_{60:06d}", "metrics.json")) as f:
                psnr = json.load(f)["per_image"][0]["psnr"]
            H, W = test_scene.height, test_scene.width
            rays = camera_rays(H, W, test_scene.intrinsics, test_scene.poses[0], device=dev)
            if test_scene.ndc:
                o, d = ndc_rays(H, W, test_scene.focal, 1.0, rays.origins, rays.directions)
                rays = Rays(o, d, rays.viewdirs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            direct = compute_metrics(trainer.render_image(state.params, rays)["rgb"], test_scene.images[0])["psnr"]
            eval_s = time.perf_counter() - t1
            if not abs(psnr - direct) <= PSNR_TOL_DB:
                raise AssertionError(f"{tag}: metrics.json PSNR {psnr} against a direct render's {direct}")
            # scan_steps on the same configuration, from a fresh state
            pool, pool_rgb = loop._build_ray_pool(scene, dev)
            fresh = trainer.init_state(0)
            trainer.scan_steps(fresh, pool, pool_rgb, 2, batch_size=TRAIN_RAYS)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.scan_steps(fresh, pool, pool_rgb, LOOP_SCAN_STEPS, batch_size=TRAIN_RAYS)
            torch.cuda.synchronize()
            scan = LOOP_SCAN_STEPS * TRAIN_RAYS / (time.perf_counter() - t1)
            log(f"{tag} on {card}: {LOOP_STEPS - (30 if name == 'resumed' else 0)} steps in {wall:.3f} s "
                f"(eval and checkpoints included); loop {log_rows[-1]['rays_per_sec']:.1f} rays/s over steps "
                f"{steps[-2]}-60 beside scan_steps {scan:.1f} rays/s; loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
                f"testset PSNR {psnr:.4f} dB (direct {direct:.4f}); eval {eval_s:.3f} s a {H}x{W} view; "
                f"peak allocated {peak:.3f} GB; K2 launches {launches[name]}")
            if name == "batching":
                draws = [(loop.make_draw(cfg, scene, dev), False)]
                nb = loop_config(base, "waits", no_batching=True, precrop_iters=20)
                draws += [(loop.make_draw(nb, scene, dev), True), (loop.make_draw(nb, scene, dev), False)]
                gen = torch.Generator(device=dev).manual_seed(1)
                for i, (draw, in_precrop) in enumerate(draws):
                    check_waits(f"train_nerf_loop: one loop step, draw {i}",
                                lambda: trainer.train_step(state, *draw(gen, in_precrop)), 0)
            del trainer, state, fresh, pool, pool_rgb
    if launches["mega"] != 2 * LOOP_STEPS or any(v for k, v in launches.items() if k != "mega"):
        raise AssertionError(f"train_nerf_loop: K2 launches {launches} (2 a step on the mega route only)")
    return {"fused_train_level": launches["mega"]}


def phase_train_nerf_sh_cli(dev, card: str, run_dir=None) -> dict:
    """``cli/train_nerf_sh.py::train_main`` at sh_deg 3, full width (8x256),
    64 + 128 samples, 1,024 rays a step and use_fused_trunk, on
    make_dataset(n_views=4, image_size=128) for LOOP_STEPS steps (print
    20, save 30, render 60); then ``cli/eval_nerf_sh.py::evaluate`` from
    checkpoint.pt with flags.json restoring the model, save_output off.
    The loss falls (the logged batch losses are printed; the step-60
    render's MSE of view 0, free of batch noise, is held below the initial
    model's), K5f and K5b launch (counters zeroed just before train_main,
    read after each call), the three JSON files are written, and each
    view's PSNR is render_image_sh's of the trained model. ``run_dir``: the
    run directory, kept by the caller (a temporary one when None)."""
    from nerf_projects_tpu_torch.cli.eval_nerf_sh import evaluate
    from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags
    from nerf_projects_tpu_torch.cli.train_nerf_sh import render_image_sh, train_main
    from nerf_projects_tpu_torch.data.base import SceneData
    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.obs.metrics import compute_metrics
    from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm

    ds = make_dataset(n_views=4, image_size=128, seed=SEED, device=dev)
    scene = SceneData(images=ds["images"].cpu().numpy(), poses=ds["poses"], intrinsics=ds["intrinsics"],
                      near=ds["near"], far=ds["far"], white_bkgd=True)
    with contextlib.nullcontext(run_dir) if run_dir else tempfile.TemporaryDirectory() as run:
        flags = NeRFSHFlags(train_dir=run, sh_deg=SH_DEG, use_viewdirs=False, use_fused_trunk=True,
                            batch_size=TRAIN_RAYS, print_every=20, save_every=30, render_every=LOOP_STEPS)
        torch.cuda.reset_peak_memory_stats(dev)
        fsm.fused_sh_fwd.launches = fsm.fused_sh_bwd.launches = 0
        t0 = time.perf_counter()
        trainer, state, _, _ = train_main(flags, scene=scene, test_scene=scene, max_steps=LOOP_STEPS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_counts = (fsm.fused_sh_fwd.launches, fsm.fused_sh_bwd.launches)
        with open(os.path.join(run, "metrics_log.json")) as f:
            entries = json.load(f)
        rows = [e for e in entries if e["phase"] == "training"]
        losses = [e["metrics"]["loss"] for e in rows]
        mse = [e["metrics"]["mse"] for e in entries if e["phase"] == "evaluation"]
        init = trainer.init_state(20200823).model  # train_main's seed
        mse.insert(0, compute_metrics(render_image_sh(trainer, init, scene, 0, chunk=flags.chunk, device=dev),
                                      scene.images[0])["mse"])
        del init
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        fsm.fused_sh_fwd.launches = 0
        summary = evaluate(NeRFSHFlags(train_dir=run, save_output=False), scene=scene, device=dev)
        eval_fwd = fsm.fused_sh_fwd.launches
        files = ["checkpoint.pt", "flags.json", "timings.txt", "nerf_evaluation_steps.json",
                 "nerf_evaluation_summary.json", "nerf_evaluation_final.json"]
        missing = [p for p in files if not os.path.exists(os.path.join(run, p))]
        with open(os.path.join(run, "nerf_evaluation_steps.json")) as f:
            per_image = json.load(f)
    tag = "train_nerf_sh_cli"
    log(f"{tag} on {card}: {LOOP_STEPS} steps in {wall:.3f} s (render and checkpoints included), "
        f"{rows[-1]['additional_info']['timing']['rays_per_sec']:.1f} rays/s over steps 40-60; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f} (steps 20, 60); view 0's MSE {mse[0]:.6f} at init -> "
        f"{mse[-1]:.6f} at step 60; peak allocated {peak:.3f} GB; K5f, K5b launches {train_counts}; "
        f"evaluate: {summary['n_images']} views of {scene.height}x{scene.width} at {summary['rays_per_sec']:.1f} rays/s, PSNR "
        f"{summary['psnr']:.4f} dB, {eval_fwd} K5f launches")
    if missing:
        raise AssertionError(f"{tag}: missing {missing}")
    if min(train_counts) <= 0 or eval_fwd <= 0:
        raise AssertionError(f"{tag}: K5f / K5b launches {train_counts}, {eval_fwd} in evaluate")
    if not all(np.isfinite(losses + mse)) or len(mse) != 2 or not mse[1] < mse[0]:
        raise AssertionError(f"{tag}: the loss is not finite or did not fall: {losses}, view 0's MSE {mse}")
    if summary["n_images"] != 4:
        raise AssertionError(f"{tag}: evaluate scored {summary['n_images']} views")
    for m in per_image:
        v = m["image_index"]
        want = compute_metrics(render_image_sh(trainer, state.model, scene, v, chunk=flags.chunk, device=dev),
                               scene.images[v])["psnr"]
        if not abs(m["psnr"] - want) <= PSNR_TOL_DB:
            raise AssertionError(f"{tag}: view {v} PSNR {m['psnr']} against render_image_sh's {want}")
    return {"fused_sh_fwd": train_counts[0] + eval_fwd, "fused_sh_bwd": train_counts[1]}


OCTREE_STEPS = 500          # the run's steps before extraction: train_nerf_sh_cli's 60, then 440 more
OCTREE_DEPTH = 8            # octree_tools extract's --init_grid_depth default (a 512^3 step-1 grid)
# The phase extracts at depth 7. At depth 8 the tree of this run (1,201,323
# nodes, 1.884 GB of float32 data: under the 4 GB that would call for depth
# 7 by size) took the phase ~300 s on the card's host (PERF.md §6, the
# PlenOctree slice's first run): ~30 s of zlib for each save of its 0.9 GB
# of float16 data, and ~170 s to compress it (15 median cuts over 9.6M
# cells, then the files), which with the earlier phases' ~430 s passes the
# 600 s watchdog.
OCTREE_EXTRACT_DEPTH = 7
OCTREE_HELD_LEAVES = 4096   # finest leaves held against K5f's plain version
OCTREE_RAYS = 1024          # rays of the exact march's hold and of the SGD step's
OCTREE_MARCH_TOL = 1e-4     # the sliced march against the step-at-a-time march: float32 sums in another order
OCTREE_UPDATE_TOL = 1e-4    # SGD updates, card against host, of the largest update
COMPRESS_PSNR_DB = 0.5      # compressed_eval's PSNR against evaluate's
MESH_RESO = 256             # gen_mesh --reso default
MESH_ISO = 10.0             # gen_mesh's default iso (25) is above this run's densities after 500 steps (largest 13.6)
VIDEO_POSES, VIDEO_SIZE = 4, 128  # gen_video's renderers: poses of the path, frame side
VIDEO_GRID_RESO = 64        # the grid gen_video renders (written to an npz, then loaded by its renderer)


def octree_nodes(idx: torch.Tensor, reso: int, depth: int) -> int:
    """The nodes of the tree that extraction refines ``depth`` times
    around the flat C-order cells ``idx`` of its reso^3 step-1 grid: the
    root and, at each depth m, the distinct blocks of 2^(depth + 1 - m)
    cells a side that hold a masked cell."""
    ijk = torch.stack([idx // (reso * reso), (idx // reso) % reso, idx % reso], -1)
    n = 1
    for s in range(1, depth + 1):
        b = ijk >> s
        side = reso >> s
        n += int(torch.unique((b[:, 0] * side + b[:, 1]) * side + b[:, 2]).numel())
    return n


def octree_march_steps(tree, rays, opts):
    """The exact octree march in numpy on the host, one step at a time
    over all rays, the transmittance carried sample by sample (the JAX
    package's scan), with its own descent of the tree: the independent
    reference of ops/octree_render.py's sliced march. -> (rgb, acc)."""
    from nerf_projects_tpu_torch.ops.octree_render import default_max_steps, infer_sh_deg
    from nerf_projects_tpu_torch.ops.sh import eval_sh_bases

    B = (infer_sh_deg(tree.data_dim) + 1) ** 2
    child = tree.child_host.reshape(-1)
    data = tree.data.detach().cpu().numpy().reshape(-1, tree.data_dim)
    inv, off = tree.invradius, tree.offset
    origins, dirs = (t.cpu().numpy() for t in (rays.origins, rays.directions))
    basis = eval_sh_bases(B, rays.viewdirs.cpu()).numpy()

    def cell(node, pos):  # node * 8 + the octant of pos in [0, 1)^3
        bit = pos >= 0.5
        return node * 8 + bit[:, 0] * 4 + bit[:, 1] * 2 + bit[:, 2], bit

    def query(p):
        t = p * inv + off
        inside = np.all((t >= 0.0) & (t < 1.0), axis=-1)
        pos = np.clip(t, 0.0, np.float32(1.0 - 1e-7))
        node = np.zeros(len(p), np.int64)
        for _ in range(tree.depth_limit):
            flat, bit = cell(node, pos)
            rel = child[flat]
            pos = np.where((rel == 0)[:, None], pos, pos * 2 - bit)
            node = node + rel
        return np.where(inside[:, None], data[cell(node, pos)[0]], 0.0)

    o, d = origins * inv + off, dirs * inv
    world_len = np.linalg.norm(dirs, axis=-1)
    dt = opts.step_size / np.maximum(np.linalg.norm(d, axis=-1), 1e-12)
    inv_d = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    t_lo, t_hi = -o * inv_d, (1.0 - o) * inv_d
    t0 = np.maximum(np.max(np.minimum(t_lo, t_hi), -1), 0.0)
    t1 = np.min(np.maximum(t_lo, t_hi), -1)
    n = len(o)
    log_T, rgb, acc = np.zeros(n, np.float32), np.zeros((n, 3), np.float32), np.zeros(n, np.float32)
    for k in range(default_max_steps(opts.step_size)):
        t = t0 + np.float32(k) * dt
        if (t >= t1).all():
            break  # every ray is past its exit: nothing is left to add
        valid = (t < t1) & (t1 > t0)
        vals = query((o + t[:, None] * d - off) / inv)
        sigma = np.maximum(vals[:, -1], 0.0)
        sigma = np.where(valid & (sigma > opts.sigma_thresh), sigma, 0.0)
        c = 1.0 / (1.0 + np.exp(-np.einsum("rcb,rb->rc", vals[:, : 3 * B].reshape(n, 3, B), basis)))
        T = np.exp(log_T)
        active = T > opts.stop_thresh
        tau = sigma * dt * world_len
        w = np.where(active, T * (1.0 - np.exp(-tau)), 0.0)
        rgb, acc = rgb + w[:, None] * c, acc + w
        log_T = log_T - np.where(active, tau, 0.0)
    return (torch.from_numpy(np.float32(rgb + (1.0 - acc[:, None]) * opts.background_brightness)),
            torch.from_numpy(np.float32(acc)))


class step_clock:
    """Wall seconds, the card's peak allocated GB and the process's peak
    resident GB so far of a block of steps, logged as one line."""

    def __init__(self, tag: str, dev):
        self.tag, self.dev = tag, dev

    def __enter__(self):
        torch.cuda.synchronize(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.dev)
        self.wall = time.perf_counter() - self.t0
        if exc[0] is None:
            log(f"plenoctree: {self.tag}: {self.wall:.3f} s, peak allocated "
                f"{torch.cuda.max_memory_allocated(self.dev) / 1e9:.3f} GB, host peak {host_peak_gb():.3f} GB")


def phase_plenoctree(dev, card: str, run_dir: str) -> dict:
    """The PlenOctree pipeline through the port's CLIs on the NeRF-SH run
    in ``run_dir`` (train_nerf_sh_cli's): the steps of the module
    docstring's ``plenoctree``. Returns this phase's K5f, K5b, K3 and K4
    launches (counters zeroed just before its first step, read after its
    last)."""
    from nerf_projects_tpu_torch.cli import gen_mesh, gen_video, octree_tools
    from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags
    from nerf_projects_tpu_torch.cli.render_imgs import render_grid_image
    from nerf_projects_tpu_torch.cli.train_nerf_sh import train_main
    from nerf_projects_tpu_torch.core.rays import camera_rays
    from nerf_projects_tpu_torch.data.base import SceneData
    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.models import grid_lifecycle as gl
    from nerf_projects_tpu_torch.models.octree import PlenOctree
    from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
    from nerf_projects_tpu_torch.ops.octree_render import OctreeRenderOptions, volume_render_octree
    from nerf_projects_tpu_torch.pipeline.extraction import auto_scale, sigma_grid
    from nerf_projects_tpu_torch.pipeline.optimization import OctreeFinetuner, finetune_fast

    tag = "plenoctree"
    ds = make_dataset(n_views=4, image_size=128, seed=SEED, device=dev)
    scene = SceneData(images=ds["images"].cpu().numpy(), poses=ds["poses"], intrinsics=ds["intrinsics"],
                      near=ds["near"], far=ds["far"], white_bkgd=True)
    del ds
    parse = octree_tools.build_parser().parse_args
    tree_path, comp_path = os.path.join(run_dir, "octree.npz"), os.path.join(run_dir, "octree_compressed.npz")
    fsm.fused_sh_fwd.launches = fsm.fused_sh_bwd.launches = 0
    tm.tile_march_fwd.launches = tm.tile_march_bwd.launches = 0
    t_phase = time.perf_counter()

    # (0) the run trained on, without the schedule's 2,500-step delay
    with step_clock(f"train_main resumed to step {OCTREE_STEPS}", dev):
        flags = NeRFSHFlags(train_dir=run_dir, sh_deg=SH_DEG, use_viewdirs=False, use_fused_trunk=True,
                            batch_size=TRAIN_RAYS, lr_delay_steps=0, print_every=100, save_every=OCTREE_STEPS,
                            render_every=0)
        train_main(flags, scene=scene, test_scene=scene, max_steps=OCTREE_STEPS, device=dev)
    _, model = octree_tools._load_model(argparse.Namespace(train_dir=run_dir, data_dir=None, config=None), dev)

    # (1) the masked share at 512^3 and the depth-8 tree's size
    with step_clock("autoscale at 256^3 and sigma at 512^3 (the depth probe)", dev):
        center, radius = auto_scale(model.eval_points_raw, (0.0, 0.0, 0.0), (1.5,) * 3, init_grid_depth=8,
                                    device=dev)
        probe = PlenOctree.create(1, center=center, radius=[r * 1.05 for r in radius], device=dev)
        reso = 2 ** (OCTREE_DEPTH + 1)
        sigma, _ = sigma_grid(model.eval_points_raw, reso, probe.invradius, probe.offset, 65536, dev)
        idx = torch.nonzero(sigma >= float(-np.log(1.0 - 0.01) / (2.0 / reso)))[:, 0]
        sigma_max = float(sigma.max())
        above_iso = float((sigma >= MESH_ISO).float().mean())
        del sigma
        nodes = octree_nodes(idx, reso, OCTREE_DEPTH)
        share = idx.numel() / reso**3
        del idx
    data_bytes = nodes * 8 * (3 * (SH_DEG + 1) ** 2 + 1) * 4
    depth = OCTREE_EXTRACT_DEPTH
    log(f"{tag}: box center {np.round(center, 4).tolist()} radius {np.round(radius, 4).tolist()} (x1.05); "
        f"masked share of the 512^3 cells {share:.6f}, largest sigma {sigma_max:.3f}, share >= {MESH_ISO} "
        f"{above_iso:.6f}; the depth-8 tree: {nodes} nodes, {data_bytes / 1e9:.3f} GB of float32 data; "
        f"extraction at depth {depth} (the watchdog, above)")
    if share <= 0:
        raise AssertionError(f"{tag}: no cell of the run's field passes the extraction threshold")

    # (2) extract through the CLI, then 4,096 finest leaves against K5f's plain version
    stats = {}
    with step_clock(f"octree_tools extract --autoscale --init_grid_depth {depth}", dev):
        tree = octree_tools.cmd_extract(parse(["extract", "--train_dir", run_dir, "--output", tree_path,
                                               "--autoscale", "--init_grid_depth", str(depth)]),
                                        device=dev, stats=stats)
    log(f"{tag}: extract: {tree.n_nodes} nodes, {tree.n_leaves} leaves, {stats['finest_leaves']} finest, masked "
        f"share of the {2 ** (depth + 1)}^3 step-1 cells {stats['masked_share']:.6f}; "
        f"{os.path.getsize(tree_path) / 1e6:.1f} MB written")
    clk = step_clock("the leaves' hold", dev).__enter__()
    flat, depths, corners, sizes = tree.leaf_geometry()
    finest = np.nonzero(depths == depths.max())[0][:OCTREE_HELD_LEAVES]
    offs = np.random.default_rng(0).random((len(finest), 8, 3)).astype(np.float32)  # extract_octree's seed 0
    unit = corners[finest][:, None, :] + offs.astype(np.float64) * sizes[finest][:, None, None]
    world = torch.from_numpy(((unit - tree.offset) / tree.invradius).astype(np.float32).reshape(-1, 3)).to(dev)
    with plain_sh(), torch.inference_mode():
        coeffs, sig = model.eval_points_raw(world)
    want = torch.cat([coeffs, sig], -1).reshape(len(finest), 8, -1).mean(1)
    want[:, -1] = torch.relu(want[:, -1])
    got = tree.data.reshape(-1, tree.data_dim)[torch.from_numpy(flat[finest]).to(dev)]
    err = float((got - want).abs().max()) / (float(want.abs().mean()) + 1.0)
    clk.__exit__(None, None, None)
    log(f"{tag}: {len(finest)} finest leaves against the mean of their samples through K5f's plain version: "
        f"max |err| / (mean |plain| + 1) {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{tag}: extracted leaves {err:.3e} from K5f's plain version")

    # (3) evaluate: the exact march (1,024 rays against the host's step-at-a-time march), then --fast
    opts = OctreeRenderOptions()
    ev = ["evaluate", "--input", tree_path, "--data_dir", "unused", "--train_dir", run_dir]
    with step_clock("evaluate (exact octree march, 4 views of 128^2)", dev) as clk:
        exact = octree_tools.cmd_evaluate(parse(ev), scene=scene, device=dev)
    exact_ms = clk.wall * 1e3 / 4
    saved = PlenOctree.load(tree_path, device=dev)  # the file evaluate read (float16 data)
    rays = camera_rays(scene.height, scene.width, scene.intrinsics, scene.poses[1], device=dev)
    rays = rays.map(lambda x: x.reshape(-1, 3))
    with torch.inference_mode():
        view_acc = torch.cat([volume_render_octree(saved, rays.map(lambda x: x[i:i + 8192]), opts)["acc"]
                              for i in range(0, rays.origins.shape[0], 8192)]).cpu()
    # rays that reach the density first (a ray through empty space checks little), in a seeded order
    order = torch.randperm(view_acc.numel(), generator=torch.Generator().manual_seed(SEED))
    sel = torch.cat([order[view_acc[order] > 0.05], order[view_acc[order] <= 0.05]])[:OCTREE_RAYS]
    rays = rays.map(lambda x: x[sel.to(dev)])
    with torch.inference_mode():
        on_card = volume_render_octree(saved, rays, opts)
    with step_clock(f"the host's step-at-a-time march of {OCTREE_RAYS} rays", dev):
        ref_rgb, ref_acc = octree_march_steps(saved.to("cpu"), rays.map(lambda x: x.cpu()), opts)
    march_err = max(float((on_card["rgb"].cpu() - ref_rgb).abs().max()),
                    float((on_card["acc"].cpu() - ref_acc).abs().max()))
    log(f"{tag}: evaluate: PSNR {exact['mean']['psnr']:.4f} dB, {exact_ms:.1f} ms a view; {OCTREE_RAYS} rays "
        f"against the host's step-at-a-time march: max |err| {march_err:.3e} (tol {OCTREE_MARCH_TOL}), "
        f"acc mean {float(ref_acc.mean()):.4f}")
    if not march_err <= OCTREE_MARCH_TOL:
        raise AssertionError(f"{tag}: the exact octree march is {march_err:.3e} from the step-at-a-time march")
    with step_clock("evaluate --fast (bake, then the fast grid route)", dev) as clk:
        fast = octree_tools.cmd_evaluate(parse(ev + ["--fast"]), scene=scene, device=dev)
    log(f"{tag}: evaluate --fast: PSNR {fast['mean']['psnr']:.4f} dB, {clk.wall * 1e3 / 4:.1f} ms a view "
        f"(the bake included)")

    # (4) finetune_fast for one epoch (K3 + K4), then one SGD step against the host's
    ft_stats = {}
    k3, k4 = tm.tile_march_fwd.launches, tm.tile_march_bwd.launches
    with step_clock("finetune_fast, 1 epoch", dev):
        tuned = finetune_fast(saved, scene, scene, n_epochs=1, val_interval=1, stats=ft_stats)
    k3, k4 = tm.tile_march_fwd.launches - k3, tm.tile_march_bwd.launches - k4
    log(f"{tag}: finetune_fast: the baked grid's val PSNR {ft_stats['initial_val_psnr']:.4f} -> "
        f"{ft_stats['val_psnr'][-1]:.4f} dB; K3, K4 launches {k3}, {k4}")
    if not ft_stats["val_psnr"][-1] >= ft_stats["initial_val_psnr"] or min(k3, k4) <= 0:
        raise AssertionError(f"{tag}: finetune_fast: val PSNR {ft_stats}, K3 / K4 launches {k3}, {k4}")
    ft = OctreeFinetuner(opts, lr=1e7, chunk=OCTREE_RAYS)
    target = torch.from_numpy(scene.images[1].reshape(-1, 3))[sel]
    with step_clock(f"one SGD step on {OCTREE_RAYS} rays, card and host", dev):
        new_card, _, mse_card = ft.step(tuned, tuned.data, None, rays, target.to(dev))
        host = tuned.to("cpu")
        new_host, _, mse_host = ft.step(host, host.data, None, rays.map(lambda x: x.cpu()), target)
    du, dw = (new_card - tuned.data).cpu(), new_host - host.data
    scale = float(dw.abs().max())
    upd_err = float((du - dw).abs().max()) / max(scale, 1e-30)
    log(f"{tag}: SGD step at lr 1e7 on {OCTREE_RAYS} rays: MSE {float(mse_card):.6f} (host {float(mse_host):.6f}); "
        f"updates against the host's: max |err| / max |update| {upd_err:.3e} (tol {OCTREE_UPDATE_TOL}), "
        f"max |update| {scale:.4e}")
    if not (scale > 0 and upd_err <= OCTREE_UPDATE_TOL):
        raise AssertionError(f"{tag}: the SGD step's updates are {upd_err:.3e} from the host's")
    del new_card, new_host, host, du, dw, tuned

    # (5) compress, then evaluate the compressed tree
    with step_clock("compress (median cut, 65,536 colours a basis)", dev):
        comp = octree_tools.cmd_compress(parse(["compress", "--input", tree_path, "--output", comp_path]),
                                         device=dev)
    z = np.load(comp_path)
    palettes = [len(z[k]) for k in z.files if k.startswith("palette_")]
    with step_clock("compressed_eval", dev):
        cev = octree_tools.cmd_compressed_eval(parse(["compressed_eval", "--input", comp_path, "--data_dir", "unused"]),
                                               scene=scene, device=dev)
    log(f"{tag}: compress: ratio {comp['compression_ratio']:.3f} ({comp['compressed_bytes'] / 1e6:.1f} MB), "
        f"palettes {min(palettes)}-{max(palettes)} entries over {len(palettes)} bases; compressed_eval PSNR "
        f"{cev['mean']['psnr']:.4f} dB against evaluate's {exact['mean']['psnr']:.4f}")
    if max(palettes) > 65536 or not abs(cev["mean"]["psnr"] - exact["mean"]["psnr"]) <= COMPRESS_PSNR_DB:
        raise AssertionError(f"{tag}: compression: palettes up to {max(palettes)}, PSNR "
                             f"{cev['mean']['psnr']} against {exact['mean']['psnr']}")

    # (6) the mesh
    obj = os.path.join(run_dir, "mesh.obj")
    with step_clock(f"gen_mesh --kind nerf_sh --reso {MESH_RESO} --iso {MESH_ISO}", dev):
        verts, tris = gen_mesh.main([run_dir, "--out", obj, "--kind", "nerf_sh", "--reso", str(MESH_RESO),
                                     "--iso", str(MESH_ISO)])
    log(f"{tag}: gen_mesh: {len(verts)} vertices, {len(tris)} triangles, {os.path.getsize(obj) / 1e6:.1f} MB OBJ")
    if not (len(tris) > 0 and os.path.getsize(obj) > 0):
        raise AssertionError(f"{tag}: gen_mesh wrote no surface")
    # (6b) gen_video's renderers: a grid, the tree and the run
    grid_path = os.path.join(run_dir, "grid.npz")
    g = SparseGrid.create(VIDEO_GRID_RESO, basis_dim=GRID_BASIS, use_sphere_bound=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    g.density_data.copy_(torch.rand(g.density_data.shape, generator=gen, device=dev) * 2.0)
    g.sh_data.copy_(torch.randn(g.sh_data.shape, generator=gen, device=dev) * 0.2)
    g.save(grid_path)
    video = ["--out_dir", "unused", "--n_poses", str(VIDEO_POSES), "--width", str(VIDEO_SIZE), "--height",
             str(VIDEO_SIZE)]
    frames = {}
    with step_clock(f"gen_video make_renderer: 3 kinds x {VIDEO_POSES} poses at {VIDEO_SIZE}^2", dev):
        for kind, ckpt in (("grid", grid_path), ("octree", tree_path), ("nerf_sh", run_dir)):
            args = gen_video.build_parser().parse_args([ckpt, "--kind", kind] + video)
            render = gen_video.make_renderer(args, dev)
            frames[kind] = torch.stack([render(pose) for pose in gen_video.poses(args)])
    loaded = SparseGrid.load(grid_path, device=dev)
    same = all(torch.equal(frames["grid"][i], render_grid_image(
        loaded, SceneData(images=np.zeros((1, VIDEO_SIZE, VIDEO_SIZE, 3), np.float32), poses=np.asarray([pose]),
                          intrinsics=gen_video.intrinsics(args), near=0.1, far=10.0), 0,
        GridRenderOptions(step_size=args.step_size), args.chunk)) for i, pose in enumerate(gen_video.poses(args)))
    log(f"{tag}: gen_video: frames {[tuple(f.shape) for f in frames.values()]}, finite "
        f"{[bool(torch.isfinite(f).all()) for f in frames.values()]}, mean "
        f"{[round(float(f.mean()), 4) for f in frames.values()]} (grid, octree, nerf_sh); the grid's frames equal "
        f"render_grid_image's: {same}")
    if not (same and all(f.shape == (VIDEO_POSES, VIDEO_SIZE, VIDEO_SIZE, 3) and bool(torch.isfinite(f).all())
                         for f in frames.values())):
        raise AssertionError(f"{tag}: gen_video's frames are not finite, or the grid's are not render_grid_image's")
    del frames, g, loaded
    counts = {"fused_sh_fwd": fsm.fused_sh_fwd.launches, "fused_sh_bwd": fsm.fused_sh_bwd.launches,
              "tile_march_fwd": tm.tile_march_fwd.launches, "tile_march_bwd": tm.tile_march_bwd.launches}
    del saved, tree, model

    # (7) the grid -> octree -> grid round trip on the shell (svox2's to_svox1)
    with step_clock("to_octree of the 512^3 shell, then octree_to_grid", dev):
        grid = scene_sparse_grid(dev, shell=True)
        rt = gl.to_octree(grid)
        back = gl.octree_to_grid(rt, dilate=0)
    occ = grid.links.reshape(-1) >= 0
    rows, rows_back = grid.links.reshape(-1)[occ].long(), back.links.reshape(-1)[occ].long()
    dens = grid.density_data[rows]
    kept = dens[:, 0] > 0  # the bake keeps sigma > 0
    lost = int((rows_back[kept] < 0).sum())
    rb = rows_back[kept]
    d_err = float((back.density_data[rb] - dens[kept]).abs().max())
    s_err = float((back.sh_data[rb] - grid.sh_data[rows[kept]]).abs().max())
    log(f"{tag}: round trip: {int(occ.sum())} occupied cells ({int(kept.sum())} with density > 0), tree "
        f"{rt.n_nodes} nodes; lost {lost}; max |err| density {d_err:.3e}, SH {s_err:.3e}")
    if lost or d_err > 0 or s_err > 0:
        raise AssertionError(f"{tag}: the round trip lost {lost} cells, density off by {d_err}, SH by {s_err}")
    del grid, rt, back
    torch.cuda.empty_cache()
    log(f"{tag} on {card}: phase wall {time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return counts


def phase_plenoctree_on_a_run(dev, card: str) -> dict:
    """train_nerf_sh_cli's run in a temporary directory, then the
    plenoctree phase on it (as main runs them)."""
    with tempfile.TemporaryDirectory() as run:
        phase_train_nerf_sh_cli(dev, card, run_dir=run)
        return phase_plenoctree(dev, card, run)


# ---------------------------------------------------------------------------
# Data parallelism: the trainer's mesh routes, the sharded render and the
# row-sharded Plenoxels state (parallel/, train/nerf_trainer.py's mesh=)
# ---------------------------------------------------------------------------

DP_NCCL_STEPS = 20          # steps of each route with the one-rank NCCL group and without a group
DP_RANK_STEPS = 5           # steps of each route on the ranks that share the card
DP_LOSS_RTOL = 1e-5         # a step's loss on W ranks against one process on the same global batch
DP_NCCL_LOSS_RTOL = 1e-6    # the one-rank group's loss: its sum / global count against torch.mean
DP_RENDER_RAYS = 4096       # the sharded request
DP_RENDER_ATOL = 1e-6       # the sharded request against one process, where its bits differ
DP_PLENOXEL_STEPS = 3       # row-sharded touched steps at fog 256^3


def dp_trainer(mega: bool, dev, mesh=None, perturb: bool = True):
    """phase_train's flagship NeRFTrainer (96 + 192 samples, 8x256, bf16
    products), over ``mesh`` when given."""
    from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
    from nerf_projects_tpu_torch.train import NeRFTrainer

    cfg = NeRFRenderConfig(num_coarse_samples=COARSE, num_fine_samples=FINE, multires=10, multires_views=4,
                           use_viewdirs=True, white_bkgd=True, perturb=perturb, raw_noise_std=0.0,
                           resample_sorted=False)
    tr = NeRFTrainer(cfg, depth=8, width=256, near=2.0, far=6.0, lrate=5e-4, lrate_decay=250,
                     compute_dtype=torch.bfloat16, use_fused_mlp=True, use_mega=mega, mega_rc=MEGA_RC,
                     mega_rf=MEGA_RF, mesh=mesh, device=dev)
    if not (tr.use_fused_mlp and tr.use_mega == mega):
        raise AssertionError("parallel: a kernel gate refused the flagship configuration")
    return tr


def params_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for m in params:
        if m is not None:
            for v in m.state_dict().values():
                h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_counters():
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft
    from nerf_projects_tpu_torch.ops.kernels import tile_march as tm

    return {"fused_mlp_fwd": fm.fused_mlp_fwd, "fused_mlp_bwd": fm.fused_mlp_bwd,
            "fused_train_level": ft.fused_train_level, "tile_march_fwd": tm.tile_march_fwd,
            "tile_march_bwd": tm.tile_march_bwd}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_counters().items()}


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in set(total) | set(more)}


def grad_bounds(got, want) -> dict:
    """The worst relative Frobenius error and the worst entry's error over
    the largest entry, over every tensor of two (coarse, fine) gradient
    dicts."""
    worst = {"fro": 0.0, "max": 0.0}
    for gg, gw in zip(got, want):
        if gw is None:
            continue
        for name, w in gw.items():
            w, g = w.float().cpu(), gg[name].float().cpu()
            worst["fro"] = max(worst["fro"], float((g - w).norm() / w.norm().clamp_min(1e-30)))
            worst["max"] = max(worst["max"], float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))
    return worst


def parallel_rank() -> dict:
    """What each rank of the phase's group runs (in its own process, its
    group set up by parallel/launch.py): DP_RANK_STEPS scan_steps of the
    mega and the fused-MLP routes over the mesh, recording each step's
    parameters before it, its all-reduced gradients and a digest of the
    parameters after it; one DP_RENDER_RAYS request through
    render_rays_sharded; DP_PLENOXEL_STEPS touched steps on the fog
    256^3 state row-sharded over the ranks, held on each rank against the
    one-process step (this rank's rows) and the cells against the owners'
    masters. Returns the records and the kernels' launches on the mesh."""
    import torch.distributed as dist

    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.parallel import make_mesh
    from nerf_projects_tpu_torch.parallel.render import render_rays_sharded
    from nerf_projects_tpu_torch.train import PlenoxelsTrainer
    from nerf_projects_tpu_torch.train import plenoxels_sparse as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())  # the launcher's init_distributed made it current
    mesh = make_mesh()
    rank, world = dist.get_rank(), dist.get_world_size()
    ds = make_dataset(n_views=2, image_size=128, device=dev)
    out, counts = {"routes": {}}, {}
    for mega in (True, False):
        tr = dp_trainer(mega, dev, mesh)
        state = tr.init_state(SEED)
        steps, apply = [], tr.apply_grads

        def record(st, grads, apply=apply, steps=steps):
            before = [{k: v.detach().cpu().clone() for k, v in m.state_dict().items()} for m in st.params]
            g = [{k: v.detach().cpu().clone() for k, v in gm.items()} for gm in grads]
            st = apply(st, grads)
            steps.append({"params": before, "grads": g, "after": params_digest(st.params)})
            return st

        tr.apply_grads = record
        zero_counts()
        state, stats = tr.scan_steps(state, ds["rays"], ds["pixels"], DP_RANK_STEPS, batch_size=TRAIN_RAYS)
        counts = add_counts(counts, read_counts())
        out["routes"][mega] = {"steps": steps, "loss": stats["loss"].tolist()}

    serve = dp_trainer(False, dev, perturb=False)
    params = tuple(random_biases(m, torch.Generator().manual_seed(SEED + 40 + i))
                   for i, m in enumerate(serve.init_params(SEED)))
    rays = ds["rays"].map(lambda t: t[:DP_RENDER_RAYS])
    zero_counts()
    out["render"] = render_rays_sharded(mesh, lambda r: serve.render_step(params, r, use_kernel=True), rays)
    counts = add_counts(counts, read_counts())

    # the row-sharded touched step at fog 256^3 against the one-process step
    bg = train_grid(dev, "fog")
    nb = bg.n_bricks
    trainer = PlenoxelsTrainer(GridRenderOptions(step_size=0.5), n_iters=128_000, lambda_tv=1e-5,
                               lambda_tv_sh=1e-3, device=dev)
    rays = train_tile_rays(SEED + 2, TRAIN_SCENES["fog"][1], dev)
    target = torch.full(rays.origins.shape, TRAIN_TARGET, device=dev)
    one = ps.packed_state_from_grid(bg, bf16_cells=True)
    touched = ps._march(trainer, bg, one.cells, rays, target)[2]
    w_tv = max(int(trainer.tv_sparsity * nb), 1) + max(int(trainer.tv_sh_sparsity * nb), 1)
    K = -(-((int(touched.sum()) + 4 * w_tv) * 5 // 4) // 256) * 256  # as phase_train_plenoxels_sparse
    sharded = ps.shard_state_rows(one, mesh)
    gen = [torch.Generator(device=dev).manual_seed(SEED + 20 + i) for i in range(DP_PLENOXEL_STEPS)]
    want = []
    for i in range(DP_PLENOXEL_STEPS):
        one, st = ps.train_step_tiles_packed_touched(trainer, bg, one, rays, target, i, gen[i], max_touched=K)
        want.append(float(st["mse"]))
    gen = [torch.Generator(device=dev).manual_seed(SEED + 20 + i) for i in range(DP_PLENOXEL_STEPS)]
    got, overflow = [], []
    zero_counts()
    for i in range(DP_PLENOXEL_STEPS):
        sharded, st = ps.train_step_tiles_packed_touched(trainer, bg, sharded, rays, target, i, gen[i],
                                                         max_touched=K, mesh=mesh)
        got.append(float(st["mse"]))
        overflow.append(float(st["touched_overflow"]))
    torch.cuda.synchronize()
    counts = add_counts(counts, read_counts())
    per = sharded.packed_k.shape[0] - 1
    lo, hi = rank * per, min((rank + 1) * per, nb + 1)
    mine = sharded.packed_k[:hi - lo]
    close = {name: close_share(a, b) for name, a, b in (
        ("masters", mine, one.packed_k[lo:hi]), ("rms", sharded.rms[:hi - lo], one.rms[lo:hi]))}
    own_cells = bool(torch.equal(sharded.cells[lo:hi], mine.to(torch.bfloat16)))
    # every row's cells on every rank: per-row sums of the bf16 bits, gathered
    rowsum = sharded.cells.view(torch.int16).to(torch.int64).sum((1, 2))
    parts = [torch.empty_like(rowsum) for _ in range(world)]
    dist.all_gather(parts, rowsum)
    out["plenoxels"] = {
        "nb": nb, "K": K, "mse": got, "want_mse": want, "overflow": overflow, "close": close,
        "own_cells": own_cells, "cells_agree": all(torch.equal(parts[0], q) for q in parts[1:]),
        "bytes": ps.state_bytes(sharded), "one_bytes": ps.state_bytes(one)}
    out["counts"] = counts
    return out


def phase_parallel(dev, card: str) -> dict:
    """Data parallelism on the card: (a) a one-rank NCCL group in this
    process: DP_NCCL_STEPS steps of the mega route (K2) and of the
    fused-MLP route (K1f + K1b) through mesh= against the same steps
    without a group (the mega route the same bits; the fused-MLP route
    the same bits or its loss within DP_NCCL_LOSS_RTOL), step ms with and
    without the group, and a step of each under set_sync_debug_mode (no
    waits); (b) W ranks in processes of their own (parallel/launch.py):
    NCCL over every card when the machine has two or more, else two ranks
    that share card 0 over gloo (which copies through the host, so no
    wait check there): parallel_rank's steps against one process on the
    same global batches, perturb on (each step's loss within DP_LOSS_RTOL
    and its gradients by GRAD_FRO_TOL / GRAD_MAX_TOL, recomputed here at
    the step's parameters; the ranks' parameters the same bits after every
    step), K2 run with n_rays_total twice its rows; the sharded request
    against render_image in one process; the row-sharded touched steps
    (MSE, tests/test_sparse_step.py's share rule, each rank's cells equal
    to the owners' masters, the float32 bytes a rank holds beside one
    process's). Returns the kernels' launches on the mesh paths."""
    import torch.distributed as dist

    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.parallel import init_distributed, make_mesh
    from nerf_projects_tpu_torch.parallel.launch import run_ranks

    tag = "parallel"
    t_phase = time.perf_counter()
    ds = make_dataset(n_views=2, image_size=128, device=dev)
    counts = {}

    # (a) the one-rank NCCL group
    init_distributed("nccl", dev, rank=0, world_size=1)
    mesh = make_mesh()
    try:
        for mega, route in ((True, "mega (K2)"), (False, "fused MLP (K1f + K1b)")):
            runs = {}
            for name, m in (("no group", None), ("1-rank NCCL", mesh)):
                tr = dp_trainer(mega, dev, m)
                warm = tr.init_state(SEED)
                tr.scan_steps(warm, ds["rays"], ds["pixels"], 1, batch_size=TRAIN_RAYS)
                if m is not None:
                    check_waits(f"{tag}: (a) one {route} step on the 1-rank NCCL group",
                                lambda: tr.scan_steps(warm, ds["rays"], ds["pixels"], 1, batch_size=TRAIN_RAYS), 0)
                state = tr.init_state(SEED)
                zero_counts()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, stats = tr.scan_steps(state, ds["rays"], ds["pixels"], DP_NCCL_STEPS, batch_size=TRAIN_RAYS)
                end.record()
                end.synchronize()
                if m is not None:
                    counts = add_counts(counts, read_counts())
                runs[name] = (state, stats["loss"].cpu(), start.elapsed_time(end) / DP_NCCL_STEPS)
            (sa, la, ma), (sb, lb, mb) = runs["no group"], runs["1-rank NCCL"]
            same = all(torch.equal(x, y) for pa, pb in zip(sa.params, sb.params)
                       for x, y in zip(pa.state_dict().values(), pb.state_dict().values()))
            rel = float(((la - lb).abs() / la.abs()).max())
            log(f"{tag}: (a) {route} on {card}: {DP_NCCL_STEPS} steps of {TRAIN_RAYS} rays, step ms {ma:.4f} "
                f"without a group, {mb:.4f} on the 1-rank NCCL group; parameters after them the same bits: "
                f"{same}; losses the same bits: {torch.equal(la, lb)}, largest relative difference {rel:.3e} "
                f"(the group's loss is its sum of squared errors over the global count, not torch.mean)")
            if not same and not mega:
                # the fused-MLP route's gradients come through autograd of
                # sum / count instead of torch.mean: held by the bounds
                # at the seed's parameters
                g = []
                for m in (None, mesh):
                    tr = dp_trainer(False, dev, m)
                    st = tr.init_state(SEED)
                    g.append(tr._value_and_grad(st.params, st.generator, ds["rays"].map(lambda t: t[:TRAIN_RAYS]),
                                                ds["pixels"][:TRAIN_RAYS])[1])
                worst = grad_bounds(g[1], g[0])
                log(f"{tag}: (a) {route}: the parameters' bits moved; one step's gradients at the seed's "
                    f"parameters: worst relative Frobenius {worst['fro']:.3e} (tol {GRAD_FRO_TOL}), worst entry "
                    f"{worst['max']:.3e} of scale (tol {GRAD_MAX_TOL})")
                same = worst["fro"] < GRAD_FRO_TOL and worst["max"] < GRAD_MAX_TOL
            if not (same and rel <= DP_NCCL_LOSS_RTOL):
                raise AssertionError(f"{tag}: {route} on the 1-rank NCCL group is not the step without a group")
    finally:
        dist.destroy_process_group()

    # (b) W ranks
    n_cards = torch.cuda.device_count()
    backend, rank_dev, W = ("nccl", None, n_cards) if n_cards >= 2 else ("gloo", "cuda:0", 2)
    log(f"{tag}: (b) {W} ranks over {backend} "
        + ("on every card" if backend == "nccl" else "sharing card 0 (NCCL refuses two ranks on one card; gloo "
                                                     "copies each collective through the host, so these steps "
                                                     "are not held to the no-wait check)"))
    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:parallel_rank", W, backend=backend, device=rank_dev)
    log(f"{tag}: (b) the ranks ran in {time.perf_counter() - t0:.1f} s (start-up, builds and checks included)")
    for r in ranks:
        counts = add_counts(counts, r["counts"])

    names = None
    for mega, route in ((True, "mega (K2, n_rays_total = 2x its rows)"), (False, "fused MLP (K1f + K1b)")):
        recs = [r["routes"][mega] for r in ranks]
        for k in range(DP_RANK_STEPS):
            digests = {rec["steps"][k]["after"] for rec in recs}
            if len(digests) != 1:
                raise AssertionError(f"{tag}: {route}: the ranks' parameters differ after step {k}")
        one = dp_trainer(mega, dev)
        state = one.init_state(SEED)
        worst_loss, worst = 0.0, {"fro": 0.0, "max": 0.0}
        for k in range(DP_RANK_STEPS):
            step = recs[0]["steps"][k]
            with torch.no_grad():
                for m, sd in zip(state.params, step["params"]):
                    m.load_state_dict(sd)
            idx = torch.randint(0, ds["pixels"].shape[0], (TRAIN_RAYS,), generator=state.generator, device=dev)
            (loss, _), grads = one._value_and_grad(state.params, state.generator, ds["rays"].map(lambda t: t[idx]),
                                                   ds["pixels"][idx])
            worst_loss = max(worst_loss, abs(recs[0]["loss"][k] - float(loss)) / abs(float(loss)))
            b = grad_bounds(step["grads"], grads)
            worst = {key: max(worst[key], b[key]) for key in worst}
        log(f"{tag}: (b) {route}: {DP_RANK_STEPS} steps of {TRAIN_RAYS} rays on {W} ranks against one process on "
            f"the same global batches at each step's parameters: losses {np.round(recs[0]['loss'], 6).tolist()}, "
            f"largest relative difference {worst_loss:.3e} (tol {DP_LOSS_RTOL}); gradients worst relative "
            f"Frobenius {worst['fro']:.3e} (tol {GRAD_FRO_TOL}), worst entry {worst['max']:.3e} of scale "
            f"(tol {GRAD_MAX_TOL}); the ranks' parameters the same bits after every step")
        if not (worst_loss <= DP_LOSS_RTOL and worst["fro"] < GRAD_FRO_TOL and worst["max"] < GRAD_MAX_TOL):
            raise AssertionError(f"{tag}: {route} on {W} ranks is not one process's step")

    serve = dp_trainer(False, dev, perturb=False)
    params = tuple(random_biases(m, torch.Generator().manual_seed(SEED + 40 + i))
                   for i, m in enumerate(serve.init_params(SEED)))
    want = serve.render_image(params, ds["rays"].map(lambda t: t[:DP_RENDER_RAYS]), use_kernel=True)
    for r in ranks:
        got = r["render"]
        names = sorted(got)
        diff = max(float(np.abs(got[k] - want[k].cpu().numpy()).max()) for k in names)
        bits = all(np.array_equal(got[k], want[k].cpu().numpy()) for k in names)
        if not (bits or diff <= DP_RENDER_ATOL):
            raise AssertionError(f"{tag}: the sharded request is {diff:.3e} from one process's")
    log(f"{tag}: (b) one {DP_RENDER_RAYS}-ray request through render_rays_sharded on {W} ranks (K1f) against "
        f"render_image in one process: the same bits {bits} ({', '.join(names)}; max |err| {diff:.3e}"
        + ("" if bits else f"; the plain torch around K1f ran on {DP_RENDER_RAYS // W} rows a call, not "
                            f"{DP_RENDER_RAYS}, tolerance {DP_RENDER_ATOL}") + ")")

    p0 = ranks[0]["plenoxels"]
    rel = [abs(a - b) / abs(b) for a, b in zip(p0["mse"], p0["want_mse"])]
    shares = {k: min(r["plenoxels"]["close"][k] for r in ranks) for k in p0["close"]}
    log(f"{tag}: (b) the touched step at fog 256^3 ({p0['nb']} bricks, max_touched {p0['K']}) on {W} ranks, the "
        f"float32 state row-sharded: {DP_PLENOXEL_STEPS} steps against the one-process step: MSE "
        f"{np.round(p0['mse'], 7).tolist()}, relative differences " + ", ".join(f"{x:.3e}" for x in rel)
        + " (tolerances 1e-5, then 1e-4: K4's atomics); each rank's rows close: "
        + ", ".join(f"{k} {v:.6f}" for k, v in shares.items()) + f" (more than {SPARSE_FRAC} needed); cells equal "
        f"to the owners' masters on every rank: {all(r['plenoxels']['own_cells'] for r in ranks)}, the same on "
        f"every rank: {all(r['plenoxels']['cells_agree'] for r in ranks)}; float32 state bytes a rank "
        f"{[r['plenoxels']['bytes'] for r in ranks]} against {p0['one_bytes']} in one process")
    if not (rel[0] <= 1e-5 and all(x <= 1e-4 for x in rel[1:]) and min(shares.values()) > SPARSE_FRAC
            and all(r["plenoxels"]["own_cells"] and r["plenoxels"]["cells_agree"] for r in ranks)
            and max(max(r["plenoxels"]["overflow"]) for r in ranks) == 0
            and max(r["plenoxels"]["bytes"] for r in ranks) < 0.55 * p0["one_bytes"]):
        raise AssertionError(f"{tag}: the row-sharded touched step disagrees with the one-process step")
    need = ("fused_mlp_fwd", "fused_mlp_bwd", "fused_train_level", "tile_march_fwd", "tile_march_bwd")
    if any(counts.get(k, 0) <= 0 for k in need):
        raise AssertionError(f"{tag}: a kernel of the mesh paths never launched: {counts}")
    log(f"{tag} on {card}: phase wall {time.perf_counter() - t_phase:.1f} s; launches on the mesh paths {counts}")
    return counts


def host_peak_gb() -> float:
    """This process's peak resident memory (ru_maxrss), GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


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
    profile_train_split(dev)
    kernels[0]["launches"] = phase_render(dev)
    launches = phase_train(dev, card)
    for entry in kernels[1:]:
        entry["launches"] = launches[entry["name"]]
    raw_fwd, raw_bwd = phase_kernel_raw(dev, serve_rows=PATCH * PATCH * (64 + 128),
                                        train_rows=TRAIN_RAYS * (COARSE + FINE))
    raw_fwd["launches"] = phase_render_raw(dev, card)
    raw_counts = phase_train_raw(dev, card)
    raw_fwd["launches"] += raw_counts["fused_mlp_raw_fwd"]
    raw_bwd["launches"] = raw_counts["fused_mlp_raw_bwd"]
    march = phase_kernel_march(dev)
    frame_launches = phase_render_plenoxels(dev, card)
    phase_render_plenoxels_eval(dev, card)
    march_bwd = phase_kernel_march_bwd(dev)
    train_launches = phase_train_plenoxels(dev, card)
    sparse_launches, cli_launches, _ = phase_train_plenoxels_sparse(dev, card)
    phase_train_plenoxels_bg(dev, card)
    for k, shapes in sparse_launches.items():
        for shape, n in shapes.items():
            train_launches[k][shape] = train_launches[k].get(shape, 0) + n
    march["launches"] = (sum(frame_launches.values()) + sum(train_launches["tile_march_fwd"].values())
                         + cli_launches["tile_march_fwd"])
    march_bwd["launches"] = sum(train_launches["tile_march_bwd"].values()) + cli_launches["tile_march_bwd"]
    kernels += [march, march_bwd]
    sh_fwd, sh_bwd = phase_kernel_sh(dev)
    sh_serve = phase_render_nerf_sh(dev, card)
    sh_counts = phase_train_nerf_sh(dev, card)
    sh_fwd["launches"] = sh_serve + sh_counts["fused_sh_fwd"]
    sh_bwd["launches"] = sh_counts["fused_sh_bwd"]
    loop_counts = phase_train_nerf_loop(dev, card)
    with tempfile.TemporaryDirectory() as sh_run:  # the NeRF-SH run, kept for the PlenOctree phase
        cli_counts = phase_train_nerf_sh_cli(dev, card, run_dir=sh_run)
        octree_counts = phase_plenoctree(dev, card, sh_run)
    kernels += [sh_fwd, sh_bwd, raw_fwd, raw_bwd]

    def levels(serving, training):  # each request or step launches a coarse and a fine level
        out = {f"serving {lv}": serving / 2 for lv in ("coarse", "fine") if serving}
        out.update({f"training {lv}": training / 2 for lv in ("coarse", "fine") if training})
        return out

    rule2({
        "fused_mlp_fwd": levels(kernels[0]["launches"], launches["fused_mlp_fwd"]),
        "fused_mlp_bwd": levels(0, kernels[1]["launches"]),
        "fused_train_level": {"training step": kernels[2]["launches"] / 2,
                              "loop step": loop_counts["fused_train_level"] / 2},
        "tile_march_fwd": {**frame_launches, **train_launches["tile_march_fwd"]},
        "tile_march_bwd": train_launches["tile_march_bwd"],
        "fused_sh_fwd": levels(sh_serve, sh_counts["fused_sh_fwd"]),
        "fused_sh_bwd": levels(0, sh_bwd["launches"]),
        "fused_mlp_raw_fwd": levels(raw_fwd["launches"] - raw_counts["fused_mlp_raw_fwd"],
                                    raw_counts["fused_mlp_raw_fwd"]),
        "fused_mlp_raw_bwd": levels(0, raw_bwd["launches"]),
    })
    # the loop's, the NeRF-SH CLI's and the PlenOctree pipeline's launches
    # join the kernels line (rule 2 above reads K2's loop launches at the
    # loop's levels; the CLIs' K5 launches mix training steps, renders and
    # extraction, and the pipeline's K3 / K4 launches finetuning's batches,
    # so they stay out of it)
    kernels[2]["launches"] += loop_counts["fused_train_level"]
    sh_fwd["launches"] += cli_counts["fused_sh_fwd"] + octree_counts["fused_sh_fwd"]
    sh_bwd["launches"] += cli_counts["fused_sh_bwd"] + octree_counts["fused_sh_bwd"]
    march["launches"] += octree_counts["tile_march_fwd"]
    march_bwd["launches"] += octree_counts["tile_march_bwd"]
    # the mesh paths (the one-rank NCCL group and the ranks' processes)
    dp = phase_parallel(dev, card)
    for entry, name in ((kernels[0], "fused_mlp_fwd"), (kernels[1], "fused_mlp_bwd"),
                        (kernels[2], "fused_train_level"), (march, "tile_march_fwd"), (march_bwd, "tile_march_bwd")):
        entry["launches"] += dp[name]
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
