#!/usr/bin/env python3
"""Drive the PyTorch port's vanilla-NeRF serving path on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

  build   nvcc compiles every CUDA kernel of the path for sm_90a.
  kernel  each kernel against its plain PyTorch version on the card, on
          a ragged 8192 + 37 rows and at the fine level's 786,432 rows,
          then both timed with CUDA events at the fine level's shape.
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

Output: progress lines, a `{"kernels": [...]}` JSON line, the card's
name and power limit as nvidia-smi gives them, and last
`{"ok": true, "device": {...}}`. Without a card it exits non-zero and
prints no result. A watchdog ends the process if it runs past
WATCHDOG_S seconds.
"""
from __future__ import annotations

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


def phase_build():
    from nerf_projects_tpu_torch.ops.kernels import _build

    b = _build.build("fused_mlp_fwd")
    log(f"build: fused_mlp_fwd {b.seconds:.1f} s -> {b.path.name}")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return b.seconds


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
        outs.append(trainer.render_image(params, rays, chunk=n_rays))
        torch.cuda.synchronize()
        log(f"render: first request at theta {REQUESTS[len(outs) - 1][0]}: {time.perf_counter() - t0:.6f} s")
    secs = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < WINDOW_S:
        t0 = time.perf_counter()
        trainer.render_image(params, requests[len(secs) % len(requests)], chunk=n_rays)
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
    entry = phase_kernel(dev, fine_rows=PATCH * PATCH * (64 + 128))
    entry["launches"] = phase_render(dev)
    log(f"chip_smoke: wall {time.perf_counter() - t0:.1f} s, build {build_s:.1f} s")
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
