"""Environment smoke test (port of ``nerf_projects_tpu/cli/check_env.py``).

Parity target: reference plenoctree/test_gpu_comprehensive.py:1-395 —
verify every stack layer with a tiny real computation: device presence,
the kernel toolchain, the render pipeline, grid and octree renderers,
native C++ ops, and optional deps. Prints a pass/fail table and exits
nonzero on failure.

The JAX package's first two rows check JAX's devices and a jitted matmul;
here they check the port's toolchain. "cuda devices" lists the cards;
without one, and without ``--device cpu``, it fails and so does the run:
nothing carries on on the host. "kernel build" finds nvcc, builds the
fused-MLP forward (K1f, ``csrc/fused_mlp_fwd.cu``) for sm_90a if no
library of its sources is built yet, launches it once on KERNEL_ROWS
seeded rows of the 8x256 MLP and holds it against its plain version;
on the host it runs only the plain version. The render rows run on the
chosen device. "native C++ ops" builds ``csrc/native_ops.cpp`` with g++
and runs it; there is no fallback to report.

    python -m nerf_projects_tpu_torch.cli.check_env [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

KERNEL_ROWS = 4096
KERNEL_TOL = 1e-2  # max |err| / (mean |plain| + 1), as chip_smoke.py holds K1f
BIAS_STD = 0.2     # random biases, so that the check sees where the kernel reads each one


def check(name, fn, results):
    t0 = time.time()
    try:
        detail = fn()
        results.append({"check": name, "ok": True,
                        "detail": detail, "sec": round(time.time() - t0, 2)})
    except Exception as e:  # noqa: BLE001
        results.append({"check": name, "ok": False,
                        "detail": f"{type(e).__name__}: {e}",
                        "sec": round(time.time() - t0, 2)})


def main(argv=None):
    p = argparse.ArgumentParser(description="environment smoke test")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)
    results = []

    def devices():
        import torch

        from nerf_projects_tpu_torch.core.device import resolve_device

        dev = resolve_device(args.device)
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        return f"{dev}; cuda devices {names}"

    check("cuda devices", devices, results)

    def kernel():
        import torch

        from nerf_projects_tpu_torch.core.device import resolve_device
        from nerf_projects_tpu_torch.models.nerf import NeRFMLP
        from nerf_projects_tpu_torch.ops.kernels import _build
        from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

        dev = resolve_device(args.device)
        gen = torch.Generator().manual_seed(0)
        model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
        with torch.no_grad():
            for name, prm in model.named_parameters():
                if name.endswith("bias"):
                    prm.copy_(torch.randn(prm.shape, generator=gen) * BIAS_STD)
        model = model.to(dev)
        x = torch.zeros(KERNEL_ROWS, 64)
        x[:, :63] = torch.randn(KERNEL_ROWS, 63, generator=gen)
        v = torch.zeros(KERNEL_ROWS, 32)
        v[:, :27] = torch.randn(KERNEL_ROWS, 27, generator=gen)
        x, v = x.to(dev), v.to(dev)
        W = fm.pack_params(model)
        want = fm.fused_nerf_mlp_reference(W, x, v)
        if dev.type != "cuda":
            if not bool(torch.isfinite(want).all()):
                raise AssertionError("K1f's plain version is not finite")
            return f"plain (host): K1f's plain version on {KERNEL_ROWS} rows, finite"
        nvcc = _build.find_nvcc()
        release = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60,
                                 check=True).stdout.strip().splitlines()[-1]
        built = _build.build("fused_mlp_fwd")
        before = fm.fused_mlp_fwd.launches
        got = fm.fused_mlp_fwd(fm.forward_weights(model, raw=False), x, v)
        launches = fm.fused_mlp_fwd.launches - before
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().mean()) + 1.0)
        detail = (f"{nvcc} ({release}); {built.path.name} built in {built.seconds:.1f} s (0: already built); "
                  f"K1f launches {launches}; max_abs_err {err:.3e}; err/(mean|plain|+1) {rel:.3e} "
                  f"(tolerance {KERNEL_TOL})")
        if launches != 1 or not bool(torch.isfinite(got).all()) or not rel < KERNEL_TOL:
            raise AssertionError(detail)
        return detail

    check("kernel build", kernel, results)

    def render():
        import torch

        from nerf_projects_tpu_torch.core.device import resolve_device
        from nerf_projects_tpu_torch.core.rays import Rays
        from nerf_projects_tpu_torch.models.nerf import NeRFMLP
        from nerf_projects_tpu_torch.models.pipeline import (
            NeRFRenderConfig,
            render_rays,
        )
        from nerf_projects_tpu_torch.ops.posenc import posenc_dim

        dev = resolve_device(args.device)
        cfg = NeRFRenderConfig(num_coarse_samples=8, num_fine_samples=0,
                               multires=4, use_viewdirs=False)
        m = NeRFMLP(depth=2, width=32, use_viewdirs=False, in_ch=posenc_dim(3, 4))
        m = m.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
        d = torch.tensor([[0.0, 0.0, 1.0]], device=dev)
        out = render_rays(None, m, None, lambda mm, x, vv=None: mm(x, vv),
                          Rays(torch.zeros((1, 3), device=dev), d, d), 2.0, 6.0, cfg,
                          randomized=False)
        assert bool(torch.isfinite(out["rgb"]).all())
        return "rgb finite"

    check("nerf pipeline", render, results)

    def grid():
        import torch

        from nerf_projects_tpu_torch.core.device import resolve_device
        from nerf_projects_tpu_torch.core.rays import Rays
        from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
        from nerf_projects_tpu_torch.ops.grid import (
            GridRenderOptions,
            volume_render_grid,
        )

        dev = resolve_device(args.device)
        g = SparseGrid.create(8, basis_dim=1, device=dev)
        d = torch.tensor([[0.0, 0.0, 1.0]], device=dev)
        out = volume_render_grid(
            g, Rays(torch.tensor([[0.0, 0.0, -3.0]], device=dev), d, d), GridRenderOptions()
        )
        return f"acc={float(out['acc'][0]):.3f}"

    check("sparse grid render", grid, results)

    def octree():
        import torch

        from nerf_projects_tpu_torch.core.device import resolve_device
        from nerf_projects_tpu_torch.core.rays import Rays
        from nerf_projects_tpu_torch.models.octree import PlenOctree
        from nerf_projects_tpu_torch.ops.octree_render import (
            OctreeRenderOptions,
            volume_render_octree,
        )

        dev = resolve_device(args.device)
        t = PlenOctree.create(4, device=dev).refine()
        d = torch.tensor([[0.0, 0.0, 1.0]], device=dev)
        volume_render_octree(
            t, Rays(torch.tensor([[0.0, 0.0, -2.0]], device=dev), d, d),
            OctreeRenderOptions(step_size=0.05),
        )
        return "ok"

    check("octree render", octree, results)

    def native():
        import numpy as np

        from nerf_projects_tpu_torch.utils import native as nat

        links = np.arange(8, dtype=np.int32).reshape(2, 2, 2)
        nbr = nat.build_neighbor_links(links, 8)
        assert nbr[0].tolist() == [4, 2, 1], nbr[0]
        return "compiled"

    check("native C++ ops", native, results)

    def deps():
        mods = []
        for m in ("imageio", "cv2", "scipy", "psutil", "matplotlib", "yaml"):
            try:
                __import__(m)
                mods.append(m)
            except ImportError:
                pass
        return ",".join(mods)

    check("optional deps", deps, results)

    ok = all(r["ok"] for r in results)
    for r in results:
        mark = "PASS" if r["ok"] else "FAIL"
        print(f"[{mark}] {r['check']:22s} {r['detail']} ({r['sec']}s)")
    print(json.dumps({"all_ok": ok}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
