#!/usr/bin/env python3
"""Diagnostic probes of the NeRF MLP kernels on one CUDA card, beside
chip_smoke.py. Run from the root of a checkout (which may be another
tree than this file's: its chip_smoke.py and package are the ones used):

    python3 /path/to/chip_probes.py f64   # K1rb's float64-sums rule, per draw
    python3 /path/to/chip_probes.py route [tag [rays [draws]]]  # K1b's and K1rb's rule under the route's own g
    python3 /path/to/chip_probes.py k2    # K2's fine level timed around other work
    python3 /path/to/chip_probes.py sh [draws]  # K5b's float64-sums rule per draw and row count
    python3 /path/to/chip_probes.py k2f64 [draws]  # K2's float64-sums rule per draw of a coarse level

f64: K1rb's gradients against the plain version with float64 sums, as
chip_smoke.check_grads reads the rule (the kernel's relative Frobenius
distance over the float32 plain version's, per gradient tensor), at five
row counts with g random in all eight columns ("all8") or in the route's
four live ones ("live"); the six worst tensors of each draw. Run in a
tree with a kernel changed (chip_mutants.py's copies) to see whether the
rule tells the two apart.

route: the same rule for K1b and K1rb with g the route's own output
gradient (chip_smoke.route_grad: a seeded training coarse level of
`rays` rays, 128 by default, the compositing's and the MSE loss's
gradient at the plain forward's outputs), at `draws` (6) draws of the
level and of the weights; per draw the six worst tensors, with the
kernel's and the float32 plain version's relative distances from the
float64 sums for the worst.

k2: K2's fine level (S 288, R 4, 1,024 rays) timed 3 x 10 launches with
CUDA events, fresh, after chip_smoke.phase_kernel and after 5 s idle,
each beside the card's SM clock, temperature and power.

sh: K5b's float64-sums rule (as chip_smoke.check_grads reads it) at
each head width (27, 48, 75, 128 columns) and at 100, 128, 1,000, 8,193
and 8,229 rows, `draws` (3) draws of weights and inputs each: the
kernel's reading and its worst tensor, the kernel's and the float32
plain version's relative distances from the float64 sums for that
tensor, and the reading of the plain version with another float32 order
(partial_sums) on the same inputs.

k2f64: K2's float64-sums rule (as chip_smoke.check_grads reads it) at
the coarse level that chip_smoke.phase_kernel_train holds against
float64 sums (S 96, R 8, with chip_smoke.level_batch's inputs and that
phase's model), at 128 and 1,024 rays, `draws` (16) seeded draws of the
inputs: per draw the three worst tensors, each with the kernel's and
the float32 plain version's relative distances from the float64 sums.
"""
from __future__ import annotations

import subprocess
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def model_on(dev, seed: int):
    from nerf_projects_tpu_torch.models.nerf import NeRFMLP

    gen = torch.Generator().manual_seed(seed)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    return c.random_biases(model, gen).to(dev), gen


def probe_f64(dev, tag: str) -> None:
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    model, gen = model_on(dev, c.SEED + 30)
    W = fm.pack_params(model, raw_layout=True)
    wk, wkt = fm.backward_weights(model, True, fm.forward_weights(model, raw=True))
    for n in (8192 + 37, 128 * 96, 16385, 65536, 294912):
        p, v = c.raw_inputs(n, gen, dev)
        for kind in ("all8", "live"):
            g = (torch.randn(n, 8, generator=gen) * 1e-3).to(dev)
            if kind == "live":
                g[:, 3] = 0
                g[:, 5:] = 0
            got = fm.fused_mlp_raw_bwd(wk, wkt, p, v, g)
            want = fm.fused_mlp_raw_bwd_reference(W, p, v, g)
            with fm.float64_sums():
                exact = fm.fused_mlp_raw_bwd_reference(W, p, v, g)
            rs = []
            for name, a, b, e in zip(fm.FusedMLPWeights._fields, got, want, exact):
                e = e.double()
                en = e.norm() + 1e-30
                r = float((a.double() - e).norm() / en) / (float((b.double() - e).norm() / en) + 1e-5)
                rs.append((r, name))
            rs.sort(reverse=True)
            print("f64", tag, n, kind, " ".join(f"{nm}={r:.3f}" for r, nm in rs[:6]), flush=True)


def probe_route(dev, tag: str, n_rays: int, draws: int) -> None:
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    for raw, name, launch, ref in ((False, "K1b", fm.fused_mlp_bwd, fm.fused_mlp_bwd_reference),
                                   (True, "K1rb", fm.fused_mlp_raw_bwd, fm.fused_mlp_raw_bwd_reference)):
        for draw in range(draws):
            model, gen = model_on(dev, c.SEED + 40 + draw)
            W = fm.pack_params(model, raw_layout=raw)
            wk, wkt = fm.backward_weights(model, raw, fm.forward_weights(model, raw=raw))
            x, v, g = c.route_grad(gen, W, dev, raw, n_rays=n_rays)
            got, want = launch(wk, wkt, x, v, g), ref(W, x, v, g)
            with fm.float64_sums():
                exact = ref(W, x, v, g)
            rs = []
            for field, a, b, e in zip(fm.FusedMLPWeights._fields, got, want, exact):
                e = e.double()
                en = e.norm() + 1e-30
                ka, pb = float((a.double() - e).norm() / en), float((b.double() - e).norm() / en)
                rs.append((ka / (pb + 1e-5), field, ka, pb))
            rs.sort(reverse=True)
            print("route", tag, n_rays, name, draw, " ".join(f"{f}={r:.3f}" for r, f, _, _ in rs[:6]),
                  f"(worst: kernel {rs[0][2]:.3e}, plain {rs[0][3]:.3e})", flush=True)


def probe_k2(dev) -> None:
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft

    model, gen = model_on(dev, 3)
    x, vt = c.level_batch(gen, 1024, 288, 4, dev, True)
    wk, wkt = fm.kernel_weights_sm90(model, raw_layout=True), fm.kernel_weights_sm90_bwd(model)
    kw = dict(S=288, R=4, n_rays_total=1024, bkgd=1.0, want_weights=False, raw_inputs=True)

    def k2(tag):
        q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
        print("smi", tag, q, flush=True)
        times = [c.time_ms(lambda: ft.fused_train_level(wk, wkt, x, vt, **kw), iters=10) for _ in range(3)]
        print("k2", tag, ["%.4f" % t for t in times], flush=True)

    k2("fresh")
    c.phase_kernel(dev, 786432)
    k2("after phase_kernel")
    torch.cuda.synchronize()
    time.sleep(5)
    k2("after 5 s idle")


class partial_sums:
    """Within the block, fused_mlp's products (_mm, _mmBT) sum their
    float32 products in 64-deep partials added in turn, as the kernels'
    promoted products do: a plain version with another float32 order."""

    def __enter__(self):
        from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

        self.saved = fm._mm, fm._mmBT

        def mm(a, w):
            a = a.to(torch.bfloat16).float()
            return sum(a[:, k: k + 64] @ w[k: k + 64].float() for k in range(0, a.shape[1], 64))

        fm._mm, fm._mmBT = mm, lambda g, w: mm(g, w.T)
        return self

    def __exit__(self, *exc):
        from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

        fm._mm, fm._mmBT = self.saved


def probe_sh(dev, draws: int) -> None:
    from nerf_projects_tpu_torch.models.nerf_sh import CondMLP
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp as fsm

    gen = torch.Generator().manual_seed(c.SEED + 31)
    names = fsm.FusedSHWeights._fields
    for num_rgb in (27, 48, 75, 128):
        for draw in range(draws):
            mlp = c.random_biases(CondMLP(num_rgb_channels=num_rgb).reset_parameters(gen), gen).to(dev)
            W = fsm.pack_sh_params(mlp)
            wk, wkt = fsm.backward_weights(mlp, fsm.forward_weights(mlp))
            for n in (100, 128, 1000, 8192 + 1, 8192 + 37):
                x = c.sh_points(n, gen, dev)
                g_rgb = (torch.randn(n, num_rgb, generator=gen) * 1e-3).to(dev)
                g_sig = (torch.randn(n, 1, generator=gen) * 1e-3).to(dev)
                got = fsm.fused_sh_bwd(wk, wkt, x, g_rgb, g_sig)
                want = fsm.fused_sh_bwd_reference(W, x, g_rgb, g_sig)
                with fm.float64_sums():
                    exact = fsm.fused_sh_bwd_reference(W, x, g_rgb, g_sig)
                with partial_sums():
                    other = fsm.fused_sh_bwd_reference(W, x, g_rgb, g_sig)
                ratio, i = c.noise_ratio(got, want, exact)
                ctl, k = c.noise_ratio(other, want, exact)
                e = exact[i].double()
                dist = [float((t[i].double() - e).norm() / (e.norm() + 1e-30)) for t in (got, want)]
                print(f"sh num_rgb={num_rgb} draw {draw} n={n}: kernel {ratio:.3f}x ({names[i]}: kernel "
                      f"{dist[0]:.3e}, float32 plain {dist[1]:.3e} from float64), plain with 64-deep partial "
                      f"sums {ctl:.3f}x ({names[k]})", flush=True)


def probe_k2_f64(dev, draws: int) -> None:
    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_projects_tpu_torch.ops.kernels import fused_train as ft

    model, _ = model_on(dev, c.SEED + 3)
    wkt = fm.kernel_weights_sm90_bwd(model)
    wk, W = fm.kernel_weights_sm90(model, raw_layout=True), fm.pack_params(model, raw_layout=True)
    for draw in range(draws):
        gen = torch.Generator().manual_seed(100 + draw)
        for n in (128, 1024):
            x, vt = c.level_batch(gen, n, c.COARSE, c.MEGA_RC, dev, raw=True)
            kw = dict(S=c.COARSE, R=c.MEGA_RC, n_rays_total=n, bkgd=1.0, want_weights=False, raw_inputs=True)
            got = ft.fused_train_level(wk, wkt, x, vt, **kw)[3]
            want = ft.fused_train_level_reference(W, x, vt, **kw)[3]
            with fm.float64_sums():
                exact = ft.fused_train_level_reference(W, x, vt, **kw)[3]
            rs = []
            for field, a, b, e in zip(fm.FusedMLPWeights._fields, got, want, exact):
                e = e.double()
                en = e.norm() + 1e-30
                ka, pb = float((a.double() - e).norm() / en), float((b.double() - e).norm() / en)
                rs.append((ka / (pb + 1e-5), field, ka, pb))
            rs.sort(reverse=True)
            print("k2f64", draw, n, " ".join(f"{f}={r:.3f} (kernel {ka:.2e}, plain {pb:.2e})"
                                            for r, f, ka, pb in rs[:3]), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    c.phase_build()
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "f64":
        probe_f64(dev, sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif what == "route":
        probe_route(dev, sys.argv[2] if len(sys.argv) > 2 else "tree",
                    int(sys.argv[3]) if len(sys.argv) > 3 else 128, int(sys.argv[4]) if len(sys.argv) > 4 else 6)
    elif what == "k2":
        probe_k2(dev)
    elif what == "sh":
        probe_sh(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    elif what == "k2f64":
        probe_k2_f64(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 16)
    else:
        print("usage: chip_probes.py f64 [tag] | route [tag [rays [draws]]] | k2 | sh [draws] | k2f64 [draws]",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
