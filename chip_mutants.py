#!/usr/bin/env python3
"""Mutation check of the kernels on one CUDA card.

Copies the package and chip_smoke.py to a temporary directory, breaks
one line of a CUDA source (or of the Python that packs a kernel's
weights) there, and runs the chip_smoke.py phases that run the broken
code (the kernel phases of K1f, K1b, K2, K3, K4, K5 and K1r, the encoded
render, the raw-points training step) on the copy; each must fail. K3's
mutants include its empty-space skip (the reach rule without the
upper-neighbour bricks) and its cache of a brick's link rows (kept when
the lower corner crosses into another brick along y or z), both shared
with K4 and run by both phases; K4's include its suffix term, its stop with
sparsity on, a ray's last run of a corner slot dropped, a run's colour
sums not reset when the slot's cell changes, its SH row's scalar tail
dropped and its touched-brick flags never set (the row-sparse steps'
phase, train_plenoxels_sparse); the render CLI's fast route's top-K
keeping the smallest weights (plain torch, ops/grid.py; the
render_plenoxels_eval phase); the training loop's checkpoint restore
without Adam's state and the NeRF-SH evaluate scoring every view against
view 0 (plain torch; the train_nerf_loop and train_nerf_sh_cli phases);
the PlenOctree march's early stop dropping a ray's last active sample and
extraction keeping a leaf's first sample's sigma instead of the mean
(plain torch; the plenoctree phase, on a fresh train_nerf_sh_cli run);
the NeRF trainer's mesh route handing K2 the shard's ray count as
n_rays_total and the row-sharded Plenoxels step skipping the all_gather
of its rewritten cell rows (the parallel phase: two ranks on the card);
the wgmma core's (mlp_sm90.cuh: K1f, K1b, K1rf, K1rb, K2, K5f
and K5b) include the concat, the relu mask, the stage ring, the dW jobs
(K1's and K5b's), the view encoder, the encoding stash, K1rb's, K1b's and
K5b's forwards without their per-slab promotion, K1f handed the raw
layout's buffer, K5f's two heads, K5b's dX heads' product without its
sigma fragment and its coefficient head's dW cut to 4 columns; K5b's
split-K reduce (fused_sh_bwd.cu). Run from the repository root (a pattern runs only the mutants whose
label contains it):

    python3 chip_mutants.py [pattern]

Prints one line per (mutant, phase): CAUGHT or SURVIVED, with the check's
message; exits 1 if a mutant survived a phase it should fail.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

# label: (file, original text, mutant text, phases that must fail); the
# phases are those that run the mutated line
MUTANTS = {
    "w5's h rows read a3 instead of a4 in the wgmma core's dW jobs (K1's and K5b's)": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "const int feats[5] = {A_X, A_TRUNK + 4 * 256, A_TRUNK + 4 * 256 + 64, A_TRUNK + 4 * 256 + 128, "
        "A_TRUNK + 4 * 256 + 192};",
        "const int feats[5] = {A_X, A_TRUNK + 3 * 256, A_TRUNK + 3 * 256 + 64, A_TRUNK + 3 * 256 + 128, "
        "A_TRUNK + 3 * 256 + 192};",
        ("kernel_raw", "fused_train_level", "fused_mlp_bwd", "kernel_sh"),
    ),
    "trunk_5's x columns dropped from the [x | h4] concat in the wgmma core": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "return kb < 4 ? xf(kb) : frag_of(a, kb - 4);",
        "return kb < 4 ? Frag{{0u, 0u, 0u, 0u}} : frag_of(a, kb - 4);",
        ("kernel_raw", "fused_train_level", "fused_mlp_bwd", "kernel_sh"),
    ),
    "the dX relu mask taken from the layer above in the wgmma core": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "grad(mlp::A_TRUNK + l * 256), ring, j);",
        "grad(mlp::A_TRUNK + (l + 1) * 256), ring, j);",
        ("kernel_raw", "fused_train_level", "fused_mlp_bwd", "kernel_sh"),
    ),
    "the NeRF-SH dX heads' product without its sigma fragment in the wgmma core": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "a[34] = a[35] = 0u;",
        "a[32] = a[33] = a[34] = a[35] = 0u;",
        ("kernel_sh",),
    ),
    "K5b's coefficient-head dW job cut to its first 4 live columns in the wgmma core": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "sh::GWRGB, sh::G_RGB, 256, 128, 0, (num_rgb + 1) / 2 * 2, 128);",
        "sh::GWRGB, sh::G_RGB, 256, 128, 0, 4, 128);",
        ("kernel_sh",),
    ),
    "K5b's recomputed forward without its per-slab promotion": (
        "nerf_projects_tpu_torch/csrc/fused_sh_bwd.cu",
        "sm90::launch_forward<sm90::IN_SH, true>(",
        "sm90::launch_forward<sm90::IN_SH, false>(",
        ("kernel_sh",),
    ),
    "K1rb's recomputed forward without its per-slab promotion": (
        "nerf_projects_tpu_torch/csrc/fused_mlp_raw_bwd.cu",
        "sm90::launch_forward<sm90::IN_TRAIN_RAW, true>(",
        "sm90::launch_forward<sm90::IN_TRAIN_RAW, false>(",
        ("kernel_raw",),
    ),
    "K1b's recomputed forward without its per-slab promotion": (
        "nerf_projects_tpu_torch/csrc/fused_mlp_bwd.cu",
        "sm90::launch_forward<sm90::IN_ENCODED, true>(",
        "sm90::launch_forward<sm90::IN_ENCODED, false>(",
        ("fused_mlp_bwd", "kernel_raw"),
    ),
    "K1f handed the raw layout's buffer by the encoded route": (
        "nerf_projects_tpu_torch/ops/kernels/fused_mlp.py",
        "return kernel_weights_sm90(model, raw_layout=raw)",
        "return kernel_weights_sm90(model, raw_layout=True)",
        ("kernel", "render"),
    ),
    "the second K-slab of every layer skipped by the wgmma core's stage ring": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "if (s * KD + kk * 16 < K) fr[kk] = af(s * KB + kk);",
        "if (s * KD + kk * 16 < K) fr[kk] = s == 1 ? Frag{{0u, 0u, 0u, 0u}} : af(s * KB + kk);",
        ("kernel_raw", "fused_train_level", "fused_mlp_bwd", "kernel_sh"),
    ),
    "inclusive instead of exclusive transmittance in the composite": (
        "nerf_projects_tpu_torch/csrc/fused_train.cu",
        "const float logT = carry + excl;",
        "const float logT = carry + incl;",
        ("fused_train_level",),
    ),
    "inclusive instead of exclusive transmittance in the tile march": (
        "nerf_projects_tpu_torch/csrc/tile_march_fwd.cu",
        "const float w = T * (1.f - expf(-tau));\n      rgb0 += w * c0;",
        "const float w = expf(-(cum + tau)) * (1.f - expf(-tau));\n      rgb0 += w * c0;",
        ("tile_march_fwd",),
    ),
    "the tile march's reach rule without the upper-neighbour bricks": (
        "nerf_projects_tpu_torch/csrc/tile_march.cuh",
        "any |= nb[c] >= 0;",
        "any |= nb[0] >= 0;",
        ("tile_march_fwd", "tile_march_bwd"),
    ),
    "the tile march's cached link rows kept when the lower corner crosses into another brick along y or z": (
        "nerf_projects_tpu_torch/csrc/tile_march.cuh",
        "if ((lx >> 3) != s.bx || (ly >> 3) != s.by || (lz >> 3) != s.bz) {",
        "if ((lx >> 3) != s.bx) {",
        ("tile_march_fwd", "tile_march_bwd"),
    ),
    "y and z taps swapped in the tile march's cell offset": (
        "nerf_projects_tpu_torch/csrc/tile_march.cuh",
        "((cx & 7) * 64 + (cy & 7) * 8 + (cz & 7))",
        "((cx & 7) * 64 + (cz & 7) * 8 + (cy & 7))",
        ("tile_march_fwd", "tile_march_bwd"),
    ),
    "the suffix term dropped from dL/dtau in the march backward": (
        "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "const float gtau = T * e * cdotg - (s_total - P);",
        "const float gtau = T * e * cdotg;",
        ("tile_march_bwd",),
    ),
    "the march backward stops at the first inactive sample with sparsity on": (
        "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "if (!active && p.sparsity_scale == 0.f) break;",
        "if (!active) break;",
        ("tile_march_bwd",),
    ),
    "the march backward drops a ray's last run of each corner slot": (
        "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "  flush<B, SCATTER>(p, acc, basis, probe);  // the ray's last run",
        "  // the ray's last run dropped",
        ("tile_march_bwd",),
    ),
    "the march backward's colour sums not reset when a slot's cell changes": (
        "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "acc.gd = acc.g0 = acc.g1 = acc.g2 = 0.f;",
        "acc.gd = 0.f;",
        ("tile_march_bwd",),
    ),
    "the march backward's SH row without its scalar tail after the float4 adds": (
        "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "for (int j = HEAD + BODY; j < N; ++j) add<SCATTER>(dst + j, v[j], probe);",
        "for (int j = HEAD + BODY; j < HEAD + BODY; ++j) add<SCATTER>(dst + j, v[j], probe);",
        ("tile_march_bwd",),
    ),
    "the march backward drops its touched-brick flag store": (
        "nerf_projects_tpu_torch/csrc/tile_march_bwd.cu",
        "if (SCATTER && p.touched && (run.gd != 0.f || colour)) p.touched[run.cell / CELLS] = 1;",
        "// the touched-brick flag store dropped",
        ("train_plenoxels_sparse",),
    ),
    "K5's w5 rows left unpermuted (the reference's [h, x] order in the [x | h] tile)": (
        "nerf_projects_tpu_torch/ops/kernels/fused_sh_mlp.py",
        "w5=((d[5].weight[:, 256:], 0), (d[5].weight[:, :256], 64)),",
        "w5=((d[5].weight[:, :256], 0), (d[5].weight[:, 256:], 256)),",
        ("kernel_sh",),
    ),
    "K5f's coefficient head cut to its first 4 columns in the wgmma core": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "const bool live[2] = {c < num_rgb, c + 1 < num_rgb};",
        "const bool live[2] = {c < 4, c + 1 < 4};",
        ("kernel_sh",),
    ),
    "K5f's sigma taken from its head's column 1 (no weights) in the wgmma core": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "if (row_a + 8 * h < n) sig[row_a + 8 * h] = acc[2 * h] + b;",
        "if (row_a + 8 * h < n) sig[row_a + 8 * h] = acc[2 * h + 1] + b;",
        ("kernel_sh",),
    ),
    "K5b's reduce skips the first split-K partial of dW": (
        "nerf_projects_tpu_torch/csrc/fused_sh_bwd.cu",
        "for (int k = 0; k < splits; ++k) s += part[k * mlp::GB0 + i];",
        "for (int k = 1; k < splits; ++k) s += part[k * mlp::GB0 + i];",
        ("kernel_sh",),
    ),
    "trunk_0's rows left unpermuted in unpack_grads' raw layout": (
        "nerf_projects_tpu_torch/ops/kernels/fused_mlp.py",
        "w0, w5x, wvv = unperm(w0, 10), unperm(w5x, 10), unperm(wvv, 4)",
        "w0, w5x, wvv = w0, unperm(w5x, 10), unperm(wvv, 4)",
        ("kernel_raw",),
    ),
    "the wgmma core's view encoder at 3 frequencies instead of 4": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "v0 = c < 27 ? mlp::encode_col(vrow[h], c, 4) : 0.f;\n"
        "          v1 = c + 1 < 27 ? mlp::encode_col(vrow[h], c + 1, 4) : 0.f;",
        "v0 = c < 27 ? mlp::encode_col(vrow[h], c, 3) : 0.f;\n"
        "          v1 = c + 1 < 27 ? mlp::encode_col(vrow[h], c + 1, 3) : 0.f;",
        ("kernel_raw", "fused_train_level"),
    ),
    "the wgmma core's encoding stash (A_X) written as zeros": (
        "nerf_projects_tpu_torch/csrc/mlp_sm90.cuh",
        "stash[slot(tile64, a_f8(MODE), fg, L.ra + 8 * h, L.t)] = r4[i];",
        "stash[slot(tile64, a_f8(MODE), fg, L.ra + 8 * h, L.t)] = kb < 4 ? 0u : r4[i];",
        ("kernel_raw", "fused_train_level", "fused_mlp_bwd", "kernel_sh"),
    ),
    "the render CLI's fast route keeps the top-K smallest weights (ops/grid.py::_render_top_k)": (
        "nerf_projects_tpu_torch/ops/grid.py",
        "top_w, top_idx = torch.topk(weights, k, dim=-1)",
        "top_w, top_idx = torch.topk(weights, k, dim=-1, largest=False)",
        ("render_plenoxels_eval",),
    ),
    "the training loop's checkpoint restore skips Adam's state (train/checkpoint.py::load_checkpoint)": (
        "nerf_projects_tpu_torch/train/checkpoint.py",
        "    template.optimizer.load_state_dict(opt)\n",
        "",
        ("train_nerf_loop",),
    ),
    "the NeRF-SH evaluate scores every view against view 0's image (cli/eval_nerf_sh.py)": (
        "nerf_projects_tpu_torch/cli/eval_nerf_sh.py",
        "m = compute_metrics(img, scene.images[v])",
        "m = compute_metrics(img, scene.images[0])",
        ("train_nerf_sh_cli",),
    ),
    "the octree march's early stop drops each ray's last active sample (ops/octree_render.py)": (
        "nerf_projects_tpu_torch/ops/octree_render.py",
        "active = T > opts.stop_thresh  # a prefix of each ray's samples",
        "active = T * torch.exp(-tau) > opts.stop_thresh  # a prefix of each ray's samples",
        ("plenoctree",),
    ),
    "extraction's step 2 averages the coefficients but keeps the first sample's sigma (pipeline/extraction.py)": (
        "nerf_projects_tpu_torch/pipeline/extraction.py",
        "rgba = _mean_over_samples(torch.cat([coeffs, sigma], -1))",
        "rgba = torch.cat([_mean_over_samples(coeffs), sigma[:, 0]], -1)",
        ("plenoctree",),
    ),
    "the transmittance's backward without its division by the factor": (
        "nerf_projects_tpu_torch/ops/render.py",
        "return torch.flip(torch.cumsum(torch.flip(g * c, (-1,)), dim=-1), (-1,)) / f",
        "return torch.flip(torch.cumsum(torch.flip(g * c, (-1,)), dim=-1), (-1,))",
        ("train_raw",),
    ),
    "K2 handed the shard's ray count as n_rays_total on the trainer's mesh route": (
        "nerf_projects_tpu_torch/train/nerf_trainer.py",
        "n_total = n_rays if rows is None else rows[2]",
        "n_total = n_rays",
        ("parallel",),
    ),
    "the row-sharded touched step without the all_gather of its rewritten cell rows": (
        "nerf_projects_tpu_torch/train/plenoxels_sparse.py",
        "st.cells[rows] = shard.from_owners(new.to(st.cells.dtype), rows)",
        "st.cells[rows] = new.to(st.cells.dtype)",
        ("parallel",),
    ),
}

PHASES = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
c.phase_build()
phases = {"kernel": lambda: c.phase_kernel(dev, fine_rows=65536),
          "render": lambda: c.phase_render(dev),
          "fused_mlp_bwd": lambda: c.phase_kernel_bwd(dev, big_rows=65536),
          "fused_train_level": lambda: c.phase_kernel_train(dev),
          "tile_march_fwd": lambda: c.phase_kernel_march(dev),
          "tile_march_bwd": lambda: c.phase_kernel_march_bwd(dev),
          "train_plenoxels_sparse": lambda: c.phase_train_plenoxels_sparse(dev, c.nvidia_smi()),
          "kernel_sh": lambda: c.phase_kernel_sh(dev),
          "kernel_raw": lambda: c.phase_kernel_raw(dev, serve_rows=65536, train_rows=65536),
          "train_raw": lambda: c.phase_train_raw(dev, c.nvidia_smi()),
          "render_plenoxels_eval": lambda: c.phase_render_plenoxels_eval(dev, c.nvidia_smi()),
          "train_plenoxels_bg": lambda: c.phase_train_plenoxels_bg(dev, c.nvidia_smi()),
          "train_nerf_loop": lambda: c.phase_train_nerf_loop(dev, c.nvidia_smi()),
          "train_nerf_sh_cli": lambda: c.phase_train_nerf_sh_cli(dev, c.nvidia_smi()),
          "plenoctree": lambda: c.phase_plenoctree_on_a_run(dev, c.nvidia_smi()),
          "parallel": lambda: c.phase_parallel(dev, c.nvidia_smi())}
for name in sys.argv[1:]:
    fn = phases[name]
    try:
        fn()
        print("RESULT", name, "SURVIVED", flush=True)
    except AssertionError as e:
        print("RESULT", name, "CAUGHT", str(e)[:200], flush=True)
'''


def main() -> int:
    # the intact libraries, built once: a copy rebuilds only those whose
    # sources the mutant changes (a library is named by its sources' hash)
    subprocess.run([sys.executable, "-c", "import chip_smoke as c; c.phase_build()"], check=True,
                   capture_output=True, text=True, timeout=900)
    survived = 0
    pattern = sys.argv[1] if len(sys.argv) > 1 else ""
    for label, (path, old, new, must_fail) in MUTANTS.items():
        if pattern not in label:
            continue
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree("nerf_projects_tpu_torch", os.path.join(d, "nerf_projects_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__", "*.tmp.so"))
            shutil.copy("chip_smoke.py", d)
            target = os.path.join(d, path)
            src = open(target).read()
            if src.count(old) != 1:
                raise SystemExit(f"mutant {label!r}: the original text is not in {path} once")
            with open(target, "w") as f:
                f.write(src.replace(old, new))
            proc = subprocess.run([sys.executable, "-c", PHASES, *must_fail], cwd=d, capture_output=True,
                                  text=True, timeout=600)
        print(f"mutant: {label}", flush=True)
        results = [l.split(" ", 3)[1:] for l in proc.stdout.splitlines() if l.startswith("RESULT")]
        if not results:
            print(proc.stdout[-2000:], proc.stderr[-2000:], flush=True)
            return 1
        for name, verdict, *msg in results:
            print(f"  {name}: {verdict} {' '.join(msg)}", flush=True)
            survived += verdict == "SURVIVED" and name in must_fail
    return 1 if survived else 0


if __name__ == "__main__":
    sys.exit(main())
