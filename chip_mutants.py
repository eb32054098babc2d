#!/usr/bin/env python3
"""Mutation check of the kernels on one CUDA card.

Copies the package and chip_smoke.py to a temporary directory, breaks
one line of a CUDA source there, and runs the chip_smoke.py kernel
phases that run the broken code (K1b, K2, K3 or K4) on the copy; each
must fail. Run from the repository root:

    python3 chip_mutants.py

Prints one line per (mutant, phase): CAUGHT or SURVIVED, with the
check's message; exits 1 if a mutant survived a phase it should fail.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

# label: (file, original text, mutant text, phases that must fail)
MUTANTS = {
    "w5's h rows read a3 instead of a4 in the dW table": (
        "nerf_projects_tpu_torch/csrc/mlp_tile.cuh",
        "{A_TRUNK + 4 * 256, 256, G_TRUNK + 5 * 256",
        "{A_TRUNK + 3 * 256, 256, G_TRUNK + 5 * 256",
        ("fused_mlp_bwd", "fused_train_level"),
    ),
    "inclusive instead of exclusive transmittance in the composite": (
        "nerf_projects_tpu_torch/csrc/fused_train.cu",
        "const float logT = carry + excl;",
        "const float logT = carry + incl;",
        ("fused_train_level",),
    ),
    "inclusive instead of exclusive transmittance in the tile march": (
        "nerf_projects_tpu_torch/csrc/tile_march_fwd.cu",
        "const float T = expf(-cum);",
        "const float T = expf(-(cum + sigma * r.step_world));",
        ("tile_march_fwd",),
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
}

PHASES = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
c.phase_build()
phases = {"fused_mlp_bwd": lambda: c.phase_kernel_bwd(dev, big_rows=65536),
          "fused_train_level": lambda: c.phase_kernel_train(dev),
          "tile_march_fwd": lambda: c.phase_kernel_march(dev),
          "tile_march_bwd": lambda: c.phase_kernel_march_bwd(dev)}
for name in sys.argv[1:]:
    fn = phases[name]
    try:
        fn()
        print("RESULT", name, "SURVIVED", flush=True)
    except AssertionError as e:
        print("RESULT", name, "CAUGHT", str(e)[:200], flush=True)
'''


def main() -> int:
    survived = 0
    for label, (path, old, new, must_fail) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree("nerf_projects_tpu_torch", os.path.join(d, "nerf_projects_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
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
