#!/bin/bash
# Paired comparison of two checkouts on one CUDA card: chip_smoke.py's
# build phase and then, from each checkout, in the order A, B, B, A,
# either the host-bound NeRF paths (the render and train phases, with
# their profile lines; the default) or, with a third argument
# "plenoxels", the Plenoxels serving phase (render_plenoxels), or, with
# "plenoxels+train", that phase and the Plenoxels training phase
# (train_plenoxels), or, with "mlp", the MLP kernels on the wgmma core's
# paths: K2's and K1rb's splits into their launches (CHANGE_DIR's
# profile_train_split, run on each checkout's package), the kernel phases
# of K1f, K1b, K2, the raw-points MLP (K1f, K1rf and K1rb at every level
# size) and the NeRF-SH trunk (K5f and K5b), the encoded render phase
# (K1f), the train phase (the mega and fused-MLP routes), the raw-points
# render and train phases and the NeRF-SH render and train phases. Run
# from anywhere, with each checkout unpacked in a directory:
#
#     bash chip_paired.sh PARENT_DIR CHANGE_DIR [plenoxels|plenoxels+train|mlp]
#
# Stops with a non-zero exit at the first run that fails or prints none
# of those lines.
set -euo pipefail
a=$1
b=$2
split=$(cd "$b" && pwd)/chip_smoke.py
case "${3:-}" in
  plenoxels)
    phases="c.phase_render_plenoxels(dev, card)"
    lines='^render_plenoxels: (fog|shell) on' ;;
  plenoxels+train)
    phases="c.phase_render_plenoxels(dev, card); c.phase_train_plenoxels(dev, card)"
    lines='^render_plenoxels: (fog|shell) on|^train_plenoxels: (fog|shell) [0-9]+\^3( on|: K3 alone|: K4 alone)' ;;
  mlp)
    phases="s.profile_train_split(dev); c.phase_kernel(dev, 786432); c.phase_kernel_bwd(dev, 294912); c.phase_kernel_train(dev); c.phase_kernel_raw(dev, 786432, 294912); c.phase_kernel_sh(dev); c.phase_render(dev); c.phase_train(dev, card); c.phase_render_raw(dev, card); c.phase_train_raw(dev, card); c.phase_render_nerf_sh(dev, card); c.phase_train_nerf_sh(dev, card)"
    lines='^split:|^kernel: fused_train_level|^kernel(_raw|_sh)?: fused_(mlp|sh)_(raw_)?(fwd|bwd) n=[0-9]+:|^kernel sizes: fused_(mlp|sh)_(raw_)?(fwd|bwd)|^render: [0-9]+ timed|^train: fused|^render_raw on|^train_raw: raw-points MLP under|^(render|train)_nerf_sh on|^profile:|^  ptxas:.*(sm90|mlp_fwd|mlp_dx|mlp_dw|sh_fwd|sh_dx)' ;;
  *)
    phases="c.phase_render(dev); c.phase_train(dev, card)"
    lines='^render: [0-9]+ timed|^train: fused|^profile:' ;;
esac
for t in "$a" "$b" "$b" "$a"; do
  echo "=== $t"
  (cd "$t" && python3 -c "
import importlib.util, torch, chip_smoke as c
spec = importlib.util.spec_from_file_location('change_smoke', '$split')
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device('cuda', 0)
card = c.nvidia_smi()
c.phase_build()
$phases
" 2>&1 | grep -E "$lines")
done
