#!/bin/bash
# Paired comparison of two checkouts on one CUDA card: chip_smoke.py's
# build phase and then, from each checkout, in the order A, B, B, A,
# either the host-bound NeRF paths (the render and train phases, with
# their profile lines; the default) or, with a third argument
# "plenoxels", the Plenoxels serving phase (render_plenoxels), or, with
# "plenoxels+train", that phase and the Plenoxels training phase
# (train_plenoxels). Run from anywhere, with each checkout unpacked in a
# directory:
#
#     bash chip_paired.sh PARENT_DIR CHANGE_DIR [plenoxels|plenoxels+train]
#
# Stops with a non-zero exit at the first run that fails or prints none
# of those lines.
set -euo pipefail
a=$1
b=$2
case "${3:-}" in
  plenoxels)
    phases="c.phase_render_plenoxels(dev, card)"
    lines='^render_plenoxels: (fog|shell) on' ;;
  plenoxels+train)
    phases="c.phase_render_plenoxels(dev, card); c.phase_train_plenoxels(dev, card)"
    lines='^render_plenoxels: (fog|shell) on|^train_plenoxels: (fog|shell) [0-9]+\^3( on|: K3 alone|: K4 alone)' ;;
  *)
    phases="c.phase_render(dev); c.phase_train(dev, card)"
    lines='^render: [0-9]+ timed|^train: fused|^profile:' ;;
esac
for t in "$a" "$b" "$b" "$a"; do
  echo "=== $t"
  (cd "$t" && python3 -c "
import torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device('cuda', 0)
card = c.nvidia_smi()
c.phase_build()
$phases
" 2>&1 | grep -E "$lines")
done
