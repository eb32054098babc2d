#!/bin/bash
# Paired comparison of the host-bound paths of two checkouts on one CUDA
# card: chip_smoke.py's build, render and train phases from each, in the
# order A, B, B, A, printing the render, train and profile lines. Run
# from anywhere, with each checkout unpacked in a directory:
#
#     bash chip_paired.sh PARENT_DIR CHANGE_DIR
#
# Stops with a non-zero exit at the first run that fails or prints none
# of those lines.
set -euo pipefail
a=$1
b=$2
for t in "$a" "$b" "$b" "$a"; do
  echo "=== $t"
  (cd "$t" && python3 -c "
import torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device('cuda', 0)
card = c.nvidia_smi()
c.phase_build()
c.phase_render(dev)
c.phase_train(dev, card)
" 2>&1 | grep -E '^render: [0-9]+ timed|^train: fused|^profile:')
done
