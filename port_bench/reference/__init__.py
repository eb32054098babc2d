"""Plain references of the benchmark's configurations: plain PyTorch in
float32 with TF32 off, importing nothing of the port."""
import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Float32 products in float32, not TF32, inside."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
