"""K1f, the fused NeRF MLP's forward (``ops/kernels/fused_mlp.py::fused_mlp_fwd``,
``csrc/fused_mlp_fwd.cu``): its operations and bytes a launch.

The live multiply-adds of a row at the unpadded widths: the trunk 63x256,
four 256x256, the skip layer 319x256, two 256x256; the sigma head 256x1,
the bottleneck 256x256, the view layer 283x128 and the rgb head 128x3.
An FMA counts two operations. Bytes: each row's inputs (points 64 and
views 32 float32, as the kernel reads them) and outputs (8 float32) once,
and the bf16 weights once.
"""

NAMES = ("sm90_fwd_kernel",)
PEAK = "bf16_flops_s"
LIVE_MACS = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256 + 256 * 256 + 283 * 128 + 128 * 3
FLOPS_PER_ROW = 2 * LIVE_MACS
IO_BYTES_PER_ROW = (64 + 32 + 8) * 4
WEIGHT_BYTES = 2 * (LIVE_MACS + 8 * 256 + 1 + 256 + 128 + 3)


def work(rows: int) -> tuple:
    """(operations, bytes) of one launch over ``rows`` rows."""
    return FLOPS_PER_ROW * rows, IO_BYTES_PER_ROW * rows + WEIGHT_BYTES
