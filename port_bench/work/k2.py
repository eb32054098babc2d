"""K2, the fused NeRF train level (``ops/kernels/fused_train.py::fused_train_level``,
``csrc/fused_train.cu``): its operations and bytes a launch.

A level over ``rows`` samples runs the MLP's forward, the products of the
input gradients (dX) and of the weight gradients (dW): three times K1f's
live multiply-adds a row (``work/k1f.py``), the compositing's few
operations a row left out. Bytes: each row's raw inputs (8 float32) and
each ray's block inputs (8 float32) once, the weights read and the
gradients written once (bf16 in, float32 out), and with ``weights_out``
the per-sample weights written (float32).
"""

from port_bench.work import k1f

NAMES = ("sm90_fwd_kernel", "sm90_dx_kernel", "sm90_dw_kernel", "mlp_grad_reduce_kernel", "composite_kernel")
PEAK = "bf16_flops_s"
FLOPS_PER_ROW = 3 * k1f.FLOPS_PER_ROW


def work(rays: int, samples: int, weights_out: bool) -> tuple:
    """(operations, bytes) of one level of ``rays`` rays at ``samples``
    samples a ray."""
    rows = rays * samples
    nbytes = rows * 8 * 4 + rays * 8 * 4 + k1f.WEIGHT_BYTES + 2 * k1f.WEIGHT_BYTES
    if weights_out:
        nbytes += rows * 4
    return FLOPS_PER_ROW * rows, nbytes
