"""Device milliseconds a Plenoxels step spends in its march (the rays'
packing, K3, the loss seeds, K4 with its zero fills): the program's
``plenoxels.march`` spans inside its ``plenoxels.step`` spans, CUDA events
at their edges (obs/trace.py, traced run); layer: kernels."""
from port_bench import program


def read(ctx):
    return program.device_ms(ctx, "train", "plenoxels.march", "plenoxels.step")
