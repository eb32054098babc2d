"""Device milliseconds a Plenoxels step spends in the dense optimizer
sweep over the whole state: the program's ``plenoxels.sweep`` spans
inside its ``plenoxels.step`` spans, CUDA events at their edges
(obs/trace.py, traced run); layer: train glue."""
from port_bench import program


def read(ctx):
    return program.device_ms(ctx, "train", "plenoxels.sweep", "plenoxels.step")
