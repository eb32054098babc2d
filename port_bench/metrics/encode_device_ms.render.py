"""Device milliseconds a NeRF view spends encoding its samples (posenc
and the padding of the encodings to the kernel's widths): the program's
``nerf.encode`` spans inside its ``view`` spans, CUDA events at their
edges (obs/trace.py, traced run); layer: pipeline."""
from port_bench import program


def read(ctx):
    return program.device_ms(ctx, "render", "nerf.encode", "view")
