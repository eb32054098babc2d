"""Device milliseconds a NeRF view spends compositing (the activations and
the volume rendering of each level): the program's ``nerf.composite``
spans inside its ``view`` spans, CUDA events at their edges
(obs/trace.py, traced run); layer: pipeline."""
from port_bench import program


def read(ctx):
    return program.device_ms(ctx, "render", "nerf.composite", "view")
