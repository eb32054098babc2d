"""Device milliseconds a NeRF view spends drawing its samples (the
stratified depths, the inverse CDF, the sort or merge, the points): the
program's ``nerf.sample`` spans inside its ``view`` spans, CUDA events at
their edges (obs/trace.py, traced run); layer: pipeline."""
from port_bench import program


def read(ctx):
    return program.device_ms(ctx, "render", "nerf.sample", "view")
