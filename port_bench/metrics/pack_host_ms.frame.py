"""Host milliseconds a frame spends packing its rays for the march: the
self time of the program's ``march.pack`` spans inside its ``frame``
spans (obs/trace.py, traced run); layer: pipeline."""
from port_bench import program


def read(ctx):
    return program.per_unit(ctx, "frame", lambda r: r.host_ms("march.pack", under="frame", self_time=True))
