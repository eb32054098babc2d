"""Host milliseconds a frame spends building rgb, acc and log_transmit from
the march's block: the self time of the program's ``frame.outputs`` spans
(obs/trace.py, traced run); layer: pipeline."""
from port_bench import program


def read(ctx):
    return program.per_unit(ctx, "frame", lambda r: r.host_ms("frame.outputs", under="frame", self_time=True))
