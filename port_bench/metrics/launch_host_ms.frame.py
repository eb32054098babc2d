"""Host milliseconds a frame spends launching K3 (the output's allocation,
the checks, the stream and the ctypes call): the self time of the
program's ``k3.launch`` spans inside its ``frame`` spans (obs/trace.py,
traced run); layer: kernels."""
from port_bench import program


def read(ctx):
    return program.per_unit(ctx, "frame", lambda r: r.host_ms("k3.launch", under="frame", self_time=True))
