"""Host milliseconds a frame spends in Python's garbage collector inside
the program's ``frame`` spans (``py.gc`` spans from gc.callbacks,
obs/trace.py, traced run); layer: entry."""
from port_bench import program


def read(ctx):
    return program.per_unit(ctx, "frame", lambda r: r.host_ms("py.gc", under="frame"))
