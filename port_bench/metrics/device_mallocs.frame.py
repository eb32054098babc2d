"""Device allocations (cudaMalloc calls of the caching allocator,
``num_device_alloc``) a frame, from the program's first frame's entry to
its last frame's exit (obs/trace.py, traced run); layer: device."""
from port_bench import program


def read(ctx):
    rec = program.recording(ctx)
    if rec is None or "alloc.device_mallocs" not in rec.counters:
        return None
    return program.per_unit(ctx, "frame", lambda r: r.counters["alloc.device_mallocs"])
