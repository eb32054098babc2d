"""Device milliseconds a unit of work (frame or step) spends in kernels
that are not the port's hand-written ones (torch's operators, copies and
fills), from the profiler's trace; layer: the glue around the kernels."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    return 1e3 * ctx["glue_s"] / ctx["units"]
