"""K2's share of its roofline, percent: the least time of its
launches in the traced window (work/k2.py over the published peaks) over
their device time in the trace; layer: kernels."""


def read(ctx):
    k = ctx["kernels"].get("k2")
    if ctx["kind"] != "train" or not k or k["time_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["time_s"]
