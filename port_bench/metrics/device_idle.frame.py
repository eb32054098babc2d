"""Percent of the traced window with no operation on the device (the
union of the device operations' intervals); layer: the device."""


def read(ctx):
    if ctx["kind"] != "frame" or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
