"""The whole step's share of the chip's peak, percent: the least time
the card could take for the traced units' work (the driver's model
arithmetic over the published peaks: operations over the FLOP rate or
bytes over HBM bandwidth, whichever is longer) over the time they took."""


def read(ctx):
    m = ctx.get("model")
    if ctx["kind"] != "train" or not m or m["time_s"] <= 0:
        return None
    return 100.0 * m["bound_s"] / m["time_s"]
