"""Host milliseconds a test view spends inside the program's entry call
(the harness's span around each call, traced run), layer: entry."""


def read(ctx):
    if ctx["kind"] != "render" or not ctx["units"]:
        return None
    return 1e3 * ctx["entry_s"] / ctx["units"]
