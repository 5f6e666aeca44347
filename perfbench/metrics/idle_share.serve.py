"""Share of the traced slice in which no operation ran on the device:
1 - the union of the device ops' intervals over the slice's length."""
from perfbench import trace as tr


def read(ctx):
    data = ctx.get("slice")
    if ctx["kind"] != "serve" or data is None or not data["kernels"]:
        return None
    return 100.0 * (1.0 - tr.busy_s(data) / tr.window_s(data))
