"""Wall time of one engine step in the traced slice: the slice's length
(its last kernel waited for) over its steps."""
from perfbench import trace as tr


def read(ctx):
    data = ctx.get("slice")
    if ctx["kind"] != "serve" or data is None or not ctx["slice_steps"]:
        return None
    return tr.window_s(data) * 1e3 / ctx["slice_steps"]
