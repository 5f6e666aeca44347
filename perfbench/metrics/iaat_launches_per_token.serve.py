"""Launches of the IAAT kernel in the window (``iaat_gemm.launch_count``)
over the output tokens its clients received in it."""


def read(ctx):
    c = ctx["counters"]
    if ctx["kind"] != "serve" or not ctx["tokens"] or \
            "iaat_launches" not in c:
        return None
    return c["iaat_launches"] / ctx["tokens"]
