"""Share of the window's routed GEMM calls that the router sent to a
kernel (``obs.ROUTES.kernel_share()``, differenced over the window)."""


def read(ctx):
    c = ctx["counters"]
    if ctx["kind"] != "train" or not c.get("routes_all"):
        return None
    return 100.0 * c["routes_kernel"] / c["routes_all"]
