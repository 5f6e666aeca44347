"""Device idle time, a step of the traced slice, while a routed GEMM
call (the program's ``gemm.dispatch``) was the innermost span open on
the host: the program's spans set on the device trace's clock and
joined to its idle gaps (``perfbench/hostspans.py``)."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None or not ctx["slice"]["kernels"]:
        return None
    return cap.idle_under("gemm.dispatch") * 1e3 / len(cap.steps)
