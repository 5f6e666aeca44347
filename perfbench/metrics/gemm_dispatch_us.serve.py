"""Host time of one routed GEMM call in the traced slice: the program's
``gemm.dispatch`` records (``api.matmul`` / ``api.gemm`` from entry to
the return of its last launch: route, plan, launches), summed, over
their number."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    calls = cap.of("gemm.dispatch")
    if not calls:
        return None
    return cap.ms(calls) * 1e3 / len(calls)
