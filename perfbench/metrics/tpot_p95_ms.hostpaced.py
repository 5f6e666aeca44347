"""95th percentile (nearest rank), over every request finished in the
window, of (finish - first token) / (tokens - 1) on the clients' clock.
A per-layer metric where the device sits idle most of the window: the
host paces these tails."""
from perfbench.serve import p95


def read(ctx):
    xs = ctx.get("tpot_s")
    if ctx["kind"] != "serve" or not xs:
        return None
    return p95(xs) * 1e3
