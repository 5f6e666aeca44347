"""95th percentile (nearest rank), over every request whose first token
reached its client in the window, of the time from send to first token,
on the clients' clock.  A per-layer metric where the device sits idle
most of the window: the host paces these tails."""
from perfbench.serve import p95


def read(ctx):
    xs = ctx.get("ttft_s")
    if ctx["kind"] != "serve" or not xs:
        return None
    return p95(xs) * 1e3
