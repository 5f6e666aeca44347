"""Model operations of every token the window's model calls processed
(real rows only: prompt tokens of prefill chunks, active slots of decode
steps, each at its position; ``work/counts.py``) over the window's
length times the card's bf16 peak (``work/peaks.json``)."""
from perfbench.work import counts


def read(ctx):
    rows = ctx.get("window_rows")
    if ctx["kind"] != "serve" or not rows:
        return None
    doc = ctx["doc"]
    flops = sum(counts.tokens_flops(doc, r) for r in rows)
    return 100.0 * flops / (ctx["window_s"] * counts.PEAKS["bf16_flops"])
