"""Model operations of the window's train steps (three times the forward
of every token, attention included, recompute not counted;
``work/counts.py``) over the window's length times the card's bf16
peak (``work/peaks.json``)."""
from perfbench.work import counts


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    mix = ctx["mix"]
    flops = ctx["steps"] * counts.train_step_flops(ctx["doc"], mix["batch"],
                                                   mix["seq"])
    return 100.0 * flops / (ctx["window_s"] * counts.PEAKS["bf16_flops"])
