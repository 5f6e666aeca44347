"""Device time of clipping and AdamW, a step of the traced slice: the
CUDA events at the edges of the program's ``train.optimizer`` spans
(``train/optimizer.adamw_update``), summed, over the slice's steps."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "train", "train.step")
    if cap is None:
        return None
    opt = [r.device_ms for r in cap.of("train.optimizer")]
    if not opt or None in opt:
        return None
    return sum(opt) / len(cap.steps)
