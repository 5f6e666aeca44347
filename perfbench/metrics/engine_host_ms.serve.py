"""Host time of the engine itself, a step of the traced slice: the
program's ``serve.step`` spans less the model calls (``model.call``) and
the host's waits on the device outside them (``serve.sync``): scheduling,
block tables, staging copies, sampling and the drain's bookkeeping."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    steps = [cap.recs[i] for i in cap.steps]
    busy = cap.ms(cap.of("model.call")) + \
        cap.ms(cap.of("serve.sync", outside="model.call"))
    return (cap.ms(steps) - busy) / len(steps)
