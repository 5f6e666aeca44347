"""Host time inside the model calls, a step of the traced slice: the
program's ``model.call`` spans (``paged_decode``, ``paged_prefill``) less
the host's waits on the device inside them (``serve.sync``)."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    t = cap.ms(cap.of("model.call")) - \
        cap.ms(cap.of("serve.sync", inside="model.call"))
    return t / len(cap.steps)
