"""Host time blocked on the device, a step of the traced slice: the
program's ``serve.sync`` spans (the drain's copies to the host, the
prefill boundary's token, and every other wait on the step's path)."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    return cap.ms(cap.of("serve.sync")) / len(cap.steps)
