"""Mean wait of a request between its admission to a slot and the start
of its first prefill chunk, over the first chunks in the traced slice:
the ``waited_us`` of the program's ``serve.prefill`` spans."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    waits = [r.attrs["waited_us"] for r in cap.of("serve.prefill")
             if r.attrs and "waited_us" in r.attrs]
    if not waits:
        return None
    return sum(waits) / len(waits) * 1e-3
