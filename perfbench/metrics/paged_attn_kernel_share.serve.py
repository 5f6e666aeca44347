"""Share of the traced slice's attention calls over the paged pool that
took the paged-attention kernel: the program's ``model.paged_attend``
records whose ``path`` is "kernel".  None where the program records no
such span."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    recs = cap.of("model.paged_attend")
    if not recs:
        return None
    kernel = sum(1 for r in recs if (r.attrs or {}).get("path") == "kernel")
    return 100.0 * kernel / len(recs)
