"""Host time inside attention over the paged pool, a step of the traced
slice: the program's ``model.paged_attend`` spans (``layers.paged_attend``:
the paged-attention kernel's launch, or the plain ops with their blocking
copy).  None where the program records no such span."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    recs = cap.of("model.paged_attend")
    if not recs:
        return None
    return cap.ms(recs) / len(cap.steps)
