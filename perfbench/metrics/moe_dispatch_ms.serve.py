"""Host time of the MoE layers' dispatch, a step of the traced slice: the
program's ``model.moe.dispatch`` spans (``layers._dropless_moe``: the
router's GEMM, top-k, the tile table and the rows gathered into their
tiles), summed.  None where the program records no such span."""
from perfbench import hostspans


def read(ctx):
    cap = hostspans.capture(ctx, "serve", "serve.step")
    if cap is None:
        return None
    recs = cap.of("model.moe.dispatch")
    if not recs:
        return None
    return cap.ms(recs) / len(cap.steps)
